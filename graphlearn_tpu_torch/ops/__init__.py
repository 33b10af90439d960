from .cold_gather import cold_gather, cold_gather_plain
from .delta_merge import (RankRows, merge_delta_csr_device, merge_ranks,
                          merge_ranks_plain, rank_inputs, rank_plan,
                          rank_rows)
from .draws import CounterDraws, TorchDraws, WalkDraws, hash_draws
from .fused_sample import sample_one_hop_fused, sample_one_hop_gns_fused
from .gather_rows import gather_rows, gather_rows_plain
from .gns import sample_one_hop_gns
from .launches import LAUNCH_COUNTED
from .negative import (NegativeSampleResult, edge_in_csr, sample_negative,
                       triplet_negatives)
from .neighbor import (OneHopResult, default_window, lookup_degree,
                       sample_one_hop)
from .random_walk import node2vec_walk, random_walk, walk_edges
from .subgraph import SubGraphResult, induced_subgraph
from .unique import InducerState, induce_next, init_node, unique_stable
from .window_gather import (csr_window_gather, csr_window_gather_plain,
                            window_gather_plain)
