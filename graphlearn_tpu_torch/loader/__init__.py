from .fused import EpochStats, FusedEpoch, FusedHeteroEpoch, FusedLinkEpoch
from .fused_tree import FusedTreeEpoch, expand_tree_levels
from .link_loader import EdgeSeedBatcher, LinkLoader, LinkNeighborLoader
from .neighbor_loader import NeighborLoader
from .node_loader import NodeLoader, SeedBatcher
from .prefetch import PrefetchIterator, PrefetchingLoader
from .subgraph_loader import SubGraphLoader
from .transform import Batch, HeteroBatch, collate, to_data, to_hetero_data
