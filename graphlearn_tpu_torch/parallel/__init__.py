"""The mesh data plane, its partitions sharing one card: sharded graph,
tiered feature store and mod-sharded edge features,
the mesh sampler and loader (GNS-biased or uniform, adaptive exchange
slack, sampled edge ids and rows), the link engine (strict negatives
over the sharded graph, the link sampler and loader), the induced
subgraph and random-walk engines, the heterogeneous engine (per-type
sharded stores with edge ids and edge features, the heterogeneous mesh
sampler, its node and link loaders), the remote-push row gather,
data-parallel training (supervised and link loss) and evaluation, the
fused mesh epochs (node, tree and link), partition failover: the
versioned `PartitionBook`, durable shards and adoption (`failover`) and
the fenced planned handoff (`handoff`), the exchange layouts (dense,
compact, hier) with the EWMA capacity model, and locality: the
streaming partitioner, the replica cache and the online rebalance
(`locality`)."""
from .dist_data import (DistDataset, DistFeature, DistGraph,
                        build_dist_edge_feature, build_dist_feature,
                        build_dist_graph, hot_count, relabel_by_partition)
from .dist_sampler import (SLACK_LADDER, AdaptiveSlack,
                           DistLinkNeighborLoader, DistLinkNeighborSampler,
                           DistNeighborLoader, DistNeighborSampler,
                           DistRandomWalker, DistSubGraphLoader,
                           DistSubGraphSampler, TorchDraws, dist_edge_exists,
                           dist_gather, dist_gather_multi,
                           dist_sample_negative, resolve_hop_chunk)
from .dist_hetero import (DistHeteroDataset, DistHeteroLinkNeighborLoader,
                          DistHeteroNeighborLoader,
                          DistHeteroNeighborSampler)
from .dp import (Mesh, make_dp_eval_step, make_dp_supervised_step,
                 make_dp_unsupervised_step, local_piece, make_mesh)
from .fused import FusedDistEpoch, FusedDistLinkEpoch, FusedDistTreeEpoch
from .exchange import (EwmaCapacityModel, ExchangeSpec, bucket_by_owner,
                       capacity_spec, mesh_factors, plan_exchange,
                       resolve_layout)
from .locality import (execute_rebalance, locality_partition,
                       rebalance_plan, resolve_partitioner)
from .failover import (NoDurableShardError, PartitionLostError, ShardStore,
                       adopt_shard)
from .handoff import HandoffAbortedError
from .partition_book import (AdoptionRefusedError, BookSpec, BookView,
                             PartitionBook)
from .rdma_gather import push_rows, push_rows_plain, rdma_gather
