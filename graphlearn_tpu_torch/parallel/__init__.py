"""The mesh data plane on one card: sharded graph and tiered feature
store, the dense exchange, the mesh sampler and loader (GNS-biased or
uniform), and data-parallel training."""
from .dist_data import (DistDataset, DistFeature, DistGraph,
                        build_dist_feature, build_dist_graph, hot_count,
                        relabel_by_partition)
from .dist_sampler import (DistNeighborLoader, DistNeighborSampler,
                           TorchDraws)
from .dp import Mesh, make_dp_supervised_step, make_mesh
from .exchange import bucket_by_owner, capacity_spec, plan_exchange
