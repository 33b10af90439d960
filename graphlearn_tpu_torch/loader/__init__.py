from .fused import EpochStats
from .fused_tree import FusedTreeEpoch, expand_tree_levels
from .neighbor_loader import NeighborLoader
from .node_loader import NodeLoader, SeedBatcher
from .prefetch import PrefetchIterator, PrefetchingLoader
from .transform import Batch, collate, to_data
