from .fused import EpochStats, FusedEpoch, FusedHeteroEpoch
from .fused_tree import FusedTreeEpoch, expand_tree_levels
from .neighbor_loader import NeighborLoader
from .node_loader import NodeLoader, SeedBatcher
from .prefetch import PrefetchIterator, PrefetchingLoader
from .transform import Batch, HeteroBatch, collate, to_data, to_hetero_data
