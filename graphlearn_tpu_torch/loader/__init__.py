from .fused_tree import expand_tree_levels
from .node_loader import SeedBatcher
from .transform import Batch
