from .fused_tree import expand_tree_levels
