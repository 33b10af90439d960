from .tree import TreeSAGE, tree_level_sizes, tree_sage_from_flax
