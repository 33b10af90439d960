from .basic_gnn import BasicGNN, GraphSAGE, graphsage_from_flax
from .conv import SAGEConv, segment_mean
from .train import make_eval_step, make_supervised_step, supervised_loss
from .tree import TreeSAGE, tree_level_sizes, tree_sage_from_flax
