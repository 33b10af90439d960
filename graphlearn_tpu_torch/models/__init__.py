from .basic_gnn import BasicGNN, GraphSAGE, graphsage_from_flax
from .conv import SAGEConv, segment_max, segment_mean, segment_sum
from .hetero import (HGT, RGCN, HeteroConv, HGTConv, hgt_from_flax,
                     rgcn_from_flax)
from .train import (make_eval_step, make_hetero_eval_step,
                    make_hetero_supervised_step, make_supervised_step,
                    supervised_loss)
from .tree import TreeSAGE, tree_level_sizes, tree_sage_from_flax
