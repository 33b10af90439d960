from .basic_gnn import (DGCNN, GCN, BasicGNN, GraphSAGE, dgcnn_from_flax,
                        gcn_from_flax, graphsage_from_flax)
from .conv import (GATConv, GCNConv, SAGEConv, gat_conv_from_flax,
                   segment_max, segment_mean, segment_softmax, segment_sum)
from .hetero import (HGT, RGCN, HeteroConv, HGTConv, hetero_conv_from_flax,
                     hgt_from_flax, rgcn_from_flax)
from .train import (link_loss_from_metadata, make_eval_step,
                    make_hetero_eval_step, make_hetero_supervised_step,
                    make_supervised_step, make_unsupervised_step,
                    supervised_loss, triplet_link_loss,
                    unsupervised_link_loss)
from .tree import TreeSAGE, tree_level_sizes, tree_sage_from_flax
