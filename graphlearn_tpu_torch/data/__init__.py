from .dataset import Dataset
from .feature import Feature
from .graph import Graph
from .reorder import sort_by_hotness, sort_by_in_degree
from .topology import CSRTopo
