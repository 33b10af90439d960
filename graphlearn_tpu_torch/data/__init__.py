from .dataset import Dataset
from .feature import Feature
from .graph import Graph
from .topology import CSRTopo
