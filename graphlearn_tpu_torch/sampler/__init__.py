from .base import (BaseSampler, HeteroSamplerOutput, NodeSamplerInput,
                   SamplerOutput)
from .hetero_neighbor_sampler import HeteroNeighborSampler
from .neighbor_sampler import NeighborSampler
