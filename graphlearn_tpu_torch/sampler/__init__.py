from .base import BaseSampler, NodeSamplerInput, SamplerOutput
from .neighbor_sampler import NeighborSampler
