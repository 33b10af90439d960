from .base import (BaseSampler, EdgeSamplerInput, HeteroSamplerOutput,
                   NegativeSampling, NodeSamplerInput, SamplerOutput)
from .hetero_neighbor_sampler import HeteroNeighborSampler
from .neighbor_sampler import NeighborSampler
from .negative_sampler import RandomNegativeSampler
