"""The sampler contract (the JAX package's `sampler/base.py:25-45,
99-160,251-261`): the node-seed input, the static-shape homogeneous
output and the abstract sampler.  Edge inputs, negative sampling and
the heterogeneous output wait for slices 7 and 8 of the ROADMAP."""
from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch


@dataclasses.dataclass
class NodeSamplerInput:
  """Seed nodes for node-wise sampling: ``node`` is ``[B]`` global ids,
  -1-padded to the loader's static batch size."""
  node: Union[np.ndarray, torch.Tensor]

  def __len__(self) -> int:
    return len(self.node)


class SamplerOutput:
  """Homogeneous sampling result, static shapes.

  Attributes:
    node: ``[node_capacity]`` global node ids in insertion order (seeds
      first), -1-padded; the local index of ``node[i]`` is ``i``.
    node_count: int32 scalar, the valid entries of ``node``.
    row / col: ``[edge_capacity]`` local COO, -1 where masked; emitted
      transposed for message passing (``row`` the neighbor, ``col`` the
      seed side).
    edge: global edge ids or None (``with_edge`` is not ported).
    edge_mask: ``[edge_capacity]`` validity.
    batch: ``[B]`` seed ids, -1-padded.
    num_sampled_nodes / num_sampled_edges: int32 per-hop counts.
    metadata: ``seed_local``, the seeds' local indices.
  """

  def __init__(self, node, node_count, row, col, edge=None, edge_mask=None,
               batch=None, num_sampled_nodes=None, num_sampled_edges=None,
               metadata=None):
    self.node = node
    self.node_count = node_count
    self.row = row
    self.col = col
    self.edge = edge
    self.edge_mask = edge_mask
    self.batch = batch
    self.num_sampled_nodes = num_sampled_nodes
    self.num_sampled_edges = num_sampled_edges
    self.metadata = metadata if metadata is not None else {}

  @property
  def batch_size(self) -> int:
    return 0 if self.batch is None else int(self.batch.shape[0])

  def __repr__(self):
    return (f'SamplerOutput(node={tuple(self.node.shape)}, '
            f'edges={tuple(self.row.shape)})')


class BaseSampler:
  """The abstract sampler."""

  def sample_from_nodes(self, inputs: NodeSamplerInput, **kwargs):
    raise NotImplementedError

  def sample_from_edges(self, inputs, **kwargs):
    raise NotImplementedError

  def subgraph(self, inputs: NodeSamplerInput, **kwargs):
    raise NotImplementedError
