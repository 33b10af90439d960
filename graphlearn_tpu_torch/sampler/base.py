"""The sampler contract (the JAX package's `sampler/base.py:25-221,
251-261`): the node-seed and edge-seed inputs, the negative-sampling
spec, the static-shape homogeneous and heterogeneous outputs and the
abstract sampler."""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch


@dataclasses.dataclass
class NodeSamplerInput:
  """Seed nodes for node-wise sampling: ``node`` is ``[B]`` global ids,
  -1-padded to the loader's static batch size; ``input_type`` their
  node type on a heterogeneous graph."""
  node: Union[np.ndarray, torch.Tensor]
  input_type: Optional[str] = None

  def __len__(self) -> int:
    return len(self.node)


@dataclasses.dataclass(frozen=True)
class NegativeSampling:
  """Negative edge sampling: ``mode`` ``'binary'`` (``ceil(amount *
  B)`` random non-edges beside ``B`` positives) or ``'triplet'``
  (``ceil(amount)`` negative destinations per positive source)."""
  mode: str = 'binary'
  amount: Union[int, float] = 1

  def __post_init__(self):
    if self.mode not in ('binary', 'triplet'):
      raise ValueError(f'Unsupported negative sampling mode {self.mode!r}')
    if self.amount <= 0:
      raise ValueError('amount must be positive')

  @classmethod
  def cast(cls, value) -> Optional['NegativeSampling']:
    """None, a spec, a ``(mode, amount)`` tuple, a dict of fields or a
    mode string -> a spec (or None)."""
    if value is None or isinstance(value, cls):
      return value
    if isinstance(value, tuple):
      return cls(*value)
    if isinstance(value, dict):
      return cls(**value)
    return cls(value)

  def is_binary(self) -> bool:
    return self.mode == 'binary'

  def is_triplet(self) -> bool:
    return self.mode == 'triplet'

  def sample_size(self, num_pos: int) -> int:
    return int(np.ceil(float(self.amount) * num_pos))


@dataclasses.dataclass
class EdgeSamplerInput:
  """Seed edges for link-wise sampling: ``row``/``col`` are ``[B]``
  endpoint ids, (-1, -1) in padded slots; ``label`` optional ``[B]``
  edge labels; ``neg_sampling`` the negative spec."""
  row: Union[np.ndarray, torch.Tensor]
  col: Union[np.ndarray, torch.Tensor]
  label: Optional[Union[np.ndarray, torch.Tensor]] = None
  input_type: Optional[tuple] = None
  neg_sampling: Optional[NegativeSampling] = None

  def __len__(self) -> int:
    return len(self.row)


class SamplerOutput:
  """Homogeneous sampling result, static shapes.

  Attributes:
    node: ``[node_capacity]`` global node ids in insertion order (seeds
      first), -1-padded; the local index of ``node[i]`` is ``i``.
    node_count: int32 scalar, the valid entries of ``node``.
    row / col: ``[edge_capacity]`` local COO, -1 where masked; emitted
      transposed for message passing (``row`` the neighbor, ``col`` the
      seed side).
    edge: ``[edge_capacity]`` int32 global edge ids (-1 where masked)
      with ``with_edge``, else None.
    edge_mask: ``[edge_capacity]`` validity.
    batch: ``[B]`` seed ids, -1-padded.
    num_sampled_nodes / num_sampled_edges: int32 per-hop counts.
    metadata: ``seed_local``, the seeds' local indices; a link sample
      adds its label indices (`NeighborSampler.sample_from_edges`), an
      induced subgraph ``mapping``.
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


class HeteroSamplerOutput:
  """Heterogeneous sampling result keyed by node and edge type, static
  shapes.

  Attributes:
    node / node_count: ``{NodeType: [cap]}`` global ids in insertion
      order (the seed type's seeds first), -1-padded, and their int32
      valid counts.
    row / col / edge_mask: ``{EdgeType: [edge_cap]}`` local COO under
      the REVERSED edge type: ``row`` indexes the neighbor's type (the
      message source), ``col`` the seed side's; -1 where masked.
    edge: ``{EdgeType: [edge_cap]}`` int32 global edge ids (-1 where
      masked) under the reversed edge types with ``with_edge``, else
      None.
    batch: ``{NodeType: [B]}`` seed ids of the seeded types.
    num_sampled_nodes: ``{NodeType: [hops + 1]}`` int32 new nodes a hop.
    edge_types: the declared (reversed) edge types, empty ones included.
    metadata: ``seed_local`` (the seeds' local indices; a dict by type
      for a link sample) and ``input_type``; a link sample adds its label
      indices (`HeteroNeighborSampler.sample_from_edges`).
  """

  def __init__(self, node, node_count, row, col, edge=None, edge_mask=None,
               batch=None, num_sampled_nodes=None, num_sampled_edges=None,
               edge_types=None, metadata=None):
    self.node = node
    self.node_count = node_count
    self.row = row
    self.col = col
    self.edge = edge
    self.edge_mask = edge_mask
    self.batch = batch
    self.num_sampled_nodes = num_sampled_nodes
    self.num_sampled_edges = num_sampled_edges
    self.edge_types = edge_types
    self.metadata = metadata if metadata is not None else {}

  def __repr__(self):
    return (f'HeteroSamplerOutput(node_types={list(self.node)}, '
            f'edge_types={list(self.row)})')


class BaseSampler:
  """The abstract sampler."""

  def sample_from_nodes(self, inputs: NodeSamplerInput, **kwargs):
    raise NotImplementedError

  def sample_from_edges(self, inputs: EdgeSamplerInput, **kwargs):
    raise NotImplementedError

  def subgraph(self, inputs: NodeSamplerInput, **kwargs):
    raise NotImplementedError
