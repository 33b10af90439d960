"""`Batch`: the PyG-``Data``-shaped mini-batch the loaders yield (the
JAX package's `loader/transform.py:45`), and the collation of a
`SamplerOutput` into one (`to_data`, `collate`, `_gather_labels`:
`loader/transform.py:150-220`, homogeneous).  Padded slots hold -1 ids
and zero rows; the masks say which slots are real."""
from __future__ import annotations

import torch


class Batch:
  """Homogeneous mini-batch.

  Attributes:
    x: ``[node_cap, D]`` node features (zero rows where padded).
    y: ``[node_cap]`` node labels (0 where padded) or None.
    edge_index: ``[2, edge_cap]`` local COO, -1 where masked; row 0 is
      the sampled neighbor (message source), row 1 the target.
    edge_attr: edge features or None (not ported).
    node: ``[node_cap]`` global node ids (-1 padded); node_mask its
      validity; edge_mask: ``[edge_cap]`` edge validity.
    edge: global edge ids or None.
    batch: ``[B]`` seed ids; batch_size the static seed count.
    num_sampled_nodes: new nodes per hop (seeds first).
    metadata: ``seed_local`` and, from the GNS sampler, ``edge_weight``
      (``[edge_cap]`` importance weights aligned with ``edge_index``).
  The mesh loader stacks every tensor field with a leading card axis.
  """

  FIELDS = ('x', 'y', 'edge_index', 'edge_attr', 'node', 'node_mask',
            'edge_mask', 'edge', 'batch', 'num_sampled_nodes',
            'num_sampled_edges', 'metadata')

  def __init__(self, x=None, y=None, edge_index=None, edge_attr=None,
               node=None, node_mask=None, edge_mask=None, edge=None,
               batch=None, batch_size: int = 0, num_sampled_nodes=None,
               num_sampled_edges=None, metadata=None):
    self.x = x
    self.y = y
    self.edge_index = edge_index
    self.edge_attr = edge_attr
    self.node = node
    self.node_mask = node_mask
    self.edge_mask = edge_mask
    self.edge = edge
    self.batch = batch
    self.batch_size = batch_size
    self.num_sampled_nodes = num_sampled_nodes
    self.num_sampled_edges = num_sampled_edges
    self.metadata = metadata if metadata is not None else {}

  def __repr__(self) -> str:
    shapes = {f: tuple(getattr(self, f).shape) for f in self.FIELDS
              if hasattr(getattr(self, f), 'shape')}
    return f'Batch(batch_size={self.batch_size}, {shapes})'


def _gather_labels(labels: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
  """``labels[ids]`` on the labels' device, 0 where ``ids < 0``: a
  plain gather (`index_select`), as the JAX package's is plain XLA."""
  valid = ids >= 0
  idx = torch.where(valid, ids.long(), 0).clamp(max=labels.shape[0] - 1)
  out = torch.index_select(labels, 0, idx)
  mask = valid.reshape(valid.shape + (1,) * (out.ndim - 1))
  return torch.where(mask, out, torch.zeros((), dtype=out.dtype,
                                            device=out.device))


def to_data(out, node_feature=None, node_label=None) -> Batch:
  """A `Batch` from a `sampler.SamplerOutput`: ``x`` from the feature
  store by the sampled ids (`data.Feature.get`, the row gather kernel on
  the card), ``y`` by `_gather_labels`; the sampler's metadata is
  forwarded."""
  x = node_feature.get(out.node) if node_feature is not None else None
  y = (_gather_labels(node_label, out.node) if node_label is not None
       else None)
  return Batch(x=x, y=y, edge_index=torch.stack([out.row, out.col]),
               node=out.node, node_mask=out.node >= 0,
               edge_mask=out.edge_mask, edge=out.edge, batch=out.batch,
               batch_size=out.batch_size,
               num_sampled_nodes=out.num_sampled_nodes,
               num_sampled_edges=out.num_sampled_edges,
               metadata=dict(out.metadata))


def collate(data, out) -> Batch:
  """Collate a homogeneous sampler output against a `data.Dataset`
  (the one implementation behind every single-card loader)."""
  return to_data(out, node_feature=data.node_features,
                 node_label=data.get_node_label_device())
