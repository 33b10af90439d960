"""`Batch` and `HeteroBatch`: the PyG-``Data``/``HeteroData``-shaped
mini-batches the loaders yield (the JAX package's `loader/transform.py:
45,109`), and the collation of a sampler output into one (`to_data`,
`to_hetero_data`, `collate`, `_gather_labels`: `loader/transform.py:
150-263`).  Padded slots hold -1 ids and zero rows; the masks say which
slots are real."""
from __future__ import annotations

import torch

from ..sampler.base import HeteroSamplerOutput


class Batch:
  """Homogeneous mini-batch.

  Attributes:
    x: ``[node_cap, D]`` node features (zero rows where padded).
    y: ``[node_cap]`` node labels (0 where padded) or None.
    edge_index: ``[2, edge_cap]`` local COO, -1 where masked; row 0 is
      the sampled neighbor (message source), row 1 the target.
    edge_attr: ``[edge_cap, F]`` edge features (zero rows where masked)
      when the sampler emitted edge ids and the dataset has an edge
      table, else None.
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


class HeteroBatch:
  """Heterogeneous mini-batch: per-type dicts.

  Attributes:
    x_dict / y_dict: ``{NodeType: [cap, D]}`` features and ``{NodeType:
      [cap]}`` labels (zero where padded), for the types that have them.
    edge_index_dict / edge_mask_dict: ``{EdgeType: [2, edge_cap]}``
      local COO under the reversed edge type (row 0 indexes the message
      source's type) and its validity.
    edge_attr_dict: ``{EdgeType: [edge_cap, F]}`` edge features of the
      emitted edge types whose table the dataset holds under that (the
      emitted, reversed) type, when the sampler emitted edge ids.
    node_dict / node_mask_dict: ``{NodeType: [cap]}`` global ids (-1
      padded) and their validity.
    batch_dict: ``{NodeType: [B]}`` seed ids; batch_size the static
      seed count.
    metadata: ``seed_local`` and ``input_type``.
  """

  FIELDS = ('x_dict', 'y_dict', 'edge_index_dict', 'edge_attr_dict',
            'node_dict', 'node_mask_dict', 'edge_mask_dict', 'batch_dict',
            'metadata')

  def __init__(self, x_dict=None, y_dict=None, edge_index_dict=None,
               edge_attr_dict=None, node_dict=None, node_mask_dict=None,
               edge_mask_dict=None, batch_dict=None, batch_size: int = 0,
               metadata=None):
    self.x_dict = x_dict or {}
    self.y_dict = y_dict or {}
    self.edge_index_dict = edge_index_dict or {}
    self.edge_attr_dict = edge_attr_dict or {}
    self.node_dict = node_dict or {}
    self.node_mask_dict = node_mask_dict or {}
    self.edge_mask_dict = edge_mask_dict or {}
    self.batch_dict = batch_dict or {}
    self.batch_size = batch_size
    self.metadata = metadata if metadata is not None else {}

  def __repr__(self):
    return (f'HeteroBatch(node_types={list(self.node_dict)}, '
            f'edge_types={list(self.edge_index_dict)})')


def _gather_labels(labels: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
  """``labels[ids]`` on the labels' device, 0 where ``ids < 0``: a
  plain gather (`index_select`), as the JAX package's is plain XLA."""
  valid = ids >= 0
  idx = torch.where(valid, ids.long(), 0).clamp(max=labels.shape[0] - 1)
  out = torch.index_select(labels, 0, idx)
  mask = valid.reshape(valid.shape + (1,) * (out.ndim - 1))
  return torch.where(mask, out, torch.zeros((), dtype=out.dtype,
                                            device=out.device))


def to_data(out, node_feature=None, node_label=None,
            edge_feature=None) -> Batch:
  """A `Batch` from a `sampler.SamplerOutput`: ``x`` from the feature
  store by the sampled ids (`data.Feature.get`, the row gather kernel on
  the card), ``y`` by `_gather_labels`, ``edge_attr`` from the edge
  store by the sampled edge ids (the same gather; -1 ids give zero
  rows); the sampler's metadata is forwarded."""
  x = node_feature.get(out.node) if node_feature is not None else None
  y = (_gather_labels(node_label, out.node) if node_label is not None
       else None)
  edge_attr = None
  if edge_feature is not None and out.edge is not None:
    edge_attr = edge_feature.get(out.edge)
  return Batch(x=x, y=y, edge_index=torch.stack([out.row, out.col]),
               edge_attr=edge_attr,
               node=out.node, node_mask=out.node >= 0,
               edge_mask=out.edge_mask, edge=out.edge, batch=out.batch,
               batch_size=out.batch_size,
               num_sampled_nodes=out.num_sampled_nodes,
               num_sampled_edges=out.num_sampled_edges,
               metadata=dict(out.metadata))


def to_hetero_data(out: HeteroSamplerOutput, node_feature_dict=None,
                   node_label_dict=None,
                   edge_feature_dict=None) -> HeteroBatch:
  """A `HeteroBatch` from a `sampler.HeteroSamplerOutput`: each type's
  ``x`` from its feature store (`data.Feature.get`, the row gather
  kernel on the card), ``y`` by `_gather_labels`, and each emitted edge
  type's ``edge_attr`` from the edge store kept under that emitted
  (reversed) type, as the JAX package looks it up: a table kept under
  the forward type is not read.  The sampler's metadata is
  forwarded."""
  x_dict, y_dict = {}, {}
  for ntype, ids in out.node.items():
    if node_feature_dict and ntype in node_feature_dict:
      x_dict[ntype] = node_feature_dict[ntype].get(ids)
    if node_label_dict and node_label_dict.get(ntype) is not None:
      y_dict[ntype] = _gather_labels(node_label_dict[ntype], ids)
  edge_attr_dict = {}
  if edge_feature_dict and out.edge is not None:
    edge_attr_dict = {et: edge_feature_dict[et].get(out.edge[et])
                      for et in out.row
                      if et in edge_feature_dict and et in out.edge}
  batch_size = max((int(v.shape[0]) for v in (out.batch or {}).values()),
                   default=0)
  return HeteroBatch(
      x_dict=x_dict, y_dict=y_dict,
      edge_index_dict={et: torch.stack([out.row[et], out.col[et]])
                       for et in out.row},
      edge_attr_dict=edge_attr_dict,
      node_dict=dict(out.node),
      node_mask_dict={nt: ids >= 0 for nt, ids in out.node.items()},
      edge_mask_dict=dict(out.edge_mask or {}),
      batch_dict=dict(out.batch or {}), batch_size=batch_size,
      metadata=dict(out.metadata))


def collate(data, out):
  """Collate a sampler output against a `data.Dataset` (the one
  implementation behind every single-card loader): a `HeteroBatch` for
  a `HeteroSamplerOutput`, else a `Batch`."""
  if isinstance(out, HeteroSamplerOutput):
    labels = None
    if isinstance(data.node_labels, dict):
      labels = {nt: data.get_node_label_device(nt)
                for nt in data.node_labels}
    feats = (data.node_features if isinstance(data.node_features, dict)
             else None)
    efeats = (data.edge_features if isinstance(data.edge_features, dict)
              else None)
    return to_hetero_data(out, node_feature_dict=feats,
                          node_label_dict=labels, edge_feature_dict=efeats)
  return to_data(out, node_feature=data.node_features,
                 node_label=data.get_node_label_device(),
                 edge_feature=data.get_edge_feature())
