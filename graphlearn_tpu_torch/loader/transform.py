"""`Batch`: the PyG-``Data``-shaped mini-batch the loaders yield (the
JAX package's `loader/transform.py:45`), with the fields the mesh
loader fills.  Padded slots hold -1 ids and zero rows; the masks say
which slots are real."""
from __future__ import annotations


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
