"""Node and edge type vocabulary (the JAX package's `typing.py:20-58`).

A node type is a string; an edge type the triplet ``(src, rel, dst)``,
sampled from ``src`` nodes towards ``dst`` nodes.
"""
from __future__ import annotations

from typing import Tuple, Union

#: Node types are denoted by a single string.
NodeType = str

#: Edge types are denoted by a triplet of strings ``(src, rel, dst)``.
EdgeType = Tuple[str, str, str]

EDGE_TYPE_STR_SPLIT = '__'


def as_str(type: Union[NodeType, EdgeType]) -> str:
  """Canonical string form of a node or edge type (``'src__rel__dst'``
  for an edge type); ``''`` for anything else."""
  if isinstance(type, NodeType):
    return type
  if isinstance(type, (list, tuple)) and len(type) == 3:
    return EDGE_TYPE_STR_SPLIT.join(type)
  return ''


def edge_type_from_str(s: str) -> Union[NodeType, EdgeType]:
  """Inverse of `as_str` for edge types."""
  parts = s.split(EDGE_TYPE_STR_SPLIT)
  if len(parts) == 3:
    return tuple(parts)
  return s


def reverse_edge_type(etype: EdgeType) -> EdgeType:
  """``(dst, rel', src)``: ``rel'`` gains or loses the ``rev_`` prefix,
  except for a self-relation (``src == dst``), whose name stays."""
  src, edge, dst = etype
  if not src == dst:
    if edge.split('_', 1)[0] == 'rev':
      edge = edge.split('_', 1)[1]
    else:
      edge = 'rev_' + edge
  return (dst, edge, src)
