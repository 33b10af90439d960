"""User-facing data manager: topology, node and edge features and
labels, for a homogeneous graph or a heterogeneous one keyed by node and
edge type (the JAX package's `data/dataset.py`)."""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..typing import EdgeType, NodeType, as_str
from ..utils import convert_to_array, resolve_device
from .feature import Feature
from .graph import Graph
from .topology import CSRTopo


def _is_tensor_csr(ei) -> bool:
  return (isinstance(ei, (tuple, list)) and len(ei) == 2
          and all(isinstance(t, torch.Tensor) for t in ei))


def _check_tensor_csr(ei, num_nodes, etype=None) -> None:
  """The one invariant of a CSR taken as is that costs no sync: the
  indptr's row count against an explicit ``num_nodes``."""
  if num_nodes is None:
    return
  got = ei[0].numel() - 1
  if got != int(num_nodes):
    where = f' for edge type {etype!r}' if etype is not None else ''
    raise ValueError(
        f'CSR indptr{where} implies {got} nodes (indptr.numel() - 1) but '
        f'num_nodes={int(num_nodes)} was given')


def _etype_num_nodes(num_nodes, etype):
  """``num_nodes`` for one edge type's rows: a scalar applies to every
  edge type; a dict is keyed by edge type or by node type (the CSR row
  count is the SOURCE type's node count)."""
  if not isinstance(num_nodes, dict):
    return num_nodes
  nn = num_nodes.get(etype)
  if nn is None and isinstance(etype, tuple):
    nn = num_nodes.get(etype[0])
  return nn


class Dataset:
  """Holds graph topology, features and labels ready for sampling.

  Every ``init_*`` method takes one value (homogeneous) or a dict keyed
  by edge type (``init_graph``) or node type (features, labels).
  """

  def __init__(self, graph=None, node_features=None, node_labels=None,
               edge_features=None):
    self.graph = graph
    self.node_features = node_features
    self.edge_features = edge_features
    self.node_labels = node_labels
    self._device_labels: Dict[Optional[NodeType], torch.Tensor] = {}
    self._explicit_num_nodes = None
    #: the `streaming.StreamingGraph` behind ``graph`` (`attach_stream`)
    self.stream = None

  def init_graph(self, edge_index=None, edge_ids=None, layout='COO',
                 device='cuda', num_nodes=None):
    """Build the device graph(s) from COO/CSR/CSC input.

    A ``(indptr, indices)`` pair of torch tensors with
    ``layout='CSR'`` is taken as canonical CSR (columns sorted within
    rows) and moved to ``device`` as is — the path for graphs made on
    the card.  Anything else is canonicalized on the host by
    `CSRTopo`.  ``edge_index`` may be a dict ``{EdgeType: input}``
    (heterogeneous); ``num_nodes`` is then a scalar, or a dict keyed by
    edge type or by node type (read for each edge type's source type),
    and ``edge_ids``/``layout`` may be dicts too.  ``edge_ids`` are the
    ids a sampler with ``with_edge`` emits (and edge features are read
    by): by default each edge's index in a COO input, or its CSR
    position in a CSR input.
    """
    if edge_index is None:
      return self
    dev = resolve_device(device)
    self._explicit_num_nodes = (num_nodes if isinstance(num_nodes, dict)
                                else None)
    if isinstance(edge_index, dict):
      if layout == 'CSR' and all(_is_tensor_csr(ei)
                                 for ei in edge_index.values()):
        for etype, ei in edge_index.items():
          _check_tensor_csr(ei, _etype_num_nodes(num_nodes, etype), etype)
        self.graph = {etype: Graph.from_tensors(
            ei[0], ei[1], device=dev,
            edge_ids=(edge_ids.get(etype) if isinstance(edge_ids, dict)
                      else None))
                      for etype, ei in edge_index.items()}
        return self
      graphs = {}
      for etype, ei in edge_index.items():
        eids = edge_ids.get(etype) if isinstance(edge_ids, dict) else None
        lay = layout.get(etype) if isinstance(layout, dict) else layout
        topo = CSRTopo(ei, edge_ids=eids, layout=lay,
                       num_nodes=_etype_num_nodes(num_nodes, etype))
        graphs[etype] = Graph(topo, device=dev)
      self.graph = graphs
      return self
    if layout == 'CSR' and _is_tensor_csr(edge_index):
      _check_tensor_csr(edge_index, num_nodes)
      self.graph = Graph.from_tensors(edge_index[0], edge_index[1],
                                      device=dev, edge_ids=edge_ids)
      return self
    topo = CSRTopo(edge_index, edge_ids=edge_ids, layout=layout,
                   num_nodes=num_nodes)
    self.graph = Graph(topo, device=dev)
    return self

  def init_node_features(self, node_feature_data=None, id2idx=None,
                         sort_func: Optional[Callable] = None,
                         split_ratio: float = 1.0, device='cuda',
                         dtype: Optional[torch.dtype] = None,
                         cold_cache_rows='auto'):
    """Create the node feature store(s) (see `Feature`); a dict of
    tables (``id2idx`` then a dict too) makes one store per node type.

    ``sort_func`` (e.g. `data.reorder.sort_by_in_degree`) reorders a
    host table hottest-first and supplies the id->row map, when the
    table is tiered (``0 < split_ratio < 1``), no ``id2idx`` is given
    and a topology is known: ``sort_func(feats, split_ratio, topo) ->
    (feats, id2index)``, the topology read for its ``indices`` (for a
    node type, the first edge type into it, else the last out of it).  A
    table already on the card cannot be reordered (ValueError).
    """
    if node_feature_data is None:
      return self
    if isinstance(node_feature_data, dict):
      self.node_features = {
          ntype: self._build_feature(
              feats, id2idx.get(ntype) if isinstance(id2idx, dict) else None,
              sort_func, split_ratio, device, dtype, cold_cache_rows,
              self._topo_for_ntype(ntype))
          for ntype, feats in node_feature_data.items()}
    else:
      topo = None
      if isinstance(self.graph, Graph):
        topo = self.graph.csr_topo or self.graph
      self.node_features = self._build_feature(
          node_feature_data, id2idx, sort_func, split_ratio, device, dtype,
          cold_cache_rows, topo)
    return self

  def _topo_for_ntype(self, ntype: NodeType):
    if not isinstance(self.graph, dict):
      return None
    candidate = None
    for (src, _, dst), g in self.graph.items():
      if dst == ntype:            # in-degree hotness counts incoming edges
        return g.csr_topo or g
      if src == ntype:
        candidate = g.csr_topo or g
    return candidate

  @staticmethod
  def _build_feature(feats, id2idx, sort_func, split_ratio, device, dtype,
                     cold_cache_rows, topo) -> Feature:
    if sort_func is not None:
      if isinstance(feats, torch.Tensor) and feats.device.type != 'cpu':
        raise ValueError(
            'sort_func cannot reorder a device-resident feature table; '
            'reorder it on the host (and pass id2idx) before moving it '
            'to the card')
      if id2idx is None and topo is not None and 0.0 < split_ratio < 1.0:
        feats, id2idx = sort_func(feats, split_ratio, topo)
    return Feature(feats, id2index=id2idx, split_ratio=split_ratio,
                   device=device, dtype=dtype,
                   cold_cache_rows=cold_cache_rows)

  def init_edge_features(self, edge_feature_data=None, id2idx=None,
                         split_ratio: float = 1.0, device='cuda',
                         dtype: Optional[torch.dtype] = None,
                         cold_cache_rows='auto'):
    """Create the edge feature store(s), rows addressed by edge id
    (`init_graph`'s ``edge_ids``): one `Feature`, or a dict keyed by
    edge type (``id2idx`` then a dict too), tiered by ``split_ratio``
    as node features are.  A batch reads them when its sampler emits
    edge ids (``with_edge``)."""
    if edge_feature_data is None:
      return self
    if isinstance(edge_feature_data, dict):
      self.edge_features = {
          etype: Feature(feats,
                         id2index=(id2idx.get(etype)
                                   if isinstance(id2idx, dict) else None),
                         split_ratio=split_ratio, device=device, dtype=dtype,
                         cold_cache_rows=cold_cache_rows)
          for etype, feats in edge_feature_data.items()}
    else:
      self.edge_features = Feature(edge_feature_data, id2index=id2idx,
                                   split_ratio=split_ratio, device=device,
                                   dtype=dtype,
                                   cold_cache_rows=cold_cache_rows)
    return self

  def get_edge_feature(self, etype: Optional[EdgeType] = None):
    """The edge `Feature`; on a heterogeneous dataset the one of
    ``etype`` (None when it has none)."""
    if isinstance(self.edge_features, dict):
      return self.edge_features.get(etype)
    return self.edge_features

  def init_node_labels(self, node_label_data=None):
    """Node labels, kept as given: a torch tensor stays where it is,
    anything else becomes a host numpy array; a dict holds one label
    array per node type."""
    if node_label_data is None:
      return self

    def keep(lab):
      return (lab if isinstance(lab, torch.Tensor)
              else convert_to_array(lab))
    if isinstance(node_label_data, dict):
      self.node_labels = {nt: keep(v) for nt, v in node_label_data.items()}
    else:
      self.node_labels = keep(node_label_data)
    self._device_labels = {}        # uploaded again on the next collate
    return self

  def get_node_label(self, ntype: Optional[NodeType] = None):
    if isinstance(self.node_labels, dict):
      return self.node_labels.get(ntype)
    return self.node_labels

  def get_node_label_device(self, ntype: Optional[NodeType] = None
                            ) -> Optional[torch.Tensor]:
    """The labels (of ``ntype`` on a heterogeneous dataset) on the
    graph's device, uploaded once and cached: batch collation gathers
    labels on the card, with no per-batch host round trip (the JAX
    package's `get_node_label_device`)."""
    lab = self.get_node_label(ntype)
    if lab is None:
      return None
    dev = self.device
    cached = self._device_labels.get(ntype)
    if cached is None or cached.device != dev:
      if not isinstance(lab, torch.Tensor):
        lab = torch.from_numpy(np.ascontiguousarray(lab))
      cached = self._device_labels[ntype] = lab.to(dev)
    return cached

  @property
  def device(self) -> torch.device:
    """The graph's device (every edge type's, on a heterogeneous
    dataset)."""
    g = self.graph
    if isinstance(g, dict):
      g = next(iter(g.values()))
    return g.device

  def num_nodes_dict(self) -> Dict[NodeType, int]:
    """Node counts by type on a heterogeneous dataset: explicit
    ``init_graph`` counts and feature-table rows (both include isolated
    nodes) merged with every edge type's source rows and largest
    destination id.  Samplers size their capacity plans from it."""
    out: Dict[NodeType, int] = {}
    for key, n in (self._explicit_num_nodes or {}).items():
      nt = key[0] if isinstance(key, tuple) else key
      out[nt] = max(out.get(nt, 0), int(n))
    if isinstance(self.node_features, dict):
      for nt, f in self.node_features.items():
        out[nt] = max(out.get(nt, 0), f.size(0))
    if isinstance(self.graph, dict):
      for (s, _, d), g in self.graph.items():
        out[s] = max(out.get(s, 0), g.num_nodes)
        out[d] = max(out.get(d, 0), g.max_index() + 1)
    return out

  def attach_stream(self, stream) -> 'Dataset':
    """Back this (homogeneous) dataset's topology with a
    `streaming.StreamingGraph`: ``self.graph`` becomes a `Graph` over
    the stream's CURRENT view and ``self.stream`` carries the handle
    version-fencing consumers re-pin from (the `ServingEngine`, once per
    dispatch).  Consumers that read ``self.graph`` once keep the version
    pinned when they read it (a complete graph, never a torn one); call
    again after a quiesce to re-snapshot.  A dataset with edge features
    cannot follow a stream (NotImplementedError, as in JAX): streamed
    edges would get ids past the frozen edge table."""
    if self.edge_features is not None:
      raise NotImplementedError(
          'attach_stream on a dataset with edge features is not supported: '
          'streamed edges would get ids past the frozen edge-feature table')
    self.stream = stream
    self.graph = Graph.from_view(stream.pin())
    return self

  def get_graph(self, etype: Optional[EdgeType] = None):
    """The `Graph`; on a heterogeneous dataset the graph of ``etype``,
    or the dict of all when ``etype`` is None."""
    if isinstance(self.graph, dict) and etype is not None:
      return self.graph.get(etype)
    return self.graph

  def get_edge_types(self):
    """The edge types of a heterogeneous dataset (None otherwise)."""
    if isinstance(self.graph, dict):
      return list(self.graph.keys())
    return None

  @property
  def is_hetero(self) -> bool:
    return isinstance(self.graph, dict)

  def __repr__(self):
    if self.is_hetero:
      etypes = ', '.join(as_str(e) for e in self.graph)
      return f'Dataset(hetero, edge_types=[{etypes}])'
    return f'Dataset(graph={self.graph!r})'
