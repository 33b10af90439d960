"""User-facing data manager for a homogeneous graph: topology, node
features and labels.  Heterogeneous datasets are slice 8 of the
ROADMAP."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..utils import convert_to_array, resolve_device
from .feature import Feature
from .graph import Graph
from .topology import CSRTopo


class Dataset:
  """Holds graph topology, features and labels ready for sampling."""

  def __init__(self, graph: Optional[Graph] = None,
               node_features: Optional[Feature] = None,
               node_labels=None):
    self.graph = graph
    self.node_features = node_features
    self.node_labels = node_labels
    self._device_labels = None
    #: the `streaming.StreamingGraph` behind ``graph`` (`attach_stream`)
    self.stream = None

  def init_graph(self, edge_index=None, edge_ids=None, layout='COO',
                 device='cuda', num_nodes=None):
    """Build the device graph from COO/CSR/CSC input.

    A ``(indptr, indices)`` pair of torch tensors with
    ``layout='CSR'`` is taken as canonical CSR (columns sorted within
    rows) and moved to ``device`` as is — the path for graphs made on
    the card.  Anything else is canonicalized on the host by
    `CSRTopo`.
    """
    if edge_index is None:
      return self
    if isinstance(edge_index, dict):
      raise NotImplementedError(
          'heterogeneous graphs are not ported yet: they are slice 8 of '
          'the ROADMAP')
    dev = resolve_device(device)
    if (layout == 'CSR' and isinstance(edge_index, (tuple, list))
        and len(edge_index) == 2
        and all(isinstance(t, torch.Tensor) for t in edge_index)):
      indptr, indices = edge_index
      if num_nodes is not None and indptr.numel() - 1 != int(num_nodes):
        raise ValueError(
            f'CSR indptr implies {indptr.numel() - 1} nodes '
            f'(indptr.numel() - 1) but num_nodes={int(num_nodes)} was given')
      self.graph = Graph.from_tensors(indptr, indices, device=dev)
      return self
    topo = CSRTopo(edge_index, edge_ids=edge_ids, layout=layout,
                   num_nodes=num_nodes)
    self.graph = Graph(topo, device=dev)
    return self

  def init_node_features(self, node_feature_data=None, id2idx=None,
                         split_ratio: float = 1.0, device='cuda',
                         dtype: Optional[torch.dtype] = None):
    """Create the node feature store (see `Feature`)."""
    if node_feature_data is None:
      return self
    self.node_features = Feature(node_feature_data, id2index=id2idx,
                                 split_ratio=split_ratio, device=device,
                                 dtype=dtype)
    return self

  def init_node_labels(self, node_label_data=None):
    """Node labels, kept as given: a torch tensor stays where it is,
    anything else becomes a host numpy array."""
    if node_label_data is None:
      return self
    self.node_labels = (node_label_data
                        if isinstance(node_label_data, torch.Tensor)
                        else convert_to_array(node_label_data))
    self._device_labels = None        # uploaded again on the next collate
    return self

  def get_node_label_device(self) -> Optional[torch.Tensor]:
    """The labels on the graph's device, uploaded once and cached:
    batch collation gathers labels on the card, with no per-batch host
    round trip (the JAX package's `get_node_label_device`)."""
    if self.node_labels is None:
      return None
    dev = self.graph.device
    if self._device_labels is None or self._device_labels.device != dev:
      lab = self.node_labels
      if not isinstance(lab, torch.Tensor):
        lab = torch.from_numpy(np.ascontiguousarray(lab))
      self._device_labels = lab.to(dev)
    return self._device_labels

  def attach_stream(self, stream) -> 'Dataset':
    """Back this dataset's topology with a `streaming.StreamingGraph`:
    ``self.graph`` becomes a `Graph` over the stream's CURRENT view and
    ``self.stream`` carries the handle version-fencing consumers re-pin
    from (the `ServingEngine`, once per dispatch).  Consumers that read
    ``self.graph`` once keep the version pinned when they read it (a
    complete graph, never a torn one); call again after a quiesce to
    re-snapshot."""
    self.stream = stream
    self.graph = Graph.from_view(stream.pin())
    return self

  def get_graph(self) -> Optional[Graph]:
    return self.graph

  def __repr__(self):
    return f'Dataset(graph={self.graph!r})'
