"""Host-side (numpy) dataset handle for sampling subprocesses (the JAX
package's `distributed/host_dataset.py`).

Producer workers never touch the card: they sample on the CPU with the
native ops (``csrc/host/cpu_ops.cc``, ``csrc/host/inducer.cc``) over
plain numpy CSR + feature arrays, staged into POSIX shared memory for
``forkserver`` / ``spawn`` workers (`shm_arrays.share_dataset`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np



class HostDataset:
  """CSR topology + features/labels as host numpy arrays.

  Attributes:
    indptr / indices / edge_ids: CSR (``edge_ids`` optional).
    node_features: ``[N, D]`` or None.
    node_labels: ``[N]`` or None.
    edge_features: ``[E, De]`` indexed by GLOBAL edge id, or None.
  """

  def __init__(self, indptr, indices, edge_ids=None, node_features=None,
               node_labels=None, edge_features=None):
    self.indptr = np.ascontiguousarray(indptr, np.int64)
    self.indices = np.ascontiguousarray(indices, np.int64)
    self.edge_ids = (np.ascontiguousarray(edge_ids, np.int64)
                     if edge_ids is not None else None)
    self.node_features = (np.asarray(node_features)
                          if node_features is not None else None)
    self.node_labels = (np.asarray(node_labels)
                        if node_labels is not None else None)
    self.edge_features = (np.asarray(edge_features)
                          if edge_features is not None else None)
    #: set for ONE partition's shard (local edges only over the global
    #: node space).  A plain `HostNeighborSampler` refuses such
    #: datasets: remote neighborhoods would silently come back empty.
    self.node_pb: Optional[np.ndarray] = None
    self.partition_idx: Optional[int] = None

  @property
  def num_nodes(self) -> int:
    return len(self.indptr) - 1

  @property
  def num_edges(self) -> int:
    return len(self.indices)

  @classmethod
  def from_coo(cls, rows, cols, num_nodes: Optional[int] = None,
               node_features=None, node_labels=None,
               edge_features=None) -> 'HostDataset':
    """``edge_features`` rows follow the INPUT edge order (edge id i =
    i-th COO edge), matching `Dataset.init_edge_features`."""
    from ..native import coo_to_csr
    rows = np.asarray(rows)
    cols = np.asarray(cols)
    n = int(num_nodes if num_nodes is not None
            else max(rows.max(initial=-1), cols.max(initial=-1)) + 1)
    indptr, indices, perm = coo_to_csr(rows, cols, n)
    return cls(indptr, indices, edge_ids=perm, node_features=node_features,
               node_labels=node_labels, edge_features=edge_features)

  @classmethod
  def from_dataset(cls, dataset) -> 'HostDataset':
    """Borrow the host copies inside a `graphlearn_tpu_torch.data.
    Dataset` (a graph built from card tensors is copied down once)."""
    indptr, indices, eids = _host_csr(dataset.get_graph())
    feats = dataset.node_features
    efeats = dataset.get_edge_feature()
    return cls(
        indptr, indices, edge_ids=eids,
        node_features=_host_table(feats),
        node_labels=_host_array(dataset.get_node_label()),
        edge_features=_host_table(efeats))

  @classmethod
  def from_partition_dir(cls, root, partition_idx: int) -> 'HostDataset':
    """One partition's shard of the offline layout: the partitioned
    plane, port slice 25."""
    raise NotImplementedError(
        'HostDataset.from_partition_dir loads an offline partition: the '
        'partitioned host plane comes in port slice 25')


def _host_array(a):
  """A host numpy copy of a label / id array (torch or numpy)."""
  if a is None:
    return None
  if hasattr(a, 'detach'):
    return a.detach().cpu().numpy()
  return np.asarray(a)


def _host_table(feature):
  """The whole table of a `data.Feature` as host numpy, or None."""
  if feature is None:
    return None
  return feature.host_get().numpy()


def _host_csr(graph):
  """``(indptr, indices, edge_ids)`` host arrays of a `data.Graph`."""
  topo = graph.csr_topo
  if topo is not None:
    return topo.indptr, topo.indices, topo.edge_ids
  eids = graph.edge_ids
  return (graph.indptr.cpu().numpy(), graph.indices.cpu().numpy(),
          None if eids is None else eids.cpu().numpy())


class HostHeteroDataset:
  """Per-edge-type CSR + per-node-type features/labels, host numpy.

  The heterogeneous twin of `HostDataset` for sampling subprocesses —
  the data the reference's hetero `DistNeighborSampler` reads through
  its per-etype `DistGraph` (`distributed/dist_neighbor_sampler.py:
  192-253` hetero path).

  Attributes:
    csr: ``{EdgeType: (indptr, indices, edge_ids)}`` in sampling
      direction src→dst (``edge_ids`` may be None).
    num_nodes: ``{NodeType: int}``.
    node_features / node_labels: ``{NodeType: array}`` (optional).
    edge_features: ``{EdgeType: [E, De]}`` by global eid (optional).
  """

  def __init__(self, csr, num_nodes, node_features=None, node_labels=None,
               edge_features=None):
    self.csr = {}
    for et, (indptr, indices, eids) in csr.items():
      self.csr[tuple(et)] = (
          np.ascontiguousarray(indptr, np.int64),
          np.ascontiguousarray(indices, np.int64),
          np.ascontiguousarray(eids, np.int64) if eids is not None
          else None)
    self.num_nodes = {nt: int(n) for nt, n in num_nodes.items()}
    self.node_features = {nt: np.asarray(v) for nt, v in
                          (node_features or {}).items()}
    self.node_labels = {nt: np.asarray(v) for nt, v in
                        (node_labels or {}).items()}
    self.edge_features = {tuple(et): np.asarray(v) for et, v in
                          (edge_features or {}).items()}
    #: see `HostDataset.node_pb` — here a per-node-type dict.
    self.node_pb = None
    self.partition_idx = None

  @property
  def edge_types(self):
    return tuple(self.csr.keys())

  @property
  def node_types(self):
    return tuple(sorted({t for (s, _, d) in self.csr for t in (s, d)}
                        | set(self.num_nodes)))

  @classmethod
  def from_coo(cls, edge_index_dict, num_nodes_dict=None,
               node_features=None, node_labels=None,
               edge_features=None) -> 'HostHeteroDataset':
    """Build from ``{EdgeType: (rows, cols)}`` COO dicts."""
    from ..native import coo_to_csr
    num_nodes = dict(num_nodes_dict or {})
    for (s, _, d), (rows, cols) in edge_index_dict.items():
      rows, cols = np.asarray(rows), np.asarray(cols)
      num_nodes[s] = max(num_nodes.get(s, 0),
                         int(rows.max(initial=-1)) + 1)
      num_nodes[d] = max(num_nodes.get(d, 0),
                         int(cols.max(initial=-1)) + 1)
    csr = {}
    for et, (rows, cols) in edge_index_dict.items():
      indptr, indices, perm = coo_to_csr(
          np.asarray(rows), np.asarray(cols), num_nodes[et[0]])
      csr[et] = (indptr, indices, perm)
    return cls(csr, num_nodes, node_features=node_features,
               node_labels=node_labels, edge_features=edge_features)

  @classmethod
  def from_dataset(cls, dataset) -> 'HostHeteroDataset':
    """Borrow the host copies inside a heterogeneous `graphlearn_tpu_torch.
    data.Dataset`."""
    assert dataset.is_hetero, 'use HostDataset for homogeneous datasets'
    csr = {et: _host_csr(dataset.get_graph(et))
           for et in dataset.get_edge_types()}
    feats = {nt: _host_table(f)
             for nt, f in (dataset.node_features or {}).items()}
    labels = {}
    if isinstance(dataset.node_labels, dict):
      labels = {nt: _host_array(lab)
                for nt, lab in dataset.node_labels.items()}
    efeats = {}
    if isinstance(dataset.edge_features, dict):
      efeats = {tuple(et): _host_table(f)
                for et, f in dataset.edge_features.items()}
    return cls(csr, dataset.num_nodes_dict(), node_features=feats,
               node_labels=labels, edge_features=efeats)

  @classmethod
  def from_partition_dir(cls, root, partition_idx: int
                         ) -> 'HostHeteroDataset':
    """One hetero partition's shard of the offline layout: port slice
    25."""
    raise NotImplementedError(
        'HostHeteroDataset.from_partition_dir loads an offline partition: '
        'the partitioned host plane comes in port slice 25')
