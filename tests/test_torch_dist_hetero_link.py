"""The heterogeneous mesh's link loader and sampled edges in the port
against the JAX package's at P = 4 (the port on the CPU, the JAX side on
four devices of the virtual CPU mesh), on the IGBH example's schema
(`examples/igbh/train_rgnn.py::synthetic`, cut down) with caller-global
edge ids (``edge_ids_dict``) and mod-sharded edge features
(``edge_feat_dict``): `DistHeteroLinkNeighborLoader` in binary mode on a
same-type edge type (paper cites paper), triplet and no-negative modes
on a two-type one (paper written_by author), each with ``with_edge``,
and the static key set of the batches (the node loader's edges, the
stored edges and an epoch with ``prefetch``:
`test_torch_dist_hetero_edges.py`).

The port replays the JAX keys through its ``draws`` provider: the hops'
as `test_torch_dist_gns.jax_key_draws` with the edge type, the
negatives' as `test_torch_dist_link.link_draws` (JAX's
``fold_in(fold_in(step key, partition), 977)``, split into rows and
columns).  Tolerance: batches, metadata and counters byte-equal /
exact.
"""
import numpy as np
import pytest

from examples.igbh.train_rgnn import P as PAPER
from examples.igbh.train_rgnn import synthetic
from graphlearn_tpu.parallel import DistHeteroDataset as JaxDataset
from graphlearn_tpu.parallel import (
    DistHeteroLinkNeighborLoader as JaxLinkLoader)
from graphlearn_tpu.parallel import make_mesh as jax_make_mesh
from graphlearn_tpu_torch.parallel import (DistHeteroDataset,
                                           DistHeteroLinkNeighborLoader)
from graphlearn_tpu_torch.typing import reverse_edge_type
from test_torch_dist_link import link_draws
from test_torch_mesh import _exchange_keys

NP = 4
BATCH = 8
SIZES = dict(npaper=240, nauthor=96, ninst=6, nfos=16, classes=4, d=8)
CITES = (PAPER, 'cites', PAPER)
WRITES = (PAPER, 'written_by', 'author')
FANOUTS = [3, 2]


@pytest.fixture(scope='module')
def data():
  edges, feats, nnodes, topic = synthetic(**SIZES)
  rng = np.random.default_rng(5)
  # caller-global ids: a permutation for cites, the input order for the
  # rest; each edge table's row r belongs to global id r
  ids = {CITES: rng.permutation(len(edges[CITES][0]))}
  efeat = {et: np.stack([np.arange(len(edges[et][0])),
                         rng.standard_normal(len(edges[et][0]))],
                        1).astype(np.float32) for et in (CITES, WRITES)}
  return edges, feats, nnodes, topic, ids, efeat


def _datasets(data):
  edges, feats, nnodes, topic, ids, efeat = data
  kw = dict(node_feat_dict=feats, node_label_dict={PAPER: topic},
            num_nodes_dict=nnodes, edge_ids_dict=ids, edge_feat_dict=efeat)
  return (JaxDataset.from_full_graph(NP, edges, **kw),
          DistHeteroDataset.from_full_graph(NP, edges, device='cpu', **kw))


def _flat(b, torch_side):
  conv = (lambda t: t.numpy()) if torch_side else np.asarray
  out = {}
  for f in ('x_dict', 'y_dict', 'node_dict', 'node_mask_dict',
            'edge_index_dict', 'edge_mask_dict', 'batch_dict',
            'edge_attr_dict'):
    for k, v in getattr(b, f).items():
      out[(f, k)] = conv(v)
  for k, v in b.metadata.items():
    if isinstance(v, dict):
      for kk, vv in v.items():
        out[('metadata', k, kk)] = conv(vv)
    elif k != 'input_type':
      out[('metadata', k)] = conv(v)
  return out


def _assert_equal(jb, tb):
  for i, (a, b) in enumerate(zip(jb, tb)):
    r, g = _flat(a, False), _flat(b, True)
    assert set(g) == set(r), (i, set(g) ^ set(r))
    for key in r:
      assert g[key].dtype == r[key].dtype, (i, key, g[key].dtype)
      np.testing.assert_array_equal(g[key], r[key], err_msg=f'{i} {key}')
    assert b.metadata['input_type'] == a.metadata['input_type']


def _check_edges(batch, ds, data):
  """Every sampled edge id names its edge (the caller's id, from the
  seed-side node to the neighbor) and its gathered row is the table's
  row; masked slots hold -1 and zero rows."""
  edges, _, _, _, ids, efeat = data
  checked = 0
  emitted = {reverse_edge_type(et): et for et in edges}
  for ret, e in batch.metadata['edge_dict'].items():
    et = emitted[ret]
    e = e.numpy()
    em = batch.edge_mask_dict[ret].numpy()
    assert (e[~em] == -1).all() and (e[em] >= 0).all()
    ei = batch.edge_index_dict[ret].numpy()
    nbr_t, seed_t = ret[0], ret[2]
    gid = ids.get(et, np.arange(len(edges[et][0])))
    pos = np.argsort(gid)                     # global id -> input position
    for p in range(NP):
      nb = ds.new2old[nbr_t][batch.node_dict[nbr_t].numpy()[p][ei[p, 0]]]
      sd = ds.new2old[seed_t][batch.node_dict[seed_t].numpy()[p][ei[p, 1]]]
      at = pos[e[p][em[p]]]
      np.testing.assert_array_equal(edges[et][0][at], sd[em[p]])
      np.testing.assert_array_equal(edges[et][1][at], nb[em[p]])
      checked += int(em[p].sum())
    if ret in batch.edge_attr_dict:
      ea = batch.edge_attr_dict[ret].numpy()
      np.testing.assert_array_equal(ea[em], efeat[et][e[em]])
      assert not ea[~em].any()
  return checked


MODES = {
    'cites-binary': (CITES, 'binary'),
    'writes-triplet': (WRITES, ('triplet', 2)),
    'writes-none': (WRITES, None),
}


@pytest.mark.parametrize('mode', list(MODES))
def test_link_loader_byte_equal_to_jax(data, mode):
  et, neg = MODES[mode]
  jds, ds = _datasets(data)
  edges = data[0]
  rows, cols = edges[et]
  seeds = (et, (rows[:90], cols[:90]))     # the last batch padded
  kw = dict(neg_sampling=neg, batch_size=BATCH, shuffle=True, seed=2,
            with_edge=True)
  jl = JaxLinkLoader(jds, FANOUTS, seeds, mesh=jax_make_mesh(NP), **kw)
  tl = DistHeteroLinkNeighborLoader(ds, FANOUTS, seeds, draws=link_draws(2),
                                    device='cpu', **kw)
  assert len(tl) == len(jl) == 3
  jb = list(jl)
  tb = list(tl)
  _assert_equal(jb, tb)
  js = jl.sampler.exchange_stats(tick_metrics=False)
  ts = tl.sampler.exchange_stats(tick_metrics=False)
  for k in _exchange_keys(js) + ['dist.negative.lost']:
    assert ts[k] == js[k], k
  edge_set = set(zip(rows.tolist(), cols.tolist()))
  keys = {tuple(sorted(b.edge_index_dict)) for b in tb}
  assert len(keys) == 1
  s_t, _, d_t = et
  for b in tb:
    assert set(b.metadata['edge_dict']) == set(b.edge_index_dict)
    assert _check_edges(b, ds, data) > 0
    md = b.metadata
    if neg == 'binary':
      eli, keep = md['edge_label_index'].numpy(), md[
          'edge_label_mask'].numpy()
      lab = md['edge_label'].numpy()
      for p in range(NP):
        src = ds.new2old[s_t][b.node_dict[s_t].numpy()[p][eli[p, 0]]]
        dst = ds.new2old[d_t][b.node_dict[d_t].numpy()[p][eli[p, 1]]]
        for a, c, y, k in zip(src, dst, lab[p], keep[p]):
          if k:
            assert ((a, c) in edge_set) == (y > 0)
    elif neg is not None:
      dn = md['dst_neg_index'].numpy()
      assert dn.shape == (NP, BATCH, 2)
      for p in range(NP):
        src = ds.new2old[s_t][b.node_dict[s_t].numpy()[p][
            md['src_index'].numpy()[p]]]
        for j in range(BATCH):
          for c in dn[p, j][dn[p, j] >= 0]:
            d = ds.new2old[d_t][b.node_dict[d_t].numpy()[p][c]]
            assert (src[j], d) not in edge_set
  pad = tb[-1].batch_dict[s_t].numpy() < 0
  assert pad.any() and not pad.all()
