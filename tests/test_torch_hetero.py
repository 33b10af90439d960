"""The heterogeneous data and sampling path against the JAX package: the
type vocabulary, a hetero `Dataset`, `_plan_capacities`,
`HeteroNeighborSampler.sample_from_nodes` and `NeighborLoader` over
edge-type dicts.

The graph is the shape of `examples/hetero/train_hgt_mag.py`'s
synthetic one: papers, authors and institutions under five edge types
(``cites``, ``writes``/``rev_writes``, ``affiliated_with`` and its
reverse), with hubs past the sampler's window, take-all rows, papers
without authors and isolated nodes.  The port's sampler replays the
JAX sampler's keys through its ``draws(step, hop, rows, k, w, etype)``
provider: ``fold_in(fold_in(fold_in(key(seed), step), hop), etype)``,
split into the uniform and the Gumbel stream, ``etype`` the index in
the sorted edge types.  Tolerances: every output byte-equal, dtypes
included.
"""
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphlearn_tpu import typing as jax_typing
from graphlearn_tpu.data import Dataset as JaxDataset
from graphlearn_tpu.loader import NeighborLoader as JaxLoader
from graphlearn_tpu.sampler import NodeSamplerInput as JaxInput
from graphlearn_tpu.sampler.hetero_neighbor_sampler import (
    HeteroNeighborSampler as JaxHeteroSampler)
from graphlearn_tpu.sampler.hetero_neighbor_sampler import (
    _plan_capacities as jax_plan)
from graphlearn_tpu.sampler.hetero_neighbor_sampler import (
    normalize_fanouts as jax_normalize)
from graphlearn_tpu_torch import typing as tt
from graphlearn_tpu_torch.data import Dataset
from graphlearn_tpu_torch.loader import HeteroBatch, NeighborLoader
from graphlearn_tpu_torch.ops import (CounterDraws, TorchDraws,
                                      hash_draws, sample_one_hop)
from graphlearn_tpu_torch.sampler import (EdgeSamplerInput,
                                          HeteroNeighborSampler,
                                          HeteroSamplerOutput,
                                          NodeSamplerInput)
from graphlearn_tpu_torch.sampler.hetero_neighbor_sampler import (
    _plan_capacities, normalize_fanouts)

P, A, I = 'paper', 'author', 'institution'
CITES = (P, 'cites', P)
WRITES = (A, 'writes', P)
REV_WRITES = (P, 'rev_writes', A)
AFFIL = (A, 'affiliated_with', I)
REV_AFFIL = (I, 'rev_affiliated_with', A)
NP, NA, NI, D, CLASSES = 120, 90, 12, 6, 4
NNODES = {P: NP, A: NA, I: NI}


def hetero_graph(seed=0):
  """COO edges, features and paper labels of the three-type graph."""
  rng = np.random.default_rng(seed)
  cdeg = rng.integers(0, 5, NP)
  cdeg[:3] = 90                         # hubs past the 64-wide window
  cdeg[3:10] = rng.integers(10, 40, 7)  # window rows
  cdeg[-10:] = 0                        # papers that cite nothing
  crow = np.repeat(np.arange(NP), cdeg)
  ccol = rng.integers(0, NP, crow.shape[0])
  wdeg = rng.integers(0, 4, NA)
  wdeg[:2] = 70
  wrow = np.repeat(np.arange(NA), wdeg)
  wcol = rng.integers(0, NP - 20, wrow.shape[0])   # 20 papers: no author
  arow = np.arange(NA - 5)
  acol = rng.integers(0, NI, arow.shape[0])
  edges = {CITES: (crow, ccol), WRITES: (wrow, wcol),
           REV_WRITES: (wcol, wrow), AFFIL: (arow, acol),
           REV_AFFIL: (acol, arow)}
  feats = {t: rng.standard_normal((n, D)).astype(np.float32)
           for t, n in NNODES.items()}
  labels = rng.integers(0, CLASSES, NP).astype(np.int32)
  return edges, feats, labels


def jax_hetero_draws(seed):
  """A draws provider that replays the JAX `HeteroNeighborSampler`'s
  keys."""
  base = jax.random.key(seed)

  def draws(step, hop, rows, k, w, etype):
    key = jax.random.fold_in(jax.random.fold_in(
        jax.random.fold_in(base, step), hop), etype)
    k_rand, k_win = jax.random.split(key)
    u = jax.random.uniform(k_rand, (rows, k))
    g = jax.random.gumbel(k_win, (rows, w), dtype=jnp.float32)
    return torch.from_numpy(np.array(u)), torch.from_numpy(np.array(g))
  return draws


def datasets(seed=0, split_ratio=1.0):
  edges, feats, labels = hetero_graph(seed)
  jds = (JaxDataset().init_graph(edges, layout='COO', num_nodes=NNODES)
         .init_node_features(feats, split_ratio=split_ratio)
         .init_node_labels({P: labels}))
  ds = (Dataset().init_graph(edges, layout='COO', num_nodes=NNODES,
                             device='cpu')
        .init_node_features(feats, split_ratio=split_ratio, device='cpu')
        .init_node_labels({P: labels}))
  return jds, ds, feats, labels


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
  for env in ('GLT_PALLAS_SAMPLE', 'GLT_PALLAS'):
    monkeypatch.delenv(env, raising=False)


def _same(got: torch.Tensor, ref, what):
  ref = np.asarray(ref)
  assert got.numpy().dtype == ref.dtype, what
  np.testing.assert_array_equal(got.numpy(), ref, err_msg=what)


@pytest.mark.parametrize('etype', [CITES, WRITES, REV_WRITES, AFFIL,
                                   REV_AFFIL, ('a', 'revise', 'b'),
                                   ('a', 'rev_x_y', 'b'), ('a', 'x', 'a')])
def test_type_vocabulary_matches_jax(etype):
  assert tt.reverse_edge_type(etype) == jax_typing.reverse_edge_type(etype)
  assert tt.as_str(etype) == jax_typing.as_str(etype)
  s = tt.as_str(etype)
  assert tt.edge_type_from_str(s) == jax_typing.edge_type_from_str(s)
  assert tt.as_str(P) == jax_typing.as_str(P) == P
  assert tt.as_str(5) == jax_typing.as_str(5) == ''


@pytest.mark.parametrize('form', ['coo', 'csr_tensors'])
def test_hetero_dataset_matches_jax(form):
  edges, feats, labels = hetero_graph()
  jds = JaxDataset().init_graph(edges, layout='COO', num_nodes=NNODES)
  if form == 'coo':
    ds = Dataset().init_graph(edges, layout='COO', num_nodes=NNODES,
                              device='cpu')
  else:
    csr = {et: (torch.tensor(np.asarray(g.indptr, np.int64)),
                torch.tensor(np.asarray(g.indices, np.int32)))
           for et, g in jds.graph.items()}
    ds = Dataset().init_graph(csr, layout='CSR', num_nodes=NNODES,
                              device='cpu')
  assert ds.is_hetero and jds.is_hetero
  assert ds.get_edge_types() == jds.get_edge_types()
  for et in jds.get_edge_types():
    ref, got = jds.get_graph(et), ds.get_graph(et)
    np.testing.assert_array_equal(got.indptr.numpy(),
                                  np.asarray(ref.indptr, np.int64))
    _same(got.indices, ref.indices, f'{et} indices')
    assert got.num_nodes == ref.num_nodes
  assert ds.num_nodes_dict() == jds.num_nodes_dict() == NNODES
  ds.init_node_features(feats, device='cpu').init_node_labels({P: labels})
  jds.init_node_features(feats).init_node_labels({P: labels})
  assert ds.num_nodes_dict() == jds.num_nodes_dict()
  for nt in NNODES:
    np.testing.assert_array_equal(
        ds.node_features[nt].get(torch.arange(NNODES[nt])).numpy(),
        feats[nt])
  _same(ds.get_node_label_device(P), jds.get_node_label_device(P),
        'labels')
  assert ds.get_node_label_device(A) is None


def test_hetero_dataset_refuses_a_row_count_mismatch():
  edges, _, _ = hetero_graph()
  jds = JaxDataset().init_graph(edges, layout='COO', num_nodes=NNODES)
  csr_t = {et: (torch.tensor(np.asarray(g.indptr, np.int64)),
                torch.tensor(np.asarray(g.indices, np.int32)))
           for et, g in jds.graph.items()}
  csr_j = {et: (jnp.asarray(g.indptr), jnp.asarray(g.indices))
           for et, g in jds.graph.items()}
  bad = dict(NNODES, author=NA + 1)
  with pytest.raises(ValueError, match='implies') as got:
    Dataset().init_graph(csr_t, layout='CSR', num_nodes=bad, device='cpu')
  with pytest.raises(ValueError, match='implies') as ref:
    JaxDataset().init_graph(csr_j, layout='CSR', num_nodes=bad)
  for msg in (str(got.value), str(ref.value)):
    assert 'for edge type' in msg and f'num_nodes={NA + 1}' in msg
  # keyed by edge type, a scalar, and None
  Dataset().init_graph(csr_t, layout='CSR', device='cpu',
                       num_nodes={et: t[0].numel() - 1
                                  for et, t in csr_t.items()})
  with pytest.raises(ValueError, match='implies'):
    Dataset().init_graph(csr_t, layout='CSR', num_nodes=NP, device='cpu')
  Dataset().init_graph(csr_t, layout='CSR', device='cpu')


ETYPES = tuple(sorted([CITES, WRITES, REV_WRITES, AFFIL, REV_AFFIL]))


@pytest.mark.parametrize('spec', [
    [3, 2],
    {CITES: [3, 2], WRITES: [2, 2], REV_WRITES: [4, 1], AFFIL: [1, 1],
     REV_AFFIL: [2, 3]},
    {CITES: [3], REV_WRITES: [2, 2], AFFIL: [0, 2, 1]},   # WRITES left out
])
def test_plan_capacities_match_jax(spec):
  got = normalize_fanouts(ETYPES, spec)
  ref = jax_normalize(ETYPES, spec)
  assert got == ref
  etypes, fanouts, hops = got
  for sizes in ({P: 16}, {P: 200}, {P: 8, A: 5}):
    assert (_plan_capacities(etypes, fanouts, sizes, hops, NNODES)
            == jax_plan(etypes, fanouts, sizes, hops, NNODES))
  # with no counts the frontiers are bounded by the fanouts alone
  assert (_plan_capacities(etypes, fanouts, {P: 16}, hops, {})
          == jax_plan(etypes, fanouts, {P: 16}, hops, {}))


SAMPLER_SPECS = {
    'shared': [3, 2],
    'dict3': {CITES: [3, 2, 2], WRITES: [2, 2, 2], REV_WRITES: [4, 1, 2],
              AFFIL: [1, 1, 1], REV_AFFIL: [2, 3, 1]},
}


def _check_output(got: HeteroSamplerOutput, ref, what):
  assert set(got.node) == set(ref.node), what
  for nt in ref.node:
    _same(got.node[nt], ref.node[nt], f'{what} node {nt}')
    _same(got.node_count[nt], ref.node_count[nt], f'{what} count {nt}')
    _same(got.num_sampled_nodes[nt], ref.num_sampled_nodes[nt],
          f'{what} num_sampled_nodes {nt}')
  assert set(got.row) == set(ref.row), what
  for et in ref.row:
    _same(got.row[et], ref.row[et], f'{what} row {et}')
    _same(got.col[et], ref.col[et], f'{what} col {et}')
    _same(got.edge_mask[et], ref.edge_mask[et], f'{what} mask {et}')
  assert got.edge_types == ref.edge_types
  assert list(got.batch) == list(ref.batch)
  for nt in ref.batch:
    _same(got.batch[nt], ref.batch[nt], f'{what} batch')
  _same(got.metadata['seed_local'], ref.metadata['seed_local'],
        f'{what} seed_local')
  assert got.metadata['input_type'] == ref.metadata['input_type']
  assert got.edge is None and ref.edge is None


@pytest.mark.parametrize('spec', sorted(SAMPLER_SPECS))
def test_sampler_matches_jax(spec):
  """Three calls (steps 1-3): duplicate seeds, hubs, papers without
  authors or citations, a padded tail; every output byte-equal."""
  jds, ds, _, _ = datasets()
  fan = SAMPLER_SPECS[spec]
  js = JaxHeteroSampler(jds.get_graph(), fan,
                        num_nodes=jds.num_nodes_dict(), seed=0)
  ts = HeteroNeighborSampler(ds.get_graph(), fan, device='cpu',
                             num_nodes=ds.num_nodes_dict(),
                             draws=jax_hetero_draws(0))
  assert ts.etypes == js.etypes and ts._num_nodes == js._num_nodes
  rng = np.random.default_rng(7)
  sample_one_hop.calls = 0
  for call in range(3):
    seeds = rng.integers(0, NP, 12).astype(np.int32)
    seeds[:4] = [0, 0, NP - 1, NP - 15]   # a hub twice, no-author papers
    if call:
      seeds[-3 * call:] = -1
    ref = js.sample_from_nodes(JaxInput(node=seeds, input_type=P))
    got = ts.sample_from_nodes(NodeSamplerInput(node=seeds, input_type=P))
    _check_output(got, ref, f'{spec} call {call}')
    if spec == 'shared':
      # hop 0 samples the papers' two edge types, hop 1 all five but
      # the institutions' (no institution is found before hop 1)
      assert set(got.row) == {tt.reverse_edge_type(et) for et in ETYPES
                              if et != REV_AFFIL}
      assert int(got.num_sampled_nodes[I][1]) == 0
  # one sampler call per (hop, edge type) with a planned frontier
  edge_caps = jax_plan(js.etypes, js.fanouts, {P: 12}, js.num_hops,
                       js._num_nodes)[3]
  per_call = sum(len(ecap) for ecap in edge_caps)
  assert per_call == (6 if spec == 'shared' else 11)
  assert sample_one_hop.calls == 3 * per_call


def test_sampler_contract():
  _, ds, _, _ = datasets()
  s = HeteroNeighborSampler(ds.get_graph(), [2], device='cpu')
  with pytest.raises(ValueError, match='input_type'):
    s.sample_from_nodes(NodeSamplerInput(node=np.arange(4)))
  # seed edges need their edge type (the link parity tests:
  # test_torch_hetero_link.py); with_edge gives ids by emitted type
  with pytest.raises(ValueError, match='input_type'):
    s.sample_from_edges(EdgeSamplerInput(np.arange(3), np.arange(3)))
  se = HeteroNeighborSampler(ds.get_graph(), [2], device='cpu',
                             with_edge=True)
  oe = se.sample_from_nodes(NodeSamplerInput(node=np.arange(8),
                                             input_type=P))
  assert set(oe.edge) == set(oe.row)
  for et, e in oe.edge.items():
    assert bool((e[oe.edge_mask[et]] >= 0).all())
    assert bool((e[~oe.edge_mask[et]] == -1).all())
  # the default draws give a well-formed sample
  out = s.sample_from_nodes(NodeSamplerInput(node=np.arange(8),
                                             input_type=P))
  for et, row in out.row.items():
    src_t, dst_t = et[0], et[2]
    cnt = {nt: int(c) for nt, c in out.node_count.items()}
    r, c, m = row.numpy(), out.col[et].numpy(), out.edge_mask[et].numpy()
    assert ((r[m] >= 0) & (r[m] < cnt[src_t])).all()
    assert ((c[m] >= 0) & (c[m] < cnt[dst_t])).all()
    assert (r[~m] == -1).all() and (c[~m] == -1).all()


@pytest.mark.parametrize('split_ratio', [1.0, 0.5])
def test_loader_batches_byte_equal_to_jax(split_ratio):
  """Three shuffled batches (the last padded) of `NeighborLoader` over
  the edge-type dict: every `HeteroBatch` field; a tiered store (split
  0.5 on every type) gives the untiered rows."""
  jds, ds, feats, labels = datasets(seed=1, split_ratio=split_ratio)
  idx = np.random.default_rng(2).permutation(NP)[:40]
  jl = JaxLoader(jds, [3, 2], (P, idx), batch_size=16, shuffle=True,
                 seed=0)
  tl = NeighborLoader(ds, [3, 2], (P, idx), batch_size=16, shuffle=True,
                      seed=0, draws=jax_hetero_draws(0), device='cpu')
  assert len(tl) == len(jl) == 3
  for i, (jb, tb) in enumerate(zip(jl, tl)):
    assert isinstance(tb, HeteroBatch) and tb.batch_size == 16
    for f in ('x_dict', 'y_dict', 'edge_index_dict', 'node_dict',
              'node_mask_dict', 'edge_mask_dict', 'batch_dict'):
      got, ref = getattr(tb, f), getattr(jb, f)
      assert sorted(got) == sorted(ref), f      # a jit sorts dict keys
      for key in ref:
        _same(got[key], ref[key], f'batch {i} {f} {key}')
    _same(tb.metadata['seed_local'], jb.metadata['seed_local'], 'seeds')
    for nt, ids in tb.node_dict.items():
      ids = ids.numpy()
      ok = ids >= 0
      np.testing.assert_array_equal(tb.x_dict[nt].numpy()[ok],
                                    feats[nt][ids[ok]])
      assert not tb.x_dict[nt].numpy()[~ok].any()
    ok = tb.node_dict[P].numpy() >= 0
    np.testing.assert_array_equal(tb.y_dict[P].numpy()[ok],
                                  labels[tb.node_dict[P].numpy()[ok]])
  assert (tb.batch_dict[P].numpy() < 0).sum() == 8
  # prefetch=2 yields the same batches on a worker thread
  pre = NeighborLoader(ds, [3, 2], (P, idx), batch_size=16, shuffle=True,
                       seed=0, draws=jax_hetero_draws(0), device='cpu',
                       prefetch=2)
  jl = JaxLoader(jds, [3, 2], (P, idx), batch_size=16, shuffle=True,
                 seed=0)
  for i, (jb, pb) in enumerate(zip(jl, pre)):
    for nt in jb.x_dict:
      _same(pb.x_dict[nt], jb.x_dict[nt], f'prefetch batch {i} x {nt}')
  pre.close()


def test_draws_without_edge_type_unchanged():
  """The homogeneous draws hash exactly as before the edge-type
  coordinate existed: a digest of recorded values, and the edge type
  moves every provider's values."""
  h = hashlib.sha256()
  td = TorchDraws(7, 'cpu')
  for args in [(1, 0, 40, 5, 64), (3, 2, 17, 10, 80)]:
    for t in td(*args):
      h.update(t.numpy().tobytes())
  for t in td(2, 1, 9, 4, 4, gns=True, owner=3):
    h.update(t.numpy().tobytes())
  cd = CounterDraws(7, 'cpu')
  for args in [(1, None, 0, 0, 40, 5, 64), (2, 4, 3, 1, 17, 10, 80)]:
    for t in cd(*args):
      h.update(t.numpy().tobytes())
  for t in hash_draws(5, torch.tensor([3, -1, 9]), 1, 2, 4, 32):
    h.update(t.numpy().tobytes())
  assert h.hexdigest() == ('ae93a462275b399480e00d45d127e956'
                           '2753313a3783883394349a8830f16b89')
  for a, b in ((td(1, 0, 40, 5, 64), td(1, 0, 40, 5, 64, etype=0)),
               (td(1, 0, 40, 5, 64, etype=0), td(1, 0, 40, 5, 64, etype=1)),
               (cd(1, None, 0, 0, 40, 5, 64),
                cd(1, None, 0, 0, 40, 5, 64, etype=0)),
               (cd(1, None, 0, 0, 40, 5, 64, etype=2),
                cd(1, None, 0, 0, 40, 5, 64, etype=3))):
    assert not torch.equal(a[0], b[0]) and not torch.equal(a[1], b[1])
  # the edge type is the fifth counter coordinate
  assert all(torch.equal(x, y) for x, y in zip(
      cd(1, None, 0, 0, 40, 5, 64, etype=2),
      cd.draw((1, 0, 0, 0, 2), 40, 5, 64)))


def test_hetero_entry_points_default_to_cuda():
  if torch.cuda.is_available():
    pytest.skip('the default device exists here')
  from graphlearn_tpu_torch.loader import FusedHeteroEpoch
  from graphlearn_tpu_torch.models import RGCN
  edges, feats, labels = hetero_graph()
  with pytest.raises(RuntimeError, match='CUDA'):
    Dataset().init_graph(edges, num_nodes=NNODES)
  with pytest.raises(RuntimeError, match='CUDA'):
    Dataset().init_node_features(feats)
  _, ds, _, _ = datasets()
  with pytest.raises(RuntimeError, match='CUDA'):
    HeteroNeighborSampler(ds.get_graph(), [2])
  with pytest.raises(RuntimeError, match='CUDA'):
    NeighborLoader(ds, [2], (P, np.arange(8)), batch_size=4)
  model = RGCN(ds.get_edge_types(), D, 4, CLASSES, target_ntype=P)
  opt = torch.optim.Adam(model.parameters())
  with pytest.raises(RuntimeError, match='CUDA'):
    FusedHeteroEpoch(ds, [2], (P, np.arange(8)), model, opt, 4)
  # asked for: the CPU runs the kernels' plain versions
  b = next(iter(NeighborLoader(ds, [2], (P, np.arange(8)), batch_size=4,
                               device='cpu')))
  assert all(x.device.type == 'cpu' for x in b.x_dict.values())
