"""Partition failover in the port against the JAX package at P = 8 (the
port on the CPU, the JAX side on the 8-device virtual CPU mesh): the
`PartitionBook`'s views, ledger and typed refusals; durable shards
(payloads byte-equal to the JAX package's, a JAX-written store adopted by
the port); the exact-completion ladder under a mid-epoch owner kill for
the node loader, the link loader, a resumed epoch, a GNS loader over a
tiered store and a double kill; the degraded fallback; the adoption's
typed refusals; the chaos sites and knobs; and the subgraph sampler,
`DistRandomWalker` and `FusedDistEpoch` under a book adopted before the
epoch.  Every case runs both packages on the same dataset and compares
batches byte for byte (the port replays the JAX keys through
`test_torch_dist_gns.jax_key_draws`), plus the book, ledger and recorder
facts.  The JAX package's ingest-compaction wiring of
`ShardStore.refresh_cb` needs mesh streaming, which the port does not
have yet: its test calls the hook directly.  Tolerances: batches, books
and counters exact; the fused epoch's losses within 1e-5 (f32 reductions
in another order).
"""
import io
import re
import tokenize
from functools import lru_cache
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from graphlearn_tpu.parallel.dist_data import DistDataset as JaxDistDataset
from graphlearn_tpu.parallel.dist_sampler import (
    DistLinkNeighborLoader as JaxLinkLoader)
from graphlearn_tpu.parallel.dist_sampler import (
    DistNeighborLoader as JaxLoader)
from graphlearn_tpu.parallel.dist_sampler import (
    DistRandomWalker as JaxWalker)
from graphlearn_tpu.parallel.dist_sampler import (
    DistSubGraphLoader as JaxSubGraphLoader)
from graphlearn_tpu.parallel import failover as jfo
from graphlearn_tpu.parallel import partition_book as jpb
from graphlearn_tpu.telemetry.recorder import recorder as jrecorder
from graphlearn_tpu.testing import chaos as jchaos
from graphlearn_tpu_torch.parallel import (DistDataset, DistLinkNeighborLoader,
                                           DistNeighborLoader,
                                           DistRandomWalker,
                                           DistSubGraphLoader)
from graphlearn_tpu_torch.parallel import failover as tfo
from graphlearn_tpu_torch.parallel import partition_book as tpb
from graphlearn_tpu_torch.telemetry import live
from graphlearn_tpu_torch.telemetry import recorder as trecorder
from graphlearn_tpu_torch.testing import chaos as tchaos
from test_torch_dist_gns import _clean_env, jax_key_draws
from test_torch_dist_link import link_draws
from test_torch_mesh import _exchange_keys

P = 8
N, E = 200, 1200
FIELDS = ('node', 'x', 'y', 'edge_index')


def _graph(seed=0):
  rng = np.random.default_rng(seed)
  rows = rng.integers(0, N, E)
  cols = rng.integers(0, N, E)
  feat = (np.arange(N)[:, None] + np.zeros((1, 6))).astype(np.float32)
  lab = (np.arange(N) % 4).astype(np.int64)
  return rows, cols, feat, lab


def jax_dataset(split_ratio=1.0):
  rows, cols, feat, lab = _graph()
  return JaxDistDataset.from_full_graph(P, rows, cols, feat, lab,
                                        split_ratio=split_ratio)


def port_dataset(split_ratio=1.0):
  rows, cols, feat, lab = _graph()
  return DistDataset.from_full_graph(P, rows, cols, feat, lab,
                                     split_ratio=split_ratio, device='cpu')


def jax_loader(ds, **kw):
  kw.setdefault('batch_size', 4)
  kw.setdefault('shuffle', True)
  kw.setdefault('seed', 0)
  return JaxLoader(ds, [3, 2], np.arange(N), **kw)


def port_loader(ds, **kw):
  kw.setdefault('batch_size', 4)
  kw.setdefault('shuffle', True)
  kw.setdefault('seed', 0)
  return DistNeighborLoader(ds, [3, 2], np.arange(N),
                            draws=jax_key_draws(0), device='cpu', **kw)


def batch_np(b, fields=FIELDS) -> dict:
  """A stacked batch's fields as numpy, from either package."""
  out = {}
  for f in fields:
    v = getattr(b, f)
    out[f] = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
  return out


def assert_epochs_equal(want, got, what=''):
  """Batch-by-batch equality of two epochs of `batch_np` dicts: equal
  values and dtypes, save that JAX (without x64) carries int64 labels
  as int32."""
  assert len(want) == len(got), f'{what}: {len(got)} != {len(want)}'
  for i, (a, b) in enumerate(zip(want, got)):
    for f in a:
      same = (a[f].dtype == b[f].dtype
              or a[f].dtype.kind == b[f].dtype.kind == 'i' and f == 'y')
      assert same, (what, i, f, a[f].dtype, b[f].dtype)
      np.testing.assert_array_equal(b[f], a[f], err_msg=f'{what} {i} {f}')


def epoch(loader, fields=FIELDS) -> list:
  return [batch_np(b, fields) for b in loader]


@lru_cache(maxsize=None)
def _reference(split_ratio=1.0, gns=False) -> tuple:
  """The fault-free epoch of the JAX loader (the port's equals it:
  `test_torch_mesh`)."""
  return tuple(epoch(jax_loader(jax_dataset(split_ratio), gns=gns)))


def reference(split_ratio=1.0, gns=False) -> list:
  return list(_reference(split_ratio, gns))


def run_both(spec, jax_fn, port_fn):
  """``jax_fn()`` under the JAX chaos plan ``spec``, then ``port_fn()``
  under the port's; both plans uninstalled after."""
  out = []
  for chaos, fn in ((jchaos, jax_fn), (tchaos, port_fn)):
    if spec:
      chaos.install(spec)
    try:
      out.append(fn())
    finally:
      chaos.uninstall()
  return out


@pytest.fixture
def env(monkeypatch):
  _clean_env(monkeypatch)
  for k in ('GLT_SHARD_DIR', 'GLT_DEGRADED_OK', 'GLT_ADOPT_TIMEOUT_S',
            'GLT_FAULT_PLAN'):
    monkeypatch.delenv(k, raising=False)
  return monkeypatch


def book_facts(book) -> dict:
  v = book.view()
  return {'version': v.version, 'owners': np.asarray(v.owners).tolist(),
          'lane_of_range': np.asarray(v.lane_of_range).tolist(),
          'slot_ranges': np.asarray(v.slot_ranges).tolist(),
          'num_lanes': int(v.num_lanes), 'spec': v.spec(),
          'adoptions': book.adoptions(), 'transfers': book.transfers()}


def assert_books_equal(jbook, tbook):
  j, t = book_facts(jbook), book_facts(tbook)
  js, ts = j.pop('spec'), t.pop('spec')
  assert t == j
  assert (js is None) == (ts is None)
  if js is not None:
    assert tuple(ts) == tuple(js)


# -- the book -----------------------------------------------------------------

def test_book_rcu_version_fencing():
  books = [m.PartitionBook(np.arange(P + 1) * 10) for m in (jpb, tpb)]
  for book in books:
    v0 = book.view()
    assert v0.version == 0 and v0.is_identity and v0.spec() is None
    assert v0.num_lanes == 1
    v1 = book.adopt(3, 5)
    assert v0.version == 0 and int(v0.owners[3]) == 3     # RCU
    assert v1.version == 1 and int(v1.owners[3]) == 5
    assert int(v1.lane_of_range[3]) == 1 and v1.num_lanes == 2
    assert [int(x) for x in v1.slot_ranges[5]] == [5, 3]
    assert v1.spec().version == 1
    assert book.adoptions() == [{'lost': 3, 'survivor': 5, 'version': 1}]
  assert_books_equal(*books)
  # a second move on the moved book lands on the same lanes in both
  for book in books:
    book.adopt(6, 0)
    assert book.live_partitions().tolist() == [0, 1, 2, 4, 5, 7]
  assert_books_equal(*books)


def test_book_typed_refusals():
  msgs = []
  for m in (jpb, tpb):
    book = m.PartitionBook(np.arange(P + 1))
    book.adopt(1, 2)
    got = []
    for lost, survivor in ((1, 4), (3, 1), (3, 2), (4, 4), (99, 0)):
      with pytest.raises(m.AdoptionRefusedError) as ei:
        book.adopt(lost, survivor)
      got.append(str(ei.value))
    assert book.version == 1                  # refusals never mutate
    assert book.pick_survivor(3) == 0
    msgs.append(got)
  assert msgs[0] == msgs[1]
  for m, key in zip(msgs[1], ('already adopted', 'itself dead',
                              'already carries', 'cannot adopt itself',
                              'out of range')):
    assert key in m


def test_hot_split_host_keys_on_range():
  bounds = np.asarray([0, 10, 30, 60])
  hot = np.asarray([5, 10, 10])
  ids = np.asarray([-1, 0, 7, 12, 25, 35, 55])
  want = jpb.hot_split_host(bounds, hot, ids)
  got = tpb.hot_split_host(bounds, hot, ids)
  for a, b in zip(want, got):
    np.testing.assert_array_equal(b, a)
  assert got[2].tolist() == [False, False, True, False, True, False, True]
  np.testing.assert_array_equal(tpb.edge_owner_host(ids[1:], 3),
                                jpb.edge_owner_host(ids[1:], 3))
  np.testing.assert_array_equal(tpb.edge_local_rows_host(ids[1:], 3),
                                jpb.edge_local_rows_host(ids[1:], 3))


def test_book_owner_functions_match_jax():
  """The virtual owner functions (range and mod rules) of a moved book
  route every id as JAX's do."""
  jbook, tbook = jpb.PartitionBook(np.arange(P + 1) * 25), None
  tbook = tpb.PartitionBook(np.arange(P + 1) * 25)
  for book in (jbook, tbook):
    book.adopt(2, 0)
    book.transfer(5, 5, 7)
  jspec, tspec = jbook.view().spec(), tbook.view().spec()
  ids = np.arange(-1, P * 25, dtype=np.int32)
  bounds = np.arange(P + 1, dtype=np.int64) * 25
  jfn = jax.jit(jpb.book_owner_fn(bounds, jspec))
  tfn = tpb.book_owner_fn(torch.from_numpy(bounds), tspec)
  ok = ids >= 0
  np.testing.assert_array_equal(
      tfn(torch.from_numpy(ids)).numpy()[ok], np.asarray(jfn(ids))[ok])
  jmod = jpb.edge_book_owner_fn(P, jspec)
  tmod = tpb.edge_book_owner_fn(P, tspec)
  np.testing.assert_array_equal(tmod(torch.from_numpy(ids[ok])).numpy(),
                                np.asarray(jmod(ids[ok])))


@pytest.mark.parametrize('mode,cap', [('range', None), ('range', 8),
                                      ('mod', None), ('mod', 8)])
def test_book_plan_at_identity_is_the_dense_exchange(mode, cap):
  """Every mesh exchange runs through `_BookPlan`; at the identity book
  (one lane a position) it is the dense exchange of the owner functions
  the pre-book path used (`plan_exchange` with `range_owner_fn` or
  `edge_owner_fn`): the same receive buffers, slots, counters, payload
  and replies, with and without a capacity."""
  from graphlearn_tpu_torch.parallel.dist_sampler import _BookPlan
  from graphlearn_tpu_torch.parallel.dp import make_mesh
  from graphlearn_tpu_torch.parallel.exchange import plan_exchange
  rng = np.random.default_rng(3)
  ids = torch.from_numpy(rng.integers(-1, P * 25, (P, 40)).astype(np.int32))
  cols = torch.from_numpy(rng.integers(0, P * 25, (P, 40)).astype(np.int32))
  bounds_t = torch.arange(P + 1, dtype=torch.int64) * 25
  mesh = make_mesh(P, device='cpu')
  owner = (tpb.edge_owner_fn(P) if mode == 'mod'
           else tpb.range_owner_fn(bounds_t))
  dense = plan_exchange(ids, owner, P, mesh, cap, payload=cols)
  book = _BookPlan(ids, bounds_t, tpb.identity_spec(P), mesh, cap,
                   payload=cols, owner_mode=mode)
  assert book.lanes == [(r, r) for r in range(P)]
  for a, b in ((book.recv_lanes, dense.recv),
               (book.recv_payload_lanes, dense.recv_payload),
               (book.slot_p, dense.slot_p), (book.slot_j, dense.slot_j),
               (book.stats, dense.stats),
               (book.requester_of_recv, dense.requester_of_recv)):
    assert torch.equal(a, b)
  if mode == 'range':
    assert torch.equal(book.local(bounds_t, -1), torch.where(
        dense.recv >= 0, dense.recv - bounds_t[:-1, None], -1))
  vals = dense.recv.to(torch.int64)[..., None] * 3 + torch.arange(2)
  assert torch.equal(book.reply(vals, fill=-7), dense.reply(vals, fill=-7))


def test_adopted_lane_cache_follows_parked_payloads():
  """`DistDataset.adopted_lane` puts a parked payload on the dataset's
  device once (edge ids as int32), and a payload that leaves
  ``adopted_shards`` (`drop_adopted`, or any other removal) leaves the
  device cache too."""
  ds = port_dataset()
  ds.adopted_shards[2] = tfo.shard_payload(ds, 2)
  lane = ds.adopted_lane(2)
  assert ds.adopted_lane(2) is lane
  assert lane['eids'].dtype == torch.int32
  for key in ('indptr', 'indices', 'fshard', 'lshard'):
    np.testing.assert_array_equal(lane[key].numpy(),
                                  ds.adopted_shards[2][key])
  ds.drop_adopted(2)
  assert not ds.adopted_shards and not ds._adopted_device
  ds.adopted_shards[2] = tfo.shard_payload(ds, 2)
  ds.adopted_lane(2)
  del ds.adopted_shards[2]
  ds.adopted_shards[3] = tfo.shard_payload(ds, 3)
  ds.adopted_lane(3)
  assert set(ds._adopted_device) == {3}


# -- durable shards and adoption ---------------------------------------------

def test_shard_payloads_byte_equal_to_jax(env, tmp_path):
  """`shard_payload` / `write_dataset_shards` of the port are the JAX
  package's, field by field (values and dtypes), untiered and tiered;
  the meta (fingerprint included) too."""
  for split in (1.0, 0.5):
    jds, ds = jax_dataset(split), port_dataset(split)
    for r in range(P):
      jp, tp = jfo.shard_payload(jds, r), tfo.shard_payload(ds, r)
      assert set(tp) == set(jp), (split, r)
      for k in jp:
        a = np.asarray(jp[k])
        assert tp[k].dtype == a.dtype, (split, r, k)
        assert np.array_equal(tp[k], a), (split, r, k)
    assert tfo.dataset_meta(ds) == jfo.dataset_meta(jds)
    assert tfo.dataset_fingerprint(ds) == jfo.dataset_fingerprint(jds)
  js = jfo.ShardStore(tmp_path / 'jax')
  ts = tfo.ShardStore(tmp_path / 'port')
  assert js.write_dataset_shards(jds) == ts.write_dataset_shards(ds) == P
  assert ts.meta() == js.meta() and ts.partitions() == list(range(P))
  for r in range(P):
    jl, tl = js.load_shard(r), ts.load_shard(r)
    assert set(tl) == set(jl)
    for k in jl:
      assert tl[k].dtype == jl[k].dtype and np.array_equal(tl[k], jl[k])


def test_adopted_shard_byte_identity_vs_static(env, tmp_path):
  """A quiesced adoption before the epoch: the adopted epoch equals the
  fault-free one and JAX's adopted epoch; the port adopts from a store
  the JAX package wrote."""
  ref = reference()
  jds, ds = jax_dataset(), port_dataset()
  jstore = jfo.ShardStore(tmp_path / 'shards')
  jstore.write_dataset_shards(jds)
  jl, tl = jax_loader(jds), port_loader(ds)
  jinfo = jfo.adopt_shard(jds, jstore, 2)
  tinfo = tfo.adopt_shard(ds, tfo.ShardStore(tmp_path / 'shards'), 2)
  assert {k: tinfo[k] for k in ('survivor', 'version')} == \
      {k: jinfo[k] for k in ('survivor', 'version')} == \
      {'survivor': 0, 'version': 1}
  assert 2 in ds.adopted_shards
  for k, v in jds.adopted_shards[2].items():
    assert np.array_equal(ds.adopted_shards[2][k], np.asarray(v)), k
  jgot, tgot = epoch(jl), epoch(tl)
  assert_epochs_equal(ref, jgot, 'jax adopted')
  assert_epochs_equal(ref, tgot, 'port adopted')
  assert_books_equal(jds.partition_book, ds.partition_book)
  # the adopted lane reads the payload put on the card, not the stack
  lanes = tl.sampler._book_lanes
  assert lanes is not None and lanes.spec.version == 1
  assert lanes.get('indptr', 2).data_ptr() != ds.graph.indptr[2].data_ptr()
  assert torch.equal(lanes.get('indptr', 2), ds.graph.indptr[2])
  assert lanes.get('indptr', 3).data_ptr() == ds.graph.indptr[3].data_ptr()
  assert lanes.get('eids', 2).dtype == torch.int32


def _kill_events(rec):
  adopts = rec.events('partition.adopt')
  phases = [e.get('phase') for e in adopts]
  lost = [(e['peer'], e['degraded'], e['adopted'])
          for e in rec.events('peer.lost')]
  return phases, lost, adopts


def test_exact_completion_mid_epoch_kill(env, tmp_path):
  """THE acceptance pin: an owner killed mid-epoch with a durable shard
  present — both packages finish the full epoch byte-identical to the
  fault-free run, with one adoption, one recovery clock closed (> 0) and
  the same book and exchange counters."""
  ref = reference()
  jds, ds = jax_dataset(), port_dataset()
  env.setenv('GLT_SHARD_DIR', str(tmp_path / 'jax'))
  jl = jax_loader(jds)
  env.setenv('GLT_SHARD_DIR', str(tmp_path / 'port'))
  tl = port_loader(ds)
  assert sorted(p.name for p in (tmp_path / 'port').iterdir()) == sorted(
      p.name for p in (tmp_path / 'jax').iterdir())
  jrecorder.enable(None)
  jrecorder.clear()
  trecorder.enable()
  trecorder.clear()
  before = live.counter('partition.adoptions_total').value()
  try:
    jgot, tgot = run_both('partition.owner:kill:4:partition=3',
                          lambda: epoch(jl), lambda: epoch(tl))
    jfacts, tfacts = _kill_events(jrecorder), _kill_events(trecorder)
  finally:
    jrecorder.disable()
    jrecorder.clear()
    trecorder.disable()
    trecorder.clear()
  assert_epochs_equal(ref, jgot, 'jax kill')
  assert_epochs_equal(ref, tgot, 'port kill')
  assert_books_equal(jds.partition_book, ds.partition_book)
  assert ds.partition_book.version == 1
  assert tfacts[0] == jfacts[0] == [None, 'recovered']
  assert tfacts[1] == jfacts[1] == [(3, False, True)]
  rec = [e for e in tfacts[2] if e.get('phase') == 'recovered'][0]
  assert rec['secs'] > 0 and rec['survivor'] == 0
  assert live.counter('partition.adoptions_total').value() == before + 1
  assert live.snapshot()['partition.recovery_secs'] > 0
  assert live.snapshot()['partition.book_version'] == 1.0
  js = jl.sampler.exchange_stats(tick_metrics=False)
  ts = tl.sampler.exchange_stats(tick_metrics=False)
  for k in _exchange_keys(js):
    assert ts[k] == js[k], k


def test_exact_completion_link_loader_kill(env, tmp_path):
  """The link loader's dispatch runs the same ladder."""
  rows, cols, _f, _l = _graph()
  pairs = (rows[:160], cols[:160])
  kw = dict(neg_sampling='binary', batch_size=4, shuffle=True, seed=0,
            input_space='new')
  ref = epoch(JaxLinkLoader(jax_dataset(), [2, 2], pairs, **kw),
              ('node', 'x'))
  jds, ds = jax_dataset(), port_dataset()
  env.setenv('GLT_SHARD_DIR', str(tmp_path / 'jax'))
  jl = JaxLinkLoader(jds, [2, 2], pairs, **kw)
  env.setenv('GLT_SHARD_DIR', str(tmp_path / 'port'))
  tl = DistLinkNeighborLoader(ds, [2, 2], pairs, draws=link_draws(0),
                              device='cpu', **kw)
  jgot, tgot = run_both('partition.owner:kill:3:partition=6',
                        lambda: epoch(jl, ('node', 'x', 'edge_index')),
                        lambda: epoch(tl, ('node', 'x', 'edge_index')))
  assert_epochs_equal(ref, [{k: b[k] for k in ('node', 'x')} for b in jgot])
  assert_epochs_equal(jgot, tgot, 'link kill')
  assert ds.partition_book.version == jds.partition_book.version == 1
  assert_books_equal(jds.partition_book, ds.partition_book)


def test_exact_completion_resumed_from_snapshot(env, tmp_path):
  """A kill in a RESUMED epoch: 3 batches, a snapshot, a fresh loader
  restores it, the kill fires in the remainder, the resumed batches
  equal the fault-free run's."""
  ref = reference()
  out = []
  for pkg, (make_ds, make_loader, chaos) in {
      'jax': (jax_dataset, jax_loader, jchaos),
      'port': (port_dataset, port_loader, tchaos)}.items():
    env.setenv('GLT_SHARD_DIR', str(tmp_path / pkg))
    loader = make_loader(make_ds())
    it = iter(loader)
    got = [batch_np(next(it)) for _ in range(3)]
    state = loader.state_dict()
    ds2 = make_ds()
    loader2 = make_loader(ds2)
    loader2.load_state_dict(state)
    chaos.install('partition.owner:kill:2:partition=1')
    try:
      got += [batch_np(b) for b in loader2.resume_epoch()]
    finally:
      chaos.uninstall()
    assert ds2.partition_book.version == 1
    out.append((got, ds2.partition_book))
  assert_epochs_equal(ref, out[0][0], 'jax resumed')
  assert_epochs_equal(ref, out[1][0], 'port resumed')
  assert_books_equal(out[0][1], out[1][1])


def test_gns_bitmask_invalidated_on_book_bump(env, tmp_path):
  """A bump rebuilds the cached-set bitmask at the fence that rebuilds
  the lanes; the next epoch's GNS batches (and weights) equal JAX's."""
  fields = FIELDS + ('edge_weight',)

  def weights(b):
    w = b.metadata['edge_weight']
    return w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
  out = []
  for pkg, make_ds, make_loader, fo in (
      ('jax', jax_dataset, jax_loader, jfo),
      ('port', port_dataset, port_loader, tfo)):
    ds = make_ds(0.5)
    loader = make_loader(ds, gns=True)
    s = loader.sampler
    assert s.gns
    first = [dict(batch_np(b), edge_weight=weights(b)) for b in loader]
    assert s._gns_bits is not None and s._gns_ver >= 0
    store = fo.ShardStore(tmp_path / pkg)
    store.write_dataset_shards(ds)
    fo.adopt_shard(ds, store, 4)
    s.maybe_refresh_book()
    assert s._gns_ver == -1                  # invalidated at the fence
    second = [dict(batch_np(b), edge_weight=weights(b)) for b in loader]
    assert s._gns_ver >= 0                   # the next epoch rebuilt it
    out.append((first, second))
  assert_epochs_equal(out[0][0], out[1][0], 'gns epoch 1')
  assert_epochs_equal(out[0][1], out[1][1], 'gns epoch 2 (adopted)')
  assert fields[-1] in out[1][1][0]


def test_gns_tiered_kill_matches_jax(env, tmp_path):
  """A kill mid-epoch of a GNS loader over a tiered store (the card's
  tiered GNS arm at a small size): one adoption, and the epoch byte-equal
  to JAX's killed epoch — and to the fault-free one, as JAX's is."""
  ref = reference(0.5, gns=True)
  out = []
  for pkg, make_ds, make_loader, chaos in (
      ('jax', jax_dataset, jax_loader, jchaos),
      ('port', port_dataset, port_loader, tchaos)):
    env.setenv('GLT_SHARD_DIR', str(tmp_path / pkg))
    ds = make_ds(0.5)
    loader = make_loader(ds, gns=True)
    chaos.install('partition.owner:kill:3:partition=2')
    try:
      out.append((epoch(loader), ds.partition_book))
    finally:
      chaos.uninstall()
  assert_epochs_equal(out[0][0], out[1][0], 'gns kill')
  assert_epochs_equal(ref, out[1][0], 'gns kill vs fault-free')
  assert_books_equal(out[0][1], out[1][1])
  assert out[1][1].adoptions() == [{'lost': 2, 'survivor': 0, 'version': 1}]


def test_no_durable_shard_falls_back_degraded(env):
  """No ``GLT_SHARD_DIR``: a typed `PartitionLostError` naming it, or,
  with ``GLT_DEGRADED_OK=1``, the degraded epoch — the range's CSR row
  emptied and its nodes' rows zero — byte-equal in both packages."""
  for fo, make_ds, make_loader, chaos in (
      (jfo, jax_dataset, jax_loader, jchaos),
      (tfo, port_dataset, port_loader, tchaos)):
    chaos.install('partition.owner:kill:2:partition=5')
    try:
      with pytest.raises(fo.PartitionLostError, match='GLT_SHARD_DIR'):
        epoch(make_loader(make_ds()))
    finally:
      chaos.uninstall()
  env.setenv('GLT_DEGRADED_OK', '1')
  jds, ds = jax_dataset(), port_dataset()
  jl, tl = jax_loader(jds), port_loader(ds)
  trecorder.enable()
  trecorder.clear()
  try:
    jgot, tgot = run_both('partition.owner:kill:2:partition=5',
                          lambda: epoch(jl), lambda: epoch(tl))
    lost = [e for e in trecorder.events('peer.lost') if e.get('degraded')]
  finally:
    trecorder.disable()
    trecorder.clear()
  assert_epochs_equal(jgot, tgot, 'degraded')
  assert len(tgot) == len(tl)
  assert lost and lost[0]['peer'] == 5
  assert ds.partition_book.version == jds.partition_book.version == 0
  assert ds.degraded_partitions == {5}
  assert not ds.graph.indptr[5].any()
  assert (ds.graph.indices[5] == -1).all()
  bounds = ds.graph.bounds
  found = False
  for b in tgot[2:]:
    p5 = (b['node'] >= bounds[5]) & (b['node'] < bounds[6])
    found = found or bool(p5.any())
    assert (b['x'][p5] == 0).all()
  assert found


def test_double_kill_second_adoption_runs_or_refuses(env, tmp_path):
  """Two owners lost: both adopt (different survivors), and a kill of an
  already-adopted range is a no-op fence; both packages agree."""
  ref = reference()
  spec = ('partition.owner:kill:2:partition=3;'
          'partition.owner:kill:5:partition=6;'
          'partition.owner:kill:6:partition=3')
  jds, ds = jax_dataset(), port_dataset()
  env.setenv('GLT_SHARD_DIR', str(tmp_path / 'jax'))
  jl = jax_loader(jds)
  env.setenv('GLT_SHARD_DIR', str(tmp_path / 'port'))
  tl = port_loader(ds)
  jgot, tgot = run_both(spec, lambda: epoch(jl), lambda: epoch(tl))
  assert_epochs_equal(ref, jgot, 'jax double')
  assert_epochs_equal(ref, tgot, 'port double')
  assert ds.partition_book.version == 2
  owners = ds.partition_book.view().owners
  assert int(owners[3]) != 3 and int(owners[6]) != 6
  assert_books_equal(jds.partition_book, ds.partition_book)


def test_adopt_timeout_and_missing_shard_typed(env, tmp_path):
  for fo, make_ds, sub in ((jfo, jax_dataset, 'j'), (tfo, port_dataset,
                                                     't')):
    ds = make_ds()
    with pytest.raises(fo.NoDurableShardError, match='GLT_DEGRADED_OK'):
      fo.adopt_shard(ds, fo.ShardStore(tmp_path / f'{sub}empty'), 1)
    other = fo.ShardStore(tmp_path / f'{sub}other')
    other.save_meta({'num_parts': 4})
    other.save_shard(1, {'indptr': np.zeros(3, np.int64),
                         'indices': np.zeros(2, np.int32),
                         'eids': np.zeros(2, np.int64)})
    with pytest.raises(fo.AdoptionRefusedError, match='partitions'):
      fo.adopt_shard(ds, other, 1)
    with pytest.raises(fo.NoDurableShardError, match='GLT_SHARD_DIR'):
      fo.adopt_shard(ds, None, 1)
    assert ds.partition_book.version == 0 and not ds.adopted_shards
  # a wedged store: the deadline fails the adoption typed
  env.setenv('GLT_ADOPT_TIMEOUT_S', '0.05')
  ds = port_dataset()
  store = tfo.ShardStore(tmp_path / 'slow')
  store.write_dataset_shards(ds)
  real = store.load_shard

  def slow(p):
    import time
    time.sleep(0.5)
    return real(p)
  store.load_shard = slow
  with pytest.raises(tfo.AdoptionRefusedError, match='GLT_ADOPT_TIMEOUT_S'):
    tfo.adopt_shard(ds, store, 1)
  assert ds.partition_book.version == 0


def test_knobs_read_with_jax_defaults(env):
  """``GLT_SHARD_DIR``, ``GLT_ADOPT_TIMEOUT_S`` and ``GLT_DEGRADED_OK``
  read as the JAX package reads them (`benchmarks/README.md`)."""
  from graphlearn_tpu.distributed import resilience as jres
  from graphlearn_tpu_torch.distributed import resilience as tres
  assert tfo.SHARD_DIR_ENV == jfo.SHARD_DIR_ENV == 'GLT_SHARD_DIR'
  assert tfo.ADOPT_TIMEOUT_ENV == jfo.ADOPT_TIMEOUT_ENV
  assert tfo.DEFAULT_ADOPT_TIMEOUT_S == jfo.DEFAULT_ADOPT_TIMEOUT_S == 120.0
  for value in (None, '7.5', 'junk', ''):
    if value is None:
      env.delenv('GLT_ADOPT_TIMEOUT_S', raising=False)
      env.delenv('GLT_SHARD_DIR', raising=False)
      env.delenv('GLT_DEGRADED_OK', raising=False)
    else:
      env.setenv('GLT_ADOPT_TIMEOUT_S', value)
      env.setenv('GLT_SHARD_DIR', value)
      env.setenv('GLT_DEGRADED_OK', value)
    if value != '':
      assert tfo.adopt_timeout_s() == jfo.adopt_timeout_s()
    assert tfo.shard_dir_from_env() == jfo.shard_dir_from_env()
    assert tres.degraded_ok() == jres.degraded_ok()
  env.setenv('GLT_DEGRADED_OK', '1')
  assert tres.degraded_ok() and jres.degraded_ok()


@pytest.mark.parametrize('spec', [
    'partition.owner:kill:4:partition=3',
    'partition.owner:delay:2:secs=0.01',
    'partition.owner:kill:2:partition=3;partition.owner:kill:5:partition=6',
    'handoff.transfer:kill:1:op=fence',
    'handoff.transfer:fail:1:op=drain:partition=3',
    '{"faults": [{"site": "handoff.transfer", "action": "delay", '
    '"op": "transfer", "secs": 0.01}, {"site": "partition.owner", '
    '"action": "kill", "nth": 2, "partition": 1}]}'])
def test_chaos_sites_parse_and_fire_as_jax(spec):
  """The two sites parse from the same spec strings as JAX's
  `parse_plan` and fire on the same arrivals."""
  jp, tp = jchaos.parse_plan(spec), tchaos.parse_plan(spec)
  assert [(f.site, f.action, f.nth, f.count, f.op, f.partition, f.secs)
          for f in tp.faults] == [
              (f.site, f.action, f.nth, f.count, f.op, f.partition, f.secs)
              for f in jp.faults]
  arrivals = ([('partition.owner', {'step': s}) for s in range(1, 8)]
              + [('handoff.transfer', {'op': seam, 'partition': p})
                 for p in (3, 4) for seam in ('snapshot', 'transfer',
                                              'fence', 'cutover', 'drain')])
  for site, ctx in arrivals:
    fired_j = [(f.action, f.partition) for f in jp.on(site, **ctx)]
    fired_t = [(f.action, f.partition) for f in tp.on(site, **ctx)]
    assert fired_t == fired_j, (site, ctx)
  assert tp.exhausted() == jp.exhausted()


def test_partition_owner_seam_raises_typed():
  for chaos, fo in ((jchaos, jfo), (tchaos, tfo)):
    chaos.install('partition.owner:kill:2:partition=6')
    try:
      chaos.partition_owner_check(step=1)
      with pytest.raises(fo.PartitionLostError) as ei:
        chaos.partition_owner_check(step=2)
      assert ei.value.partition == 6
      chaos.partition_owner_check(step=3)
    finally:
      chaos.uninstall()


# -- the routing-convention pin -------------------------------------------------

def test_no_mod_p_routing_convention_outside_book():
  """Every ownership read in the port's `parallel/` goes through
  `partition_book`: no inline ``searchsorted(bounds...)`` owner lookups
  and no ``% num_parts`` / ``% P`` routing in code outside it (strings
  and comments excepted) — the port's twin of the JAX package's pin."""
  root = Path(__file__).resolve().parents[1] / 'graphlearn_tpu_torch'
  owner_pat = re.compile(r'searchsorted\((?:g\.)?bounds\w*,')
  mod_pat = re.compile(
      r'[-\w\])]\s*%\s*(?:num_parts|self\.num_parts|P\b|mesh\.size|parts\b)')
  offenders = []
  files = sorted((root / 'parallel').glob('*.py'))
  assert len(files) >= 10
  for f in files:
    if f.name == 'partition_book.py':
      continue
    src = f.read_text()
    lines = src.splitlines()
    code = list(lines)
    for tok in tokenize.generate_tokens(io.StringIO(src).readline):
      if tok.type in (tokenize.STRING, tokenize.COMMENT):
        (r0, c0), (r1, c1) = tok.start, tok.end
        for r in range(r0, r1 + 1):
          line = code[r - 1]
          lo = c0 if r == r0 else 0
          hi = c1 if r == r1 else len(line)
          code[r - 1] = line[:lo] + ' ' * (hi - lo) + line[hi:]
    for ln, c in enumerate(code, 1):
      if owner_pat.search(c) or mod_pat.search(c):
        offenders.append(f'{f.name}:{ln}: {lines[ln - 1].strip()}')
  assert not offenders, '\n'.join(offenders)


# -- refresh_cb -----------------------------------------------------------------

def test_shard_refresh_cb_rewrites_from_current_stacks(tmp_path):
  """`ShardStore.refresh_cb` rewrites the durable shards from the
  dataset's CURRENT stacks (called directly: the port's mesh has no
  stream, so no ingest compaction calls it).  After the graph grows, the
  refreshed shards equal the JAX package's shards of the grown graph."""
  rows, cols, feat, lab = _graph()
  ds = port_dataset()
  store = tfo.ShardStore(tmp_path / 'port')
  store.write_dataset_shards(ds)
  before = store.load_shard(0)
  rng = np.random.default_rng(7)
  rows2 = np.concatenate([rows, rng.integers(0, N, 40)])
  cols2 = np.concatenate([cols, rng.integers(0, N, 40)])
  grown = DistDataset.from_full_graph(P, rows2, cols2, feat, lab,
                                      device='cpu')
  ds.graph = grown.graph
  store.refresh_cb(ds)()
  after = store.load_shard(0)
  assert not np.array_equal(before['indptr'], after['indptr'])
  jstore = jfo.ShardStore(tmp_path / 'jax')
  jstore.write_dataset_shards(JaxDistDataset.from_full_graph(
      P, rows2, cols2, feat, lab))
  assert store.meta() == jstore.meta() and store.meta()['num_parts'] == P
  for r in range(P):
    jl, tl = jstore.load_shard(r), store.load_shard(r)
    for k in jl:
      assert np.array_equal(tl[k], jl[k]), (r, k)


# -- the mesh engines under a book adopted before the epoch ---------------------

def _adopt_both(jds, ds, tmp_path, lost=2):
  for fo, d, name in ((jfo, jds, 'jax'), (tfo, ds, 'port')):
    store = fo.ShardStore(tmp_path / name)
    store.write_dataset_shards(d)
    fo.adopt_shard(d, store, lost)


@pytest.mark.parametrize('with_edge,max_degree', [(True, None), (False, 2)])
def test_subgraph_sampler_under_adopted_book(env, tmp_path, with_edge,
                                             max_degree):
  """The exact full-window hop (K3's arm, with edge ids) and the
  truncating one (K1's) under an adopted book equal JAX's."""
  fields = ('node', 'x', 'y', 'edge_index', 'edge_mask') + (
      ('edge',) if with_edge else ())
  kw = dict(batch_size=4, shuffle=True, seed=0, with_edge=with_edge,
            max_degree=max_degree)
  jds, ds = jax_dataset(), port_dataset()
  want = epoch(JaxSubGraphLoader(jds, [3, 2], np.arange(N), **kw), fields)
  _adopt_both(jds, ds, tmp_path)
  jgot = epoch(JaxSubGraphLoader(jds, [3, 2], np.arange(N), **kw), fields)
  tl = DistSubGraphLoader(ds, [3, 2], np.arange(N), draws=jax_key_draws(0),
                          device='cpu', **kw)
  tgot = epoch(tl, fields)
  assert tl.sampler.exact_window == (max_degree is None)
  assert_epochs_equal(jgot, tgot, 'subgraph adopted')
  assert_epochs_equal(want, tgot, 'subgraph adopted vs fault-free')
  assert tl.sampler._book_lanes is not None


def test_random_walker_under_adopted_book(env, tmp_path):
  """Walks under an adopted book equal JAX's and the fault-free ones.
  The stores carry no features: JAX's walker stacks an adopted payload's
  feature shard into its featureless placeholder and fails (a gap in the
  reference, not the port: the port's walker over a store with features
  is held to its own fault-free walks below)."""
  rows, cols, feat, lab = _graph()
  jds = JaxDistDataset.from_full_graph(P, rows, cols, num_nodes=N)
  ds = DistDataset.from_full_graph(P, rows, cols, num_nodes=N, device='cpu')
  rng = np.random.default_rng(3)
  starts = [ds.old2new[rng.integers(0, N, (P, 24))].astype(np.int32)
            for _ in range(2)]
  jw0 = JaxWalker(jds, 5, seed=0)
  want = [np.asarray(jw0.walk(s)) for s in starts]
  _adopt_both(jds, ds, tmp_path, lost=5)
  jw = JaxWalker(jds, 5, seed=0)
  tw = DistRandomWalker(ds, 5, draws=jax_key_draws(0), device='cpu')
  for i, s in enumerate(starts):
    got = tw.walk(s).numpy()
    np.testing.assert_array_equal(got, np.asarray(jw.walk(s)), f'call {i}')
    np.testing.assert_array_equal(got, want[i], f'call {i} vs fault-free')
  js, ts = (jw.exchange_stats(tick_metrics=False),
            tw.exchange_stats(tick_metrics=False))
  for k in _exchange_keys(js):
    assert ts[k] == js[k], k
  fds = port_dataset()
  _adopt_both(jax_dataset(), fds, tmp_path / 'feat', lost=5)
  fw = DistRandomWalker(fds, 5, draws=jax_key_draws(0), device='cpu')
  for i, s in enumerate(starts):
    np.testing.assert_array_equal(fw.walk(s).numpy(), want[i])


def test_fused_dist_epoch_under_adopted_book(env, tmp_path):
  """`FusedDistEpoch` over an adopted book: the epoch's losses and
  accuracy equal JAX's fused epoch on the same adopted book, and the
  chunk boundary's supervision adopts a range killed there."""
  import optax
  from graphlearn_tpu.models import GraphSAGE as FlaxGraphSAGE
  from graphlearn_tpu.models import create_train_state
  from graphlearn_tpu.parallel import local_batch_piece, replicate
  from graphlearn_tpu.parallel import make_mesh as jax_make_mesh
  from graphlearn_tpu.parallel.fused import FusedDistEpoch as JaxFused
  from graphlearn_tpu_torch.models import GraphSAGE, graphsage_from_flax
  from graphlearn_tpu_torch.parallel import FusedDistEpoch
  from test_torch_dist_gns import _numpy_tree
  from test_torch_fused_mesh import jax_epoch_draws
  jds, ds = jax_dataset(), port_dataset()
  _adopt_both(jds, ds, tmp_path, lost=6)
  jmesh = jax_make_mesh(P)
  train = np.arange(0, 160)
  batch = next(iter(jax_loader(jds)))
  fmodel = FlaxGraphSAGE(hidden_features=8, out_features=4, num_layers=2)
  tx = optax.adam(3e-3)
  state, apply_fn = create_train_state(fmodel, jax.random.key(0),
                                       local_batch_piece(batch, P), tx)
  model = GraphSAGE(6, 8, 4, num_layers=2)
  model.load_state_dict(graphsage_from_flax(_numpy_tree(state.params)))
  opt = torch.optim.Adam(model.parameters(), lr=3e-3, eps=1e-8)
  jf = JaxFused(jds, [3, 2], train, apply_fn, tx, batch_size=4, mesh=jmesh,
                seed=0)
  tf = FusedDistEpoch(ds, [3, 2], train, model, opt, batch_size=4, seed=0,
                      draws=jax_epoch_draws(0), device='cpu')
  jstate = replicate(state, jmesh)
  jstate, jstats = jf.run(jstate)
  stats = tf.run()
  np.testing.assert_allclose(stats.losses.numpy(), np.asarray(jstats.losses),
                             rtol=1e-5, atol=1e-5)
  assert (stats.correct, stats.seeds) == (jstats.correct, jstats.seeds)
  assert tf.sampler.book_spec.version == 1
  # a kill at the next chunk boundary adopts at the same arrival in both
  env.setenv('GLT_SHARD_DIR', str(tmp_path / 'port'))
  jchaos.install('partition.owner:kill:1:partition=1')
  tchaos.install('partition.owner:kill:1:partition=1')
  try:
    jstate, jstats = jf.run(jstate)
    stats = tf.run()
  finally:
    jchaos.uninstall()
    tchaos.uninstall()
  np.testing.assert_allclose(stats.losses.numpy(), np.asarray(jstats.losses),
                             rtol=1e-5, atol=1e-5)
  assert_books_equal(jds.partition_book, ds.partition_book)
  assert ds.partition_book.version == 2
