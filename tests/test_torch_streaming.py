"""The streaming slice (WAL -> delta-CSR merge -> RCU publish ->
version-pinned serving) of the port against the JAX package.

Everything compared here is integer or gathered bytes, so every
comparison is exact (tolerance 0): the rank formulas against the JAX
Pallas rank kernel (interpret mode), merges against the JAX host merge
and its Pallas device merge, WAL files across the two packages, every
published view against the JAX `StreamingGraph` over the same batches,
and served trees against the JAX engine over the same version's edges
with JAX's draws replayed.
"""
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphlearn_tpu.data import Dataset as JaxDataset
from graphlearn_tpu.ops.pallas_delta import DeltaMergeUnsupported
from graphlearn_tpu.ops.pallas_delta import \
    merge_delta_csr_device as jax_merge_device
from graphlearn_tpu.ops.pallas_delta import merge_ranks as jax_merge_ranks
from graphlearn_tpu.serving import ServingEngine as JaxServingEngine
from graphlearn_tpu.streaming import IngestPipeline as JaxIngestPipeline
from graphlearn_tpu.streaming import StreamingGraph as JaxStreamingGraph
from graphlearn_tpu.streaming import WriteAheadLog as JaxWriteAheadLog
from graphlearn_tpu.streaming.delta import DeltaSegment as JaxDeltaSegment
from graphlearn_tpu.streaming.delta import \
    merge_delta_csr as jax_merge_host
from graphlearn_tpu_torch.data import Dataset, Graph
from graphlearn_tpu_torch.ops import (default_window, merge_delta_csr_device,
                                      merge_ranks, merge_ranks_plain,
                                      rank_inputs, rank_plan, rank_rows,
                                      sample_one_hop)
from graphlearn_tpu_torch.ops.delta_merge import (MAX_TILE, NARROW_BASE,
                                                   NARROW_NEW, WIDE_QUERIES)
from graphlearn_tpu_torch.serving import ServingEngine
from graphlearn_tpu_torch.streaming import (DeltaSegment, IngestPipeline,
                                            StreamingGraph, WriteAheadLog,
                                            merge_delta_csr)
from graphlearn_tpu_torch.telemetry import live, recorder
from graphlearn_tpu_torch.testing import chaos

N = 64


@pytest.fixture(autouse=True)
def _clean():
  chaos.uninstall()
  recorder.enable()
  recorder.clear()
  yield
  chaos.uninstall()
  recorder.clear()
  recorder.disable()


def _base_coo(seed=0, e=3 * N):
  rng = np.random.default_rng(seed)
  return rng.integers(0, N, e), rng.integers(0, N, e)


def _batches(k=8, b=11, seed=1):
  rng = np.random.default_rng(seed)
  return [(rng.integers(0, N, b), rng.integers(0, N, b)) for _ in range(k)]


def _fresh_stream(reserve=0):
  rows, cols = _base_coo()
  return StreamingGraph.from_coo(rows, cols, num_nodes=N,
                                 reserve_edges=reserve, device='cpu')


def _jax_stream():
  rows, cols = _base_coo()
  return JaxStreamingGraph.from_coo(rows, cols, num_nodes=N, device=False)


def _assert_views_equal(got, ref):
  for name in ('indptr', 'indices', 'edge_ids'):
    a, b = getattr(got, name), getattr(ref, name)
    assert a.dtype == b.dtype, name
    np.testing.assert_array_equal(a, b, err_msg=name)


# -- the merge ranks ----------------------------------------------------------

def _delta_fixture(n=60, seed=12, events=41):
  """A sorted CSR (Poisson degrees, duplicate columns) and a segment
  whose rows hold unsorted, repeated columns that tie with the base."""
  rng = np.random.default_rng(seed)
  deg = rng.poisson(6, n)
  indptr = np.zeros(n + 1, np.int64)
  np.cumsum(deg, out=indptr[1:])
  e = int(indptr[-1])
  indices = np.concatenate([np.sort(rng.integers(0, n // 3, d))
                            for d in deg]).astype(np.int64)
  eids = rng.permutation(e).astype(np.int64)
  src = rng.integers(0, n // 4, events).astype(np.int64)
  dst = rng.integers(0, n // 3, events).astype(np.int64)
  return indptr, indices, eids, src, dst


def _wide_fixture(n=14, seed=21):
  """Rows of base widths up to 300 and 33-64 new columns that all tie
  (with each other and with base columns), plus one row of unsorted new
  columns; events of the rows interleave."""
  rng = np.random.default_rng(seed)
  deg = rng.integers(0, 301, n)
  deg[:4] = (0, 129, 300, 33)
  indptr = np.zeros(n + 1, np.int64)
  np.cumsum(deg, out=indptr[1:])
  indices = np.concatenate([np.sort(rng.integers(0, 4, d))
                            for d in deg]).astype(np.int64)
  src, dst = [], []
  for row in range(0, n, 2):
    cnt = int(rng.integers(33, 65))
    src.append(np.full(cnt, row))
    dst.append(np.full(cnt, rng.integers(0, 4)) if row != 4
               else rng.integers(0, 4, cnt))
  src, dst = np.concatenate(src), np.concatenate(dst)
  perm = rng.permutation(len(src))
  eids = rng.permutation(int(indptr[-1])).astype(np.int64)
  return (indptr, indices, eids, src[perm].astype(np.int64),
          dst[perm].astype(np.int64))


def _port_ranks(indptr, indices, src, dst):
  ri = rank_inputs(indptr, src)
  t = torch.from_numpy
  rows = rank_rows(ri.base_start, ri.base_cnt, ri.seg_off, ri.seg_cnt,
                   ri.base_out, device='cpu')
  pos_b, pos_s = merge_ranks(rows, t(np.asarray(indices, np.int32)),
                             t(np.asarray(dst, np.int32)[ri.order]))
  return ri, pos_b.numpy(), pos_s.numpy()


@pytest.mark.parametrize('seed', [12, 13, 14, 'wide'])
def test_plain_ranks_equal_jax_rank_kernel(seed):
  """The port's ragged ranks (plain version on the CPU) equal the JAX
  Pallas rank kernel's padded `[R, L]` ranks, cropped to its masks, on
  unsorted segment rows with ties on both sides; ``wide`` holds rows of
  the kernel's wide class: 33-64 tied new columns, base rows up to 300
  wide."""
  indptr, indices, _, src, dst = (_wide_fixture() if seed == 'wide'
                                  else _delta_fixture(seed=seed))
  ri, pos_b, pos_s = _port_ranks(indptr, indices, src, dst)
  assert (ri.seg_cnt > 1).any()
  if seed == 'wide':                      # the kernel's wide class only
    rows = rank_plan(ri.base_cnt, ri.seg_cnt).blocks[:, 0]
    assert set(rows.tolist()) == set(range(len(ri.rows)))
    assert ri.seg_cnt.min() > NARROW_NEW and ri.base_cnt.max() > NARROW_BASE
  s_dst = dst[ri.order]
  sent = np.iinfo(np.int32).max
  lb, ls = int(ri.base_cnt.max()), int(ri.seg_cnt.max())
  bmask = np.arange(lb) < ri.base_cnt[:, None]
  smask = np.arange(ls) < ri.seg_cnt[:, None]
  bc = np.full((len(ri.rows), lb), sent, np.int32)
  bc[bmask] = indices[(indptr[ri.rows][:, None] + np.arange(lb))[bmask]]
  sc = np.full((len(ri.rows), ls), sent, np.int32)
  sc[smask] = s_dst[(ri.seg_off[:, None] + np.arange(ls))[smask]]
  assert any((np.diff(row[m]) < 0).any() for row, m in zip(sc, smask))
  ref_b, ref_s = jax_merge_ranks(bc, sc, interpret=True)
  assert pos_b.dtype == pos_s.dtype == np.int32
  np.testing.assert_array_equal(pos_b, ref_b[bmask])
  np.testing.assert_array_equal(pos_s, ref_s[smask])


def test_ranks_wrapper_on_cpu_runs_plain_and_checks_dtypes():
  indptr, indices, _, src, dst = _delta_fixture()
  before = merge_ranks.launches
  calls = merge_ranks_plain.calls
  _port_ranks(indptr, indices, src, dst)
  assert merge_ranks.launches == before
  assert merge_ranks_plain.calls == calls + 1
  ri = rank_inputs(indptr, src)
  rows = rank_rows(ri.base_start, ri.base_cnt, ri.seg_off, ri.seg_cnt,
                   ri.base_out, device='cpu')
  t = torch.from_numpy
  with pytest.raises(ValueError, match='indices'):
    merge_ranks(rows, t(indices), t(dst.astype(np.int32)))
  with pytest.raises(ValueError, match='base_cnt'):
    merge_ranks(rows._replace(base_cnt=rows.base_cnt.int()),
                t(indices.astype(np.int32)), t(dst.astype(np.int32)))
  with pytest.raises(ValueError, match='work'):
    merge_ranks(rows._replace(work=rows.work[:, :5].contiguous()),
                t(indices.astype(np.int32)), t(dst.astype(np.int32)))
  with pytest.raises(ValueError, match='int32'):
    rank_plan(np.array([2 ** 31 - 1]), np.array([1]))


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_rank_plan_covers_each_row_and_column_once(seed):
  """`rank_plan` against brute force: exactly the rows wider than the
  narrow class (base > NARROW_BASE or new > NARROW_NEW) have blocks;
  every base and new column of such a row lies in exactly one block's
  query chunk, every block holds at least one, and the tile is the
  smallest power of two holding the widest wide row's new columns, up
  to MAX_TILE.  `rank_rows` keeps the rows' order and gives each block
  its row's descriptor."""
  rng = np.random.default_rng(seed)
  r = 300
  base = rng.choice([0, 1, 31, 32, 33, 127, 128, 129, 1000, 8192], r)
  new = rng.choice([0, 1, 2, 31, 32, 33, 64, 512, 9000], r)
  if seed == 2:
    new[new > NARROW_NEW] = NARROW_NEW    # base-wide rows only
  plan = rank_plan(base, new)
  wide = [i for i in range(r)
          if base[i] > NARROW_BASE or new[i] > NARROW_NEW]
  assert sorted(set(plan.blocks[:, 0].tolist())) == wide
  covered = {i: np.zeros(base[i] + new[i], np.int64) for i in wide}
  for row, q0 in plan.blocks.tolist():
    assert q0 < base[row] + new[row]
    covered[row][q0:q0 + WIDE_QUERIES] += 1
  for row, hits in covered.items():
    assert (hits == 1).all(), row
  widest = max([int(new[i]) for i in wide], default=0)
  assert plan.tile == (0 if not wide else
                       min(1 << max(widest - 1, 0).bit_length(), MAX_TILE))
  start, off, out = (rng.integers(0, 1 << 40, r) for _ in range(3))
  rows = rank_rows(start, base, off, new, out, device='cpu')
  want = np.stack([start, off, out, base, new], 1)[plan.blocks[:, 0]]
  np.testing.assert_array_equal(rows.work.numpy()[:, :5], want)
  np.testing.assert_array_equal(rows.work.numpy()[:, 5], plan.blocks[:, 1])
  for got, a in zip(rows[:5], (start, base, off, new, out)):
    np.testing.assert_array_equal(got.numpy(), a)
  assert (rows.tile, rows.n_base) == (plan.tile, int(base.sum()))
  empty = rank_plan(np.zeros(0, np.int64), np.zeros(0, np.int64))
  assert (len(empty.blocks), empty.tile) == (0, 0)


def _merge_case(case):
  indptr, indices, eids, src, dst = _delta_fixture(seed=7)
  e = len(indices)
  if case == 'empty_segment':
    src, dst = src[:0], dst[:0]
  elif case == 'empty_base':
    indptr = np.zeros_like(indptr)
    indices, eids = indices[:0], eids[:0]
    e = 0
  elif case == 'ties':
    src = np.full(20, 7, np.int64)
    dst = np.array([3] * 10 + [5] * 10, np.int64)
    dst[::3] = indices[indptr[7]] if indptr[8] > indptr[7] else 1
  elif case == 'wide_row':                # past the JAX kernel's 2048 cap
    n = len(indptr) - 1
    deg = np.diff(indptr)
    deg[9] = 2600
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    rng = np.random.default_rng(3)
    indices = np.concatenate([np.sort(rng.integers(0, n // 3, d))
                              for d in deg]).astype(np.int64)
    e = len(indices)
    eids = rng.permutation(e).astype(np.int64)
    src = np.concatenate([src, np.full(30, 9)])
    dst = np.concatenate([dst, rng.integers(0, n // 3, 30)])
  ev = (np.arange(len(src)) + e).astype(np.int64)
  return indptr, indices, eids, src, dst, ev


@pytest.mark.parametrize('case', ['random', 'empty_segment', 'empty_base',
                                  'ties', 'wide_row'])
def test_merges_byte_equal_to_jax(case):
  """Both port merges equal the JAX host merge, dtypes included, and
  the JAX Pallas merge wherever it takes the shape (it refuses a row
  wider than 2048; the port has no cap)."""
  indptr, indices, eids, src, dst, ev = _merge_case(case)
  ref = jax_merge_host(indptr, indices, eids,
                       JaxDeltaSegment(src=src, dst=dst, eids=ev))
  seg = DeltaSegment(src=src, dst=dst, eids=ev)
  got_dev = merge_delta_csr_device(indptr, indices, eids, seg,
                                   device='cpu')
  got_host = merge_delta_csr(indptr, indices, eids, seg)
  if case == 'wide_row':
    with pytest.raises(DeltaMergeUnsupported):
      jax_merge_device(indptr, indices, eids,
                       JaxDeltaSegment(src=src, dst=dst, eids=ev),
                       interpret=True)
  else:
    jax_dev = jax_merge_device(indptr, indices, eids,
                               JaxDeltaSegment(src=src, dst=dst, eids=ev),
                               interpret=True)
    for a, b in zip(jax_dev, ref):
      np.testing.assert_array_equal(a, b)
  for got in (got_dev, got_host):
    for a, b, name in zip(got, ref, ('indptr', 'indices', 'eids')):
      assert a.dtype == b.dtype, name
      np.testing.assert_array_equal(a, b, err_msg=name)


def test_merge_refuses_out_of_range_source_like_jax():
  indptr, indices, eids, _, _ = _delta_fixture()
  bad = DeltaSegment(src=np.array([len(indptr)]), dst=np.array([0]),
                     eids=np.array([0]))
  with pytest.raises(ValueError, match='out of range'):
    merge_delta_csr_device(indptr, indices, eids, bad, device='cpu')
  with pytest.raises(ValueError, match='out of range'):
    merge_delta_csr(indptr, indices, eids, bad)


# -- the WAL is shared between the packages -----------------------------------

def _write_log(cls, d):
  wal = cls(d)
  for i in range(4):
    assert wal.append([i, i + 1, 2], [i + 3, i, 5]) == i + 1
  wal.reset_to(1)                   # a compaction epilogue: new header
  assert wal.append([9], [8]) == 5
  size = wal.stats()['bytes']
  wal.close()
  return size


@pytest.mark.parametrize('writer,reader', [
    (JaxWriteAheadLog, WriteAheadLog), (WriteAheadLog, JaxWriteAheadLog)],
    ids=['jax_to_port', 'port_to_jax'])
def test_wal_replays_across_packages(tmp_path, writer, reader):
  """Same on-disk format: seqnos, counts, the compaction header and
  torn-tail truncation read the same in either package."""
  size = _write_log(writer, tmp_path)
  wal = reader(tmp_path)
  recs = list(wal.replay())
  assert [r.seqno for r in recs] == [2, 3, 4, 5]
  np.testing.assert_array_equal(recs[0].src, [1, 2, 2])
  np.testing.assert_array_equal(recs[-1].dst, [8])
  assert recs[0].src.dtype == np.int64
  assert wal.last_seqno == 5 and wal.total_events == 10
  assert wal.lifetime_events == 13
  wal.close()
  with open(tmp_path / 'wal.log', 'r+b') as f:  # tear the newest record
    f.truncate(size - 5)
  wal = reader(tmp_path)
  assert wal.truncations == 1
  assert [r.seqno for r in wal.replay()] == [2, 3, 4]
  assert wal.append([1], [1]) == 5
  wal.close()
  assert [r.seqno for r in writer(tmp_path).replay()] == [2, 3, 4, 5]


# -- StreamingGraph -----------------------------------------------------------

def test_every_published_view_equals_jax_stream():
  sg, jsg = _fresh_stream(), _jax_stream()
  _assert_views_equal(sg.pin(), jsg.pin())
  for r, c in _batches(k=6, b=13):
    v, jv = sg.apply_events(r, c), jsg.apply_events(r, c)
    assert v.version == jv.version
    _assert_views_equal(v, jv)
  assert sg.version == 7
  # the device twins hold the same CSR: int64 indptr, int32 padded
  # indices with a zero tail, and the edge count from the host arrays
  v = sg.pin()
  assert v.indptr_dev.dtype == torch.int64
  assert v.indices_dev.dtype == torch.int32
  assert v.indices_dev.numel() == sg.edge_capacity >= v.num_edges
  np.testing.assert_array_equal(v.indptr_dev.numpy(), v.indptr)
  np.testing.assert_array_equal(v.indices_dev[:v.num_edges].numpy(),
                                v.indices)
  assert not v.indices_dev[v.num_edges:].any()
  pubs = recorder.events('stream.publish')
  assert [e['version'] for e in pubs] == list(range(2, 8))
  assert all(e['total_ms'] >= e['ranks_ms'] >= 0 for e in pubs)


def test_out_of_range_events_refused():
  sg = _fresh_stream()
  v = sg.version
  with pytest.raises(ValueError, match='destination'):
    sg.apply_events([0], [N])
  with pytest.raises(ValueError, match='source'):
    sg.apply_events([N + 3], [0])
  assert sg.version == v               # nothing half-published


def test_rcu_pin_survives_later_publishes():
  sg = _fresh_stream()
  v1 = sg.pin()
  snap = (v1.indptr.copy(), v1.indices.copy(), v1.indices_dev.clone())
  for r, c in _batches(k=3):
    sg.apply_events(r, c)
  np.testing.assert_array_equal(v1.indptr, snap[0])
  np.testing.assert_array_equal(v1.indices, snap[1])
  assert torch.equal(v1.indices_dev, snap[2])
  assert sg.pin().version == v1.version + 3


def test_edge_capacity_grows_by_powers_of_two():
  sg = _fresh_stream(reserve=256)
  jsg = JaxStreamingGraph.from_coo(*_base_coo(), num_nodes=N,
                                   reserve_edges=256, device=True)
  cap0 = sg.edge_capacity
  assert cap0 == jsg.edge_capacity == 256
  sg.apply_events(*_batches(k=1, b=5)[0])
  assert sg.edge_capacity == cap0
  assert sg.pin().indices_dev.numel() == cap0
  big = np.arange(2 * cap0) % N
  sg.apply_events(big, (big + 1) % N)
  jsg.apply_events(*_batches(k=1, b=5)[0])
  jsg.apply_events(big, (big + 1) % N)
  assert sg.edge_capacity == jsg.edge_capacity > cap0
  assert sg.edge_capacity & (sg.edge_capacity - 1) == 0
  assert sg.pin().indices_dev.numel() == sg.edge_capacity


def test_state_dict_round_trip():
  sg = _fresh_stream(reserve=512)
  for r, c in _batches(k=3):
    sg.apply_events(r, c)
  state = sg.state_dict()
  other = StreamingGraph.from_coo([0], [1], num_nodes=N, device='cpu')
  other.load_state_dict(state)
  _assert_views_equal(other.pin(), sg.pin())
  assert other.version == sg.version == 4
  assert other.edge_capacity == 512
  r, c = _batches(k=1, seed=9)[0]
  _assert_views_equal(other.apply_events(r, c), sg.apply_events(r, c))
  # the JAX stream loads the port's state and publishes the same next
  jsg = _jax_stream()
  jsg.load_state_dict(sg.state_dict())
  r, c = _batches(k=1, seed=10)[0]
  _assert_views_equal(sg.apply_events(r, c), jsg.apply_events(r, c))


def test_graph_over_a_view_counts_the_views_edges():
  sg = _fresh_stream(reserve=1024)
  ds = Dataset().attach_stream(sg)
  g = ds.get_graph()
  assert ds.stream is sg
  assert g.num_edges == sg.num_edges == 3 * N
  assert g.indices.numel() == 1024
  assert g.indices.data_ptr() == sg.pin().indices_dev.data_ptr()
  assert isinstance(Graph.from_view(sg.pin()), Graph)


# -- the ingest pipeline ------------------------------------------------------

def _drive(wal_dir, plan=None, compact_every=3):
  """The fixed event sequence through a pipeline, with a process kill +
  restart at every fired fault.  A WAL-append fault means the client was
  never acked, so it resubmits; an apply/compact kill means the batch is
  durably logged, so replay owns it."""
  def fresh():
    return IngestPipeline(_fresh_stream(), wal_dir=str(wal_dir),
                          compact_every=compact_every)

  pipe = fresh()
  if plan:
    chaos.install(plan)
  kills = 0
  try:
    for r, c in _batches():
      try:
        pipe.ingest(r, c)
      except chaos.ChaosKilledError:
        kills += 1
        pipe.close()
        pipe = fresh()
      except chaos.InjectedFault:
        kills += 1
        pipe.close()
        pipe = fresh()
        pipe.ingest(r, c)
  finally:
    chaos.uninstall()
  stats = pipe.stats()
  pipe.close()
  return pipe.stream.pin(), kills, stats


def _jax_reference():
  jsg = _jax_stream()
  for r, c in _batches():
    jsg.apply_events(r, c)
  return jsg.pin()


@pytest.mark.parametrize('site,action,nth', [
    ('ingest.apply', 'kill', 4),
    ('ingest.compact', 'kill', 2),
    ('ingest.wal', 'truncate', 4),
    ('ingest.wal', 'fail', 3),
])
def test_exactly_once_under_chaos(tmp_path, site, action, nth):
  """Kill at any ingest seam, restart, and the recovered graph is
  byte-identical to a fault-free run — and to the JAX stream over the
  same batches."""
  ref, _, ref_stats = _drive(tmp_path / 'ref')
  got, kills, stats = _drive(
      tmp_path / 'chaos',
      {'faults': [{'site': site, 'action': action, 'nth': nth}]})
  assert kills == 1
  _assert_views_equal(got, ref)
  _assert_views_equal(got, _jax_reference())
  assert stats['applied_events'] == ref_stats['applied_events'] == 88


def test_compaction_bounds_replay(tmp_path):
  pipe = IngestPipeline(_fresh_stream(), wal_dir=str(tmp_path),
                        compact_every=2)
  for r, c in _batches(k=7):
    pipe.ingest(r, c)
  assert pipe.stats()['compactions'] == 3
  pipe.close()
  recorder.clear()
  pipe2 = IngestPipeline(_fresh_stream(), wal_dir=str(tmp_path),
                         compact_every=2)
  rep = recorder.events('ingest.replay')[-1]
  assert rep['restored'] is True
  assert rep['replayed_records'] == 1   # only the post-compaction suffix
  _assert_views_equal(pipe2.stream.pin(), pipe.stream.pin())
  pipe2.close()


def test_torn_tail_replay_and_live_recover(tmp_path):
  """A torn WAL tail replays exactly the whole-record prefix; the
  resubmitted batch lands once; recover() on a live pipeline is a
  no-op."""
  pipe = IngestPipeline(_fresh_stream(), wal_dir=str(tmp_path),
                        compact_every=0)
  batches = _batches(k=4)
  for r, c in batches[:3]:
    pipe.ingest(r, c)
  chaos.install('ingest.wal:truncate:1')
  with pytest.raises(chaos.InjectedFault):
    pipe.ingest(*batches[3])
  chaos.uninstall()
  pipe.close()
  pipe2 = IngestPipeline(_fresh_stream(), wal_dir=str(tmp_path),
                         compact_every=0)
  assert recorder.events('ingest.replay')[-1]['replayed_records'] == 3
  assert pipe2.wal.truncations == 1 and pipe2.stream.version == 4
  pipe2.ingest(*batches[3])
  assert pipe2.recover()['replayed_records'] == 0
  ref = _fresh_stream()
  for r, c in batches:
    ref.apply_events(r, c)
  _assert_views_equal(pipe2.stream.pin(), ref.pin())
  pipe2.close()


def test_port_recovers_a_jax_pipelines_log(tmp_path):
  """A WAL the JAX pipeline wrote is replayed by the port's pipeline
  into the same graph."""
  jpipe = JaxIngestPipeline(_jax_stream(), wal_dir=str(tmp_path),
                            compact_every=0)
  for r, c in _batches():
    jpipe.ingest(r, c)
  jview = jpipe.stream.pin()
  jpipe.close()
  pipe = IngestPipeline(_fresh_stream(), wal_dir=str(tmp_path),
                        compact_every=0)
  assert pipe.stats()['applied_seqno'] == 8
  _assert_views_equal(pipe.stream.pin(), jview)
  pipe.close()


def test_health_metrics_and_lag_flip(tmp_path):
  pipe = IngestPipeline(_fresh_stream(), wal_dir=str(tmp_path),
                        compact_every=0, max_lag=5)
  pipe.ingest([1, 2], [3, 4])
  snap = live.snapshot()
  assert snap['ingest.events_total'] >= 2
  assert snap['ingest.lag_events'] == 0
  assert snap['graph.version'] == pipe.stream.version
  assert live.healthz()['components']['ingestion']['healthy']
  pipe.close()
  pipe2 = IngestPipeline(_fresh_stream(), wal_dir=str(tmp_path),
                         compact_every=0, max_lag=1, recover=False)
  comp = live.healthz()['components']['ingestion']
  assert not comp['healthy'] and comp['lag_events'] == 2
  pipe2.recover()
  assert live.healthz()['components']['ingestion']['healthy']
  pipe2.close()
  assert 'ingestion' not in live.healthz()['components']
  assert 'ingest.lag_events' not in live.snapshot()


def test_ingest_fault_dumps_postmortem(tmp_path, monkeypatch):
  from graphlearn_tpu_torch.telemetry import postmortem
  monkeypatch.setenv(postmortem.POSTMORTEM_DIR_ENV, str(tmp_path / 'pm'))
  postmortem.reset()
  pipe = IngestPipeline(_fresh_stream(), wal_dir=str(tmp_path / 'wal'),
                        compact_every=0)
  chaos.install('ingest.apply:kill:2')
  pipe.ingest([1], [2])
  with pytest.raises(chaos.ChaosKilledError):
    pipe.ingest([3], [4])
  chaos.uninstall()
  bundles = list((tmp_path / 'pm').glob('*.json'))
  assert len(bundles) == 1 and 'ingest_apply' in bundles[0].name
  bundle = json.loads(bundles[0].read_text())
  assert bundle['reason'] == 'ingest.apply'
  assert bundle['extra']['wal_seqno'] == 2
  assert bundle['extra']['applied_seqno'] == 1
  assert not bundle['health']['components']['ingestion']['healthy']
  assert [e['kind'] for e in bundle['events']].count('fault.injected') == 1
  pipe.close()
  postmortem.reset()


# -- readers of a moving graph ------------------------------------------------

def test_one_hop_on_a_padded_view_equals_static():
  """The sampler over a quiesced stream's padded twins is byte-equal to
  it over the same graph loaded statically."""
  rows, cols = _base_coo(seed=9)
  sg = StreamingGraph.from_coo(rows, cols, num_nodes=N, reserve_edges=4096,
                               device='cpu')
  extra = _batches(k=2, b=31, seed=4)
  for r, c in extra:
    sg.apply_events(r, c)
  all_r = np.concatenate([rows] + [r for r, _ in extra])
  all_c = np.concatenate([cols] + [c for _, c in extra])
  g = Dataset().init_graph((all_r, all_c), num_nodes=N,
                           device='cpu').get_graph()
  view = sg.pin()
  assert view.indices_dev.numel() > 2 * g.indices.numel()
  seeds = torch.tensor([0, 5, 17, 40, -1, N - 1], dtype=torch.int32)
  rng = np.random.default_rng(0)
  for k in (3, 6):
    w = default_window(k)
    u = torch.from_numpy(rng.random((6, k), np.float32))
    gum = torch.from_numpy(rng.gumbel(size=(6, w)).astype(np.float32))
    a = sample_one_hop(view.indptr_dev, view.indices_dev, seeds, k, u, gum)
    b = sample_one_hop(g.indptr, g.indices, seeds, k, u, gum)
    assert torch.equal(a.nbrs, b.nbrs) and torch.equal(a.mask, b.mask)


def _jax_replay_draws(engine_seed):
  """A draws provider that reproduces the JAX engine's per-seed keys
  (``fold_in(key(seed), node)``, ``fold_in(., hop)``, ``split``)."""
  base = jax.random.key(engine_seed)

  def provider(seed_ids, hop, rows_per_seed, k, w):
    us, gs = [], []
    for s in seed_ids.tolist():
      key = jax.random.fold_in(jax.random.fold_in(base, max(s, 0)), hop)
      k_rand, k_win = jax.random.split(key)
      us.append(np.asarray(jax.random.uniform(k_rand, (rows_per_seed, k))))
      gs.append(np.asarray(jax.random.gumbel(k_win, (rows_per_seed, w),
                                             dtype=jnp.float32)))
    return (torch.from_numpy(np.concatenate(us)),
            torch.from_numpy(np.concatenate(gs)))

  return provider


def _serving_pieces(reserve=64):
  rng = np.random.default_rng(3)
  rows = np.repeat(np.arange(N), 4)
  cols = rng.integers(0, N, rows.shape[0])
  feats = rng.random((N, 8), dtype=np.float32)
  sg = StreamingGraph.from_coo(rows, cols, num_nodes=N,
                               reserve_edges=reserve * len(rows),
                               device='cpu')
  ds = (Dataset().init_node_features(feats, device='cpu')
        .attach_stream(sg))
  return sg, ds, feats


def test_serving_pins_one_version_under_ingest():
  """While an ingest thread publishes, every dispatch answers from one
  version: its nodes/x are byte-equal to the JAX engine over that
  version's edge set, with JAX's draws replayed."""
  sg, ds, feats = _serving_pieces()
  eng = ServingEngine(ds, [3, 2], seed=7, buckets=(2,), device='cpu',
                      draws=_jax_replay_draws(7))
  views = {1: sg.pin()}
  refs = {}
  rng = np.random.default_rng(5)
  done = threading.Event()

  def ingest_loop():
    for _ in range(40):
      v = sg.apply_events(rng.integers(0, N, 7), rng.integers(0, N, 7))
      views[v.version] = v
      time.sleep(0.005)
    done.set()

  def jax_ref(version):
    if version not in refs:
      v = views[version]
      jds = (JaxDataset()
             .init_graph((v.indptr, v.indices), layout='CSR', num_nodes=N)
             .init_node_features(feats))
      refs[version] = JaxServingEngine(jds, [3, 2], seed=7, buckets=(2,))
    return refs[version]

  t = threading.Thread(target=ingest_loop, daemon=True)
  t.start()
  seen = []
  try:
    for i in range(5):
      seeds = [i % N, (7 * i + 3) % N]
      got = eng.infer(seeds)
      seen.append(eng.graph_version)
      for _ in range(2000):             # the loop records a view just
        if seen[-1] in views:           # after publishing it
          break
        time.sleep(0.001)
      want = jax_ref(seen[-1]).infer(seeds)
      assert got.nodes.tobytes() == np.asarray(want.nodes).tobytes()
      assert got.x.tobytes() == np.asarray(want.x).tobytes()
      time.sleep(0.02)
  finally:
    t.join(30.0)
  assert done.is_set()
  eng.infer([1, 2])                     # quiesced: the newest version
  assert eng.graph_version == sg.version == 41
  assert seen == sorted(seen) and len(set(seen)) > 1


def test_hold_graph_freezes_version_across_dispatches():
  sg, ds, _ = _serving_pieces(reserve=16)
  eng = ServingEngine(ds, [3, 2], seed=7, buckets=(1, 2), device='cpu')
  rng = np.random.default_rng(2)
  with eng.hold_graph() as held:
    a = eng.infer([3])
    sg.apply_events(rng.integers(0, N, 5), rng.integers(0, N, 5))
    b = eng.infer([3])
    assert eng.graph_version == held == 1
    assert a.nodes.tobytes() == b.nodes.tobytes()
  eng.infer([3])
  assert eng.graph_version == 2
  static = ServingEngine(
      Dataset().init_graph((sg.pin().indptr, sg.pin().indices), layout='CSR',
                           num_nodes=N, device='cpu')
      .init_node_features(ds.node_features.hot_tier, device='cpu'),
      [3, 2], seed=7, buckets=(1, 2), device='cpu')
  assert static.graph_version == 0
  got, want = eng.infer([3, 9]), static.infer([3, 9])
  assert got.nodes.tobytes() == want.nodes.tobytes()
  assert got.x.tobytes() == want.x.tobytes()
