"""Preemption-tolerant training in the port: durable mid-epoch snapshots
and byte-identical resume (the contracts of the JAX package's
`tests/test_snapshot_resume.py`).

A chaos-killed epoch (``fused.dispatch:kill``), restored from the latest
published snapshot in a FRESH driver or loader (a new model and optimizer
from another init: the stand-in for a new process), finishes with the
batches, losses, counts, parameters and optimizer state of an
uninterrupted seeded twin, and the next epoch too: bitwise (the same
steps run in the same order on the CPU).  For the single-card fused
epochs (resident and tiered stores; `FusedEpoch`, `FusedTreeEpoch`,
`FusedLinkEpoch` — a tiered link epoch is not ported), the mesh loaders
(resident, tiered, tiered with GNS; node and link) and the fused mesh
epochs (a kill at epoch 2's only dispatch).  A stale model, optimizer or
chunk size raises `CheckpointMismatchError` naming the path; a snapshot
under a prefetch worker raises.

Cross-package: a port mesh loader over P = 2 (tiered, GNS, fed JAX's
keys) killed after 2 batches and resumed gives, with its pre-kill
batches, JAX's uninterrupted epoch byte for byte (JAX's own resume of
that GNS loader is not: its state has no ``gns_inflight`` leaf, and the
characterisation test pins that gap); a resumed `FusedEpoch`
fed JAX's keys and the Flax parameters gives JAX's uninterrupted losses
and parameters within 1e-5 (f32 matmuls reduce in another order in
XLA:CPU than in torch, as `tests/test_torch_fused.py` holds them).
"""
import itertools

import jax
import numpy as np
import optax
import pytest
import torch

from graphlearn_tpu.loader import FusedEpoch as JaxFusedEpoch
from graphlearn_tpu.parallel import DistDataset as JaxDistDataset
from graphlearn_tpu.parallel import DistNeighborLoader as JaxDistLoader
from graphlearn_tpu.parallel import make_mesh as jax_make_mesh
from graphlearn_tpu_torch.data import Dataset
from graphlearn_tpu_torch.loader import (FusedEpoch, FusedLinkEpoch,
                                         FusedTreeEpoch)
from graphlearn_tpu_torch.models import GraphSAGE, TreeSAGE, graphsage_from_flax
from graphlearn_tpu_torch.parallel import (DistDataset, DistLinkNeighborLoader,
                                           DistNeighborLoader,
                                           FusedDistEpoch, FusedDistLinkEpoch,
                                           FusedDistTreeEpoch)
from graphlearn_tpu_torch.telemetry import recorder
from graphlearn_tpu_torch.testing import chaos
from graphlearn_tpu_torch.utils.checkpoint import (CheckpointMismatchError,
                                                   SnapshotManager)
from test_torch_dist_gns import _batch_np, _port_np, jax_key_draws
from test_torch_fused import _datasets as _fused_datasets
from test_torch_fused import _jax_state
from test_torch_fused_tree import _numpy_tree, jax_epoch_draws


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
  for env in ('GLT_SNAPSHOT_DIR', 'GLT_SNAPSHOT_EVERY', 'GLT_FAULT_PLAN',
              'GLT_GNS', 'GLT_COLD_CACHE_ROWS', 'GLT_COLD_PREFETCH',
              'GLT_PALLAS_SAMPLE'):
    monkeypatch.delenv(env, raising=False)
  chaos.uninstall()
  recorder.enable()
  recorder.clear()
  yield
  chaos.uninstall()
  recorder.clear()
  recorder.disable()


# -- single-card fused epochs ----------------------------------------------

N, D, CLASSES = 90, 8, 3


def _cluster_dataset(split_ratio=1.0, seed=0):
  """The JAX test's clustered graph: 6 edges a node, 85% inside the
  node's class."""
  rng = np.random.default_rng(seed)
  labels = (np.arange(N) % CLASSES).astype(np.int32)
  rows, cols = [], []
  for v in range(N):
    for _ in range(6):
      u = (rng.choice(np.nonzero(labels == labels[v])[0])
           if rng.random() < 0.85 else rng.integers(0, N))
      rows.append(v)
      cols.append(int(u))
  feats = np.eye(CLASSES, D, dtype=np.float32)[labels]
  feats += rng.normal(0, 0.3, feats.shape).astype(np.float32)
  ds = (Dataset().init_graph((np.array(rows), np.array(cols)), num_nodes=N,
                             device='cpu')
        .init_node_features(feats, split_ratio=split_ratio, device='cpu')
        .init_node_labels(labels))
  return ds, np.array(rows), np.array(cols)


def _driver(kind, split_ratio=1.0, init=0, hidden=16, chunk=1, opt_cls=None):
  """A fresh driver over a fresh dataset: ``(driver, model, optimizer)``
  (batch 32, shuffled, seed 5, ``max_steps_per_program=chunk``)."""
  ds, rows, cols = _cluster_dataset(split_ratio)
  if kind == 'tree':
    model = TreeSAGE(D, hidden, CLASSES, num_layers=2)
  else:
    model = GraphSAGE(D, hidden, CLASSES if kind != 'link' else 8,
                      num_layers=2)
  model.reset_parameters(torch.Generator().manual_seed(init))
  opt = (opt_cls or (lambda p: torch.optim.Adam(p, lr=1e-2)))(
      model.parameters())
  kw = dict(batch_size=32, shuffle=True, seed=5,
            max_steps_per_program=chunk, device='cpu')
  if kind == 'link':
    fused = FusedLinkEpoch(ds, [4, 3], (rows[:150], cols[:150]), model, opt,
                           **kw)
  else:
    cls = FusedTreeEpoch if kind == 'tree' else FusedEpoch
    fused = cls(ds, [4, 3], np.arange(N), model, opt, **kw)
  return fused, model, opt


def _train_tensors(model, opt):
  out = {f'model.{k}': v.clone() for k, v in model.state_dict().items()}
  for i, p in enumerate(model.parameters()):
    for k, v in opt.state[p].items():
      out[f'opt.{i}.{k}'] = v.clone() if torch.is_tensor(v) else v
  return out


def _assert_same_tensors(a, b):
  assert a.keys() == b.keys()
  for k in a:
    if torch.is_tensor(a[k]):
      assert torch.equal(a[k], b[k]), k
    else:
      assert a[k] == b[k], k


def _assert_same_stats(got, want):
  assert torch.equal(got.losses, want.losses)
  assert (got.correct, got.seeds) == (want.correct, want.seeds)


CASES = [('subgraph', 1.0), ('subgraph', 0.5), ('tree', 1.0), ('tree', 0.5),
         ('link', 1.0)]


@pytest.mark.parametrize('warm', [False, True], ids=['fresh', 'warm'])
@pytest.mark.parametrize('kind,split', CASES,
                         ids=[f'{k}-{"resident" if s == 1 else "tiered"}'
                              for k, s in CASES])
def test_fused_epoch_kill_resume_byte_identical(tmp_path, monkeypatch, kind,
                                                split, warm):
  """The acceptance loop, single card: a chunked epoch, a planned kill at
  the third chunk, a restore in a fresh driver with a fresh model and
  optimizer, the rest of the epoch and the next: losses, counts,
  parameters and optimizer state bitwise the uninterrupted twin's.
  ``warm``: the fresh driver trained an epoch of its own first, so the
  restore overwrites live optimizer state in place."""
  if split < 1.0:
    monkeypatch.setenv('GLT_COLD_CACHE_ROWS', '16')
  ref, rmodel, ropt = _driver(kind, split)
  ref1 = ref.run()
  ref_state1 = _train_tensors(rmodel, ropt)
  ref2 = ref.run()
  ref_state2 = _train_tensors(rmodel, ropt)

  snap_dir = str(tmp_path / 'plane')
  fused, _, _ = _driver(kind, split)
  assert fused.attach_snapshots(SnapshotManager(snap_dir, every=1))
  chaos.install('fused.dispatch:kill:3')         # the 3rd chunk's arrival
  with pytest.raises(chaos.ChaosKilledError):
    fused.run()
  assert chaos.active().exhausted()
  chaos.uninstall()
  assert len(recorder.events('snapshot.save')) == 2, 'two chunks saved'
  del fused                                      # the kill

  resumed, model, opt = _driver(kind, split, init=7)
  if warm:
    resumed.run()
  resumed.attach_snapshots(SnapshotManager(snap_dir))
  prog = resumed.restore_from_snapshot()
  assert int(prog['next_chunk']) == 2 and int(prog['epoch']) == 1
  assert recorder.events('snapshot.restore')
  got1 = resumed.run()
  _assert_same_stats(got1, ref1)
  _assert_same_tensors(_train_tensors(model, opt), ref_state1)
  if kind != 'link':
    assert got1.seeds == N                       # exact unique count
  got2 = resumed.run()                           # the next epoch
  _assert_same_stats(got2, ref2)
  _assert_same_tensors(_train_tensors(model, opt), ref_state2)


def test_fused_epoch_restore_rejects_stale_train_state(tmp_path):
  """A snapshot of another model (or another optimizer) raises
  `CheckpointMismatchError` naming the path, before anything loads."""
  fused, _, _ = _driver('subgraph')
  fused.attach_snapshots(SnapshotManager(str(tmp_path / 'p'), every=1))
  fused.run()
  other, model, _ = _driver('subgraph', hidden=24, init=3)
  before = {k: v.clone() for k, v in model.state_dict().items()}
  other.attach_snapshots(SnapshotManager(str(tmp_path / 'p')))
  with pytest.raises(CheckpointMismatchError) as ei:
    other.restore_from_snapshot()
  assert ei.value.path.startswith("['model']")
  assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
  assert other._epoch_idx == 0                   # the plane did not load
  sgd, _, _ = _driver('subgraph', opt_cls=lambda p: torch.optim.SGD(
      p, lr=1e-2, momentum=0.9))
  sgd.attach_snapshots(SnapshotManager(str(tmp_path / 'p')))
  with pytest.raises(CheckpointMismatchError) as ei:
    sgd.restore_from_snapshot()
  assert ei.value.path == "['optimizer']['kind']"


def test_fused_epoch_resume_rejects_changed_chunk_size(tmp_path):
  """Resuming under another chunk size would mis-stitch the key
  schedule: the mismatch error names the knob."""
  fused, _, _ = _driver('subgraph')
  fused.attach_snapshots(SnapshotManager(str(tmp_path / 'p'), every=1))
  chaos.install('fused.dispatch:kill:3')
  with pytest.raises(chaos.ChaosKilledError):
    fused.run()
  chaos.uninstall()
  resumed, _, _ = _driver('subgraph', chunk=2)
  resumed.attach_snapshots(SnapshotManager(str(tmp_path / 'p')))
  resumed.restore_from_snapshot()
  with pytest.raises(CheckpointMismatchError, match='chunk') as ei:
    resumed.run()
  assert ei.value.path == 'progress.chunk_steps'


def test_attach_and_restore_edges(tmp_path, monkeypatch):
  fused, model, _ = _driver('subgraph')
  with pytest.raises(ValueError, match='attach_snapshots'):
    fused.restore_from_snapshot()
  assert fused.attach_snapshots() is None        # no GLT_SNAPSHOT_DIR
  monkeypatch.setenv('GLT_SNAPSHOT_DIR', str(tmp_path / 'env'))
  monkeypatch.setenv('GLT_SNAPSHOT_EVERY', '2')
  snap = fused.attach_snapshots()
  assert snap is not None and snap.every == 2
  assert fused.restore_from_snapshot() is None   # nothing saved yet
  fused.run()                                    # 3 chunks: saves 1 and 3
  assert [e['next_chunk'] for e in recorder.events('snapshot.save')] == [1, 3]
  fused.evaluate(np.arange(40))                  # evaluation never saves
  assert len(recorder.events('snapshot.save')) == 2


# -- the mesh loaders ------------------------------------------------------

MESH_N = 64
MESH_P = 4


def _mesh_dataset(split_ratio=0.3):
  rows = np.concatenate([np.arange(MESH_N), np.arange(MESH_N)])
  cols = np.concatenate([(np.arange(MESH_N) + 1) % MESH_N,
                         (np.arange(MESH_N) + 2) % MESH_N])
  feats = (np.arange(MESH_N, dtype=np.float32)[:, None]
           * np.ones((1, 4), np.float32))        # feat[v] == v
  labels = (np.arange(MESH_N) % 5).astype(np.int32)
  node_pb = (np.arange(MESH_N) % MESH_P).astype(np.int32)
  return DistDataset.from_full_graph(
      MESH_P, rows, cols, node_feat=feats, node_label=labels,
      num_nodes=MESH_N, node_pb=node_pb, split_ratio=split_ratio,
      device='cpu'), rows, cols


def _mesh_loader(ds, kind='node', seed=9, rows=None, cols=None, **kw):
  kw.setdefault('cold_cache_rows', 4)
  if kind == 'link':
    return DistLinkNeighborLoader(ds, [2, 2], (rows, cols), batch_size=4,
                                  neg_sampling='binary', shuffle=True,
                                  seed=seed, device='cpu', **kw)
  return DistNeighborLoader(ds, [2, 2], np.arange(MESH_N), batch_size=4,
                            shuffle=True, seed=seed, device='cpu', **kw)


def _batch_bytes(b):
  out = (b.node.numpy().tobytes(), b.x.numpy().tobytes(),
         b.y.numpy().tobytes() if b.y is not None else b'',
         b.edge_index.numpy().tobytes())
  ew = b.metadata.get('edge_weight')
  eli = b.metadata.get('edge_label_index')
  return out + (b'' if ew is None else ew.numpy().tobytes(),
                b'' if eli is None else eli.numpy().tobytes())


MESH_CASES = [('node', 1.0, False), ('node', 0.3, False), ('node', 0.3, True),
              ('link', 0.3, True)]


@pytest.mark.parametrize('kind,split,gns', MESH_CASES,
                         ids=['resident', 'tiered', 'tiered-gns',
                              'link-tiered-gns'])
def test_mesh_loader_kill_resume_byte_identical(tmp_path, kind, split, gns):
  """The acceptance loop, mesh loader: consume part of an epoch (on a
  tiered store the cold cache and the dispatch-ahead overlay are live),
  snapshot through the durable store, lose the loader, and finish in a
  fresh one: the pre-kill and resumed batches are the uninterrupted
  twin's epoch byte for byte, and the next epoch is its next."""
  ds, rows, cols = _mesh_dataset(split)
  kw = dict(kind=kind, rows=rows, cols=cols, gns=gns)
  ref = _mesh_loader(ds, **kw)
  epoch1 = [_batch_bytes(b) for b in ref]
  epoch2 = [_batch_bytes(b) for b in ref]
  assert len(epoch1) >= 3

  loader = _mesh_loader(ds, **kw)
  assert loader.sampler.gns == gns
  it = iter(loader)
  got = [_batch_bytes(next(it)) for _ in range(2)]
  snap = SnapshotManager(str(tmp_path / 'plane'), every=1)
  assert snap.save(loader.state_dict(),
                   {'epoch': 0, 'next_chunk': loader._consumed})
  del loader, it                                 # the kill
  payload = SnapshotManager(str(tmp_path / 'plane')).restore_latest()

  resumed = _mesh_loader(ds, **kw)
  resumed.load_state_dict(payload['plane'])
  rest = [_batch_bytes(b) for b in resumed.resume_epoch()]
  assert len(got) + len(rest) == len(epoch1), 'exact batch count'
  assert got + rest == epoch1, 'batches must be byte-identical'
  assert [_batch_bytes(b) for b in resumed] == epoch2
  with pytest.raises(ValueError, match='load_state_dict'):
    resumed.resume_epoch()


def test_mesh_loader_cold_service_fault_then_resume(tmp_path):
  """``feature.cold_service`` fails mid-epoch: the epoch surfaces
  `InjectedFault`, and the snapshot taken at the last delivered batch
  turns it into a finished, byte-identical epoch in a fresh loader."""
  ds, _, _ = _mesh_dataset()
  ref = _mesh_loader(ds)
  epoch1 = [_batch_bytes(b) for b in ref]

  loader = _mesh_loader(ds)
  snap = SnapshotManager(str(tmp_path / 'plane'), every=1)
  it = iter(loader)
  got = []
  chaos.install('feature.cold_service:fail:3:op=dist')
  with pytest.raises(chaos.InjectedFault):
    while True:
      b = next(it)
      got.append(_batch_bytes(b))
      snap.save(loader.state_dict(), {'epoch': 0,
                                      'next_chunk': loader._consumed})
  chaos.uninstall()
  assert len(got) == 2, 'the third overlay dies'
  assert recorder.events('fault.injected')

  payload = SnapshotManager(str(tmp_path / 'plane')).restore_latest()
  resumed = _mesh_loader(ds)
  resumed.load_state_dict(payload['plane'])
  rest = [_batch_bytes(b) for b in resumed.resume_epoch()]
  assert got + rest == epoch1


def test_mesh_loader_snapshot_refuses_prefetch():
  ds, _, _ = _mesh_dataset()
  loader = _mesh_loader(ds, prefetch=2)
  it = iter(loader)
  next(it)
  with pytest.raises(ValueError, match='prefetch'):
    loader.state_dict()
  loader.close()
  loader.state_dict()                            # the worker is gone


def test_adaptive_slack_ladder_state_roundtrip(tmp_path):
  """The `AdaptiveSlack` rung and pin survive a snapshot on disk: a
  fresh loader restored from it resumes at the tuned rung instead of
  the 2.0 default."""
  ds, _, _ = _mesh_dataset(split_ratio=1.0)
  loader = _mesh_loader(ds, exchange_slack='adaptive')
  ctl = loader._adaptive
  assert ctl is not None
  for _ in loader:                 # epoch 1 telemetry
    pass
  for _ in loader:                 # iter() retunes: drop-free tightens
    break
  loader.close()
  assert not ctl._pinned
  tuned = ctl._idx
  assert ctl.sampler.exchange_slack == ctl.slack

  snap = SnapshotManager(str(tmp_path / 'p'), every=1)
  assert snap.save(loader.state_dict(), {'epoch': 0, 'next_chunk': 1})
  state = SnapshotManager(str(tmp_path / 'p')).restore_latest()['plane']
  resumed = _mesh_loader(ds, exchange_slack='adaptive')
  assert resumed._adaptive._idx != tuned or tuned == 4
  resumed.load_state_dict(state)
  assert resumed._adaptive._idx == tuned
  assert resumed.sampler.exchange_slack == ctl.slack
  assert resumed._adaptive._pinned == ctl._pinned
  assert resumed._epoch_count == loader._epoch_count == 2


# -- the fused mesh epochs -------------------------------------------------

FN = 128


def _fused_mesh_driver(kind, init=0):
  rng = np.random.default_rng(0)
  labels = (np.arange(FN) % 4).astype(np.int32)
  rows = np.repeat(np.arange(FN), 5)
  cols = rng.integers(0, FN, rows.shape[0])
  feats = np.eye(4, 8, dtype=np.float32)[labels]
  feats += rng.normal(0, 0.3, feats.shape).astype(np.float32)
  ds = DistDataset.from_full_graph(MESH_P, rows, cols, node_feat=feats,
                                   node_label=labels, num_nodes=FN,
                                   device='cpu')
  if kind == 'tree':
    model = TreeSAGE(8, 16, 4, num_layers=2)
  else:
    model = GraphSAGE(8, 16, 4 if kind == 'node' else 8, num_layers=2)
  model.reset_parameters(torch.Generator().manual_seed(init))
  opt = torch.optim.Adam(model.parameters(), lr=1e-2)
  kw = dict(batch_size=8, seed=0, device='cpu')
  if kind == 'link':
    fused = FusedDistLinkEpoch(ds, [3, 2], (rows[:200], cols[:200]), model,
                               opt, **kw)
  else:
    cls = FusedDistTreeEpoch if kind == 'tree' else FusedDistEpoch
    fused = cls(ds, [3, 2], np.arange(FN), model, opt, **kw)
  return fused, model, opt


@pytest.mark.parametrize('kind', ['node', 'tree', 'link'])
def test_fused_mesh_epoch_kill_resume_byte_identical(tmp_path, kind):
  """A mesh epoch is one chunk: it saves at its end whatever the
  cadence.  A kill at epoch 2's dispatch, a restore in a fresh driver:
  the first `run` returns epoch 1's saved stats without a step, the
  second reruns epoch 2 bitwise the uninterrupted run's."""
  ref, rmodel, ropt = _fused_mesh_driver(kind)
  ref1 = ref.run()
  ref2 = ref.run()
  ref_state2 = _train_tensors(rmodel, ropt)

  fused, _, _ = _fused_mesh_driver(kind)
  fused.attach_snapshots(SnapshotManager(str(tmp_path / 'p'), every=5))
  chaos.install('fused.dispatch:kill:1:epoch=2')
  first = fused.run()
  _assert_same_stats(first, ref1)
  with pytest.raises(chaos.ChaosKilledError):
    fused.run()
  chaos.uninstall()
  assert [e['next_chunk'] for e in recorder.events('snapshot.save')] == [
      len(ref)]

  resumed, model, opt = _fused_mesh_driver(kind, init=5)
  resumed.attach_snapshots(SnapshotManager(str(tmp_path / 'p')))
  assert int(resumed.restore_from_snapshot()['epoch']) == 1
  chaos.install('fused.dispatch:kill:1:epoch=1')   # epoch 1 must not run
  again = resumed.run()
  chaos.uninstall()
  _assert_same_stats(again, ref1)
  got2 = resumed.run()
  _assert_same_stats(got2, ref2)
  _assert_same_tensors(_train_tensors(model, opt), ref_state2)


# -- across the packages ---------------------------------------------------

def test_mesh_loader_resume_byte_equal_to_jax_epoch(tmp_path, monkeypatch):
  """A port mesh loader over P = 2 (tiered, GNS, the victim cache and the
  dispatch-ahead overlay live), fed JAX's keys, killed after 2 batches
  and resumed in a fresh loader: its pre-kill and resumed batches are
  JAX's uninterrupted epoch byte for byte."""
  from test_torch_dist_gns import _graph
  p, n = 2, 240
  rows, cols, feats, labels = _graph(n)
  kw = dict(node_feat=feats, node_label=labels, num_nodes=n, split_ratio=0.3)
  jds = JaxDistDataset.from_full_graph(p, rows, cols, **kw)
  ds = DistDataset.from_full_graph(p, rows, cols, device='cpu', **kw)
  lkw = dict(batch_size=16, shuffle=True, seed=0, cold_cache_rows=24,
             gns=True)
  jl = JaxDistLoader(jds, [3, 2], np.arange(n), mesh=jax_make_mesh(p), **lkw)
  want = [_batch_np(b) for b in jl]
  assert len(want) >= 5

  def port():
    return DistNeighborLoader(ds, [3, 2], np.arange(n),
                              draws=jax_key_draws(0), device='cpu', **lkw)
  loader = port()
  assert loader._cold_pipeline and loader.sampler.gns
  got = [_port_np(b) for b in itertools.islice(iter(loader), 2)]
  state = loader.state_dict()
  assert 'gns_inflight' in state['sampler']
  snap = SnapshotManager(str(tmp_path / 'p'), every=1)
  assert snap.save(state, {'epoch': 0, 'next_chunk': 2})
  del loader
  resumed = port()
  resumed.load_state_dict(
      SnapshotManager(str(tmp_path / 'p')).restore_latest()['plane'])
  got += [_port_np(b) for b in resumed.resume_epoch()]
  assert len(got) == len(want)
  for i, (r, g) in enumerate(zip(want, got)):
    for f in ('node', 'x', 'y', 'edge_index', 'edge_mask', 'edge_weight'):
      assert g[f].dtype == r[f].dtype, (i, f)
      np.testing.assert_array_equal(g[f], r[f], err_msg=f'batch {i} {f}')


@pytest.mark.parametrize('gns', [False, True], ids=['tiered', 'tiered-gns'])
def test_jax_mesh_loader_resume_reference_gap(gns):
  """JAX's own kill/resume of the same P = 2 tiered loader, through its
  own ``state_dict`` (which has no ``gns_inflight`` leaf: only the
  port's sampler keeps it): without GNS JAX's resumed epoch is its
  uninterrupted one byte for byte; with GNS it differs from the first
  re-dispatched batch on, since that batch samples against the cache
  after the consumed batch's admissions.  This gap in the reference is
  why the port keeps the dispatched-ahead batch's cached-set bits
  (`test_mesh_loader_resume_byte_equal_to_jax_epoch` holds the port's
  resume to JAX's uninterrupted epoch)."""
  from test_torch_dist_gns import _graph
  p, n, kill = 2, 240, 2
  rows, cols, feats, labels = _graph(n)
  jds = JaxDistDataset.from_full_graph(
      p, rows, cols, node_feat=feats, node_label=labels, num_nodes=n,
      split_ratio=0.3)

  def jax_loader():
    return JaxDistLoader(jds, [3, 2], np.arange(n), mesh=jax_make_mesh(p),
                         batch_size=16, shuffle=True, seed=0,
                         cold_cache_rows=24, gns=gns)
  want = [_batch_np(b) for b in jax_loader()]
  loader = jax_loader()
  it = iter(loader)
  got = [_batch_np(next(it)) for _ in range(kill)]
  state = loader.state_dict()
  assert 'gns_inflight' not in state['sampler']
  del loader, it
  resumed = jax_loader()
  resumed.load_state_dict(state)
  got += [_batch_np(b) for b in resumed.resume_epoch()]
  assert len(got) == len(want)
  same = [all(np.array_equal(g[f], r[f]) for f in
              ('node', 'x', 'y', 'edge_index', 'edge_mask', 'edge_weight'))
          for r, g in zip(want, got)]
  assert all(same[:kill])
  if gns:
    assert not same[kill], 'JAX resumes a GNS loader byte-identically now'
  else:
    assert all(same)


def test_resumed_fused_epoch_matches_jax(tmp_path):
  """A port `FusedEpoch` fed JAX's keys and the Flax parameters, killed at
  its second chunk and resumed in a fresh driver (another init), gives
  JAX's uninterrupted epoch: losses and parameters within 1e-5, counts
  and Adam's step count equal."""
  jds, ds = _fused_datasets()
  train = np.random.default_rng(1).permutation(300)[:72]   # 5 steps
  tx = optax.adam(3e-3)
  state, apply_fn = _jax_state(jds, tx)
  params0 = _numpy_tree(state.params)            # the run donates state
  jf = JaxFusedEpoch(jds, [3, 2], train, apply_fn, tx, batch_size=16,
                     shuffle=True, seed=0, max_steps_per_program=2)
  state, jstats = jf.run(state)

  def port(params):
    model = GraphSAGE(6, 8, 5, num_layers=2)
    if params is not None:
      model.load_state_dict(graphsage_from_flax(_numpy_tree(params)))
    opt = torch.optim.Adam(model.parameters(), lr=3e-3, eps=1e-8)
    return model, opt, FusedEpoch(
        ds, [3, 2], train, model, opt, batch_size=16, shuffle=True, seed=0,
        max_steps_per_program=2, draws=jax_epoch_draws(0), device='cpu')

  _, _, killed = port(params0)
  killed.attach_snapshots(SnapshotManager(str(tmp_path / 'p'), every=1))
  chaos.install('fused.dispatch:kill:2')
  with pytest.raises(chaos.ChaosKilledError):
    killed.run()
  chaos.uninstall()
  model, opt, resumed = port(None)               # another init
  resumed.attach_snapshots(SnapshotManager(str(tmp_path / 'p')))
  assert int(resumed.restore_from_snapshot()['next_chunk']) == 2
  stats = resumed.run()
  np.testing.assert_allclose(stats.losses.numpy(), np.asarray(jstats.losses),
                             rtol=1e-5, atol=1e-5)
  assert (stats.correct, stats.seeds) == (jstats.correct, jstats.seeds)
  assert {int(s['step']) for s in opt.state.values()} == {int(state.step)}
  ref = graphsage_from_flax(_numpy_tree(state.params))
  for name, p in model.state_dict().items():
    np.testing.assert_allclose(p.numpy(), ref[name].numpy(), rtol=1e-5,
                               atol=1e-5, err_msg=name)
