"""The port's checkpoint store and data-plane state against the JAX
package's `utils/checkpoint.py` and batchers.

The contracts of the JAX package's `tests/test_snapshot_resume.py`
(template validation, the RNG round trip, the snapshot cadence, the
absorbed write faults, the skip past a corrupt newest snapshot) hold
with the same assertions; the numpy layout only (the port has no orbax
backend).  Cross-package: `validate_tree` names the same first diverging
path as JAX's on the same trees, packed RNG states and batcher states
load across the packages and give the same next batches, and every
stateful component the port already had round-trips through a snapshot
on disk, where its leaves come back as 0-d numpy arrays.  Everything is
exact: no tolerance.
"""
import numpy as np
import pytest
import torch

from graphlearn_tpu.loader.link_loader import \
    EdgeSeedBatcher as JaxEdgeSeedBatcher
from graphlearn_tpu.loader.node_loader import SeedBatcher as JaxSeedBatcher
from graphlearn_tpu.utils import checkpoint as jax_ckpt
from graphlearn_tpu_torch.data import Feature
from graphlearn_tpu_torch.data.cold_cache import (ClockShardCache,
                                                  DeviceColdCache,
                                                  MeshColdCache)
from graphlearn_tpu_torch.loader.link_loader import EdgeSeedBatcher
from graphlearn_tpu_torch.loader.node_loader import SeedBatcher
from graphlearn_tpu_torch.ops.gns import DecayedSketch
from graphlearn_tpu_torch.telemetry import recorder
from graphlearn_tpu_torch.testing import chaos
from graphlearn_tpu_torch.utils.checkpoint import (CheckpointMismatchError,
                                                   Checkpointer,
                                                   SnapshotManager,
                                                   pack_rng_state,
                                                   restore_rng_state,
                                                   snapshot_dir_from_env,
                                                   snapshot_every_from_env,
                                                   validate_tree)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
  for env in ('GLT_SNAPSHOT_DIR', 'GLT_SNAPSHOT_EVERY', 'GLT_FAULT_PLAN'):
    monkeypatch.delenv(env, raising=False)
  chaos.uninstall()
  recorder.enable()
  recorder.clear()
  yield
  chaos.uninstall()
  recorder.clear()
  recorder.disable()


def _tree(v=0.0):
  return {'w': np.full((3, 2), v, np.float32),
          'opt': {'step': np.int32(4), 'mu': np.arange(3, dtype=np.float64)}}


def _mismatch_cases():
  bad_struct = {'w': np.zeros((3, 2), np.float32),
                'opt': {'step': np.int32(0)}}              # 'mu' missing
  bad_shape = _tree()
  bad_shape['w'] = np.zeros((2, 2), np.float32)
  bad_dtype = _tree()
  bad_dtype['opt']['mu'] = np.arange(3, dtype=np.float32)
  return (('structure', bad_struct, 'structure'),
          ('shape', bad_shape, 'shape'),
          ('dtype', bad_dtype, 'dtype'))


def test_checkpointer_restore_validates_template(tmp_path):
  """A stale checkpoint raises `CheckpointMismatchError` naming the first
  diverging path instead of restoring garbage."""
  ckpt = Checkpointer(tmp_path / 'ck')
  assert ckpt.restore() is None and ckpt.latest_step() is None
  ckpt.save(1, _tree(1.5))
  out = ckpt.restore(template=_tree())           # matching: round trips
  np.testing.assert_array_equal(out['w'], np.full((3, 2), 1.5, np.float32))
  assert int(out['opt']['step']) == 4 and out['opt']['step'].shape == ()
  for name, template, msg in _mismatch_cases():
    with pytest.raises(CheckpointMismatchError, match=msg) as ei:
      ckpt.restore(template=template)
    assert ei.value.path, f'{name}: the diverging path is the point'


def test_checkpointer_keeps_the_newest_steps(tmp_path):
  ckpt = Checkpointer(tmp_path / 'ck', max_to_keep=2)
  for step in (3, 7, 11):
    ckpt.save(step, {'k': np.int64(step)})
  assert ckpt.all_steps() == [7, 11] and ckpt.latest_step() == 11
  assert int(ckpt.restore()['k']) == 11
  assert int(ckpt.restore(step=7)['k']) == 7


def test_trees_round_trip_with_lists_tuples_and_empties(tmp_path):
  tree = {'shards': [{'ids': np.arange(3)}, {'ids': np.arange(2)}],
          'pair': (np.float32(1.5), np.arange(4, dtype=np.int16)),
          'empty': {}, 'none_list': [], 7: np.uint8(3), 'skip': None}
  ckpt = Checkpointer(tmp_path / 'ck')
  ckpt.save(1, tree)
  out = ckpt.restore()
  validate_tree(out, {k: v for k, v in tree.items() if k != 'skip'})
  assert isinstance(out['shards'], list) and isinstance(out['pair'], tuple)
  assert out['empty'] == {} and out['none_list'] == []
  np.testing.assert_array_equal(out['shards'][1]['ids'], np.arange(2))
  assert out['pair'][1].dtype == np.int16 and int(out[7]) == 3


def _divergent_pairs():
  base = {'plane': {'batcher': {'rng': np.zeros(8, np.uint8),
                                'epochs_started': np.int64(1)},
                    'cache': {'shards': [{'ids': np.arange(4)},
                                         {'ids': np.arange(4)}]}},
          'progress': {'losses': np.zeros(3, np.float32)}}

  def edit(fn):
    import copy
    t = copy.deepcopy(base)
    fn(t)
    return t
  return {
      'missing_key': edit(lambda t: t['plane']['batcher'].pop('rng')),
      'extra_key': edit(lambda t: t['progress'].__setitem__(
          'counts', np.zeros((3, 2), np.int64))),
      'shape': edit(lambda t: t['plane']['cache']['shards'][1].__setitem__(
          'ids', np.arange(5))),
      'dtype': edit(lambda t: t['progress'].__setitem__(
          'losses', np.zeros(3, np.float64))),
      'list_length': edit(lambda t: t['plane']['cache']['shards'].pop()),
      'list_vs_tuple': edit(lambda t: t['plane']['cache'].__setitem__(
          'shards', tuple(t['plane']['cache']['shards']))),
  }, base


@pytest.mark.parametrize('case', ['missing_key', 'extra_key', 'shape',
                                  'dtype', 'list_length', 'list_vs_tuple'])
def test_validate_tree_names_the_same_path_as_jax(case):
  """The same restored and template trees give the same first diverging
  path (JAX's ``keystr`` form) in both packages."""
  pairs, template = _divergent_pairs()
  restored = pairs[case]
  with pytest.raises(jax_ckpt.CheckpointMismatchError) as jei:
    jax_ckpt.validate_tree(restored, template)
  with pytest.raises(CheckpointMismatchError) as ei:
    validate_tree(restored, template)
  assert ei.value.path == jei.value.path
  assert ei.value.path
  validate_tree(template, template)
  jax_ckpt.validate_tree(template, template)


def test_validate_tree_names_first_diverging_path():
  good = _tree()
  bad = _tree()
  bad['opt']['mu'] = np.arange(4, dtype=np.float64)
  with pytest.raises(CheckpointMismatchError) as ei:
    validate_tree(bad, good)
  assert 'mu' in ei.value.path


def test_rng_state_pack_roundtrip_and_across_packages():
  rng = np.random.default_rng(11)
  packed = pack_rng_state(rng)
  a = rng.permutation(32)
  fresh = np.random.default_rng(0)
  restore_rng_state(fresh, packed)
  np.testing.assert_array_equal(fresh.permutation(32), a)
  # a state packed by one package restores in the other
  for pack, restore in ((jax_ckpt.pack_rng_state, restore_rng_state),
                        (pack_rng_state, jax_ckpt.restore_rng_state)):
    src = np.random.default_rng(5)
    p = pack(src)
    want = src.permutation(40)
    dst = np.random.default_rng(99)
    restore(dst, p)
    np.testing.assert_array_equal(dst.permutation(40), want)


def test_snapshot_manager_roundtrip_and_cadence(tmp_path, monkeypatch):
  monkeypatch.setenv('GLT_SNAPSHOT_EVERY', '2')
  snap = SnapshotManager(str(tmp_path / 's'))
  assert snap.every == 2
  assert [snap.due() for _ in range(5)] == [True, False, True, False, True]
  ok = snap.save({'cursor': np.int64(3)},
                 {'epoch': 1, 'next_chunk': 2,
                  'losses': np.arange(2, dtype=np.float32)},
                 train=_tree(2.0))
  assert ok
  fresh = SnapshotManager(str(tmp_path / 's'))   # a new process
  payload = fresh.restore_latest()
  assert int(np.asarray(payload['plane']['cursor'])) == 3
  assert int(np.asarray(payload['progress']['next_chunk'])) == 2
  np.testing.assert_array_equal(payload['train']['w'],
                                np.full((3, 2), 2.0, np.float32))
  saves = recorder.events('snapshot.save')
  restores = recorder.events('snapshot.restore')
  assert saves and saves[0]['ok'] and saves[0]['secs'] >= 0
  assert restores and restores[0]['epoch'] == 1
  assert restores[0]['next_chunk'] == 2
  assert SnapshotManager(str(tmp_path / 'empty')).restore_latest() is None


def test_snapshot_env_knobs(tmp_path, monkeypatch):
  assert snapshot_dir_from_env() is None
  with pytest.raises(ValueError, match='GLT_SNAPSHOT_DIR'):
    SnapshotManager()
  monkeypatch.setenv('GLT_SNAPSHOT_DIR', str(tmp_path / 'env'))
  monkeypatch.setenv('GLT_SNAPSHOT_EVERY', 'x')
  assert snapshot_every_from_env() == 1
  monkeypatch.setenv('GLT_SNAPSHOT_EVERY', '0')
  assert snapshot_every_from_env() == 1
  monkeypatch.setenv('GLT_SNAPSHOT_EVERY', '8')
  snap = SnapshotManager()
  assert snap.directory == tmp_path / 'env' and snap.every == 8
  assert SnapshotManager(every=3).every == 3


def test_snapshot_write_faults_keep_previous_durable(tmp_path):
  """`checkpoint.io` ``fail`` and ``truncate`` are absorbed: save()
  returns False, the failure lands in telemetry, and the previous
  published snapshot stays the durable latest."""
  snap = SnapshotManager(str(tmp_path / 's'), every=1, max_to_keep=1)
  assert snap.save({'k': np.int64(1)}, {'epoch': 0, 'next_chunk': 1})
  chaos.install('checkpoint.io:fail:1; checkpoint.io:truncate:2')
  assert not snap.save({'k': np.int64(2)}, {'epoch': 0, 'next_chunk': 2})
  assert not snap.save({'k': np.int64(3)}, {'epoch': 0, 'next_chunk': 3})
  assert chaos.active().exhausted()
  chaos.uninstall()
  payload = SnapshotManager(str(tmp_path / 's')).restore_latest()
  assert int(np.asarray(payload['plane']['k'])) == 1, \
      'a failed write must never shadow the last good snapshot'
  evs = recorder.events('snapshot.save')
  assert [e['ok'] for e in evs] == [True, False, False]
  assert all('error' in e for e in evs[1:])


def test_restore_latest_skips_corrupt_newest(tmp_path):
  snap = SnapshotManager(str(tmp_path / 's'), every=1)
  assert snap.save({'k': np.int64(1)}, {'epoch': 0, 'next_chunk': 1})
  assert snap.save({'k': np.int64(2)}, {'epoch': 0, 'next_chunk': 2})
  steps = sorted((tmp_path / 's').glob('step_*'))
  assert len(steps) == 2
  (steps[-1] / 'leaves.npz').write_bytes(b'not a zipfile')
  payload = SnapshotManager(str(tmp_path / 's')).restore_latest()
  assert int(np.asarray(payload['plane']['k'])) == 1, \
      'corrupt newest must fall back to the older good snapshot'
  evs = recorder.events('snapshot.restore')
  assert any(e.get('ok') is False and 'error' in e for e in evs)
  (steps[0] / 'leaves.npz').write_bytes(b'also broken')
  with pytest.raises(Exception):
    SnapshotManager(str(tmp_path / 's')).restore_latest()


def test_chaos_fused_dispatch_seam_filters_by_epoch():
  chaos.install('fused.dispatch:kill:2:epoch=3')
  for chunk in range(4):
    chaos.fused_dispatch_check(chunk=chunk, epoch=2)   # never matches
  chaos.fused_dispatch_check(chunk=0, epoch=3)
  assert not chaos.active().exhausted()
  with pytest.raises(chaos.ChaosKilledError, match='epoch 3, chunk 5'):
    chaos.fused_dispatch_check(chunk=5, epoch=3)
  assert chaos.active().exhausted()
  chaos.install({'faults': [{'site': 'fused.dispatch', 'action': 'delay',
                             'secs': 0.0}]})
  chaos.fused_dispatch_check(chunk=0, epoch=1)
  assert chaos.active().exhausted()


# -- the batchers' state, across the packages -----------------------------

def _epoch(b):
  return [np.asarray(x) for x in b]


def _same(a, b):
  assert len(a) == len(b)
  for x, y in zip(a, b):
    np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize('direction', ['jax_to_port', 'port_to_jax'])
@pytest.mark.parametrize('mid_epoch', [True, False], ids=['mid', 'boundary'])
def test_seed_batcher_state_loads_across_packages(tmp_path, direction,
                                                  mid_epoch):
  """A batcher's state, saved through the source package's store and
  loaded into the other package's batcher, gives the same batches: the
  interrupted epoch again (``mid_epoch``), then the next one."""
  src_cls, dst_cls = ((JaxSeedBatcher, SeedBatcher)
                      if direction == 'jax_to_port'
                      else (SeedBatcher, JaxSeedBatcher))
  # each package's store writes its own layout; the state's leaves are
  # what the packages share
  store = (jax_ckpt.Checkpointer(tmp_path / 'b', use_orbax=False)
           if direction == 'jax_to_port' else Checkpointer(tmp_path / 'b'))
  src = src_cls(np.arange(50), 8, shuffle=True, seed=3)
  _epoch(src)
  e2 = _epoch(src)                               # the interrupted epoch
  store.save(1, src.state_dict())
  e3 = _epoch(src)
  restored = store.restore()
  dst = dst_cls(np.arange(50), 8, shuffle=True, seed=77)
  dst.load_state_dict(restored, mid_epoch=mid_epoch)
  if mid_epoch:
    assert dst.epochs_started == 1
    _same(_epoch(dst), e2)
  else:
    assert dst.epochs_started == 2
  _same(_epoch(dst), e3)
  assert dst.epochs_started == src.epochs_started


def test_edge_seed_batcher_state_matches_jax():
  rows, cols = np.arange(30), (np.arange(30) * 7) % 30
  labels = np.arange(30) % 3
  jb = JaxEdgeSeedBatcher(rows, cols, labels, 4, shuffle=True, seed=2)
  tb = EdgeSeedBatcher(rows, cols, labels, 4, shuffle=True, seed=9)
  e1 = list(jb)
  tb.load_state_dict(jb.state_dict(), mid_epoch=True)
  for want, got in ((e1, list(tb)), (list(jb), list(tb))):
    assert len(want) == len(got) == len(tb)
    for (jr, jc, jl), (r, c, lab) in zip(want, got):
      np.testing.assert_array_equal(r, jr)
      np.testing.assert_array_equal(c, jc)
      np.testing.assert_array_equal(lab, jl)
  st = tb.state_dict()
  assert set(st) == {'rng', 'epoch_rng', 'epochs_started'}


# -- the state the port already had, through a snapshot on disk ------------

def _disk_round_trip(tmp_path, state):
  snap = SnapshotManager(str(tmp_path / 'rt'), every=1)
  assert snap.save({'s': state}, {'epoch': 0, 'next_chunk': 0})
  return SnapshotManager(str(tmp_path / 'rt')).restore_latest()['plane']['s']


def test_cache_policy_and_sketch_round_trip_on_disk(tmp_path):
  pol = ClockShardCache(6)
  pol.sketch.update(np.array([3, 4, 3, 9]))
  ids, slots, _ = pol.plan_admissions(np.array([3, 4, 9, 11]),
                                      np.array([2, 1, 1, 1]))
  pol.commit(ids, slots)
  pol.lookup(np.array([3, 9]))
  back = ClockShardCache(6)
  back.load_state_dict(_disk_round_trip(tmp_path, pol.state_dict()))
  np.testing.assert_array_equal(back.ids, pol.ids)
  np.testing.assert_array_equal(back.ref, pol.ref)
  assert back.hand == pol.hand
  np.testing.assert_array_equal(back.resident_ids(), pol.resident_ids())
  np.testing.assert_array_equal(back.sketch.scores, pol.sketch.scores)
  # the decay is kept as a float32 leaf
  assert back.sketch.decay == np.float32(pol.sketch.decay)
  sk = DecayedSketch(slots=16, decay=0.5)
  sk.update(np.array([1, 2, 2]))
  sk2 = DecayedSketch(slots=16)
  sk2.load_state_dict(_disk_round_trip(tmp_path, sk.state_dict()))
  np.testing.assert_array_equal(sk2.scores, sk.scores)
  assert sk2.decay == 0.5 and int(np.asarray(
      _disk_round_trip(tmp_path, {'n': 3})['n'])) == 3


def test_feature_and_mesh_cache_round_trip_on_disk(tmp_path, monkeypatch):
  monkeypatch.setenv('GLT_COLD_CACHE_ROWS', '8')
  rng = np.random.default_rng(0)
  table = rng.standard_normal((40, 3)).astype(np.float32)
  feat = Feature(table, split_ratio=0.25, device='cpu')
  feat.get(torch.arange(40))
  feat.get(torch.tensor([30, 31, 32, 33]))
  state = feat.state_dict()
  assert int(state['has_cache']) == 1
  back = Feature(table, split_ratio=0.25, device='cpu')
  back.load_state_dict(_disk_round_trip(tmp_path, state))
  cache, cache2 = feat._cold_cache, back._cold_cache
  np.testing.assert_array_equal(cache2.policy.ids, cache.policy.ids)
  assert torch.equal(cache2.rows, cache.rows)
  ids = torch.tensor([31, 5, 33, 39])
  assert torch.equal(back.get(ids), feat.get(ids))

  dev = DeviceColdCache(4, 3, torch.float32, device='cpu')
  dev.admit(torch.arange(12.).reshape(4, 3), np.array([10, 11, 12, 13]),
            np.ones(4, bool))
  dev2 = DeviceColdCache(4, 3, torch.float32, device='cpu')
  dev2.load_state_dict(_disk_round_trip(tmp_path, dev.state_dict()))
  assert torch.equal(dev2.rows, dev.rows)

  mc = MeshColdCache(3, 2, torch.float32, num_local=2, device='cpu')
  x = torch.arange(16.).reshape(2, 4, 2)
  ids_l = np.array([[5, 6, 7, -1], [8, 9, -1, -1]])
  mc.commit_admissions(x, mc.plan_admissions(ids_l, ids_l >= 0))
  mst = mc.state_dict()
  assert set(mst) == {'shards', 'rows'} and len(mst['shards']) == 2
  mc2 = MeshColdCache(3, 2, torch.float32, num_local=2, device='cpu')
  mc2.load_state_dict(_disk_round_trip(tmp_path, mst))
  assert torch.equal(mc2.rows, mc.rows)
  for a, b in zip(mc2.shards, mc.shards):
    np.testing.assert_array_equal(a.resident_ids(), b.resident_ids())
  with pytest.raises(ValueError, match='shards'):
    MeshColdCache(3, 2, torch.float32, num_local=3,
                  device='cpu').load_state_dict(mst)
