"""The port's tiered feature store against the JAX package's: `Feature`
at splits 0 / 0.5 / 1 with no victim cache, the ``'auto'`` cache and a
3-row cache that churns, under no / a full / a partial ``id2index``;
bf16 storage; the cache's ``state_dict`` round trip; ``host_get``;
`sort_by_in_degree`; the cold-gather kernel's plain version; the
``feature.cold_service`` chaos seam and the cache counters.

The JAX side runs with ``GLT_PALLAS_COLD`` unset: its compact host path,
byte-identical to its pinned path by contract.  The port runs its CPU
path (the kernels' plain versions).  Tolerances: none — outputs are
byte-equal and every counter equal, over three repeated lookups (each
admits into the cache, so later lookups read what earlier ones left).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphlearn_tpu.data import CSRTopo as JaxTopo
from graphlearn_tpu.data import Feature as JaxFeature
from graphlearn_tpu.data.reorder import sort_by_hotness as jax_hotness
from graphlearn_tpu.data.reorder import sort_by_in_degree as jax_sort
from graphlearn_tpu_torch.data import CSRTopo, Dataset, Feature
from graphlearn_tpu_torch.data.cold_cache import (PinnedColdBuffer,
                                                  emit_cache_events)
from graphlearn_tpu_torch.data.feature import LOOKUP_PARTS
from graphlearn_tpu_torch.data.reorder import sort_by_hotness, sort_by_in_degree
from graphlearn_tpu_torch.ops import cold_gather, cold_gather_plain
from graphlearn_tpu_torch.telemetry.live import live
from graphlearn_tpu_torch.testing import chaos

N, D = 64, 5


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
  for env in ('GLT_PALLAS_COLD', 'GLT_COLD_CACHE_ROWS', 'GLT_PALLAS',
              'GLT_FAULT_PLAN', 'GLT_GNS_SKETCH', 'GLT_GNS_DECAY'):
    monkeypatch.delenv(env, raising=False)


def _feats(seed=0):
  return np.random.default_rng(seed).standard_normal((N, D)).astype(
      np.float32)


def _id_map(kind, seed=3):
  if kind is None:
    return None
  m = np.random.default_rng(seed).permutation(N).astype(np.int64)
  if kind == 'partial':
    m[[2, 7, 40]] = -1
  return m


def _batches(seed=5, b=40, n=3):
  """``n`` lookups of ``b`` ids with repeats and invalid ids, then the
  first again."""
  rng = np.random.default_rng(seed)
  out = []
  for _ in range(n):
    ids = rng.integers(0, N, b).astype(np.int64)
    ids[rng.random(b) < 0.1] = -1
    ids[:3] = ids[3]                         # repeats inside one lookup
    out.append(ids)
  return out + [out[0]]


def _pair(split, cache, id_map, dtype=None):
  feats = _feats()
  ref = JaxFeature(feats, id2index=id_map, split_ratio=split,
                   cold_cache_rows=cache,
                   dtype=None if dtype is None else jnp.bfloat16)
  got = Feature(feats, id2index=id_map, split_ratio=split, device='cpu',
                cold_cache_rows=cache,
                dtype=None if dtype is None else torch.bfloat16)
  return ref, got


def _raw(x) -> bytes:
  """Bytes of a lookup (bf16 compared as its 16-bit patterns)."""
  if isinstance(x, torch.Tensor):
    if x.dtype == torch.bfloat16:
      return x.view(torch.int16).numpy().tobytes()
    return x.numpy().tobytes()
  x = np.asarray(x)
  if x.dtype == jnp.bfloat16:
    return x.view(np.int16).tobytes()
  return x.tobytes()


def _cache_state(f):
  cache = f._cold_cache
  return None if cache is None else cache.stats.snapshot()


@pytest.mark.parametrize('id_kind', [None, 'full', 'partial'])
@pytest.mark.parametrize('cache', [0, 'auto', 3])
@pytest.mark.parametrize('split', [0.0, 0.5, 1.0])
def test_lookups_byte_equal_to_jax(split, cache, id_kind):
  id_map = _id_map(id_kind)
  ref, got = _pair(split, cache, id_map)
  assert got.hot_rows == ref.hot_rows and got._cache_rows == ref._cache_rows
  for i, ids in enumerate(_batches()):
    want = np.asarray(ref.get(ids))
    have = got.get(ids)
    assert have.dtype == torch.float32 and have.shape == want.shape
    assert _raw(have) == _raw(want), f'lookup {i}'
    # a torch id tensor takes the same path
    assert _raw(got.get(torch.from_numpy(ids))) == _raw(want)
    ref.get(ids)                              # keep the two caches in step
    assert got.cold_stats == ref.cold_stats, f'lookup {i}'
    assert _cache_state(got) == _cache_state(ref), f'lookup {i}'
  if 0 < got.hot_rows < N and cache == 3:
    assert got._cold_cache.stats.evicts > 0     # the small cache churned


@pytest.mark.parametrize('split', [0.0, 0.5])
def test_bf16_tiers_byte_equal_to_jax(split):
  ref, got = _pair(split, 4, _id_map('partial'), dtype='bf16')
  assert got.dtype == torch.bfloat16
  for i, ids in enumerate(_batches(seed=9)):
    have = got.get(ids)
    assert have.dtype == torch.bfloat16
    assert _raw(have) == _raw(ref.get(ids)), f'lookup {i}'


def test_cache_state_dict_round_trip_matches_jax():
  """The snapshot carries the JAX package's policy fields and rows; a
  fresh store that loads it serves the next lookups as the original
  does, cache counters included."""
  ref, got = _pair(0.5, 6, None)
  batches = _batches(seed=11, n=4)
  for ids in batches[:2]:
    ref.get(ids)
    got.get(ids)
  js, ts = ref.state_dict(), got.state_dict()
  assert ts['has_cache'] == js['has_cache'] == 1
  jp, tp = js['cache']['policy'], ts['cache']['policy']
  for k in ('ids', 'ref'):
    np.testing.assert_array_equal(tp[k], jp[k])
  assert tp['hand'] == jp['hand']
  np.testing.assert_array_equal(tp['sketch']['scores'],
                                jp['sketch']['scores'])
  assert (ts['cache']['rows'].numpy().tobytes()
          == np.asarray(js['cache']['rows']).tobytes())
  fresh = Feature(_feats(), split_ratio=0.5, device='cpu', cold_cache_rows=6)
  fresh.load_state_dict(ts)
  for ids in batches[2:]:
    a, b = got.get(ids), fresh.get(ids)
    assert _raw(a) == _raw(b) == _raw(ref.get(ids))
  np.testing.assert_array_equal(fresh._cold_cache.policy.ids,
                                got._cold_cache.policy.ids)
  # a store without a cache snapshots nothing and loads nothing
  none = Feature(_feats(), split_ratio=0.5, device='cpu', cold_cache_rows=0)
  assert none.state_dict() == {'has_cache': 0}
  none.load_state_dict(ts)
  small = Feature(_feats(), split_ratio=0.5, device='cpu', cold_cache_rows=2)
  with pytest.raises(ValueError, match='capacity'):
    small.load_state_dict(ts)


@pytest.mark.parametrize('id_kind', [None, 'partial'])
def test_host_get_matches_jax(id_kind):
  ref, got = _pair(0.5, 'auto', _id_map(id_kind))
  ids = np.array([0, 5, -1, N - 1, 2, 7, 40, 5], np.int64)
  want = ref.host_get(ids)
  have = got.host_get(ids)
  assert have.dtype == torch.float32
  assert have.numpy().tobytes() == np.asarray(want).tobytes()
  assert got.host_get().numpy().tobytes() == _feats().tobytes()


def test_sort_by_in_degree_matches_jax():
  rng = np.random.default_rng(2)
  rows = rng.integers(0, N, 400)
  cols = np.minimum(rng.zipf(1.5, 400) - 1, N - 1)   # skewed in-degrees
  feats = _feats()
  jf, jmap = jax_sort(feats, 0.5, JaxTopo((rows, cols), num_nodes=N))
  topo = CSRTopo((rows, cols), num_nodes=N)
  f, m = sort_by_in_degree(feats, 0.5, topo)
  assert m.dtype == jmap.dtype and m.tobytes() == jmap.tobytes()
  assert f.tobytes() == np.asarray(jf).tobytes()
  # a CPU tensor table and a graph whose indices are a tensor (the card's
  # layout) give the same permutation
  ds = Dataset().init_graph((rows, cols), num_nodes=N, device='cpu')
  ft, mt = sort_by_in_degree(torch.from_numpy(feats), 0.5, ds.get_graph())
  assert isinstance(ft, torch.Tensor) and ft.numpy().tobytes() == f.tobytes()
  assert mt.tobytes() == m.tobytes()
  hot = rng.random(N)
  a, am = sort_by_hotness(feats, hot)
  b, bm = jax_hotness(feats, hot)
  assert a.tobytes() == np.asarray(b).tobytes() and am.tobytes() == bm.tobytes()
  # through the Dataset, as the JAX package's `init_node_features` does
  ds.init_node_features(feats, sort_func=sort_by_in_degree, split_ratio=0.5,
                        device='cpu')
  assert ds.node_features._id2index_host.tobytes() == jmap.tobytes()
  ids = np.arange(N)
  assert ds.node_features.get(ids).numpy().tobytes() == feats.tobytes()
  with pytest.raises(ValueError, match='device-resident'):
    Dataset().init_node_features(torch.empty((N, D), device='meta'),
                                 sort_func=sort_by_in_degree, device='cpu')


def test_cold_gather_plain_contract():
  """The cold block is cast once at build and a fill equals
  ``rows[idx].astype(dtype)`` (the JAX `PinnedColdBuffer` contract),
  written only at the miss positions; the wrapper checks its inputs."""
  rows = np.random.default_rng(0).standard_normal((32, 8))
  buf = PinnedColdBuffer(rows, 8, torch.float32, device='cpu')
  assert buf.rows.dtype == torch.float32
  idx = np.array([3, 0, 31], np.int32)
  out = torch.full((5, 8), 7.0)
  pos = torch.tensor([4, 0, 2], dtype=torch.int32)
  before = cold_gather_plain.calls
  buf.gather(out, pos, torch.from_numpy(idx))
  assert cold_gather_plain.calls == before + 1
  np.testing.assert_array_equal(out.numpy()[[4, 0, 2]],
                                rows[idx].astype(np.float32))
  assert (out.numpy()[[1, 3]] == 7.0).all()
  assert 'memory.tier_bytes{tier=pinned_host}' in live.snapshot()
  empty = torch.empty(0, dtype=torch.int32)
  assert cold_gather(out, buf.rows, empty, empty) is out
  with pytest.raises(ValueError, match='dtype'):
    cold_gather(out.double(), buf.rows, pos, pos)
  with pytest.raises(ValueError, match='width'):
    cold_gather(torch.zeros(5, 4), buf.rows, pos, pos)
  with pytest.raises(ValueError, match='int32'):
    cold_gather(out, buf.rows, pos.long(), pos)
  with pytest.raises(ValueError, match=r'\[rows, 8\]'):
    PinnedColdBuffer(rows[:, :4], 8, device='cpu')


def test_device_table_with_a_cold_tier_raises():
  with pytest.raises(ValueError, match='split_ratio == 1.0'):
    Feature(torch.empty((N, D), device='meta'), split_ratio=0.5,
            device='cpu')


def test_cold_service_fault_plan_raises():
  f = Feature(_feats(), split_ratio=0.5, device='cpu')
  hot_only = np.array([0, 1, -1], np.int64)
  cold = np.array([0, N - 1], np.int64)
  chaos.install('feature.cold_service:fail:2')
  try:
    f.get(hot_only)                         # no cold row: the seam is idle
    f.get(cold)                             # first arrival passes
    with pytest.raises(chaos.InjectedFault, match='cold-tier'):
      f.get(cold)
    f.get(cold)                             # the fault fired once
  finally:
    chaos.uninstall()


def test_cache_counters_by_scope():
  snap = live.snapshot()
  key = 'cache.hits_total{scope=serving}'
  emit_cache_events('serving', 3, 2, 1, 0)
  after = live.snapshot()
  assert after[key] - snap.get(key, 0) == 3
  assert (after['cache.misses_total{scope=serving}']
          - snap.get('cache.misses_total{scope=serving}', 0)) == 2
  assert 'cache.evicts_total{scope=serving}' not in after or (
      after['cache.evicts_total{scope=serving}']
      == snap.get('cache.evicts_total{scope=serving}', 0))
  f = Feature(_feats(), split_ratio=0.5, device='cpu', cold_cache_rows=8)
  ids = np.arange(N // 2, N)
  before = live.snapshot().get('cache.misses_total{scope=feature}', 0)
  f.get(ids)
  f.get(ids, scope='feature')
  assert (live.snapshot()['cache.misses_total{scope=feature}'] - before
          == f._cold_cache.stats.misses)
  # the lookups' host seconds by part
  assert tuple(f.lookup_secs) == LOOKUP_PARTS
  assert all(v > 0 for v in f.lookup_secs.values())
