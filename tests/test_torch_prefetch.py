"""`prefetch=N` in the port's loaders: the JAX package's prefetch tests
(`tests/test_prefetch.py`) on the port's `NeighborLoader`,
`PrefetchIterator` and `DistNeighborLoader`, and a tiered
`NeighborLoader(prefetch=2)` against the JAX loader.

The parity test replays the JAX sampler's keys through the port's
``draws`` provider (``fold_in(key(seed), step)`` -> ``fold_in(., hop)``
-> ``split``).  Tolerances: batches byte-equal.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphlearn_tpu.data import CSRTopo as JaxTopo
from graphlearn_tpu.data import Dataset as JaxDataset
from graphlearn_tpu.data import Feature as JaxFeature
from graphlearn_tpu.data.reorder import sort_by_in_degree as jax_sort
from graphlearn_tpu.loader import NeighborLoader as JaxLoader
from graphlearn_tpu_torch.data import Dataset
from graphlearn_tpu_torch.data.reorder import sort_by_in_degree
from graphlearn_tpu_torch.loader import NeighborLoader, PrefetchIterator
from graphlearn_tpu_torch.parallel import DistDataset, DistNeighborLoader

N = 256


def _graph():
  rng = np.random.default_rng(0)
  rows = np.repeat(np.arange(N), 4)
  cols = rng.integers(0, N, N * 4)
  feats = np.tile(np.arange(N, dtype=np.float32)[:, None], (1, 8))
  return rows, cols, feats


def _dataset(split_ratio):
  rows, cols, feats = _graph()
  return (Dataset()
          .init_graph((rows, cols), layout='COO', num_nodes=N, device='cpu')
          .init_node_features(feats, split_ratio=split_ratio, device='cpu')
          .init_node_labels(np.arange(N) % 4))


def jax_key_draws(seed):
  """A draws provider that replays the JAX `NeighborSampler`'s keys."""
  base = jax.random.key(seed)

  def draws(step, hop, rows, k, w):
    k_rand, k_win = jax.random.split(
        jax.random.fold_in(jax.random.fold_in(base, step), hop))
    u = jax.random.uniform(k_rand, (rows, k))
    g = jax.random.gumbel(k_win, (rows, w), dtype=jnp.float32)
    return torch.from_numpy(np.array(u)), torch.from_numpy(np.array(g))
  return draws


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
  for env in ('GLT_PALLAS_SAMPLE', 'GLT_PALLAS', 'GLT_PALLAS_COLD',
              'GLT_COLD_CACHE_ROWS', 'GLT_COLD_PREFETCH'):
    monkeypatch.delenv(env, raising=False)


@pytest.mark.parametrize('split_ratio', [1.0, 0.5])
def test_prefetch_yields_identical_batches(split_ratio):
  ds = _dataset(split_ratio)
  plain = NeighborLoader(ds, [3, 2], np.arange(N), batch_size=32,
                         shuffle=True, seed=7, device='cpu')
  pre = NeighborLoader(ds, [3, 2], np.arange(N), batch_size=32,
                       shuffle=True, seed=7, prefetch=2, device='cpu')
  got_a = list(plain)
  got_b = list(pre)
  assert len(got_a) == len(got_b) == len(plain)
  for a, b in zip(got_a, got_b):
    for f in ('batch', 'node', 'x', 'y', 'edge_index'):
      assert getattr(a, f).numpy().tobytes() == getattr(b, f).numpy(
      ).tobytes(), f


def test_prefetch_overlaps_producer_with_consumer():
  """With depth 2, producer (d s/item) and consumer (d s/item) pipeline:
  total ~ n*d, not n*2d."""
  d = 0.05
  n = 10

  def slow_producer():
    for i in range(n):
      time.sleep(d)
      yield i

  t0 = time.perf_counter()
  got = []
  for item in PrefetchIterator(slow_producer(), depth=2):
    time.sleep(d)            # consumer work
    got.append(item)
  elapsed = time.perf_counter() - t0
  assert got == list(range(n))
  # serial would be >= n*2*d = 1.0 s; overlapped ~ n*d + d
  assert elapsed < n * 2 * d * 0.8, elapsed


def test_prefetch_propagates_exceptions():
  def boom():
    yield 1
    raise RuntimeError('producer failed')

  it = PrefetchIterator(boom(), depth=2)
  assert next(it) == 1
  with pytest.raises(RuntimeError, match='producer failed'):
    next(it)


def test_abandoned_prefetch_epoch_cannot_steal_next_epoch():
  """Breaking out of a prefetch epoch costs the next epoch no batch,
  and the new epoch closes the abandoned worker."""
  ds = _dataset(1.0)
  loader = NeighborLoader(ds, [3], np.arange(N), batch_size=8,
                          shuffle=True, seed=1, prefetch=2, device='cpu')
  it = iter(loader)
  next(it)                       # abandon mid-epoch
  abandoned_thread = it._thread
  seen = sum(1 for _ in loader)  # fresh epoch
  assert seen == len(loader) == N // 8
  abandoned_thread.join(timeout=10)
  assert not abandoned_thread.is_alive()


def test_prefetch_early_abandonment_stops_worker():
  def endless():
    i = 0
    while True:
      yield i
      i += 1

  it = PrefetchIterator(endless(), depth=2)
  assert next(it) == 0
  thread = it._thread
  it.close()
  thread.join(timeout=5)
  assert not thread.is_alive()


def test_prefetch_workers_under_thread_switch_stress():
  """More workers than cores, a tiny switch interval: every iterator
  yields its whole stream in order, loader epochs abandoned at random
  points cost the next epoch nothing, and every worker exits."""
  import os
  import sys
  old = sys.getswitchinterval()
  sys.setswitchinterval(1e-6)
  try:
    n_iters = 2 * (os.cpu_count() or 1) + 2
    its = [PrefetchIterator(iter(range(i, i + 200)), depth=2)
           for i in range(n_iters)]
    got = [[] for _ in its]
    for _ in range(200):
      for i, it in enumerate(its):
        got[i].append(next(it))
    assert got == [list(range(i, i + 200)) for i in range(n_iters)]
    for it in its:
      assert next(it, None) is None
      it.join(timeout=10)
      assert not it._thread.is_alive()
    ds = _dataset(1.0)
    loader = NeighborLoader(ds, [2], np.arange(64), batch_size=8,
                            prefetch=2, device='cpu')
    rng = np.random.default_rng(0)
    threads = []
    for _ in range(6):
      it = iter(loader)
      for _ in range(int(rng.integers(0, 4))):
        next(it)                           # abandon part-way
      threads.append(it._thread)
      full = [b.batch.tolist() for b in loader]
      assert full == [list(range(k, k + 8)) for k in range(0, 64, 8)]
    loader.close()
    for t in threads:
      t.join(timeout=10)
      assert not t.is_alive()
  finally:
    sys.setswitchinterval(old)


def test_mesh_loader_prefetch_matches_sync():
  """prefetch=2 on the mesh loader yields the synchronous loader's
  batches (same seed stream), over two epochs on one worker each."""
  n = 64
  rows = np.concatenate([np.arange(n), np.arange(n)])
  cols = np.concatenate([(np.arange(n) + 1) % n, (np.arange(n) + 2) % n])
  feats = np.arange(n, dtype=np.float32)[:, None] * np.ones((1, 3),
                                                            np.float32)
  ds = DistDataset.from_full_graph(4, rows, cols, node_feat=feats,
                                   num_nodes=n, split_ratio=0.5,
                                   device='cpu')
  outs = []
  for pf in (0, 2):
    loader = DistNeighborLoader(ds, [2, 2], np.arange(n), batch_size=4,
                                shuffle=True, seed=3, prefetch=pf,
                                device='cpu')
    acc = []
    for _ in range(2):                     # two epochs: a worker each
      for b in loader:
        acc.append((b.node.numpy(), b.x.numpy()))
    outs.append(acc)
  assert len(outs[0]) == len(outs[1]) == 2 * len(loader)
  # the tiered store's cold overlay, timed by part
  assert all(v > 0 for v in loader.sampler.overlay_secs.values())
  for (n0, x0), (n1, x1) in zip(outs[0], outs[1]):
    np.testing.assert_array_equal(n0, n1)
    assert x0.tobytes() == x1.tobytes()


def test_tiered_prefetch_loader_byte_equal_to_jax():
  """A tiered store (split 0.5, sorted by in-degree, a small cache that
  churns) behind `NeighborLoader(prefetch=2)`: every batch byte-equal to
  the JAX loader's, over two epochs."""
  rows, cols, _ = _graph()
  feats = np.random.default_rng(4).standard_normal((N, 8)).astype(
      np.float32)
  labels = (np.arange(N) % 4).astype(np.int32)
  jf, jmap = jax_sort(feats, 0.5, JaxTopo((rows, cols), num_nodes=N))
  jds = (JaxDataset().init_graph((rows, cols), num_nodes=N)
         .init_node_labels(labels))
  jds.node_features = JaxFeature(jf, id2index=jmap, split_ratio=0.5,
                                 cold_cache_rows=16)
  ds = (Dataset().init_graph((rows, cols), num_nodes=N, device='cpu')
        .init_node_features(feats, sort_func=sort_by_in_degree,
                            split_ratio=0.5, device='cpu',
                            cold_cache_rows=16)
        .init_node_labels(labels))
  idx = np.random.default_rng(2).permutation(N)[:100]
  jl = JaxLoader(jds, [3, 2], idx, batch_size=16, shuffle=True, seed=0)
  tl = NeighborLoader(ds, [3, 2], idx, batch_size=16, shuffle=True, seed=0,
                      draws=jax_key_draws(0), device='cpu', prefetch=2)
  n_batches = 0
  for _ in range(2):
    for i, (jb, tb) in enumerate(zip(jl, tl)):
      for f in ('x', 'y', 'edge_index', 'node', 'edge_mask', 'batch'):
        want = np.asarray(getattr(jb, f))
        got = getattr(tb, f).numpy()
        assert got.dtype == want.dtype, (i, f)
        assert got.tobytes() == want.tobytes(), (i, f)
      n_batches += 1
  tl.close()
  assert n_batches == 2 * len(tl) == 14
  stats = ds.node_features._cold_cache.stats.snapshot()
  assert stats == jds.node_features._cold_cache.stats.snapshot()
  assert stats['hits'] and stats['evicts']
