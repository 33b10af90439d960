"""The serving slice as a whole: the port's `ServingEngine` against the
JAX `ServingEngine`, and the port's own coalescing contract.

For the parity tests the port is handed a draws provider that replays
the JAX engine's per-seed keys (``fold_in(key(seed), node)``, then
``fold_in(·, hop)`` and ``split``), so both engines sample the same
trees: ``nodes``/``x`` byte-equal, ``logits`` within ``rtol=atol=1e-5``
(f32 matmuls reduce in another order on XLA:CPU than in torch).
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphlearn_tpu.data import Dataset as JaxDataset
from graphlearn_tpu.models.tree import TreeSAGE as FlaxTreeSAGE
from graphlearn_tpu.serving import ServingEngine as JaxServingEngine
from graphlearn_tpu_torch.data import Dataset
from graphlearn_tpu_torch.models import TreeSAGE, tree_sage_from_flax
from graphlearn_tpu_torch.ops import hash_draws
from graphlearn_tpu_torch.serving import (AdmissionController,
                                          AdmissionRejected, ServingEngine,
                                          ServingFrontend, resolve_buckets)

N, D = 64, 6
FANOUTS = [3, 2]
BUCKETS = (1, 2, 4)
SEED = 7


def _graph_feats():
  rng = np.random.default_rng(0)
  rows = np.repeat(np.arange(N), 4)
  rows = np.concatenate([rows, np.full(20, 5)])   # node 5: beyond window
  cols = rng.integers(0, N, rows.shape[0])
  keep = (rows != 9)                              # node 9: no neighbors
  feats = rng.standard_normal((N, D)).astype(np.float32)
  return rows[keep], cols[keep], feats


def _port_dataset():
  rows, cols, feats = _graph_feats()
  return (Dataset().init_graph((rows, cols), layout='COO', num_nodes=N,
                               device='cpu')
          .init_node_features(feats, device='cpu'))


def _jax_dataset():
  rows, cols, feats = _graph_feats()
  return (JaxDataset().init_graph((rows, cols), layout='COO', num_nodes=N)
          .init_node_features(feats))


def jax_replay_draws(engine_seed):
  """A draws provider that reproduces the JAX engine's threefry draws."""
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


@pytest.fixture(scope='module')
def jax_pair():
  """(JAX model engine, port model engine) with carried-over params."""
  flax_model = FlaxTreeSAGE(hidden_features=8, out_features=5,
                            num_layers=len(FANOUTS))
  jeng = JaxServingEngine(_jax_dataset(), FANOUTS, model=flax_model,
                          seed=SEED, buckets=BUCKETS)
  params = jeng.init_params(jax.random.key(0))
  state = tree_sage_from_flax(jax.tree_util.tree_map(np.asarray, params))
  peng = ServingEngine(_port_dataset(), FANOUTS,
                       model=TreeSAGE(D, 8, 5, len(FANOUTS)), params=state,
                       seed=SEED, buckets=BUCKETS, device='cpu',
                       draws=jax_replay_draws(SEED))
  return jeng, peng


SEEDS = np.array([5, 17, 9], np.int64)    # hub, ordinary, no neighbors


def test_logits_and_nodes_match_jax_engine(jax_pair):
  jeng, peng = jax_pair
  for cap in (4, None):
    ref, got = jeng.infer(SEEDS, cap=cap), peng.infer(SEEDS, cap=cap)
    assert got.nodes.dtype == np.int32
    assert got.nodes.tobytes() == np.asarray(ref.nodes).tobytes()
    np.testing.assert_allclose(got.logits, np.asarray(ref.logits),
                               rtol=1e-5, atol=1e-5)
  ref, got = jeng.offline_reference(SEEDS), peng.offline_reference(SEEDS)
  assert got.nodes.tobytes() == np.asarray(ref.nodes).tobytes()
  np.testing.assert_allclose(got.logits, np.asarray(ref.logits),
                             rtol=1e-5, atol=1e-5)
  assert (got.nodes[2, 1:] == -1).all()     # node 9's tree is empty


def test_modelless_x_byte_equal_to_jax_engine():
  jeng = JaxServingEngine(_jax_dataset(), FANOUTS, seed=SEED,
                          buckets=BUCKETS)
  peng = ServingEngine(_port_dataset(), FANOUTS, seed=SEED,
                       buckets=BUCKETS, device='cpu',
                       draws=jax_replay_draws(SEED))
  for cap in (2, 4):
    seeds = SEEDS[:cap - 1] if cap == 2 else SEEDS
    ref, got = jeng.infer(seeds, cap=cap), peng.infer(seeds, cap=cap)
    assert got.nodes.tobytes() == np.asarray(ref.nodes).tobytes()
    assert got.x.dtype == np.float32
    assert got.x.tobytes() == np.asarray(ref.x).tobytes()
  assert got.x.shape == (3, peng.tree_width, D)


def _tiered_pair(cache_rows, model=False):
  """(JAX engine, port engine) over a tiered table (split 0.5: the hot
  half on the device, the cold half in host memory behind a victim cache
  of ``cache_rows``), with carried-over params when ``model``."""
  from graphlearn_tpu.data import Feature as JaxFeature
  from graphlearn_tpu_torch.data import Feature
  _, _, feats = _graph_feats()
  jds = _jax_dataset()
  jds.node_features = JaxFeature(feats, split_ratio=0.5,
                                 cold_cache_rows=cache_rows)
  pds = _port_dataset()
  pds.node_features = Feature(feats, split_ratio=0.5, device='cpu',
                              cold_cache_rows=cache_rows)
  kw = dict(seed=SEED, buckets=BUCKETS)
  if not model:
    return (JaxServingEngine(jds, FANOUTS, **kw),
            ServingEngine(pds, FANOUTS, device='cpu',
                          draws=jax_replay_draws(SEED), **kw))
  flax_model = FlaxTreeSAGE(hidden_features=8, out_features=5,
                            num_layers=len(FANOUTS))
  jeng = JaxServingEngine(jds, FANOUTS, model=flax_model, **kw)
  params = jeng.init_params(jax.random.key(0))
  state = tree_sage_from_flax(jax.tree_util.tree_map(np.asarray, params))
  peng = ServingEngine(pds, FANOUTS, model=TreeSAGE(D, 8, 5, len(FANOUTS)),
                       params=state, device='cpu',
                       draws=jax_replay_draws(SEED), **kw)
  return jeng, peng


@pytest.mark.parametrize('cache_rows', [0, 4])
def test_tiered_engine_byte_equal_to_jax(cache_rows):
  """Tiered dispatches (dedup, the tiered fill under the 'serving'
  scope, the inverse expand): nodes and x byte-equal to the JAX tiered
  engine over repeated dispatches (the cache admits between them), the
  cache counters equal, and x equal to the fully-hot engine's."""
  jeng, peng = _tiered_pair(cache_rows)
  hot = ServingEngine(_port_dataset(), FANOUTS, seed=SEED, buckets=BUCKETS,
                      device='cpu', draws=jax_replay_draws(SEED))
  assert peng._tiered and not hot._tiered
  for seeds in (SEEDS, np.array([40, 41, 5, 17]), SEEDS, SEEDS[:1]):
    ref, got = jeng.infer(seeds), peng.infer(seeds)
    assert got.nodes.tobytes() == np.asarray(ref.nodes).tobytes()
    assert got.x.tobytes() == np.asarray(ref.x).tobytes()
    assert got.x.tobytes() == hot.infer(seeds).x.tobytes()
    t0, dur = peng.last_cold_fill
    assert dur >= 0 and peng.last_collect[1] >= 0
  jf, pf = jeng._feat, peng._feat
  assert pf.cold_stats == jf.cold_stats
  if cache_rows:
    assert (pf._cold_cache.stats.snapshot()
            == jf._cold_cache.stats.snapshot())
    assert pf._cold_cache.stats.hits > 0


def test_tiered_engine_logits_match_jax():
  jeng, peng = _tiered_pair(4, model=True)
  for cap in (4, None):
    ref, got = jeng.infer(SEEDS, cap=cap), peng.infer(SEEDS, cap=cap)
    assert got.nodes.tobytes() == np.asarray(ref.nodes).tobytes()
    np.testing.assert_allclose(got.logits, np.asarray(ref.logits),
                               rtol=1e-5, atol=1e-5)


# -- the port's own contract, with its hash draws -------------------------
@pytest.fixture(scope='module')
def engine():
  eng = ServingEngine(_port_dataset(), FANOUTS, seed=SEED, buckets=BUCKETS,
                      device='cpu')
  eng.warmup()
  return eng


@pytest.fixture(scope='module')
def model_engine():
  eng = ServingEngine(_port_dataset(), FANOUTS,
                      model=TreeSAGE(D, 8, 5, len(FANOUTS)), seed=SEED,
                      buckets=BUCKETS, device='cpu')
  eng.init_params(torch.Generator().manual_seed(0))
  eng.warmup()
  return eng


def test_coalesced_byte_identical_to_offline_across_buckets(engine):
  seeds = np.array([3, 5, 41, 9], np.int64)
  ref = engine.offline_reference(seeds)
  got = engine.infer(seeds, cap=4)
  assert got.nodes.tobytes() == ref.nodes.tobytes()
  assert got.x.tobytes() == ref.x.tobytes()
  for s, cap in ((seeds[:2], 2), (seeds[:2], 4), (seeds[:1], 4)):
    got = engine.infer(s, cap=cap)
    assert got.nodes.tobytes() == ref.nodes[:len(s)].tobytes()
    assert got.x.tobytes() == ref.x[:len(s)].tobytes()
  # rider independence: a seed's tree ignores who shares the bucket
  a = engine.infer(np.array([41, 3, 12]), cap=4)
  assert a.nodes[1].tobytes() == ref.nodes[0].tobytes()


def test_repeat_determinism_and_seed_sensitivity(engine):
  seeds = np.arange(10, 14)
  a, b = engine.infer(seeds), engine.infer(seeds)
  assert a.nodes.tobytes() == b.nodes.tobytes()
  other = ServingEngine(engine.data, FANOUTS, seed=SEED + 1,
                        buckets=BUCKETS, device='cpu')
  assert other.infer(seeds).nodes.tobytes() != a.nodes.tobytes()


def test_model_logits_across_buckets(model_engine):
  seeds = np.array([1, 5, 30])
  ref = model_engine.offline_reference(seeds)
  got = model_engine.infer(seeds)
  assert got.nodes.tobytes() == ref.nodes.tobytes()
  assert got.logits.shape == (3, 5) and np.isfinite(got.logits).all()
  np.testing.assert_allclose(got.logits, ref.logits, rtol=1e-5, atol=1e-5)


def test_hash_draws_contract():
  seeds = torch.tensor([4, -1, 4, 9], dtype=torch.int32)
  u, g = hash_draws(SEED, seeds, 1, 3, 2, 64)
  assert u.shape == (12, 2) and g.shape == (12, 64)
  assert u.dtype == g.dtype == torch.float32
  assert ((u > 0) & (u < 1)).all() and torch.isfinite(g).all()
  # a seed's block is the same in every slot; -1 hashes as node 0
  assert torch.equal(u[0:3], u[6:9]) and torch.equal(g[0:3], g[6:9])
  u0, _ = hash_draws(SEED, torch.tensor([0], dtype=torch.int32), 1, 3, 2,
                     64)
  assert torch.equal(u[3:6], u0)
  big, _ = hash_draws(0, torch.arange(2000, dtype=torch.int32), 0, 1, 8, 64)
  assert abs(big.mean().item() - 0.5) < 0.01
  assert not torch.equal(u[0:3], u[9:12])


def test_resolve_buckets_and_bucket_for(monkeypatch, engine):
  assert resolve_buckets((8, 2, 2, 4)) == (2, 4, 8)
  monkeypatch.setenv('GLT_SERVING_BUCKETS', '1, 4,16')
  assert resolve_buckets() == (1, 4, 16)
  monkeypatch.setenv('GLT_SERVING_BUCKETS', 'garbage')
  assert resolve_buckets() == (1, 2, 4, 8, 16)
  assert [engine.bucket_for(n) for n in (1, 2, 3, 4)] == [1, 2, 4, 4]
  with pytest.raises(ValueError):
    engine.bucket_for(5)
  assert engine.max_request_seeds() == 4
  assert all(engine.warm.values())


def test_model_without_params_and_wrong_device():
  eng = ServingEngine(_port_dataset(), FANOUTS,
                      model=TreeSAGE(D, 8, 5, 2), device='cpu')
  with pytest.raises(ValueError, match='params'):
    eng.infer([1])
  with pytest.raises(ValueError, match='init_params'):
    ServingEngine(_port_dataset(), FANOUTS, device='cpu').init_params(
        torch.Generator())


def test_frontend_coalesces_and_demuxes(engine):
  fe = ServingFrontend(engine, max_wait_ms=1000.0, auto_start=False)
  futs = [fe.submit([s]) for s in (3, 7, 11)]
  futs.append(fe.submit([20]))
  assert fe.pump_once(block=False) == 4           # one run, cap 4
  ref = engine.offline_reference([3, 7, 11, 20])
  for i, f in enumerate(futs):
    r = f.result(1.0)
    assert r.nodes.tobytes() == ref.nodes[i:i + 1].tobytes()
    assert r.x.tobytes() == ref.x[i:i + 1].tobytes()
  st = fe.stats()
  assert st['dispatches'] == 1 and st['served_requests'] == 4
  assert st['failed'] == 0 and st['admitted'] == 4
  assert fe.pump_once(block=False) == 0


def test_frontend_refuses_out_of_range_and_oversize(engine):
  fe = ServingFrontend(engine, auto_start=False)
  for bad in ([N], [-1], [3, N + 7], []):
    with pytest.raises(ValueError):
      fe.submit(bad)
  with pytest.raises(AdmissionRejected) as ei:
    fe.submit(list(range(5)))
  assert ei.value.reason == 'too_large'


def test_queue_bound_and_shutdown_resolve_typed(engine):
  fe = ServingFrontend(engine, max_queue=2, auto_start=False)
  futs = [fe.submit([1]), fe.submit([2])]
  with pytest.raises(AdmissionRejected) as ei:
    fe.submit([3])
  assert ei.value.reason == 'queue_full' and ei.value.limit == 2
  fe.shutdown()
  for f in futs:
    with pytest.raises(AdmissionRejected) as e2:
      f.result(1.0)
    assert e2.value.reason == 'shutdown'
  assert fe.stats()['shed']['shutdown'] == 2
  with pytest.raises(AdmissionRejected):
    fe.submit([1])


def test_deadline_shed_and_drain_window():
  ac = AdmissionController(max_queue=4, default_deadline_ms=1.0)
  req = ac.submit([1])
  import time
  time.sleep(0.01)
  assert ac.take(4, 0.0, block=False) == []
  with pytest.raises(AdmissionRejected) as ei:
    req.future.result(0)
  assert ei.value.reason == 'deadline'
  ac.set_draining(True)
  with pytest.raises(AdmissionRejected) as ei:
    ac.submit([1])
  assert ei.value.reason == 'draining' and ac.draining()
  ac.set_draining(False)
  ac.submit([1])
  assert ac.stats()['shed']['deadline'] == 1


def test_executor_fault_resolves_every_future(engine, monkeypatch):
  fe = ServingFrontend(engine, max_wait_ms=0.0, auto_start=False)
  futs = [fe.submit([1]), fe.submit([2])]

  def boom(*a, **k):
    raise RuntimeError('device fault')

  monkeypatch.setattr(engine, 'infer', boom)
  assert fe.pump_once(block=False) == 0
  for f in futs:
    with pytest.raises(RuntimeError, match='device fault'):
      f.result(1.0)
  assert fe.stats()['failed'] == 2


def test_threaded_end_to_end(model_engine):
  fe = ServingFrontend(model_engine, max_wait_ms=2.0)
  rng = np.random.default_rng(3)
  reqs = [rng.integers(0, N, rng.integers(1, 5)) for _ in range(24)]
  out = [None] * len(reqs)

  def client(lo):
    for i in range(lo, len(reqs), 2):
      out[i] = fe.infer(reqs[i], timeout=30.0)

  threads = [threading.Thread(target=client, args=(i,)) for i in (0, 1)]
  for t in threads:
    t.start()
  for t in threads:
    t.join()
  fe.shutdown()
  assert fe.stats()['failed'] == 0
  assert fe.stats()['served_requests'] == len(reqs)
  for seeds, res in zip(reqs[:6], out[:6]):
    ref = model_engine.offline_reference(seeds)
    assert res.nodes.tobytes() == ref.nodes.tobytes()
    np.testing.assert_allclose(res.logits, ref.logits, rtol=1e-5,
                               atol=1e-5)
