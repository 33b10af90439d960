"""Drain-free hot model swap: the port's engine lifecycle (`set_params`,
`validate_params`, ``params=``) and `hot_swap` against the JAX package's,
and the swap contracts of ``tests/test_fleet.py`` on the port.

Parity tests hand the port the JAX engine's draws (`jax_replay_draws`)
and a Flax candidate converted by `tree_sage_from_flax`: nodes
byte-equal, logits within ``rtol=atol=1e-5`` (f32 matmuls reduce in
another order on XLA:CPU than in torch).
"""
import threading
import time

import jax
import numpy as np
import pytest
import torch

from graphlearn_tpu.models.tree import TreeSAGE as FlaxTreeSAGE
from graphlearn_tpu.serving import ServingEngine as JaxServingEngine
from graphlearn_tpu.serving import ServingFrontend as JaxServingFrontend
from graphlearn_tpu.serving import swap as jax_swap
from graphlearn_tpu_torch.models import TreeSAGE, tree_sage_from_flax
from graphlearn_tpu_torch.serving import (AdmissionRejected, ServingEngine,
                                          ServingFrontend, SwapAbortedError,
                                          SwapParityError,
                                          SwapValidationError, hot_swap)
from graphlearn_tpu_torch.telemetry import recorder
from test_torch_serving import (BUCKETS, D, FANOUTS, SEED, SEEDS,
                                _jax_dataset, _port_dataset,
                                jax_replay_draws)

HIDDEN, CLASSES = 8, 5


@pytest.fixture(autouse=True)
def _recording():
  recorder.enable()
  recorder.clear()
  yield
  recorder.clear()
  recorder.disable()


def _flax_model(hidden=HIDDEN):
  return FlaxTreeSAGE(hidden_features=hidden, out_features=CLASSES,
                      num_layers=len(FANOUTS))


def _flax_params(key, hidden=HIDDEN):
  widths = [1, FANOUTS[0], FANOUTS[0] * FANOUTS[1]]
  return jax.tree_util.tree_map(np.asarray, _flax_model(hidden).init(
      jax.random.key(key), [np.zeros((w, D), np.float32) for w in widths],
      [np.ones((w,), bool) for w in widths]))


def _engines():
  """(JAX engine, port engine) with the same installed params (key 0)."""
  jeng = JaxServingEngine(_jax_dataset(), FANOUTS, model=_flax_model(),
                          seed=SEED, buckets=BUCKETS)
  params = _flax_params(0)
  jeng.params = params
  peng = ServingEngine(_port_dataset(), FANOUTS,
                       model=TreeSAGE(D, HIDDEN, CLASSES, len(FANOUTS)),
                       params=tree_sage_from_flax(params), seed=SEED,
                       buckets=BUCKETS, device='cpu',
                       draws=jax_replay_draws(SEED))
  return jeng, peng


def _same(got, ref):
  assert got.nodes.tobytes() == np.asarray(ref.nodes).tobytes()
  np.testing.assert_allclose(got.logits, np.asarray(ref.logits),
                             rtol=1e-5, atol=1e-5)


def _poisoned(params):
  """A candidate with a NaN in the last layer's bias: every logit of
  class 0 is NaN, so the parity probe's divergence is not finite."""
  bad = jax.tree_util.tree_map(np.array, params)
  bad['params'][f'layer{len(FANOUTS) - 1}_self']['bias'][0] = np.nan
  return bad


# -- the engine lifecycle against JAX -----------------------------------------
def test_set_params_matches_jax():
  jeng, peng = _engines()
  cand = _flax_params(99)
  assert jeng.set_params(cand) == peng.set_params(
      tree_sage_from_flax(cand)) == 1
  for cap in (4, None):
    _same(peng.infer(SEEDS, cap=cap), jeng.infer(SEEDS, cap=cap))
  _same(peng.offline_reference(SEEDS), jeng.offline_reference(SEEDS))
  cand2 = _flax_params(5)
  assert jeng.set_params(cand2, version=7) == peng.set_params(
      tree_sage_from_flax(cand2), version=7) == 7
  assert peng.model_version == jeng.model_version == 7
  _same(peng.infer(SEEDS), jeng.infer(SEEDS))
  assert peng.compile_status()['model_version'] == 7


def test_candidate_params_run_without_installing():
  jeng, peng = _engines()
  before = peng.infer(SEEDS, cap=4)
  cand = _flax_params(99)
  got = peng.infer(SEEDS, cap=4, params=tree_sage_from_flax(cand))
  _same(got, jeng.infer(SEEDS, cap=4, params=cand))
  _same(peng.offline_reference(SEEDS, params=tree_sage_from_flax(cand)),
        jeng.offline_reference(SEEDS, params=cand))
  assert not np.allclose(got.logits, before.logits)
  after = peng.infer(SEEDS, cap=4)
  assert after.logits.tobytes() == before.logits.tobytes()
  assert peng.model_version == 0


def _drop_bias(p):
  del p['params']['layer0_self']['bias']
  return p


def _add_leaf(p):
  p['params']['extra'] = {'kernel': np.zeros((D, 3), np.float32)}
  return p


def _half(p):
  leaf = p['params']['layer0_self']
  leaf['kernel'] = leaf['kernel'].astype(np.float16)
  return p


@pytest.mark.parametrize('case', ['width', 'missing', 'extra', 'dtype'])
def test_validate_params_refuses_what_jax_refuses(case):
  jeng, peng = _engines()
  if case == 'width':
    cand = _flax_params(1, hidden=16)
  else:
    cand = {'width': None, 'missing': _drop_bias, 'extra': _add_leaf,
            'dtype': _half}[case](jax.tree_util.tree_map(
                np.array, _flax_params(1)))
  state = tree_sage_from_flax(cand)
  if case == 'dtype':
    state['layer0_self.weight'] = state['layer0_self.weight'].half()
  with pytest.raises(ValueError):
    jeng.validate_params(cand)
  with pytest.raises(ValueError):
    peng.validate_params(state)
  with pytest.raises(ValueError):
    peng.set_params(state)
  assert peng.model_version == 0
  jeng.validate_params(_flax_params(2))           # both accept a
  peng.validate_params(tree_sage_from_flax(_flax_params(2)))   # conforming one


def test_hot_swap_matches_jax_frontend(request):
  """The same swap script on a port frontend and a JAX frontend: the
  same version sequence, the same answers after each step, the same
  error class on the validation, parity and abort paths."""
  jeng, peng = _engines()
  jfe = JaxServingFrontend(jeng, max_wait_ms=1.0,
                           default_deadline_ms=30000.0)
  pfe = ServingFrontend(peng, max_wait_ms=1.0, default_deadline_ms=30000.0)
  request.addfinalizer(jfe.shutdown)
  request.addfinalizer(pfe.shutdown)
  cands = [_flax_params(99), _flax_params(5)]
  versions = {'jax': [], 'port': []}

  def step(which, fn_j, fn_p):
    outs = []
    for name, fe, fn in (('jax', jfe, fn_j), ('port', pfe, fn_p)):
      try:
        fn(fe)
        outs.append('ok')
      except Exception as e:        # noqa: BLE001 — the class is compared
        outs.append(type(e).__name__)
      versions[name].append(fe.engine.model_version)
    assert outs[0] == outs[1], (which, outs)
    _same(pfe.infer(SEEDS), jfe.infer(SEEDS))
    assert not pfe.admission.draining() and not jfe.admission.draining()
    return outs[0]

  assert step('commit', lambda fe: jax_swap.hot_swap(fe, cands[0]),
              lambda fe: hot_swap(fe, tree_sage_from_flax(cands[0]))) == 'ok'
  assert step('commit v7',
              lambda fe: jax_swap.hot_swap(fe, cands[1], version=7),
              lambda fe: hot_swap(fe, tree_sage_from_flax(cands[1]),
                                  version=7)) == 'ok'
  wide = _flax_params(3, hidden=16)
  assert step('validation', lambda fe: jax_swap.hot_swap(fe, wide),
              lambda fe: hot_swap(fe, tree_sage_from_flax(wide))
              ) == 'SwapValidationError'
  bad = _poisoned(_flax_params(4))
  assert step('parity', lambda fe: jax_swap.hot_swap(fe, bad),
              lambda fe: hot_swap(fe, tree_sage_from_flax(bad))
              ) == 'SwapParityError'

  def wedged(swap, cand):
    def run(fe):
      assert fe._dispatch_gate.acquire(timeout=5.0)
      try:
        swap(fe, cand, gate_timeout_s=0.1)
      finally:
        fe._dispatch_gate.release()
    return run

  assert step('abort', wedged(jax_swap.hot_swap, cands[0]),
              wedged(hot_swap, tree_sage_from_flax(cands[0]))
              ) == 'SwapAbortedError'
  assert versions['jax'] == versions['port'] == [1, 7, 7, 7, 7]


# -- the swap contracts on the port (tests/test_fleet.py) ---------------------
def _frontend(model=True, auto=True, **kw):
  kw.setdefault('max_wait_ms', 1.0)
  kw.setdefault('default_deadline_ms', 30000.0)
  m = TreeSAGE(D, HIDDEN, CLASSES, len(FANOUTS)) if model else None
  eng = ServingEngine(_port_dataset(), FANOUTS, model=m, seed=SEED,
                      buckets=BUCKETS, device='cpu')
  if model:
    eng.init_params(torch.Generator().manual_seed(0))
  return ServingFrontend(eng, auto_start=auto, **kw)


def _candidate(seed, hidden=HIDDEN):
  model = TreeSAGE(D, hidden, CLASSES, len(FANOUTS))
  model.reset_parameters(torch.Generator().manual_seed(seed))
  return model.state_dict()


def test_hot_swap_commits_new_version_zero_drops(request):
  fe = _frontend()
  request.addfinalizer(fe.shutdown)
  eng = fe.engine
  r_before = fe.infer([3])
  cand = _candidate(99)
  out = fe.swap_model(cand, version=7)
  assert out['version'] == 7 and eng.model_version == 7
  assert out['drained_ms'] >= 0 and out['parity_max_err'] <= 1e-4
  assert not fe.admission.draining()
  r_after = fe.infer([3])
  np.testing.assert_array_equal(r_before.nodes, r_after.nodes)
  assert not np.array_equal(r_before.logits, r_after.logits)
  ref = eng.offline_reference([3], params=cand)
  np.testing.assert_allclose(r_after.logits, ref.logits, atol=1e-5)
  ev = [e for e in recorder.events('serving.swap') if e.get('ok')]
  assert ev and ev[-1]['version'] == 7
  assert fe.stats()['model_version'] == 7


def test_hot_swap_parity_failure_rolls_back_typed(request):
  fe = _frontend()
  request.addfinalizer(fe.shutdown)
  eng = fe.engine
  r_before = fe.infer([5])
  cand = _candidate(99)
  cand['layer1_self.bias'][0] = float('nan')
  with pytest.raises(SwapParityError) as ei:
    fe.swap_model(cand, probe_seeds=[0, 9, 17, 25])
  assert not np.isfinite(ei.value.max_err)
  assert eng.model_version == 0
  assert not fe.admission.draining()
  r_after = fe.infer([5])
  assert r_after.logits.tobytes() == r_before.logits.tobytes()
  ev = [e for e in recorder.events('serving.swap') if e.get('rolled_back')]
  assert len(ev) == 1 and not ev[0]['ok']
  assert fe.stats()['shed']['shutdown'] == 0      # nothing flushed


def test_swap_validation_refuses_bad_tree_before_drain(request):
  fe = _frontend()
  request.addfinalizer(fe.shutdown)
  with pytest.raises(SwapValidationError):
    fe.swap_model(_candidate(0, hidden=16))
  assert not fe.admission.draining()
  assert fe.stats()['shed']['draining'] == 0      # the door never drained
  assert not recorder.events('serving.swap')


def test_swap_abort_when_executor_never_quiesces(request):
  fe = _frontend()
  request.addfinalizer(fe.shutdown)
  assert fe._dispatch_gate.acquire(timeout=5.0)
  try:
    with pytest.raises(SwapAbortedError):
      fe.swap_model(_candidate(99), gate_timeout_s=0.1)
  finally:
    fe._dispatch_gate.release()
  assert not fe.admission.draining()
  assert fe.engine.model_version == 0
  ev = [e for e in recorder.events('serving.swap') if not e.get('ok')]
  assert len(ev) == 1 and not ev[0]['rolled_back']
  fe.infer([3])


def test_swap_needs_model(request):
  fe = _frontend(model=False)
  request.addfinalizer(fe.shutdown)
  with pytest.raises(SwapValidationError):
    hot_swap(fe, {'w': torch.ones(3)})


def test_draining_rejection_carries_retry_after(request):
  fe = _frontend(model=False)
  request.addfinalizer(fe.shutdown)
  fe.admission.set_draining(True)
  with pytest.raises(AdmissionRejected) as ei:
    fe.submit([1])
  assert ei.value.reason == 'draining'
  assert ei.value.retry_after_ms and ei.value.retry_after_ms > 0
  fe.admission.set_draining(False)
  fe.infer([1])


def test_overlapping_drain_windows_refcounted():
  fe = _frontend(model=False, auto=False)
  try:
    fe.admission.set_draining(True)
    fe.admission.set_draining(True)
    fe.admission.set_draining(False)
    assert fe.admission.draining()
    with pytest.raises(AdmissionRejected):
      fe.submit([1])
    fe.admission.set_draining(False)
    assert not fe.admission.draining()
    fe.submit([1])
  finally:
    fe.shutdown()


def test_draining_sheds_do_not_burn_slo_but_real_sheds_do(monkeypatch):
  monkeypatch.setenv('GLT_SERVING_SLO_P99_MS', '50')
  fe = _frontend(model=False, auto=False, max_queue=4,
                 default_deadline_ms=50.0)
  try:
    win = fe.slo.windows[0]
    fe.admission.set_draining(True)
    for _ in range(5):
      with pytest.raises(AdmissionRejected):
        fe.submit([1])
    assert fe.slo.window_stats(win)['count'] == 0
    assert fe.slo.window_stats(win)['burn_rate'] == 0.0
    assert fe.admission.stats()['shed']['draining'] == 5
    h = fe._health()
    assert h['healthy'] and h['draining']
    fe.admission.set_draining(False)
    for _ in range(4):
      fe.submit([1])
    with pytest.raises(AdmissionRejected):
      fe.submit([1])                           # queue_full at 4/4
    st = fe.slo.window_stats(win)
    assert st['count'] == 1 and st['violations'] == 1
    assert st['burn_rate'] > 1.0
    time.sleep(0.06)
    fe.pump_once(block=False)                  # deadline sheds burn too
    assert fe.slo.window_stats(win)['violations'] >= 2
  finally:
    fe.shutdown()


def test_heartbeat_block_and_health(request):
  fe = _frontend()
  request.addfinalizer(fe.shutdown)
  fe.infer([1, 2])
  st = fe.stats()
  for key in ('queue_depth', 'in_flight', 'draining', 'closed',
              'compile_status', 'model_version', 'headroom_qps', 'slo'):
    assert key in st, key
  assert st['compile_status']['compiles'] == 0    # the CPU builds nothing
  assert st['slo']['windows'][0]['count'] == 1
  assert fe.quiesced()
  assert fe._health()['healthy'] and fe._health()['executor_alive']
  fe.shutdown()
  assert not fe._health()['healthy']


def test_hot_swap_under_live_traffic_drops_nothing(request):
  """4 clients keep submitting while the swap commits: every request
  resolves ok (drain sheds resubmitted after their retry hint), each
  answer equals the reference under the old or the new params, and
  every request submitted after the swap returned is the new params'."""
  fe = _frontend(max_wait_ms=2.0)
  request.addfinalizer(fe.shutdown)
  eng = fe.engine
  old = {k: v.clone() for k, v in eng.model.state_dict().items()}
  new = _candidate(1)
  rng = np.random.default_rng(0)
  reqs = [rng.integers(0, 64, int(rng.integers(1, 5))) for _ in range(96)]
  results, submitted_at = [None] * len(reqs), [0.0] * len(reqs)
  errors, retries = [], [0]
  swapped = threading.Event()

  def client(lo):
    for i in range(lo, len(reqs), 4):
      while True:
        submitted_at[i] = time.monotonic()
        try:
          results[i] = fe.submit(reqs[i]).result(30.0)
          break
        except AdmissionRejected as e:
          if e.reason != 'draining':
            errors.append(e)
            break
          retries[0] += 1
          time.sleep(e.retry_after_ms / 1e3)
        except Exception as e:      # noqa: BLE001 — counted, then fatal
          errors.append(e)
          break
      if i == len(reqs) // 3:
        swapped.wait(30.0)

  threads = [threading.Thread(target=client, args=(c,)) for c in range(4)]
  for t in threads:
    t.start()
  while sum(r is not None for r in results) < len(reqs) // 3:
    time.sleep(0.001)
  out = fe.swap_model(new)
  t_swapped = time.monotonic()
  swapped.set()
  for t in threads:
    t.join(60.0)
    assert not t.is_alive()
  assert not errors and all(r is not None for r in results)
  assert out['version'] == eng.model_version == 1
  for i, res in enumerate(results):
    refs = [eng.infer(reqs[i], params=p) for p in (old, new)]
    for ref in refs:
      assert res.nodes.tobytes() == ref.nodes.tobytes()
    close = [np.allclose(res.logits, ref.logits, rtol=1e-5, atol=1e-5)
             for ref in refs]
    assert any(close), i
    if submitted_at[i] > t_swapped:
      assert close[1], i
