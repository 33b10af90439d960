"""The fleet router: the port's `FleetRouter` against the JAX package's,
and the router contracts of ``tests/test_fleet.py`` on the port.

Parity: one scripted heartbeat sequence drives a port router and a JAX
router in lockstep — the state maps after every pass and the final
counters must be equal, through overload, draining, a closed replica,
three flaps into quarantine and its backoff.  A 3-replica port fleet
(the JAX engine's draws replayed) and a JAX fleet, each with a chaos
kill of r0 while it holds queued requests, answer the same requests:
every one resolves and the port's ``nodes``/``x`` are byte-equal to the
JAX fleet's.

Replicas built with ``auto=False`` never pump, so their queued requests
sit like in-flight traffic on a wedged process.
"""
import time

import numpy as np
import pytest

from graphlearn_tpu.serving import FleetRouter as JaxFleetRouter
from graphlearn_tpu.serving import LocalReplica as JaxLocalReplica
from graphlearn_tpu.serving import ServingEngine as JaxServingEngine
from graphlearn_tpu.serving import ServingFrontend as JaxServingFrontend
from graphlearn_tpu.testing import chaos as jax_chaos
from graphlearn_tpu_torch.distributed.resilience import FailoverExhausted
from graphlearn_tpu_torch.serving import (AdmissionRejected, FleetRouter,
                                          LocalReplica, RemoteReplica,
                                          ServingEngine, ServingFrontend)
from graphlearn_tpu_torch.telemetry import recorder
from graphlearn_tpu_torch.telemetry.live import live
from graphlearn_tpu_torch.testing import chaos
from test_torch_serving import (BUCKETS, FANOUTS, N, SEED, _jax_dataset,
                                _port_dataset, jax_replay_draws)


@pytest.fixture(autouse=True)
def _clean():
  chaos.uninstall()
  jax_chaos.uninstall()
  recorder.enable()
  recorder.clear()
  yield
  chaos.uninstall()
  jax_chaos.uninstall()
  recorder.clear()
  recorder.disable()


def _frontend(auto=True, draws=None, **kw):
  kw.setdefault('max_wait_ms', 1.0)
  kw.setdefault('default_deadline_ms', 30000.0)
  eng = ServingEngine(_port_dataset(), FANOUTS, seed=SEED, buckets=BUCKETS,
                      device='cpu', draws=draws)
  return ServingFrontend(eng, auto_start=auto, **kw)


def _fleet(n=3, auto=(), **router_kw):
  """n local replicas r0..r{n-1}; indices in ``auto`` run their
  executor, the rest stay manual (queued requests sit)."""
  router_kw.setdefault('auto_start', False)
  router_kw.setdefault('dead_after', 2)
  reps = [LocalReplica(f'r{i}', _frontend(auto=i in auto))
          for i in range(n)]
  return FleetRouter(reps, **router_kw), reps


def _drain_all(reps, futs, timeout=20.0):
  """Pump every live replica until the given futures resolve."""
  deadline = time.monotonic() + timeout
  out = []
  for f in futs:
    while not f.done():
      for r in reps:
        if not r._dead:
          r.frontend.pump_once(block=False)
      if time.monotonic() > deadline:
        raise TimeoutError('fleet futures stuck')
    out.append(f.result(1.0))
  return out


# -- parity with the JAX router -----------------------------------------------
class ScriptedReplica:
  """A replica handle whose heartbeats follow a script: ``None`` is a
  miss, ``'slow'`` a healthy block after a 50 ms stall, a dict a
  serving block."""

  def __init__(self, name, script):
    self.name = name
    self.script = list(script)

  def heartbeat(self):
    hb = self.script.pop(0)
    if hb is None:
      return None
    if hb == 'slow':
      time.sleep(0.05)
      hb = {}
    block = {'queue_depth': 0, 'max_queue': 256, 'draining': False,
             'closed': False}
    block.update(hb)
    return {'serving': block}

  def submit(self, seeds, deadline_ms=None, trace=None):
    raise AssertionError('scripted replicas take no traffic')

  def close(self):
    pass


OK, MISS, SLOW = {}, None, 'slow'
DEEP = {'queue_depth': 230}
DRAIN = {'draining': True}
CLOSED = {'closed': True}
#: (pause before the pass in seconds, {replica: heartbeat}) per pass
SCRIPT = (
    [(0, {'r0': OK, 'r1': OK, 'r2': OK}),
     (0, {'r0': MISS, 'r1': DEEP, 'r2': CLOSED}),
     (0, {'r0': MISS, 'r1': SLOW, 'r2': CLOSED}),        # r0, r2 dead
     (0, {'r0': OK, 'r1': DRAIN, 'r2': OK}),             # flap 1, readmit
     (0, {'r0': MISS, 'r1': DRAIN, 'r2': OK}),
     (0, {'r0': MISS, 'r1': OK, 'r2': MISS}),
     (0, {'r0': OK, 'r1': OK, 'r2': OK}),                # flap 2
     (0, {'r0': MISS, 'r1': OK, 'r2': OK}),
     (0, {'r0': MISS, 'r1': OK, 'r2': OK}),
     (0, {'r0': OK, 'r1': OK, 'r2': OK}),                # flap 3: quarantine
     (0, {'r0': OK, 'r1': OK, 'r2': OK}),                # backoff holds
     (0.25, {'r0': OK, 'r1': OK, 'r2': OK}),             # readmitted
     (0, {'r0': MISS, 'r1': OK, 'r2': OK}),
     (0, {'r0': MISS, 'r1': OK, 'r2': OK}),
     (0, {'r0': OK, 'r1': OK, 'r2': OK}),                # re-quarantined
     (0.25, {'r0': OK, 'r1': OK, 'r2': OK}),             # 0.4 s backoff
     (0.25, {'r0': OK, 'r1': OK, 'r2': OK})])            # readmitted


def test_check_replicas_state_sequence_matches_jax():
  kw = dict(heartbeat_ms=50.0, slow_ms=30.0, dead_after=2,
            flap_window_s=60.0, quarantine_backoff_s=0.2,
            auto_start=False)
  names = ('r0', 'r1', 'r2')
  scripts = {n: [hb[n] for _, hb in SCRIPT] for n in names}
  port = FleetRouter([ScriptedReplica(n, scripts[n]) for n in names], **kw)
  ref = JaxFleetRouter([ScriptedReplica(n, scripts[n]) for n in names],
                       **kw)
  try:
    seq_p, seq_j = [], []
    for pause, _ in SCRIPT:
      time.sleep(pause)
      seq_p.append(port.check_replicas())
      seq_j.append(ref.check_replicas())
    assert seq_p == seq_j
    assert [s['r0'] for s in seq_p].count('quarantined') == 4
    assert {s['r1'] for s in seq_p} == {'healthy', 'overloaded',
                                        'draining'}
    sp, sj = port.stats(), ref.stats()
    for key in ('evictions', 'quarantined', 'redriven', 'submitted'):
      assert sp[key] == sj[key], key
    assert sp['quarantined'] == 2
    assert ({n: r['misses'] for n, r in sp['replicas'].items()}
            == {n: r['misses'] for n, r in sj['replicas'].items()})
  finally:
    port.close()
    ref.close()


def _jax_fleet(n=3, auto=(1, 2)):
  reps = []
  for i in range(n):
    eng = JaxServingEngine(_jax_dataset(), FANOUTS, seed=SEED,
                           buckets=BUCKETS)
    fe = JaxServingFrontend(eng, auto_start=i in auto, warmup=True,
                            max_wait_ms=1.0, default_deadline_ms=30000.0)
    reps.append(JaxLocalReplica(f'r{i}', fe))
  return JaxFleetRouter(reps, auto_start=False, dead_after=2), reps


def test_chaos_killed_fleet_answers_like_jax_fleet(request):
  """r0 never pumps, so its share of 12 requests sits queued; a chaos
  kill on its heartbeat seam evicts it and its stranded requests are
  redriven exactly once.  Every request resolves, and the answers equal
  the JAX fleet's under the same plan, byte for byte."""
  draws = jax_replay_draws(SEED)
  reps = [LocalReplica(f'r{i}', _frontend(auto=i in (1, 2), draws=draws))
          for i in range(3)]
  port = FleetRouter(reps, auto_start=False, dead_after=2)
  ref, jreps = _jax_fleet()
  request.addfinalizer(lambda: port.close(close_replicas=True))
  request.addfinalizer(lambda: ref.close(close_replicas=True))
  rng = np.random.default_rng(3)
  reqs = [rng.integers(0, N, int(rng.integers(1, 4))) for _ in range(12)]
  plan = {'faults': [{'site': 'serving.replica', 'action': 'kill',
                      'op': 'heartbeat', 'replica': 'r0', 'nth': 1}]}
  answers = {}
  for name, router, rs, ch in (('port', port, reps, chaos),
                               ('jax', ref, jreps, jax_chaos)):
    futs = [router.submit(s) for s in reqs]
    stranded = rs[0].frontend.admission.depth()
    assert stranded > 0
    ch.install(plan)
    router.check_replicas()                # the kill fires: miss 1
    assert router.check_replicas()['r0'] == 'dead'
    assert router.stats()['redriven'] == stranded
    answers[name] = _drain_all(rs, futs)
    st = router.stats()
    assert st['resolved'] == {'ok': 12, 'shed': 0, 'error': 0}
    assert st['in_flight'] == 0
  for got, want in zip(answers['port'], answers['jax']):
    assert got.nodes.tobytes() == np.asarray(want.nodes).tobytes()
    assert got.x.tobytes() == np.asarray(want.x).tobytes()


# -- routing and accounting ---------------------------------------------------
def test_fleet_spreads_and_resolves_all(request):
  router, reps = _fleet(3, auto=(0, 1, 2))
  request.addfinalizer(lambda: router.close(close_replicas=True))
  futs = [router.submit([i % N]) for i in range(12)]
  assert len([f.result(20.0) for f in futs]) == 12
  st = router.stats()
  assert st['submitted'] == 12
  assert st['resolved'] == {'ok': 12, 'shed': 0, 'error': 0}
  assert st['in_flight'] == 0
  for r in reps:
    assert r.frontend.admission.admitted > 0


def test_fleet_answers_match_offline_reference(request):
  router, reps = _fleet(2, auto=(0, 1))
  request.addfinalizer(lambda: router.close(close_replicas=True))
  ref_eng = reps[0].frontend.engine
  for seed in (3, 11, 7):
    got = router.infer([seed], timeout=20.0)
    ref = ref_eng.offline_reference([seed])
    assert got.nodes.tobytes() == ref.nodes.tobytes()
    assert got.x.tobytes() == ref.x.tobytes()


def test_router_future_stamps_resolve_time(request):
  router, _ = _fleet(2, auto=(0, 1))
  request.addfinalizer(lambda: router.close(close_replicas=True))
  fut = router.submit([4])
  t0 = time.monotonic()
  fut.result(20.0)
  assert fut.done_monotonic is not None and fut.done_monotonic <= \
      time.monotonic() and fut.done_monotonic >= t0 - 20.0
  with pytest.raises(RuntimeError, match='consumed'):
    fut.result(1.0)


# -- failover: eviction and exactly-once redrive ------------------------------
def test_dead_replica_evicted_and_stranded_requests_redriven(request):
  router, reps = _fleet(3, auto=(1, 2))
  request.addfinalizer(lambda: router.close(close_replicas=True))
  futs = [router.submit([i % N]) for i in range(9)]
  stranded = reps[0].frontend.admission.depth()
  assert stranded > 0
  reps[0].kill()
  assert router.check_replicas()['r0'] == 'healthy'   # miss 1
  assert router.check_replicas()['r0'] == 'dead'      # miss 2: evict
  st = router.stats()
  assert st['evictions'] == 1 and st['redriven'] == stranded
  assert len(_drain_all(reps, futs)) == 9
  st = router.stats()
  assert st['resolved'] == {'ok': 9, 'shed': 0, 'error': 0}
  assert st['submitted'] == 9 and st['in_flight'] == 0
  evicts = [e for e in recorder.events('serving.failover')
            if e.get('event') == 'evict']
  assert evicts and evicts[0]['redriven'] == stranded
  assert len([e for e in recorder.events('serving.failover')
              if e.get('event') == 'redrive']) == stranded


def test_second_loss_after_redrive_resolves_typed(request):
  router, reps = _fleet(2, auto=())
  request.addfinalizer(lambda: router.close(close_replicas=True))
  fut = router.submit([3])
  first = next(r for r in reps if r.frontend.admission.depth())
  first.kill()
  router.check_replicas(), router.check_replicas()
  assert router.stats()['redriven'] == 1
  second = next(r for r in reps if r is not first)
  second.kill()
  router.check_replicas(), router.check_replicas()
  with pytest.raises(FailoverExhausted):
    fut.result(5.0)
  assert router.stats()['resolved'] == {'ok': 0, 'shed': 0, 'error': 1}
  assert [e for e in recorder.events('serving.failover')
          if e.get('event') == 'exhausted']


def test_no_replica_accepts_raises_typed(request):
  router, reps = _fleet(2, auto=())
  request.addfinalizer(lambda: router.close(close_replicas=True))
  for r in reps:
    r.kill()
  router.check_replicas(), router.check_replicas()
  with pytest.raises(FailoverExhausted):
    router.submit([1])


def test_slow_replica_overloaded_not_evicted_under_chaos_delay(request):
  chaos.install({'faults': [{'site': 'serving.replica', 'action': 'delay',
                             'op': 'heartbeat', 'replica': 'r1', 'nth': 1,
                             'count': 99, 'secs': 0.06}]})
  router, reps = _fleet(3, auto=(0, 1, 2), slow_ms=30.0)
  request.addfinalizer(lambda: router.close(close_replicas=True))
  for _ in range(3):
    states = router.check_replicas()
  assert states['r1'] == 'overloaded'
  assert router.stats()['evictions'] == 0
  futs = [router.submit([i % N]) for i in range(24)]
  for f in futs:
    f.result(20.0)
  counts = {r.name: r.frontend.admission.admitted for r in reps}
  assert 0 < counts['r1'] < min(counts['r0'], counts['r2'])
  assert router.stats()['redriven'] == 0


def test_chaos_kill_evicts_and_redrives_exactly_once(request):
  router, reps = _fleet(3, auto=(1, 2))
  request.addfinalizer(lambda: router.close(close_replicas=True))
  futs = [router.submit([i % N]) for i in range(9)]
  stranded = reps[0].frontend.admission.depth()
  assert stranded > 0
  chaos.install('serving.replica:kill:1:op=heartbeat:replica=r0')
  router.check_replicas()
  router.check_replicas()
  assert router.replica_states()['r0'] == 'dead'
  assert router.stats()['redriven'] == stranded
  assert len(_drain_all(reps, futs)) == 9
  assert router.stats()['resolved']['error'] == 0


def test_chaos_kill_on_submit_reroutes(request):
  router, reps = _fleet(3, auto=(0, 1, 2))
  request.addfinalizer(lambda: router.close(close_replicas=True))
  chaos.install('serving.replica:kill:2:op=submit:replica=r0')
  futs = [router.submit([i % N]) for i in range(12)]
  assert all(f.result(20.0) is not None for f in futs)
  assert reps[0]._dead
  router.check_replicas()
  assert router.check_replicas()['r0'] == 'dead'


def test_flap_below_threshold_costs_nothing(request):
  router, reps = _fleet(2, auto=(0, 1), dead_after=3)
  request.addfinalizer(lambda: router.close(close_replicas=True))
  reps[0]._flap_until = time.monotonic() + 0.05
  assert router.check_replicas()['r0'] == 'healthy'   # miss 1 only
  assert router.stats()['replicas']['r0']['misses'] == 1
  time.sleep(0.06)
  assert router.check_replicas()['r0'] == 'healthy'
  assert router.stats()['replicas']['r0']['misses'] == 0
  assert router.stats()['evictions'] == 0


def test_flap_past_threshold_evicts_then_readmits(request):
  chaos.install('serving.replica:flap:1:op=heartbeat:replica=r0:secs=0.15')
  router, reps = _fleet(2, auto=(0, 1), dead_after=2)
  request.addfinalizer(lambda: router.close(close_replicas=True))
  router.check_replicas()
  assert router.check_replicas()['r0'] == 'dead'
  time.sleep(0.16)
  assert router.check_replicas()['r0'] == 'healthy'
  assert [e for e in recorder.events('serving.failover')
          if e.get('event') == 'readmit']
  router.infer([1], timeout=20.0)


def test_submit_evict_race_still_redrives(request):
  router, reps = _fleet(2, auto=(1,))
  request.addfinalizer(lambda: router.close(close_replicas=True))
  orig = reps[0].submit

  def racing_submit(seeds, deadline_ms=None, trace=None):
    fut = orig(seeds, deadline_ms, trace=trace)
    router._evict('r0')              # the monitor wins the race
    return fut

  reps[0].submit = racing_submit
  fut = router.submit([3])
  assert router.stats()['redriven'] == 1
  assert fut.result(20.0) is not None
  assert router.stats()['resolved'] == {'ok': 1, 'shed': 0, 'error': 0}


# -- draining, sweeping, bad input --------------------------------------------
def test_draining_replica_skipped_not_evicted(request):
  router, reps = _fleet(2, auto=(0, 1))
  request.addfinalizer(lambda: router.close(close_replicas=True))
  reps[0].frontend.admission.set_draining(True)
  assert router.check_replicas()['r0'] == 'draining'
  before = reps[0].frontend.admission.admitted
  for f in [router.submit([i % N]) for i in range(6)]:
    f.result(20.0)
  assert reps[0].frontend.admission.admitted == before
  assert router.stats()['evictions'] == 0
  assert router._health()['healthy']
  reps[0].frontend.admission.set_draining(False)
  assert router.check_replicas()['r0'] == 'healthy'


def test_abandoned_futures_swept_from_ledger(request):
  router, _ = _fleet(2, auto=(0, 1), abandon_grace_s=0.05)
  request.addfinalizer(lambda: router.close(close_replicas=True))
  fut = router.submit([3])
  deadline = time.monotonic() + 10
  while not fut.done():
    assert time.monotonic() < deadline
    time.sleep(0.01)
  time.sleep(0.06)
  router.check_replicas()
  st = router.stats()
  assert st['in_flight'] == 0 and st['swept'] == 1
  with pytest.raises(RuntimeError, match='swept'):
    fut.result(1.0)


def test_malformed_request_raises_without_charging_misses(request):
  router, _ = _fleet(2, auto=(0, 1))
  request.addfinalizer(lambda: router.close(close_replicas=True))
  for _ in range(3):
    with pytest.raises(ValueError):
      router.submit([N + 5])
  st = router.stats()
  assert st['evictions'] == 0
  assert all(r['misses'] == 0 for r in st['replicas'].values())
  router.infer([1], timeout=20.0)


def test_shutdown_replica_rerouted_and_rotated_out(request):
  router, reps = _fleet(2, auto=(0, 1))
  request.addfinalizer(lambda: router.close(close_replicas=True))
  reps[0].frontend.shutdown()
  for i in range(6):
    router.infer([i], timeout=20.0)
  assert router.stats()['resolved']['ok'] == 6
  router.check_replicas()
  assert router.check_replicas()['r0'] == 'dead'
  router.infer([7], timeout=20.0)


def test_all_replicas_draining_raises_admission_typed(request):
  router, reps = _fleet(2, auto=(0, 1))
  request.addfinalizer(lambda: router.close(close_replicas=True))
  for r in reps:
    r.frontend.admission.set_draining(True)
  router.check_replicas()
  with pytest.raises(AdmissionRejected) as ei:
    router.submit([1])
  assert ei.value.reason == 'draining'
  assert ei.value.retry_after_ms and ei.value.retry_after_ms > 0
  for r in reps:
    r.frontend.admission.set_draining(False)
  router.check_replicas()
  router.infer([1], timeout=20.0)


def test_fleet_health_component_reports_per_replica(request):
  router, reps = _fleet(2, auto=(0, 1))
  request.addfinalizer(lambda: router.close(close_replicas=True))
  router.check_replicas()
  fleet = live.healthz()['components']['fleet']
  assert fleet['healthy']
  assert set(fleet['replicas']) == {'r0', 'r1'}
  assert fleet['replicas']['r0']['state'] == 'healthy'
  assert fleet['replicas']['r0']['slo'] is not None
  assert live.snapshot()['fleet.replicas{state=healthy}'] == 2
  reps[0].kill()
  router.check_replicas(), router.check_replicas()
  st = router.stats()['replicas']
  assert st['r0']['state'] == 'dead' and st['r1']['state'] == 'healthy'
  assert live.snapshot()['fleet.replicas{state=dead}'] == 1


# -- flap damping -------------------------------------------------------------
def _flap_once(router, reps, i=0):
  """One full dead→healthy flap; returns the re-admission pass's map."""
  reps[i]._flap_until = time.monotonic() + 30.0
  router.check_replicas()
  router.check_replicas()                      # dead at dead_after=2
  reps[i]._flap_until = 0.0
  return router.check_replicas()


def test_three_flaps_quarantine_with_backoff(request):
  base = live.counter('fleet.quarantines_total').value()
  router, reps = _fleet(2, auto=(0, 1), flap_window_s=60.0,
                        quarantine_backoff_s=0.2)
  request.addfinalizer(lambda: router.close(close_replicas=True))
  assert _flap_once(router, reps)['r0'] == 'healthy'
  assert _flap_once(router, reps)['r0'] == 'healthy'
  assert _flap_once(router, reps)['r0'] == 'quarantined'
  assert router.stats()['quarantined'] == 1
  assert live.counter('fleet.quarantines_total').value() == base + 1
  assert [e for e in recorder.events('serving.failover')
          if e.get('event') == 'quarantine']
  before = reps[0].frontend.admission.admitted
  for f in [router.submit([i % N]) for i in range(6)]:
    f.result(20.0)
  assert reps[0].frontend.admission.admitted == before
  assert router.check_replicas()['r0'] == 'quarantined'
  time.sleep(0.25)
  assert router.check_replicas()['r0'] == 'healthy'
  assert _flap_once(router, reps)['r0'] == 'quarantined'
  assert router.stats()['quarantined'] == 2
  time.sleep(0.25)                            # 0.4 s backoff now
  assert router.check_replicas()['r0'] == 'quarantined'
  time.sleep(0.25)
  assert router.check_replicas()['r0'] == 'healthy'


def test_slow_flaps_outside_window_never_quarantine(request):
  router, reps = _fleet(2, auto=(0, 1), flap_window_s=0.01)
  request.addfinalizer(lambda: router.close(close_replicas=True))
  for _ in range(4):
    assert _flap_once(router, reps)['r0'] == 'healthy'
    time.sleep(0.02)
  assert router.stats()['quarantined'] == 0


# -- elastic membership and what is not ported --------------------------------
def test_add_and_remove_replica(request):
  router, reps = _fleet(2, auto=(0, 1))
  request.addfinalizer(lambda: router.close(close_replicas=True))
  extra = LocalReplica('r2', _frontend(auto=True))
  router.add_replica(extra)
  with pytest.raises(ValueError):
    router.add_replica(extra)
  for f in [router.submit([i % N]) for i in range(12)]:
    f.result(20.0)
  assert extra.frontend.admission.admitted > 0
  assert router.remove_replica('r2') is extra
  extra.close()
  assert router.remove_replica('r2') is None
  assert set(router.replica_states()) == {'r0', 'r1'}
  assert [e for e in recorder.events('serving.failover')
          if e.get('event') == 'retire']


def test_remove_replica_redrives_its_stranded_requests(request):
  router, reps = _fleet(2, auto=(1,))
  request.addfinalizer(lambda: router.close(close_replicas=True))
  futs = [router.submit([i % N]) for i in range(6)]
  stranded = reps[0].frontend.admission.depth()
  assert stranded > 0
  router.remove_replica('r0')
  assert router.stats()['redriven'] == stranded
  assert all(f.result(20.0) is not None for f in futs)
  reps[0].close()


def test_remote_replica_and_scraper_not_ported(request):
  # RemoteReplica is ported with the host runtime (its RPC round trip:
  # test_torch_serving_rpc.py); a handle with an ops endpoint federates
  # over HTTP, the in-process replica through its heartbeat
  from graphlearn_tpu_torch.telemetry.federation import (HttpTarget,
                                                          RegistryTarget)
  remote = RemoteReplica('r9', None, 0, ops_url='http://127.0.0.1:9')
  assert remote.reachable() and remote.ops_url == 'http://127.0.0.1:9'
  router, _ = _fleet(1, auto=(0,))
  request.addfinalizer(lambda: router.close(close_replicas=True))
  # the scraper is ported since the telemetry slice: it federates the
  # replica (and the process registry as 'self')
  from graphlearn_tpu_torch.telemetry import FleetScraper
  scraper = router.make_scraper()
  assert isinstance(scraper, FleetScraper)
  assert sorted(scraper.scrape()) == ['r0', 'self']
  wired = FleetRouter([remote], auto_start=False)
  request.addfinalizer(wired.close)
  targets = {t.name: t for t in wired.make_scraper()._targets}
  assert isinstance(targets['r9'], HttpTarget)
  assert isinstance(targets['self'], RegistryTarget)
