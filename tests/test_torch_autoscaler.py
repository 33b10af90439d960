"""The elastic controller: the port's `ElasticController` against the JAX
package's on one scripted router feed, the decision-machine contracts
of ``tests/test_autoscaler.py`` on the port, the `SloTracker` idle
contract, and one closed loop over a real port fleet on the CPU.

The scripted fleet is pure Python (fake router, replicas and
frontends), so both packages' controllers read exactly the same
heartbeats under the same injected times and must make exactly the
same decisions.
"""
import time

import pytest
import torch

from graphlearn_tpu.serving.autoscaler import (ElasticController as
                                               JaxElasticController)
from graphlearn_tpu.testing import chaos as jax_chaos
from graphlearn_tpu_torch.models import TreeSAGE
from graphlearn_tpu_torch.serving import (AdmissionRejected, FleetRouter,
                                          LocalReplica, ServingEngine,
                                          ServingFrontend)
from graphlearn_tpu_torch.serving.autoscaler import (COOLDOWN_ENV,
                                                     ElasticController,
                                                     ScaleAbortedError,
                                                     cooldowns_from_env)
from graphlearn_tpu_torch.telemetry import recorder
from graphlearn_tpu_torch.telemetry.live import LiveRegistry
from graphlearn_tpu_torch.telemetry.slo import SloTracker
from graphlearn_tpu_torch.testing import chaos
from test_torch_serving import BUCKETS, D, FANOUTS, N, _port_dataset


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


# -- the scripted fleet -------------------------------------------------------
def _hb(short_burn=0.0, long_burn=0.0, qps=1.0, depth=0, max_q=64,
        state='healthy', headroom=None):
  serving = {'queue_depth': depth, 'max_queue': max_q,
             'slo': {'windows': [
                 {'window_secs': 1.0, 'burn_rate': short_burn, 'qps': qps},
                 {'window_secs': 3.0, 'burn_rate': long_burn, 'qps': qps}]}}
  if headroom is not None:
    serving['headroom_qps'] = headroom
  return {'state': state, 'serving': serving}


class FakeAdmission:
  def __init__(self):
    self.draining = False

  def set_draining(self, flag):
    self.draining = bool(flag)


class FakeEngine:
  def __init__(self, compiles=0):
    self._compiles = compiles

  def compile_count(self):
    return self._compiles


class FakeFrontend:
  def __init__(self, compiles=0, quiesces=True):
    self.engine = FakeEngine(compiles)
    self.admission = FakeAdmission()
    self._quiesces = quiesces

  def quiesced(self):
    return self._quiesces and self.admission.draining


class FakeReplica:
  def __init__(self, name, compiles=0, quiesces=True, hb=None):
    self.name = name
    self.frontend = FakeFrontend(compiles, quiesces)
    self.closed = False
    self._hb = hb or {'serving': {'closed': False, 'draining': False}}

  def heartbeat(self):
    return self._hb

  def close(self):
    self.closed = True


class FakeRouter:
  def __init__(self, hb):
    self.hb = dict(hb)
    self.replicas = {}
    self.removed = []

  def heartbeats(self):
    return {k: dict(v) for k, v in self.hb.items()}

  def add_replica(self, handle):
    self.replicas[handle.name] = handle

  def remove_replica(self, name):
    self.removed.append(name)
    return self.replicas.pop(name, None)

  def get_replica(self, name):
    return self.replicas.get(name)


def _controller(router, spawn, cls=ElasticController, **kw):
  kw.setdefault('min_replicas', 1)
  kw.setdefault('max_replicas', 3)
  kw.setdefault('cooldown_s', (3.0, 15.0))
  kw.setdefault('out_burn', 1.0)
  kw.setdefault('in_burn', 0.1)
  kw.setdefault('auto_start', False)
  return cls(router, spawn, **kw)


# -- parity with the JAX controller -------------------------------------------
#: (now, heartbeat feed, chaos plan or None) per evaluation
FEED = [
    (10.0, {'r0': _hb(short_burn=2.0, qps=5.0)}, 'scale.spawn:fail:1'),
    (10.1, {'r0': _hb(short_burn=2.0, qps=5.0)}, None),
    (10.5, {'r0': _hb(short_burn=1.5), 's1': _hb(qps=2.0)}, None),
    (12.0, {'r0': _hb(long_burn=0.5), 's1': _hb(long_burn=0.5)}, None),
    (14.0, {'r0': _hb(depth=50, max_q=64)}, None),
    (14.1, {'r0': _hb(depth=50), 's1': _hb(), 's2': _hb()}, None),
    (20.0, {'r0': _hb(qps=9.0, headroom=3.5), 's1': _hb(qps=0.5),
            's2': _hb(qps=0.2, state='overloaded')}, None),
    (21.0, {'r0': _hb(qps=9.0), 's1': _hb(qps=0.5)}, None),
    (40.0, {'r0': _hb(qps=9.0), 's1': _hb(qps=0.5),
            'gone': _hb(short_burn=9.0, state='dead')}, None),
    (41.0, {'r0': _hb(qps=9.0)}, None),
]


def test_decisions_match_jax_on_one_feed():
  logs = {}
  for name, cls, ch in (('port', ElasticController, chaos),
                        ('jax', JaxElasticController, jax_chaos)):
    router = FakeRouter({})
    count = [0]

    def spawn():
      count[0] += 1
      return FakeReplica(f's{count[0]}')

    ctl = _controller(router, spawn, cls=cls)
    router.replicas = {'r0': FakeReplica('r0'), 's1': FakeReplica('s1'),
                       's2': FakeReplica('s2')}
    recs = []
    for now, feed, plan in FEED:
      router.hb = dict(feed)
      if plan:
        ch.install(plan)
      try:
        recs.append(ctl.evaluate(now=now))
      finally:
        ch.uninstall()
      recs.append(ctl.signals())
    logs[name] = (recs, router.removed, sorted(router.replicas))
  port, ref = logs['port'], logs['jax']
  strip = lambda r: r if r is None else {   # noqa: E731 — error texts
      k: v for k, v in r.items() if k != 'error'}   # name the package
  assert [strip(r) for r in port[0]] == [strip(r) for r in ref[0]]
  assert port[1:] == ref[1:]
  outcomes = [r['outcome'] for r in port[0][::2] if r]
  assert 'rolled_back' in outcomes and 'ok' in outcomes
  assert 'held:cooldown' in outcomes and 'held:bounds' in outcomes


# -- scale-out ----------------------------------------------------------------
def test_scale_out_on_burn_spike_admits_warm_replica():
  router = FakeRouter({'r0': _hb(short_burn=2.0)})
  spawned = []

  def spawn():
    h = FakeReplica(f'spawn-{len(spawned)}')
    spawned.append(h)
    return h

  rec = _controller(router, spawn).evaluate(now=10.0)
  assert rec['dir'] == 'out' and rec['outcome'] == 'ok'
  assert rec['replica'] == 'spawn-0' and rec['short_burn'] == 2.0
  assert 'spawn-0' in router.replicas and not spawned[0].closed
  assert recorder.events('scale.decision')[-1]['outcome'] == 'ok'


def test_queue_is_a_leading_indicator():
  router = FakeRouter({'r0': _hb(depth=60, max_q=64)})
  ctl = _controller(router, lambda: FakeReplica('s'), queue_ratio=0.7)
  rec = ctl.evaluate(now=0.0)
  assert rec['dir'] == 'out' and rec['outcome'] == 'ok'


def test_cooldown_suppresses_then_rearms():
  router = FakeRouter({'r0': _hb(short_burn=2.0)})
  ctl = _controller(router, lambda: FakeReplica('s0'))
  assert ctl.evaluate(now=10.0)['outcome'] == 'ok'
  held = ctl.evaluate(now=10.5)
  assert held['dir'] == 'out' and held['outcome'] == 'held:cooldown'
  router.replicas.clear()
  assert ctl.evaluate(now=13.5)['outcome'] == 'ok'


def test_bounds_are_hard_stops():
  router = FakeRouter({'r0': _hb(short_burn=2.0)})
  ctl = _controller(router, lambda: FakeReplica('s'), max_replicas=1)
  assert ctl.evaluate(now=0.0)['outcome'] == 'held:bounds'
  router = FakeRouter({'r0': _hb()})
  rec = _controller(router, lambda: FakeReplica('s')).evaluate(now=0.0)
  assert rec['dir'] == 'in' and rec['outcome'] == 'held:bounds'


def test_hysteresis_band_decides_nothing():
  router = FakeRouter({'r0': _hb(short_burn=0.5)})
  ctl = _controller(router, lambda: FakeReplica('s'))
  assert ctl.evaluate(now=0.0) is None
  assert ctl.decisions() == []
  assert not recorder.events('scale.decision')


def test_spawn_chaos_fault_rolls_back_and_rearms():
  router = FakeRouter({'r0': _hb(short_burn=2.0)})
  ctl = _controller(router, lambda: FakeReplica('s0'))
  chaos.install('scale.spawn:fail:1')
  rec = ctl.evaluate(now=10.0)
  chaos.uninstall()
  assert rec['outcome'] == 'rolled_back'
  assert 'InjectedFault' in rec['error']
  assert router.replicas == {}
  rec2 = ctl.evaluate(now=10.1)
  assert rec2['outcome'] == 'ok' and 's0' in router.replicas


def test_spawn_chaos_kill_and_empty_spawn_roll_back():
  router = FakeRouter({'r0': _hb(short_burn=2.0)})
  ctl = _controller(router, lambda: None)
  chaos.install('scale.spawn:kill:1')
  assert 'ChaosKilledError' in ctl.evaluate(now=1.0)['error']
  chaos.uninstall()
  rec = ctl.evaluate(now=1.1)
  assert rec['outcome'] == 'rolled_back'
  assert 'ScaleAbortedError' in rec['error']


def test_cold_replica_refused_at_admission():
  router = FakeRouter({'r0': _hb(short_burn=2.0)})
  cold = FakeReplica('cold', compiles=2)
  rec = _controller(router, lambda: cold).evaluate(now=0.0)
  assert rec['outcome'] == 'rolled_back'
  assert 'warm-restore pin' in rec['error']
  assert cold.closed and router.replicas == {}


@pytest.mark.parametrize('flag', ['closed', 'draining'])
def test_closed_or_draining_replica_refused(flag):
  router = FakeRouter({'r0': _hb(short_burn=2.0)})
  h = FakeReplica('x', hb={'serving': {flag: True}})
  rec = _controller(router, lambda: h).evaluate(now=0.0)
  assert rec['outcome'] == 'rolled_back' and flag in rec['error']
  assert h.closed


def test_verify_needs_a_heartbeat():
  ctl = _controller(FakeRouter({}), lambda: None)
  h = FakeReplica('mute')
  h._hb = None
  with pytest.raises(ScaleAbortedError) as ei:
    ctl._verify_replica(h)
  assert ei.value.stage == 'verify'


# -- scale-in -----------------------------------------------------------------
def test_scale_in_drains_coldest_then_retires():
  router = FakeRouter({'hot': _hb(qps=5.0), 'cold': _hb(qps=1.0)})
  victim = FakeReplica('cold')
  router.replicas = {'hot': FakeReplica('hot'), 'cold': victim}
  ctl = _controller(router, lambda: None)
  rec = ctl.evaluate(now=100.0)
  assert rec['dir'] == 'in' and rec['outcome'] == 'ok'
  assert rec['replica'] == 'cold'
  assert router.removed == ['cold'] and victim.closed
  assert victim.frontend.admission.draining
  assert ctl.evaluate(now=101.0)['outcome'] == 'held:cooldown'


def test_quiesce_timeout_undrains_and_keeps_victim():
  router = FakeRouter({'hot': _hb(qps=5.0), 'wedged': _hb(qps=1.0)})
  victim = FakeReplica('wedged', quiesces=False)
  router.replicas = {'hot': FakeReplica('hot'), 'wedged': victim}
  ctl = _controller(router, lambda: None, quiesce_timeout_s=0.05)
  rec = ctl.evaluate(now=100.0)
  assert rec['outcome'] == 'rolled_back' and 'quiesce' in rec['error']
  assert not victim.frontend.admission.draining
  assert not victim.closed and 'wedged' in router.replicas
  assert ctl.evaluate(now=100.2)['outcome'] == 'rolled_back'


def test_no_healthy_victim_holds():
  router = FakeRouter({'a': _hb(state='overloaded'),
                       'b': _hb(state='draining')})
  rec = _controller(router, lambda: None).evaluate(now=5.0)
  assert rec['dir'] == 'in' and rec['outcome'] == 'held:no_victim'


def test_dead_and_quarantined_replicas_feed_no_signals():
  router = FakeRouter({'r0': _hb(short_burn=0.0, headroom=2.0),
                       'gone': _hb(short_burn=9.0, state='dead'),
                       'flap': _hb(short_burn=9.0, state='quarantined')})
  sig = _controller(router, lambda: None).signals()
  assert sig['replicas'] == 1 and sig['short_burn'] == 0.0
  assert sig['headroom_qps'] == 2.0
  assert _controller(FakeRouter({}), lambda: None).evaluate(now=0) is None


def test_cooldown_knob(monkeypatch):
  monkeypatch.setenv(COOLDOWN_ENV, '2,9')
  assert cooldowns_from_env() == (2.0, 9.0)
  monkeypatch.setenv(COOLDOWN_ENV, '4')
  assert cooldowns_from_env() == (4.0, 4.0)
  monkeypatch.setenv(COOLDOWN_ENV, 'x')
  assert cooldowns_from_env() == (3.0, 15.0)


# -- the SloTracker idle contract ---------------------------------------------
def _tracker(now, **kw):
  kw.setdefault('p99_target_ms', 100.0)
  kw.setdefault('qps_target', 0.0)
  kw.setdefault('windows', (1.0, 3.0))
  kw.setdefault('budget', 0.1)
  return SloTracker(registry=LiveRegistry(), clock=lambda: now[0], **kw)


def test_fresh_tracker_reads_burn_zero():
  now = [1000.0]
  t = _tracker(now)
  try:
    for w in t.windows:
      st = t.window_stats(w)
      assert st['count'] == 0 and st['burn_rate'] == 0.0
    assert all(w['burn_rate'] == 0.0 for w in t.snapshot()['windows'])
  finally:
    t.close()


def test_idle_window_reads_burn_zero_not_stale():
  now = [1000.0]
  t = _tracker(now)
  try:
    for _ in range(5):
      t.observe(500.0, ok=True)
    assert t.window_stats(1.0)['burn_rate'] == pytest.approx(10.0)
    now[0] += 60.0
    st = t.window_stats(1.0)
    assert st['count'] == 0 and st['burn_rate'] == 0.0
  finally:
    t.close()


def test_zero_budget_and_zero_target_read_burn_zero():
  now = [1000.0]
  for kw in ({'budget': 0.0}, {'p99_target_ms': 0.0}):
    t = _tracker(now, **kw)
    try:
      t.observe(500.0, ok=False)
      assert t.window_stats(1.0)['burn_rate'] == 0.0
    finally:
      t.close()


# -- one closed loop over a real port fleet -----------------------------------
def _replica(name):
  eng = ServingEngine(_port_dataset(), FANOUTS,
                      model=TreeSAGE(D, 8, 5, len(FANOUTS)), seed=3,
                      buckets=BUCKETS, device='cpu')
  eng.init_params(torch.Generator().manual_seed(0))
  fe = ServingFrontend(eng, max_wait_ms=1.0, default_deadline_ms=30000.0)
  fe.slo.windows = (0.3, 0.6)
  fe.slo._tripped = {w: False for w in fe.slo.windows}
  fe.slo.budget = 0.1
  fe.slo.p99_target_ms = 1e-6 if name == 'e0' else 1e6
  return LocalReplica(name, fe)


def test_elastic_loop_over_a_real_fleet(request):
  """e0's target makes every request violate, so its burn scales the
  fleet out to a verified warm replica (the CPU builds nothing:
  ``compile_count() == 0``); once e0's window ages out the burn is 0
  and the coldest replica drains and retires while traffic keeps
  resolving."""
  router = FleetRouter([_replica('e0')], auto_start=False, dead_after=3)
  request.addfinalizer(lambda: router.close(close_replicas=True))
  ctl = ElasticController(router, lambda: _replica('e1'), min_replicas=1,
                          max_replicas=2, cooldown_s=(0.0, 0.0),
                          out_burn=0.5, in_burn=0.15, auto_start=False)
  for i in range(8):
    router.infer([i % N], timeout=20.0)
  router.check_replicas()
  rec = ctl.evaluate()
  assert rec['dir'] == 'out' and rec['outcome'] == 'ok', rec
  assert set(router.replica_states()) == {'e0', 'e1'}
  assert router.get_replica('e1').frontend.engine.compile_count() == 0
  router.get_replica('e0').frontend.slo.p99_target_ms = 1e6
  time.sleep(0.7)                            # both windows age out
  router.check_replicas()
  served = []
  for i in range(4):
    try:
      served.append(router.infer([i], timeout=20.0))
    except AdmissionRejected:
      pass
  rec = ctl.evaluate()
  assert rec['dir'] == 'in' and rec['outcome'] == 'ok', rec
  assert len(router.replica_states()) == 1
  router.check_replicas()
  assert router.infer([1], timeout=20.0) is not None
  assert len(served) == 4
