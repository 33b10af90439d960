"""Closed-loop elastic autoscaling: size the fleet from SLO burn.

The port's copy of the JAX package's `serving/autoscaler.py`.  The
`ElasticController` evaluates the router's heartbeat feed
(`FleetRouter.heartbeats`: short- and long-window burn, queue depth,
headroom) periodically and:

  * **scales out** when the worst short- or long-window burn crosses
    ``out_burn`` or a queue nears its bound: spawn a replica (the
    caller's factory), verify it (a healthy heartbeat, neither draining
    nor closed, and the warm pin ``compile_count() == 0``: a replica
    that still had to compile would answer its first requests late),
    and only then `FleetRouter.add_replica` it;
  * **scales in** when every window's burn is under ``in_burn`` and the
    queues are idle: drain the coldest replica (lowest short-window
    qps) through its admission door, wait for quiesce, retire it.

**Hysteresis**: ``out_burn`` and ``in_burn`` are apart, each direction
has its own cooldown (``GLT_SCALE_COOLDOWN_S`` = ``"out,in"``), and
min/max replica bounds are hard stops.  Every considered decision emits
a ``scale.decision`` event and lands in the decision ledger
(`decisions`).  A decision that fails mid-flight (chaos ``scale.spawn``,
a failed warm pin, a quiesce timeout) rolls back typed — the partial
replica closed, a drained victim un-drained, a post-mortem bundle
dumped — and re-arms: the failed direction's cooldown is not spent.

Knobs: ``GLT_SCALE_EVAL_S``, ``GLT_SCALE_COOLDOWN_S``,
``GLT_SCALE_MIN`` / ``GLT_SCALE_MAX``, ``GLT_SCALE_OUT_BURN`` /
``GLT_SCALE_IN_BURN``.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..telemetry import postmortem
from ..telemetry.live import live
from ..telemetry.recorder import recorder

EVAL_ENV = 'GLT_SCALE_EVAL_S'
COOLDOWN_ENV = 'GLT_SCALE_COOLDOWN_S'
MIN_ENV = 'GLT_SCALE_MIN'
MAX_ENV = 'GLT_SCALE_MAX'
OUT_BURN_ENV = 'GLT_SCALE_OUT_BURN'
IN_BURN_ENV = 'GLT_SCALE_IN_BURN'

DEFAULT_EVAL_S = 1.0
#: (out, in) cooldowns: a burn spike adds capacity fast, retiring it is
#: never urgent
DEFAULT_COOLDOWN_S = (3.0, 15.0)
DEFAULT_MIN_REPLICAS = 1
DEFAULT_MAX_REPLICAS = 8
#: scale out above this worst-window burn (1.0 = spending the budget)
DEFAULT_OUT_BURN = 1.0
#: scale in only below this on every window (the hysteresis gap)
DEFAULT_IN_BURN = 0.1
#: queue_depth/max_queue at or above which scale-out fires without burn
#: (the queue leads; burn lags a window behind)
DEFAULT_QUEUE_RATIO = 0.7


def _env_float(name: str, default: float) -> float:
  try:
    return float(os.environ.get(name, default))
  except ValueError:
    return default


def _env_int(name: str, default: int) -> int:
  try:
    return int(os.environ.get(name, default))
  except ValueError:
    return default


def cooldowns_from_env() -> Tuple[float, float]:
  """``GLT_SCALE_COOLDOWN_S`` as ``"out,in"`` (one value = both)."""
  raw = os.environ.get(COOLDOWN_ENV)
  if not raw:
    return DEFAULT_COOLDOWN_S
  try:
    parts = [float(p) for p in raw.split(',')]
  except ValueError:
    return DEFAULT_COOLDOWN_S
  if len(parts) == 1:
    return (parts[0], parts[0])
  return (parts[0], parts[1])


class ScaleAbortedError(RuntimeError):
  """A scale decision failed mid-flight and was rolled back typed;
  ``stage`` names where (``spawn``, ``verify``, ``quiesce``)."""

  def __init__(self, msg: str, stage: Optional[str] = None):
    super().__init__(msg)
    self.stage = stage


class ElasticController:
  """The closed-loop fleet sizer (see the module doc).

  Args:
    router: the `FleetRouter` whose fleet is managed.
    spawn_fn: zero-argument replica factory for scale-out; returns an
      unregistered handle (`LocalReplica`) that the controller verifies
      and admits, or closes on a fault.
    min_replicas / max_replicas: fleet-size bounds (else
      ``GLT_SCALE_MIN`` / ``GLT_SCALE_MAX``).
    eval_s: evaluation cadence (else ``GLT_SCALE_EVAL_S``).
    cooldown_s: (out, in) seconds (else ``GLT_SCALE_COOLDOWN_S``).
    out_burn / in_burn: hysteresis thresholds on the worst-window burn
      (else ``GLT_SCALE_OUT_BURN`` / ``GLT_SCALE_IN_BURN``).
    queue_ratio: queue fullness that triggers scale-out on its own.
    warm_pin: require ``engine.compile_count() == 0`` of a spawned
      replica (skipped for handles without an engine).
    quiesce_timeout_s: drain budget of a scale-in before rollback.
    clock: monotonic source (tests drive decisions deterministically).
    auto_start: run the evaluation thread.
  """

  def __init__(self, router, spawn_fn: Callable[[], object],
               min_replicas: Optional[int] = None,
               max_replicas: Optional[int] = None,
               eval_s: Optional[float] = None,
               cooldown_s: Optional[Tuple[float, float]] = None,
               out_burn: Optional[float] = None,
               in_burn: Optional[float] = None,
               queue_ratio: float = DEFAULT_QUEUE_RATIO,
               warm_pin: bool = True,
               quiesce_timeout_s: float = 10.0,
               clock=time.monotonic, auto_start: bool = True):
    self._router = router
    self._spawn_fn = spawn_fn
    self.min_replicas = (min_replicas if min_replicas is not None
                         else _env_int(MIN_ENV, DEFAULT_MIN_REPLICAS))
    self.max_replicas = (max_replicas if max_replicas is not None
                         else _env_int(MAX_ENV, DEFAULT_MAX_REPLICAS))
    self.eval_s = (eval_s if eval_s is not None
                   else _env_float(EVAL_ENV, DEFAULT_EVAL_S))
    cd = cooldown_s if cooldown_s is not None else cooldowns_from_env()
    self.cooldown_out_s, self.cooldown_in_s = float(cd[0]), float(cd[1])
    self.out_burn = (out_burn if out_burn is not None
                     else _env_float(OUT_BURN_ENV, DEFAULT_OUT_BURN))
    self.in_burn = (in_burn if in_burn is not None
                    else _env_float(IN_BURN_ENV, DEFAULT_IN_BURN))
    self.queue_ratio = float(queue_ratio)
    self.warm_pin = bool(warm_pin)
    self.quiesce_timeout_s = float(quiesce_timeout_s)
    self._clock = clock
    self._lock = threading.Lock()
    #: every considered decision, in order, with its signal snapshot
    self._decisions: List[Dict] = []  # guarded-by: self._lock
    self._last_out = -1e18           # guarded-by: self._lock
    self._last_in = -1e18            # guarded-by: self._lock
    self._closed = False
    self._thread: Optional[threading.Thread] = None
    self._m_scale = {d: live.counter('scale.replicas', labels={'dir': d})
                     for d in ('out', 'in')}
    if auto_start:
      self.start()

  # -- lifecycle ------------------------------------------------------------
  def start(self) -> None:
    if self._thread is not None:
      return
    self._thread = threading.Thread(target=self._loop, daemon=True,
                                    name='glt-elastic-controller')
    self._thread.start()

  def close(self) -> None:
    self._closed = True
    t = self._thread
    if t is not None:
      t.join(self.eval_s + 5.0)
    self._thread = None

  def _loop(self) -> None:
    while not self._closed:
      try:
        self.evaluate()
      except Exception:             # noqa: BLE001 — a dead controller
        # scales nothing ever again: outlive any single bad evaluation
        pass
      time.sleep(self.eval_s)

  # -- signals --------------------------------------------------------------
  def signals(self) -> Dict:
    """The decision signals from the router's heartbeat feed: the worst
    short/long-window burn and queue fullness over live replicas, the
    summed headroom and the live-replica count.  A replica without a
    heartbeat yet contributes 0 (an empty SLO window reads burn 0)."""
    short_burn = long_burn = queue_frac = 0.0
    headroom = 0.0
    have_headroom = False
    replicas = 0
    for ent in self._router.heartbeats().values():
      if ent['state'] in ('dead', 'quarantined'):
        continue
      replicas += 1
      serving = ent['serving'] or {}
      windows = (serving.get('slo') or {}).get('windows') or []
      if windows:
        short_burn = max(short_burn,
                         float(windows[0].get('burn_rate') or 0.0))
        long_burn = max(long_burn,
                        float(windows[-1].get('burn_rate') or 0.0))
      depth, max_q = serving.get('queue_depth'), serving.get('max_queue')
      if depth is not None and max_q:
        queue_frac = max(queue_frac, float(depth) / float(max_q))
      hr = serving.get('headroom_qps')
      if hr is not None:
        headroom += float(hr)
        have_headroom = True
    return {'replicas': replicas,
            'short_burn': round(short_burn, 4),
            'long_burn': round(long_burn, 4),
            'queue_frac': round(queue_frac, 4),
            'headroom_qps': (round(headroom, 3) if have_headroom
                             else None)}

  # -- the evaluation loop --------------------------------------------------
  def evaluate(self, now: Optional[float] = None) -> Optional[Dict]:
    """One closed-loop pass: read signals, decide, act.  Returns the
    ledger record of the decision considered (None in steady state: no
    event, no record)."""
    now = self._clock() if now is None else now
    sig = self.signals()
    n = sig['replicas']
    if n == 0:
      return None                    # replica survival is the router's job
    want_out = (sig['short_burn'] > self.out_burn
                or sig['long_burn'] > self.out_burn
                or sig['queue_frac'] >= self.queue_ratio)
    want_in = (not want_out
               and sig['short_burn'] < self.in_burn
               and sig['long_burn'] < self.in_burn
               and sig['queue_frac'] < self.queue_ratio / 2)
    if want_out:
      if n >= self.max_replicas:
        return self._record('out', sig, 'held:bounds', now)
      with self._lock:
        cooling = now - self._last_out < self.cooldown_out_s
      if cooling:
        return self._record('out', sig, 'held:cooldown', now)
      return self._scale_out(sig, now)
    if want_in:
      if n <= self.min_replicas:
        return self._record('in', sig, 'held:bounds', now)
      with self._lock:
        cooling = now - self._last_in < self.cooldown_in_s
      if cooling:
        return self._record('in', sig, 'held:cooldown', now)
      return self._scale_in(sig, now)
    return None                      # between thresholds: hysteresis

  def decisions(self) -> List[Dict]:
    with self._lock:
      return [dict(d) for d in self._decisions]

  def _record(self, direction: str, sig: Dict, outcome: str, now: float,
              replica: Optional[str] = None,
              error: Optional[str] = None) -> Dict:
    rec = {'dir': direction, 'outcome': outcome, 'replica': replica,
           'at': now, 'error': error, **sig}
    with self._lock:
      self._decisions.append(rec)
    recorder.emit('scale.decision', dir=direction, outcome=outcome,
                  replica=replica, error=error, **sig)
    return rec

  # -- scale-out ------------------------------------------------------------
  def _verify_replica(self, handle) -> None:
    """A spawned replica's admission bar: a healthy heartbeat (neither
    closed nor draining) and, when the handle exposes its engine, the
    warm pin ``compile_count() == 0``."""
    hb = handle.heartbeat()
    serving = (hb or {}).get('serving')
    if not serving:
      raise ScaleAbortedError(
          f'spawned replica {handle.name!r} answered no heartbeat',
          stage='verify')
    if serving.get('closed') or serving.get('draining'):
      raise ScaleAbortedError(
          f'spawned replica {handle.name!r} is '
          f'{"closed" if serving.get("closed") else "draining"} at '
          'admission time', stage='verify')
    engine = getattr(getattr(handle, 'frontend', None), 'engine', None)
    if self.warm_pin and engine is not None:
      compiles = engine.compile_count()
      if compiles != 0:
        raise ScaleAbortedError(
            f'warm-restore pin failed on {handle.name!r}: '
            f'compile_count()=={compiles} after warmup — the kernels '
            'were neither loaded nor restored from GLT_AOT_CACHE_DIR; '
            'admitting it would serve first requests at build latency',
            stage='verify')

  def _scale_out(self, sig: Dict, now: float) -> Dict:
    from ..testing import chaos
    handle = None
    try:
      chaos.scale_spawn_check()
      handle = self._spawn_fn()
      if handle is None:
        raise ScaleAbortedError('spawn_fn returned no replica',
                                stage='spawn')
      self._verify_replica(handle)
      self._router.add_replica(handle)
    except Exception as e:          # noqa: BLE001 — every spawn fault
      # rolls back typed and re-arms (the cooldown is not spent)
      if handle is not None:
        handle.close()
      postmortem.dump('autoscale.scale_out_fault', error=e,
                      extra={'signals': sig})
      return self._record('out', sig, 'rolled_back', now,
                          replica=getattr(handle, 'name', None),
                          error=f'{type(e).__name__}: {e}')
    with self._lock:
      self._last_out = now
    self._m_scale['out'].inc()
    return self._record('out', sig, 'ok', now, replica=handle.name)

  # -- scale-in -------------------------------------------------------------
  def _pick_coldest(self) -> Optional[str]:
    """The scale-in victim: the healthy replica with the lowest
    short-window qps (ties broken by name)."""
    best = None
    for name, ent in sorted(self._router.heartbeats().items()):
      if ent['state'] != 'healthy':
        continue
      windows = ((ent['serving'] or {}).get('slo') or {}) \
          .get('windows') or []
      qps = float(windows[0].get('qps') or 0.0) if windows else 0.0
      if best is None or qps < best[1]:
        best = (name, qps)
    return best[0] if best else None

  def _scale_in(self, sig: Dict, now: float) -> Dict:
    victim = self._pick_coldest()
    if victim is None:
      return self._record('in', sig, 'held:no_victim', now)
    handle = self._router.get_replica(victim)
    frontend = getattr(handle, 'frontend', None)
    if handle is None or frontend is None:
      return self._record('in', sig, 'held:no_victim', now,
                          replica=victim)
    # the hot-swap drain: queued work finishes, new arrivals shed typed
    # with the retry hint
    frontend.admission.set_draining(True)
    deadline = time.monotonic() + self.quiesce_timeout_s
    while not frontend.quiesced():
      if time.monotonic() > deadline:
        frontend.admission.set_draining(False)   # back into rotation
        e = ScaleAbortedError(
            f'replica {victim!r} did not quiesce within '
            f'{self.quiesce_timeout_s:g}s of draining — un-draining and '
            'keeping it', stage='quiesce')
        postmortem.dump('autoscale.scale_in_fault', error=e,
                        extra={'signals': sig, 'replica': victim})
        return self._record('in', sig, 'rolled_back', now,
                            replica=victim,
                            error=f'{type(e).__name__}: {e}')
      time.sleep(0.005)
    # quiesced: out of rotation first, then close
    self._router.remove_replica(victim)
    handle.close()
    with self._lock:
      self._last_in = now
    self._m_scale['in'].inc()
    return self._record('in', sig, 'ok', now, replica=victim)
