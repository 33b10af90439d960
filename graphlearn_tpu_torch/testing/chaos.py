"""Seeded, declarative fault injection.

The port's copy of the JAX package's `testing/chaos.py`, reduced to the
seams the port fires.  A *fault plan* is a list of
:class:`Fault` records naming a **site** (a seam the code calls into),
an **action**, and the ``nth`` matching arrival at that seam on which
it fires (counted per fault — deterministic under a fixed plan).  The
plan syntax is the JAX package's, so a plan written for one package
reads the same in the other.  Sites and actions:

  ``rpc.request``
      Inside `distributed.rpc.RpcClient.request`, once per attempt.
      ``drop`` (sever the connection after the request is sent — the
      server may have executed it, exercising the replay cache),
      ``delay`` (sleep ``secs`` before sending), ``corrupt`` (scramble
      the reply payload so the client misparses).  ``op`` filters by
      handler name.
  ``producer.worker``
      At the top of a sampling worker's per-batch loop
      (`distributed.dist_sampling_producer`).  ``kill`` hard-exits the
      process with ``WORKER_KILL_EXIT`` (no cleanup, like the OOM
      killer).  ``worker`` / ``epoch`` / ``generation`` filter by worker
      rank, epoch and restart generation (0 = the original process).
  ``checkpoint.io``
      Inside `utils.checkpoint.Checkpointer.save`.  ``fail`` (the write
      dies before any byte lands), ``truncate`` (a partial tmp write,
      then death before the atomic publish).
  ``ingest.wal``
      Inside `streaming.wal.WriteAheadLog.append`.  ``fail`` (the
      append dies before any byte lands), ``truncate`` (half a record
      lands, then the process "dies"; the next open truncates the torn
      tail).
  ``ingest.apply``
      Inside `streaming.ingest.IngestPipeline`, between the durable WAL
      append and the in-memory commit.  ``kill`` raises
      :class:`ChaosKilledError` (logged but not applied; a restart
      replays it exactly once), ``delay`` sleeps ``secs``.
  ``ingest.compact``
      Inside `IngestPipeline.compact`, before the snapshot publishes.
      ``kill`` raises :class:`ChaosKilledError`.
  ``feature.cold_service``
      Inside `data.Feature.get`, on a lookup of a mixed table that
      needs the host cold tier (``op`` is ``'feature'``), and at the top
      of the mesh sampler's cold overlay (``op`` is ``'dist'``).
      ``fail`` raises :class:`InjectedFault`: the cold tier died under
      the batch.
  ``fused.dispatch``
      Before each chunk of a fused epoch (`loader.fused`; a fused mesh
      epoch is one chunk, `parallel.fused`).  ``kill`` raises
      :class:`ChaosKilledError` (the in-process stand-in for a
      preemption), ``delay`` sleeps ``secs``.  ``epoch`` filters by
      epoch.
  ``serving.request``
      Inside the serving executor just before a coalesced dispatch
      (``op='dispatch'``; ``replica`` is the frontend's fleet name), and
      inside the `DistServer.serve_infer` RPC handler before admission
      (``op='serve_infer'``).
      ``delay`` sleeps ``secs`` (a slow executor: queued requests behind
      it expire and shed typed), ``drop`` raises :class:`InjectedFault`
      on every rider of the dispatch.
  ``serving.replica``
      Inside a fleet replica handle (`serving.router`), on
      ``op='submit'`` and ``op='heartbeat'``; ``replica`` filters by
      name.  ``kill`` (the replica dies for good: its executor stops
      cold and its queued requests freeze until the router redrives
      them), ``delay`` (a slow replica, classified overloaded, not
      dead), ``flap`` (unreachable for ``secs``, then back).
  ``scale.spawn``
      Inside `serving.autoscaler.ElasticController`'s scale-out, once
      per spawn attempt before the replica factory runs.  ``delay``
      sleeps, ``fail`` raises :class:`InjectedFault`, ``kill`` raises
      :class:`ChaosKilledError`; either raise rolls the decision back
      typed and leaves the cooldown unspent.
  ``aot.cache``
      Inside the kernel-build cache (`serving.aot_cache`), ``op`` =
      ``'save'`` / ``'load'``.  ``fail`` raises :class:`InjectedFault`
      (absorbed: a cache fault costs an ``nvcc`` run, never a kernel),
      ``corrupt`` scrambles the payload before publish (a later load
      must catch the checksum and rebuild).
  ``partition.owner``
      At every mesh dispatch seam (`parallel.dist_sampler`'s node, link,
      subgraph and walk dispatches; a fused mesh epoch's chunk boundary),
      before the draw cursor advances.  ``kill`` classifies the fault's
      ``partition`` dead and raises `parallel.failover.PartitionLostError`
      (the sampler's recovery ladder: adopt, else degraded, else typed);
      ``delay`` sleeps ``secs`` (a slow owner, not a dead one).
  ``handoff.transfer``
      Inside `parallel.handoff.handoff`, once a phase with ``op`` = the
      seam (``snapshot`` / ``transfer`` / ``fence`` / ``cutover`` /
      ``drain``) and ``partition`` = the moving range.  ``delay`` sleeps,
      ``fail`` raises :class:`InjectedFault`, ``kill`` raises
      :class:`ChaosKilledError`.  A raise before ``cutover`` unwinds to the
      source; at ``drain`` it is absorbed (the move stands).
  ``ops.scrape``
      Inside the ops endpoint's request handler (`telemetry.opsserver`),
      once per HTTP request with ``op`` = the route path.  ``delay``
      stalls that handler thread (the serving executor must not
      notice), ``drop`` raises :class:`InjectedFault` (the route
      answers 503).

Plans install programmatically (:func:`install`) or from the
``GLT_FAULT_PLAN`` env var (inherited by producer subprocesses and
sampling servers: how cross-process chaos reaches them).  JSON::

    {"faults": [{"site": "ingest.apply", "action": "kill", "nth": 3}]}

or the compact form ``site:action:nth[:key=val...]`` joined by ``;``.
Without a plan every seam is one module-attribute check.
"""
from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

FAULT_PLAN_ENV = 'GLT_FAULT_PLAN'

#: exit code of a chaos-killed sampling worker (distinctive in
#: ``dead_worker_exitcodes``: an injected kill, not a real crash)
WORKER_KILL_EXIT = 173

_SITES = ('rpc.request', 'producer.worker', 'checkpoint.io', 'ingest.wal', 'ingest.apply', 'ingest.compact',
          'feature.cold_service', 'fused.dispatch', 'serving.request',
          'serving.replica', 'scale.spawn', 'aot.cache', 'partition.owner',
          'handoff.transfer', 'ops.scrape')
_ACTIONS = ('drop', 'delay', 'corrupt', 'kill', 'fail', 'truncate',
            'flap')


class InjectedFault(RuntimeError):
  """A chaos ``fail``/``truncate`` fired: the real-world analog (disk
  error, a kill mid-write) raised mid-operation."""


class ChaosKilledError(RuntimeError):
  """A planned ``kill`` fired — the in-process stand-in for a process
  death.  The test must resume from durable state in a fresh object."""


@dataclass
class Fault:
  """One planned fault: fire ``count`` times starting at the ``nth``
  matching arrival (1-based) at ``site``."""
  site: str
  action: str
  nth: int = 1
  count: int = 1
  op: Optional[str] = None
  worker: Optional[int] = None    # producer.worker: rank filter
  epoch: Optional[int] = None     # fused.dispatch, producer.worker
  #: producer.worker: restart-generation filter (0 = the original
  #: process, so a deterministic kill cannot re-fire in its replacement)
  generation: Optional[int] = None
  replica: Optional[str] = None   # serving.*, scale.spawn: name filter
  #: partition.owner: the victim partition (a kill classifies it dead);
  #: also a filter where the seam names one (handoff.transfer)
  partition: Optional[int] = None
  secs: float = 0.1               # delay / flap duration
  _seen: int = field(default=0, repr=False, compare=False)

  def __post_init__(self):
    if self.site not in _SITES:
      raise ValueError(f'unknown fault site {self.site!r} '
                       f'(expected one of {_SITES})')
    if self.action not in _ACTIONS:
      raise ValueError(f'unknown fault action {self.action!r} '
                       f'(expected one of {_ACTIONS})')

  def _matches(self, ctx: Dict[str, Any]) -> bool:
    if self.op is not None and ctx.get('op') != self.op:
      return False
    if self.replica is not None and ctx.get('replica') != self.replica:
      return False
    if self.worker is not None and ctx.get('worker') != self.worker:
      return False
    if (self.generation is not None
        and ctx.get('generation') != self.generation):
      return False
    if (self.partition is not None and 'partition' in ctx
        and ctx.get('partition') != self.partition):
      return False
    return self.epoch is None or ctx.get('epoch') == self.epoch


class ChaosPlan:
  """A set of faults; arrival counting is per fault, under a lock."""

  def __init__(self, faults: List[Fault]):
    self.faults = list(faults)
    self._lock = threading.Lock()

  def on(self, site: str, **ctx) -> List[Fault]:
    """Record one arrival at ``site``; return the faults that fire."""
    fired = []
    with self._lock:
      for f in self.faults:
        if f.site != site or not f._matches(ctx):
          continue
        f._seen += 1
        if f.nth <= f._seen < f.nth + f.count:
          fired.append(f)
    if fired:
      from ..telemetry.recorder import recorder
      for f in fired:
        recorder.emit('fault.injected', site=site, action=f.action,
                      nth=f.nth, arrival=f._seen, op=ctx.get('op'),
                      worker=ctx.get('worker'), epoch=ctx.get('epoch'))
    return fired

  def exhausted(self) -> bool:
    """Every planned fault has fired its full count."""
    with self._lock:
      return all(f._seen >= f.nth + f.count - 1 for f in self.faults)


def parse_plan(spec) -> ChaosPlan:
  """A plan from a dict / list / JSON string / compact string (a plan's
  ``seed`` is accepted and unused: no seam here draws at random)."""
  if isinstance(spec, ChaosPlan):
    return spec
  if isinstance(spec, str):
    s = spec.strip()
    if not s.startswith(('{', '[')):
      return ChaosPlan([_parse_compact(p) for p in s.split(';')
                        if p.strip()])
    spec = json.loads(s)
  if isinstance(spec, dict):
    spec = spec.get('faults', [])
  return ChaosPlan([f if isinstance(f, Fault) else Fault(**f)
                    for f in spec])


def _parse_compact(part: str) -> Fault:
  toks = part.strip().split(':')
  if len(toks) < 2:
    raise ValueError(f'bad compact fault {part!r}: need site:action')
  kw: Dict[str, Any] = {'site': toks[0], 'action': toks[1]}
  if len(toks) > 2 and toks[2]:
    kw['nth'] = int(toks[2])
  for tok in toks[3:]:
    if '=' not in tok:
      raise ValueError(f'bad compact fault field {tok!r} in {part!r}')
    k, v = tok.split('=', 1)
    kw[k] = int(v) if k in ('nth', 'count', 'epoch', 'partition',
                            'worker', 'generation') else (
        float(v) if k == 'secs' else v)
  return Fault(**kw)


# -- process-global plan ----------------------------------------------------
_plan: Optional[ChaosPlan] = None
_env_checked = False
_install_lock = threading.Lock()


def install(spec) -> ChaosPlan:
  """Install ``spec`` as the process's active plan (replacing any)."""
  global _plan, _env_checked
  with _install_lock:
    _plan = parse_plan(spec)
    _env_checked = True
  return _plan


def uninstall() -> None:
  """Deactivate chaos for this process."""
  global _plan, _env_checked
  with _install_lock:
    _plan = None
    _env_checked = True


def active() -> Optional[ChaosPlan]:
  """The process's plan, lazily read from ``GLT_FAULT_PLAN``."""
  global _plan, _env_checked
  if _plan is None and not _env_checked:
    with _install_lock:
      if _plan is None and not _env_checked:
        _env_checked = True
        spec = os.environ.get(FAULT_PLAN_ENV)
        if spec:
          _plan = parse_plan(spec)
  return _plan


# -- seams ------------------------------------------------------------------
def on(site: str, **ctx) -> List[Fault]:
  """The generic seam: no-op (one global read) without a plan."""
  p = active()
  return p.on(site, **ctx) if p is not None else []


def rpc_faults(op: str) -> List[Fault]:
  """`RpcClient.request` seam, once per attempt.  The caller applies the
  returned actions (sleep for ``delay``, sever for ``drop``, scramble
  the reply for ``corrupt``)."""
  return on('rpc.request', op=op)


def corrupt_payload(payload: bytes) -> bytes:
  """Deterministically scramble a reply payload (bit-flip every 7th
  byte): enough to break both pickle and tensor-map parsing."""
  buf = bytearray(payload)
  if not buf:
    return b'\xff\xff\xff\xff'
  buf[::7] = bytes((b ^ 0xFF) for b in buf[::7])
  return bytes(buf)


def worker_kill_check(rank: int, epoch: int, generation: int = 0,
                      flush=()) -> None:
  """Sampling-worker seam, before each batch: a fired ``kill`` hard-exits
  the process (``os._exit``, no cleanup).  ``flush`` holds mp queues
  (the producer's progress-ack queue) whose feeder threads are joined
  first: the seam models a crash BETWEEN batches, after every earlier
  batch's ack left the process, so the supervisor replays exactly the
  unsent batches (a lost ack would replay a sent one, and a
  deterministic kill would then re-fire in every replacement)."""
  for f in on('producer.worker', worker=rank, epoch=epoch,
              generation=generation):
    if f.action == 'kill':
      for q in flush:
        try:
          q.close()
          q.join_thread()
        except Exception:           # noqa: BLE001 — best-effort flush
          pass
      os._exit(WORKER_KILL_EXIT)


def ingest_wal_faults(op: str = 'append') -> List[str]:
  """WAL seam, once per append: ``fail`` raises `InjectedFault` before
  any byte is written; ``truncate`` is returned so the writer lands a
  partial record and then raises."""
  actions = [f.action for f in on('ingest.wal', op=op)]
  if 'fail' in actions:
    raise InjectedFault(f'injected WAL append failure (op {op!r})')
  return actions


def ingest_apply_check(seqno: int = 0) -> None:
  """Delta-apply seam, between the durable append and the commit:
  ``kill`` raises `ChaosKilledError`, ``delay`` sleeps in place."""
  for f in on('ingest.apply', seqno=int(seqno)):
    if f.action == 'delay':
      time.sleep(f.secs)
    elif f.action == 'kill':
      raise ChaosKilledError(f'injected ingest apply kill (seqno {seqno})')


def ingest_compact_check(seqno: int = 0) -> None:
  """Compaction seam, before the snapshot publishes: ``kill`` raises
  `ChaosKilledError`."""
  for f in on('ingest.compact', seqno=int(seqno)):
    if f.action == 'kill':
      raise ChaosKilledError(
          f'injected ingest compaction kill (seqno {seqno})')


def cold_service_check(scope: str = '') -> None:
  """Host cold-tier seam, once per lookup that needs the cold tier:
  ``fail`` raises `InjectedFault`."""
  for f in on('feature.cold_service', op=scope or None):
    if f.action == 'fail':
      raise InjectedFault(
          f'injected cold-tier service failure (scope {scope!r})')


def fused_dispatch_check(chunk: int = 0, epoch: int = 0,
                         phase: str = '') -> None:
  """Fused-chunk-dispatch seam, before a chunk's first step: ``delay``
  sleeps in place, ``kill`` raises `ChaosKilledError` (the preemption
  stand-in: the run resumes from its durable snapshot in a fresh
  driver)."""
  for f in on('fused.dispatch', chunk=int(chunk), epoch=int(epoch),
              op=phase or None):
    if f.action == 'delay':
      time.sleep(f.secs)
    elif f.action == 'kill':
      raise ChaosKilledError(
          f'injected fused.dispatch kill (epoch {epoch}, chunk {chunk})')


def maybe_delay(faults: List[Fault]) -> None:
  for f in faults:
    if f.action == 'delay':
      time.sleep(f.secs)


def serving_request_check(op: str = '', replica: str = '') -> None:
  """Serving-executor seam, before each coalesced dispatch: ``delay``
  sleeps in place, ``drop`` raises `InjectedFault`.  ``replica`` is the
  frontend's fleet name, so a plan can stall one replica."""
  for f in on('serving.request', op=op or None, replica=replica or None):
    if f.action == 'delay':
      time.sleep(f.secs)
    elif f.action == 'drop':
      raise InjectedFault(f'injected serving request drop (op {op!r})')


def replica_faults(replica: str, op: str) -> List[Fault]:
  """Fleet-replica seam, one arrival per ``submit`` / ``heartbeat``:
  ``delay`` sleeps here; ``kill`` and ``flap`` are returned for the
  handle to apply (it owns the dead or flapping state)."""
  fired = on('serving.replica', replica=replica, op=op)
  maybe_delay(fired)
  return fired


def aot_cache_faults(op: str) -> List[str]:
  """Kernel-build-cache seam, ``op`` ``'save'`` / ``'load'``: ``fail``
  raises `InjectedFault` (the caller absorbs it into an ``nvcc`` run);
  ``corrupt`` is returned so the writer scrambles what it publishes."""
  actions = [f.action for f in on('aot.cache', op=op)]
  if 'fail' in actions:
    raise InjectedFault(f'injected aot cache failure (op {op!r})')
  return actions


def scale_spawn_check(replica: str = '') -> None:
  """Elastic scale-out seam, once per spawn attempt before the replica
  factory runs: ``delay`` sleeps, ``fail`` raises `InjectedFault`,
  ``kill`` raises `ChaosKilledError`."""
  fired = on('scale.spawn', replica=replica or None)
  maybe_delay(fired)
  for f in fired:
    if f.action == 'fail':
      raise InjectedFault(f'injected scale.spawn provisioning failure '
                          f'(replica {replica!r})')
    if f.action == 'kill':
      raise ChaosKilledError(f'injected scale.spawn kill (replica '
                             f'{replica!r})')


def ops_scrape_check(path: str = '') -> None:
  """Ops-endpoint seam (`telemetry.opsserver`), once per HTTP request
  with ``op=<route path>``: ``delay`` stalls the scrape handler thread
  in place (a wedged scraper must never block the serving executor or a
  fused dispatch), ``drop`` raises `InjectedFault` (the handler answers
  503)."""
  for f in on('ops.scrape', op=path or None):
    if f.action == 'delay':
      time.sleep(f.secs)
    elif f.action == 'drop':
      raise InjectedFault(f'injected ops scrape drop (path {path!r})')


def partition_owner_check(step: int = 0) -> None:
  """Partition-owner seam, one arrival a mesh dispatch, before the draw
  cursor advances (a recovered dispatch then draws as the fault-free one
  did): ``delay`` sleeps in place (a slow owner is not reclassified);
  ``kill`` raises `parallel.failover.PartitionLostError` naming the
  fault's ``partition``."""
  fired = on('partition.owner', step=int(step))
  maybe_delay(fired)
  for f in fired:
    if f.action == 'kill':
      from ..parallel.failover import PartitionLostError
      p = int(f.partition or 0)
      raise PartitionLostError(
          f'injected partition.owner kill: partition {p} classified dead '
          f'at dispatch step {step}', partition=p)


def handoff_transfer_check(seam: str, partition: int = 0) -> None:
  """Planned-handoff seam, once a phase (``op`` = the seam name):
  ``delay`` sleeps in place (the source keeps serving), ``fail`` raises
  `InjectedFault`, ``kill`` raises `ChaosKilledError`."""
  fired = on('handoff.transfer', op=seam, partition=int(partition))
  maybe_delay(fired)
  for f in fired:
    if f.action == 'fail':
      raise InjectedFault(
          f'injected handoff {seam} failure (partition {partition})')
    if f.action == 'kill':
      raise ChaosKilledError(
          f'injected handoff {seam} kill (partition {partition})')
