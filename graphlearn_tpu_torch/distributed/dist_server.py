"""Sampling server: producer pools serving remote trainer clients.

The JAX package's `distributed/dist_server.py`; reference
`distributed/dist_server.py:38-227`: a server process owns the dataset,
builds an `MpSamplingProducer` + shm buffer per client loader, and
serves `fetch_one_sampled_message` pulls until the clients ask it to
exit — CPU hosts do the sampling, the card's host only trains.  With a
`serving.ServingFrontend` attached (`attach_serving`) the same process
answers online inference (`serve_infer`) and hot model swaps
(`serving_swap`) on its own card.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional

import numpy as np

from ..channel import ShmChannel
from .dist_context import DistContext, DistRole, _set_context
from .dist_options import (MpDistSamplingWorkerOptions,
                           RemoteDistSamplingWorkerOptions)
from .dist_sampling_producer import MpSamplingProducer
from .host_dataset import HostDataset
from .rpc import RpcServer


class DistServer:
  """Per-process server state + RPC handler methods
  (reference `dist_server.py:38-156`)."""

  def __init__(self, dataset: HostDataset):
    self.dataset = dataset
    self._producers: Dict[int, MpSamplingProducer] = {}
    self._channels: Dict[int, ShmChannel] = {}
    self._seeds: Dict[int, np.ndarray] = {}
    self._next_id = 0
    self._exit = threading.Event()
    self._lock = threading.Lock()
    self.rank = 0                   # set by init_server
    self.num_clients = 1            # set by init_server
    self._left_clients: set = set()
    self._serving = None            # ServingFrontend (attach_serving)

  # -- handlers ------------------------------------------------------------
  def get_dataset_meta(self):
    d = self.dataset
    from .host_dataset import HostHeteroDataset
    if isinstance(d, HostHeteroDataset):
      return {
          'hetero': True,
          'num_nodes': dict(d.num_nodes),
          'edge_types': [tuple(et) for et in d.edge_types],
          'feature_dims': {nt: f.shape[1]
                           for nt, f in d.node_features.items()},
          'has_labels': {nt: True for nt in d.node_labels},
      }
    return {
        'hetero': False,
        'num_nodes': d.num_nodes, 'num_edges': d.num_edges,
        'feature_dim': (d.node_features.shape[1]
                        if d.node_features is not None else 0),
        'has_labels': d.node_labels is not None,
    }

  def create_sampling_producer(self, opts: RemoteDistSamplingWorkerOptions,
                               fanouts, batch_size: int, seeds,
                               with_edge: bool = False,
                               shuffle: bool = False, seed: int = 0,
                               sampling_config=None) -> int:
    """Build a producer + buffer for one client loader
    (reference `dist_server.py:83-116`)."""
    channel = ShmChannel(opts.buffer_capacity, opts.buffer_size)
    mp_opts = MpDistSamplingWorkerOptions(
        num_workers=opts.num_workers,
        worker_concurrency=opts.worker_concurrency,
        collect_features=opts.collect_features)
    producer = MpSamplingProducer(
        self.dataset, fanouts, batch_size, channel, mp_opts,
        with_edge=with_edge, shuffle=shuffle, seed=seed,
        sampling_config=sampling_config)
    producer.init()
    seeds = np.asarray(seeds)
    with self._lock:
      pid = self._next_id
      self._next_id += 1
      self._producers[pid] = producer
      self._channels[pid] = channel
      self._seeds[pid] = seeds if seeds.ndim > 1 else seeds.reshape(-1)
    return pid

  def start_new_epoch_sampling(self, producer_id: int,
                               drop_last: bool = False,
                               epoch=None) -> int:
    # ``epoch`` fast-forwards a freshly ADOPTED producer to
    # the loader's current epoch so its permutation stream and
    # (epoch, seq) batch seeds line up byte-identically with what the
    # dead server's producer would have produced
    return self._producers[producer_id].produce_all(
        self._seeds[producer_id], drop_last=drop_last,
        epoch=None if epoch is None else int(epoch))

  def fetch_one_sampled_message(self, producer_id: int):
    """Pull of one message (reference `fetch_one_sampled_message`,
    `dist_server.py:121-131`).  Returns the wire bytes untouched —
    they cross the socket as a tensor-map frame without a
    parse/re-serialize round trip (a producer's '#SPAN' context tensor
    rides through to the client intact).

    Liveness-guarded: the buffer pull is a timed poll interleaved with
    producer supervision, so a crashed sampling worker is restarted
    (its unacked batches replayed; the client's '#SEQ' dedup absorbs
    any double delivery) and an irrecoverable pool surfaces to the
    client as a `PeerLostError`-tagged RPC error instead of a request
    that never returns."""
    from ..telemetry.spans import span
    from .resilience import PeerLostError, fetch_deadline
    from .rpc import RawTensorMap, RpcError
    with span('server.fetch', producer=producer_id):
      channel = self._channels[producer_id]
      producer = self._producers[producer_id]
      timed = getattr(channel, 'recv_bytes_timeout', None)
      if timed is None:
        return RawTensorMap(channel.recv_bytes())
      patience = fetch_deadline()
      deadline = time.monotonic() + patience
      while True:
        data = timed(2.0)
        if data is not None:
          return RawTensorMap(data)
        # acks live client-side; supervise with unknown acks replays
        # the dead worker's FULL assignment (consumer dedup keeps the
        # epoch exact)
        # an irrecoverable pool already wrote its 'peer.lost'
        # post-mortem inside supervise() (with the worker/exitcode/
        # outstanding context) — no second dump here, the one-shot
        # per-reason dedup would discard it anyway
        _, lost = producer.supervise(None)
        if lost:
          raise PeerLostError(
              f'producer {producer_id}: worker restart budget '
              f'exhausted with {len(lost)} batch(es) unrecoverable '
              f'(exit codes {producer.dead_worker_exitcodes()})',
              peer=f'server-{self.rank}/producer-{producer_id}',
              outstanding=len(lost))
        if time.monotonic() > deadline:
          # alive-but-silent past the (generous) fetch deadline: an
          # ambiguous stall, NOT a proven peer loss — raise the plain
          # RPC error so degraded-mode clients don't amputate a
          # server whose pool may merely be stuck (PeerLostError is
          # reserved for the exhausted-budget arm above)
          raise RpcError(
              f'producer {producer_id}: no message within '
              f'{patience:.0f}s fetch deadline '
              f'({producer.alive_workers()} worker(s) alive — '
              'stalled or extremely slow pool)')

  def destroy_sampling_producer(self, producer_id: int) -> None:
    with self._lock:
      producer = self._producers.pop(producer_id, None)
      channel = self._channels.pop(producer_id, None)
      self._seeds.pop(producer_id, None)
    if producer is not None:
      producer.shutdown()
    if channel is not None:
      channel.close()

  # -- serving plane --------------------------------------------------------
  def attach_serving(self, frontend) -> None:
    """Attach a `serving.ServingFrontend`: `serve_infer` starts
    answering, and `heartbeat` grows the serving block (queue depth,
    in-flight batch, per-bucket compile status) — the overloaded-vs-
    dead discriminator for serving clients."""
    self._serving = frontend

  def serve_infer(self, seeds, deadline_ms=None, trace=None):
    """One online inference request (RPC handler).  Exactly-once:
    this handler runs under the replay cache like every RPC, so a
    retried request replays the cached reply instead of re-executing
    (and the engine's per-seed determinism makes even a hypothetical
    re-execution byte-identical).  `AdmissionRejected` travels back
    typed via the wire's structured error-kind field —
    `DistClient.serve` resurfaces it as the same class.  ``trace``
    is the caller's request-trace context: this handler's span
    (``serving.rpc``) is the cross-process edge under the router's
    root, and the frontend's per-request spans parent under it."""
    from ..telemetry.tracing import _new_id, child_ctx, tracer
    from ..testing import chaos
    chaos.serving_request_check('serve_infer')
    serving = self._serving
    if serving is None:
      from .rpc import RpcError
      raise RpcError(f'server {self.rank} has no serving tier '
                     'attached (attach_serving was never called)')
    # pre-mint the rpc span id so the frontend's child spans (queue
    # wait / dispatch slice) parent under a span recorded only after
    # the future resolves (spans are recorded on completion)
    rpc_sid = _new_id() if trace else None
    t0 = time.monotonic()
    try:
      fut = serving.submit(np.asarray(seeds), deadline_ms,
                           trace=child_ctx(trace, rpc_sid))
      # wait on the REQUEST's deadline (+ execution grace), not the
      # tier default: a caller that paid for a long deadline must not
      # be timed out at the default by its own server (the in-process
      # `ServingFrontend.infer` uses the same arithmetic)
      dl = (float(deadline_ms) if deadline_ms is not None
            else serving.admission.default_deadline_ms)
      res = fut.result(dl / 1e3 + 30.0)
    except Exception as e:          # noqa: BLE001 — record, re-raise
      dur = time.monotonic() - t0
      if trace:
        tracer.span('serving.rpc', trace, span_id=rpc_sid, t0=t0,
                    dur=dur, rank=self.rank,
                    error=f'{type(e).__name__}: {e}'[:160])
        tracer.resolve(trace, outcome='error', latency_ms=dur * 1e3)
      raise
    dur = time.monotonic() - t0
    if trace:
      tracer.span('serving.rpc', trace, span_id=rpc_sid, t0=t0,
                  dur=dur, rank=self.rank)
      tracer.resolve(trace, outcome='ok', latency_ms=dur * 1e3)
    out = {'nodes': np.asarray(res.nodes)}
    if res.x is not None:
      out['x'] = np.asarray(res.x)
    if res.logits is not None:
      out['logits'] = np.asarray(res.logits)
    return out

  def serving_swap(self, params, version=None):
    """Drain-free hot model swap RPC: validates the candidate against
    `offline_reference` parity before admitting traffic to it, rolls
    back on mismatch.  ``params`` arrives as numpy arrays — a state dict,
    or a Flax parameter tree, which the model's ``*_from_flax``
    converter turns into one — and is loaded onto this server's own
    device by the engine.  `SwapParityError` /
    `SwapValidationError` travel back typed via the wire's structured
    error-kind field (`DistClient.swap_model` resurfaces them as the
    same classes); runs under the replay cache like every RPC, so a
    retried swap replays its cached verdict instead of swapping
    twice."""
    serving = self._serving
    if serving is None:
      from .rpc import RpcError
      raise RpcError(f'server {self.rank} has no serving tier '
                     'attached (attach_serving was never called)')
    return serving.swap_model(_state_dict(serving.engine, params),
                              version=version)

  def heartbeat(self) -> dict:
    """Liveness + health snapshot (the slow-peer / dead-peer
    discriminator `DistClient.heartbeat` keys off): which producers
    exist and how many of their workers are alive; with a serving
    tier attached, also its queue depth / in-flight batch count /
    per-bucket compile status, so a serving client can tell an
    OVERLOADED peer (deep queue, warm buckets) from a dead or
    still-compiling one."""
    with self._lock:
      producers = {pid: {'alive_workers': p.alive_workers(),
                         'dead_exitcodes': p.dead_worker_exitcodes(),
                         'restarts': p._restarts}
                   for pid, p in self._producers.items()}
    out = {'rank': self.rank, 'time': time.time(),
           'producers': producers}
    if self._serving is not None:
      out['serving'] = self._serving.stats()
    return out

  def health(self) -> dict:
    """The `/healthz` server component: a superset of `heartbeat` —
    per-producer supervision state with a per-producer ``healthy``
    verdict (any dead or irrecoverable worker flips the process
    unhealthy until supervision replaces it).  The serving tier
    reports through its OWN `/healthz` component, so this block
    stays about the sampling plane."""
    with self._lock:
      producers = {pid: p.health()
                   for pid, p in self._producers.items()}
    return {'rank': self.rank,
            'healthy': all(p['healthy'] for p in producers.values()),
            'producers': producers,
            'clients_left': sorted(self._left_clients),
            'serving_attached': self._serving is not None}

  def notify_leave(self, client_rank: int) -> bool:
    """Record an orderly client departure — `wait_for_exit`'s timeout
    diagnostics name the clients that never called this."""
    self._left_clients.add(int(client_rank))
    return True

  def exit(self, client_rank: Optional[int] = None) -> bool:
    if client_rank is not None:
      self._left_clients.add(int(client_rank))
    self._exit.set()
    return True

  # -- lifecycle -----------------------------------------------------------
  def wait_for_exit(self, timeout: Optional[float] = None) -> bool:
    """Poll until a client requested exit (reference
    `wait_and_shutdown_server` poll loop, `dist_server.py:64-74`).
    Producers are destroyed either way — a timeout means the clients
    died, and leaking sampling subprocesses + SysV segments is worse
    than cutting them off.  A timeout is LOGGED through the flight
    recorder with the clients that never said goodbye, instead of
    returning silently (the operator's first question is "which
    trainer hung?")."""
    done = self._exit.wait(timeout)
    if not done:
      from ..telemetry.recorder import recorder
      missing = sorted(set(range(self.num_clients))
                       - self._left_clients)
      recorder.emit('server.shutdown_timeout', rank=self.rank,
                    timeout_secs=timeout,
                    clients_never_exited=missing,
                    clients_left=sorted(self._left_clients),
                    live_producers=len(self._producers))
    for pid in list(self._producers):
      self.destroy_sampling_producer(pid)
    if self._serving is not None:
      # queued serving requests resolve with typed shutdown
      # rejections (never silently lost), then the executor stops
      self._serving.shutdown()
      self._serving = None
    return done


def _state_dict(engine, params) -> dict:
  """A swap candidate as a flat state dict of host arrays: a Flax tree
  (nested dicts) goes through the engine model's converter."""
  if any(isinstance(v, dict) for v in params.values()):
    from .. import models
    name = type(engine.model).__name__
    conv = _FLAX_CONVERTERS.get(name)
    if conv is None:
      raise ValueError(f'no Flax converter for a {name} model: send a '
                       'state dict')
    params = getattr(models, conv)(params)
  return dict(params)


#: served model class -> its Flax parameter converter in `models`
_FLAX_CONVERTERS = {'TreeSAGE': 'tree_sage_from_flax'}

_server: Optional[DistServer] = None
_rpc_server: Optional[RpcServer] = None


def init_server(num_servers: int, num_clients: int, rank: int,
                dataset: HostDataset, host: str = '0.0.0.0',
                port: int = 0) -> DistServer:
  """Stand up this process as sampling server ``rank``
  (reference `init_server`, `dist_server.py:158-190`).  Returns after
  binding; call `wait_for_exit` to serve until shutdown.  The bound
  port is at ``get_server().port`` (0 = auto-pick, for tests)."""
  global _server, _rpc_server
  _set_context(DistContext(role=DistRole.SERVER, rank=rank,
                           world_size=num_servers, group_name='server',
                           num_servers=num_servers,
                           num_clients=num_clients))
  srv = DistServer(dataset)
  srv.rank = rank
  srv.num_clients = num_clients
  rpc = RpcServer(host, port)
  for name in ('get_dataset_meta', 'create_sampling_producer',
               'start_new_epoch_sampling', 'fetch_one_sampled_message',
               'destroy_sampling_producer', 'exit', 'heartbeat',
               'notify_leave', 'serve_infer', 'serving_swap'):
    rpc.register(name, getattr(srv, name))
  if getattr(dataset, 'node_pb', None) is not None:
    # a shard-backed server also serves its partition to peer samplers:
    # the partitioned host plane, port slice 25
    rpc.shutdown()
    raise NotImplementedError(
        'a server over a partition shard (PartitionService for peer '
        'samplers) comes with the partitioned host plane, port slice 25')
  rpc.start()
  srv.port = rpc.port
  # live ops plane: one scrapeable endpoint per server process
  # (GLT_OPS_PORT, 0/unset = disabled) + this server's supervision
  # state on /healthz; no-ops entirely at the default
  from ..telemetry import opsserver
  from ..telemetry.live import live
  opsserver.maybe_start_from_env()
  srv._health_fn = srv.health       # pinned: unregister is fn-guarded
  live.register_health('server', srv._health_fn)
  _server, _rpc_server = srv, rpc
  return srv


def get_server() -> Optional[DistServer]:
  return _server


def wait_and_shutdown_server(timeout: Optional[float] = None) -> None:
  global _server, _rpc_server
  if _server is not None:
    _server.wait_for_exit(timeout)
    from ..telemetry.live import live
    live.unregister_health('server',
                           fn=getattr(_server, '_health_fn', None))
  if _rpc_server is not None:
    _rpc_server.shutdown()
  _server = _rpc_server = None
