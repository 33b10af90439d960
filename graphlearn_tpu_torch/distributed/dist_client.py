"""Trainer-side client of the sampling servers.

The JAX package's `distributed/dist_client.py`; reference
`distributed/dist_client.py:24-98`: `init_client` joins the
deployment, loaders call `create_sampling_producer` on their target
server, and `shutdown_client` has client-0 tell every server to exit.
"""
from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .dist_context import DistContext, DistRole, _set_context, get_context
from .dist_options import RemoteDistSamplingWorkerOptions
from .rpc import RpcClient, RpcError


class RemoteProducerHandle:
  """One loader's producer living on a server."""

  def __init__(self, client: 'DistClient', server_idx: int,
               producer_id: int):
    self._client = client
    self._server_idx = server_idx
    self._pid = producer_id

  def start_new_epoch(self, drop_last: bool = False,
                      epoch: Optional[int] = None) -> int:
    kw = {} if epoch is None else {'epoch': int(epoch)}
    return self._client.request_server(
        self._server_idx, 'start_new_epoch_sampling', self._pid,
        drop_last=drop_last, **kw)

  def fetch(self, src=None):
    # ``src`` is the replacement-fetch routing hint (see
    # `MultiProducerHandle.fetch`); with one server there is only one
    # place to fetch from, so it is accepted and ignored
    from ..telemetry.spans import span
    with span('client.fetch', server=self._server_idx):
      return self._client.request_server(
          self._server_idx, 'fetch_one_sampled_message', self._pid)

  def destroy(self) -> None:
    # best-effort cleanup: ONE short attempt, no retry ladder — a
    # teardown against an already-dead server must not block for the
    # full retry deadline (the server reaps producers on exit anyway)
    try:
      self._client._rpcs[self._server_idx].request_once(
          'destroy_sampling_producer', self._pid, timeout=5.0)
    except Exception:
      pass


class MultiProducerHandle:
  """One loader fanned out over several servers (list-valued
  ``server_rank``, reference `dist_options.py:202-258`): each server
  samples a batch-aligned seed slice; fetches round-robin by each
  server's per-epoch message count.

  Elastic failover: ``creation_args`` (recorded by
  `DistClient.create_sampling_producer`) lets `adopt_server`
  recreate a dead server's producer — its exact seed slice and seed
  offset — on a SURVIVOR, fast-forwarded to the loader's current
  epoch, under the SAME handle index (= '#SRC' tag), so the channel's
  (source, seq) replay dedup + source-routed replacement fetches
  absorb the re-produced prefix and the epoch finishes with every
  expected batch, byte-identical."""

  def __init__(self, handles: List[RemoteProducerHandle],
               creation_args: Optional[List[tuple]] = None):
    self._handles = handles
    self._lock = threading.Lock()
    self._plan: List[int] = []      # handle idx per outstanding message
    self._pos = 0
    #: per-handle (opts, fanouts, batch_size, seeds, with_edge,
    #: shuffle, seed, sampling_config) — guarded-by: self._lock
    self._creation_args = creation_args or []
    self._epochs_started = 0        # guarded-by: self._lock
    self._last_drop_last = False    # guarded-by: self._lock
    self._adopted: dict = {}        # dead server_idx -> survivor idx

  @property
  def server_indices(self) -> List[int]:
    return [h._server_idx for h in self._handles]

  def adopt_server(self, client: 'DistClient', server_idx: int,
                   survivor_idx: Optional[int] = None) -> dict:
    """Recreate the dead server's producers on a survivor (exact
    completion instead of `drop_server`'s write-off).  Idempotent per
    dead server: repeat losses (several in-flight fetches failing in
    turn) only append the one replacement fetch each fetch consumed.
    Returns ``{'survivor', 'owed', 'recreated'}``; raises
    `AdoptionRefusedError` when no creation args were recorded or no
    survivor remains."""
    from ..parallel.partition_book import AdoptionRefusedError
    with self._lock:
      already = self._adopted.get(server_idx)
      if already is not None:
        self._plan.append(already[1])   # the failed fetch's refetch
        return {'survivor': already[0], 'owed': 1, 'recreated': 0}
      if not self._creation_args:
        raise AdoptionRefusedError(
            'this producer plan recorded no creation args — '
            'adoption unavailable (single-producer plans have no '
            'survivor to recreate on)')
      dead = [i for i, h in enumerate(self._handles)
              if h._server_idx == server_idx]
      if not dead:
        raise AdoptionRefusedError(
            f'server {server_idx} owns no handle of this plan')
      live = sorted({h._server_idx for i, h in enumerate(self._handles)
                     if i not in dead}
                    - {s for s, _ in self._adopted.values()}
                    - {server_idx})
      if survivor_idx is None:
        if not live:
          raise AdoptionRefusedError(
              f'no surviving server to adopt server {server_idx}\'s '
              'producers (one adoption per survivor)')
        survivor_idx = live[0]
      epoch = self._epochs_started - 1
      drop_last = self._last_drop_last
      owed = sum(1 for i in self._plan[self._pos:] if i in dead)
      dead_args = [(j, self._creation_args[j]) for j in dead]
    # RPCs outside the lock: producer creation + the fast-forwarded
    # epoch start can take seconds on a big slice
    recreated = 0
    for j, args in dead_args:
      new_h = client._create_one(survivor_idx, *args)
      new_h.start_new_epoch(drop_last, epoch=max(epoch, 0))
      with self._lock:
        self._handles[j] = new_h
      recreated += 1
    with self._lock:
      self._adopted[server_idx] = (survivor_idx, dead[0])
      # the fetch that surfaced the loss consumed a plan entry whose
      # message is still owed — put one back, routed at the adopted
      # handle (the re-produced prefix drains via replay discards +
      # source-routed replacements)
      self._plan.append(dead[0])
    return {'survivor': survivor_idx, 'owed': owed + 1,
            'recreated': recreated}

  def start_new_epoch(self, drop_last: bool = False) -> int:
    counts = [h.start_new_epoch(drop_last) for h in self._handles]
    with self._lock:
      self._epochs_started += 1
      self._last_drop_last = bool(drop_last)
      # interleave: h0, h1, ..., h0, h1, ... while counts last
      plan = []
      remaining = list(counts)
      while any(remaining):
        for i, r in enumerate(remaining):
          if r > 0:
            plan.append(i)
            remaining[i] -= 1
      self._plan = plan
      self._pos = 0
    return sum(counts)

  def fetch(self, src=None):
    """One planned fetch, or — ``src`` given — a replacement fetch
    routed to that handle.  A replacement replaces a message the
    consumer discarded as a worker-restart replay duplicate: the real
    undelivered message sits in THAT server's buffer, so round-robin
    would send the extra fetch to a server that owes nothing (blocking
    there until its fetch deadline and failing a healthy epoch)."""
    if src is not None:
      msg = self._handles[src].fetch()
      if isinstance(msg, dict):
        msg['#SRC'] = np.int64(src)
      return msg
    with self._lock:
      if self._pos >= len(self._plan):
        raise RpcError('no planned fetches remain (accounting bug, or '
                       'every server owing messages is gone)')
      idx = self._plan[self._pos]
      self._pos += 1
    msg = self._handles[idx].fetch()
    if isinstance(msg, dict):
      # source tag: each server's producer numbers its '#SEQ' stamps
      # from 0, so the consumer's replay dedup must key on
      # (source, seq) — without this, server B's batch 0 reads as a
      # replay of server A's batch 0 and gets discarded
      msg['#SRC'] = np.int64(idx)
    return msg

  def drop_server(self, server_idx: int) -> int:
    """Degraded mode: a server is lost for good — remove its remaining
    planned fetches so survivors finish the epoch.  Returns how many
    planned (not-yet-started) fetches it still owed; in-flight fetches
    that fail surface separately, one `PeerLostError` each."""
    with self._lock:
      dead = [i for i, h in enumerate(self._handles)
              if h._server_idx == server_idx]
      remaining = self._plan[self._pos:]
      kept = [i for i in remaining if i not in dead]
      self._plan = kept
      self._pos = 0
      return len(remaining) - len(kept)

  def destroy(self) -> None:
    for h in self._handles:
      h.destroy()


class DistClient:
  """Connections to every sampling server."""

  def __init__(self, server_addrs: Sequence[Tuple[str, int]], rank: int,
               num_clients: int):
    self.rank = rank
    self._rpcs: List[RpcClient] = [RpcClient(h, p) for h, p in server_addrs]
    self.num_servers = len(self._rpcs)
    self.num_clients = num_clients

  def request_server(self, server_idx: int, name: str, *args, **kwargs):
    """RPC to one server, classified on failure: a retry-exhausted
    request probes the peer — still answering its ping means SLOW
    (`RetryExhausted` propagates, caller may widen its deadline), not
    answering means DEAD (`PeerLostError`, emitted as a ``peer.lost``
    event).  A server-side `PeerLostError` (its producer pool died)
    re-raises typed on this side too."""
    from ..telemetry.recorder import recorder
    from .resilience import PeerLostError, RetryExhausted
    try:
      return self._rpcs[server_idx].request(name, *args, **kwargs)
    except PeerLostError:
      raise
    except RetryExhausted as e:
      if self._rpcs[server_idx].probe():
        raise                      # slow peer: alive but over budget
      addr = self._rpcs[server_idx].addr
      recorder.emit('peer.lost', peer=server_idx, peer_kind='server',
                    addr=f'{addr[0]}:{addr[1]}', op=name,
                    degraded=False, error=str(e))
      raise PeerLostError(
          f'server {server_idx} at {addr} is gone: {name!r} '
          f'exhausted retries and the liveness probe failed',
          peer=server_idx) from e
    except RpcError as e:
      if getattr(e, 'remote_kind', None) == 'PeerLostError':
        # the server executed but ITS producer pool is irrecoverable
        # (typed via the wire's structured error-kind field — never
        # sniffed out of the message text)
        raise PeerLostError(f'server {server_idx}: {e}',
                            peer=server_idx) from e
      raise

  def serve(self, seeds, server_idx: Optional[int] = None,
            deadline_ms: Optional[float] = None,
            trace: Optional[dict] = None) -> dict:
    """One online inference request against a server's serving tier:
    ``seeds`` (a few node ids) -> ``{'nodes': [k, W], 'x':
    [k, W, D] | 'logits': [k, C]}`` numpy arrays, byte-identical to
    the per-seed offline reference whatever the request was coalesced
    with.  Rides the full resilience ladder via
    `request_server`: transport faults retry under the same request
    id (the server's replay cache keeps the retry exactly-once), a
    dead peer surfaces as `PeerLostError` — and a server-side
    admission refusal resurfaces TYPED as
    `serving.admission.AdmissionRejected` (wire error-kind field,
    never message-text sniffing), so callers can tell overload (back
    off / reroute) from failure.  Default server = ``rank %
    num_servers``, the producer round-robin convention.  ``trace``
    (a `telemetry.tracing` context dict) rides the RPC frame so the
    server's per-request spans join the caller's trace tree."""
    from ..serving.admission import AdmissionRejected
    if server_idx is None:
      server_idx = self.rank % self.num_servers
    seeds = np.asarray(seeds, np.int64).reshape(-1)
    try:
      return self.request_server(server_idx, 'serve_infer', seeds,
                                 deadline_ms=deadline_ms, trace=trace)
    except RpcError as e:
      if getattr(e, 'remote_kind', None) == 'AdmissionRejected':
        # rebuild the typed rejection FAITHFULLY from the wire's
        # structured extra field (reason / retry_after_ms / queue
        # diagnostics) — a fleet router keys its reroute-vs-raise
        # decision off `reason`, and a draining replica's retry-after
        # hint must survive the hop
        extra = getattr(e, 'remote_extra', None) or {}
        raise AdmissionRejected(
            f'server {server_idx} shed the request: {e}',
            reason=extra.get('reason', ''),
            queue_depth=extra.get('queue_depth'),
            limit=extra.get('limit'),
            waited_ms=extra.get('waited_ms'),
            retry_after_ms=extra.get('retry_after_ms')) from e
      raise

  def swap_model(self, params, server_idx: Optional[int] = None,
                 version: Optional[int] = None) -> dict:
    """Hot model swap on one server's serving tier: ships the candidate
    params as numpy arrays (a state dict — torch tensors are copied to
    the host first, so no CUDA tensor crosses the wire — or a Flax
    parameter tree), the server loads them onto its own device,
    quiesces between coalesced runs, parity-checks against its offline
    reference, and commits or rolls back.  Typed `SwapParityError` /
    `SwapValidationError` resurface here as the same classes (wire
    error-kind field)."""
    from ..serving.swap import (SwapAbortedError, SwapParityError,
                                SwapValidationError)
    if server_idx is None:
      server_idx = self.rank % self.num_servers
    params = _host_tree(params)
    try:
      return self.request_server(server_idx, 'serving_swap', params,
                                 version=version)
    except RpcError as e:
      kind = getattr(e, 'remote_kind', None)
      if kind == 'SwapParityError':
        extra = getattr(e, 'remote_extra', None) or {}
        raise SwapParityError(f'server {server_idx}: {e}',
                              max_err=extra.get('max_err')) from e
      if kind == 'SwapValidationError':
        raise SwapValidationError(f'server {server_idx}: {e}') from e
      if kind == 'SwapAbortedError':
        raise SwapAbortedError(f'server {server_idx}: {e}') from e
      raise

  def heartbeat(self, server_idx: int, timeout: float = 2.0):
    """One-shot health snapshot from a server (fresh connection, no
    retries); ``None`` when the peer is unreachable."""
    try:
      return self._rpcs[server_idx].request_once('heartbeat',
                                                 timeout=timeout)
    except Exception:              # noqa: BLE001 — unreachable = None
      return None

  def get_dataset_meta(self, server_idx: int = 0):
    return self.request_server(server_idx, 'get_dataset_meta')

  def _create_one(self, idx: int, opts, fanouts, batch_size, seeds,
                  with_edge, shuffle, seed,
                  sampling_config=None) -> RemoteProducerHandle:
    # dict-valued (per-edge-type) fanouts must survive the RPC intact;
    # tuple keys pickle fine
    fanouts = (dict(fanouts) if isinstance(fanouts, dict)
               else list(fanouts))
    pid = self.request_server(
        idx, 'create_sampling_producer', opts, fanouts,
        int(batch_size), np.asarray(seeds), with_edge=with_edge,
        shuffle=shuffle, seed=seed, sampling_config=sampling_config)
    return RemoteProducerHandle(self, idx, pid)

  def create_sampling_producer(
      self, opts: RemoteDistSamplingWorkerOptions, fanouts,
      batch_size: int, seeds: np.ndarray, with_edge: bool = False,
      shuffle: bool = False, seed: int = 0, sampling_config=None):
    idx = opts.server_rank
    if idx is None:
      idx = self.rank % self.num_servers   # round-robin default
    if isinstance(idx, (list, tuple)):
      if len(idx) == 1:
        idx = idx[0]
      else:
        # fan out: split seeds batch-aligned across the listed servers
        # (axis 0: rows are edge pairs in link mode)
        seeds = np.asarray(seeds)
        n_batches = (len(seeds) + batch_size - 1) // batch_size
        per = ((n_batches + len(idx) - 1) // len(idx)) * batch_size
        handles, creation_args = [], []
        for j, sidx in enumerate(idx):
          sl = seeds[j * per:(j + 1) * per]
          if len(sl):
            args = (opts, fanouts, batch_size, sl, with_edge,
                    shuffle, seed + j, sampling_config)
            handles.append(self._create_one(sidx, *args))
            # recorded per handle: `adopt_server` recreates the exact
            # slice + seed offset on a survivor
            creation_args.append(args)
        return MultiProducerHandle(handles, creation_args)
    return self._create_one(idx, opts, fanouts, batch_size, seeds,
                            with_edge, shuffle, seed, sampling_config)

  def shutdown(self, notify_servers: bool = True) -> None:
    """Every client says goodbye (`notify_leave` — the server's
    shutdown-timeout diagnostics name whoever didn't); client-0 then
    asks every server to exit (reference `shutdown_client`,
    `dist_client.py:54-76`)."""
    if notify_servers:
      for i in range(self.num_servers):
        try:
          self._rpcs[i].request_once('notify_leave', self.rank,
                                     timeout=2.0)
        except Exception:
          pass
        if self.rank == 0:
          # one short attempt: telling an already-dead server to exit
          # must not ride the retry ladder
          try:
            self._rpcs[i].request_once('exit', client_rank=self.rank,
                                       timeout=5.0)
          except Exception:
            pass
    for c in self._rpcs:
      c.close()


def _host_tree(tree):
  """A parameter tree with every tensor as a host numpy array."""
  if isinstance(tree, dict):
    return {k: _host_tree(v) for k, v in tree.items()}
  if hasattr(tree, 'detach'):
    return tree.detach().cpu().numpy()
  return np.asarray(tree)


_client: Optional[DistClient] = None


def init_client(server_addrs: Sequence[Tuple[str, int]], rank: int = 0,
                num_clients: int = 1) -> DistClient:
  """Declare this process trainer client ``rank``
  (reference `init_client`, `dist_client.py:24-51`)."""
  global _client
  _set_context(DistContext(
      role=DistRole.CLIENT, rank=rank, world_size=num_clients,
      group_name='client', num_servers=len(server_addrs),
      num_clients=num_clients))
  _client = DistClient(server_addrs, rank, num_clients)
  return _client


def get_client() -> Optional[DistClient]:
  return _client


def shutdown_client(notify_servers: bool = True) -> None:
  global _client
  if _client is not None:
    _client.shutdown(notify_servers)
  _client = None
