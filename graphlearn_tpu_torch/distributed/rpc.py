"""Socket RPC substrate for the server-client deployment mode.

The JAX package's `distributed/rpc.py`, frame for frame, so a client of
one package can talk to a server of the other.  The reference rides
torch.distributed.rpc/TensorPipe (`distributed/rpc.py:236-292`); the
sampling tier here needs no device runtime at all, so the control plane
is a deliberately small threaded socket RPC:

  * frames: ``[u32 kind][u64 len][payload]`` — kind 0 = pickled
    control object, kind 1 = tensor-map bytes (``csrc/host/
    tensor_map.cc`` serialization, no pickle on the sample-message
    path).  A dict of arrays goes as a tensor map unless one of its
    dtypes has no wire code; then that one message goes as pickle (the
    wire format, not a fallback: the native library itself must load,
    or encoding raises);
  * server: one daemon thread per connection, handlers looked up in a
    registry (the reference's `RpcCalleeBase`/`rpc_register`,
    `rpc.py:364-443`);
  * client: a connection pool so concurrent prefetch threads each own
    a socket.

Failure story (the resilience layer, `distributed/resilience.py`):

  * every request carries an **idempotency id** ``(client_token,
    seq)``; the server keeps a bounded per-client **replay cache** of
    encoded replies (with in-progress markers), so a request retried
    after a lost reply is answered from cache — **never executed
    twice** (the fetch handler pops a message; double execution would
    lose a batch);
  * the client applies a **per-request socket timeout**, severs and
    reopens the connection on ANY transport fault (a peer dying
    mid-frame must not leave a half-read stream to misparse the next
    reply), and retries under a `RetryPolicy` deadline with capped,
    seeded-jitter backoff — each retry emitted as an ``rpc.retry``
    flight-recorder event;
  * servers answer a built-in ``__ping__`` so callers can tell a slow
    peer (retry) from a dead one (`PeerLostError`).

Trusted-cluster assumption (same as TensorPipe): control frames use
pickle, so only run between your own hosts.
"""
from __future__ import annotations

import itertools
import pickle
import socket
import socketserver
import struct
import threading
import time
import uuid
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from ..native import parse_tensor_map, serialize_tensor_map

_HDR = struct.Struct('<IQ')
KIND_PICKLE = 0
KIND_TENSOR_MAP = 1

#: replay-cache bounds: encoded replies kept per client token (count
#: and bytes), and distinct client tokens tracked per server.  The
#: entry count must stay comfortably above any client's concurrent
#: request fan-out (prefetch threads): a retry whose cached reply was
#: pruned re-executes the handler — exactly the double execution the
#: cache exists to prevent.  64 entries vs the default prefetch of 4
#: leaves a 16x margin.
REPLAY_ENTRIES_PER_CLIENT = 64
REPLAY_BYTES_PER_CLIENT = 64 * 1024 * 1024
REPLAY_MAX_CLIENTS = 256
#: completed reply frames older than this are dropped regardless of
#: the caps: a retry only arrives within the client's retry deadline
#: (default 120s), so frames delivered long ago are pure dead weight —
#: without the horizon, fetch replies (hundreds of KB to MB each)
#: would pin the full byte budget per token on a long-running server.
REPLAY_RETAIN_SECS = 600.0


def _send_frame(sock: socket.socket, kind: int, payload: bytes) -> None:
  sock.sendall(_HDR.pack(kind, len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
  buf = bytearray()
  while len(buf) < n:
    chunk = sock.recv(min(n - len(buf), 1 << 20))
    if not chunk:
      raise ConnectionError('peer closed')
    buf += chunk
  return bytes(buf)


def _recv_frame(sock: socket.socket) -> Tuple[int, bytes]:
  kind, ln = _HDR.unpack(_recv_exact(sock, _HDR.size))
  return kind, _recv_exact(sock, ln)


def _encode_obj(obj: Any) -> Tuple[int, bytes]:
  """Encode one value to its frame ``(kind, payload)``; a non-empty dict
  of string-keyed arrays goes through the tensor-map path, everything
  else (and a dict holding a dtype without a wire code) as pickle."""
  if isinstance(obj, RawTensorMap):
    return KIND_TENSOR_MAP, bytes(obj)
  if (isinstance(obj, dict) and obj
      and all(isinstance(k, str) for k in obj)
      and all(isinstance(v, (np.ndarray, np.generic))
              for v in obj.values())):
    try:
      return KIND_TENSOR_MAP, serialize_tensor_map(obj)
    except KeyError:                # a dtype the wire format lacks
      pass
  return KIND_PICKLE, pickle.dumps(obj, protocol=5)


def _decode_obj(kind: int, payload: bytes) -> Any:
  if kind == KIND_TENSOR_MAP:
    return parse_tensor_map(payload)
  return pickle.loads(payload)


def send_obj(sock: socket.socket, obj: Any) -> None:
  """Send one value; dict-of-ndarray goes through the tensor-map path."""
  _send_frame(sock, *_encode_obj(obj))


def recv_obj(sock: socket.socket) -> Any:
  return _decode_obj(*_recv_frame(sock))


class RawTensorMap(bytes):
  """Already-serialized tensor-map payload: `send_obj` frames it
  directly (no parse/re-serialize on the server's fetch hot path) and
  the receiving side parses it into the usual dict."""


class RpcError(RuntimeError):
  pass


class _RemoteError:
  """A handler exception shipped to the caller.  ``kind`` carries the
  original exception type name as a STRUCTURED field so clients can
  classify (e.g. a server-side `PeerLostError`) without sniffing the
  message text; it resurfaces as ``RpcError.remote_kind``.  ``extra``
  carries the exception's scalar attributes (an `AdmissionRejected`'s
  ``reason``/``retry_after_ms``/``queue_depth`` diagnostics) so the
  client can REBUILD the typed error faithfully instead of parsing
  its message."""

  def __init__(self, msg: str, kind: Optional[str] = None,
               extra: Optional[dict] = None):
    self.msg = msg
    self.kind = kind
    self.extra = extra


def _error_extra(exc: BaseException) -> Optional[dict]:
  """Scalar attributes of a handler exception, wire-safe."""
  out = {k: v for k, v in getattr(exc, '__dict__', {}).items()
         if v is None or isinstance(v, (str, int, float, bool))}
  return out or None


def _remote_to_error(out: '_RemoteError') -> RpcError:
  err = RpcError(out.msg)
  err.remote_kind = getattr(out, 'kind', None)
  err.remote_extra = getattr(out, 'extra', None)
  return err


class _TransportError(Exception):
  """Internal marker: the reply never arrived intact (connection
  severed, timed out, or the frame misparsed).  ALWAYS resets the
  socket and retries — never surfaces to callers directly."""


class _ReplayEntry:
  """One replay-cache slot: ``frame`` lands when execution completes;
  until then duplicates park on ``done`` instead of re-executing."""
  __slots__ = ('frame', 'done', 'done_at')

  def __init__(self):
    self.frame: Optional[Tuple[int, bytes]] = None
    self.done = threading.Event()
    self.done_at: Optional[float] = None

  def resolve(self, frame: Tuple[int, bytes]) -> None:
    self.frame = frame
    self.done_at = time.monotonic()
    self.done.set()


class _ReplayCache:
  """Bounded per-client-token reply cache (the server side of request
  idempotency).  ``begin`` either claims a fresh entry (caller must
  execute and `finish`), returns the existing one (caller replays), or
  reports the entry EVICTED — a retry whose cached reply was pruned
  must NOT silently re-execute (the fetch handler pops a message;
  re-running it would hand one client two different batches under one
  request id).  Eviction tracking is a per-client high-water mark over
  pruned seqs: client seqs are monotone, so ``seq <= watermark`` with
  no live entry means the reply existed once and is gone."""

  EVICTED = 'evicted'

  def __init__(self, max_entries: int = REPLAY_ENTRIES_PER_CLIENT,
               max_bytes: int = REPLAY_BYTES_PER_CLIENT,
               max_clients: int = REPLAY_MAX_CLIENTS):
    self._lock = threading.Lock()
    # guarded-by: self._lock
    self._clients: 'OrderedDict[str, OrderedDict[int, _ReplayEntry]]' = \
        OrderedDict()
    # bounded LRU: a mark only matters while a zombie client might
    # still retry; without a cap the server leaks one int per client
    # token EVER seen (a serving fleet recycles clients
    # continuously).  4x max_clients keeps marks well past the
    # per-client eviction horizon.
    self._evicted_marks: 'OrderedDict[str, int]' = OrderedDict()  # guarded-by: self._lock
    self._max_marks = 4 * max_clients
    self._max_entries = max_entries
    self._max_bytes = max_bytes
    self._max_clients = max_clients

  def occupancy(self) -> int:
    """Live entries across every client — the exactly-once cache's
    memory pressure (exported as the ``rpc.replay_cache_entries``
    gauge; near the eviction caps = retries at risk of
    `ReplayEvictedError`)."""
    with self._lock:
      return sum(len(per) for per in self._clients.values())

  def begin(self, token: str, seq: int):
    """Returns ``(entry, fresh)`` — ``fresh`` means the caller owns
    execution; otherwise replay (wait on ``entry.done`` if needed).
    Returns ``(None, EVICTED)`` when this seq's entry was pruned —
    the caller must answer with the typed eviction error instead of
    executing."""
    with self._lock:
      per = self._clients.get(token)
      if per is None:
        per = self._clients[token] = OrderedDict()
      self._clients.move_to_end(token)
      ent = per.get(seq)
      if ent is not None:
        per.move_to_end(seq)
        return ent, False
      if seq <= self._evicted_marks.get(token, -1):
        self._evicted_marks.move_to_end(token)
        return None, self.EVICTED
      ent = per[seq] = _ReplayEntry()
      self._prune_locked(token)
      return ent, True

  def _mark_evicted_locked(self, token: str, seq: int) -> None:
    cur = self._evicted_marks.get(token, -1)
    if seq > cur:
      self._evicted_marks[token] = seq
    self._evicted_marks.move_to_end(token)
    while len(self._evicted_marks) > self._max_marks:
      self._evicted_marks.popitem(last=False)

  def _prune_locked(self, token: str) -> None:
    per = self._clients[token]
    # time horizon first: delivered frames a retry can no longer ask
    # for (any retry lands within the client's deadline) are dead
    # weight whatever the caps say
    horizon = time.monotonic() - REPLAY_RETAIN_SECS
    for s in [s for s, e in per.items()
              if e.done_at is not None and e.done_at < horizon]:
      del per[s]
      self._mark_evicted_locked(token, s)
    total = sum(len(e.frame[1]) for e in per.values()
                if e.frame is not None)
    while len(per) > self._max_entries or total > self._max_bytes:
      victim = next((s for s, e in per.items() if e.frame is not None),
                    None)
      if victim is None:            # everything in flight: never evict
        break
      total -= len(per.pop(victim).frame[1])
      self._mark_evicted_locked(token, victim)
    while len(self._clients) > self._max_clients:
      stale = next((t for t, p in self._clients.items()
                    if t != token
                    and all(e.frame is not None for e in p.values())),
                   None)
      if stale is None:
        break
      # a whole-client eviction forgets its seqs too: keep the mark so
      # a zombie client's late retry cannot re-execute either
      if self._clients[stale]:
        self._mark_evicted_locked(stale, max(self._clients[stale]))
      del self._clients[stale]


class RpcServer:
  """Threaded request server with a name->handler registry."""

  def __init__(self, host: str = '0.0.0.0', port: int = 0):
    registry: Dict[str, Callable] = {}
    self._registry = registry
    active: set = set()
    closed = [False]
    alock = threading.Lock()
    replay = _ReplayCache()
    self._active, self._alock, self._closed = active, alock, closed
    self._replay = replay
    # liveness endpoint: answered straight from the registry, so a
    # probe exercises the same accept/dispatch path real requests use
    registry['__ping__'] = lambda: {'ok': True, 'time': time.time()}

    def _serve_one(sock) -> None:
      req = recv_obj(sock)
      if len(req) == 4:
        rid, name, args, kwargs = req
      else:                         # legacy 3-tuple, no idempotency id
        rid, (name, args, kwargs) = None, req
      ent = fresh = None
      if rid is not None:
        ent, fresh = replay.begin(str(rid[0]), int(rid[1]))
        if fresh == _ReplayCache.EVICTED:
          # the reply existed once and was pruned: answering the retry
          # by re-executing would break exactly-once — a typed error
          # (resilience.ReplayEvictedError client-side) is the honest
          # outcome
          _send_frame(sock, *_encode_obj(_RemoteError(
              f'replay entry for request {rid} was evicted before the '
              'retry arrived (cache pressure: raise '
              'REPLAY_ENTRIES_PER_CLIENT or lower prefetch fan-out)',
              kind='ReplayEvictedError')))
          return
        if not fresh:
          # retried request: the first execution owns the side effect;
          # park until its reply frame lands, then replay it verbatim.
          # The park outlives every configurable wait (retry deadline,
          # server fetch deadline) so a legitimately long first
          # execution is never failed out from under its retry.
          from .resilience import default_policy, fetch_deadline
          park = max(600.0, 2 * default_policy().deadline,
                     2 * fetch_deadline())
          if not ent.done.wait(timeout=park):
            _send_frame(sock, *_encode_obj(_RemoteError(
                'original execution still in flight')))
            return
          _send_frame(sock, *ent.frame)
          return
      frame = None
      try:
        fn = registry.get(name)
        try:
          if fn is None:
            raise RpcError(f'no handler registered for {name!r}')
          result = fn(*args, **kwargs)
        except Exception as exc:    # ship the error to the caller
          result = _RemoteError(f'{type(exc).__name__}: {exc}',
                                kind=type(exc).__name__,
                                extra=_error_extra(exc))
        try:
          frame = _encode_obj(result)
        except Exception as exc:    # unencodable result: still a reply
          frame = _encode_obj(
              _RemoteError(f'reply encoding failed: {exc}'))
      finally:
        # the entry must resolve even on BaseException (thread kill,
        # interpreter shutdown) — a permanently-pending entry would
        # park every future retry of this rid until their timeouts.
        # Cache BEFORE sending: if this connection died, the retry
        # (on a fresh connection) replays the frame instead of
        # re-executing a non-idempotent handler.
        if ent is not None and not ent.done.is_set():
          if frame is None:
            frame = _encode_obj(_RemoteError(
                'execution aborted before a reply was produced'))
          ent.resolve(frame)
      _send_frame(sock, *frame)

    class Handler(socketserver.BaseRequestHandler):
      def handle(self):
        sock = self.request
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        with alock:
          if closed[0]:
            # accepted just as shutdown() snapshotted the set: self-
            # close instead of serving a "dead" server's connection
            try:
              sock.close()
            except OSError:
              pass
            return
          active.add(sock)
        try:
          while True:
            _serve_one(sock)
        except (ConnectionError, EOFError, OSError):
          return
        finally:
          with alock:
            active.discard(sock)

    class Server(socketserver.ThreadingTCPServer):
      daemon_threads = True
      allow_reuse_address = True

    self._server = Server((host, port), Handler)
    self.host, self.port = self._server.server_address
    self._thread = threading.Thread(target=self._server.serve_forever,
                                    daemon=True)
    # live ops plane: replay-cache occupancy at scrape time (latest
    # RpcServer in the process wins the gauge — one server per
    # process outside tests; shutdown() unregisters so a dead
    # server's cache isn't pinned or reported as live)
    from ..telemetry.live import live
    self._occupancy_fn = replay.occupancy
    live.gauge('rpc.replay_cache_entries', fn=self._occupancy_fn)

  def register(self, name: str, fn: Callable) -> None:
    """Reference `rpc_register` (`distributed/rpc.py:401-420`)."""
    self._registry[name] = fn

  def start(self) -> None:
    self._thread.start()

  def shutdown(self) -> None:
    """Stop accepting AND sever live connections: handler threads are
    daemons blocked in recv, so without the severing a "shut down"
    server keeps answering pooled peers indefinitely — callers (and
    failure tests) must see a dead peer as ConnectionError, not as a
    healthy endpoint."""
    from ..telemetry.live import live
    live.unregister_gauge('rpc.replay_cache_entries',
                          fn=self._occupancy_fn)
    self._server.shutdown()
    self._server.server_close()
    with self._alock:
      self._closed[0] = True
      conns = list(self._active)
    for s in conns:
      try:
        s.shutdown(socket.SHUT_RDWR)
      except OSError:
        pass
      try:
        s.close()
      except OSError:
        pass


class RpcClient:
  """Per-thread pooled connections to one server address, with the
  resilience layer on every `request`: per-attempt socket timeout,
  reset-and-reconnect on any transport fault, idempotent request ids,
  deadline-bounded seeded backoff."""

  def __init__(self, host: str, port: int, policy=None):
    self.addr = (host, port)
    self._local = threading.local()
    self._all: list = []
    self._lock = threading.Lock()
    self._policy = policy
    self._token = uuid.uuid4().hex
    self._seq = itertools.count()
    self._closed = False

  def policy(self):
    if self._policy is None:
      from .resilience import default_policy
      self._policy = default_policy()
    return self._policy

  def _sock(self, timeout: Optional[float] = None) -> socket.socket:
    s = getattr(self._local, 'sock', None)
    if s is None:
      s = socket.create_connection(self.addr,
                                   timeout=timeout or 120)
      s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
      self._local.sock = s
      with self._lock:
        self._all.append(s)
    return s

  def _drop_sock(self) -> None:
    """Sever the calling thread's connection.  A transport fault
    leaves the stream position undefined (half-read frame); the only
    safe recovery is a fresh socket."""
    s = getattr(self._local, 'sock', None)
    if s is None:
      return
    self._local.sock = None
    with self._lock:
      try:
        self._all.remove(s)
      except ValueError:
        pass
    try:
      s.close()
    except OSError:
      pass

  def _roundtrip(self, rid, name: str, args, kwargs, timeout: float,
                 faults=()) -> Any:
    """One attempt: send the request, read the reply.  Any failure —
    connect, send, timeout, severed mid-frame, misparsed reply — is
    normalized to `_TransportError` so the retry loop treats the whole
    attempt atomically (and resets the socket)."""
    from ..testing import chaos
    try:
      sock = self._sock(timeout)
      sock.settimeout(timeout)
      send_obj(sock, (rid, name, args, kwargs))
    except Exception as e:
      raise _TransportError(f'send failed: {e}') from e
    dropped = False
    for f in faults:
      if f.action == 'drop':
        # sever AFTER the send: the server may already be executing —
        # the replay cache, not a re-execution, must answer the retry
        dropped = True
        try:
          sock.shutdown(socket.SHUT_RDWR)
        except OSError:
          pass
    if dropped:
      # the attempt FAILS deterministically: on a fast loopback the
      # reply can already sit in the receive buffer when the shutdown
      # lands, and reading it would silently un-inject the fault (the
      # retry-and-replay path under test would never run)
      raise _TransportError('injected connection drop')
    try:
      kind, payload = _recv_frame(sock)
    except Exception as e:
      raise _TransportError(f'recv failed: {e}') from e
    if any(f.action == 'corrupt' for f in faults):
      payload = chaos.corrupt_payload(payload)
    try:
      return _decode_obj(kind, payload)
    except Exception as e:
      raise _TransportError(f'reply misparsed: {e}') from e

  def request(self, name: str, *args, **kwargs) -> Any:
    """Synchronous call (reference `request_server`,
    `dist_client.py:79-98`); safe from multiple threads.  Transport
    faults retry under the policy deadline with the SAME request id
    (the server-side replay cache makes the retry exactly-once);
    application errors raise `RpcError` immediately."""
    from ..telemetry.recorder import recorder
    from ..testing import chaos
    from ..utils.profiling import metrics
    from .resilience import RetryExhausted
    if self._closed:
      raise RpcError('client closed')
    policy = self.policy()
    rid = (self._token, next(self._seq))
    deadline = time.monotonic() + policy.deadline
    attempt = 0
    while True:
      faults = chaos.rpc_faults(name)
      chaos.maybe_delay(faults)
      try:
        out = self._roundtrip(rid, name, args, kwargs,
                              policy.request_timeout, faults)
      except _TransportError as e:
        self._drop_sock()
        now = time.monotonic()
        if self._closed:
          raise RpcError('client closed') from e
        if now >= deadline:
          raise RetryExhausted(
              f'{name!r} to {self.addr} failed after {attempt + 1} '
              f'attempt(s) over {policy.deadline:.1f}s: {e}') from e
        delay = min(policy.delay(attempt), max(deadline - now, 0.0))
        metrics.inc('rpc.retries')
        recorder.emit('rpc.retry', op=name, attempt=attempt,
                      addr=f'{self.addr[0]}:{self.addr[1]}',
                      error=str(e), backoff_secs=round(delay, 4))
        time.sleep(delay)
        attempt += 1
        continue
      if isinstance(out, _RemoteError):
        if getattr(out, 'kind', None) == 'ReplayEvictedError':
          # typed: the server pruned this request's reply before the
          # retry arrived — re-execution was refused to keep
          # exactly-once, so the caller must treat the request as of
          # unknown outcome (not silently get a second execution)
          from .resilience import ReplayEvictedError
          raise ReplayEvictedError(out.msg)
        raise _remote_to_error(out)
      return out

  def request_once(self, name: str, *args, timeout: float = 2.0,
                   **kwargs) -> Any:
    """One attempt on a FRESH connection, no retries, no request id —
    the liveness-probe primitive (a pooled socket may be the wedged
    thing being diagnosed)."""
    s = socket.create_connection(self.addr, timeout=timeout)
    try:
      s.settimeout(timeout)
      s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
      send_obj(s, (None, name, args, kwargs))
      out = recv_obj(s)
    finally:
      try:
        s.close()
      except OSError:
        pass
    if isinstance(out, _RemoteError):
      raise _remote_to_error(out)
    return out

  def probe(self, timeout: float = 2.0) -> bool:
    """Is the server answering its built-in ``__ping__``?  The
    slow-peer / dead-peer discriminator."""
    try:
      return bool(self.request_once('__ping__', timeout=timeout))
    except Exception:               # noqa: BLE001 — any failure = dead
      return False

  def close(self) -> None:
    self._closed = True
    with self._lock:
      for s in self._all:
        try:
          s.close()
        except OSError:
          pass
      self._all.clear()
