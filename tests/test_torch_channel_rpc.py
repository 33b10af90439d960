"""The port's channels and socket RPC against the JAX package's: channel
round trips (shm across a process, mp, the remote prefetch channel's
epoch and replay discards) with the ``#SPAN`` link parked on receive,
the retry policy's schedule, the wire (a JAX client against a port
server and back), and the resilience contract of `tests/
test_resilience.py` on the port's `RpcServer` / `RpcClient`: drop,
corrupt and delay faults, a slow request answered exactly once, a dead
server, and the replay cache's eviction watermark.
"""
import contextlib
import itertools
import multiprocessing as mp
import signal
import threading
import time

import numpy as np
import pytest

from graphlearn_tpu.channel import \
    RemoteReceivingChannel as JaxRemoteReceivingChannel
from graphlearn_tpu.distributed import resilience as jax_resilience
from graphlearn_tpu.distributed import rpc as jax_rpc
from graphlearn_tpu_torch.channel import (MpChannel, RemoteReceivingChannel,
                                          ShmChannel)
from graphlearn_tpu_torch.distributed.resilience import (
    PeerLostError, ReplayEvictedError, RetryExhausted, RetryPolicy,
    reset_default_policy)
from graphlearn_tpu_torch.distributed.rpc import (RpcClient, RpcError,
                                                  RpcServer, _ReplayCache)
from graphlearn_tpu_torch.telemetry import recorder, spans
from graphlearn_tpu_torch.testing import chaos

from _torch_host_worker import produce


@contextlib.contextmanager
def deadline(secs):
  """Fail the test, not the run, if a socket or process wait hangs."""
  def fire(*_):
    raise TimeoutError(f'test exceeded {secs}s')
  old = signal.signal(signal.SIGALRM, fire)
  signal.alarm(secs)
  try:
    yield
  finally:
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture(autouse=True)
def _clean():
  reset_default_policy()
  chaos.uninstall()
  recorder.enable(None)
  recorder.clear()
  with deadline(60):
    yield
  chaos.uninstall()
  recorder.clear()
  recorder.disable()
  reset_default_policy()


# -- channels ----------------------------------------------------------------

def test_shm_channel_across_a_process_and_span_park():
  ch = ShmChannel(capacity=4, shm_size='1MB')
  assert ch.capacity == 4 and ch.slot_bytes == (1 << 20) // 4
  p = mp.get_context('spawn').Process(target=produce, args=(ch, 5),
                                      daemon=True)
  p.start()
  for i in range(5):
    out = ch.recv_timeout(30.0)
    assert out is not None and len(out['ids']) == i + 1
    assert out['val'][0, 0] == float(i)
  p.join(timeout=30)
  assert p.exitcode == 0
  # a producer's ambient span rides the message and is parked on recv
  with spans.span('producer.sample', worker=0):
    ctx = spans.current()
    ch.send({'a': np.arange(3)})
  out = ch.recv()
  assert spans.SPAN_KEY not in out
  assert ch.last_span_context == ctx
  assert spans.link_fields(ch.last_span_context) == {
      'producer_trace': ctx.trace_id, 'producer_span': ctx.span_id}
  assert ch.recv_timeout(0.05) is None and ch.occupancy() == 0
  # a message that fits only without its span context keeps the
  # message and drops the link
  small = ShmChannel(capacity=1, shm_size=4096)
  payload = {'p': np.zeros(4096 - 64, np.uint8)}
  with spans.span('producer.sample'):
    small.send(payload)
  assert small.recv()['p'].nbytes == 4096 - 64
  for c in (ch, small):
    c.close()


def test_mp_channel_roundtrip_and_timeout():
  ch = MpChannel()
  ch.send({'x': np.arange(3)})
  assert ch.recv()['x'].tolist() == [0, 1, 2]
  assert ch.recv_timeout(0.05) is None
  ch.close()


def test_remote_channel_discards_stale_epochs_and_replays():
  """Same script through the JAX channel and the port's: stale-epoch
  messages and duplicate (source, seq) replays are discarded and
  replaced, so exactly the expected unique batches come out."""
  def script():
    stream = [
        {'#EPOCH': np.int64(0), '#SEQ': np.int64(0)},   # stale
        {'#EPOCH': np.int64(1), '#SEQ': np.int64(0)},
        {'#EPOCH': np.int64(1), '#SEQ': np.int64(0)},   # replay
        {'#EPOCH': np.int64(1), '#SEQ': np.int64(1)},
        {'#EPOCH': np.int64(1), '#SEQ': np.int64(2)},
    ]
    lock = threading.Lock()

    def fetch():
      with lock:
        return dict(stream.pop(0))
    return fetch

  outs = []
  for cls in (RemoteReceivingChannel, JaxRemoteReceivingChannel):
    ch = cls(script(), num_expected=3, prefetch_size=1)
    ch.reset(3, epoch=1)
    got = [int(ch.recv()['#SEQ']) for _ in range(3)]
    with pytest.raises(StopIteration):
      ch.recv()
    outs.append((got, ch.duplicates_discarded))
    ch.close()
  assert outs[0] == outs[1] == ([0, 1, 2], 1)


# -- retry policy ------------------------------------------------------------

def test_retry_policy_schedule_matches_jax(monkeypatch):
  a = RetryPolicy(seed=7)
  b = jax_resilience.RetryPolicy(seed=7)
  assert [a.delay(i) for i in range(12)] == [b.delay(i) for i in range(12)]
  monkeypatch.setenv('GLT_RPC_TIMEOUT', '3')
  monkeypatch.setenv('GLT_RPC_DEADLINE', '9')
  monkeypatch.setenv('GLT_RPC_BACKOFF_BASE', '0.2')
  monkeypatch.setenv('GLT_RPC_RETRY_SEED', '5')
  p, q = RetryPolicy.from_env(), jax_resilience.RetryPolicy.from_env()
  assert (p.request_timeout, p.deadline, p.base_delay, p.seed) == \
      (q.request_timeout, q.deadline, q.base_delay, q.seed) == \
      (3.0, 9.0, 0.2, 5)
  assert issubclass(RetryExhausted, RpcError)
  assert issubclass(PeerLostError, RpcError)
  assert issubclass(ReplayEvictedError, RpcError)
  e = PeerLostError('x', peer=3, received=1, expected=4, outstanding=2)
  assert (e.peer, e.received, e.expected, e.outstanding) == (3, 1, 4, 2)


# -- rpc -----------------------------------------------------------------------

def _fast_policy(**kw):
  kw.setdefault('request_timeout', 2.0)
  kw.setdefault('deadline', 6.0)
  kw.setdefault('base_delay', 0.01)
  kw.setdefault('max_delay', 0.05)
  kw.setdefault('seed', 7)
  return RetryPolicy(**kw)


def _serve(cls):
  srv = cls('127.0.0.1', 0)
  calls = []
  lock = threading.Lock()

  def bump(tag='x'):
    with lock:
      calls.append(tag)
    return len(calls)

  srv.register('bump', bump)
  srv.register('echo', lambda v: v)
  srv.register('slow', lambda secs: (time.sleep(secs), bump('slow'))[1])
  srv.register('boom', lambda: 1 / 0)
  srv.start()
  srv.calls = calls
  return srv


@pytest.fixture
def server():
  srv = _serve(RpcServer)
  yield srv
  srv.shutdown()


def test_wire_is_the_jax_package_wire():
  """A JAX client talks to a port server and a port client to a JAX
  server: frames, request ids and the tensor-map payloads are one
  format.  (A handler's error travels as each package's own pickled
  error class, so errors are typed within one package only.)"""
  msg = {'ids': np.arange(5), 'x': np.ones((2, 3), np.float32)}
  for srv_cls, cli_cls in ((RpcServer, jax_rpc.RpcClient),
                           (jax_rpc.RpcServer, RpcClient)):
    srv = _serve(srv_cls)
    cli = cli_cls('127.0.0.1', srv.port, policy=_fast_policy())
    try:
      out = cli.request('echo', msg)
      assert out['ids'].tolist() == list(range(5))
      assert out['x'].tobytes() == msg['x'].tobytes()
      assert cli.request('echo', [1, 'a']) == [1, 'a']
      assert cli.request('bump') == 1 and cli.probe()
    finally:
      cli.close()
      srv.shutdown()


def test_basic_roundtrip_probe_and_application_error(server):
  cli = RpcClient('127.0.0.1', server.port, policy=_fast_policy())
  assert cli.request('echo', {'a': 1}) == {'a': 1}
  assert cli.probe()
  with pytest.raises(RpcError, match='ZeroDivisionError') as ei:
    cli.request('boom')
  assert ei.value.remote_kind == 'ZeroDivisionError'
  assert not recorder.events('rpc.retry'), \
      'application errors must not burn retry budget'
  cli.close()
  with pytest.raises(RpcError):
    cli.request('echo', 1)        # closed clients refuse, not hang


def test_drop_fault_retries_without_double_execution(server):
  cli = RpcClient('127.0.0.1', server.port, policy=_fast_policy())
  assert cli.request('bump') == 1
  chaos.install({'faults': [{'site': 'rpc.request', 'action': 'drop',
                             'nth': 1, 'op': 'bump'}]})
  assert cli.request('bump') == 2, 'answered from the replay cache'
  assert len(server.calls) == 2, 'handler must NOT run twice'
  retries = recorder.events('rpc.retry')
  assert retries and retries[0]['op'] == 'bump'
  injected = recorder.events('fault.injected')
  assert injected and injected[0]['action'] == 'drop'
  cli.close()


def test_corrupt_reply_resets_and_delay_sleeps(server):
  cli = RpcClient('127.0.0.1', server.port, policy=_fast_policy())
  chaos.install('rpc.request:corrupt:1:op=echo;'
                'rpc.request:delay:3:op=echo:secs=0.3')
  assert cli.request('echo', [1, 2, 3]) == [1, 2, 3]
  assert recorder.events('rpc.retry')
  t0 = time.monotonic()
  assert cli.request('echo', 'after') == 'after'   # arrival 3: delayed
  assert time.monotonic() - t0 >= 0.3
  assert chaos.active().exhausted()
  cli.close()


def test_slow_request_times_out_but_runs_exactly_once(server):
  cli = RpcClient('127.0.0.1', server.port,
                  policy=_fast_policy(request_timeout=0.4, deadline=8.0))
  assert cli.request('slow', 1.2) == 1
  assert server.calls == ['slow'], 'slow handler must run exactly once'
  assert recorder.events('rpc.retry')
  cli.close()


def test_dead_server_retry_exhausted_probe_false_and_reconnect():
  srv = _serve(RpcServer)
  port = srv.port
  cli = RpcClient('127.0.0.1', port,
                  policy=_fast_policy(deadline=1.0, request_timeout=0.5))
  assert cli.request('echo', 1) == 1
  srv.shutdown()
  with pytest.raises(RetryExhausted):
    cli.request('echo', 2)
  assert not cli.probe(timeout=0.5)
  # the same address back within a longer deadline: a transparent
  # reconnect rides out the outage
  cli._policy = _fast_policy(deadline=10.0, request_timeout=0.5)
  box = {}

  def resurrect():
    time.sleep(0.6)
    box['srv'] = s2 = RpcServer('127.0.0.1', port)
    s2.register('echo', lambda v: v)
    s2.start()

  t = threading.Thread(target=resurrect)
  t.start()
  assert cli.request('echo', 'back') == 'back'
  t.join()
  cli.close()
  box['srv'].shutdown()


def test_replay_cache_eviction_watermark_and_typed_error(server):
  cache = _ReplayCache(max_entries=2)
  for seq in range(4):
    ent, fresh = cache.begin('tok', seq)
    assert fresh is True
    ent.resolve((1, b'x' * 8))
  assert cache.begin('tok', 0) == (None, _ReplayCache.EVICTED)
  ent, fresh = cache.begin('tok', 3)
  assert fresh is False and ent.frame is not None
  assert cache.begin('tok', 9)[1] is True
  # end to end: a zombie retry of an evicted request id is refused typed
  cli = RpcClient('127.0.0.1', server.port, policy=_fast_policy())
  assert cli.request('bump') == 1
  server._replay._max_entries = 1
  assert cli.request('bump') == 2
  executed = len(server.calls)
  cli._seq = itertools.count(0)
  with pytest.raises(ReplayEvictedError, match='evicted'):
    cli.request('bump')
  assert len(server.calls) == executed
  cli.close()


def test_server_shutdown_diagnostics_and_heartbeat():
  from graphlearn_tpu_torch.distributed.dist_server import DistServer
  srv = DistServer(dataset=None)
  srv.rank, srv.num_clients = 2, 3
  srv.notify_leave(1)
  assert srv.heartbeat()['producers'] == {}
  assert srv.wait_for_exit(timeout=0.05) is False
  evs = recorder.events('server.shutdown_timeout')
  assert len(evs) == 1 and evs[0]['clients_never_exited'] == [0, 2]
  assert evs[0]['clients_left'] == [1] and evs[0]['rank'] == 2
