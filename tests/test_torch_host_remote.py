"""The server–client plane against the JAX package: a spawned port
sampling server feeds a remote `DistNeighborLoader` (its one producer
pool serves every epoch of this module), and an in-process port server
answers the serve RPC, as `tests/test_serving_rpc.py` pins it for JAX.

Remote epochs are byte-equal, batch for batch, to JAX's batches of the
same ``(epoch, seq)`` (see `test_torch_host_mp`).  The chaos epoch kills
a server-side worker, drops two fetch replies and delays another: the
epoch still receives exactly the expected unique batches.  The serve
RPC answers JAX's engine (the port engine replays JAX's draws: nodes
byte-equal, logits within ``rtol=atol=1e-5``), stays exactly-once under
dropped connections, carries its ``serving.rpc`` span under the router's
root, resurfaces admission and swap errors typed, and swaps parameters
sent as numpy over the wire (parity probe ``atol=1e-4``, `hot_swap`'s).
"""
import contextlib
import multiprocessing as mp
import signal

import jax
import numpy as np
import pytest
import torch

from graphlearn_tpu.models.tree import TreeSAGE as FlaxTreeSAGE
from graphlearn_tpu.serving import ServingEngine as JaxServingEngine
from graphlearn_tpu_torch import distributed as pdist
from graphlearn_tpu_torch.distributed.resilience import reset_default_policy
from graphlearn_tpu_torch.distributed.rpc import RpcError
from graphlearn_tpu_torch.models import TreeSAGE, tree_sage_from_flax
from graphlearn_tpu_torch.serving import (AdmissionRejected, FleetRouter,
                                          LocalReplica, RemoteReplica,
                                          ServingEngine, ServingFrontend)
from graphlearn_tpu_torch.serving.swap import SwapValidationError
from graphlearn_tpu_torch.telemetry import recorder, tracer
from graphlearn_tpu_torch.testing import chaos

from _torch_host_worker import sampling_server
from test_torch_host_mp import N, N_BATCHES, BATCH, FANOUTS, SEED
from test_torch_host_mp import Reference, match
from test_torch_serving import (BUCKETS, SEEDS, _jax_dataset,
                                _port_dataset, jax_replay_draws)
from test_torch_serving import FANOUTS as S_FANOUTS
from test_torch_serving import SEED as S_SEED

KILL_PLAN = 'producer.worker:kill:2:worker=0:epoch=1:generation=0'
SAMPLING, SERVING = 0, 1          # the client's server indices


@contextlib.contextmanager
def deadline(secs):
  def fire(*_):
    raise TimeoutError(f'test exceeded {secs}s')
  old = signal.signal(signal.SIGALRM, fire)
  signal.alarm(secs)
  try:
    yield
  finally:
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


class _StubHostDataset:
  """The serving server never builds a producer: a shape-only dataset."""
  num_nodes = 64
  num_edges = 256
  node_features = None
  node_labels = None


@pytest.fixture(scope='module')
def cluster(tmp_path_factory):
  jsonl = str(tmp_path_factory.mktemp('remote') / 'server.jsonl')
  ctx = mp.get_context('spawn')
  port_q = ctx.Queue()
  proc = ctx.Process(target=sampling_server,
                     args=(port_q, N, jsonl, KILL_PLAN), daemon=False)
  proc.start()
  # the serving server: in this process, a model engine replaying JAX's
  # draws, its parameters carried over from JAX's
  flax_model = FlaxTreeSAGE(hidden_features=8, out_features=5,
                            num_layers=len(S_FANOUTS))
  jeng = JaxServingEngine(_jax_dataset(), S_FANOUTS, model=flax_model,
                          seed=S_SEED, buckets=BUCKETS)
  flax_params = jax.tree_util.tree_map(
      np.asarray, jeng.init_params(jax.random.key(0)))

  def port_frontend(name):
    eng = ServingEngine(_port_dataset(), S_FANOUTS,
                        model=TreeSAGE(6, 8, 5, len(S_FANOUTS)),
                        params=tree_sage_from_flax(flax_params),
                        seed=S_SEED, buckets=BUCKETS, device='cpu',
                        draws=jax_replay_draws(S_SEED))
    return ServingFrontend(eng, auto_start=True, warmup=True,
                           max_wait_ms=1.0, default_deadline_ms=4000.0,
                           name=name)

  frontend = port_frontend('remote')
  srv = pdist.init_server(num_servers=1, num_clients=1, rank=0,
                          dataset=_StubHostDataset(), host='127.0.0.1',
                          port=0)
  srv.attach_serving(frontend)
  port = port_q.get(timeout=120)
  client = pdist.init_client(
      [('127.0.0.1', port), ('127.0.0.1', srv.port)], rank=0, num_clients=1)
  loader = pdist.DistNeighborLoader(
      None, FANOUTS, np.arange(N), batch_size=BATCH, shuffle=True,
      worker_options=pdist.RemoteDistSamplingWorkerOptions(
          server_rank=SAMPLING, num_workers=2, prefetch_size=1),
      device='cpu', seed=SEED)
  loader.RECV_POLL_SECS = 0.5
  box = dict(loader=loader, ref=Reference(np.arange(N), SEED), jeng=jeng,
             flax_params=flax_params, frontend=frontend, client=client,
             jsonl=jsonl, port_frontend=port_frontend)
  yield box
  loader.shutdown()
  client.shutdown()                 # notify_leave + exit to both servers
  pdist.wait_and_shutdown_server(timeout=10)
  proc.join(timeout=60)
  if proc.is_alive():
    proc.terminate()
  assert proc.exitcode == 0, 'the sampling server must exit cleanly'


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
  monkeypatch.setenv('GLT_RPC_TIMEOUT', '10')
  monkeypatch.setenv('GLT_RPC_DEADLINE', '30')
  monkeypatch.setenv('GLT_RPC_BACKOFF_BASE', '0.02')
  reset_default_policy()
  chaos.uninstall()
  recorder.enable(None)
  recorder.clear()
  with deadline(120):
    yield
  chaos.uninstall()
  recorder.clear()
  recorder.disable()
  reset_default_policy()


# -- the sampling plane --------------------------------------------------------

def test_remote_epoch_byte_equal_to_jax(cluster):
  loader = cluster['loader']
  match(list(loader), cluster['ref'].epoch(0))
  assert len(loader.channel._seen_seqs) == N_BATCHES
  meta = cluster['client'].get_dataset_meta(SAMPLING)
  assert meta == {'hetero': False, 'num_nodes': N, 'num_edges': 3 * N,
                  'feature_dim': 4, 'has_labels': True}


def test_chaos_epoch_accounts_exactly(cluster):
  """Worker 0 dies server-side before its second batch (epoch 1), the
  2nd fetch's connection drops after the send, the 4th is delayed past
  the poll: received = expected = unique seqs, each batch JAX's."""
  loader = cluster['loader']
  chaos.install('rpc.request:drop:2:op=fetch_one_sampled_message;'
                'rpc.request:delay:4:op=fetch_one_sampled_message:'
                'secs=0.8')
  batches = list(loader)
  assert chaos.active().exhausted(), 'every planned fault must fire'
  match(batches, cluster['ref'].epoch(1))
  assert len(loader.channel._seen_seqs) == N_BATCHES
  retries = recorder.events('rpc.retry')
  assert retries and all(e['op'] == 'fetch_one_sampled_message'
                         for e in retries)
  hb = cluster['client'].heartbeat(SAMPLING)
  assert hb is not None and list(hb['producers'].values())[0][
      'alive_workers'] == 2
  with open(cluster['jsonl']) as f:
    server_events = f.read()
  assert '"kind": "producer.restart"' in server_events
  assert '"kind": "fault.injected"' in server_events
  chaos.uninstall()
  match(list(loader), cluster['ref'].epoch(2))     # fault-free again


# -- the serve RPC ---------------------------------------------------------------

def test_serve_roundtrip_matches_jax_offline(cluster):
  client, jeng = cluster['client'], cluster['jeng']
  out = client.serve(SEEDS, server_idx=SERVING)
  ref = jeng.offline_reference(SEEDS)
  assert out['nodes'].tobytes() == np.asarray(ref.nodes).tobytes()
  np.testing.assert_allclose(out['logits'], np.asarray(ref.logits),
                             rtol=1e-5, atol=1e-5)
  hb = client.heartbeat(SERVING)
  assert hb['serving']['served_requests'] >= 1
  assert hb['serving']['queue_depth'] == 0


def test_serve_exactly_once_under_drop_and_typed_errors(cluster):
  client, frontend = cluster['client'], cluster['frontend']
  before = frontend.admission.stats()['admitted']
  chaos.install('rpc.request:drop:1:op=serve_infer')
  out = client.serve([7, 11], server_idx=SERVING)
  assert chaos.active().exhausted()
  assert recorder.events('rpc.retry')[0]['op'] == 'serve_infer'
  assert frontend.admission.stats()['admitted'] - before == 1, \
      'the retried request must not execute twice'
  ref = frontend.engine.offline_reference([7, 11])
  assert out['nodes'].tobytes() == ref.nodes.tobytes()
  chaos.uninstall()
  with pytest.raises(AdmissionRejected):
    client.serve(list(range(BUCKETS[-1] + 1)), server_idx=SERVING)
  chaos.install('serving.request:drop:1:op=serve_infer')
  with pytest.raises(RpcError) as ei:
    client.serve([3], server_idx=SERVING)
  assert ei.value.remote_kind == 'InjectedFault'
  chaos.uninstall()
  frontend.admission.set_draining(True)
  try:
    with pytest.raises(AdmissionRejected) as ei:
      client.serve([3], server_idx=SERVING)
    assert ei.value.reason == 'draining' and ei.value.retry_after_ms > 0
  finally:
    frontend.admission.set_draining(False)


def test_router_remote_and_local_replicas_traced(cluster):
  """A FleetRouter over one RemoteReplica and one LocalReplica answers
  every request as the offline reference; a traced request's
  ``serving.rpc`` span sits under the router's root."""
  client, frontend = cluster['client'], cluster['frontend']
  local = cluster['port_frontend']('local')
  router = FleetRouter([RemoteReplica('remote', client, SERVING),
                        LocalReplica('local', local)], auto_start=False)
  tracer.configure(sample=1, slow_ms=0.0, buffer=64)
  tracer.clear()
  try:
    futs = [router.submit(np.array([s])) for s in (3, 5, 17, 40)]
    for s, f in zip((3, 5, 17, 40), futs):
      got = f.result(30.0)
      ref = frontend.engine.offline_reference([s])
      assert np.asarray(got.nodes).tobytes() == ref.nodes.tobytes()
      np.testing.assert_allclose(got.logits, ref.logits, rtol=1e-5,
                                 atol=1e-5)
    assert router.stats()['submitted'] == 4
    rpc_spans = []
    for t in tracer.traces():
      spans = {s['name']: s for s in tracer.spans_of(t['trace_id'])}
      if 'serving.rpc' in spans:
        root, rpc_span = spans['serving.route'], spans['serving.rpc']
        assert rpc_span['parent_id'] == root['span_id'] == t['trace_id']
        assert spans['serving.queue_wait']['parent_id'] == \
            rpc_span['span_id']
        rpc_spans.append(rpc_span)
    assert rpc_spans, 'the remote replica served no traced request'
  finally:
    tracer.configure(sample=0)
    router.close()
    local.shutdown()


def test_swap_over_the_wire(cluster):
  client, frontend = cluster['client'], cluster['frontend']
  v0 = frontend.engine.model_version
  out = client.swap_model(cluster['flax_params'], server_idx=SERVING)
  assert out['version'] == v0 + 1 and out['parity_max_err'] <= 1e-4
  state = {k: v.clone() * 0.5 for k, v in
           tree_sage_from_flax(cluster['flax_params']).items()}
  out = client.swap_model(state, server_idx=SERVING, version=7)
  assert out['version'] == 7 and frontend.engine.model_version == 7
  got = client.serve([5], server_idx=SERVING)
  ref = frontend.engine.offline_reference([5])
  np.testing.assert_allclose(got['logits'], ref.logits, rtol=1e-5,
                             atol=1e-5)
  bad = dict(state)
  bad[next(iter(bad))] = torch.zeros(3, 3)
  with pytest.raises(SwapValidationError):
    client.swap_model(bad, server_idx=SERVING)
  assert frontend.engine.model_version == 7
