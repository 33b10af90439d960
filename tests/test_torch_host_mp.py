"""The mp producer path against the JAX package: one pool of two spawned
sampling workers serves every test of this module, epoch after epoch.

A batch's content is a function of ``(epoch, seq)`` only: the JAX
reference of each arrived batch is JAX's own host sampler at JAX's
batch seed ``(epoch * 1000003 + seq) * 131071`` over the seq's seed
slice of the epoch's permutation, collated by JAX's `DistLoader`; every
port batch (``device='cpu'``) is byte-equal to it.  Epoch 1 kills worker
0 before its second batch (the plan reaches the workers through
``GLT_FAULT_PLAN``): the supervisor restarts it and replays what it never
sent, and the epoch still accounts exactly.  The collate spans link to
the workers' ``producer.sample`` spans, and a snapshot taken mid-epoch
resumes to the remaining batches, byte-equal.
"""
import contextlib
import json
import os
import signal

import numpy as np
import pytest

from graphlearn_tpu import distributed as jdist
from graphlearn_tpu_torch import distributed as pdist
from graphlearn_tpu_torch.telemetry import recorder
from graphlearn_tpu_torch.testing import chaos
from graphlearn_tpu_torch.utils.checkpoint import SnapshotManager

from _torch_host_worker import ring
from test_torch_host_sampler import assert_batch_equal

N, BATCH, FANOUTS, SEED = 48, 8, [3, 2], 3
N_BATCHES = N // BATCH
KILL_PLAN = 'producer.worker:kill:2:worker=0:epoch=1:generation=0'


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


class Reference:
  """JAX's batches of an epoch, by seq."""

  def __init__(self, seeds, shuffle_seed, **loader_kw):
    self.ds = ring(jdist, N)
    self.seeds = np.asarray(seeds)
    self.rng = np.random.default_rng(shuffle_seed)
    self.sampler = jdist.HostNeighborSampler(self.ds, FANOUTS)
    self.collate = jdist.DistNeighborLoader(
        self.ds, FANOUTS, self.seeds, batch_size=BATCH, to_device=False,
        **loader_kw)

  def epoch(self, epoch):
    perm = self.rng.permutation(self.seeds)
    out = {}
    for seq in range(N_BATCHES):
      msg = self.sampler.sample_from_nodes(
          perm[seq * BATCH:(seq + 1) * BATCH],
          batch_seed=(epoch * 1000003 + seq) * 131071)
      out[seq] = self.collate._collate_fn(msg)
    return out


def _key(batch):
  s = np.asarray(batch.batch)
  return tuple(sorted(s[s >= 0].tolist()))


def match(batches, ref):
  """Every arrived batch equals JAX's batch of the same seq."""
  by_key = {_key(b): b for b in ref.values()}
  assert len(batches) == len(ref)
  for b in batches:
    assert_batch_equal(b, by_key.pop(_key(b)))
  assert not by_key


@pytest.fixture(scope='module')
def plane(tmp_path_factory):
  """The module's one pool: spawned workers inherit the kill plan (it
  fires only in epoch 1, only in the original worker 0) and a telemetry
  sink, so their spans and injected faults land in ``worker.jsonl``."""
  jsonl = str(tmp_path_factory.mktemp('mp') / 'worker.jsonl')
  saved = {k: os.environ.get(k) for k in ('GLT_FAULT_PLAN',
                                          'GLT_TELEMETRY_JSONL')}
  os.environ['GLT_FAULT_PLAN'] = KILL_PLAN
  os.environ['GLT_TELEMETRY_JSONL'] = jsonl
  chaos.uninstall()                 # this process ignores the env plan
  loader = pdist.DistNeighborLoader(
      ring(pdist, N), FANOUTS, np.arange(N), batch_size=BATCH,
      shuffle=True,
      worker_options=pdist.MpDistSamplingWorkerOptions(
          num_workers=2, mp_start_method='spawn'),
      device='cpu', seed=SEED)
  loader.RECV_POLL_SECS = 0.5
  ref = Reference(np.arange(N), SEED)
  yield loader, ref, jsonl
  loader.shutdown()
  for k, v in saved.items():
    if v is None:
      os.environ.pop(k, None)
    else:
      os.environ[k] = v


@pytest.fixture(autouse=True)
def _clean():
  recorder.enable(None)
  recorder.clear()
  with deadline(120):
    yield
  recorder.clear()
  recorder.disable()


def test_epoch0_byte_equal_to_jax(plane):
  loader, ref, _ = plane
  batches = list(loader)
  match(batches, ref.epoch(0))
  assert len(loader._seen_seqs) == N_BATCHES
  assert all(v >= 0 for v in loader.phase_secs.values())


def test_worker_kill_epoch_exact_and_byte_equal(plane):
  loader, ref, jsonl = plane
  batches = list(loader)
  match(batches, ref.epoch(1))
  assert len(loader._seen_seqs) == N_BATCHES, 'duplicate or missing #SEQ'
  restarts = recorder.events('producer.restart')
  assert restarts and restarts[0]['worker'] == 0
  assert restarts[0]['exitcode'] == chaos.WORKER_KILL_EXIT
  assert restarts[0]['replayed'] >= 1
  with open(jsonl) as f:
    kills = [json.loads(ln) for ln in f if '"fault.injected"' in ln]
  assert any(e['action'] == 'kill' and e['worker'] == 0 for e in kills)


def test_collate_spans_link_producer_spans(plane):
  loader, ref, jsonl = plane
  batches = list(loader)
  match(batches, ref.epoch(2))
  collates = [e for e in recorder.events('span.begin')
              if e['name'] == 'collate']
  assert len(collates) == N_BATCHES
  with open(jsonl) as f:
    produced = {json.loads(ln)['span_id'] for ln in f
                if '"producer.sample"' in ln and '"span.begin"' in ln}
  assert all(e.get('producer_span') in produced for e in collates)
  assert all(e.get('producer_trace') for e in collates)


def test_snapshot_resume_yields_the_rest_byte_equal(plane, tmp_path):
  loader, ref, _ = plane
  want = ref.epoch(3)
  consumed = 2
  it = iter(loader)
  first = [next(it) for _ in range(consumed)]
  snap = SnapshotManager(str(tmp_path / 'snap'), every=1)
  snap.save(loader.state_dict(), {'epoch': 3, 'next_chunk': consumed})
  # the preemption: the interrupted epoch is abandoned, its position
  # restored from the durable snapshot and the epoch resumed
  payload = SnapshotManager(str(tmp_path / 'snap')).restore_latest()
  loader.load_state_dict(payload['plane'])
  rest = list(loader.resume_epoch())
  assert consumed + len(rest) == N_BATCHES
  match(first + rest, want)
  # the next epoch is whole again: the interrupted dispatch's leftovers
  # are discarded by their epoch stamp
  match(list(loader), ref.epoch(4))
