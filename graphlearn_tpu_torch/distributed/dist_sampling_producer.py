"""Sampling producers: subprocess pool + collocated twin.

The JAX package's `distributed/dist_sampling_producer.py`; reference
`distributed/dist_sampling_producer.py:52-328`:
``DistMpSamplingProducer`` spawns N sampling workers which consume
SAMPLE_ALL commands from a task queue, iterate their seed slice, and
push messages into the shm channel; ``DistCollocatedSamplingProducer``
does the same synchronously in-process.  The workers are numpy/native-
only: they never touch torch tensors or CUDA.

Start method: ``forkserver`` by default — workers descend from a clean
server process with no CUDA context (a fork after the trainer has
initialised CUDA is unsafe), and the dataset crosses the boundary
through POSIX shared memory (`shm_arrays.share_dataset`: one copy at
init, zero per worker).  ``fork`` remains opt-in via
``MpDistSamplingWorkerOptions.mp_start_method`` for callers whose
parent process has not initialised CUDA and is single-threaded at spawn
time (the copy-on-write zero-copy path); safety invariant documented
there.
"""
from __future__ import annotations

import enum
import multiprocessing as mp
import queue as queue_mod
import threading
from typing import List, Optional, Sequence

import numpy as np

from ..channel.base import ChannelBase
from .dist_options import MpDistSamplingWorkerOptions
from .host_dataset import HostDataset, HostHeteroDataset
from .host_sampler import HostHeteroNeighborSampler, HostNeighborSampler


class MpCommand(enum.Enum):
  SAMPLE_ALL = 0
  STOP = 1


def _make_sampler(dataset, fanouts, with_edge, collect_features, seed,
                  peer_addrs=None):
  """Homo/hetero host sampler by dataset kind.  A SHARD dataset with
  ``peer_addrs`` needs the cross-server sampler of the partitioned
  plane (port slice 25)."""
  if (getattr(dataset, 'node_pb', None) is not None
      and peer_addrs is not None):
    raise NotImplementedError(
        'cross-server host sampling (HostDistNeighborSampler over peer '
        'partition services) comes with the partitioned host plane, port '
        'slice 25')
  cls = (HostHeteroNeighborSampler
         if isinstance(dataset, HostHeteroDataset) else HostNeighborSampler)
  return cls(dataset, fanouts, with_edge=with_edge,
             collect_features=collect_features, seed=seed)


def _dispatch_sample(sampler, cfg, seeds_slice, batch_seed: int):
  """NODE/LINK/SUBGRAPH dispatch (reference `SamplingType` switch in
  `_sampling_worker_loop`, `dist_sampling_producer.py:110-135`)."""
  hetero = isinstance(sampler, HostHeteroNeighborSampler)
  if hetero and (cfg is None or cfg.input_type is None):
    raise ValueError(
        'hetero sampling needs a HostSamplingConfig with input_type '
        '(the seed node type, or the seed edge type in link mode)')
  if cfg is None or cfg.sampling_type == 'node':
    if hetero:
      return sampler.sample_from_nodes(cfg.input_type, seeds_slice,
                                       batch_seed=batch_seed)
    return sampler.sample_from_nodes(seeds_slice, batch_seed=batch_seed)
  if cfg.sampling_type == 'link':
    label = seeds_slice[:, 2] if seeds_slice.shape[1] > 2 else None
    if hetero:
      return sampler.sample_from_edges(
          cfg.input_type, seeds_slice[:, 0], seeds_slice[:, 1],
          label=label, neg_mode=cfg.neg_mode, neg_amount=cfg.neg_amount,
          batch_seed=batch_seed)
    return sampler.sample_from_edges(
        seeds_slice[:, 0], seeds_slice[:, 1], label=label,
        neg_mode=cfg.neg_mode, neg_amount=cfg.neg_amount,
        batch_seed=batch_seed)
  if cfg.sampling_type == 'subgraph':
    if hetero:
      # the reference's SubGraphOp is homogeneous-only
      # (`include/subgraph_op_base.h`); same boundary here
      raise ValueError('subgraph sampling is homogeneous-only')
    return sampler.sample_subgraph(seeds_slice, batch_seed=batch_seed)
  raise ValueError(f'unknown sampling_type {cfg.sampling_type!r}')


def _sampling_worker_loop(rank, dataset, fanouts, with_edge,
                          collect_features, channel, task_queue, seed,
                          sampling_config=None, progress_queue=None,
                          generation=0):
  """Body of one sampling subprocess (reference `_sampling_worker_loop`,
  `dist_sampling_producer.py:52-144`)."""
  from .shm_arrays import SharedDatasetHandle
  segs = None
  if isinstance(dataset, SharedDatasetHandle):
    # non-fork start: attach zero-copy shm views; hold the segments
    # for the process lifetime
    dataset, segs = dataset.materialize()  # noqa: F841 — keepalive
  sampler = _make_sampler(dataset, fanouts, with_edge, collect_features,
                          seed * 7919 + rank,
                          peer_addrs=getattr(sampling_config,
                                             'peer_addrs', None))
  while True:
    try:
      cmd, payload = task_queue.get(timeout=5.0)
    except queue_mod.Empty:
      continue
    if cmd == MpCommand.STOP:
      break
    seeds, batch_size, epoch, seqs = payload
    from ..telemetry.spans import span
    from ..testing import chaos
    for i, lo in enumerate(range(0, len(seeds), batch_size)):
      # fault-plan seam: a planned 'kill' hard-exits here, between
      # batches — the supervisor must restart us and replay what we
      # never delivered (the chaos suite's central scenario).  The
      # progress queue rides `flush` so acks for batches the channel
      # already holds survive the exit (see `worker_kill_check`).
      chaos.worker_kill_check(
          rank, epoch, generation,
          flush=(progress_queue,) if progress_queue is not None
          else ())
      # the producer-side span covers sample + send; the channel
      # injects its context into the message at send time, so the
      # consumer's collate span can link back to THIS trace (the
      # worker's recorder comes up via GLT_TELEMETRY_JSONL, which
      # spawn/forkserver children inherit)
      seq = int(seqs[i])
      with span('producer.sample', worker=rank, epoch=epoch,
                offset=lo):
        # batch content is a function of (epoch, seq) ONLY — a batch
        # replayed after a worker restart (possibly from a different
        # offset) is byte-identical to the original, so consumer-side
        # '#SEQ' dedup keeps epoch content exact under faults
        msg = _dispatch_sample(
            sampler, sampling_config, seeds[lo:lo + batch_size],
            batch_seed=(epoch * 1000003 + seq) * 131071)
        # Epoch stamp lets consumers discard stale messages after an
        # early-terminated epoch (`DistLoader._recv_current_epoch`);
        # the seq stamp is the per-batch identity replay dedup keys on.
        msg['#EPOCH'] = np.int64(epoch)
        msg['#SEQ'] = np.int64(seq)
        channel.send(msg)
      if progress_queue is not None:
        # progress ack AFTER the durable channel send: the channel
        # outlives us, so a sent batch never needs replay — the
        # supervisor replays only what sits between the last ack and
        # the crash (consumer-side '#SEQ' dedup absorbs the overlap)
        try:
          progress_queue.put((epoch, rank, seq))
        except Exception:           # noqa: BLE001 — teardown race
          pass


class MpSamplingProducer:
  """N sampling subprocesses feeding ``channel``.

  Reference ``DistMpSamplingProducer`` (`dist_sampling_producer.py:
  147-260`): per-epoch ``produce_all`` splits the shuffled seed set
  into per-worker, batch-aligned ranges.
  """

  def __init__(self, dataset: HostDataset, num_neighbors: Sequence[int],
               batch_size: int, channel: ChannelBase,
               options: Optional[MpDistSamplingWorkerOptions] = None,
               with_edge: bool = False, shuffle: bool = False,
               seed: int = 0, sampling_config=None):
    self.opts = options or MpDistSamplingWorkerOptions()
    self.ds = dataset
    # keep dict-valued (per-edge-type) fanouts intact
    self.fanouts = (dict(num_neighbors) if isinstance(num_neighbors, dict)
                    else list(num_neighbors))
    self.batch_size = int(batch_size)
    self.channel = channel
    self.with_edge = with_edge
    self.shuffle = shuffle
    self.sampling_config = sampling_config
    self._rng = np.random.default_rng(seed)
    self._seed = seed
    self._epoch = 0
    self._ctx = mp.get_context(self.opts.mp_start_method)
    self._task_queues: List = []
    self._workers: List = []
    self.current_epoch = -1      # stamp of the last dispatched epoch
    # supervision state: per-worker assignment ledger for the CURRENT
    # epoch ({rank: (seed_slice, seq_stamps)}), workers declared
    # irrecoverable, and the restart budget consumed so far
    self._assignments: dict = {}   # guarded-by: self._sup_lock
    self._lost: set = set()        # guarded-by: self._sup_lock
    self._restarts = 0             # guarded-by: self._sup_lock
    # worker progress acks, this epoch  # guarded-by: self._sup_lock
    self._sent_seqs: set = set()
    self._progress = None
    self._generations: dict = {}   # rank -> restart count
    # staged peer-lost bundle context  # guarded-by: self._sup_lock
    self._pending_postmortem: Optional[dict] = None
    # one supervisor at a time: the server runtime calls supervise()
    # from one RPC handler thread per in-flight fetch — without the
    # lock two threads can both restart the same dead worker (orphaned
    # duplicate process, double-billed restart budget)
    self._sup_lock = threading.Lock()

  def _spawn_worker(self, rank: int):
    tq = self._ctx.Queue()
    w = self._ctx.Process(
        target=_sampling_worker_loop,
        args=(rank, self._ds_arg, self.fanouts, self.with_edge,
              self.opts.collect_features, self.channel, tq, self._seed,
              self.sampling_config, self._progress,
              self._generations.get(rank, 0)),
        daemon=True)
    w.start()
    return tq, w

  def init(self) -> None:
    ds_arg = self.ds
    self._shm_segs = None
    if self._ctx.get_start_method() == 'forkserver':
      # the server imports the sampling code (torch included, never
      # CUDA) once, before its first fork: a worker, and a restarted
      # one, starts sampling at once instead of importing it again.
      # No effect when this process's server already runs.
      self._ctx.set_forkserver_preload(['__main__', __name__])
    if self._ctx.get_start_method() != 'fork':
      # stage the dataset into POSIX shm once; workers attach
      # zero-copy instead of unpickling a full copy each
      from .shm_arrays import share_dataset
      ds_arg, self._shm_segs = share_dataset(self.ds)
    self._ds_arg = ds_arg          # kept: restarts respawn from it
    self._progress = self._ctx.Queue()
    for r in range(self.opts.num_workers):
      tq, w = self._spawn_worker(r)
      self._task_queues.append(tq)
      self._workers.append(w)

  def num_batches(self, num_seeds: int) -> int:
    return (num_seeds + self.batch_size - 1) // self.batch_size

  def fast_forward(self, seeds: np.ndarray, epoch: int) -> None:
    """Advance this producer's epoch counter AND its shuffle RNG to
    ``epoch`` by drawing (and discarding) the skipped permutations —
    the partition-adoption path: a producer recreated on a
    survivor mid-run must produce epoch ``e`` byte-identical to what
    the dead server's producer would have (batch content is a
    function of (epoch, seq) + the epoch's permutation, and the
    permutation is the ``epoch``-th draw from the seeded stream)."""
    seeds = np.asarray(seeds)
    while self._epoch < int(epoch):
      if self.shuffle:
        self._rng.permutation(seeds)     # axis-0, node AND link mode
      self._epoch += 1

  def produce_all(self, seeds: np.ndarray, drop_last: bool = False,
                  epoch: Optional[int] = None) -> int:
    """Dispatch one epoch; returns the number of messages to expect.
    ``drop_last`` truncates *after* the shuffle, so the dropped
    remainder differs per epoch (torch DataLoader semantics).
    ``seeds`` is ``[E]`` node ids, or ``[E, 2|3]`` edge pairs
    (+labels) in link mode — shuffling/slicing is along axis 0.
    ``epoch`` fast-forwards a freshly created producer to that epoch
    before producing (`fast_forward` — the adoption path)."""
    from ..utils.checkpoint import pack_rng_state
    seeds = np.asarray(seeds)
    if seeds.ndim == 1:
      seeds = seeds.reshape(-1)
    if epoch is not None:
      self.fast_forward(seeds, epoch)
    # pre-shuffle RNG capture: a mid-epoch snapshot restores THIS
    # state so the resumed produce_all re-draws the same permutation
    # (batch content is a function of (epoch, seq) — identical shuffle
    # + identical stamps = byte-identical replays)
    self._pre_epoch_rng = pack_rng_state(self._rng)
    if self.shuffle:
      seeds = self._rng.permutation(seeds)
    if drop_last:
      seeds = seeds[:(len(seeds) // self.batch_size) * self.batch_size]
    with self._sup_lock:
      return self._produce_all_locked(seeds)

  def _produce_all_locked(self, seeds: np.ndarray) -> int:
    # under _sup_lock: the server runtime can run supervise() from a
    # fetch handler thread concurrently with a start-epoch RPC — an
    # unlocked respawn here would race it (duplicate replacement
    # workers, a replayed task enqueued on a queue this method is
    # about to replace)
    # an epoch boundary is a recovery point: workers that died late in
    # the previous epoch respawn BEFORE this epoch's assignments go
    # out (their queues would otherwise hold work no one ever does),
    # and the restart budget + lost set reset — the budget bounds
    # crash-looping within one epoch, not uptime across a long run
    self._restarts = 0
    self._lost.clear()
    for r, w in enumerate(self._workers):
      if not w.is_alive():
        from ..telemetry.recorder import recorder
        self._generations[r] = self._generations.get(r, 0) + 1
        tq, proc = self._spawn_worker(r)
        self._task_queues[r] = tq
        self._workers[r] = proc
        recorder.emit('producer.restart', worker=r, exitcode=w.exitcode,
                      replayed=0, restarts=self._restarts,
                      budget=None, at='epoch_boundary')
        from ..utils.profiling import metrics
        metrics.inc('producer.restarts_total')
    nw = max(len(self._workers), 1)
    # batch-aligned contiguous slices (reference `:249-260`)
    n_batches = self.num_batches(len(seeds))
    per_worker = ((n_batches + nw - 1) // nw) * self.batch_size
    batches_per_worker = per_worker // self.batch_size
    self._assignments = {}
    for r, tq in enumerate(self._task_queues):
      sl = seeds[r * per_worker:(r + 1) * per_worker]
      if len(sl):
        # '#SEQ' stamps: the global batch index of each batch in this
        # slice — the identity supervision replays and consumers
        # dedup on (unique within the epoch by construction)
        seqs = [r * batches_per_worker + i
                for i in range(self.num_batches(len(sl)))]
        self._assignments[r] = (sl, seqs)
        tq.put((MpCommand.SAMPLE_ALL,
                (sl, self.batch_size, self._epoch, seqs)))
    self.current_epoch = self._epoch
    self._epoch += 1
    self._sent_seqs = set()
    self._drain_progress()          # discard stale prior-epoch acks
    return n_batches

  def _drain_progress(self) -> None:
    """Fold worker progress acks for the CURRENT epoch into
    ``_sent_seqs`` (acks are ``(epoch, rank, seq)`` put after each
    durable channel send)."""
    # called from _produce_all_locked/_supervise_locked only
    # glint: holds=self._sup_lock
    if self._progress is None:
      return
    while True:
      try:
        ep, _, s = self._progress.get_nowait()
      except queue_mod.Empty:
        return
      except (OSError, ValueError):
        return                      # queue tearing down
      if ep == self.current_epoch:
        self._sent_seqs.add(s)

  def alive_workers(self) -> int:
    """Liveness probe (the reference's 5s MP_STATUS_CHECK_INTERVAL
    watchdog, `dist_sampling_producer.py:39-41`): consumers use this
    to fail loudly instead of blocking forever on a channel no one
    will ever fill."""
    return sum(1 for w in self._workers if w.is_alive())

  def dead_worker_exitcodes(self):
    return [w.exitcode for w in self._workers if not w.is_alive()]

  def health(self) -> dict:
    """Supervision state for `/healthz`: ``healthy`` means every
    spawned worker is currently alive and none is declared
    irrecoverable — a dead-but-restartable worker reads unhealthy
    until `supervise` replaces it (exactly the during-the-incident
    signal a liveness prober wants)."""
    alive = self.alive_workers()
    with self._sup_lock:
      lost, restarts = sorted(self._lost), self._restarts
    return {'healthy': alive == len(self._workers) and not lost,
            'alive_workers': alive,
            'num_workers': len(self._workers),
            'dead_exitcodes': self.dead_worker_exitcodes(),
            'lost_workers': lost,
            'restarts': restarts}

  def _unacked(self, rank: int, acked_seqs=None):
    """The (seed_slice, seqs) of ``rank``'s current-epoch batches with
    no delivery evidence: neither in the worker's own progress acks
    (``_sent_seqs`` — sent to the channel, which outlives the worker)
    nor in the consumer's optional ``acked_seqs``.  Replay of an
    already-sent batch would be harmless (consumer '#SEQ' dedup) but
    wasteful — and under a deterministic kill fault it would re-fire
    the fault forever."""
    # called from _supervise_locked only  # glint: holds=self._sup_lock
    sl, seqs = self._assignments.get(rank, (None, []))
    if sl is None:
      return None, []
    done = set(self._sent_seqs)
    if acked_seqs is not None:
      done |= set(acked_seqs)
    bs = self.batch_size
    keep = [i for i, s in enumerate(seqs) if s not in done]
    if not keep:
      return None, []
    parts = [sl[i * bs:(i + 1) * bs] for i in keep]
    return np.concatenate(parts, axis=0), [seqs[i] for i in keep]

  def supervise(self, acked_seqs=None):
    """Detect dead workers, restart them, and replay their unacked
    current-epoch batches (same '#SEQ' stamps + (epoch, seq)-derived
    batch seeds, so replays are byte-identical to what was lost).

    Returns ``(restarted, lost_seqs)``: workers restarted this call,
    and the outstanding seq stamps owned by workers past the restart
    budget (``GLT_MAX_WORKER_RESTARTS``) — permanently lost batches
    the caller must either subtract from the epoch (degraded mode) or
    raise `PeerLostError` over."""
    from ..telemetry.recorder import recorder
    from .resilience import max_worker_restarts
    with self._sup_lock:
      out = self._supervise_locked(acked_seqs, recorder,
                                   max_worker_restarts())
      pending = self._pending_postmortem
      self._pending_postmortem = None
    if pending is not None:
      # OUTSIDE the supervision lock: the bundle's health snapshot
      # calls back into `health()`, which takes `_sup_lock` (the
      # lock is not reentrant — dumping under it deadlocks)
      from ..telemetry import postmortem
      postmortem.dump('peer.lost', extra=pending)
    return out

  def _supervise_locked(self, acked_seqs, recorder, budget):
    self._drain_progress()
    restarted = 0
    lost_seqs: list = []
    for r, w in enumerate(self._workers):
      if w.is_alive():
        continue
      sl, seqs = self._unacked(r, acked_seqs)
      if r in self._lost or self._restarts >= budget:
        if r not in self._lost:
          self._lost.add(r)
          recorder.emit('peer.lost', peer=f'worker-{r}', peer_kind='worker',
                        exitcode=w.exitcode,
                        outstanding=len(seqs),
                        restarts=self._restarts, budget=budget)
          # black box: an irrecoverable worker pool is fatal — stage
          # a post-mortem for `supervise` to write AFTER releasing
          # `_sup_lock` (the bundle's health snapshot re-enters
          # `health()`, which needs the lock)
          self._pending_postmortem = {
              'peer': f'worker-{r}', 'exitcode': w.exitcode,
              'outstanding': len(seqs),
              'restarts': self._restarts, 'budget': budget}
        lost_seqs.extend(seqs)
        continue
      exitcode = w.exitcode
      self._restarts += 1
      self._generations[r] = self._generations.get(r, 0) + 1
      tq, proc = self._spawn_worker(r)
      self._task_queues[r] = tq
      self._workers[r] = proc
      if sl is not None and self.current_epoch >= 0:
        tq.put((MpCommand.SAMPLE_ALL,
                (sl, self.batch_size, self.current_epoch, seqs)))
        self._assignments[r] = (sl, seqs)
      recorder.emit('producer.restart', worker=r, exitcode=exitcode,
                    replayed=len(seqs), restarts=self._restarts,
                    budget=budget)
      from ..utils.profiling import metrics
      metrics.inc('producer.restarts_total')
      restarted += 1
    return restarted, lost_seqs

  # -- DataPlaneState (utils.checkpoint) ------------------------------------
  def state_dict(self) -> dict:
    """Producer positions: epoch counter, shuffle RNG (current AND the
    pre-shuffle state of the in-flight epoch), per-worker restart
    generations.  Worker processes are NOT captured — they are
    respawned fresh and replay deterministically from (epoch, seq)."""
    from ..utils.checkpoint import pack_bytes, pack_rng_state
    return {
        'epoch': self._epoch,
        'current_epoch': self.current_epoch,
        'rng': pack_rng_state(self._rng),
        'pre_epoch_rng': getattr(self, '_pre_epoch_rng',
                                 pack_rng_state(self._rng)),
        'generations': pack_bytes(dict(self._generations)),
    }

  def load_state_dict(self, state: dict, mid_epoch: bool = True) -> None:
    """``mid_epoch=True`` rewinds so the NEXT `produce_all` re-
    dispatches the interrupted epoch (same epoch number, same
    shuffle); False resumes at the epoch boundary."""
    from ..utils.checkpoint import restore_rng_state, unpack_bytes
    cur = int(np.asarray(state['current_epoch']))
    if mid_epoch:
      self._epoch = cur if cur >= 0 else 0
      restore_rng_state(self._rng, state['pre_epoch_rng'])
    else:
      self._epoch = int(np.asarray(state['epoch']))
      restore_rng_state(self._rng, state['rng'])
    self._generations = dict(unpack_bytes(state['generations']))

  def shutdown(self) -> None:
    for tq in self._task_queues:
      try:
        tq.put((MpCommand.STOP, None))
      except Exception:
        pass
    for w in self._workers:
      w.join(timeout=5.0)
      if w.is_alive():
        w.terminate()
    self._workers = []
    self._task_queues = []
    if getattr(self, '_shm_segs', None):
      from .shm_arrays import release
      release(self._shm_segs)
      self._shm_segs = None


class CollocatedSamplingProducer:
  """Synchronous in-process producer (reference
  ``DistCollocatedSamplingProducer``, `dist_sampling_producer.py:
  263-328`) — same message contract, no subprocesses, no channel."""

  def __init__(self, dataset: HostDataset, num_neighbors: Sequence[int],
               batch_size: int, with_edge: bool = False,
               collect_features: bool = True, shuffle: bool = False,
               seed: int = 0, sampling_config=None):
    self.sampler = _make_sampler(dataset, num_neighbors, with_edge,
                                 collect_features, seed,
                                 peer_addrs=getattr(sampling_config,
                                                    'peer_addrs', None))
    self.batch_size = int(batch_size)
    self.shuffle = shuffle
    self.sampling_config = sampling_config
    self._rng = np.random.default_rng(seed)

  def epoch(self, seeds: np.ndarray, drop_last: bool = False):
    seeds = np.asarray(seeds)
    if seeds.ndim == 1:
      seeds = seeds.reshape(-1)
    if self.shuffle:
      seeds = self._rng.permutation(seeds)
    if drop_last:
      seeds = seeds[:(len(seeds) // self.batch_size) * self.batch_size]
    for lo in range(0, len(seeds), self.batch_size):
      yield _dispatch_sample(self.sampler, self.sampling_config,
                             seeds[lo:lo + self.batch_size],
                             batch_seed=None)
