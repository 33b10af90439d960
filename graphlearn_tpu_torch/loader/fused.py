"""Fused epochs on one card: the host driver the fused epochs share (the
JAX package's `loader/fused.py:428-683`, `EpochStats` and
`_SupervisedScanEpoch`), the subgraph epoch `FusedEpoch` (`:686-852`),
its heterogeneous twin `FusedHeteroEpoch` (`:853-994`) and the
link-prediction epoch `FusedLinkEpoch` (`:997-1400`); the tree epoch
`loader.fused_tree.FusedTreeEpoch` runs on the same driver.

JAX runs each chunk of an epoch as one compiled `lax.scan` program, so
the host enqueues once.  The port's counterpart on a card is a CUDA
graph: the first `run` (or `evaluate`) runs its first step eagerly on a
side stream — the warm-up `torch.cuda.graph` needs, and a real step —
then captures the step once; every later step of every epoch copies its
seeds and draw coordinates into the graph's static device buffers and
replays it.  The train and the eval graph share one memory pool.  On
the CPU every step runs eagerly (what the parity tests drive).  There is
no eager route on a card: a capture that fails raises.

What carries over from JAX exactly is the schedule: the host shuffle,
the split into chunks of ``max_steps_per_program`` steps whose tail is
padded with -1 seeds, and the draw coordinates of each step, ``draws(
epoch, chunk, step, hop, rows, k, w)``:

  * ``epoch`` counts `run` calls from 1; `evaluate` draws at epoch 0
    (JAX keys evaluation in its own fold domain, ``fold_in(fold_in(
    key(seed), 0), 1)``, and training at ``fold_in(key(seed), epoch)``);
  * ``chunk`` is the chunk's first step, or None when the epoch is one
    chunk (JAX then keys the steps from the epoch key itself);
  * ``step`` is the step's index within its chunk and ``hop`` the hop;
  * a heterogeneous hop passes ``etype=ei`` too, the index of its edge
    type among the sorted edge types (JAX folds it in after the hop);
  * a link step draws its negative candidates from ``neg_draws(epoch,
    chunk, step, stream, trials, r, high)`` (JAX: ``fold_in(step key,
    0)``, its hops under ``fold_in(step key, 1)``), and its evaluation
    is one chunk whatever ``max_steps_per_program`` (as JAX's).

On a card ``epoch``, ``chunk`` and ``step`` arrive as 0-d int64 device
tensors (``chunk`` 0 for a one-chunk epoch), read from the graph's
static buffer, so a provider must compute from them on the card; the
default, `ops.draws.CounterDraws`, does.  A fully padded step is skipped:
no forward, no optimizer step (and no replay), so Adam's moments and
step count do not move (JAX guards its scan body the same way).  Nothing
in `run` waits for the card; the returned `EpochStats` does when read.

A tiered feature store (``split_ratio < 1``) runs eagerly, chunk by
chunk, in JAX's three dispatches: every step of the chunk is sampled,
then `Feature.get` serves each step's rows in step order (the host
cache policy runs between the halves, so nothing is captured), then
every step trains.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..models.train import (_correct, link_loss_from_metadata,
                            supervised_loss)
from ..ops.draws import CounterDraws
from ..ops.launches import LAUNCH_COUNTED
from ..sampler.base import NegativeSampling
from ..telemetry.live import metrics
from ..telemetry.recorder import recorder
from ..telemetry.spans import span
from ..sampler.hetero_neighbor_sampler import (HeteroNeighborSampler,
                                               _hetero_multihop)
from ..sampler.neighbor_sampler import (NeighborSampler, _multihop_sample,
                                        link_metadata, link_seeds)
from ..testing import chaos
from ..utils.checkpoint import (CheckpointMismatchError, SnapshotManager,
                                snapshot_dir_from_env, to_numpy,
                                validate_tree)
from ..utils.device import resolve_device
from .link_loader import EdgeSeedBatcher, as_edge_pairs, shift_binary_labels
from .node_loader import SeedBatcher
from .transform import _gather_labels

#: ``draws(epoch, chunk, step, hop, rows, k, w) -> (u [rows, k],
#: gumbel [rows, w])``; a heterogeneous hop adds ``etype=ei``
EpochDraws = Callable[..., Tuple[torch.Tensor, torch.Tensor]]


class EpochStats:
  """Lazy epoch statistics: device tensors, read (and synchronised) on
  access."""

  def __init__(self, losses: torch.Tensor, correct: torch.Tensor,
               valid: torch.Tensor):
    self.losses = losses
    self._correct = correct
    self._valid = valid

  @property
  def loss(self) -> float:
    return float(self.losses.mean())

  @property
  def correct(self) -> int:
    return int(self._correct)

  @property
  def seeds(self) -> int:
    return int(self._valid)

  @property
  def accuracy(self) -> float:
    return self.correct / max(self.seeds, 1)

  def __getitem__(self, key: str):
    return getattr(self, key)

  def __repr__(self):
    return f'EpochStats(steps={self.losses.shape[0]}, <lazy>)'


class Rematerialized(nn.Module):
  """``module`` under activation checkpointing (JAX's `jax.checkpoint`):
  the backward recomputes the forward instead of keeping its
  activations.  No RNG state is saved, so it captures in a CUDA
  graph."""

  def __init__(self, module: nn.Module):
    super().__init__()
    self.module = module

  def forward(self, *args):
    return checkpoint(self.module, *args, use_reentrant=False,
                      preserve_rng_state=False)


def check_capturable(optimizer: torch.optim.Optimizer, owner: str) -> None:
  """A captured step replays the optimizer's update, which then has to
  keep its step count on the card: raise unless every parameter group
  was built with ``capturable=True``."""
  if not all(g.get('capturable', False) for g in optimizer.param_groups):
    raise ValueError(
        f'{owner} replays its step as a CUDA graph on the card: build the '
        f'optimizer with capturable=True (e.g. torch.optim.Adam(params, '
        f'lr, capturable=True))')


class CapturedStep:
  """One step captured as a CUDA graph: its static inputs (``seeds
  [B]`` int32, ``coords [3]`` int64), its static outputs, and the kernel
  launches one replay makes (the wrappers count at the Python call,
  which a replay does not make, so `replay` adds what the capture
  counted: an inferred count, not one observed on the card)."""

  def __init__(self, graph, seeds, coords, outputs, launches):
    self.graph = graph
    self.seeds = seeds
    self.coords = coords
    self.outputs = outputs
    self.launches = launches

  def replay(self, seeds: torch.Tensor, coords: torch.Tensor):
    self.seeds.copy_(seeds)
    self.coords.copy_(coords)
    self.graph.replay()
    for fn, n in self.launches:
      fn.launches += n
    return self.outputs


def _np_dtype(t: torch.Tensor) -> np.dtype:
  return torch.empty(0, dtype=t.dtype).numpy().dtype


def _like(t: torch.Tensor) -> np.ndarray:
  """A numpy stand-in with ``t``'s shape and dtype (no copy: what a
  template leaf needs)."""
  return np.broadcast_to(np.zeros((), _np_dtype(t)), tuple(t.shape))


def _hparams(group: dict) -> dict:
  """The numeric hyperparameters of an optimizer's parameter group (the
  values a scheduler moves: lr, betas, eps, weight decay, momentum...);
  flags and the params list stay the live optimizer's."""
  out = {}
  for k, v in group.items():
    if k == 'params' or isinstance(v, bool):
      continue
    if isinstance(v, (int, float)) or (
        isinstance(v, tuple) and v
        and all(isinstance(x, float) for x in v)):
      out[k] = v
  return out


def _hparam(v) -> object:
  """A saved hyperparameter leaf as the optimizer keeps it: a Python
  number, or a tuple of them (Adam's betas)."""
  v = np.asarray(v).tolist()
  return tuple(v) if isinstance(v, list) else v


class _SnapshotHooks:
  """Chunk-boundary snapshots and mid-epoch resume for the fused epochs
  (the JAX package's `_SnapshotHooks`, `loader/fused.py:261-425`),
  shared by the single-card drivers here and the mesh drivers in
  `parallel.fused`, so the save and restore contracts cannot drift.

  Lifecycle::

      fused.attach_snapshots(SnapshotManager(dir, every=2))
      fused.run()                       # saves at chunk boundaries
      # ... a preemption; in a fresh process, same constructor args:
      fused.attach_snapshots(SnapshotManager(dir))
      fused.restore_from_snapshot()     # rewinds the data plane and
      fused.run()                       # loads model and optimizer;
                                        # finishes the epoch

  A payload holds (a) the data plane: the epoch counter, the batcher's
  RNG at the epoch's start (a resume re-draws the interrupted epoch's
  permutation) and, on a tiered store, the feature store's cold-cache
  ring; (b) the progress: the next chunk's first step, the chunk length
  and the finished steps' losses and counts; (c) the train state: the
  model's and the optimizer's state as numpy.  The draws are keyed by
  (epoch, chunk, step), so the resumed steps draw as the uninterrupted
  ones do.

  A restore copies into the model's live parameters and loads the
  optimizer through `load_state_dict`, which makes new state tensors:
  any captured step is dropped, and the next step captures again.
  """

  _snap = None
  _resume = None

  def attach_snapshots(self, manager=None):
    """Attach a `utils.checkpoint.SnapshotManager` (None builds one from
    ``GLT_SNAPSHOT_DIR`` when it is set); returns the manager or
    None."""
    if manager is None:
      if snapshot_dir_from_env() is None:
        return None
      manager = SnapshotManager()
    self._snap = manager
    return manager

  # -- the data plane (overridden by the mesh drivers) ------------------------
  def data_plane_state(self) -> dict:
    st = {'epoch_idx': self._epoch_idx,
          'batcher': self._batcher.state_dict()}
    if getattr(self, '_tiered', False):
      st['feat'] = self._feat.state_dict()
    return st

  def load_data_plane_state(self, plane: dict) -> None:
    # run() pre-increments the epoch counter, and the batcher rewinds to
    # the interrupted epoch's start, so run() re-draws that epoch
    self._epoch_idx = int(np.asarray(plane['epoch_idx'])) - 1
    self._batcher.load_state_dict(plane['batcher'], mid_epoch=True)
    if 'feat' in plane and getattr(self, '_tiered', False):
      self._feat.load_state_dict(plane['feat'])

  # -- the train state --------------------------------------------------------
  def train_state(self) -> dict:
    """The model's and the optimizer's state as host numpy arrays."""
    opt = self.optimizer.state_dict()
    return to_numpy({
        'model': dict(self.model.state_dict()),
        'optimizer': {'kind': type(self.optimizer).__name__,
                      'state': opt['state'],
                      'groups': [_hparams(g) for g in
                                 self.optimizer.param_groups]}})

  def _train_template(self, saved: dict) -> dict:
    """What a restorable train state must look like, from the parameters
    alone (an optimizer that has not stepped yet has no state): each
    saved tensor of a parameter's state has that parameter's shape and
    dtype, a 0-d leaf (such as Adam's step) its own."""
    params = [p for g in self.optimizer.param_groups for p in g['params']]
    state = {}
    for i, st in (saved.get('optimizer', {}).get('state') or {}).items():
      if not (isinstance(st, dict) and isinstance(i, int)
              and 0 <= i < len(params)):
        continue                   # no such parameter: validate_tree names it
      state[i] = {k: (_like(params[i]) if np.asarray(v).ndim
                      else np.asarray(v)) for k, v in st.items()}
    return {'model': {k: _like(v) for k, v in self.model.state_dict().items()},
            'optimizer': {
                'kind': np.asarray(type(self.optimizer).__name__),
                'state': state,
                'groups': to_numpy([_hparams(g) for g in
                                    self.optimizer.param_groups])}}

  def load_train_state(self, train: dict) -> None:
    """Validate ``train`` against the live model and optimizer
    (`CheckpointMismatchError` naming the first diverging path), then
    load it."""
    kind = str(np.asarray(train.get('optimizer', {}).get('kind', '')))
    if kind != type(self.optimizer).__name__:
      raise CheckpointMismatchError(
          f'the snapshot holds a {kind} optimizer state, this driver runs '
          f'{type(self.optimizer).__name__}', path="['optimizer']['kind']")
    validate_tree(train, self._train_template(train))
    with torch.no_grad():
      for k, t in self.model.state_dict().items():
        t.copy_(torch.from_numpy(np.asarray(train['model'][k])))
    sd = self.optimizer.state_dict()
    sd['state'] = {i: {k: torch.from_numpy(np.array(v))
                       for k, v in st.items()}
                   for i, st in train['optimizer']['state'].items()}
    for g, hp in zip(sd['param_groups'], train['optimizer']['groups']):
      g.update({k: _hparam(v) for k, v in hp.items()})
    self.optimizer.load_state_dict(sd)
    # new state tensors: a captured step would train the old ones
    getattr(self, '_replays', {}).clear()

  def restore_from_snapshot(self) -> Optional[dict]:
    """Load the newest snapshot: the model and optimizer state (checked
    first: `CheckpointMismatchError` on a stale snapshot), then the
    data plane; the next `run` continues the interrupted epoch.  Returns
    the snapshot's progress (``epoch``, ``next_chunk``, ...), or None
    when the directory holds no snapshot."""
    if self._snap is None:
      raise ValueError('restore_from_snapshot() needs attach_snapshots() '
                       'first')
    payload = self._snap.restore_latest()
    if payload is None:
      return None
    if payload.get('train') is not None:
      self.load_train_state(payload['train'])
    self.load_data_plane_state(payload['plane'])
    self._resume = payload['progress']
    return self._resume

  # -- run()-side helpers -----------------------------------------------------
  def _take_resume(self, chunk_steps: int) -> Optional[dict]:
    """Pop the pending resume progress (one epoch continuation a
    restore); raise `CheckpointMismatchError` when it was taken at
    another chunk length."""
    prog, self._resume = self._resume, None
    if prog is None:
      return None
    saved = int(np.asarray(prog['chunk_steps']))
    if saved != chunk_steps:
      raise CheckpointMismatchError(
          f'the snapshot was taken with chunks of {saved} steps, this '
          f'epoch runs chunks of {chunk_steps}: resume with the same '
          'max_steps_per_program', path='progress.chunk_steps')
    return prog

  def _resume_outs(self, chunk_steps: int, outs) -> Tuple[int, int]:
    """``(the first chunk to run, steps done)``; the done steps' losses
    and counts are copied from the snapshot into ``outs``."""
    prog = self._take_resume(chunk_steps)
    if prog is None:
      return 0, 0
    done = int(np.asarray(prog['losses']).shape[0])
    for buf, key in zip(outs, ('losses', 'counts')):
      buf[:done].copy_(torch.from_numpy(np.asarray(prog[key])))
    return int(np.asarray(prog['next_chunk'])), done

  def _save_chunk_snapshot(self, next_chunk: int, chunk_steps: int, losses,
                           counts, force: bool = False, **extra) -> None:
    """One boundary's snapshot when due (``force``: whatever the
    cadence).  Reading the losses and the train state waits for the
    card."""
    if self._snap is None or not (force or self._snap.due()):
      return
    progress = {'epoch': self._epoch_idx, 'next_chunk': int(next_chunk),
                'chunk_steps': int(chunk_steps), 'losses': losses,
                'counts': counts}
    progress.update({k: v for k, v in extra.items() if v is not None})
    self._snap.save(self.data_plane_state(), progress,
                    train=self.train_state())


class _SupervisedEpoch(_SnapshotHooks):
  """The host driver of the single-card fused epochs.  A subclass sets
  ``_owner`` and supplies ``_sample(seeds, draws) -> sample`` (the
  sampler half) and ``_gather(sample, seeds) -> (inputs, y)`` (the
  feature and label gathers; ``model(*inputs)`` gives the logits).
  On a heterogeneous dataset ``_graph`` and ``_feat`` are the dataset's
  dicts and ``_labels`` those of ``label_type``.  A step's seeds are one
  row of `_epoch_seeds` (``[B]`` node ids; the link epoch's ``[3, B]``
  edges and labels), and `_valid_step` says whether a row holds a
  seed."""

  _owner = 'the fused epoch'
  _needs_labels = True

  def _init_driver(self, data, input_nodes, model,
                   optimizer: torch.optim.Optimizer, batch_size: int,
                   shuffle: bool, drop_last: bool, seed: Optional[int],
                   max_steps_per_program: Optional[int],
                   draws: Optional[EpochDraws], remat: bool, device,
                   label_type: Optional[str] = None, batcher=None):
    self.device = resolve_device(device)
    graph = data.get_graph()
    for g in graph.values() if isinstance(graph, dict) else (graph,):
      if g.device != self.device:
        raise ValueError(f'the graph lives on {g.device}, the epoch on '
                         f'{self.device}')
    feat = data.node_features
    if feat is None or (isinstance(feat, dict) and not feat):
      raise ValueError(f'{self._owner} needs node features')
    labels = data.get_node_label_device(label_type)
    if labels is None and self._needs_labels:
      of = '' if label_type is None else f' of {label_type!r}'
      raise ValueError(f'{self._owner} needs node labels{of}')
    self._tiered = any(f.is_tiered for f in (
        feat.values() if isinstance(feat, dict) else (feat,)))
    self._capture = self.device.type == 'cuda' and not self._tiered
    if self._capture:
      check_capturable(optimizer, self._owner)
    self.data = data
    self.model = model
    self.optimizer = optimizer
    self.batch_size = int(batch_size)
    self._train_model = Rematerialized(model) if remat else model
    self._graph = graph
    self._feat = feat
    self._labels = labels
    if batcher is None:
      input_nodes = np.asarray(input_nodes)
      if input_nodes.dtype == np.bool_:
        input_nodes = np.nonzero(input_nodes)[0]
      batcher = SeedBatcher(input_nodes, self.batch_size, shuffle,
                            drop_last, seed)
    self._batcher = batcher
    self._chunk = (int(max_steps_per_program)
                   if max_steps_per_program else None)
    self.draws = (draws if draws is not None
                  else CounterDraws(seed or 0, self.device))
    self._epoch_idx = 0
    self._replays = {}
    self._pool = None
    self._captures = 0

  def __len__(self) -> int:
    return len(self._batcher)

  def compile_count(self) -> int:
    """CUDA graphs captured so far (one for training and one for
    evaluation per epoch object; 0 on the CPU)."""
    return self._captures

  # -- the schedule ---------------------------------------------------------

  def _chunks(self, seeds: np.ndarray, one_chunk: bool = False
              ) -> Iterator[Tuple[int, np.ndarray]]:
    """``(chunk offset, [chunk, B] piece)``, the tail piece padded with
    -1 rows (the whole epoch one chunk with ``one_chunk``)."""
    s = seeds.shape[0]
    chunk = s if one_chunk else (self._chunk or s)
    for c0 in range(0, s, chunk):
      part = seeds[c0:c0 + chunk]
      real = part.shape[0]
      if real < chunk:
        pad = np.full((chunk - real,) + seeds.shape[1:], -1, seeds.dtype)
        part = np.concatenate([part, pad])
      yield c0, part

  def _epoch_seeds(self) -> np.ndarray:
    """One epoch's ``[S, B]`` seed rows, in the batcher's order."""
    return np.stack(list(self._batcher))

  def _valid_step(self, row: np.ndarray) -> bool:
    return bool((row >= 0).any())

  def _schedule(self, seeds: np.ndarray, epoch: int,
                one_chunk: bool = False):
    """The chunk length and the steps that hold a valid seed, chunk by
    chunk: ``(chunk, [(c0, [(seeds_i, (epoch, chunk, step)), ...]),
    ...])`` on the host."""
    parts = list(self._chunks(seeds, one_chunk))
    out = []
    for c0, part in parts:
      chunk = None if len(parts) == 1 else c0
      piece = []
      for i in range(part.shape[0]):
        if self._valid_step(part[i]):
          piece.append((part[i], (epoch, chunk, i)))
      out.append((c0, piece))
    return (parts[0][1].shape[0] if parts else 0), out

  def _upload(self, a: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    if self.device.type == 'cuda':
      return t.pin_memory().to(self.device, non_blocking=True)
    return t.to(self.device)

  def _step_draws(self, coords):
    epoch, chunk, step = coords

    def draws(hop, rows, k, w, **etype):
      return self.draws(epoch, chunk, step, hop, rows, k, w, **etype)
    return draws

  # -- one step ---------------------------------------------------------------

  def _train_on(self, seeds: torch.Tensor, inputs, y) -> Tuple:
    self.model.train()
    self.optimizer.zero_grad(set_to_none=True)
    logits = self._train_model(*inputs)
    loss = supervised_loss(logits, y, seeds, self.batch_size)
    loss.backward()
    self.optimizer.step()
    return loss.detach(), torch.stack(
        [_correct(logits, y, seeds, self.batch_size), (seeds >= 0).sum()])

  @torch.no_grad()
  def _eval_on(self, seeds: torch.Tensor, inputs, y) -> Tuple:
    self.model.eval()
    logits = self.model(*inputs)
    return (torch.stack([_correct(logits, y, seeds, self.batch_size),
                         (seeds >= 0).sum()]),)

  def _train_step(self, seeds: torch.Tensor, coords) -> Tuple:
    """One eager train step: ``(loss, [correct, valid])``.  ``coords``
    is ``(epoch, chunk, step)``, ints or 0-d device tensors."""
    inputs, y = self._gather(self._sample(seeds, self._step_draws(coords)),
                             seeds)
    return self._train_on(seeds, inputs, y)

  def _eval_step(self, seeds: torch.Tensor, coords) -> Tuple:
    """One eager eval step: ``([correct, valid],)``."""
    inputs, y = self._gather(self._sample(seeds, self._step_draws(coords)),
                             seeds)
    return self._eval_on(seeds, inputs, y)

  # -- capture ----------------------------------------------------------------

  def _captured(self, kind: str, seeds: torch.Tensor, coords: torch.Tensor,
                outs: List[torch.Tensor], n: int) -> CapturedStep:
    """Warm up with the step itself (step ``n`` of the epoch, its
    outputs written to ``outs``) on a side stream, then capture it."""
    fn = self._train_step if kind == 'train' else self._eval_step
    t0 = time.perf_counter()
    static_seeds, static_coords = seeds.clone(), coords.clone()
    args = (static_seeds, tuple(static_coords.unbind(0)))
    main = torch.cuda.current_stream(self.device)
    side = torch.cuda.Stream(self.device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
      for buf, val in zip(outs, fn(*args)):
        buf[n].copy_(val)
    main.wait_stream(side)
    if self._pool is None:
      self._pool = torch.cuda.graph_pool_handle()
    wrappers = list(LAUNCH_COUNTED)
    before = [fn_.launches for fn_ in wrappers]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=self._pool, stream=side):
      static_out = fn(*args)
    # the capture recorded these launches; none of them ran
    launches = []
    for fn_, b in zip(wrappers, before):
      if fn_.launches != b:
        launches.append((fn_, fn_.launches - b))
        fn_.launches = b
    self._captures += 1
    # the port's counterpart of a program compile: one capture a kind
    dt = time.perf_counter() - t0
    metrics.inc('fused.compile.misses')
    metrics.inc('fused.compile.secs', dt)
    recorder.emit('fused.compile', fn=f'{type(self).__name__}.{kind}',
                  secs=round(dt, 3), persistent_cache=False)
    step = CapturedStep(graph, static_seeds, static_coords, static_out,
                        launches)
    self._replays[kind] = step
    return step

  def _run_steps(self, kind: str, seeds: np.ndarray, epoch: int,
                 one_chunk: bool = False) -> List[torch.Tensor]:
    """Every step of an epoch over ``[S, B]`` seeds; returns the
    per-step outputs stacked: ``[losses [n], counts [n, 2]]`` for
    training, ``[counts [n, 2]]`` for evaluation.  A training epoch
    passes the ``fused.dispatch`` seam before each chunk and offers a
    snapshot after it; a resumed one starts at the snapshot's chunk,
    the earlier steps' outputs taken from the snapshot."""
    chunk_steps, plan = self._schedule(seeds, epoch, one_chunk)
    n = sum(len(piece) for _, piece in plan)
    outs = [torch.empty((n, 2), dtype=torch.int64, device=self.device)]
    train = kind == 'train'
    if train:
      outs.insert(0, torch.empty(n, dtype=torch.float32,
                                 device=self.device))
    if n == 0:
      return outs
    skip, j = self._resume_outs(chunk_steps, outs) if train else (0, 0)
    for c0, piece in plan:
      if c0 < skip or not piece:
        continue
      if train:
        chaos.fused_dispatch_check(chunk=c0, epoch=epoch)
      # a training chunk is one dispatch span (JAX: one program)
      with (span('fused.dispatch', chunk=c0) if train
            else contextlib.nullcontext()):
        if self._tiered:
          self._run_tiered(kind, piece, outs, j)
        elif not self._capture:
          fn = self._train_step if train else self._eval_step
          for i, (row, coords) in enumerate(piece):
            for buf, val in zip(outs, fn(self._upload(row), coords)):
              buf[j + i].copy_(val)
        else:
          self._run_captured(kind, piece, outs, j)
      j += len(piece)
      if train:
        self._save_chunk_snapshot(c0 + chunk_steps, chunk_steps,
                                  outs[0][:j], outs[1][:j])
    return outs

  def _run_captured(self, kind: str, piece, outs, j: int) -> None:
    """One chunk's steps as replays of the captured step (captured at
    the first step that runs, which writes its own outputs)."""
    seeds_d = self._upload(np.stack([row for row, _ in piece]))
    coords_d = self._upload(np.array(
        [(e, c or 0, i) for _, (e, c, i) in piece], np.int64))
    graph = self._replays.get(kind)
    first = 0
    if graph is None:
      graph = self._captured(kind, seeds_d[0], coords_d[0], outs, j)
      first = 1
    else:
      metrics.inc('fused.compile.hits')
    for i in range(first, len(piece)):
      for buf, val in zip(outs, graph.replay(seeds_d[i], coords_d[i])):
        buf[j + i].copy_(val)

  def _run_tiered(self, kind: str, piece, outs, j: int) -> None:
    """A tiered chunk: sample every step, serve every step's rows in step
    order, then train (or evaluate) every step."""
    on = self._train_on if kind == 'train' else self._eval_on
    rows = [self._upload(row) for row, _ in piece]
    samples = [self._sample(s, self._step_draws(coords))
               for s, (_, coords) in zip(rows, piece)]
    # the between-dispatch cold service: every step's rows, in order
    with span('feature.cold_overlay', scope=type(self).__name__,
              steps=len(piece)):
      gathered = [self._gather(smp, s) for smp, s in zip(samples, rows)]
    for i, (s, (inputs, y)) in enumerate(zip(rows, gathered)):
      for buf, val in zip(outs, on(s, inputs, y)):
        buf[j + i].copy_(val)

  # -- the driver -------------------------------------------------------------

  def run(self) -> EpochStats:
    """One training epoch; returns its lazy `EpochStats`."""
    seeds = self._epoch_seeds()
    self._epoch_idx += 1
    with span('fused.epoch', scope=type(self).__name__,
              epoch=self._epoch_idx, steps=seeds.shape[0],
              tiered=self._tiered):
      losses, counts = self._run_steps('train', seeds, self._epoch_idx)
    return EpochStats(losses, counts[:, 0].sum(), counts[:, 1].sum())

  def evaluate(self, input_nodes) -> float:
    """Accuracy over ``input_nodes`` (e.g. the test split)."""
    ids = np.asarray(input_nodes)
    if ids.dtype == np.bool_:
      ids = np.nonzero(ids)[0]
    if ids.size == 0:
      raise ValueError('evaluate() got an empty split')
    seeds = np.stack(list(SeedBatcher(ids, self.batch_size, shuffle=False)))
    (counts,) = self._run_steps('eval', seeds, 0)
    correct, total = (int(v) for v in counts.sum(0).cpu())
    return correct / max(total, 1)


class FusedEpoch(_SupervisedEpoch):
  """Supervised subgraph epochs over uniform neighbor sampling (the JAX
  package's `FusedEpoch`).  Each step samples with the per-batch
  sampler's `_multihop_sample` (seeds in ascending order per hop,
  ``sort_locality``), gathers the node table's rows through
  `Feature.get` (the row gather kernel) and its labels, runs the model's
  ``(x, edge_index, edge_mask)`` forward and the masked seed loss.

  Example::

      model = GraphSAGE(100, 256, 47, num_layers=3).to('cuda')
      opt = torch.optim.Adam(model.parameters(), lr=3e-3,
                             capturable=True)
      fused = FusedEpoch(ds, [15, 10, 5], train_idx, model, opt,
                         batch_size=1024, seed=0, remat=True)
      for _ in range(epochs):
        stats = fused.run()
      acc = fused.evaluate(test_idx)

  Args:
    data: a `data.Dataset` on ``device`` with node features and labels.
    num_neighbors: per-hop fanouts.
    input_nodes: seed ids (or a boolean mask).
    model: a `models.GraphSAGE` (or a module with its ``(x, edge_index,
      edge_mask) -> [node_cap, C]`` signature) on ``device``; trained
      in place.
    optimizer: a `torch.optim.Optimizer` over the model's parameters;
      on a card built with ``capturable=True`` (else ValueError).
    batch_size / shuffle / drop_last / seed: epoch controls.
    remat: recompute the model's forward in the backward
      (`Rematerialized`); `evaluate` runs without it.
    max_steps_per_program: the chunk length of the draw schedule
      (module docstring); None keeps the epoch one chunk.
    draws: the ``draws(epoch, chunk, step, hop, rows, k, w)`` provider;
      default `ops.draws.CounterDraws` on ``device``.
    device: where training runs (default ``'cuda'``).
  """

  _owner = 'FusedEpoch'

  def __init__(self, data, num_neighbors: Sequence[int], input_nodes,
               model, optimizer: torch.optim.Optimizer, batch_size: int,
               shuffle: bool = True, drop_last: bool = False,
               seed: Optional[int] = None, remat: bool = False,
               max_steps_per_program: Optional[int] = None,
               draws: Optional[EpochDraws] = None, device='cuda'):
    self._init_driver(data, input_nodes, model, optimizer, batch_size,
                      shuffle, drop_last, seed, max_steps_per_program,
                      draws, remat, device)
    self.fanouts = tuple(int(k) for k in num_neighbors)
    self._node_cap = NeighborSampler(self._graph, self.fanouts,
                                     device=self.device).node_capacity(
                                         self.batch_size)

  def _sample(self, seeds: torch.Tensor, draws):
    return _multihop_sample(self._graph.indptr, self._graph.indices, seeds,
                            self.fanouts, self._node_cap,
                            lambda _step, hop, rows, k, w: draws(
                                hop, rows, k, w), 0)

  def _gather(self, out, seeds: torch.Tensor):
    x = self._feat.get(out.node)
    edge_index = torch.stack([out.row, out.col])
    return (x, edge_index, out.edge_mask), _gather_labels(self._labels,
                                                          out.node)


class FusedHeteroEpoch(_SupervisedEpoch):
  """Supervised epochs on a heterogeneous graph (the JAX package's
  `FusedHeteroEpoch`).  Each step samples with the per-batch sampler's
  `_hetero_multihop` (K1 per hop and edge type, the per-type inducer),
  gathers every type's rows through its `Feature.get` (the row gather
  kernel) and the seed type's labels, runs the model's ``(x_dict,
  edge_index_dict, edge_mask_dict) -> seed-type logits`` forward and
  the masked seed loss.  On a card each step is a replay of one
  captured CUDA graph, as in `FusedEpoch`.

  Example::

      # the batches carry the reversed edge types
      etypes = [reverse_edge_type(et) for et in ds.get_edge_types()]
      model = RGCN(etypes, 128, 128, 349, num_layers=2,
                   target_ntype='paper').to('cuda')
      opt = torch.optim.Adam(model.parameters(), lr=1e-3,
                             capturable=True)
      fused = FusedHeteroEpoch(ds, [10, 10], ('paper', train_idx), model,
                               opt, batch_size=512, seed=0)
      stats = fused.run()
      acc = fused.evaluate(test_idx)

  Args:
    data: a heterogeneous `data.Dataset` on ``device``: every node
      type's features wholly on the device (``split_ratio`` 1), labels
      of the seed type.
    num_neighbors: per-hop fanouts, one list or ``{EdgeType: list}``.
    input_nodes: ``(node_type, ids)`` (ids or a boolean mask).
    model: e.g. `models.RGCN` / `models.HGT` with ``target_ntype`` the
      seed type, on ``device``; trained in place.
    optimizer: over the model's parameters; on a card built with
      ``capturable=True``.
    batch_size / shuffle / drop_last / seed / remat /
      max_steps_per_program / device: as `FusedEpoch`.
    draws: the ``draws(epoch, chunk, step, hop, rows, k, w, etype=ei)``
      provider; default `ops.draws.CounterDraws` on ``device``.
  """

  _owner = 'FusedHeteroEpoch'

  def __init__(self, data, num_neighbors, input_nodes, model,
               optimizer: torch.optim.Optimizer, batch_size: int,
               shuffle: bool = True, drop_last: bool = False,
               seed: Optional[int] = None, remat: bool = False,
               max_steps_per_program: Optional[int] = None,
               draws: Optional[EpochDraws] = None, device='cuda'):
    if not data.is_hetero:
      raise ValueError('FusedHeteroEpoch needs a hetero Dataset; use '
                       'FusedEpoch for homogeneous graphs')
    if not (isinstance(input_nodes, tuple)
            and isinstance(input_nodes[0], str)):
      raise ValueError('input_nodes must be (node_type, ids)')
    self.input_type, ids = input_nodes
    feats = data.node_features
    if not isinstance(feats, dict) or not feats:
      raise ValueError('FusedHeteroEpoch needs per-type node features')
    for nt, f in feats.items():
      if f.is_tiered:
        raise ValueError(
            f'feature table for {nt!r} keeps rows on host; '
            f'FusedHeteroEpoch needs split_ratio == 1.0 everywhere (use '
            f'NeighborLoader(prefetch=2) for tiered tables)')
    self._init_driver(data, ids, model, optimizer, batch_size, shuffle,
                      drop_last, seed, max_steps_per_program, draws, remat,
                      device, label_type=self.input_type)
    sampler = HeteroNeighborSampler(self._graph, num_neighbors,
                                    device=self.device,
                                    num_nodes=data.num_nodes_dict())
    self._plan = sampler.plan({self.input_type: self.batch_size})

  def _sample(self, seeds: torch.Tensor, draws):
    return _hetero_multihop(self._graph, {self.input_type: seeds},
                            self._plan, draws)

  def _gather(self, out, seeds: torch.Tensor):
    node, _, row, col, emask = out[:5]
    x_dict = {nt: self._feat[nt].get(ids) for nt, ids in node.items()
              if nt in self._feat}
    edge_index = {et: torch.stack([row[et], col[et]]) for et in row}
    return (x_dict, edge_index, dict(emask)), _gather_labels(
        self._labels, node[self.input_type])


def _homogeneous_pairs(edge_label_index):
  """``(rows, cols)`` of homogeneous seed edges; seed edges of an edge
  type raise ValueError."""
  etype, rows, cols = as_edge_pairs(edge_label_index)
  if etype is not None:
    raise ValueError('FusedLinkEpoch is homogeneous-only: use '
                     'LinkNeighborLoader for seed edges of an edge type')
  return rows, cols


class FusedLinkEpoch(_SupervisedEpoch):
  """Link-prediction (unsupervised) epochs (the JAX package's
  `FusedLinkEpoch`): each step draws the batch's negatives, samples the
  multi-hop neighborhoods of the positive and negative endpoints
  (`sampler.neighbor_sampler.link_seeds` and `_multihop_sample`),
  gathers the node table's rows through `Feature.get` (the row gather
  kernel), runs the model's ``(x, edge_index, edge_mask) -> [node_cap,
  D]`` embeddings and the binary (sigmoid) or triplet (max-margin) link
  loss of `link_metadata`.  On a card each step is a replay of one
  captured CUDA graph, the negatives drawn inside it.

  Example::

      model = GraphSAGE(50, 64, 64, num_layers=2).to('cuda')
      opt = torch.optim.Adam(model.parameters(), lr=3e-3,
                             capturable=True)
      fused = FusedLinkEpoch(ds, [10, 10], (rows, cols), model, opt,
                             batch_size=512, neg_sampling='binary', seed=0)
      stats = fused.run()   # seeds: valid seed edges; correct: 0
      auc = fused.evaluate((test_rows, test_cols))

  Args:
    data: a homogeneous `data.Dataset` on ``device`` with node features
      wholly on the device (a tiered store raises NotImplementedError);
      labels are not needed.
    num_neighbors: per-hop fanouts.
    edge_label_index: ``[2, E]`` or ``(rows, cols)`` seed edges.
    model / optimizer: as `FusedEpoch` (on a card ``capturable=True``).
    batch_size: seed edges a step.
    neg_sampling: a `sampler.NegativeSampling` or a mode string
      (default binary, amount 1).
    edge_label: optional ``[E]`` int labels (binary mode shifts them up
      by one: 0 is the sampled negative).
    shuffle / drop_last / seed / remat / max_steps_per_program / device:
      as `FusedEpoch`.
    draws: the hop draws, ``draws(epoch, chunk, step, hop, rows, k,
      w)``; neg_draws: the candidates, ``neg_draws(epoch, chunk, step,
      stream, trials, r, high)``; both default to
      `ops.draws.CounterDraws` on ``device``.
  """

  _owner = 'FusedLinkEpoch'
  _needs_labels = False

  def __init__(self, data, num_neighbors: Sequence[int], edge_label_index,
               model, optimizer: torch.optim.Optimizer, batch_size: int,
               neg_sampling='binary', edge_label=None, shuffle: bool = True,
               drop_last: bool = False, seed: Optional[int] = None,
               remat: bool = False,
               max_steps_per_program: Optional[int] = None,
               draws: Optional[EpochDraws] = None,
               neg_draws: Optional[Callable] = None, device='cuda'):
    if data.is_hetero:
      raise ValueError('FusedLinkEpoch is homogeneous-only')
    if data.node_features is not None and data.node_features.is_tiered:
      raise NotImplementedError(
          'FusedLinkEpoch over a tiered feature store is not ported yet (see '
          "the ROADMAP's slice catalogue, item 5): use split_ratio=1.0, or "
          'LinkNeighborLoader(prefetch=2)')
    rows, cols = _homogeneous_pairs(edge_label_index)
    batcher = EdgeSeedBatcher(rows, cols, edge_label, batch_size, shuffle,
                              drop_last, seed)
    self._init_driver(data, None, model, optimizer, batch_size, shuffle,
                      drop_last, seed, max_steps_per_program, draws, remat,
                      device, batcher=batcher)
    self.neg = NegativeSampling.cast(neg_sampling)
    self.neg_draws = (neg_draws if neg_draws is not None
                      else CounterDraws(seed or 0, self.device).negatives)
    self.fanouts = tuple(int(k) for k in num_neighbors)
    b = self.batch_size
    if self.neg.is_binary():
      width = 2 * b + 2 * self.neg.sample_size(b)
    else:
      width = 2 * b + b * int(np.ceil(float(self.neg.amount)))
    self._node_cap = NeighborSampler(self._graph, self.fanouts,
                                     device=self.device).node_capacity(width)

  # -- the schedule: a step's row is [src, dst, label], [3, B] int32 ----------

  def _epoch_seeds(self) -> np.ndarray:
    out = []
    for r, c, lab in self._batcher:
      if lab is None:
        lab = np.ones_like(r)
      elif self.neg.is_binary():
        lab = shift_binary_labels(r, c, lab)
      out.append(np.stack([r, c, lab.astype(np.int32)]))
    return np.stack(out)

  def _valid_step(self, row: np.ndarray) -> bool:
    return bool(((row[0] >= 0) & (row[1] >= 0)).any())

  def _step_draws(self, coords):
    epoch, chunk, step = coords

    def candidates(stream, trials, r, high):
      return self.neg_draws(epoch, chunk, step, stream, trials, r, high)
    return super()._step_draws(coords), candidates

  # -- one step -----------------------------------------------------------------

  def _sample(self, seeds: torch.Tensor, draws):
    hops, candidates = draws
    src, dst, label = seeds[0], seeds[1], seeds[2]
    g = self._graph
    out = _multihop_sample(
        g.indptr, g.indices,
        link_seeds(g.indptr, g.indices, src, dst, self.neg, candidates),
        self.fanouts, self._node_cap,
        lambda _step, hop, rows, k, w: hops(hop, rows, k, w), 0)
    out.metadata = link_metadata(out.metadata['seed_local'], src, dst,
                                 label, self.neg)
    return out

  def _gather(self, out, seeds: torch.Tensor):
    x = self._feat.get(out.node)
    edge_index = torch.stack([out.row, out.col])
    return (x, edge_index, out.edge_mask), out.metadata

  def _train_on(self, seeds: torch.Tensor, inputs, metadata) -> Tuple:
    self.model.train()
    self.optimizer.zero_grad(set_to_none=True)
    loss = link_loss_from_metadata(self._train_model(*inputs), metadata)
    loss.backward()
    self.optimizer.step()
    valid = ((seeds[0] >= 0) & (seeds[1] >= 0)).sum()
    return loss.detach(), torch.stack([torch.zeros_like(valid), valid])

  @torch.no_grad()
  def _eval_on(self, seeds: torch.Tensor, inputs, metadata) -> Tuple:
    """The batch's pairwise AUC counts: ``[2 * wins + ties, pairs]``
    over every (valid positive, negative) pair of scores (the binary
    layout: the first B pairs positive, the rest negative)."""
    self.model.eval()
    emb = self.model(*inputs)
    eli = metadata['edge_label_index'].long()
    mask = metadata['edge_label_mask']
    score = (emb[eli[0]] * emb[eli[1]]).sum(-1)
    b = self.batch_size
    ps, ns = score[:b, None], score[None, b:]
    pair_ok = mask[:b, None] & mask[None, b:]
    wins2 = 2 * ((ps > ns) & pair_ok).sum() + ((ps == ns) & pair_ok).sum()
    return (torch.stack([wins2, pair_ok.sum()]),)

  # -- the driver -----------------------------------------------------------------

  def evaluate(self, edge_label_index) -> float:
    """Held-out link AUC over ``edge_label_index``: per batch, fresh
    strict negatives, the endpoints' embedding dot products as scores,
    and every (positive, negative) comparison counted (ties a half).
    Binary negative sampling only."""
    if not self.neg.is_binary():
      raise ValueError('evaluate() needs binary negative sampling')
    rows, cols = _homogeneous_pairs(edge_label_index)
    if len(np.asarray(rows)) == 0:
      raise ValueError('evaluate() got an empty split')
    seeds = np.stack([np.stack([r, c, np.ones_like(r)]) for r, c, _ in
                      EdgeSeedBatcher(rows, cols, None, self.batch_size)])
    (counts,) = self._run_steps('eval', seeds, 0, one_chunk=True)
    wins2, total = (int(v) for v in counts.sum(0).cpu())
    return wins2 / 2 / max(total, 1)
