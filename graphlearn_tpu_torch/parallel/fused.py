"""Fused data-parallel epochs over the partition mesh (the JAX package's
`parallel/fused.py:65-1406`: `_MeshEpochDriver`, `FusedDistEpoch`,
`FusedDistTreeEpoch`, `FusedDistLinkEpoch`), for stores wholly on the
card.

JAX runs a mesh epoch as one SPMD `lax.scan` program.  The port's mesh
holds its ``P`` partitions on one card (`parallel.dp.Mesh`), and its
epochs run the same steps eagerly, one after another: each step
exchanges every hop's frontier to its owners, collects features and
labels, and takes the data-parallel optimizer step.  Nothing in `run`
waits for the card; the returned `EpochStats` does when read.

The schedule is JAX's: the host shuffle of ``P * B`` seeds a step, and
the draw coordinates ``draws(epoch, step, hop, rows, k, w, gns,
owner)``, where ``epoch`` counts `run` calls from 1 (`evaluate` draws
at epoch 0, JAX's eval fold domain ``fold_in(fold_in(key(seed), 0),
1)``), ``step`` is the step's index in the epoch and ``owner`` the
partition that samples the rows (JAX's key ``fold_in(fold_in(fold_in(
fold_in(key(seed), epoch), step), hop), owner)``).  The default
provider is the per-batch loader's, `ops.draws.TorchDraws`, at
coordinates ``(epoch, step, hop, owner)``: these epochs run eagerly, so
nothing replays a seed baked into a graph, and a generator's uniforms
cost the card less than `ops.draws.CounterDraws`' hash (which the
single-card epochs need for their captured steps).

`FusedDistLinkEpoch`'s provider also draws the strict negatives,
``draws.negatives(epoch, step, stream, trials, r, high, part)`` (JAX's
``fold_in(fold_in(step key, part), 977)``, split into the rows and the
columns); the default takes them from a generator at ``(epoch, step, -1
- stream, part)``.

The exchange counters of every step are folded into the sampler's
accumulator, so ``sampler.exchange_stats()`` reads what the per-batch
loader would have counted at the same draws.  The slack is static:
``'adaptive'`` retunes between batches on the host, which a fused epoch
does not do.

Partition failover: at each chunk boundary (a `run`, an `evaluate`) the
driver closes a pending adoption's recovery clock, runs owner
supervision and the book fence (`_chunk_fence`), so a ``partition.owner``
kill lands at the same arrival as in JAX and every step of the chunk
reads one pinned view.

Snapshots (`loader.fused._SnapshotHooks`): a mesh epoch is one chunk,
as JAX's untiered epoch is one program, so it passes the
``fused.dispatch`` seam once, before its first step, and saves once at
its end whatever the cadence; a restored epoch that had finished returns
its saved stats without running a step, and the next `run` continues
with the next epoch.  Not ported: tiered stores and captured mesh steps
(the ROADMAP's slice catalogue, item 5), and the rollback of a stalled
mesh epoch to its last snapshot with the stall watchdog (JAX's
`distributed/resilience.py`, item 14).
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..loader.fused import EpochStats, Rematerialized, _SnapshotHooks
from ..loader.node_loader import SeedBatcher
from ..loader.transform import Batch
from ..models.train import _correct, supervised_loss
from ..ops.draws import TorchDraws
from ..telemetry.aggregate import per_hop_padding
from ..telemetry.recorder import recorder
from ..telemetry.spans import span
from ..testing import chaos
from ..sampler.base import NegativeSampling
from .dist_data import DistDataset
from .dist_sampler import (DistLinkNeighborSampler, DistNeighborSampler,
                           _dist_one_hop, _stacked_batch, dist_gather_multi,
                           pack_link_seeds_relabeled, packed_rows,
                           resolve_exchange_slack)
from .dp import (Mesh, local_piece, make_dp_eval_step,
                 make_dp_supervised_step, make_dp_unsupervised_step)
from .exchange import dest_histogram
from .partition_book import range_owner_fn

#: ``draws(epoch, step, hop, rows, k, w, gns=False, owner=0) -> (u
#: [rows, k], gumbel [rows, w])``
MeshEpochDraws = Callable[..., Tuple[torch.Tensor, torch.Tensor]]


def _generator_draws(seed: int, device) -> MeshEpochDraws:
  gen = TorchDraws(seed, device)

  def draws(epoch, step, hop, rows, k, w, gns=False, owner=0):
    return gen.draw((epoch, step, hop, owner), rows, k, w, gns)

  def negatives(epoch, step, stream, trials, r, high, part=None):
    return gen.int_draw((epoch, step, -1 - int(stream), int(part or 0)),
                        trials, r, high)
  draws.negatives = negatives
  return draws


def _node_items(dataset: DistDataset, input_nodes,
                input_space: str) -> np.ndarray:
  """The node epochs' batcher items: the seeds, relabelled when
  ``input_space='old'``."""
  seeds = np.asarray(input_nodes).reshape(-1)
  if input_space == 'old' and dataset.old2new is not None:
    seeds = dataset.old2new[seeds]
  return seeds


class _EpochDraws:
  """An epoch's draws in the samplers' form: ``draws(step, hop, rows, k,
  w, gns, owner)`` and ``negatives(step, stream, trials, r, high,
  part)`` (the link samplers'), at the epoch's coordinate."""

  def __init__(self, draws: MeshEpochDraws, epoch: int):
    self.draws, self.epoch = draws, epoch

  def __call__(self, step, hop, rows, k, w, gns=False, owner=0):
    return self.draws(self.epoch, step, hop, rows, k, w, gns, owner)

  def negatives(self, step, stream, trials, r, high, part=None):
    return self.draws.negatives(self.epoch, step, stream, trials, r, high,
                                part=part)


class _MeshEpochDriver(_SnapshotHooks):
  """The host driver the fused mesh epochs share: the seed schedule,
  the draw coordinates, `run`, `evaluate` and the ``hop.padding``
  events.  A subclass supplies ``_train_step(seeds, draws, step,
  any_valid)`` -> ``(loss, correct, valid, hop_counts [H+1] or None)``
  (``seeds`` a step's ``[P, B]`` seeds, or ``[P, B, 2|3]`` seed edges;
  ``any_valid``: the step holds a valid seed, known on the host) and
  ``_eval_step(seeds, draws, step)`` -> ``(correct, total)``."""

  _owner = 'the fused mesh epoch'

  def _init_driver(self, dataset: DistDataset, make_sampler: Callable,
                   items: np.ndarray, model, optimizer, batch_size: int,
                   mesh: Optional[Mesh], shuffle: bool, drop_last: bool,
                   seed: int, exchange_slack,
                   draws: Optional[MeshEpochDraws], device,
                   need_labels: bool = True):
    """``make_sampler(dataset, mesh=, collect_features=, seed=,
    exchange_slack=, device=)`` builds the epoch's sampler; ``items``
    are what the batcher splits (relabelled seeds, or row indices of a
    packed seed-edge table)."""
    if dataset.node_features is None or (need_labels
                                         and dataset.node_labels is None):
      raise ValueError(f'{self._owner} needs node features'
                       + (' and labels' if need_labels else ''))
    if exchange_slack == 'adaptive':
      raise ValueError(
          "exchange_slack='adaptive' retunes between batches on the "
          f"host; {self._owner} takes a static slack ('auto' or a "
          'number) — or use the per-batch loader for adaptive tuning')
    if dataset.node_features.is_tiered:
      raise NotImplementedError(
          f'{self._owner} runs on stores wholly on the card; tiered '
          '(split_ratio < 1) fused mesh epochs are not ported yet: they '
          'are ROADMAP Queue 1 item 5')
    self.sampler = make_sampler(
        dataset, mesh=mesh, collect_features=True, seed=seed,
        exchange_slack=resolve_exchange_slack(exchange_slack, shuffle),
        device=device)
    self.ds = dataset
    self.mesh = self.sampler.mesh
    self.device = self.sampler.device
    self.num_parts = dataset.num_partitions
    self.batch_size = int(batch_size)
    self.model = model
    self.optimizer = optimizer
    self._batcher = SeedBatcher(items, self.batch_size * self.num_parts,
                                shuffle, drop_last, seed)
    self.draws = (draws if draws is not None
                  else _generator_draws(seed, self.device))
    self._epoch_idx = 0

  def __len__(self) -> int:
    return len(self._batcher)

  def _upload(self, a: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a, np.int32))
    if self.device.type == 'cuda':
      return t.pin_memory().to(self.device, non_blocking=True)
    return t

  def _steps(self, flat: np.ndarray) -> torch.Tensor:
    """The batcher's ``[S, P*B]`` items as the steps' seeds on the
    card."""
    return self._upload(flat.reshape(-1, self.num_parts, self.batch_size))

  def data_plane_state(self) -> dict:
    return {'epoch_idx': self._epoch_idx,
            'batcher': self._batcher.state_dict(),
            'sampler': self.sampler.data_plane_state()}

  def load_data_plane_state(self, plane: dict) -> None:
    self._epoch_idx = int(np.asarray(plane['epoch_idx'])) - 1
    self._batcher.load_state_dict(plane['batcher'], mid_epoch=True)
    self.sampler.load_data_plane_state(plane['sampler'])

  def run(self) -> EpochStats:
    """One training epoch; returns its lazy `EpochStats`."""
    flat = np.stack(list(self._batcher))           # [S, P*B]
    s = flat.shape[0]
    self._epoch_idx += 1
    prog = self._take_resume(s)
    if prog is not None and int(np.asarray(prog['next_chunk'])) >= s:
      # the snapshot was taken at this epoch's end: its stats, no step
      losses = torch.from_numpy(np.asarray(prog['losses'])).to(self.device)
      counts = torch.from_numpy(np.asarray(prog['counts'])).to(self.device)
      hops = prog.get('hops')
      if hops is not None:
        self._emit_hop_events(torch.from_numpy(np.asarray(hops)), s)
      return EpochStats(losses, counts[:, 0].sum(), counts[:, 1].sum())
    seeds = self._steps(flat)
    draws = _EpochDraws(self.draws, self._epoch_idx)
    with span('fused.epoch', scope=type(self).__name__,
              epoch=self._epoch_idx, steps=s, tiered=False):
      # the epoch is one chunk: one dispatch span over its steps
      with span('fused.dispatch'):
        chaos.fused_dispatch_check(chunk=0, epoch=self._epoch_idx)
        self._chunk_fence()
        losses, counts, hops = [], [], None
        for i in range(s):
          loss, correct, valid, hop = self._train_step(
              seeds[i], draws, i, bool((flat[i] >= 0).any()))
          losses.append(loss)
          counts.append(torch.stack([correct, valid]))
          hops = hop if hops is None else hops + hop
        losses, counts = torch.stack(losses), torch.stack(counts)
      self._emit_hop_events(hops, s)
      self._save_chunk_snapshot(s, s, losses, counts, force=True, hops=hops)
    return EpochStats(losses, counts[:, 0].sum(), counts[:, 1].sum())

  def evaluate(self, input_nodes, input_space: str = 'old') -> float:
    """Accuracy over ``input_nodes`` (e.g. the test split); its
    exchanges count in `exchange_stats`, as in JAX."""
    ids = np.asarray(input_nodes).reshape(-1)
    if ids.dtype == np.bool_:
      ids = np.nonzero(ids)[0]
    if ids.size == 0:
      raise ValueError('evaluate() got an empty split')
    if input_space == 'old' and self.ds.old2new is not None:
      ids = self.ds.old2new[ids]
    flat = np.stack(list(SeedBatcher(ids, self.batch_size * self.num_parts,
                                     shuffle=False)))
    seeds = self._steps(flat)
    draws = _EpochDraws(self.draws, 0)
    self._chunk_fence()
    counts = torch.stack([torch.stack(self._eval_step(seeds[i], draws, i))
                          for i in range(seeds.shape[0])])
    correct, total = (int(v) for v in counts.sum(0).cpu())
    return correct / max(total, 1)

  def _chunk_fence(self) -> None:
    """The chunk boundary (a mesh epoch is one chunk; `evaluate` is
    another), as JAX's ``_chunk_arrs``: close a pending adoption's
    recovery clock (the previous chunk has been dispatched), run owner
    supervision, then the book fence — every step of the chunk reads the
    view pinned here."""
    self.sampler._complete_recovery()
    self.sampler._partition_supervision()
    self.sampler.maybe_refresh_book()

  def _emit_hop_events(self, hop_counts: torch.Tensor, steps: int) -> None:
    """One ``hop.padding`` event a hop for the epoch (its node count,
    capacity and fill), only when the recorder is on: reading the
    counts waits for the card."""
    if not recorder.enabled or hop_counts is None:
      return
    fanouts = getattr(self, 'fanouts', None) or self.sampler.fanouts
    rows = per_hop_padding(
        hop_counts.cpu().numpy(),
        self.batch_size * self.num_parts * max(int(steps), 1), fanouts)
    for row in rows:
      recorder.emit('hop.padding', scope=type(self).__name__,
                    epoch=self._epoch_idx, steps=int(steps), **row)

  def cluster_exchange_stats(self) -> dict:
    """The sampler's `cluster_exchange_stats` (the epochs' exchanges
    folded in)."""
    return self.sampler.cluster_exchange_stats()


class FusedDistEpoch(_MeshEpochDriver):
  """Data-parallel subgraph epochs over the mesh.  Each step is the
  mesh sampler's sample-and-collect (`DistNeighborSampler`, the same
  program the per-batch loader dispatches) and the data-parallel step
  (`make_dp_supervised_step`).

  Example::

      model = GraphSAGE(100, 64, 47, num_layers=2).to('cuda')
      opt = torch.optim.Adam(model.parameters(), lr=3e-3)
      fused = FusedDistEpoch(dist_ds, [10, 5], train_idx, model, opt,
                             batch_size=512, seed=0)
      for _ in range(epochs):
        stats = fused.run()

  Args:
    dataset: a `DistDataset` wholly on the card (a tiered one raises
      NotImplementedError).
    num_neighbors: per-hop fanouts.
    input_nodes: global seed ids (``input_space='old'`` maps them
      through ``dataset.old2new``).
    model / optimizer: trained in place (the model's ``(x, edge_index,
      edge_mask)`` forward on each partition's piece).
    batch_size: seeds a partition a step.
    mesh: the partitions' `Mesh` (default: all of them on ``device``).
    shuffle / drop_last / seed: epoch controls.
    exchange_slack: static capacity factor (``'auto'``: the shuffled
      default; ``'adaptive'`` raises ValueError).
    remat: recompute the forward in the backward; `evaluate` runs
      without it.
    draws: the ``draws(epoch, step, hop, rows, k, w, gns, owner)``
      provider (module docstring).
  """

  _owner = 'FusedDistEpoch'

  def __init__(self, dataset: DistDataset, num_neighbors, input_nodes,
               model, optimizer: torch.optim.Optimizer, batch_size: int,
               mesh: Optional[Mesh] = None, shuffle: bool = True,
               drop_last: bool = False, seed: int = 0,
               input_space: str = 'old', exchange_slack='auto',
               remat: bool = False, draws: Optional[MeshEpochDraws] = None,
               device='cuda'):
    self._init_driver(
        dataset, functools.partial(DistNeighborSampler,
                                   num_neighbors=num_neighbors),
        _node_items(dataset, input_nodes, input_space), model,
        optimizer, batch_size, mesh, shuffle, drop_last, seed,
        exchange_slack, draws, device)
    step_model = Rematerialized(model) if remat else model
    self._dp_step = make_dp_supervised_step(step_model, optimizer,
                                            self.batch_size, self.mesh)
    self._dp_eval = make_dp_eval_step(model, self.batch_size, self.mesh)

  def _collate(self, seeds: torch.Tensor, draws, step: int) -> Batch:
    out = self.sampler._sample_collect(seeds, draws, step)
    return Batch(x=out['x'], y=out['y'],
                 edge_index=torch.stack([out['row'], out['col']], dim=1),
                 node=out['node'], node_mask=out['node'] >= 0,
                 edge_mask=out['row'] >= 0, batch=seeds,
                 batch_size=self.batch_size,
                 num_sampled_nodes=out['num_sampled_nodes'],
                 metadata={'seed_local': out['seed_local']})

  def _train_step(self, seeds, draws, step, any_valid):
    # JAX's mesh step has no padding guard: a step of padding alone
    # still moves Adam (the batcher never yields one)
    batch = self._collate(seeds, draws, step)
    loss, correct = self._dp_step(batch)
    return (loss, correct, (seeds >= 0).sum(),
            batch.num_sampled_nodes.sum(0))

  def _eval_step(self, seeds, draws, step):
    return self._dp_eval(self._collate(seeds, draws, step))


class FusedDistTreeEpoch(_MeshEpochDriver):
  """Tree-layout data-parallel epochs over the mesh (the mesh twin of
  `loader.fused_tree.FusedTreeEpoch`).  Per step, every hop exchanges
  each partition's level frontier to its owners, which sample it in
  arrival order (`_dist_one_hop`, no dedup); all levels' features and
  the seeds' labels ride one `dist_gather_multi` exchange; each
  partition's piece runs `models.TreeSAGE`, and the gradients are
  averaged over the partitions.  A step with no valid seed leaves the
  optimizer untouched, as JAX's guard does.

  Level ids past the feature exchange's capacity come back as zero
  rows while staying valid in the mean's count (counted in
  ``dist.feature.dropped``), as in JAX.

  Args:
    dataset / num_neighbors / input_nodes / batch_size / mesh /
    shuffle / drop_last / seed / input_space / exchange_slack / remat /
    draws: as `FusedDistEpoch`.
    model: a `models.TreeSAGE` with ``num_layers == len(num_neighbors)``.
    optimizer: over the model's parameters.
  """

  _owner = 'FusedDistTreeEpoch'

  def __init__(self, dataset: DistDataset, num_neighbors, input_nodes,
               model, optimizer: torch.optim.Optimizer, batch_size: int,
               mesh: Optional[Mesh] = None, shuffle: bool = True,
               drop_last: bool = False, seed: int = 0,
               input_space: str = 'old', exchange_slack='auto',
               remat: bool = False, draws: Optional[MeshEpochDraws] = None,
               device='cuda'):
    self.fanouts = tuple(int(k) for k in num_neighbors)
    if getattr(model, 'num_layers', len(self.fanouts)) != len(self.fanouts):
      raise ValueError(
          f'model.num_layers={model.num_layers} must equal '
          f'len(num_neighbors)={len(self.fanouts)}')
    # the sampler's scaffolding (mesh, tables, counters) without its
    # multi-hop induce
    self._init_driver(
        dataset, functools.partial(DistNeighborSampler, num_neighbors=[]),
        _node_items(dataset, input_nodes, input_space), model,
        optimizer, batch_size, mesh, shuffle, drop_last, seed,
        exchange_slack, draws, device)
    self._train_model = Rematerialized(model) if remat else model

  def _expand_collect(self, seeds: torch.Tensor, draws, step: int):
    """The tree expansion and the one feature/label exchange for the
    ``[P, B]`` seeds: ``(xs, masks, y, hop_counts)``, ``xs[t]`` ``[P,
    F_t, D]``, ``hop_counts[t]`` the valid ids of level ``t`` over the
    partitions."""
    smp = self.sampler
    g = self.ds.graph
    p = self.num_parts
    levels, frontier = [seeds], seeds
    fr_stats = torch.zeros(3, dtype=torch.int64, device=self.device)
    # the src -> dst range attribution of both exchanges
    range_owner = range_owner_fn(smp._bounds_t)
    attr_fr = torch.zeros((p, p), dtype=torch.int64, device=self.device)
    for h, k in enumerate(self.fanouts):
      attr_fr += dest_histogram(frontier, range_owner, p)
      nbrs, mask, _, _, st = _dist_one_hop(
          self.mesh, g.indptr, g.indices, smp._bounds_t, frontier, k, draws,
          step, h, smp._channel_cap(frontier.shape[1], 'frontier'),
          sort_locality=False, book=smp._book_lanes)
      fr_stats += st
      frontier = torch.where(mask, nbrs, -1).reshape(p, -1)
      levels.append(frontier)
    all_ids = torch.cat(levels, dim=1)
    (feats, labels), ft_stats = dist_gather_multi(
        self.mesh, (self.ds.node_features.shards, self.ds.node_labels),
        smp._bounds_t, all_ids,
        capacity=smp._channel_cap(all_ids.shape[1], 'feature'),
        book=smp._book_lanes, book_keys=('fshard', 'lshard'))
    smp._accumulate_stats(torch.cat([fr_stats, ft_stats]))
    smp._accumulate_attr(attr_fr, dest_histogram(all_ids, range_owner, p))
    xs = list(torch.split(feats, [lvl.shape[1] for lvl in levels], dim=1))
    masks = [lvl >= 0 for lvl in levels]
    hop_counts = torch.stack([m.sum() for m in masks])
    return xs, masks, labels[:, :self.batch_size], hop_counts

  def _train_step(self, seeds, draws, step, any_valid):
    xs, masks, y, hop_counts = self._expand_collect(seeds, draws, step)
    self.model.train()
    self.optimizer.zero_grad(set_to_none=True)
    losses, correct = [], []
    for p in range(self.num_parts):
      logits = self._train_model([x[p] for x in xs], [m[p] for m in masks])
      loss = supervised_loss(logits, y[p], seeds[p], self.batch_size)
      loss.backward()
      losses.append(loss.detach())
      correct.append(_correct(logits, y[p], seeds[p], self.batch_size))
    self.mesh.mean_gradients(self.model.parameters())
    if any_valid:
      self.optimizer.step()
    return (torch.stack(losses).mean(), torch.stack(correct).sum(),
            (seeds >= 0).sum(), hop_counts)

  @torch.no_grad()
  def _eval_step(self, seeds, draws, step):
    xs, masks, y, _ = self._expand_collect(seeds, draws, step)
    self.model.eval()
    correct = []
    for p in range(self.num_parts):
      logits = self.model([x[p] for x in xs], [m[p] for m in masks])
      correct.append(_correct(logits, y[p], seeds[p], self.batch_size))
    return torch.stack(correct).sum(), (seeds >= 0).sum()


class FusedDistLinkEpoch(_MeshEpochDriver):
  """Data-parallel link-prediction epochs over the mesh (JAX's
  `FusedDistLinkEpoch`).  Each step is the mesh link sampler's step
  (`DistLinkNeighborSampler`: every partition's seed edges, strict
  negatives against the whole sharded graph, the endpoints' expansion
  and feature collection, the same program `DistLinkNeighborLoader`
  dispatches) and the data-parallel link-loss step
  (`make_dp_unsupervised_step`: binary or triplet by the metadata).

  Its draws provider also draws the negatives (module docstring).

  Args:
    dataset: a `DistDataset` wholly on the card (a tiered one raises
      NotImplementedError); labels are not needed.
    num_neighbors: per-hop fanouts of the endpoint expansion.
    edge_label_index: ``[2, E]`` (or ``(rows, cols)``) seed edges.
    model / optimizer: an embedding model (``(x, edge_index, edge_mask)
      -> [N, D]``), trained in place.
    batch_size: seed edges a partition a step.
    neg_sampling: ``'binary'`` (default) or ``('triplet', amount)``.
    edge_label: optional integer labels (binary mode shifts them up by
      one).
    Others as `FusedDistEpoch`.
  """

  _owner = 'FusedDistLinkEpoch'

  def __init__(self, dataset: DistDataset, num_neighbors, edge_label_index,
               model, optimizer: torch.optim.Optimizer, batch_size: int,
               neg_sampling='binary', edge_label=None,
               mesh: Optional[Mesh] = None, shuffle: bool = True,
               drop_last: bool = False, seed: int = 0,
               input_space: str = 'old', exchange_slack='auto',
               remat: bool = False, draws: Optional[MeshEpochDraws] = None,
               device='cuda'):
    mode = NegativeSampling.cast(neg_sampling)
    self.pairs = pack_link_seeds_relabeled(
        edge_label_index, edge_label, mode.mode if mode else None, dataset,
        input_space)
    self._init_driver(
        dataset, functools.partial(DistLinkNeighborSampler,
                                   num_neighbors=num_neighbors,
                                   neg_sampling=neg_sampling),
        np.arange(len(self.pairs)), model, optimizer, batch_size, mesh,
        shuffle, drop_last, seed, exchange_slack, draws, device,
        need_labels=False)
    step_model = Rematerialized(model) if remat else model
    self._dp_step = make_dp_unsupervised_step(step_model, optimizer,
                                              self.mesh)

  def _steps(self, flat: np.ndarray, pairs=None) -> torch.Tensor:
    """Row indices ``[S, P*B]`` of ``pairs`` (default: the training
    table) -> the packed seed edges ``[S, P, B, 2|3]`` on the card."""
    pairs = self.pairs if pairs is None else pairs
    return self._upload(packed_rows(pairs, flat).reshape(
        -1, self.num_parts, self.batch_size, pairs.shape[1]))

  def _collate(self, pairs: torch.Tensor, draws, step: int) -> Batch:
    out = self.sampler._sample_link(pairs, draws, step)
    return _stacked_batch(out, out['metadata'], self.batch_size)

  def _train_step(self, pairs, draws, step, any_valid):
    # as JAX's scan body: every step moves the optimizer
    loss = self._dp_step(self._collate(pairs, draws, step))
    valid = ((pairs[..., 0] >= 0) & (pairs[..., 1] >= 0)).sum()
    return loss, torch.zeros((), dtype=torch.int64,
                             device=self.device), valid, None

  def evaluate(self, edge_label_index, input_space: str = 'old') -> float:
    """Held-out link AUC over ``edge_label_index``: per step of ``P *
    B`` edges, fresh strict negatives (epoch 0's draws, JAX's eval
    domain), each partition's embeddings, and every (positive,
    negative) score comparison of a partition counted, ties a half.
    Binary negative sampling only; its exchanges count in
    `exchange_stats`."""
    if self.sampler.neg_mode != 'binary':
      raise ValueError('evaluate() needs binary negative sampling')
    pairs = pack_link_seeds_relabeled(edge_label_index, None, 'binary',
                                      self.ds, input_space)
    if pairs.shape[0] == 0:
      raise ValueError('evaluate() got an empty split')
    if pairs.shape[1] != self.pairs.shape[1]:
      # the seed rows keep the training table's width (JAX pads ones)
      pairs = np.concatenate([pairs, np.ones(
          (pairs.shape[0], self.pairs.shape[1] - pairs.shape[1]),
          pairs.dtype)], axis=1)
    flat = np.stack(list(SeedBatcher(np.arange(len(pairs)),
                                     self.batch_size * self.num_parts,
                                     shuffle=False)))
    steps = self._steps(flat, pairs)
    draws = _EpochDraws(self.draws, 0)
    self._chunk_fence()
    b = self.batch_size
    counts = []
    self.model.eval()
    with torch.no_grad():
      for i in range(steps.shape[0]):
        batch = self._collate(steps[i], draws, i)
        for p in range(self.num_parts):
          piece = local_piece(batch, p)
          emb = self.model(piece.x, piece.edge_index, piece.edge_mask)
          eli = piece.metadata['edge_label_index'].long()
          mask = piece.metadata['edge_label_mask']
          score = (emb[eli[0]] * emb[eli[1]]).sum(-1)
          ps, ns = score[:b, None], score[None, b:]
          ok = mask[:b, None] & mask[None, b:]
          counts.append(torch.stack([
              2 * ((ps > ns) & ok).sum() + ((ps == ns) & ok).sum(),
              ok.sum()]))
    wins2, total = (int(v) for v in torch.stack(counts).sum(0).cpu())
    return wins2 / 2 / max(total, 1)
