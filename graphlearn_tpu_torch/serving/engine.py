"""Bucketed single-shot inference engine.

Online traffic arrives as single-seed or few-seed queries.  The engine
serves them through a small ladder of **shape buckets**
(``GLT_SERVING_BUCKETS``, seed capacities): a coalesced batch pads its
tail with INVALID_ID up to the smallest bucket that fits, and every
dispatch of a bucket runs the same static shapes — per hop one launch
of the sampler kernel, then one launch of the row-gather kernel over
the whole ``[cap * W]`` tree, then (with a model) the `TreeSAGE`
forward.

**Per-seed determinism (the coalescing contract).**  The per-seed tree
expansion of the JAX engine (a ``vmap`` over seeds) is written out here
as a batch dimension, and every draw comes from
`ops.draws.hash_draws` keyed by (engine seed, seed node id, hop, row,
lane): a seed's tree depends only on the engine seed and the node id —
never on bucket capacity, slot position or co-batched traffic.  So
``nodes`` and gathered ``x`` of a coalesced dispatch are byte-identical
to serving each seed alone (`offline_reference`), and ``logits`` agree
to float tolerance across bucket shapes (a matmul over another row
count may reduce in another order).

**Streaming graphs.**  With a `streaming.StreamingGraph` attached
(``stream=`` or `Dataset.attach_stream`), every dispatch first re-pins
the newest published `GraphView` (`_repin_graph`) and reads topology
only through that one view, so a dispatch answers from exactly one
``graph_version`` while ingest publishes concurrently; `hold_graph`
freezes the version across several dispatches.

The feature table is fully device-resident; the tiered path, the
executable cache and hot model swaps are later slices (ROADMAP).
"""
from __future__ import annotations

import functools
import os
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.dataset import Dataset
from ..data.feature import _device_gather
from ..data.graph import Graph
from ..loader.fused_tree import expand_tree_levels
from ..ops.draws import hash_draws
from ..utils import INVALID_ID, resolve_device

BUCKETS_ENV = 'GLT_SERVING_BUCKETS'
DEFAULT_BUCKETS = (1, 2, 4, 8, 16)

#: ``(seed_ids [cap], hop t, rows_per_seed F_t, k, w) -> (u [cap*F_t, k],
#: gumbel [cap*F_t, w])`` — see `ops.draws.hash_draws`
DrawsProvider = Callable[[torch.Tensor, int, int, int, int],
                         Tuple[torch.Tensor, torch.Tensor]]


def resolve_buckets(spec=None) -> Tuple[int, ...]:
  """The seed-capacity ladder: an explicit sequence wins, else
  ``GLT_SERVING_BUCKETS`` (comma-separated ints), else the default.
  Returned sorted ascending, deduplicated, all positive."""
  if spec is None:
    env = os.environ.get(BUCKETS_ENV)
    if env:
      try:
        spec = [int(tok) for tok in env.split(',') if tok.strip()]
      except ValueError:
        spec = None
  if not spec:
    spec = DEFAULT_BUCKETS
  caps = sorted({int(c) for c in spec if int(c) > 0})
  if not caps:
    raise ValueError(f'no positive bucket capacities in {spec!r}')
  return tuple(caps)


@dataclass
class ServingResult:
  """De-multiplexed per-request inference output (host numpy arrays).

  ``nodes`` is ``[k, W]`` int32 — each seed's sampled tree, all levels
  concatenated (widths ``1, k1, k1*k2, ...``; INVALID_ID where masked).
  Exactly one of ``x`` (``[k, W, D]`` gathered features, model-less
  engines; a bf16 table comes back widened to f32) and ``logits``
  (``[k, C]`` f32, engines with a model) is set."""
  nodes: np.ndarray
  x: Optional[np.ndarray] = None
  logits: Optional[np.ndarray] = None

  def slice(self, lo: int, hi: int) -> 'ServingResult':
    return ServingResult(
        nodes=self.nodes[lo:hi],
        x=None if self.x is None else self.x[lo:hi],
        logits=None if self.logits is None else self.logits[lo:hi])


def _host(t: torch.Tensor) -> np.ndarray:
  if t.dtype == torch.bfloat16:
    t = t.float()
  return t.cpu().numpy()


class ServingEngine:
  """Bucketed single-shot inference over a `Dataset`.

  Args:
    data: homogeneous `Dataset` with node features, on ``device``.
    num_neighbors: per-hop fanouts of the sampling tree.
    model: optional tree-layout model (`models.tree.TreeSAGE`
      signature ``(xs, masks) -> [B, C]``); moved to ``device``.
    params: optional state dict loaded into ``model``; otherwise call
      `init_params` before serving.
    seed: the serve key — two engines with one seed answer identically.
    buckets: seed-capacity ladder override (else
      ``GLT_SERVING_BUCKETS``).
    device: where the engine runs (default ``'cuda'``; raises without
      CUDA).  The dataset must live there.
    draws: optional draws provider (`DrawsProvider`); default
      `ops.draws.hash_draws` under ``seed``.
    stream: optional `streaming.StreamingGraph` to serve from (default:
      the dataset's ``stream``, if `Dataset.attach_stream` set one).
  """

  def __init__(self, data: Dataset, num_neighbors: Sequence[int],
               model: Optional[torch.nn.Module] = None, params=None,
               seed: int = 0, buckets=None, device='cuda',
               draws: Optional[DrawsProvider] = None, stream=None):
    self.device = resolve_device(device)
    feat = data.node_features
    if feat is None:
      raise ValueError('ServingEngine needs node features')
    self._stream = stream if stream is not None else data.stream
    self._pin_lock = threading.Lock()
    self._pin_holds = 0            # guarded-by: self._pin_lock
    if self._stream is not None:
      view = self._stream.pin()
      graph, version = Graph.from_view(view), view.version
    else:
      graph, version = data.get_graph(), 0
    for what, dev in (('graph', graph.device), ('features', feat.device)):
      if dev != self.device:
        raise ValueError(f'the dataset {what} live on {dev}, the engine '
                         f'on {self.device}; build the Dataset with '
                         f'device={str(self.device)!r}')
    self.data = data
    self.fanouts = tuple(int(k) for k in num_neighbors)
    self.buckets = resolve_buckets(buckets)
    self.num_nodes = graph.num_nodes
    self._feat = feat
    #: (graph_version, indptr, indices) of the pinned view, swapped
    #: with one reference assignment
    self._pinned = (version, graph.indptr, graph.indices)
    self._seed = int(seed)
    self._draws = (draws if draws is not None
                   else functools.partial(hash_draws, self._seed))
    self.level_widths = self._level_widths()
    self.tree_width = sum(self.level_widths)
    self.model = model
    self._params_ready = False
    if model is not None:
      model.to(self.device).eval()
      if params is not None:
        model.load_state_dict(params)
        self._params_ready = True
    #: bucket capacity -> True once `warmup` ran it
    self.warm = {cap: False for cap in self.buckets}

  # -- static layout --------------------------------------------------------
  def _level_widths(self) -> Tuple[int, ...]:
    widths = [1]
    for k in self.fanouts:
      widths.append(widths[-1] * k)
    return tuple(widths)

  def max_request_seeds(self) -> int:
    return self.buckets[-1]

  def bucket_for(self, n_seeds: int) -> int:
    """Smallest capacity holding ``n_seeds`` (ValueError past the
    ladder — admission refuses those with a typed error instead)."""
    for cap in self.buckets:
      if n_seeds <= cap:
        return cap
    raise ValueError(f'{n_seeds} seeds exceed the largest bucket '
                     f'{self.buckets[-1]}')

  # -- streaming fence ------------------------------------------------------
  @property
  def graph_version(self) -> int:
    """The published graph version the engine serves (0 for a static
    graph)."""
    return self._pinned[0]

  def _repin_graph(self) -> None:
    """Swap in the newest published `GraphView` BEFORE a dispatch
    starts.  A dispatch in flight keeps the tensors it read; the swap
    is one reference assignment, so no reader sees half a graph."""
    if self._stream is None:
      return
    view = self._stream.pin()
    if view.version == self._pinned[0]:
      return
    with self._pin_lock:
      if self._pin_holds > 0:      # hold_graph(): keep the version the
        return                     # held comparison started on
      view = self._stream.pin()
      self._pinned = (view.version, view.indptr_dev, view.indices_dev)

  @contextmanager
  def hold_graph(self):
    """Freeze the pinned ``graph_version`` across SEVERAL dispatches
    (one dispatch is always torn-read-safe on its own): for comparing
    dispatches against each other while ingest publishes.  Yields the
    held version."""
    self._repin_graph()            # the newest version, then freeze
    with self._pin_lock:
      self._pin_holds += 1
      version = self._pinned[0]
    try:
      yield version
    finally:
      with self._pin_lock:
        self._pin_holds -= 1

  # -- device path ----------------------------------------------------------
  def _collect(self, seeds: torch.Tensor, indptr: torch.Tensor,
               indices: torch.Tensor) -> torch.Tensor:
    """``[cap]`` seeds -> ``[cap, W]`` sampled trees.  Level ``t`` of
    the batched expansion is seed-major (slot ``i`` owns rows
    ``i*F_t .. (i+1)*F_t``), each seed's block parent-major — the order
    the JAX engine's per-seed ``vmap`` concatenates."""
    cap = seeds.shape[0]

    def draws(t: int, k: int, w: int):
      return self._draws(seeds, t, self.level_widths[t], k, w)

    levels, _ = expand_tree_levels(indptr, indices, seeds, self.fanouts,
                                   draws)
    return torch.cat([lvl.view(cap, -1) for lvl in levels], dim=1)

  def _split_levels(self, flat: torch.Tensor) -> List[torch.Tensor]:
    """``[cap, W, ...]`` -> per-level ``[cap * w_t, ...]`` tensors in
    tree-layout order."""
    out, off = [], 0
    cap = flat.shape[0]
    for w in self.level_widths:
      out.append(flat[:, off:off + w].reshape((cap * w,) + flat.shape[2:]))
      off += w
    return out

  # -- host side ------------------------------------------------------------
  def init_params(self, generator: torch.Generator) -> dict:
    """Init the model's parameters from ``generator`` (see
    `TreeSAGE.reset_parameters`); returns the state dict."""
    if self.model is None:
      raise ValueError('init_params() needs a model')
    self.model.reset_parameters(generator)
    self._params_ready = True
    return self.model.state_dict()

  def _pad(self, seeds: np.ndarray, cap: int) -> torch.Tensor:
    out = np.full((cap,), INVALID_ID, np.int32)
    out[:len(seeds)] = np.asarray(seeds, np.int32)
    return torch.from_numpy(out).to(self.device)

  @torch.inference_mode()
  def _dispatch(self, padded: torch.Tensor) -> ServingResult:
    """One bucket dispatch (``padded`` already at a bucket capacity):
    re-pin the graph, sample, gather every tree row in one launch, then
    the model.  The graph is read once here: a concurrent publish lands
    in the next dispatch, never mid-run."""
    if self.model is not None and not self._params_ready:
      raise ValueError(
          'ServingEngine has a model but no params — call '
          'init_params(generator) (or pass params=) before serving')
    self._repin_graph()
    _, indptr, indices = self._pinned
    nodes = self._collect(padded, indptr, indices)
    cap = nodes.shape[0]
    x = _device_gather(self._feat.hot_tier, nodes.reshape(-1),
                       self._feat.id2index).view(cap, self.tree_width, -1)
    if self.model is None:
      return ServingResult(nodes=_host(nodes), x=_host(x))
    masks = [lvl >= 0 for lvl in self._split_levels(nodes)]
    logits = self.model(self._split_levels(x), masks)
    return ServingResult(nodes=_host(nodes), logits=_host(logits))

  def infer(self, seeds, cap: Optional[int] = None) -> ServingResult:
    """Serve one (possibly coalesced) seed batch; results sliced back
    to ``len(seeds)``.  ``cap`` pins the bucket (the frontend picks it
    once per coalesced dispatch); default = smallest fitting."""
    seeds = np.asarray(seeds).reshape(-1)
    cap = self.bucket_for(len(seeds)) if cap is None else cap
    return self._dispatch(self._pad(seeds, cap)).slice(0, len(seeds))

  def offline_reference(self, seeds,
                        cap: Optional[int] = None) -> ServingResult:
    """Every seed served ALONE — through the smallest bucket by
    default, or a pinned ``cap`` — the reference the coalesced path is
    held to."""
    parts = [self.infer(np.asarray([s]), cap=cap)
             for s in np.asarray(seeds).reshape(-1)]
    return ServingResult(
        nodes=np.concatenate([p.nodes for p in parts]),
        x=(None if parts[0].x is None
           else np.concatenate([p.x for p in parts])),
        logits=(None if parts[0].logits is None
                else np.concatenate([p.logits for p in parts])))

  def warmup(self) -> dict:
    """Run every bucket once at server start (which also builds the
    kernels), with valid ids and, where the bucket has room, one
    INVALID tail slot.  Returns ``{'buckets': {...}, 'secs': wall}``."""
    import time
    t0 = time.perf_counter()
    n = min(self.num_nodes, 8)
    for cap in self.buckets:
      seeds = np.arange(cap, dtype=np.int32) % n
      if cap > 1:
        seeds[-1] = INVALID_ID
      self._dispatch(torch.from_numpy(seeds).to(self.device))
      self.warm[cap] = True
    return {'buckets': dict(self.warm),
            'secs': round(time.perf_counter() - t0, 3)}
