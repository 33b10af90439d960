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

**Tiered tables.**  With ``split_ratio < 1`` a dispatch samples the
trees on the card, brings the ``[cap, W]`` node ids to the host once,
deduplicates them (`np.unique`, padded to a power of two with
INVALID_ID), fills the distinct rows through the tiered
`data.Feature.get` under the ``'serving'`` cache scope (hot rows by the
row-gather kernel, victim-cache hits on the card, misses by the
cold-gather kernel from pinned host memory) and expands them back by
the inverse map on the card.  Each rider's rows are byte-equal to the
fully-hot engine's.  `last_collect` and `last_cold_fill` hold the
dispatch's sampling and fill ``(monotonic t0, seconds)``.

**Model versions.**  `set_params` installs a new state dict and bumps
``model_version`` (`serving.swap.hot_swap` quiesces and parity-checks
first); `validate_params` refuses a candidate whose keys, shapes or
dtypes differ from the model's.  ``params=`` on `infer` and
`offline_reference` runs a candidate without installing it, through
`torch.func.functional_call` over the engine's module.

**Kernel builds.**  A dispatch is eager torch and compiles nothing; what
a fresh process compiles is its kernels (`_build`).  `warmup` makes them
present first, through the durable kernel-build cache
(``GLT_AOT_CACHE_DIR``, `serving.aot_cache`), and `compile_count` counts
the ``nvcc`` runs this process started since the engine was built — 0
for a replica whose kernels were restored or already loaded.
"""
from __future__ import annotations

import functools
import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _build
from ..data.dataset import Dataset
from ..data.feature import _device_gather
from ..data.graph import Graph
from ..loader.fused_tree import expand_tree_levels
from ..ops.draws import hash_draws
from ..utils import INVALID_ID, next_power_of_two, resolve_device

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
    self._tiered = feat.is_tiered
    #: (monotonic t0, seconds) of the last tiered dispatch's sampling and
    #: of its feature fill
    self.last_collect = self.last_cold_fill = None
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
    #: bumped by `set_params` (the hot-swap commit)
    self.model_version = 0
    self._nvcc_base = _build.NVCC_RUNS
    #: kernel libraries `warmup` restored from the kernel-build cache
    self._aot_restores = 0
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
  def _dispatch(self, padded: torch.Tensor,
                params: Optional[dict] = None) -> ServingResult:
    """One bucket dispatch (``padded`` already at a bucket capacity):
    re-pin the graph, sample, gather every tree row in one launch, then
    the model — under ``params`` (a state dict on the engine's device)
    when given, else the installed version.  The graph is read once
    here: a concurrent publish lands in the next dispatch, never
    mid-run."""
    if self.model is not None and params is None and not self._params_ready:
      raise ValueError(
          'ServingEngine has a model but no params — call '
          'init_params(generator) (or pass params=) before serving')
    self._repin_graph()
    _, indptr, indices = self._pinned
    t0 = time.monotonic()
    nodes = self._collect(padded, indptr, indices)
    if self._tiered:
      nodes_h = nodes.cpu().numpy()
      self.last_collect = (t0, time.monotonic() - t0)
      x = self._tiered_fill(nodes_h)
    else:
      x = _device_gather(self._feat.hot_tier, nodes.reshape(-1),
                         self._feat.id2index)
    cap = nodes.shape[0]
    x = x.view(cap, self.tree_width, -1)
    if self.model is None:
      return ServingResult(nodes=_host(nodes), x=_host(x))
    masks = [lvl >= 0 for lvl in self._split_levels(nodes)]
    args = (self._split_levels(x), masks)
    logits = (self.model(*args) if params is None else
              torch.func.functional_call(self.model, params, args))
    return ServingResult(nodes=_host(nodes), logits=_host(logits))

  def _tiered_fill(self, nodes_h: np.ndarray) -> torch.Tensor:
    """``[cap, W]`` host node ids -> ``[cap * W, D]`` rows on the card:
    each distinct id fetched once per dispatch (riders' trees overlap
    under skewed traffic), then expanded by the inverse map."""
    uniq, inverse = np.unique(nodes_h.reshape(-1), return_inverse=True)
    uniq_p = np.full(next_power_of_two(max(len(uniq), 1)), INVALID_ID,
                     np.int64)
    uniq_p[:len(uniq)] = uniq
    t0 = time.monotonic()
    x_u = self._feat.get(uniq_p, scope='serving')
    inv = torch.from_numpy(inverse.reshape(-1)).to(self.device)
    x = x_u.index_select(0, inv)
    self.last_cold_fill = (t0, time.monotonic() - t0)
    return x

  def infer(self, seeds, cap: Optional[int] = None,
            params: Optional[dict] = None) -> ServingResult:
    """Serve one (possibly coalesced) seed batch; results sliced back
    to ``len(seeds)``.  ``cap`` pins the bucket (the frontend picks it
    once per coalesced dispatch); default = smallest fitting.
    ``params`` runs a candidate state dict for this call without
    installing it (hot-swap validation)."""
    seeds = np.asarray(seeds).reshape(-1)
    cap = self.bucket_for(len(seeds)) if cap is None else cap
    if params is not None:
      params = self._params_on_device(params)
    return self._dispatch(self._pad(seeds, cap),
                          params=params).slice(0, len(seeds))

  def offline_reference(self, seeds, cap: Optional[int] = None,
                        params: Optional[dict] = None) -> ServingResult:
    """Every seed served ALONE — through the smallest bucket by
    default, or a pinned ``cap`` — the reference the coalesced path is
    held to (under ``params`` when given)."""
    if params is not None:
      params = self._params_on_device(params)
    parts = [self.infer(np.asarray([s]), cap=cap, params=params)
             for s in np.asarray(seeds).reshape(-1)]
    return ServingResult(
        nodes=np.concatenate([p.nodes for p in parts]),
        x=(None if parts[0].x is None
           else np.concatenate([p.x for p in parts])),
        logits=(None if parts[0].logits is None
                else np.concatenate([p.logits for p in parts])))

  # -- model versions -------------------------------------------------------
  def _params_on_device(self, params) -> dict:
    self.validate_params(params)
    return {k: torch.as_tensor(v).to(self.device) for k, v in params.items()}

  def validate_params(self, params) -> None:
    """Refuse a candidate state dict that is not the installed model's
    architecture: the same keys, and each tensor's shape and dtype.
    Raises ValueError naming the first difference."""
    if self.model is None:
      raise ValueError('validate_params on a model-less engine')
    want = self.model.state_dict()
    missing = sorted(set(want) - set(params))
    extra = sorted(set(params) - set(want))
    if missing or extra:
      raise ValueError(
          f'state dict keys changed (missing {missing}, extra {extra}) — '
          'a hot swap must keep the architecture; deploy a new engine '
          'for a new architecture')
    for key, old in want.items():
      new = torch.as_tensor(params[key])
      if tuple(new.shape) != tuple(old.shape) or new.dtype != old.dtype:
        raise ValueError(
            f'param {key!r} changed shape/dtype ({tuple(new.shape)} '
            f'{new.dtype} vs {tuple(old.shape)} {old.dtype}) — refused')

  def set_params(self, params, version: Optional[int] = None) -> int:
    """Install a new model version (the hot-swap commit: callers go
    through `serving.swap.hot_swap`, which quiesces the executor and
    parity-checks first, since the copy into the module is not atomic
    against a concurrent dispatch).  Returns the new ``model_version``."""
    state = self._params_on_device(params)
    with torch.no_grad():
      self.model.load_state_dict(state)
    self._params_ready = True
    self.model_version = (int(version) if version is not None
                          else self.model_version + 1)
    return self.model_version

  # -- warmup and kernel builds ---------------------------------------------
  def warmup(self, aot_cache='env') -> dict:
    """Make the kernels present (on the card: `_build.build_all`
    through the kernel-build cache, ``'env'`` = ``GLT_AOT_CACHE_DIR``),
    then run every bucket once, with valid ids and, where the bucket has
    room, one INVALID tail slot.  Returns ``{'buckets', 'compiles' (nvcc
    runs), 'secs', 'aot_restored' (libraries restored by this call)}``."""
    t0 = time.perf_counter()
    runs0 = _build.NVCC_RUNS
    restored = 0
    if self.device.type == 'cuda':
      info = _build.build_all(aot_cache=aot_cache)
      restored = sum(v['source'] == 'restored' for v in info.values())
      self._aot_restores += restored
    n = min(self.num_nodes, 8)
    for cap in self.buckets:
      seeds = np.arange(cap, dtype=np.int32) % n
      if cap > 1:
        seeds[-1] = INVALID_ID
      self._dispatch(torch.from_numpy(seeds).to(self.device))
      self.warm[cap] = True
    return {'buckets': dict(self.warm),
            'compiles': _build.NVCC_RUNS - runs0,
            'secs': round(time.perf_counter() - t0, 3),
            'aot_restored': restored}

  def compile_count(self) -> int:
    """``nvcc`` runs this process started since the engine was built
    (the warm pin of a spawned replica: 0 when every kernel was restored
    or already loaded)."""
    return _build.NVCC_RUNS - self._nvcc_base

  def compile_status(self) -> dict:
    """Per-bucket warm status and build counters (the heartbeat's
    serving block)."""
    return {'buckets': {str(c): bool(w) for c, w in self.warm.items()},
            'compiles': self.compile_count(),
            'aot_programs': self._aot_restores,
            'model_version': self.model_version,
            'graph_version': self.graph_version,
            'tiered': self._tiered}
