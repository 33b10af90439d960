"""Locality-aware mesh partitioning and the online rebalance (the JAX
package's `parallel/locality.py`).

  * `locality_partition`: a seeded streaming greedy (LDG/Fennel style)
    that places each node on the partition maximising its placed
    neighbours' (hotness-weighted) affinity, discounted by the
    partition's load, under a hard ``ceil((1 + eps) * N / P)`` cap; then
    ``passes`` refinement sweeps.  Host numpy, decision for decision the
    JAX package's: the same inputs and seed give the same ``node_pb``.
    `DistDataset.from_full_graph(partitioner='locality')` relabels by it,
    so ranges stay contiguous and the book never changes shape.
  * `rebalance_plan` / `execute_rebalance`: rank the ranges by measured
    demand (a sketch's ``range_mass``, else the attribution bytes
    matrix's column mass) and move the hottest ranges of overloaded
    owners onto their top underloaded requester, each move one fenced
    `handoff.handoff`.

``GLT_PARTITIONER=range|locality`` selects the partitioner (unset: the
seeded round-robin); ``GLT_LOCALITY_EPS`` and ``GLT_LOCALITY_PASSES``
size the greedy; ``GLT_REBALANCE_OVERLOAD`` is the planner's overload
factor.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

#: the partitioners `from_full_graph` and ``GLT_PARTITIONER`` accept
PARTITIONERS = ('range', 'locality')


def resolve_partitioner(partitioner=None) -> Union[str, np.ndarray,
                                                   Callable]:
  """The active partitioner: an explicit name, ``node_pb`` array or
  callable ``(rows, cols, num_nodes, num_parts) -> node_pb`` wins; else
  ``GLT_PARTITIONER``; default ``'range'``."""
  if partitioner is None:
    partitioner = os.environ.get('GLT_PARTITIONER', 'range') or 'range'
  if isinstance(partitioner, str):
    if partitioner not in PARTITIONERS:
      raise ValueError(
          f'unknown partitioner {partitioner!r}: expected one of '
          f'{PARTITIONERS}, a node_pb array, or a callable')
    return partitioner
  if callable(partitioner):
    return partitioner
  return np.asarray(partitioner)


def _env_float(name: str, default: float) -> float:
  try:
    return float(os.environ.get(name, default))
  except ValueError:
    return default


def _env_int(name: str, default: int) -> int:
  try:
    return int(os.environ.get(name, default))
  except ValueError:
    return default


def edge_cut_frac(rows, cols, node_pb) -> float:
  """The fraction of edges whose endpoints lie on different
  partitions."""
  rows = np.asarray(rows)
  if not len(rows):
    return 0.0
  node_pb = np.asarray(node_pb)
  return float(np.mean(node_pb[rows] != node_pb[np.asarray(cols)]))


def _adjacency_csr(rows: np.ndarray, cols: np.ndarray,
                   num_nodes: int) -> Tuple[np.ndarray, np.ndarray]:
  """The undirected adjacency CSR (both directions, self-loops dropped)
  the greedy scores against, each row's neighbours in input order."""
  u = np.concatenate([rows, cols])
  v = np.concatenate([cols, rows])
  keep = u != v
  u, v = u[keep], v[keep]
  order = np.argsort(u, kind='stable')
  u, v = u[order], v[order]
  indptr = np.zeros(num_nodes + 1, np.int64)
  np.cumsum(np.bincount(u, minlength=num_nodes), out=indptr[1:])
  return indptr, v.astype(np.int64)


def _greedy(indptr: np.ndarray, nbrs: np.ndarray, w: np.ndarray,
            order: np.ndarray, num_parts: int, cap: int,
            passes: int) -> Tuple[np.ndarray, np.ndarray]:
  """The stream and its refinement sweeps: ``(part [N] int64, sizes
  [P] int64)``.  Each node's score is ``aff * (1 - size / cap) - size *
  tie`` over the partitions with room (``aff`` the summed weight of its
  placed neighbours there, in neighbour order, as `np.bincount` sums);
  a refinement scores the node's own partition without the node and
  moves it only to a strictly better one with room.  The first maximum
  wins."""
  n = len(indptr) - 1
  part = np.full(n, -1, np.int64)
  sizes = np.zeros(num_parts, np.int64)
  tie = 1.0 / (cap * max(num_parts, 1) * 4.0)
  zeros = np.zeros(num_parts, np.float64)

  def best(v: int, current: int) -> int:
    nb = nbrs[indptr[v]:indptr[v + 1]]
    pnb = part[nb]
    placed = pnb >= 0
    aff = (np.bincount(pnb[placed], weights=w[nb[placed]],
                       minlength=num_parts) if placed.any() else zeros)
    score = aff * (1.0 - sizes / cap) - sizes * tie
    score[sizes >= cap] = -np.inf
    if current >= 0:
      s1 = sizes[current] - 1
      score[current] = aff[current] * (1.0 - s1 / cap) - s1 * tie
    return int(np.argmax(score))

  for v in order.tolist():
    p = best(v, -1)
    part[v] = p
    sizes[p] += 1
  for _ in range(max(int(passes), 0)):
    moved = 0
    for v in order.tolist():
      cur = int(part[v])
      p = best(v, cur)
      if p != cur and sizes[p] < cap:
        sizes[cur] -= 1
        sizes[p] += 1
        part[v] = p
        moved += 1
    if not moved:
      break
  return part, sizes


def compiled_greedy(indptr: np.ndarray, nbrs: np.ndarray, w: np.ndarray,
                    order: np.ndarray, num_parts: int, cap: int,
                    passes: int) -> Tuple[np.ndarray, np.ndarray]:
  """`_greedy` compiled (``csrc/locality_greedy.cpp``, host code built by
  ``nvcc`` with the kernels): the same decisions, without numpy's
  per-node call overhead."""
  import ctypes
  from .. import _build
  lib = _build.load_library('locality_greedy')
  fn = lib.locality_greedy
  ptr = ctypes.c_void_p
  fn.argtypes = [ptr, ptr, ptr, ptr, ctypes.c_longlong, ctypes.c_int,
                 ctypes.c_longlong, ctypes.c_int, ptr, ptr]
  fn.restype = ctypes.c_int
  arrs = [np.ascontiguousarray(indptr, np.int64),
          np.ascontiguousarray(nbrs, np.int64),
          np.ascontiguousarray(w, np.float64),
          np.ascontiguousarray(order, np.int64)]
  n = len(arrs[0]) - 1
  part = np.empty(n, np.int64)
  sizes = np.empty(num_parts, np.int64)
  err = fn(*(a.ctypes.data for a in arrs), n, int(num_parts), int(cap),
           int(passes), part.ctypes.data, sizes.ctypes.data)
  if err:
    raise ValueError(f'locality_greedy refused num_parts={num_parts} '
                     f'cap={cap}')
  return part, sizes


def locality_partition(rows, cols, num_nodes: int, num_parts: int, *,
                       seed: int = 0,
                       hotness: Optional[np.ndarray] = None,
                       balance_eps: Optional[float] = None,
                       passes: Optional[int] = None,
                       greedy: Optional[Callable] = None
                       ) -> Tuple[np.ndarray, Dict]:
  """The seeded streaming partition of a COO graph (module docstring).

  Nodes stream in ``default_rng(seed).permutation`` order; a neighbour's
  weight is ``1 + hotness / mean(hotness)`` (1 without ``hotness``, an
  array or anything with ``.score(ids)``).  ``balance_eps``
  (``GLT_LOCALITY_EPS``, 0.05) sets the cap, ``passes``
  (``GLT_LOCALITY_PASSES``, 1) the refinement sweeps.  ``greedy``
  replaces `_greedy` (the same signature and decisions:
  `compiled_greedy`).  Returns ``(node_pb [N] int32,
  stats)``, ``stats`` = ``edge_cut_frac``, ``max_part_frac``, ``cap``,
  ``passes`` and ``seed``; sets the ``locality.edge_cut_frac`` gauge and
  emits ``partition.relabel``.
  """
  rows = np.asarray(rows, np.int64)
  cols = np.asarray(cols, np.int64)
  num_nodes, num_parts = int(num_nodes), int(num_parts)
  if balance_eps is None:
    balance_eps = _env_float('GLT_LOCALITY_EPS', 0.05)
  if passes is None:
    passes = _env_int('GLT_LOCALITY_PASSES', 1)
  if hotness is not None and hasattr(hotness, 'score'):
    hotness = hotness.score(np.arange(num_nodes))
  cap = max(int(np.ceil((1.0 + float(balance_eps)) * num_nodes
                        / max(num_parts, 1))), 1)
  indptr, nbrs = _adjacency_csr(rows, cols, num_nodes)
  if hotness is not None:
    hot = np.asarray(hotness, np.float64)
    w = 1.0 + hot / (hot.mean() or 1.0)
  else:
    w = np.ones(num_nodes, np.float64)
  order = np.random.default_rng(seed).permutation(num_nodes)
  part, sizes = (greedy or _greedy)(indptr, nbrs, w, order, num_parts, cap,
                                    int(passes))
  cut = edge_cut_frac(rows, cols, part)
  stats = {
      'edge_cut_frac': cut,
      'max_part_frac': float(sizes.max(initial=0) * num_parts
                             / max(num_nodes, 1)),
      'cap': cap,
      'passes': int(passes),
      'seed': int(seed),
  }
  from ..telemetry.live import live
  from ..telemetry.recorder import recorder
  live.gauge('locality.edge_cut_frac', fn=lambda: cut)
  recorder.emit('partition.relabel', partitioner='locality',
                num_parts=num_parts, num_nodes=num_nodes, seed=int(seed),
                edge_cut_frac=round(cut, 6),
                max_part_frac=round(stats['max_part_frac'], 6),
                hotness_weighted=hotness is not None)
  return part.astype(np.int32), stats


# -- online rebalance: measured demand -> planned handoffs -------------------

def _demand_per_range(attribution: Dict, sketch=None) -> Optional[np.ndarray]:
  """``[P]`` demand: the sketch's decayed range mass when it has mass,
  else the attribution bytes matrix's column sums."""
  if sketch is not None:
    mass = getattr(sketch, 'range_mass', None)
    if mass is not None and np.asarray(mass).sum() > 0:
      return np.asarray(mass, np.float64)
  m = attribution.get('bytes_matrix') if attribution else None
  if m is None:
    return None
  return np.asarray(m, np.float64).sum(axis=0)


def rebalance_plan(attribution: Dict, sketch=None, book=None, *,
                   max_moves: Optional[int] = None,
                   overload_factor: Optional[float] = None) -> List[Dict]:
  """Plan hot-range moves from measured traffic (the JAX package's
  `rebalance_plan`).

  Ranges go hottest first.  Range ``r`` moves when (a) its owner's load
  is above ``overload_factor`` (``GLT_REBALANCE_OVERLOAD``, 1.1) times
  the mean, (b) its top requester (bytes-matrix column order, the owner
  excluded) is loaded below the mean, and (c) the book can take the
  move: ``r`` sits at its own position, the destination is alive — its
  own range neither moved already nor moved by an earlier move of this
  plan — carries no extra lane and is no other move's destination.
  Returns ``[{'range', 'frm', 'to', 'demand'}, ...]``.

  The last clause of (c) is the port's: the JAX package's plan can send
  a later move to a position whose own range an earlier move took away,
  which its book then refuses; wherever its book accepts its plan, the
  two plans are equal.
  """
  if overload_factor is None:
    overload_factor = _env_float('GLT_REBALANCE_OVERLOAD', 1.1)
  demand = _demand_per_range(attribution, sketch)
  if demand is None or not len(demand) or demand.sum() <= 0:
    return []
  num_parts = len(demand)
  m = np.asarray(attribution.get('bytes_matrix',
                                 np.zeros((num_parts, num_parts))),
                 np.float64)
  owners = (np.asarray(book.view().owners) if book is not None
            else np.arange(num_parts))
  dead = set(np.flatnonzero(owners != np.arange(num_parts)).tolist())
  load = np.zeros(num_parts, np.float64)
  for r in range(num_parts):
    load[int(owners[r])] += demand[r]
  mean = load.sum() / max(num_parts, 1)
  busy_dest = set(int(owners[r]) for r in range(num_parts)
                  if int(owners[r]) != r)
  plan: List[Dict] = []
  for r in np.argsort(-demand):
    r = int(r)
    if max_moves is not None and len(plan) >= max_moves:
      break
    frm = int(owners[r])
    if frm != r or r in dead:
      continue                    # already off-owner: immovable
    if load[frm] <= overload_factor * mean:
      continue
    col = m[:, r].copy()
    col[r] = -1.0                 # the owner is not a destination
    for d in np.argsort(-col):
      d = int(d)
      if col[d] <= 0:
        break
      if d == r or d in dead or d in busy_dest or load[d] >= mean:
        continue
      plan.append({'range': r, 'frm': frm, 'to': d,
                   'demand': float(demand[r])})
      busy_dest.add(d)
      dead.add(r)                 # r's position no longer serves r
      load[frm] -= demand[r]
      load[d] += demand[r]
      break
  return plan


def execute_rebalance(ds, plan: Sequence[Dict], store=None) -> List[Dict]:
  """Run a `rebalance_plan` move by move through the fenced
  `handoff.handoff` (snapshot, transfer, fence, one book bump, drain),
  each move one ``partition.rebalance`` event; a refused or aborted move
  stops the rest (the state it was planned from no longer holds).
  Returns the moves' handoff infos."""
  from ..telemetry.recorder import recorder
  from .handoff import handoff
  infos: List[Dict] = []
  for mv in plan:
    info = handoff(ds, int(mv['range']), int(mv['to']), store=store)
    recorder.emit('partition.rebalance', partition=int(mv['range']),
                  frm=int(mv['frm']), to=int(mv['to']),
                  demand=float(mv.get('demand', 0.0)),
                  version=info['version'],
                  secs=round(float(info['secs']), 6))
    infos.append(info)
  return infos
