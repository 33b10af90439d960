"""Random walks over the device CSR (the JAX package's
`ops/random_walk.py`): uniform walks with optional restarts, node2vec's
second-order biased walks and the skip-gram pairs of a walk corpus.

As JAX's `lax.scan`, a walk advances the whole batch one step at a
time with plain tensor ops (a degree lookup, a draw, a neighbor
gather); there is no Pallas kernel behind them to port.  Output is a
static ``[B, walk_length + 1]`` int32 table whose column 0 holds the
starts; a walk that starts invalid (< 0) or reaches a node without
out-edges is INVALID_ID from then on (a restart brings it back).

The draws come from a `ops.draws.WalkDraws` provider by step ``t``:
``ints(t, high)`` (``high = max(deg, 1)`` a row), ``uniform(t, b)`` for
restarts and ``gumbel(t, b, w)`` for node2vec.  The default is
`WalkDraws(CounterDraws(seed, device))`, which gives the same walks on
the CPU and on the card; the parity tests replay JAX's keys
(``split(key, L)[t]``, then ``split`` into the offset and the restart
key).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils.padding import INVALID_ID
from .draws import CounterDraws, WalkDraws
from .negative import edge_in_csr


def _walk_setup(indices: torch.Tensor, starts: torch.Tensor, draws, seed):
  if indices.numel() == 0:          # an edgeless graph: keep gathers legal;
    indices = torch.zeros(1, dtype=torch.int32, device=starts.device)
  if draws is None:                 # deg == 0 masks every row
    draws = WalkDraws(CounterDraws(seed, starts.device))
  return indices, starts.to(torch.int32), draws


def _rows(indptr: torch.Tensor, cur: torch.Tensor):
  """``(start int64, deg int32)`` of each current node (clamped ids)."""
  n = indptr.numel() - 1
  v = cur.long().clamp(0, max(n - 1, 0))
  lo = indptr[v]
  return lo, (indptr[v + 1] - lo).to(torch.int32)


def random_walk(indptr: torch.Tensor, indices: torch.Tensor,
                starts: torch.Tensor, walk_length: int,
                restart_prob: float = 0.0,
                draws: Optional[WalkDraws] = None,
                seed: int = 0) -> torch.Tensor:
  """``[B, walk_length + 1]`` int32 uniform walks from ``starts``.

  Each step moves to an out-neighbor drawn uniformly (``draws.ints(t,
  max(deg, 1))``); with ``restart_prob > 0`` a valid walk jumps back to
  its start where ``draws.uniform(t, B) < restart_prob``.
  """
  indices, starts, draws = _walk_setup(indices, starts, draws, seed)
  last = indices.numel() - 1
  cur, path = starts, [starts]
  for t in range(int(walk_length)):
    valid = cur >= 0
    lo, deg = _rows(indptr, cur)
    off = draws.ints(t, deg.clamp(min=1))
    pos = (lo + off.long()).clamp(0, last)
    nxt = torch.where(valid & (deg > 0), indices[pos].to(torch.int32),
                      INVALID_ID)
    if restart_prob > 0.0:
      jump = draws.uniform(t, starts.shape[0]) < restart_prob
      nxt = torch.where(jump & valid, starts, nxt)
    cur = nxt
    path.append(nxt)
  return torch.stack(path, dim=1)


def node2vec_walk(indptr: torch.Tensor, indices: torch.Tensor,
                  starts: torch.Tensor, walk_length: int, p: float = 1.0,
                  q: float = 1.0, max_degree: int = 64,
                  draws: Optional[WalkDraws] = None,
                  seed: int = 0) -> torch.Tensor:
  """``[B, walk_length + 1]`` int32 node2vec walks.

  From ``cur`` after ``prev`` a candidate weighs ``1/p`` when it is
  ``prev``, 1 when it is a neighbor of ``prev`` (`ops.negative.
  edge_in_csr`, which needs columns sorted within rows) and ``1/q``
  otherwise; the first step is uniform.  The step draws by Gumbel-max
  over the first ``max_degree`` candidates of the row (``-log p`` and
  ``-log q`` taken in f32, ``argmax`` taking the first maximum): pass
  at least the graph's maximum degree for exact walks.
  """
  indices, starts, draws = _walk_setup(indices, starts, draws, seed)
  b, w = starts.shape[0], max(int(max_degree), 1)
  dev = starts.device
  last = indices.numel() - 1
  slot = torch.arange(w, dtype=torch.int64, device=dev)
  log_p = -torch.log(torch.tensor(p, dtype=torch.float32, device=dev))
  log_q = -torch.log(torch.tensor(q, dtype=torch.float32, device=dev))
  zero = torch.zeros((), dtype=torch.float32, device=dev)
  rows = torch.arange(b, device=dev)
  cur = starts
  prev = torch.full_like(starts, INVALID_ID)
  path = [starts]
  for t in range(int(walk_length)):
    valid = cur >= 0
    lo, deg = _rows(indptr, cur)
    cand = indices[(lo[:, None] + slot[None, :]).clamp(0, last)].to(
        torch.int32)
    in_win = slot[None, :] < deg[:, None]
    prev_b = prev[:, None].expand(b, w)
    is_dist1 = edge_in_csr(indptr, indices,
                           torch.where(prev_b >= 0, prev_b, 0).reshape(-1),
                           cand.reshape(-1)).reshape(b, w)
    logw = torch.where(cand == prev_b, log_p,
                       torch.where(is_dist1, zero, log_q))
    logw = torch.where(prev[:, None] >= 0, logw, zero)
    score = torch.where(in_win, logw + draws.gumbel(t, b, w),
                        float('-inf'))
    pick = torch.argmax(score, dim=1)
    nxt = torch.where(valid & (deg > 0), cand[rows, pick], INVALID_ID)
    prev, cur = cur, nxt
    path.append(nxt)
  return torch.stack(path, dim=1)


def walk_edges(walks: torch.Tensor, window: int = 1
               ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Skip-gram ``(src, dst)`` pairs of a walk table: every ordered pair
  ``off`` = 1..``window`` steps apart on each walk, offset-major, -1
  where either end is invalid."""
  length = walks.shape[1]
  src = torch.cat([walks[:, :length - off].reshape(-1)
                   for off in range(1, window + 1)])
  dst = torch.cat([walks[:, off:].reshape(-1)
                   for off in range(1, window + 1)])
  ok = (src >= 0) & (dst >= 0)
  return (torch.where(ok, src, INVALID_ID),
          torch.where(ok, dst, INVALID_ID))
