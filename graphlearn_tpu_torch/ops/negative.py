"""Random negative edges on the device (the JAX package's
`ops/negative.py`): a membership test of (row, col) pairs against a CSR
whose columns are sorted within each row, and strict negative sampling
as a static ``[trials, R]`` batch of candidates with a validity mask in
place of a retry loop.

The candidates come in from a ``candidates(stream, trials, r, high) ->
[trials, r]`` int32 provider (ids in ``[0, high)``), as the one-hop
sampler's draws do: stream 0 holds the rows and stream 1 the columns.
`ops.draws.TorchDraws.negatives` and `ops.draws.CounterDraws.
negatives` draw them; the parity tests replay JAX's ``randint`` keys
(``split(key)`` into the row and the column stream).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..utils.padding import INVALID_ID

#: ``candidates(stream, trials, r, high) -> [trials, r]`` int32 ids
Candidates = Callable[[int, int, int, int], torch.Tensor]


def edge_in_csr(indptr: torch.Tensor, indices: torch.Tensor,
                rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
  """Is ``(rows[i], cols[i])`` an edge?  A branchless lower bound over
  each row's ascending columns in ``bit_length(E)`` fixed steps (a row
  may hold all ``E`` edges); rows < 0 are never edges."""
  num_edges = indices.shape[0]
  valid = rows >= 0
  if num_edges == 0:
    return torch.zeros_like(valid)
  n = indptr.shape[0] - 1
  r = torch.where(valid, rows, 0).long()
  lo = indptr[r.clamp(max=n)]
  hi = indptr[(r + 1).clamp(max=n)]
  hi0 = hi
  last = num_edges - 1
  for _ in range(num_edges.bit_length()):
    active = lo < hi
    mid = (lo + hi) // 2
    go_right = indices[mid.clamp(0, last)] < cols
    lo = torch.where(active & go_right, mid + 1, lo)
    hi = torch.where(active & ~go_right, mid, hi)
  return valid & (lo < hi0) & (indices[lo.clamp(0, last)] == cols)


class NegativeSampleResult(NamedTuple):
  """``rows``/``cols``: ``[R]`` int32 pairs (-1 where masked);
  ``mask``: their validity (all true with ``padding``)."""
  rows: torch.Tensor
  cols: torch.Tensor
  mask: torch.Tensor


def first_non_edge(exists: torch.Tensor) -> torch.Tensor:
  """``[trials, R]`` membership -> each slot's first trial that is not
  an edge, or the last trial where every trial is (the padding
  fallback).  `argmax` over int8 returns the first maximum, as JAX's
  over booleans does."""
  ok = ~exists
  first = torch.argmax(ok.to(torch.int8), dim=0)
  return torch.where(ok.any(dim=0), first, exists.shape[0] - 1)


def sample_negative(indptr: torch.Tensor, indices: torch.Tensor,
                    req_num: int, candidates: Candidates, *,
                    trials: int = 5, strict: bool = True,
                    padding: bool = True,
                    num_cols: Optional[int] = None) -> NegativeSampleResult:
  """``req_num`` node pairs that are, in strict mode, not edges.

  Each slot takes its first candidate pair that is not an edge among
  ``trials``; with ``padding`` a slot whose every trial is an edge keeps
  its last (so the output is full, with a few false negatives), without
  it the slot is masked.  Non-strict mode keeps the first trial.  Rows
  are drawn from ``[0, N)`` and columns from ``[0, num_cols)``
  (default ``N``; a bipartite graph's destination type).
  """
  num_nodes = indptr.shape[0] - 1
  rows = candidates(0, trials, req_num, num_nodes)
  cols = candidates(1, trials, req_num,
                    num_cols if num_cols is not None else num_nodes)
  if not strict:
    return NegativeSampleResult(rows[0], cols[0], torch.ones(
        req_num, dtype=torch.bool, device=rows.device))
  exists = edge_in_csr(indptr, indices, rows.reshape(-1),
                       cols.reshape(-1)).reshape(trials, req_num)
  pick = first_non_edge(exists)[None]
  out_rows = rows.gather(0, pick)[0]
  out_cols = cols.gather(0, pick)[0]
  if padding:
    mask = torch.ones(req_num, dtype=torch.bool, device=rows.device)
  else:
    mask = (~exists).any(dim=0)
    out_rows = torch.where(mask, out_rows, INVALID_ID)
    out_cols = torch.where(mask, out_cols, INVALID_ID)
  return NegativeSampleResult(out_rows, out_cols, mask)


def triplet_negatives(indptr: torch.Tensor, indices: torch.Tensor,
                      src: torch.Tensor, candidates: Candidates,
                      amount: int,
                      num_nodes: Optional[int] = None) -> torch.Tensor:
  """``[B, amount]`` negative destinations per source: each slot's first
  of 5 candidates (stream 0, ``[0, num_nodes)``, default N) that is not
  an edge from its source, or the last (the JAX package's
  `_triplet_neg_dst`)."""
  b, trials = src.shape[0], 5
  cand = candidates(0, trials, b * amount,
                    indptr.shape[0] - 1 if num_nodes is None else num_nodes)
  rows = src.repeat_interleave(amount)[None].expand(trials, -1)
  exists = edge_in_csr(indptr, indices, rows.reshape(-1),
                       cand.reshape(-1)).reshape(trials, b * amount)
  return cand.gather(0, first_non_edge(exists)[None])[0].reshape(b, amount)
