"""Uniform one-hop neighbor sampling, the plain PyTorch version.

Same contract as the JAX package's `ops/neighbor.py::sample_one_hop`
with ``replace=False, sort_locality=False``, but the random draws are
inputs: ``u [B, k]`` for the with-replacement arm and ``gumbel [B, w]``
for the window arm.  Given the draws JAX makes from its key, the
outputs are byte-equal.  Per row:

  * ``deg <= k``      — take all neighbors (slots ``0..deg-1``);
  * ``k < deg <= w``  — without replacement: Gumbel top-k over the
    first ``deg`` window entries, in `jax.lax.top_k` order (value
    descending, then index ascending — a stable descending sort, never
    `torch.topk`, whose tie order is unspecified);
  * ``deg > w``       — with replacement: ``min(trunc(u * deg), deg-1)``
    with the product in f32.

With ``with_edge_ids`` each slot also carries its edge id: ``edge_ids``
at the slot's CSR position, or the position itself when ``edge_ids`` is
None (int32, so the graph must hold fewer than 2**31 edges), and
INVALID_ID where the slot is masked.

`ops.fused_sample.sample_one_hop_fused` is the CUDA kernel of the same
function; it runs this version for tensors on the CPU.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils.padding import INVALID_ID, round_up


class OneHopResult(NamedTuple):
  """Dense one-hop sample.

  Attributes:
    nbrs: ``[B, k]`` int32 neighbor ids (INVALID_ID where masked).
    mask: ``[B, k]`` bool slot validity (slot < min(deg, k)).
    eids: ``[B, k]`` int32 edge ids (INVALID_ID where masked), or None
      without ``with_edge_ids``.
    weights: ``[B, k]`` f32 importance weights of the GNS sampler
      (`ops.gns`), or None for the uniform sampler.
  """
  nbrs: torch.Tensor
  mask: torch.Tensor
  eids: Optional[torch.Tensor] = None
  weights: Optional[torch.Tensor] = None


def default_window(k: int) -> int:
  return round_up(max(8 * k, 64), 8)


def _seed_rows(indptr: torch.Tensor, seeds: torch.Tensor):
  """``(start int64, deg int32)`` per seed; invalid (``< 0``) seeds get
  degree 0, out-of-range ids clamp like an XLA gather."""
  n = indptr.numel() - 1
  valid = seeds >= 0
  s = torch.where(valid, seeds.long(), 0).clamp(max=n)
  start = indptr[s]
  deg = (indptr[(s + 1).clamp(max=n)] - start).to(torch.int32)
  return start, torch.where(valid, deg, 0)


def lookup_degree(indptr: torch.Tensor, nodes: torch.Tensor) -> torch.Tensor:
  """Degree per node (0 for invalid ids), int32."""
  return _seed_rows(indptr, nodes)[1]


def check_edge_ids(num_edges: int, edge_ids: Optional[torch.Tensor],
                   with_edge_ids: bool) -> None:
  """The edge-id arm's contract: int32 ``edge_ids`` of one per edge, or
  CSR positions that fit int32."""
  if not with_edge_ids:
    return
  if edge_ids is None:
    if num_edges >= 1 << 31:
      raise ValueError(f'{num_edges} edges: CSR positions do not fit the '
                       'int32 edge ids; pass int32 edge_ids')
  elif edge_ids.dtype != torch.int32 or edge_ids.shape != (num_edges,):
    raise ValueError(f'edge_ids must be [{num_edges}] int32, got '
                     f'{tuple(edge_ids.shape)} {edge_ids.dtype}')


def sample_one_hop(indptr: torch.Tensor, indices: torch.Tensor,
                   seeds: torch.Tensor, k: int, u: torch.Tensor,
                   gumbel: torch.Tensor,
                   edge_ids: Optional[torch.Tensor] = None,
                   with_edge_ids: bool = False) -> OneHopResult:
  """Sample up to ``k`` neighbors per seed with injected draws.

  Args:
    indptr: ``[N+1]`` int64 CSR row pointers.
    indices: ``[E]`` int32 CSR column indices.
    seeds: ``[B]`` seed ids; ``-1`` entries give empty rows.
    k: fanout.
    u: ``[B, k]`` f32 uniforms in ``[0, 1)``.
    gumbel: ``[B, w]`` f32 Gumbel noise; ``w`` is the window.
    edge_ids: optional ``[E]`` int32 edge ids, read at the sampled
      positions.
    with_edge_ids: also return ``eids``.
  """
  sample_one_hop.calls += 1
  e = indices.numel()
  check_edge_ids(e, edge_ids, with_edge_ids)
  w = gumbel.shape[1]
  dev = seeds.device
  start, deg = _seed_rows(indptr, seeds)
  slot = torch.arange(k, dtype=torch.int32, device=dev)
  mask = slot[None, :] < torch.clamp(deg, max=k)[:, None]
  rand_off = torch.minimum((u * deg[:, None].float()).to(torch.int32),
                           torch.clamp(deg - 1, min=0)[:, None])
  wslot = torch.arange(w, dtype=torch.int32, device=dev)
  g = torch.where(wslot[None, :] < deg[:, None], gumbel,
                  torch.full_like(gumbel, float('-inf')))
  top_idx = torch.sort(g, dim=1, descending=True,
                       stable=True).indices[:, :k].to(torch.int32)
  medium = ((deg > k) & (deg <= w))[:, None]
  off = torch.where((deg <= k)[:, None], slot[None, :],
                    torch.where(medium, top_idx, rand_off))
  eids = None
  if e == 0:
    nbrs = torch.full(mask.shape, INVALID_ID, dtype=torch.int32, device=dev)
    if with_edge_ids:
      eids = nbrs.clone()
  else:
    pos = torch.clamp(start[:, None] + off, 0, e - 1)
    nbrs = torch.where(mask, indices[pos].to(torch.int32), INVALID_ID)
    if with_edge_ids:
      ids = pos.to(torch.int32) if edge_ids is None else edge_ids[pos]
      eids = torch.where(mask, ids, INVALID_ID)
  return OneHopResult(nbrs=nbrs, mask=mask, eids=eids)


#: calls of the plain version (a serving run on the card expects 0)
sample_one_hop.calls = 0
