"""Message passing on padded COO batches: `segment_mean`, the masked
segment sum and max that `models.hetero.HGTConv` needs, `SAGEConv` and
`GCNConv` (the JAX package's `models/conv.py:26-66,97-176`, as
`nn.Module`s).

Edges are ``[2, E]`` local COO with -1 in masked slots;
``edge_index[0]`` is the message source (the sampled neighbor) and
``edge_index[1]`` the target, so messages flow src -> dst.
Aggregation is `index_add_` over the static node table, with invalid
edges routed to an extra row that is cut off.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int, mask: Optional[torch.Tensor] = None,
                 weights: Optional[torch.Tensor] = None) -> torch.Tensor:
  """Masked mean of edge messages per target row.

  ``weights`` (``[E]``, the GNS importance weights of
  ``Batch.metadata['edge_weight']``) scale the numerator only; the
  denominator stays the valid-edge count, counted in f32.  That is the
  ``Σ_j w_j·x_j / k`` form that is unbiased for the uniform neighbor
  mean under any sampling bias.
  """
  if mask is not None:
    seg = torch.where(mask, segment_ids, num_segments)
  else:
    seg = torch.where(segment_ids >= 0, segment_ids, num_segments)
  seg = seg.long()
  if weights is not None:
    data = data * weights.to(data.dtype)[:, None]
  tot = data.new_zeros((num_segments + 1, data.shape[1])).index_add_(
      0, seg, data)[:num_segments]
  cnt = torch.zeros(num_segments + 1, dtype=torch.float32,
                    device=data.device).index_add_(
      0, seg, torch.ones(seg.shape[0], dtype=torch.float32,
                         device=data.device))[:num_segments]
  mean = tot.float() / torch.clamp(cnt, min=1.0)[:, None]
  return mean.to(data.dtype)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
  """Sum of the rows of ``data`` per segment (`jax.ops.segment_sum`):
  ids outside ``[0, num_segments)`` (the invalid rows routed away) add
  nothing, and an empty segment is 0."""
  ok = (segment_ids >= 0) & (segment_ids < num_segments)
  seg = torch.where(ok, segment_ids, num_segments).long()
  out = data.new_zeros((num_segments + 1,) + tuple(data.shape[1:]))
  return out.index_add_(0, seg, data)[:num_segments]


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
  """Max of the rows of ``data`` per segment: rows with an id outside
  ``[0, num_segments)`` (the invalid rows routed away) take no part; an
  empty segment is ``-inf`` (`jax.ops.segment_max`'s identity) and is
  then returned as 0, as the JAX package's `segment_max` returns it.
  Its gradient goes to the rows equal to their segment's max, shared
  evenly among ties."""
  ok = (segment_ids >= 0) & (segment_ids < num_segments)
  seg = torch.where(ok, segment_ids, num_segments).long()
  idx = seg.reshape((-1,) + (1,) * (data.ndim - 1)).expand_as(data)
  out = torch.full((num_segments + 1,) + tuple(data.shape[1:]),
                   float('-inf'), dtype=data.dtype, device=data.device)
  out = out.scatter_reduce(0, idx, data, 'amax',
                           include_self=True)[:num_segments]
  return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


class SAGEConv(nn.Module):
  """GraphSAGE convolution: ``out[v] = lin_self(x[v]) +
  lin_neigh(mean_{u->v} x[u])`` (``lin_self`` has a bias, ``lin_neigh``
  none — the Flax module's parameters).  Only the mean aggregator is
  ported; ``edge_weight`` weights its numerator (`segment_mean`)."""

  def __init__(self, in_features: int, out_features: int,
               aggr: str = 'mean'):
    super().__init__()
    if aggr != 'mean':
      raise ValueError(f'aggr {aggr!r} is not ported: SAGEConv supports '
                       "aggr='mean'")
    self.aggr = aggr
    self.lin_self = nn.Linear(in_features, out_features)
    self.lin_neigh = nn.Linear(in_features, out_features, bias=False)

  def forward(self, x: torch.Tensor, edge_index: torch.Tensor,
              edge_mask: Optional[torch.Tensor] = None,
              edge_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    n = x.shape[0]
    src, dst = edge_index[0], edge_index[1]
    # index_select, not x[src]: its backward is one index_add_, where the
    # backward of advanced indexing sorts the ids and walks each run of
    # equal ids serially — and every masked slot reads row 0, so one id
    # repeats ~10^5 times (345 ms per call at products scale, H100)
    msg = torch.index_select(x, 0, src.long().clamp(0, n - 1))
    agg = segment_mean(msg, dst, n, edge_mask, weights=edge_weight)
    return self.lin_self(x) + self.lin_neigh(agg)


class GCNConv(nn.Module):
  """Graph convolution with symmetric degree normalisation and a self
  loop: ``h = lin(x)``, ``out[v] = sum_{u->v} h[u] / sqrt(d_out(u)
  d_in(v)) + h[v] / sqrt(d_in(v) d_out(v))``, the degrees counted over
  the valid edges in f32, plus one (the self loop)."""

  def __init__(self, in_features: int, out_features: int):
    super().__init__()
    self.lin = nn.Linear(in_features, out_features)

  def forward(self, x: torch.Tensor, edge_index: torch.Tensor,
              edge_mask: Optional[torch.Tensor] = None,
              edge_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    if edge_weight is not None:
      raise ValueError('GCNConv takes no edge_weight (the GNS importance '
                       'weights have an unbiased meaning for SAGEConv only)')
    n = x.shape[0]
    src, dst = edge_index[0], edge_index[1]
    valid = edge_mask if edge_mask is not None else dst >= 0
    ssafe = torch.where(valid, src, n)
    dsafe = torch.where(valid, dst, n)
    ones = valid.to(torch.float32)
    deg_in = segment_sum(ones, dsafe, n) + 1.0
    deg_out = segment_sum(ones, ssafe, n) + 1.0
    s = src.long().clamp(0, n - 1)
    d = dst.long().clamp(0, n - 1)
    w = torch.rsqrt(deg_out)[s] * torch.rsqrt(deg_in)[d]
    h = self.lin(x)
    msg = torch.index_select(h, 0, s) * w.to(h.dtype)[:, None]
    agg = segment_sum(msg, dsafe, n)
    self_w = torch.rsqrt(deg_in) * torch.rsqrt(deg_out)
    return agg + h * self_w.to(h.dtype)[:, None]
