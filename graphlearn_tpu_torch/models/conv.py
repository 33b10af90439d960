"""Message passing on padded COO batches: `segment_mean`, the masked
segment sum and max that `models.hetero.HGTConv` needs, the attention
normaliser `segment_softmax`, `SAGEConv`, `GCNConv` and `GATConv` (the
JAX package's `models/conv.py:26-176,217-250`, as `nn.Module`s), and
`gat_conv_from_flax`.

Edges are ``[2, E]`` local COO with -1 in masked slots;
``edge_index[0]`` is the message source (the sampled neighbor) and
``edge_index[1]`` the target, so messages flow src -> dst.
Aggregation is `index_add_` over the static node table, with invalid
edges routed to an extra row that is cut off.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
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


def segment_softmax(e: torch.Tensor, dst: torch.Tensor, num_segments: int,
                    valid: torch.Tensor) -> torch.Tensor:
  """Masked softmax of the edge scores ``e`` ``[E, h]`` over each
  target's incoming edges: masked edges score ``-inf`` and are routed
  out of range, each target's scores are shifted by their max (a
  target with no valid edge shifts by 0), exponentiated and normalised.
  Masked edges get weight 0 and, as their exponent is filled with 0
  before the ``exp``, a zero gradient (never NaN)."""
  dsafe = torch.where(valid, dst, num_segments).long()
  dc = dst.long().clamp(0, max(num_segments - 1, 0))
  vm = valid[:, None]
  e = torch.where(vm, e, float('-inf'))
  idx = dsafe[:, None].expand_as(e)
  emax = torch.full((num_segments + 1, e.shape[1]), float('-inf'),
                    dtype=e.dtype, device=e.device)
  emax = emax.scatter_reduce(0, idx, e, 'amax',
                             include_self=False)[:num_segments]
  emax = torch.where(torch.isfinite(emax), emax, torch.zeros_like(emax))
  shifted = torch.where(vm, e - torch.index_select(emax, 0, dc),
                        torch.zeros((), dtype=e.dtype, device=e.device))
  ex = torch.where(vm, torch.exp(shifted),
                   torch.zeros((), dtype=e.dtype, device=e.device))
  denom = segment_sum(ex, dsafe, num_segments)
  return ex / torch.clamp(torch.index_select(denom, 0, dc), min=1e-16)


def _attention_aggregate(z_src_sel: torch.Tensor, w: torch.Tensor,
                         dst: torch.Tensor, valid: torch.Tensor, n: int,
                         heads: int, features: int,
                         concat: bool) -> torch.Tensor:
  """Weight each edge's ``[E, h, f]`` message by its softmaxed score,
  sum into the target rows and merge the heads (concatenated, or
  averaged)."""
  dsafe = torch.where(valid, dst, n)
  msg = z_src_sel * w.to(z_src_sel.dtype)[:, :, None]
  agg = segment_sum(msg.reshape(-1, heads * features), dsafe, n)
  if concat:
    return agg
  return agg.reshape(n, heads, features).mean(dim=1)


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


class GATConv(nn.Module):
  """Graph attention: ``z = lin(x)`` split into ``heads`` heads of
  ``out_features``, each edge ``u -> v`` scored ``leaky_relu(<z[u],
  att_src> + <z[v], att_dst>)`` per head (in f32), the scores
  softmaxed over each target's valid incoming edges
  (`segment_softmax`) and the weighted messages ``z[u]`` summed; the
  heads are concatenated (``concat``) or averaged.  ``lin`` has no bias
  and there is no self loop, as in the Flax module; ``att_src`` and
  ``att_dst`` are ``[heads, out_features]``, Glorot-uniform."""

  def __init__(self, in_features: int, out_features: int, heads: int = 1,
               concat: bool = True, negative_slope: float = 0.2):
    super().__init__()
    self.heads, self.out_features = int(heads), int(out_features)
    self.concat, self.negative_slope = bool(concat), float(negative_slope)
    self.lin = nn.Linear(in_features, self.heads * self.out_features,
                         bias=False)
    bound = math.sqrt(6.0 / (self.heads + self.out_features))
    self.att_src = nn.Parameter(
        torch.empty(self.heads, self.out_features).uniform_(-bound, bound))
    self.att_dst = nn.Parameter(
        torch.empty(self.heads, self.out_features).uniform_(-bound, bound))

  def forward(self, x: torch.Tensor, edge_index: torch.Tensor,
              edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    n = x.shape[0]
    h, f = self.heads, self.out_features
    src, dst = edge_index[0], edge_index[1]
    valid = edge_mask if edge_mask is not None else dst >= 0
    z = self.lin(x).reshape(n, h, f)
    alpha_src = (z * self.att_src.to(z.dtype)[None]).sum(-1).float()
    alpha_dst = (z * self.att_dst.to(z.dtype)[None]).sum(-1).float()
    sc = src.long().clamp(0, n - 1)
    dc = dst.long().clamp(0, n - 1)
    e = F.leaky_relu(torch.index_select(alpha_src, 0, sc)
                     + torch.index_select(alpha_dst, 0, dc),
                     self.negative_slope)
    w = segment_softmax(e, dst, n, valid)
    return _attention_aggregate(torch.index_select(z, 0, sc), w, dst, valid,
                                n, h, f, self.concat)


def gat_conv_from_flax(params) -> Dict[str, torch.Tensor]:
  """A Flax `GATConv` param tree (``Dense_0/kernel``, ``att_src``,
  ``att_dst``, with or without the top ``'params'`` level) -> a
  `GATConv` state dict (``lin.weight`` is the kernel transposed)."""
  tree = params.get('params', params)
  out = {}
  for name, val in tree.items():
    if hasattr(val, 'items'):
      key = 'lin' if name == 'Dense_0' else name
      out[f'{key}.weight'] = torch.from_numpy(np.ascontiguousarray(
          np.asarray(val['kernel'], np.float32).T))
    else:
      out[name] = torch.from_numpy(np.asarray(val, np.float32).copy())
  return out
