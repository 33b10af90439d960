"""Heterogeneous GNNs over `HeteroBatch` dicts: `HeteroConv` (its RGCN
mode and its factory mode), `RGCN`, `HGTConv` and `HGT` (the JAX
package's `models/hetero.py:21-290`), and `rgcn_from_flax` /
`hgt_from_flax` / `hetero_conv_from_flax`, which carry a Flax model's
parameters into these modules.

``edge_index_dict[(a, rel, b)][0]`` indexes type-``a`` nodes (message
sources) and ``[1]`` type-``b`` nodes (targets), as the heterogeneous
sampler emits them.  The parameters are a function of the constructor's
types, never of what a batch holds, and carry the Flax modules' names
(``conv0.lin_paper__cites__paper.weight`` is Flax's ``conv0 /
lin_paper__cites__paper / kernel``, transposed).

``dtype`` is the compute dtype, as in Flax and `models.TreeSAGE`: the
parameters stay f32, each dense layer casts its input, weight and bias
to it (bf16 runs the matmuls on tensor cores), and the logits come back
in f32.
"""
from __future__ import annotations

import math
import re
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..typing import EdgeType, NodeType, as_str
from .conv import segment_max, segment_mean, segment_sum

InFeatures = Union[int, Dict[NodeType, int]]


def _dense(lin: nn.Linear, x: torch.Tensor,
           dtype: Optional[torch.dtype]) -> torch.Tensor:
  """``lin(x)`` computed in ``dtype`` (Flax ``nn.Dense(dtype=...)``)."""
  if dtype is None:
    return lin(x)
  bias = None if lin.bias is None else lin.bias.to(dtype)
  return F.linear(x.to(dtype), lin.weight.to(dtype), bias)


def _in_dims(in_features: InFeatures, ntypes) -> Dict[NodeType, int]:
  if isinstance(in_features, dict):
    return {nt: int(d) for nt, d in in_features.items()}
  return {nt: int(in_features) for nt in ntypes}


def _ntypes(etypes) -> list:
  return sorted({t for (s, _, d) in etypes for t in (s, d)})


class _Resettable(nn.Module):

  @torch.no_grad()
  def reset_parameters(self, generator: torch.Generator) -> None:
    """Init every parameter from ``generator`` on the CPU, so the values
    do not depend on the device: linear weights and biases from
    ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))``, HGT's relation matrices
    and GAT's attention vectors Glorot-uniform (Flax's init), HGT's
    priors 1."""
    for name, p in self.named_parameters():
      leaf = name.rsplit('.', 1)[-1]
      if leaf.startswith('prior_'):
        vals = torch.ones(p.shape)
      elif leaf.startswith(('w_att_', 'w_msg_', 'att_')):
        bound = math.sqrt(6.0 / (p.shape[-2] + p.shape[-1]))
        vals = torch.empty(p.shape).uniform_(-bound, bound,
                                             generator=generator)
      else:
        lin = self.get_submodule(name.rsplit('.', 1)[0])
        bound = 1.0 / math.sqrt(lin.in_features)
        vals = torch.empty(p.shape).uniform_(-bound, bound,
                                             generator=generator)
      p.copy_(vals)


class HeteroConv(_Resettable):
  """A convolution per edge type, aggregated into each target type and
  summed (``aggr='sum'``) or averaged (``'mean'``) across edge types.

  Two modes, as in JAX:

  * default: per-edge-type linear messages (``lin_{etype}``),
    mean-aggregated, plus a per-type self term (``lin_self_{nt}``) —
    the RGCN layer;
  * ``make_conv``: each edge type gets a fresh homogeneous conv,
    ``make_conv(in_features, out_features)`` (``conv_{etype}``; e.g.
    `SAGEConv`), run on the bipartite pair by concatenating ``[x_dst;
    x_src]`` and shifting the source ids by the target count (a
    relation within one type runs directly), with no extra self term;
    a type no edge type targets gets ``lin_self_{nt}``.  The factory
    must give a torch module (`SAGEConv`, `GCNConv`, `GATConv`: the
    RGAT of ``lambda i, o: GATConv(i, o // heads, heads=heads)``).

  An edge type whose endpoint types both have inputs but which is
  absent from a batch runs on an empty edge set (its weights get a zero
  gradient, as in JAX).

  Args:
    etypes: the edge types to convolve.
    in_features: input width, one for every node type of ``etypes`` or
      ``{NodeType: width}`` (the types with inputs); factory mode needs
      equal widths on both ends of each edge type.
    out_features: per-type output width.
    dtype: the RGCN mode's compute dtype (factory mode: set it in the
      factory's convs).
  """

  def __init__(self, etypes: Sequence[EdgeType], in_features: InFeatures,
               out_features: int, aggr: str = 'sum', make_conv=None,
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    if aggr not in ('sum', 'mean'):
      raise ValueError(f"aggr must be 'sum' or 'mean', got {aggr!r}")
    if make_conv is not None and dtype is not None:
      raise ValueError('HeteroConv(make_conv=..., dtype=...): set the '
                       'compute dtype inside the factory instead')
    self.etypes = tuple(tuple(et) for et in etypes)
    self.aggr = aggr
    self.dtype = dtype
    self.factory = make_conv is not None
    dims = _in_dims(in_features, _ntypes(self.etypes))
    self.ntypes = tuple(dims)
    targets = set()
    for et in self.etypes:
      a, _, b = et
      if a not in dims or b not in dims:
        continue
      targets.add(b)
      if not self.factory:
        self.add_module(f'lin_{as_str(et)}',
                        nn.Linear(dims[a], out_features, bias=False))
        continue
      if dims[a] != dims[b]:
        raise ValueError(
            f'HeteroConv(make_conv=...) needs equal feature widths for '
            f'{et}: {dims[a]} vs {dims[b]} — project per-type inputs first')
      conv = make_conv(dims[a], out_features)
      if not isinstance(conv, nn.Module):
        raise NotImplementedError(
            f'make_conv gave a {type(conv).__name__}, not a torch module: '
            'a factory must return an nn.Module taking (x, edge_index, '
            'edge_mask), e.g. SAGEConv, GCNConv or GATConv')
      self.add_module(f'conv_{as_str(et)}', conv)
    for nt, d in dims.items():
      if not self.factory or nt not in targets:
        self.add_module(f'lin_self_{nt}', nn.Linear(d, out_features))

  def forward(self, x_dict, edge_index_dict, edge_mask_dict=None):
    out, counts = {}, {}
    for et in self.etypes:
      a, _, b = et
      if a not in x_dict or b not in x_dict:
        continue
      xa = x_dict[a]
      if et in edge_index_dict:
        ei = edge_index_dict[et]
        em = (edge_mask_dict or {}).get(et)
      else:
        ei = torch.zeros((2, 0), dtype=torch.int32, device=xa.device)
        em = torch.zeros(0, dtype=torch.bool, device=xa.device)
      na, nb = xa.shape[0], x_dict[b].shape[0]
      if self.factory:
        conv = getattr(self, f'conv_{as_str(et)}')
        if a == b:
          agg = conv(xa, ei, em)
        else:
          src = ei[0].clamp(0, na - 1) + nb
          agg = conv(torch.cat([x_dict[b], xa]),
                     torch.stack([src.to(ei.dtype), ei[1]]), em)[:nb]
      else:
        src = ei[0].long().clamp(0, na - 1)
        msg = _dense(getattr(self, f'lin_{as_str(et)}'),
                     torch.index_select(xa, 0, src), self.dtype)
        agg = segment_mean(msg, ei[1], nb, em)
      out[b] = agg if b not in out else out[b] + agg
      counts[b] = counts.get(b, 0) + 1
    res = {}
    for nt, x in x_dict.items():
      agg = None
      if nt in out:
        agg = out[nt] / counts[nt] if self.aggr == 'mean' else out[nt]
      if self.factory and agg is not None:
        res[nt] = agg
        continue
      h = _dense(getattr(self, f'lin_self_{nt}'), x, self.dtype)
      res[nt] = h if agg is None else h + agg
    return res


class RGCN(_Resettable):
  """Relational GCN: ``num_layers`` `HeteroConv` layers (``conv{i}``),
  relu (and dropout in training) between them.

  ``forward(x_dict, edge_index_dict, edge_mask_dict=None)`` returns the
  ``target_ntype``'s ``[cap, out]`` logits, or every type's when it is
  None; f32 either way.
  """

  def __init__(self, etypes: Sequence[EdgeType], in_features: InFeatures,
               hidden_features: int, out_features: int,
               num_layers: int = 2, dropout: float = 0.0,
               target_ntype: Optional[NodeType] = None,
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    self.num_layers = int(num_layers)
    self.dropout = float(dropout)
    self.target_ntype = target_ntype
    self.dtype = dtype
    dims = _in_dims(in_features, _ntypes(etypes))
    for i in range(self.num_layers):
      feats = out_features if i == self.num_layers - 1 else hidden_features
      self.add_module(f'conv{i}', HeteroConv(etypes, dims, feats,
                                             dtype=dtype))
      dims = {nt: feats for nt in dims}

  def forward(self, x_dict, edge_index_dict, edge_mask_dict=None):
    h = x_dict
    for i in range(self.num_layers):
      h = getattr(self, f'conv{i}')(h, edge_index_dict, edge_mask_dict)
      if i < self.num_layers - 1:
        h = {nt: torch.relu(v) for nt, v in h.items()}
        if self.dropout > 0:
          h = {nt: F.dropout(v, self.dropout, self.training)
               for nt, v in h.items()}
    h = {nt: v.float() for nt, v in h.items()}
    if self.target_ntype is not None:
      return h[self.target_ntype]
    return h


class HGTConv(_Resettable):
  """Heterogeneous Graph Transformer convolution: per-type Q/K/V
  projections, per-edge-type relation matrices (``w_att_*``,
  ``w_msg_*``, ``[heads, f, f]``) and priors (``prior_*``, ``[heads]``),
  masked attention per target node.

  The attention is not one softmax over a target's edges of every type:
  each edge type's scores are shifted by that edge type's own segment
  max, and the numerators and denominators are then summed across edge
  types, as in the JAX module.  An edge type absent from a batch adds
  nothing; a type no edge type reaches gets its skip projection alone
  (and has no ``out_*`` projection when no edge type of ``etypes``
  targets it).

  Args:
    ntypes / etypes: the types it holds parameters for.
    in_features: input width (int or ``{NodeType: width}``).
    out_features: output width, ``heads * f``.
  """

  def __init__(self, ntypes: Sequence[NodeType], etypes: Sequence[EdgeType],
               in_features: InFeatures, out_features: int, heads: int = 2,
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    if out_features % heads:
      raise ValueError(f'out_features {out_features} is not a multiple of '
                       f'heads {heads}')
    self.ntypes = tuple(ntypes)
    self.etypes = tuple(tuple(et) for et in etypes)
    self.heads, self.out_features, self.dtype = heads, out_features, dtype
    f = out_features // heads
    dims = _in_dims(in_features, self.ntypes)
    for nt in self.ntypes:
      for proj in ('q', 'k', 'v'):
        self.add_module(f'{proj}_{nt}', nn.Linear(dims[nt], out_features))
    for et in self.etypes:
      for name in ('w_att', 'w_msg'):
        w = torch.empty(heads, f, f)
        bound = math.sqrt(6.0 / (2 * f))
        self.register_parameter(f'{name}_{as_str(et)}', nn.Parameter(
            w.uniform_(-bound, bound)))
      self.register_parameter(f'prior_{as_str(et)}',
                              nn.Parameter(torch.ones(heads)))
    targets = {d for (s, _, d) in self.etypes if s in dims}
    for nt in self.ntypes:
      if nt in targets:
        self.add_module(f'out_{nt}', nn.Linear(out_features, out_features))
      self.add_module(f'skip_{nt}', nn.Linear(dims[nt], out_features))

  def forward(self, x_dict, edge_index_dict, edge_mask_dict=None):
    h, f, dt = self.heads, self.out_features // self.heads, self.dtype
    q, k, v = {}, {}, {}
    for nt in self.ntypes:
      if nt not in x_dict:
        continue
      x = x_dict[nt]
      n = x.shape[0]
      q[nt] = _dense(getattr(self, f'q_{nt}'), x, dt).reshape(n, h, f)
      k[nt] = _dense(getattr(self, f'k_{nt}'), x, dt).reshape(n, h, f)
      v[nt] = _dense(getattr(self, f'v_{nt}'), x, dt).reshape(n, h, f)
    agg, den = {}, {}
    for et in self.etypes:
      if et not in edge_index_dict:
        continue
      a, _, b = et
      if a not in k or b not in q:
        continue
      ei = edge_index_dict[et]
      em = (edge_mask_dict or {}).get(et)
      na, nb = k[a].shape[0], q[b].shape[0]
      src = ei[0].long().clamp(0, na - 1)
      dst = ei[1].long()
      valid = em if em is not None else dst >= 0
      dsafe = torch.where(valid, dst, nb)
      dclip = dst.clamp(0, nb - 1)
      s = as_str(et)
      w_att, w_msg = getattr(self, f'w_att_{s}'), getattr(self, f'w_msg_{s}')
      ke = torch.einsum('ehf,hfg->ehg', torch.index_select(k[a], 0, src),
                        w_att.to(k[a].dtype))
      ve = torch.einsum('ehf,hfg->ehg', torch.index_select(v[a], 0, src),
                        w_msg.to(v[a].dtype))
      qe = torch.index_select(q[b], 0, dclip)
      score = ((qe * ke).sum(-1).float() * getattr(self, f'prior_{s}')[None, :]
               / math.sqrt(f))
      score = torch.where(valid[:, None], score, float('-inf'))
      smax = segment_max(score, dsafe, nb)
      ex = torch.where(valid[:, None],
                       torch.exp(score - torch.index_select(smax, 0, dclip)),
                       0.0)
      num = segment_sum((ex.to(ve.dtype)[:, :, None] * ve).reshape(-1, h * f),
                        dsafe, nb).reshape(nb, h, f)
      agg[b] = num if b not in agg else agg[b] + num
      d_et = segment_sum(ex, dsafe, nb)
      den[b] = d_et if b not in den else den[b] + d_et
    out = {}
    for nt in q:
      x = x_dict[nt]
      skip = _dense(getattr(self, f'skip_{nt}'), x, dt)
      if nt not in agg:
        out[nt] = skip
        continue
      att = agg[nt] / torch.clamp(den[nt], min=1e-16)[:, :, None]
      att = F.gelu(att.reshape(x.shape[0], h * f), approximate='tanh')
      out[nt] = _dense(getattr(self, f'out_{nt}'), att, dt) + skip
    return out


class HGT(_Resettable):
  """HGT stack: per-type input projections ``in_{nt}``, ``num_layers``
  `HGTConv` layers with relu, and a head — ``head`` on the
  ``target_ntype`` (its ``[cap, out]`` logits), else ``head_{nt}`` for
  every type; f32 either way.

  Args:
    ntypes / etypes: the node and edge types.
    in_features: input width (int or ``{NodeType: width}``: the types
      with inputs).
  """

  def __init__(self, ntypes: Sequence[NodeType], etypes: Sequence[EdgeType],
               in_features: InFeatures, hidden_features: int,
               out_features: int, num_layers: int = 2, heads: int = 2,
               target_ntype: Optional[NodeType] = None,
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    self.num_layers = int(num_layers)
    self.target_ntype = target_ntype
    self.dtype = dtype
    dims = _in_dims(in_features, ntypes)
    for nt, d in dims.items():
      self.add_module(f'in_{nt}', nn.Linear(d, hidden_features))
    for i in range(self.num_layers):
      self.add_module(f'conv{i}', HGTConv(ntypes, etypes, hidden_features,
                                          hidden_features, heads,
                                          dtype=dtype))
    if target_ntype is not None:
      self.head = nn.Linear(hidden_features, out_features)
    else:
      for nt in dims:
        self.add_module(f'head_{nt}', nn.Linear(hidden_features,
                                                out_features))

  def forward(self, x_dict, edge_index_dict, edge_mask_dict=None):
    dt = self.dtype
    h = {nt: _dense(getattr(self, f'in_{nt}'), x, dt)
         for nt, x in x_dict.items()}
    for i in range(self.num_layers):
      h = getattr(self, f'conv{i}')(h, edge_index_dict, edge_mask_dict)
      h = {nt: torch.relu(v) for nt, v in h.items()}
    if self.target_ntype is not None:
      return _dense(self.head, h[self.target_ntype], dt).float()
    return {nt: _dense(getattr(self, f'head_{nt}'), v, dt).float()
            for nt, v in h.items()}


def _flax_state_dict(params) -> Dict[str, torch.Tensor]:
  """A Flax param tree (nested dicts of arrays, with or without the top
  ``'params'`` level) -> a state dict: a Dense's ``kernel`` ``[in,
  out]`` becomes ``weight`` (transposed) beside its ``bias``; any other
  array keeps its name and shape."""
  tree = params.get('params', params)
  state = {}

  def walk(prefix, node):
    for name, val in node.items():
      key = prefix + name
      if hasattr(val, 'items'):
        if 'kernel' in val:
          state[key + '.weight'] = torch.from_numpy(np.ascontiguousarray(
              np.asarray(val['kernel'], np.float32).T))
          if 'bias' in val:
            state[key + '.bias'] = torch.from_numpy(
                np.asarray(val['bias'], np.float32).copy())
        else:
          walk(key + '.', val)
      else:
        state[key] = torch.from_numpy(np.asarray(val, np.float32).copy())

  walk('', tree)
  return state


def rgcn_from_flax(params) -> Dict[str, torch.Tensor]:
  """A Flax `RGCN` param tree -> an `RGCN` state dict."""
  return _flax_state_dict(params)


def hetero_conv_from_flax(params) -> Dict[str, torch.Tensor]:
  """A Flax param tree of `HeteroConv(make_conv=...)` layers (alone or
  in a model, e.g. the bipartite example's ``BiSAGE`` or the IGBH
  example's RGAT) -> a state dict of the port's factory-mode
  `HeteroConv`: each ``conv_{etype}`` scope's one factory-made conv
  (Flax names it ``SAGEConv_0`` or ``GATConv_0``) becomes the port's
  ``conv_{etype}`` itself, and that conv's unnamed ``Dense_0`` (GAT's
  and GCN's projection) its ``lin``."""
  out = {}
  for k, v in _flax_state_dict(params).items():
    k = re.sub(r'(^|\.)(conv_[^.]+)\.[A-Za-z]\w*_0\.', r'\1\2.', k)
    out[re.sub(r'(^|\.)(conv_[^.]+)\.Dense_0\.', r'\1\2.lin.', k)] = v
  return out


def hgt_from_flax(params) -> Dict[str, torch.Tensor]:
  """A Flax `HGT` param tree -> an `HGT` state dict (``w_att_*`` and
  ``w_msg_*`` stay ``[heads, f, f]``, ``prior_*`` ``[heads]``).  A Flax
  model creates a type's parameters only where its init batch reached
  them; the port's module holds every type's, so load a tree from an
  init batch with every edge type, or with ``strict=False``."""
  return _flax_state_dict(params)
