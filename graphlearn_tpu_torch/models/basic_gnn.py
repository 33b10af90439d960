"""Stacked GNN models over padded batches: `BasicGNN`, `GraphSAGE`, `GCN`
and SEAL's `DGCNN` (the JAX package's `models/basic_gnn.py:20-69,
90-147`), and `graphsage_from_flax`, `gcn_from_flax` and
`dgcnn_from_flax`, which carry a Flax model's parameters into the
module."""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .conv import GCNConv, SAGEConv


class BasicGNN(nn.Module):
  """``num_layers`` convolutions: conv -> relu between layers, the last
  layer linear.  Layer ``i`` is the submodule ``conv{i}``."""

  def __init__(self, in_features: int, hidden_features: int,
               out_features: int, num_layers: int = 2):
    super().__init__()
    self.num_layers = int(num_layers)
    for i in range(self.num_layers):
      fin = in_features if i == 0 else hidden_features
      fout = out_features if i == self.num_layers - 1 else hidden_features
      self.add_module(f'conv{i}', self.make_conv(fin, fout, i))

  def make_conv(self, in_features: int, out_features: int,
                idx: int) -> nn.Module:
    raise NotImplementedError

  @torch.no_grad()
  def reset_parameters(self, generator: torch.Generator) -> None:
    """Init every weight and bias from ``U(-1/sqrt(fan_in),
    1/sqrt(fan_in))``, drawn on the CPU from ``generator`` so the values
    do not depend on the device."""
    for name, p in self.named_parameters():
      lin = self.get_submodule(name.rsplit('.', 1)[0])
      bound = 1.0 / math.sqrt(lin.in_features)
      p.copy_(torch.empty(p.shape, dtype=torch.float32).uniform_(
          -bound, bound, generator=generator))

  def forward(self, x, edge_index, edge_mask=None, edge_weight=None):
    for i in range(self.num_layers):
      x = self.get_submodule(f'conv{i}')(x, edge_index, edge_mask,
                                         edge_weight=edge_weight)
      if i < self.num_layers - 1:
        x = torch.relu(x)
    return x


class GraphSAGE(BasicGNN):
  """The flagship model (3 layers, hidden 256 in the reference's
  products example)."""

  def make_conv(self, in_features, out_features, idx):
    return SAGEConv(in_features, out_features)


def graphsage_from_flax(params) -> Dict[str, torch.Tensor]:
  """A Flax `GraphSAGE` param tree (nested dicts of arrays, with or
  without the top ``'params'`` level) -> a `GraphSAGE` state dict.  A
  Flax ``Dense.kernel`` is ``[in, out]``; ``Linear.weight`` is its
  transpose."""
  tree = params.get('params', params)
  state = {}
  for conv, lins in tree.items():
    for lin, leaves in lins.items():
      state[f'{conv}.{lin}.weight'] = torch.from_numpy(np.ascontiguousarray(
          np.asarray(leaves['kernel'], np.float32).T))
      if 'bias' in leaves:
        state[f'{conv}.{lin}.bias'] = torch.from_numpy(
            np.asarray(leaves['bias'], np.float32).copy())
  return state


class GCN(BasicGNN):
  """A `BasicGNN` of `GCNConv` layers."""

  def make_conv(self, in_features, out_features, idx):
    return GCNConv(in_features, out_features)


class DGCNN(nn.Module):
  """Deep Graph CNN, SEAL's classifier (the JAX package's `DGCNN`): tanh
  `GCNConv` layers (``num_layers`` of ``hidden_features``, then one of
  width 1, the sort key), their outputs concatenated (``D =
  num_layers * hidden + 1``), the ``k`` valid nodes with the largest
  key pooled in descending order (ties by the lower index, as
  `jax.lax.top_k`; missing rows zero), then ``Conv1d(D, 16, 1)``, a
  max pool of 2, ``Conv1d(16, 32, min(5, L))`` (VALID), ``Linear(., 128)``
  and ``Linear(128, out_features)``.

  ``forward(x, edge_index, edge_mask=None, node_mask=None)`` takes one
  graph's node table and returns its ``[out_features]`` logits.
  """

  def __init__(self, in_features: int, hidden_features: int = 32,
               out_features: int = 2, num_layers: int = 3, k: int = 30):
    super().__init__()
    self.num_layers, self.k = int(num_layers), int(k)
    for i in range(self.num_layers + 1):
      fin = in_features if i == 0 else hidden_features
      fout = 1 if i == self.num_layers else hidden_features
      self.add_module(f'conv{i}', GCNConv(fin, fout))
    width = self.num_layers * hidden_features + 1
    self.conv1d_a = nn.Conv1d(width, 16, 1)
    length = self.k // 2 if self.k >= 2 else self.k
    kernel = min(5, length)
    self.conv1d_b = nn.Conv1d(16, 32, kernel)
    self.lin1 = nn.Linear((length - kernel + 1) * 32, 128)
    self.lin2 = nn.Linear(128, out_features)

  def forward(self, x, edge_index, edge_mask=None, node_mask=None):
    n = x.shape[0]
    if node_mask is None:
      node_mask = torch.ones(n, dtype=torch.bool, device=x.device)
    hs, h = [], x
    for i in range(self.num_layers + 1):
      h = torch.tanh(self.get_submodule(f'conv{i}')(h, edge_index,
                                                    edge_mask))
      hs.append(h)
    hcat = torch.cat(hs, dim=-1)                          # [n, D]
    key = torch.where(node_mask, h[:, 0], float('-inf'))
    # a stable descending sort: equal keys keep the lower index first
    top = torch.sort(key, descending=True, stable=True).indices[:self.k]
    valid = key[top] > float('-inf')
    pooled = torch.where(valid[:, None], hcat[top], 0.0)  # [min(k, n), D]
    if pooled.shape[0] < self.k:
      pooled = torch.cat([pooled, pooled.new_zeros(
          (self.k - pooled.shape[0], pooled.shape[1]))])
    z = torch.relu(self.conv1d_a(pooled.t()[None]))      # [1, 16, k]
    if z.shape[2] >= 2:
      z = F.max_pool1d(z, 2, 2)
    z = torch.relu(self.conv1d_b(z))                      # [1, 32, L']
    # Flax flattens [1, L', 32] length-major
    z = z.transpose(1, 2).reshape(1, -1)
    return self.lin2(torch.relu(self.lin1(z)))[0]


def _flax_layer(prefix: str, leaves) -> Dict[str, torch.Tensor]:
  """One Flax layer's leaves -> state-dict entries under ``prefix``:
  ``Embed.embedding`` -> ``nn.Embedding.weight``; a ``Dense.kernel``
  ``[in, out]`` -> ``nn.Linear.weight`` ``[out, in]``; a ``Conv.kernel``
  ``[kernel, in, out]`` -> ``nn.Conv1d.weight`` ``[out, in, kernel]``;
  the bias as it is."""
  def t(a):
    return torch.tensor(np.asarray(a, np.float32))
  if 'embedding' in leaves:
    return {f'{prefix}.weight': t(leaves['embedding'])}
  kernel = np.asarray(leaves['kernel'], np.float32)
  out = {f'{prefix}.weight': t(kernel.transpose(tuple(
      range(kernel.ndim))[::-1]))}
  if 'bias' in leaves:
    out[f'{prefix}.bias'] = t(leaves['bias'])
  return out


def gcn_from_flax(params) -> Dict[str, torch.Tensor]:
  """A Flax `GCN` param tree (with or without the top ``'params'``
  level) -> a `GCN` state dict."""
  tree = params.get('params', params)
  state = {}
  for conv, sub in tree.items():
    state.update(_flax_layer(f'{conv}.lin', sub['Dense_0']))
  return state


def dgcnn_from_flax(params) -> Dict[str, torch.Tensor]:
  """A Flax `DGCNN` param tree -> a `DGCNN` state dict.  A tree that
  wraps one behind a label embedding (``{'Embed_0', 'DGCNN_0'}``, SEAL's
  classifier) -> the state dict of a module whose children ``embed``
  (an `nn.Embedding`) and ``dgcnn`` (the `DGCNN`) hold them."""
  tree = params.get('params', params)
  if 'DGCNN_0' in tree:
    state = {f'dgcnn.{k}': v
             for k, v in dgcnn_from_flax(tree['DGCNN_0']).items()}
    state.update(_flax_layer('embed', tree['Embed_0']))
    return state
  names = {'Dense_0': 'lin1', 'Dense_1': 'lin2'}
  state = {}
  for name, sub in tree.items():
    if name in names:
      state.update(_flax_layer(names[name], sub))
    elif name.startswith('conv1d'):
      state.update(_flax_layer(name, sub))
    else:
      state.update(_flax_layer(f'{name}.lin', sub['Dense_0']))
  return state
