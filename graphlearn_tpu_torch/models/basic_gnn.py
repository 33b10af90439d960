"""Stacked GNN models over padded batches: `BasicGNN` and `GraphSAGE`
(the JAX package's `models/basic_gnn.py:20-62`), and
`graphsage_from_flax`, which carries a Flax `GraphSAGE`'s parameters
into the module."""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
from torch import nn

from .conv import SAGEConv


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
