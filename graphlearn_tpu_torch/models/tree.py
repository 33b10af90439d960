"""Tree-layout GraphSAGE: message passing on the sampler's native
window structure (the JAX package's `models/tree.py::TreeSAGE`).

Level ``t`` holds ``B * k_1 ... k_t`` slots and each parent owns a
contiguous window of ``k_{t+1}`` children, so mean aggregation is a
reshape and a masked mean — no scatter.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def tree_level_sizes(batch_size: int, fanouts: Sequence[int]
                     ) -> Tuple[int, ...]:
  """Slot count per tree level: ``[B, B*k1, B*k1*k2, ...]``."""
  sizes = [batch_size]
  for k in fanouts:
    sizes.append(sizes[-1] * int(k))
  return tuple(sizes)


class TreeSAGE(nn.Module):
  """GraphSAGE (mean aggregator) over tree-layout level tensors.

  ``forward(xs, masks)``: ``xs[t]`` is the ``[F_t, in_features]``
  feature tensor of level ``t`` and ``masks[t]`` its ``[F_t]`` validity;
  returns the seed level's ``[B, out_features]`` logits in f32.  Layer
  ``l`` has ``layer{l}_self`` (with bias) and ``layer{l}_neigh``
  (without), shared across levels — the Flax module's parameter names.

  ``dtype`` is the compute dtype (the Flax module's ``dtype``; None
  computes in f32): the parameters stay f32, the inputs, weights and
  biases are cast to it (bf16 runs the matmuls on tensor cores), and
  each window's child count is taken in f32 and then cast, as in JAX.

  Parameters start uninitialised: call `reset_parameters` with a
  generator, or load a state dict (e.g. from `tree_sage_from_flax`).
  """

  def __init__(self, in_features: int, hidden_features: int,
               out_features: int, num_layers: int = 2,
               dtype: Optional[torch.dtype] = None):
    super().__init__()
    self.num_layers = int(num_layers)
    self.dtype = dtype
    dims = [in_features] + [hidden_features] * (num_layers - 1)
    for layer in range(num_layers):
      out = hidden_features if layer < num_layers - 1 else out_features
      self.add_module(f'layer{layer}_self', nn.utils.skip_init(
          nn.Linear, dims[layer], out))
      self.add_module(f'layer{layer}_neigh', nn.utils.skip_init(
          nn.Linear, dims[layer], out, bias=False))

  @torch.no_grad()
  def reset_parameters(self, generator: torch.Generator) -> None:
    """Init every weight and bias from ``U(-1/sqrt(fan_in),
    1/sqrt(fan_in))`` (`nn.Linear`'s default law), drawn on the CPU from
    ``generator`` so the values do not depend on the device."""
    for p_name, p in self.named_parameters():
      lin = self.get_submodule(p_name.rsplit('.', 1)[0])
      bound = 1.0 / math.sqrt(lin.in_features)
      vals = torch.empty(p.shape, dtype=torch.float32).uniform_(
          -bound, bound, generator=generator)
      p.copy_(vals)

  def forward(self, xs: Sequence[torch.Tensor],
              masks: Sequence[torch.Tensor]) -> torch.Tensor:
    if len(xs) != self.num_layers + 1:
      raise ValueError(
          f'TreeSAGE(num_layers={self.num_layers}) needs '
          f'{self.num_layers + 1} levels, got {len(xs)}')
    dt = self.dtype or torch.float32
    # zero invalid slots once: they then add nothing as masked-out self
    # terms or as masked children
    hs = [x.to(dt) * m[:, None].to(dt) for x, m in zip(xs, masks)]
    for layer in range(self.num_layers):
      lin_self = self.get_submodule(f'layer{layer}_self')
      lin_neigh = self.get_submodule(f'layer{layer}_neigh')
      w_self, b_self = lin_self.weight.to(dt), lin_self.bias.to(dt)
      w_neigh = lin_neigh.weight.to(dt)
      new_hs = []
      for t in range(self.num_layers - layer):
        parent, child = hs[t], hs[t + 1]
        p = parent.shape[0]
        k = child.shape[0] // p
        cm = masks[t + 1].reshape(p, k)
        cd = child.reshape(p, k, child.shape[1])
        # the mask gates the sum too: past layer 0 an invalid slot holds
        # relu(bias), not zero
        cnt = torch.clamp(cm.sum(dim=1, dtype=torch.float32), min=1.0)
        mean = (cd * cm[..., None].to(dt)).sum(dim=1) / cnt[:, None].to(dt)
        h = F.linear(parent, w_self, b_self) + F.linear(mean, w_neigh)
        if layer < self.num_layers - 1:
          h = torch.relu(h)
        new_hs.append(h)
      hs = new_hs
    return hs[0].float()


def tree_sage_from_flax(params) -> Dict[str, torch.Tensor]:
  """A Flax `TreeSAGE` param tree (nested dicts of arrays, with or
  without the top ``'params'`` level) -> a `TreeSAGE` state dict.
  Flax ``Dense.kernel`` is ``[in, out]``; ``Linear.weight`` is its
  transpose."""
  tree = params.get('params', params)
  state = {}
  for mod_name, leaves in tree.items():
    state[f'{mod_name}.weight'] = torch.from_numpy(
        np.ascontiguousarray(np.asarray(leaves['kernel'], np.float32).T))
    if 'bias' in leaves:
      state[f'{mod_name}.bias'] = torch.from_numpy(
          np.asarray(leaves['bias'], np.float32).copy())
  return state
