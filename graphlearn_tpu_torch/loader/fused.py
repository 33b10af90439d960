"""`EpochStats`, the lazy statistics a fused epoch returns (the JAX
package's `loader/fused.py:428-463`).  The epoch driver itself lives
with its only ported epoch, `loader.fused_tree.FusedTreeEpoch`.
"""
from __future__ import annotations

import torch


class EpochStats:
  """Lazy epoch statistics: device tensors, read (and synchronised) on
  access."""

  def __init__(self, losses: torch.Tensor, correct: torch.Tensor,
               valid: torch.Tensor):
    self.losses = losses
    self._correct = correct
    self._valid = valid

  @property
  def loss(self) -> float:
    return float(self.losses.mean())

  @property
  def correct(self) -> int:
    return int(self._correct)

  @property
  def seeds(self) -> int:
    return int(self._valid)

  @property
  def accuracy(self) -> float:
    return self.correct / max(self.seeds, 1)

  def __getitem__(self, key: str):
    return getattr(self, key)

  def __repr__(self):
    return f'EpochStats(steps={self.losses.shape[0]}, <lazy>)'
