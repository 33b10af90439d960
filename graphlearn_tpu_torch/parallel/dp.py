"""The device mesh and data-parallel training (the JAX package's
`parallel/dp.py:26-109`).

`Mesh` is the port's stand-in for a `jax.sharding.Mesh`: the cards of
the ``data`` axis and the collectives the data plane needs.  This slice
runs one card (P=1), where the all-to-all and the gradient mean are the
identity; meshes of more cards need NCCL collectives and are ROADMAP
slice 12.  Stacked batches carry a leading axis of the mesh size, as in
JAX.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models.train import _loss_and_correct
from ..utils.device import resolve_device


class Mesh:
  """A 1-D mesh of ``size`` cards (the JAX package's ``data`` axis)."""

  def __init__(self, device, size: int = 1):
    if size != 1:
      raise NotImplementedError(
          f'a mesh of {size} cards needs collectives across cards, which '
          'are ROADMAP slice 12; this port runs one card (P=1)')
    self.device = resolve_device(device)
    self.size = 1

  def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
    """``[P, ...]`` row ``q`` sent to card ``q`` -> ``[P, ...]`` row ``q``
    received from card ``q`` (the tiled ``jax.lax.all_to_all``)."""
    return x

  def mean_gradients(self, params) -> None:
    """Average every parameter's gradient over the mesh (``pmean``)."""
    return None


def make_mesh(n_devices: Optional[int] = 1, device='cuda') -> Mesh:
  """A mesh of ``n_devices`` cards starting at ``device`` (`Mesh` raises
  NotImplementedError for more than one)."""
  return Mesh(device, 1 if n_devices is None else int(n_devices))


def local_piece(batch, index: int = 0):
  """Card ``index``'s slice of a stacked ``[P, ...]`` Batch."""
  from ..loader.transform import Batch

  def pick(v):
    if isinstance(v, torch.Tensor):
      return v[index]
    if isinstance(v, dict):
      return {k: pick(x) for k, x in v.items()}
    return v
  return Batch(**{f: pick(getattr(batch, f)) for f in Batch.FIELDS},
               batch_size=batch.batch_size)


def make_dp_supervised_step(model, optimizer, batch_size: int, mesh: Mesh):
  """The data-parallel supervised step over a stacked batch.

  Returns ``step(stacked_batch) -> (mean_loss, correct)``: each card's
  piece runs forward and backward, gradients are averaged over the mesh
  (`Mesh.mean_gradients`), the optimizer steps once, and the loss mean
  and the summed count of correct seed predictions come back as device
  tensors.
  """

  def step(stacked):
    model.train()
    optimizer.zero_grad(set_to_none=True)
    losses, correct = [], []
    for p in range(mesh.size):
      loss, c = _loss_and_correct(model, local_piece(stacked, p),
                                  batch_size)
      loss.backward()
      losses.append(loss.detach())
      correct.append(c)
    mesh.mean_gradients(model.parameters())
    optimizer.step()
    return torch.stack(losses).mean(), torch.stack(correct).sum()

  return step
