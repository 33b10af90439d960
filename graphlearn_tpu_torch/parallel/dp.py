"""The partition mesh and data-parallel training (the JAX package's
`parallel/dp.py:26-170`).

`Mesh` is the port's stand-in for a `jax.sharding.Mesh` over the
``data`` axis: ``size`` partitions, all on ONE card (``device``), in one
process.  Every per-partition array is stacked with a leading axis of
the mesh size, as the JAX package's stacked batches are, so its
collectives are tensor ops on that card: the tiled all-to-all is a
transpose of the stacked ``[P_src, P_dst, ...]`` send buffers, and the
gradient mean is a division of the gradients summed over the pieces.
Nothing here crosses cards; a mesh of several cards (one process per
card, NCCL) is ROADMAP slice 12.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models.train import (_correct, _loss_and_correct,
                            link_loss_from_metadata)
from ..utils.device import resolve_device


class Mesh:
  """A 1-D mesh of ``size`` partitions sharing the one card ``device``
  (the JAX package's ``data`` axis)."""

  def __init__(self, device, size: int = 1):
    if int(size) < 1:
      raise ValueError(f'a mesh needs at least one partition, got {size}')
    self.device = resolve_device(device)
    self.size = int(size)

  def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
    """Stacked send buffers ``[P_src, P_dst, ...]`` (row ``q`` of source
    ``p``'s buffer goes to partition ``q``) -> the receive buffers
    ``[P_dst, P_src, ...]`` (row ``p`` of ``q``'s buffer came from
    ``p``): the tiled ``jax.lax.all_to_all`` of every partition at
    once, a transpose on the card (the identity at P = 1)."""
    if x.shape[0] != self.size or x.shape[1] != self.size:
      raise ValueError(f'all_to_all takes [{self.size}, {self.size}, ...] '
                       f'send buffers, got {tuple(x.shape)}')
    return x.transpose(0, 1).contiguous()

  def mean_gradients(self, params) -> None:
    """Turn the gradients summed over the ``size`` pieces into their
    mean (``pmean``), in place."""
    if self.size == 1:
      return
    for p in params:
      if p.grad is not None:
        p.grad.div_(self.size)


def make_mesh(n_devices: Optional[int] = 1, device='cuda') -> Mesh:
  """A mesh of ``n_devices`` partitions on the one card ``device`` (the
  partitions share it: no collective here crosses cards)."""
  return Mesh(device, 1 if n_devices is None else int(n_devices))


def local_piece(batch, index: int = 0):
  """Partition ``index``'s slice of a stacked ``[P, ...]`` `Batch` or
  `HeteroBatch` (the dict fields sliced key by key)."""
  cls = type(batch)

  def pick(v):
    if isinstance(v, torch.Tensor):
      return v[index]
    if isinstance(v, dict):
      return {k: pick(x) for k, x in v.items()}
    return v
  return cls(**{f: pick(getattr(batch, f)) for f in cls.FIELDS},
             batch_size=batch.batch_size)


def make_dp_supervised_step(model, optimizer, batch_size: int, mesh: Mesh):
  """The data-parallel supervised step over a stacked batch.

  Returns ``step(stacked_batch) -> (mean_loss, correct)``: each
  partition's piece runs forward and backward (the gradients add up
  over the pieces), `Mesh.mean_gradients` turns the sum into the mean,
  the optimizer steps once, and the loss mean and the summed count of
  correct seed predictions come back as device tensors.
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


def make_dp_unsupervised_step(model, optimizer, mesh: Mesh):
  """The data-parallel unsupervised (link-loss) step over a stacked link
  batch (`DistLinkNeighborLoader`).

  Returns ``step(stacked_batch) -> mean_loss``: each partition's piece
  embeds its nodes and takes the link loss of its own positives and
  negatives (`models.train.link_loss_from_metadata`: binary or triplet,
  by the metadata's keys), forward and backward (the gradients add up
  over the pieces); `Mesh.mean_gradients` turns the sum into the mean,
  the optimizer steps once, and the loss mean comes back as a device
  tensor.  As in JAX the model runs without the GNS edge weights.
  """

  def step(stacked):
    model.train()
    optimizer.zero_grad(set_to_none=True)
    losses = []
    for p in range(mesh.size):
      b = local_piece(stacked, p)
      emb = model(b.x, b.edge_index, b.edge_mask)
      loss = link_loss_from_metadata(emb, b.metadata)
      loss.backward()
      losses.append(loss.detach())
    mesh.mean_gradients(model.parameters())
    optimizer.step()
    return torch.stack(losses).mean()

  return step


def make_dp_eval_step(model, batch_size: int, mesh: Mesh):
  """The data-parallel evaluation step: ``step(stacked_batch) ->
  (correct, total)``, both summed over the pieces.  As in JAX the model
  runs without the GNS edge weights (evaluation batches come from an
  unbiased loader)."""

  @torch.no_grad()
  def step(stacked):
    model.eval()
    correct, total = [], []
    for p in range(mesh.size):
      b = local_piece(stacked, p)
      logits = model(b.x, b.edge_index, b.edge_mask)
      correct.append(_correct(logits, b.y, b.batch, batch_size))
      total.append((b.batch >= 0).sum())
    return torch.stack(correct).sum(), torch.stack(total).sum()

  return step
