"""Supervised training and eval steps on `Batch`es (the JAX package's
`models/train.py:35-119`).

The loss is the softmax cross entropy over the seed slots (table rows
``[0, batch_size)``), masked by seed validity, so a padded tail batch
trains correctly.  Where the sampler attached GNS importance weights
(``Batch.metadata['edge_weight']``) they flow into the aggregation.
The model and the optimizer hold the state that JAX's `TrainState`
carries.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def supervised_loss(logits: torch.Tensor, y: torch.Tensor,
                    batch_seeds: torch.Tensor,
                    batch_size: int) -> torch.Tensor:
  """Masked softmax cross entropy over the seed slots."""
  seed_logits = logits[:batch_size]
  valid = (batch_seeds >= 0).to(seed_logits.dtype)
  ce = F.cross_entropy(seed_logits, y[:batch_size].long(), reduction='none')
  return (ce * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def _apply_with_weights(model, batch) -> torch.Tensor:
  """Apply the model to a Batch, with the GNS edge weights when the
  sampler attached them."""
  ew = (batch.metadata or {}).get('edge_weight')
  if ew is not None:
    return model(batch.x, batch.edge_index, batch.edge_mask, edge_weight=ew)
  return model(batch.x, batch.edge_index, batch.edge_mask)


def _correct(logits: torch.Tensor, y: torch.Tensor, seeds: torch.Tensor,
             batch_size: int) -> torch.Tensor:
  """Correct predictions among the valid seed slots."""
  pred = torch.argmax(logits.detach()[:batch_size], dim=-1)
  return ((pred == y[:batch_size].long()) & (seeds >= 0)).sum()


def _loss_and_correct(model, batch, batch_size: int):
  """The seed-slot loss (with its graph) and the count of correct
  valid seed predictions for one single-card Batch."""
  logits = _apply_with_weights(model, batch)
  loss = supervised_loss(logits, batch.y, batch.batch, batch_size)
  return loss, _correct(logits, batch.y, batch.batch, batch_size)


def make_supervised_step(model, optimizer, batch_size: int):
  """``step(batch) -> (loss, correct)`` for a single-card Batch: one
  forward, backward and optimizer update; both results stay on the
  device (read them when needed)."""

  def step(batch):
    model.train()
    optimizer.zero_grad(set_to_none=True)
    loss, correct = _loss_and_correct(model, batch, batch_size)
    loss.backward()
    optimizer.step()
    return loss.detach(), correct

  return step


def make_eval_step(model, batch_size: int):
  """``step(batch) -> (correct, total)``: the masked seed-slot accuracy
  counts of one single-card Batch, without gradients; both stay on the
  device."""

  @torch.no_grad()
  def step(batch):
    model.eval()
    logits = _apply_with_weights(model, batch)
    return (_correct(logits, batch.y, batch.batch, batch_size),
            (batch.batch >= 0).sum())

  return step
