"""Supervised training and eval steps on `Batch`es and `HeteroBatch`es
(the JAX package's `models/train.py:35-119`, and the heterogeneous step
of `examples/hetero/train_hgt_mag.py:183-192`), and the link losses and
step of unsupervised training (`models/train.py:122-191`).

The loss is the softmax cross entropy over the seed slots (table rows
``[0, batch_size)``), masked by seed validity, so a padded tail batch
trains correctly; on a `HeteroBatch` over the seed type's logits,
labels and seeds.  Where the sampler attached GNS importance weights
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


def _extract(model, batch):
  """``(logits, y, seeds)`` of one single-card Batch."""
  return _apply_with_weights(model, batch), batch.y, batch.batch


def _loss_and_correct(model, batch, batch_size: int):
  """The seed-slot loss (with its graph) and the count of correct
  valid seed predictions for one single-card Batch."""
  logits, y, seeds = _extract(model, batch)
  loss = supervised_loss(logits, y, seeds, batch_size)
  return loss, _correct(logits, y, seeds, batch_size)


def _hetero_extract(input_type):
  """``(logits, y, seeds)`` of one HeteroBatch: the model's logits for
  the seed type ``input_type``, its labels and seeds."""

  def extract(model, batch):
    logits = model(batch.x_dict, batch.edge_index_dict,
                   batch.edge_mask_dict)
    return logits, batch.y_dict[input_type], batch.batch_dict[input_type]
  return extract


def _extracted_supervised_step(extract, model, optimizer, batch_size: int):
  """The one update body (masked seed-slot loss, backward, optimizer
  step, masked correct count) behind both supervised steps."""

  def step(batch):
    model.train()
    optimizer.zero_grad(set_to_none=True)
    logits, y, seeds = extract(model, batch)
    loss = supervised_loss(logits, y, seeds, batch_size)
    loss.backward()
    optimizer.step()
    return loss.detach(), _correct(logits, y, seeds, batch_size)

  return step


def _extracted_eval_step(extract, model, batch_size: int):

  @torch.no_grad()
  def step(batch):
    model.eval()
    logits, y, seeds = extract(model, batch)
    return _correct(logits, y, seeds, batch_size), (seeds >= 0).sum()

  return step


def make_supervised_step(model, optimizer, batch_size: int):
  """``step(batch) -> (loss, correct)`` for a single-card Batch: one
  forward, backward and optimizer update; both results stay on the
  device (read them when needed)."""
  return _extracted_supervised_step(_extract, model, optimizer, batch_size)


def make_eval_step(model, batch_size: int):
  """``step(batch) -> (correct, total)``: the masked seed-slot accuracy
  counts of one single-card Batch, without gradients; both stay on the
  device."""
  return _extracted_eval_step(_extract, model, batch_size)


def make_hetero_supervised_step(model, optimizer, batch_size: int,
                                input_type: str):
  """``step(batch) -> (loss, correct)`` for a `HeteroBatch` seeded with
  ``input_type`` nodes; ``model(x_dict, edge_index_dict,
  edge_mask_dict)`` returns that type's logits (`RGCN` / `HGT` with
  ``target_ntype=input_type``)."""
  return _extracted_supervised_step(_hetero_extract(input_type), model,
                                    optimizer, batch_size)


def make_hetero_eval_step(model, batch_size: int, input_type: str):
  """``step(batch) -> (correct, total)`` for a `HeteroBatch`, as
  `make_eval_step`."""
  return _extracted_eval_step(_hetero_extract(input_type), model,
                              batch_size)


def _rows(emb: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
  """``emb[clip(idx)]`` for any shape of ``idx`` (one `index_select`,
  whose backward is one `index_add_`)."""
  n = emb.shape[0]
  flat = idx.reshape(-1).long().clamp(0, n - 1)
  return torch.index_select(emb, 0, flat).reshape(idx.shape + (-1,))


def sigmoid_binary_cross_entropy(logits: torch.Tensor,
                                 labels: torch.Tensor) -> torch.Tensor:
  """``-y log σ(x) - (1 - y) log σ(-x)`` elementwise, in log-sigmoid
  form (`optax.sigmoid_binary_cross_entropy`)."""
  return (-labels * F.logsigmoid(logits)
          - (1.0 - labels) * F.logsigmoid(-logits))


def _masked_mean(ls: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
  v = valid.to(ls.dtype)
  return (ls * v).sum() / torch.clamp(v.sum(), min=1.0)


def unsupervised_link_loss(emb: torch.Tensor, metadata: dict
                           ) -> torch.Tensor:
  """The binary link loss of a link batch's metadata (``edge_label_index``,
  ``edge_label``, ``edge_label_mask``): the sigmoid cross entropy of the
  endpoints' embedding dot products against ``min(label, 1)``, averaged
  over the valid pairs."""
  eli = metadata['edge_label_index']
  label = metadata['edge_label'].to(emb.dtype)
  mask = metadata.get('edge_label_mask')
  logit = (_rows(emb, eli[0]) * _rows(emb, eli[1])).sum(-1)
  ls = sigmoid_binary_cross_entropy(logit, torch.clamp(label, max=1.0))
  valid = (eli[0] >= 0) & (eli[1] >= 0)
  if mask is not None:
    valid = mask & valid
  return _masked_mean(ls, valid)


def triplet_link_loss(emb: torch.Tensor, metadata: dict,
                      margin: float = 1.0) -> torch.Tensor:
  """The max-margin triplet loss of a triplet link batch's metadata
  (``src_index``, ``dst_pos_index``, ``dst_neg_index [B, A]``, -1 in
  invalid slots), averaged over the valid (source, negative) slots."""
  si = metadata['src_index']
  dp = metadata['dst_pos_index']
  dn = metadata['dst_neg_index']
  es = _rows(emb, si)
  pos = (es * _rows(emb, dp)).sum(-1)                 # [B]
  neg = (es[:, None, :] * _rows(emb, dn)).sum(-1)     # [B, A]
  ls = torch.relu(margin - pos[:, None] + neg)
  return _masked_mean(ls, ((si >= 0) & (dp >= 0))[:, None] & (dn >= 0))


def link_loss_from_metadata(emb: torch.Tensor, metadata: dict
                            ) -> torch.Tensor:
  """The binary or the triplet link loss, by the metadata's keys."""
  if 'edge_label_index' in metadata:
    return unsupervised_link_loss(emb, metadata)
  if 'src_index' in metadata:
    return triplet_link_loss(emb, metadata)
  raise KeyError('batch metadata carries neither edge_label_index '
                 '(binary) nor src_index (triplet) link labels')


def make_unsupervised_step(model, optimizer):
  """``step(batch) -> loss`` for a link `Batch` (`loader.
  LinkNeighborLoader`): the model's embeddings, the link loss of the
  batch's metadata (`link_loss_from_metadata`), backward and the
  optimizer update; the loss stays on the device."""

  def step(batch):
    model.train()
    optimizer.zero_grad(set_to_none=True)
    emb = model(batch.x, batch.edge_index, batch.edge_mask)
    loss = link_loss_from_metadata(emb, batch.metadata)
    loss.backward()
    optimizer.step()
    return loss.detach()

  return step
