"""Cache-aware Global Neighbor Sampling (GNS): the host side, the
membership bitmask and the plain PyTorch version of the biased sampler.

The JAX package's `ops/gns.py`, with the same knobs (``GLT_GNS``,
``GLT_GNS_BOOST``, ``GLT_GNS_DECAY``, ``GLT_GNS_SKETCH``).  Neighbor
selection is biased toward the device-servable set (the static hot
split plus the cold-cache residents), and every sampled edge carries
the ``p/q`` importance weight that keeps the weighted neighbor mean
unbiased.  Per seed row with degree ``d`` (window ``w``, fanout ``k``):

  * ``d <= k``      — take all neighbors, weight 1;
  * ``k < d <= w``  — ``k`` independent draws from ``q(v) ∝ 1 +
    boost·cached(v)`` over the window by inverse CDF: ``off_j =
    min(#{cum <= v_j·max(total, 1e-9)}, d-1)``, weight ``(total/d) /
    w(off_j)``;
  * ``d > w``       — uniform with replacement, ``min(trunc(u·d), d-1)``,
    weight 1.

The random numbers are inputs (``u [B, k]`` for the hub arm, ``v [B,
k]`` for the biased arm); given the uniforms JAX draws from its key the
outputs are byte-equal.  `ops.fused_sample.sample_one_hop_gns_fused` is
the CUDA kernel of the same function (`csrc/sample_one_hop_gns.cu`).

The bitmask (bit ``i`` of byte ``j`` is node ``8j + i``, little bit
order) comes in three forms, as in JAX: a 1-D shared mask, a 2-D
``[R, nbytes]`` stack of per-requester masks, or the deduplicated
``(table [T, nbytes], row_index [R])`` pair; the per-requester forms
need ``req``, each row's requester index.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.padding import INVALID_ID
from .neighbor import OneHopResult, _seed_rows, default_window

GNS_ENV = 'GLT_GNS'
BOOST_ENV = 'GLT_GNS_BOOST'
DECAY_ENV = 'GLT_GNS_DECAY'
SKETCH_ENV = 'GLT_GNS_SKETCH'

#: a cached neighbor is ``1 + boost`` times as likely per draw
DEFAULT_BOOST = 16.0
#: sketch decay per update (~20-batch half-life at one update a batch)
DEFAULT_DECAY = 0.95
#: hashed sketch slots (float32 scores)
DEFAULT_SKETCH_SLOTS = 1 << 16


def gns_enabled(spec=None) -> bool:
  """An explicit argument wins, else ``GLT_GNS`` ('1'/'true' = on)."""
  if spec is not None:
    return bool(spec)
  return os.environ.get(GNS_ENV, '0').lower() in ('1', 'true')


def _env_float(env: str, default: float) -> float:
  try:
    return float(os.environ.get(env, default))
  except ValueError:
    return default


def resolve_boost(spec=None) -> float:
  if spec is not None:
    return float(spec)
  return _env_float(BOOST_ENV, DEFAULT_BOOST)


def resolve_decay(spec=None) -> float:
  if spec is not None:
    return float(spec)
  return min(max(_env_float(DECAY_ENV, DEFAULT_DECAY), 0.0), 1.0)


def resolve_sketch_slots(spec=None) -> int:
  if spec is not None:
    return max(int(spec), 1)
  try:
    return max(int(os.environ.get(SKETCH_ENV, DEFAULT_SKETCH_SLOTS)), 1)
  except ValueError:
    return DEFAULT_SKETCH_SLOTS


#: Fibonacci-hash multiplier (2^64 / phi)
_HASH_MULT = np.uint64(0x9E3779B97F4A7C15)


class DecayedSketch:
  """Hashed, exponentially decayed visit-frequency sketch (host numpy,
  fixed size): ``scores[hash(id) % slots]`` approximates an id's
  decayed visit count.  The cold cache ranks admissions by it."""

  def __init__(self, slots: Optional[int] = None,
               decay: Optional[float] = None):
    self.slots = resolve_sketch_slots(slots)
    self.decay = resolve_decay(decay)
    self.scores = np.zeros(self.slots, np.float32)

  def _slot(self, ids: np.ndarray) -> np.ndarray:
    mixed = ids.astype(np.uint64) * _HASH_MULT        # wraps mod 2^64
    return (mixed % np.uint64(self.slots)).astype(np.int64)

  def update(self, ids, counts=None) -> int:
    """Decay every score, then add this batch's visit counts.  Returns
    the number of valid ids folded in."""
    ids = np.asarray(ids, np.int64).reshape(-1)
    sel = ids >= 0
    ids = ids[sel]
    self.scores *= self.decay
    if len(ids) == 0:
      return 0
    if counts is None:
      add = np.ones(len(ids), np.float32)
    else:
      add = np.asarray(counts, np.float32).reshape(-1)[sel]
    np.add.at(self.scores, self._slot(ids), add)
    return len(ids)

  def score(self, ids) -> np.ndarray:
    ids = np.asarray(ids, np.int64).reshape(-1)
    out = self.scores[self._slot(np.clip(ids, 0, None))]
    return np.where(ids >= 0, out, 0.0).astype(np.float32)

  def state_dict(self) -> dict:
    return {'scores': self.scores.copy(), 'decay': np.float32(self.decay)}

  def load_state_dict(self, state: dict) -> None:
    scores = np.asarray(state['scores'], np.float32)
    if scores.shape[0] != self.slots:
      raise ValueError(
          f'visit-sketch snapshot has {scores.shape[0]} slots, this '
          f'sketch holds {self.slots}; resume with the same '
          f'{SKETCH_ENV} the snapshot was taken under')
    self.scores = scores.copy()
    self.decay = float(np.asarray(state['decay']))


def cached_set_bits(num_nodes: int, bounds, hot_counts,
                    resident_ids) -> np.ndarray:
  """``uint8 [ceil(N/8)]`` membership of the static hot split (rows
  ``[bounds[p], bounds[p] + hot_counts[p])``) plus the residents."""
  mask = np.zeros(int(num_nodes), bool)
  bounds = np.asarray(bounds, np.int64)
  hot_counts = np.asarray(hot_counts, np.int64)
  for p in range(len(hot_counts)):
    lo = int(bounds[p])
    mask[lo:lo + int(hot_counts[p])] = True
  res = np.asarray(resident_ids, np.int64).reshape(-1)
  res = res[(res >= 0) & (res < num_nodes)]
  mask[res] = True
  return np.packbits(mask, bitorder='little')


def set_resident_bits(base_bits: np.ndarray, resident_ids,
                      num_nodes: int) -> np.ndarray:
  """OR resident membership into a copy of a packed mask."""
  bits = base_bits.copy()
  res = np.asarray(resident_ids, np.int64).reshape(-1)
  res = res[(res >= 0) & (res < num_nodes)]
  np.bitwise_or.at(bits, res >> 3,
                   (np.uint8(1) << (res & 7).astype(np.uint8)))
  return bits


def dedup_requester_bits(num_nodes: int, bounds, hot_counts,
                         residents_by_device,
                         base_bits: Optional[np.ndarray] = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
  """``(table [T, ceil(N/8)], row_index [P + 1])``: row 0 is the hot
  split alone; each device with residents gets its own row; devices
  without residents and the last (fallback) requester point at row 0."""
  base = (base_bits if base_bits is not None
          else cached_set_bits(num_nodes, bounds, hot_counts,
                               np.empty(0, np.int64)))
  rows = [base]
  row_index = np.zeros(len(hot_counts) + 1, np.int32)
  for d in range(len(hot_counts)):
    res = residents_by_device.get(d)
    if res is None or len(res) == 0:
      continue
    row_index[d] = len(rows)
    rows.append(set_resident_bits(base, res, num_nodes))
  return np.stack(rows), row_index


def is_per_requester(bits) -> bool:
  """True for the forms that need ``req`` (the dedup pair, a 2-D
  stack)."""
  if isinstance(bits, tuple):
    return True
  return bits.ndim == 2


def bits_table(bits) -> torch.Tensor:
  """The ``[T, nbytes]`` byte table behind any bitmask form."""
  if isinstance(bits, tuple):
    return bits[0]
  if bits.ndim == 2:
    return bits
  return bits.reshape(1, -1)


def bits_rows(bits, req: Optional[torch.Tensor], b: int,
              device) -> torch.Tensor:
  """``[B]`` int32 row of `bits_table` each seed row reads."""
  if not is_per_requester(bits):
    return torch.zeros(b, dtype=torch.int32, device=device)
  if req is None:
    raise ValueError('per-requester bitmask needs req')
  if isinstance(bits, tuple):
    row_index = bits[1]
    row = req.long().clamp(0, row_index.shape[0] - 1)
    return row_index[row].to(torch.int32)
  return req.clamp(0, bits.shape[0] - 1).to(torch.int32)


def bitmask_lookup(bits, ids: torch.Tensor,
                   req: Optional[torch.Tensor] = None) -> torch.Tensor:
  """``[...]`` ids -> uint8 membership (0/1); ids < 0 read 0.  For the
  per-requester forms ``req [B]`` selects the mask per leading entry."""
  valid = ids >= 0
  idc = torch.where(valid, ids, 0).long()
  if is_per_requester(bits):
    table = bits_table(bits)
    row = bits_rows(bits, req, req.shape[0] if req is not None else 0,
                    ids.device).long()
    row = row.reshape(row.shape + (1,) * (ids.ndim - row.ndim))
    byte = table[row, (idc >> 3).clamp(0, table.shape[1] - 1)]
  else:
    byte = bits[(idc >> 3).clamp(0, bits.shape[0] - 1)]
  bit = (byte >> (idc & 7).to(torch.uint8)) & 1
  return torch.where(valid, bit, torch.zeros_like(bit)).to(torch.uint8)


def sample_one_hop_gns(indptr: torch.Tensor, indices: torch.Tensor,
                       seeds: torch.Tensor, k: int, u: torch.Tensor,
                       v: torch.Tensor, bits, boost: float,
                       req: Optional[torch.Tensor] = None,
                       window: Optional[int] = None) -> OneHopResult:
  """Biased one-hop sampling with importance weights, the plain version
  (the JAX `sample_one_hop_gns` with ``sort_locality=False`` and its
  draws injected).

  Args:
    indptr: ``[N+1]`` int64; indices: ``[E]`` int32; seeds: ``[B]``
      (-1 = empty row).
    u: ``[B, k]`` f32 uniforms of the ``d > w`` arm.
    v: ``[B, k]`` f32 uniforms of the biased arm.
    bits: membership bitmask in any of the three forms (module
      docstring); req: ``[B]`` requester index per row for the
      per-requester forms.
    boost: a cached neighbor draws with weight ``1 + boost``.
    window: ``w`` (default `default_window(k)`).
  Returns ``OneHopResult`` with ``weights [B, k]`` f32 (0 where masked).
  """
  sample_one_hop_gns.calls += 1
  e = indices.numel()
  dev = seeds.device
  w = int(window) if window is not None else default_window(k)
  start, deg = _seed_rows(indptr, seeds)
  slot = torch.arange(k, dtype=torch.int32, device=dev)
  mask = slot[None, :] < torch.clamp(deg, max=k)[:, None]
  dmax = torch.clamp(deg - 1, min=0)[:, None]
  rand_off = torch.minimum((u * deg[:, None].float()).to(torch.int32), dmax)
  wslot = torch.arange(w, dtype=torch.int32, device=dev)
  in_deg = wslot[None, :] < deg[:, None]
  last = max(e - 1, 0)
  win_pos = torch.clamp(start[:, None] + wslot[None, :], 0, last)
  if e == 0:
    win_ids = torch.full(in_deg.shape, INVALID_ID, dtype=torch.int32,
                         device=dev)
  else:
    win_ids = indices[win_pos].to(torch.int32)
  cached = bitmask_lookup(bits, torch.where(in_deg, win_ids, INVALID_ID),
                          req=req)
  wgt = torch.where(in_deg, 1.0 + torch.tensor(
      boost, dtype=torch.float32) * cached.float(), 0.0)
  cum = torch.cumsum(wgt, dim=1)
  total = cum[:, -1]
  draws = v * torch.clamp(total, min=1e-9)[:, None]
  off_b = torch.searchsorted(cum, draws.contiguous(), right=True)
  off_b = torch.minimum(off_b.to(torch.int32), dmax)
  w_drawn = torch.gather(wgt, 1, off_b.long())
  iw = (total[:, None] / torch.clamp(deg, min=1)[:, None].float()) \
      / torch.clamp(w_drawn, min=1e-9)
  medium = ((deg > k) & (deg <= w))[:, None]
  off = torch.where((deg <= k)[:, None], slot[None, :],
                    torch.where(medium, off_b, rand_off))
  weights = torch.where(mask, torch.where(medium, iw, 1.0), 0.0)
  if e == 0:
    nbrs = torch.full(mask.shape, INVALID_ID, dtype=torch.int32, device=dev)
  else:
    pos = torch.clamp(start[:, None] + off, 0, last)
    nbrs = torch.where(mask, indices[pos].to(torch.int32), INVALID_ID)
  return OneHopResult(nbrs=nbrs, mask=mask,
                      weights=weights.to(torch.float32))


#: calls of the plain version (a training run on the card expects 0)
sample_one_hop_gns.calls = 0
