"""Counter-based draws for per-seed sampling trees.

The JAX serving engine keys each seed's tree with threefry
(``fold_in(key(engine_seed), node)``, then ``fold_in(·, hop)`` and
``split`` into the uniform and Gumbel streams).  Torch cannot reproduce
threefry, so the port derives every draw from a hash of its coordinates
instead::

  (engine seed, seed node id, hop t, row p within the seed's level-t
   block, lane j, stream)  ->  32-bit h
  u = ((h >> 8) + 0.5) * 2**-24        gumbel = -log(-log(u'))

A seed's draws — and so its sampled tree — depend only on the engine
seed and the node id: never on the bucket, the slot or co-batched
requests, which is the coalescing contract of the serving engine.  The
hash runs as 32-bit mixing rounds in int64 torch ops (masked to 32
bits, every product below 2**63) on the engine's device, outside the
sampling kernel, as the JAX package draws outside its Pallas kernel.
"""
from __future__ import annotations

from typing import Tuple

import torch

_M32 = 0xFFFFFFFF
# odd multipliers below 2**31, so a 32-bit value times one fits int64
_C1 = 0x7FEB352D
_C2 = 0x68E31DA5
_STREAM_U = 0x5555
_STREAM_GUMBEL = 0xAAAA


def _mix(x: torch.Tensor) -> torch.Tensor:
  """A 32-bit avalanche round on int64 tensors holding uint32 values."""
  x = x ^ (x >> 16)
  x = (x * _C1) & _M32
  x = x ^ (x >> 15)
  x = (x * _C2) & _M32
  return x ^ (x >> 16)


def _uniform(h: torch.Tensor) -> torch.Tensor:
  """uint32 hashes -> f32 uniforms in (0, 1), exactly representable."""
  return ((h >> 8).to(torch.float32) + 0.5) * (2.0 ** -24)


def hash_draws(engine_seed: int, seed_ids: torch.Tensor, hop: int,
               rows_per_seed: int, k: int, w: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Draws for hop ``hop`` of a batch of per-seed trees.

  Args:
    engine_seed: the serve key.
    seed_ids: ``[cap]`` seed node ids (``-1`` = padding; hashed as 0).
    hop: hop index ``t``.
    rows_per_seed: frontier rows per seed at this hop (``k_1 ... k_t``).
    k / w: fanout and window.
  Returns:
    ``u [cap * rows_per_seed, k]`` and ``gumbel [cap * rows_per_seed,
    w]``, f32 on ``seed_ids``' device, seed-major then row-major — the
    frontier order of `loader.fused_tree.expand_tree_levels`.
  """
  dev = seed_ids.device
  node = torch.where(seed_ids >= 0, seed_ids.long(), 0) & _M32
  key = _mix(_mix(torch.full_like(node, int(engine_seed) & _M32)) ^ node)
  key = _mix(key ^ int(hop))
  p = torch.arange(rows_per_seed, dtype=torch.int64, device=dev)
  row = _mix(key[:, None] ^ p[None, :]).reshape(-1)

  def stream(tag: int, width: int) -> torch.Tensor:
    lane = torch.arange(width, dtype=torch.int64, device=dev)
    return _uniform(_mix(_mix(row ^ tag)[:, None] ^ lane[None, :]))

  u = stream(_STREAM_U, k)
  gumbel = -torch.log(-torch.log(stream(_STREAM_GUMBEL, w)))
  return u, gumbel
