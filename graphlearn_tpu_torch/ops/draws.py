"""Draws for the samplers: counter-based draws for per-seed sampling
trees (`hash_draws`, serving), for the single-card fused epochs
(`CounterDraws`, whose coordinates may live on the card, so a captured
CUDA graph draws anew on every replay) and the default provider of the
per-batch samplers and the eager fused mesh epochs (`TorchDraws`).
Beside the uniform and Gumbel streams of the one-hop sampler, the two
providers draw the negative samplers' candidates: ``[trials, R]`` int32
ids uniform in ``[0, high)`` (`ops.negative.sample_negative`), and one
int32 id a row below that row's own bound (`row_ints`, the random
walks' next-hop draw; `WalkDraws` gives a walk its streams).

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

from typing import Sequence, Tuple

import torch

_M32 = 0xFFFFFFFF
# odd multipliers below 2**31, so a 32-bit value times one fits int64
_C1 = 0x7FEB352D
_C2 = 0x68E31DA5
_STREAM_U = 0x5555
_STREAM_GUMBEL = 0xAAAA
_STREAM_V = 0x3333
_STREAM_INT = 0x6666
_STREAM_ROW_INT = 0x9999


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
  u = _stream(row, _STREAM_U, k)
  gumbel = -torch.log(-torch.log(_stream(row, _STREAM_GUMBEL, w)))
  return u, gumbel


def _hashes(row: torch.Tensor, tag: int, width: int) -> torch.Tensor:
  """``[R]`` row hashes -> ``[R, width]`` uint32 hashes of stream
  ``tag`` (int64)."""
  lane = torch.arange(width, dtype=torch.int64, device=row.device)
  return _mix(_mix(row ^ tag)[:, None] ^ lane[None, :])


def _stream(row: torch.Tensor, tag: int, width: int) -> torch.Tensor:
  """``[R]`` row hashes -> ``[R, width]`` uniforms of stream ``tag``."""
  return _uniform(_hashes(row, tag, width))


class CounterDraws:
  """The single-card fused epochs' default draws: a hash of ``(seed, coordinates,
  row, lane, stream)``, like `hash_draws`, in pure tensor arithmetic.

  A coordinate is a Python int or a 0-d int64 tensor on ``device``;
  either form gives the same values, so a step captured in a CUDA
  graph with its coordinates in a device buffer draws on every replay
  what the eager step draws from the same numbers.  Each coordinate enters the key through its low 32
  bits.  The Gumbels are ``-log(-log(u))`` taken in float64 and rounded
  to float32, so the CPU and the card give the same float32 values
  (their float32 ``log`` may differ in the last bit).

  ``draws(epoch, chunk, step, hop, rows, k, w, etype=None)`` (the
  fused epochs' form, ``chunk`` None read as 0) returns ``u [rows, k]``
  and ``gumbel [rows, w]``; ``etype``, the index of a heterogeneous
  hop's edge type among the sorted edge types, is a fifth coordinate
  (without it the key is the four-coordinate one).  `draw` takes any
  coordinates and, with ``gns``, returns a second ``[rows, k]`` uniform
  stream ``v`` in place of the Gumbels.  `ints` draws negative
  candidates at any coordinates, `negatives` at the fused link epoch's
  ``(epoch, chunk, step, stream)``.
  """

  def __init__(self, seed: int, device):
    self.seed = int(seed) & _M32
    self.device = torch.device(device)

  def key(self, coords) -> torch.Tensor:
    """The 0-d int64 key of ``coords`` on ``device``."""
    key = _mix(torch.full((), self.seed, dtype=torch.int64,
                          device=self.device))
    for c in coords:
      c = (c.to(torch.int64) if isinstance(c, torch.Tensor)
           else int(c)) & _M32
      key = _mix(key ^ c)
    return key

  def draw(self, coords, rows: int, k: int, w: int, gns: bool = False
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    p = torch.arange(rows, dtype=torch.int64, device=self.device)
    row = _mix(self.key(coords) ^ p)
    u = _stream(row, _STREAM_U, k)
    if gns:
      return u, _stream(row, _STREAM_V, k)
    g = _stream(row, _STREAM_GUMBEL, w).double()
    return u, (-torch.log(-torch.log(g))).float()

  def __call__(self, epoch, chunk, step, hop, rows, k, w, etype=None):
    coords = (epoch, 0 if chunk is None else chunk, step, hop)
    if etype is not None:
      coords += (etype,)
    return self.draw(coords, rows, k, w)

  def ints(self, coords, trials: int, r: int, high: int) -> torch.Tensor:
    """``[trials, r]`` int32 ids in ``[0, high)``: each a 32-bit hash
    ``h`` of (key, trial, slot) mapped by ``(h * high) >> 32``; a wider
    ``r`` extends a narrower one."""
    t = torch.arange(trials, dtype=torch.int64, device=self.device)
    h = _hashes(_mix(self.key(coords) ^ t), _STREAM_INT, r)
    return ((h * int(high)) >> 32).to(torch.int32)

  def negatives(self, epoch, chunk, step, stream, trials, r, high):
    """The fused link epoch's form: `ints` at ``(epoch, chunk, step,
    stream)``, ``chunk`` None read as 0."""
    return self.ints((epoch, 0 if chunk is None else chunk, step, stream),
                     trials, r, high)

  def row_ints(self, coords, high: torch.Tensor) -> torch.Tensor:
    """``[R]`` int32 ids, row ``p`` in ``[0, high[p])`` (``high`` a
    ``[R]`` tensor of bounds in ``[1, 2**31]``): a 32-bit hash ``h`` of
    (key, row) mapped by ``(h * high) >> 32``."""
    p = torch.arange(high.shape[0], dtype=torch.int64, device=self.device)
    h = _mix(_mix(self.key(coords) ^ p) ^ _STREAM_ROW_INT)
    return ((h * high.to(self.device, torch.int64)) >> 32).to(torch.int32)


class TorchDraws:
  """The training samplers' default draws provider: a `torch.Generator`
  on ``device`` seeded from ``seed`` and the draw's coordinates.
  Gumbels are ``-log(-log(u))`` of uniforms kept above the smallest
  normal float.

  ``draws(step, hop, rows, k, w, gns=False, owner=0, etype=None)`` (the
  samplers' form) returns ``u [rows, k]`` and ``gumbel [rows, w]``, or
  with ``gns`` a second ``[rows, k]`` uniform stream ``v``; ``owner`` is
  the mesh partition that samples the rows and ``etype`` the index of a
  heterogeneous hop's edge type (the coordinates are ``(step, hop)`` for
  owner 0 without an edge type, so a one-partition mesh and the
  single-card sampler draw as before, ``(step, hop, owner)`` for
  another owner, and ``(step, hop, owner, etype)`` with an edge type);
  `draw` takes any tuple of coordinates.  ``negatives(step, stream,
  trials, r, high)`` (the negative samplers' form) returns ``[trials,
  r]`` int32 candidates in ``[0, high)`` at ``(step, -1 - stream)``,
  coordinates no hop draws at; the mesh's negatives pass the partition
  that draws them, ``part=p``, as a third coordinate ``(step, -1 -
  stream, p)``.
  """

  def __init__(self, seed: int, device):
    self.seed = int(seed)
    self.device = torch.device(device)

  def _from(self, mixed: int, rows: int, k: int, w: int, gns: bool):
    gen = torch.Generator(device=self.device)
    gen.manual_seed(mixed & ((1 << 63) - 1))
    u = torch.rand((rows, k), generator=gen, device=self.device)
    if gns:
      return u, torch.rand((rows, k), generator=gen, device=self.device)
    g = torch.rand((rows, w), generator=gen, device=self.device)
    g.clamp_(min=torch.finfo(torch.float32).tiny)
    return u, -torch.log(-torch.log(g))

  def _mixed(self, coords: Sequence[int]) -> int:
    mixed = self.seed
    for c in coords:
      mixed = mixed * 1_000_003 + int(c)
    return mixed

  def draw(self, coords: Sequence[int], rows: int, k: int, w: int,
           gns: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(u, gumbel)`` (with ``gns``, ``(u, v)``) at non-negative
    integer ``coords``, each below 1,000,003 (distinct coordinates,
    distinct generator seeds)."""
    return self._from(self._mixed(coords), rows, k, w, gns)

  def __call__(self, step, hop, rows, k, w, gns=False, owner=0,
               etype=None):
    """The samplers' form: the draws at coordinates ``(step, hop)``,
    ``(step, hop, owner)`` for an owner other than 0, or ``(step, hop,
    owner, etype)`` for a heterogeneous hop."""
    coords = (step, hop)
    if int(owner) != 0 or etype is not None:
      coords += (owner,)
    if etype is not None:
      coords += (etype,)
    return self._from(self._mixed(coords), rows, k, w, gns)

  def negatives(self, step, stream, trials, r, high,
                part=None) -> torch.Tensor:
    coords = (step, -1 - int(stream))
    if part is not None:
      coords += (int(part),)
    return self.int_draw(coords, trials, r, high)

  def int_draw(self, coords: Sequence[int], trials: int, r: int,
               high) -> torch.Tensor:
    """``[trials, r]`` int32 in ``[0, high)`` at integer ``coords``
    (`negatives` at its coordinates)."""
    gen = torch.Generator(device=self.device)
    gen.manual_seed(self._mixed(coords) & ((1 << 63) - 1))
    return torch.randint(0, int(high), (trials, r), generator=gen,
                         device=self.device, dtype=torch.int32)

  def row_ints(self, coords: Sequence[int],
               high: torch.Tensor) -> torch.Tensor:
    """``[R]`` int32 ids, row ``p`` in ``[0, high[p])`` (bounds in
    ``[1, 2**31]``): 32 random bits ``h`` a row, mapped by ``(h * high)
    >> 32``, from a generator seeded at ``(*coords, -1)``, coordinates
    no other draw uses."""
    gen = torch.Generator(device=self.device)
    gen.manual_seed(self._mixed(tuple(coords) + (-1,)) & ((1 << 63) - 1))
    h = torch.randint(0, 1 << 32, (high.shape[0],), generator=gen,
                      device=self.device, dtype=torch.int64)
    return ((h * high.to(self.device, torch.int64)) >> 32).to(torch.int32)


class WalkDraws:
  """The random walks' draws at walk step ``t`` (`ops.random_walk`),
  from a `CounterDraws` or `TorchDraws`: ``ints(t, high)``, the ``[B]``
  next-hop offsets (row ``p`` in ``[0, high[p])``, at coordinates ``(t,
  0)``); ``uniform(t, b)``, the ``[B]`` f32 restart draws (``(t, 1)``);
  ``gumbel(t, b, w)``, node2vec's ``[B, w]`` Gumbel noise (``(t,
  2)``)."""

  def __init__(self, base):
    self.base = base

  def ints(self, step, high: torch.Tensor) -> torch.Tensor:
    return self.base.row_ints((step, 0), high)

  def uniform(self, step, b: int) -> torch.Tensor:
    return self.base.draw((step, 1), b, 1, 1)[0][:, 0]

  def gumbel(self, step, b: int, w: int) -> torch.Tensor:
    return self.base.draw((step, 2), b, 1, w)[1]
