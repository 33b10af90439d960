"""K6, the cold-row fill, on the CPU: the wrapper (which runs the plain
version for CPU tensors) against the JAX package's gather
(`PinnedColdBuffer.gather`'s jitted ``jnp.take`` with its int32 ids,
scattered to the miss positions as the JAX mixed path expands them) at
every row layout the card's forced sets take; the wrapper's id checks;
the fill's independence of the order of the (pos, rel) pairs; and the
tiered store's reusable staging buffer for the ids.  Tolerance: none,
the outputs are compared byte for byte.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphlearn_tpu_torch.data import Feature
from graphlearn_tpu_torch.ops import cold_gather, cold_gather_plain
from graphlearn_tpu_torch.ops.cold_gather import PLAN_MIN_ROWS, cold_plan

#: (columns, dtype): rows of 4, 12, 200 (bf16), 400, 512 and 1,024 bytes
LAYOUTS = ((1, 'float32'), (3, 'float32'), (100, 'bfloat16'),
           (100, 'float32'), (128, 'float32'), (256, 'float32'))
NC, B = 61, 40


def _case(cols, dt, seed=0, m=17):
  """A cold block, an output that starts from other rows, and ``m``
  misses: distinct positions, rows with both ends of the block and an
  adjacent run."""
  rng = np.random.default_rng(seed)
  cold = rng.standard_normal((NC, cols)).astype(np.float32)
  init = rng.standard_normal((B, cols)).astype(np.float32)
  pos = rng.choice(B, m, replace=False).astype(np.int32)
  rel = rng.integers(0, NC, m).astype(np.int32)
  rel[:5] = [0, NC - 1, 7, 8, 9]
  tdt = getattr(torch, dt)
  return (torch.from_numpy(cold).to(tdt), torch.from_numpy(init).to(tdt),
          pos, rel)


def _bytes(x) -> bytes:
  if isinstance(x, torch.Tensor):
    return x.view(torch.uint8).numpy().tobytes()
  x = np.asarray(x)
  return x.view(np.uint8).tobytes()


def _jax_fill(cold, init, pos, rel):
  """The JAX package's fill: its jitted take over the block with int32
  ids, scattered into the batch at the miss positions."""
  jdt = jnp.bfloat16 if cold.dtype == torch.bfloat16 else jnp.float32
  rows = jnp.asarray(cold.float().numpy()).astype(jdt)
  take = jax.jit(lambda r, i: jnp.take(r, i, axis=0))
  got = take(rows, jnp.asarray(np.ascontiguousarray(rel, np.int32)))
  out = jnp.asarray(init.float().numpy()).astype(jdt)
  return out.at[jnp.asarray(pos)].set(got)


@pytest.mark.parametrize('cols,dt', LAYOUTS)
def test_fill_byte_equal_to_jax(cols, dt):
  cold, init, pos, rel = _case(cols, dt)
  out = init.clone()
  assert cold_gather(out, cold, torch.from_numpy(pos),
                     torch.from_numpy(rel)) is out
  assert _bytes(out) == _bytes(_jax_fill(cold, init, pos, rel))


@pytest.mark.parametrize('pt,rt', [(torch.int64, torch.int64),
                                   (torch.int64, torch.int32),
                                   (torch.int32, torch.int64),
                                   (torch.int16, torch.int16)])
def test_ids_must_be_int32(pt, rt):
  """int32 ids, as the JAX gather's; any other type, or a pair whose
  types differ, raises before anything is filled."""
  cold, init, pos, rel = _case(3, 'float32')
  out = init.clone()
  with pytest.raises(ValueError, match='int32'):
    cold_gather(out, cold, torch.from_numpy(pos).to(pt),
                torch.from_numpy(rel).to(rt))
  assert torch.equal(out, init)
  cold_gather(out, cold, torch.from_numpy(pos), torch.from_numpy(rel))
  assert not torch.equal(out, init)


@pytest.mark.parametrize('seed', [1, 2, 3])
def test_fill_independent_of_pair_order(seed):
  """Positions are distinct, so serving the misses in any order (the
  batch's, or sorted by block row) gives the same output."""
  cold, init, pos, rel = _case(100, 'float32', seed=seed, m=B)
  perm = np.random.default_rng(seed).permutation(B)
  by_rel = np.argsort(rel, kind='stable')
  outs = []
  for order in (np.arange(B), perm, by_rel):
    out = init.clone()
    cold_gather_plain(out, cold, torch.from_numpy(pos[order]),
                      torch.from_numpy(rel[order]))
    outs.append(_bytes(out))
  assert outs[0] == outs[1] == outs[2]


@pytest.mark.parametrize('seed', [4, 5])
def test_plan_step_gives_the_same_fill(seed):
  """The plan step (the pairs in block order, run here on the CPU as
  the card runs it before the kernel from `PLAN_MIN_ROWS` misses)
  keeps every (pos, rel) pair and leaves the fill unchanged."""
  cold, init, pos, rel = _case(128, 'float32', seed=seed, m=B)
  p, r = cold_plan(torch.from_numpy(pos), torch.from_numpy(rel))
  assert p.dtype == r.dtype == torch.int32
  assert (r[1:] >= r[:-1]).all()
  assert sorted(zip(p.tolist(), r.tolist())) == sorted(zip(pos, rel))
  planned, given = init.clone(), init.clone()
  cold_gather_plain(planned, cold, p, r)
  cold_gather_plain(given, cold, torch.from_numpy(pos),
                    torch.from_numpy(rel))
  assert _bytes(planned) == _bytes(given)
  assert PLAN_MIN_ROWS > 584          # a serving dispatch takes no plan


def test_empty_fill_leaves_out():
  cold, init, _, _ = _case(3, 'float32')
  out = init.clone()
  empty = torch.empty(0, dtype=torch.int32)
  assert cold_gather(out, cold, empty, empty) is out
  assert torch.equal(out, init)


def test_tiered_store_stages_ids_in_one_reused_buffer():
  """The tiered store writes each lookup's (pos, rel) as int32 into one
  staging buffer that grows by powers of two and is reused, and the
  rows it fills equal the table's."""
  feats = np.random.default_rng(4).standard_normal((64, 5)).astype(
      np.float32)
  f = Feature(feats, split_ratio=0.25, device='cpu')
  buffers = []
  for ids in (np.arange(16, 64), np.arange(20, 40), np.arange(0, 64)):
    got = f.get(ids)
    np.testing.assert_array_equal(got.numpy(), feats[ids])
    buf = f._staging._buf
    assert buf.dtype == torch.int32 and buf.shape[0] >= 2 * 48
    assert buf.shape[0] & (buf.shape[0] - 1) == 0
    buffers.append(buf.data_ptr())
  assert buffers[0] == buffers[1] == buffers[2]
