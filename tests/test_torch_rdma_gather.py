"""The port's remote-push row gather (`parallel.rdma_gather`) against the
JAX package's `rdma_gather` on the 8-device virtual CPU mesh (its Pallas
kernel in interpret mode, run as `tests/test_rdma_gather.py` runs it),
and against the port's own `dist_gather_multi` at the same capacity.

Tolerance: byte-equal everywhere (rows are copied, never computed).
"""
import jax
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from graphlearn_tpu.parallel import make_mesh as jax_make_mesh
from graphlearn_tpu.parallel.rdma_gather import rdma_gather as jax_rdma
from graphlearn_tpu.parallel.shard_map_compat import shard_map
from graphlearn_tpu_torch.parallel import (dist_gather_multi, make_mesh,
                                           push_rows, push_rows_plain,
                                           rdma_gather)

NP = 8
ROWS = 16          # per shard


def _jax_run(shards, bounds, ids, capacity):
  mesh = jax_make_mesh(NP)
  sh = NamedSharding(mesh, P('data'))
  rp = NamedSharding(mesh, P())

  def per_dev(shard_s, bounds_r, ids_s):
    return jax_rdma(shard_s[0], bounds_r, ids_s[0], 'data', NP,
                    exchange_capacity=capacity)[None]

  f = shard_map(per_dev, mesh=mesh, in_specs=(P('data'), P(), P('data')),
                out_specs=P('data'))
  return np.asarray(jax.jit(f)(
      jax.device_put(shards, sh), jax.device_put(bounds, rp),
      jax.device_put(ids, sh)))


def _shards(kind):
  """``[NP, ROWS, D]`` tables whose rows carry their global id (never
  zero, so a zero row reads as masked)."""
  gid = np.arange(NP * ROWS).reshape(NP, ROWS, 1) + 1
  if kind == 'int32':                 # a label column
    return (gid * 7 + 1).astype(np.int32)
  d = 5 if kind == 'bf16' else 8
  vals = (gid + np.arange(d) / 8.0).astype(np.float32)
  return vals.astype(ml_dtypes.bfloat16) if kind == 'bf16' else vals


def _to_torch(a):
  if a.dtype == ml_dtypes.bfloat16:
    return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
  return torch.from_numpy(a)


def _bytes(x):
  if isinstance(x, torch.Tensor):
    x = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
  return np.ascontiguousarray(x).view(np.uint8)


def _ids(case):
  rng = np.random.default_rng(0)
  if case == 'drops':
    # every id owned by partition 0: capacity 8 drops the tail
    return np.tile(np.arange(12, dtype=np.int32), (NP, 1))
  ids = rng.integers(0, NP * ROWS, (NP, 16)).astype(np.int32)
  ids[0, 3] = ids[5, 0] = ids[7, 15] = -1
  return ids


@pytest.mark.parametrize('case,kind,capacity', [
    ('invalid', 'f32', None), ('drops', 'f32', 8), ('invalid', 'bf16', 8),
    ('invalid', 'int32', 8)])
def test_rdma_gather_byte_equal_to_jax(case, kind, capacity):
  shards = _shards(kind)
  bounds = np.arange(NP + 1, dtype=np.int64) * ROWS
  ids = _ids(case)
  ref = _jax_run(shards, bounds, ids, capacity)
  mesh = make_mesh(NP, device='cpu')
  t_shards, t_ids = _to_torch(shards), torch.from_numpy(ids)
  launches, calls = push_rows.launches, push_rows_plain.calls
  got = rdma_gather(mesh, t_shards, bounds, t_ids, capacity=capacity)
  assert push_rows.launches == launches            # the CPU runs the plain
  assert push_rows_plain.calls == calls + 1
  assert got.dtype == t_shards.dtype and got.shape == ref.shape
  np.testing.assert_array_equal(_bytes(got), _bytes(ref))
  (alt,), stats = dist_gather_multi(mesh, (t_shards,), bounds, t_ids,
                                    capacity=capacity)
  np.testing.assert_array_equal(_bytes(got), _bytes(alt))
  # first principles: an invalid id or a dropped one reads zero, a kept
  # one its own row
  first = got.float()[..., 0].numpy()
  want = shards.astype(np.float32)[..., 0].reshape(-1)
  kept = first != 0
  np.testing.assert_array_equal(first[kept], want[ids[kept]])
  assert not kept[ids < 0].any()
  if case == 'drops':
    assert (kept.sum(1) == 8).all() and int(stats[1]) == NP * 4
  else:
    assert kept.sum() == (ids >= 0).sum() and int(stats[1]) == 0


def test_one_column_table_reads_as_a_column():
  mesh = make_mesh(NP, device='cpu')
  labels = torch.from_numpy(_shards('int32')[..., 0])       # [P, R]
  ids = torch.from_numpy(_ids('invalid'))
  got = rdma_gather(mesh, labels, np.arange(NP + 1) * ROWS, ids)
  assert got.shape == ids.shape
  np.testing.assert_array_equal(
      got.numpy(), np.where(ids.numpy() >= 0,
                            labels.reshape(-1)[ids.long().clamp(min=0)],
                            0))


def test_push_rows_plain_matches_a_loop():
  """Every slot holds its owner's row at the clamped local index —
  invalid and foreign ids included (the stitch masks those)."""
  rng = np.random.default_rng(3)
  p, r, d, c = 3, 5, 4, 6
  shards = rng.standard_normal((p, r, d)).astype(np.float32)
  starts = np.array([0, 5, 10], np.int64)
  recv = rng.integers(-1, 18, (p, p, c)).astype(np.int32)
  got = push_rows(torch.from_numpy(recv), torch.from_numpy(starts),
                  torch.from_numpy(shards)).numpy()
  assert got.shape == (p, p, c, d)
  for o in range(p):
    for q in range(p):
      for j in range(c):
        local = min(max(int(recv[o, q, j]) - int(starts[o]), 0), r - 1)
        np.testing.assert_array_equal(got[q, o, j], shards[o, local])


def test_push_rows_rejects_what_it_cannot_take():
  shards = torch.zeros((2, 3, 4))
  starts = torch.zeros(2, dtype=torch.int64)
  ids = torch.zeros((2, 2, 5), dtype=torch.int32)
  with pytest.raises(ValueError, match='recv_ids'):
    push_rows(ids.long(), starts, shards)
  with pytest.raises(ValueError, match='recv_ids'):
    push_rows(ids[:1], starts, shards)
  with pytest.raises(ValueError, match='starts'):
    push_rows(ids, starts.int(), shards)
  with pytest.raises(ValueError, match='shards'):
    push_rows(ids, starts, shards[:, :0])
