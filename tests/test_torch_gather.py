"""The port's row gather (remap + mask + clamp) against the JAX package.

The JAX side runs `data/feature.py::_device_gather(use_pallas=True)`,
whose `gather_rows` goes through the Pallas per-row DMA kernel in
interpret mode on the CPU (``GLT_PALLAS=1``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphlearn_tpu.data.feature import _device_gather as jax_device_gather
from graphlearn_tpu.ops.pallas_gather import gather_rows as jax_gather_rows
from graphlearn_tpu_torch import _build
from graphlearn_tpu_torch.ops import gather_rows, gather_rows_plain

N, D = 37, 5


def _table(seed=0, n=N, d=D):
  rng = np.random.default_rng(seed)
  t = rng.standard_normal((n, d)).astype(np.float32)
  t[3] = -0.0                       # signed zeros survive the copy
  return t


def _ids(seed=1):
  rng = np.random.default_rng(seed)
  ids = rng.integers(0, N, 24).astype(np.int32)
  # repeats, both boundaries, past the end (clamps), invalid
  ids[:7] = [5, 5, 0, N - 1, N + 4, -1, -7]
  return ids


def _id2index(seed=2, m=N - 6):
  rng = np.random.default_rng(seed)
  m_ = rng.permutation(N)[:m].astype(np.int32)
  m_[[1, 4, 9]] = -1                # unmapped entries
  return m_                         # shorter than the id range: clamps


#: row layouts the kernel's branches take on the card: one thread a row
#: (rows of at most 16 bytes), lane groups of 2-16 lanes, and the wide
#: rows of the feature tables (D = 100 f32 and bf16); int32 is the label
#: column
TABLES = [('float32', 1), ('float32', 2), ('float32', 3), ('float32', 4),
          ('float32', D), ('float32', 8), ('float32', 100), ('int32', 1),
          ('bfloat16', 1), ('bfloat16', 100)]


def _typed_table(dtype, d, seed=0):
  """The same rows as a numpy table for JAX and a torch table."""
  if dtype == 'int32':
    t = np.random.default_rng(seed).integers(-9, 2**31 - 1, (N, d),
                                             dtype=np.int32)
    return jnp.asarray(t), torch.from_numpy(t)
  t = _table(seed, d=d)
  if dtype == 'bfloat16':
    return (jnp.asarray(t).astype(jnp.bfloat16),
            torch.from_numpy(t).to(torch.bfloat16))
  return jnp.asarray(t), torch.from_numpy(t)


def _bytes(a) -> bytes:
  if isinstance(a, torch.Tensor):
    a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
    return a.numpy().tobytes()
  return np.asarray(a).tobytes()


@pytest.mark.parametrize('with_map', [False, True])
@pytest.mark.parametrize('id_dtype', [np.int32, np.int64])
@pytest.mark.parametrize('dtype,d', TABLES,
                         ids=[f'{t}x{d}' for t, d in TABLES])
def test_plain_byte_equal_to_jax_pallas(monkeypatch, with_map, id_dtype,
                                        dtype, d):
  monkeypatch.setenv('GLT_PALLAS', '1')     # interpret-mode Pallas path
  jt, tt = _typed_table(dtype, d)
  ids = _ids()
  m = _id2index() if with_map else None
  ref = jax_device_gather(jt, jnp.asarray(ids),
                          None if m is None else jnp.asarray(m),
                          use_pallas=True)
  got = gather_rows(tt, torch.from_numpy(ids.astype(id_dtype)),
                    None if m is None else torch.from_numpy(m))
  assert got.dtype == tt.dtype and got.shape == (len(ids), d)
  assert _bytes(got) == _bytes(ref)


def test_plain_clamps_like_the_pallas_kernel():
  table = _table(seed=3)
  idx = np.array([0, N - 1, N + 9, 2, 2], np.int32)
  ref = np.asarray(jax_gather_rows(jnp.asarray(table), jnp.asarray(idx),
                                   interpret=True))
  got = gather_rows_plain(torch.from_numpy(table), torch.from_numpy(idx))
  assert got.numpy().tobytes() == ref.tobytes()


def test_bf16_rows_are_the_f32_rows_rounded():
  table, ids = _table(seed=4), _ids(seed=5)
  m = torch.from_numpy(_id2index(seed=6))
  t32 = torch.from_numpy(table)
  got = gather_rows(t32.to(torch.bfloat16), torch.from_numpy(ids), m)
  ref = gather_rows(t32, torch.from_numpy(ids), m).to(torch.bfloat16)
  assert got.dtype == torch.bfloat16
  assert torch.equal(got.view(torch.int16), ref.view(torch.int16))


def test_wrapper_runs_plain_on_cpu_and_never_off_it():
  table, ids = torch.from_numpy(_table()), torch.from_numpy(_ids())
  calls, launches = gather_rows_plain.calls, gather_rows.launches
  gather_rows(table, ids)
  assert gather_rows_plain.calls == calls + 1
  assert gather_rows.launches == launches
  with pytest.raises(ValueError):
    gather_rows(torch.empty(4, 3, device='meta'),
                torch.empty(2, dtype=torch.int32, device='meta'))
  assert gather_rows_plain.calls == calls + 1
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match='CUDA'):
      _build.kernel('gather_rows', 'glt_gather_rows', ())


@pytest.mark.parametrize('bad', ['1d_table', 'int8', 'float_ids',
                                 'empty_map'])
def test_contract_errors(bad):
  table = torch.zeros(4, 3)
  ids = torch.zeros(2, dtype=torch.int32)
  m = None
  if bad == '1d_table':
    table = torch.zeros(4)
  elif bad == 'int8':
    table = torch.zeros(4, 3, dtype=torch.int8)
  elif bad == 'float_ids':
    ids = torch.zeros(2)
  else:
    m = torch.zeros(0, dtype=torch.int32)
  with pytest.raises(ValueError):
    gather_rows(table, ids, m)
