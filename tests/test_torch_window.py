"""K3, the CSR neighbor-window gather, against the JAX package:
`csr_window_gather_plain` and the CPU path of `csr_window_gather`
against the Pallas `csr_window_gather` in interpret mode, and
`window_gather_plain` against `xla_window_gather`.  Inputs from numpy
seeds; every comparison byte-equal, dtypes included."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphlearn_tpu.ops.pallas_window import \
    csr_window_gather as jax_window_gather
from graphlearn_tpu.ops.pallas_window import xla_window_gather
from graphlearn_tpu_torch.ops import window_gather as wg


def _jax(fn, ind, starts, w, **kw):
  return np.asarray(fn(jnp.asarray(ind), jnp.asarray(starts), w, **kw))


def _port(fn, ind, starts, w):
  out = fn(torch.from_numpy(ind), torch.from_numpy(starts), w)
  assert out.dtype == torch.int32
  return out.numpy()


def _starts(e, w, n=97, seed=0):
  rng = np.random.default_rng(seed)
  starts = rng.integers(0, max(e, 1), n).astype(np.int32)
  # unit-boundary crossings, the array's end, negative and past-the-end
  # starts (the Pallas path clamps starts, not positions)
  starts[:7] = [max(e - 1, 0), max(e - w, 0), min(1020, max(e - 1, 0)),
                -5, -1, e, e + 1000]
  # every residue mod 4, near the start and near the end of the array
  starts[7:15] = np.clip([1, 2, 3, 4, e - w - 1, e - w - 2, e - w - 3,
                          e - 2], 0, None)
  return starts


@pytest.mark.parametrize('e,w', [(5000, 128), (5000, 64), (130000, 128),
                                 (1024, 16), (100, 128), (5000, 1),
                                 (5000, 3), (5000, 33), (5000, 127)])
def test_csr_window_gather_matches_pallas(e, w):
  ind = np.random.default_rng(1).integers(0, 1 << 20, e).astype(np.int32)
  starts = _starts(e, w)
  ref = _jax(jax_window_gather, ind, starts, w, interpret=True)
  before = wg.csr_window_gather_plain.calls
  for fn in (wg.csr_window_gather_plain, wg.csr_window_gather):
    got = _port(fn, ind, starts, w)
    assert got.dtype == ref.dtype and got.shape == (len(starts), w)
    np.testing.assert_array_equal(got, ref, err_msg=fn.__name__)
  # the wrapper took the plain version for CPU tensors, no launch
  assert wg.csr_window_gather_plain.calls == before + 2


def test_csr_window_gather_empty_indices_and_int64_starts():
  empty = np.zeros(0, np.int32)
  starts = np.array([0, 3, -2], np.int32)
  ref = _jax(jax_window_gather, empty, starts, 8, interpret=True)
  got = _port(wg.csr_window_gather, empty, starts, 8)
  np.testing.assert_array_equal(got, ref)
  assert not got.any()
  # the port's indptr is int64: int64 starts give the int32 ones' result
  ind = np.arange(50, dtype=np.int32)
  s32 = np.array([-3, 0, 17, 49, 60], np.int32)
  np.testing.assert_array_equal(
      _port(wg.csr_window_gather, ind, s32.astype(np.int64), 16),
      _jax(jax_window_gather, ind, s32, 16, interpret=True))


@pytest.mark.parametrize('e,w', [(5000, 128), (1024, 16), (100, 64)])
def test_window_gather_plain_matches_xla(e, w):
  ind = np.random.default_rng(2).integers(0, 1 << 20, e).astype(np.int32)
  starts = _starts(e, w, seed=3)
  ref = _jax(xla_window_gather, ind, starts, w)
  got = _port(wg.window_gather_plain, ind, starts, w)
  assert got.dtype == ref.dtype
  np.testing.assert_array_equal(got, ref)


def test_window_gather_plain_clamps_like_xla():
  ind = np.arange(100, dtype=np.int32)
  starts = np.array([95], np.int32)
  got = _port(wg.window_gather_plain, ind, starts, 10)
  np.testing.assert_array_equal(got[0], [95, 96, 97, 98, 99, 99, 99, 99,
                                         99, 99])
  np.testing.assert_array_equal(got, _jax(xla_window_gather, ind, starts,
                                          10))


def test_the_two_functions_differ_on_negative_starts():
  """Start -5: the Pallas path clamps the start (``indices[0..w)``), the
  XLA path each position (``indices[0]`` six times first); the port
  keeps each function's semantics."""
  ind = np.arange(100, dtype=np.int32)
  starts = np.array([-5], np.int32)
  pallas = _jax(jax_window_gather, ind, starts, 8, interpret=True)
  xla = _jax(xla_window_gather, ind, starts, 8)
  np.testing.assert_array_equal(pallas[0], np.arange(8))
  np.testing.assert_array_equal(xla[0], [0, 0, 0, 0, 0, 0, 1, 2])
  np.testing.assert_array_equal(_port(wg.csr_window_gather, ind, starts, 8),
                                pallas)
  np.testing.assert_array_equal(_port(wg.window_gather_plain, ind, starts,
                                      8), xla)


def test_width_and_dtype_contract():
  """Any width >= 1 (no 128-lane cap); a width or dtype the kernel
  cannot take raises ValueError."""
  ind = np.random.default_rng(4).integers(0, 9, 600).astype(np.int32)
  starts = np.array([0, 350, 599, -4], np.int32)
  got = _port(wg.csr_window_gather, ind, starts, 200)
  for i, s in enumerate(np.clip(starts, 0, 599)):
    pos = np.minimum(s + np.arange(200), 599)
    np.testing.assert_array_equal(got[i], ind[pos])
  t_ind, t_starts = torch.from_numpy(ind), torch.from_numpy(starts)
  for bad in ((t_ind, t_starts, 0), (t_ind.long(), t_starts, 8),
              (t_ind, t_starts.float(), 8), (t_ind[None], t_starts, 8)):
    with pytest.raises(ValueError):
      wg.csr_window_gather(*bad)
  assert wg.csr_window_gather(t_ind, t_starts[:0], 8).shape == (0, 8)
