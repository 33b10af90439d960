"""The port's one-hop sampler against the JAX package.

Draws are made in the test from a JAX key with the discipline of
`graphlearn_tpu/ops/neighbor.py::sample_one_hop` (``k_rand, k_win =
split(key)``; ``u [B, k]``, ``gumbel [B, w]``) and handed to the port,
whose plain version must then be byte-equal (nbrs and mask) to both the
XLA sampler and the Pallas fused kernel in interpret mode, on every arm
(to the XLA sampler alone past the Pallas kernel's 128-wide window).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphlearn_tpu.ops.neighbor import sample_one_hop as jax_sample
from graphlearn_tpu.ops.pallas_sample import MAX_W, fused_sample_supported
from graphlearn_tpu.ops.pallas_sample import sample_one_hop_fused as jax_fused
from graphlearn_tpu_torch import _build
from graphlearn_tpu_torch.ops import (default_window, lookup_degree,
                                      sample_one_hop, sample_one_hop_fused)


def _csr(k, n=120, seed=0, w=None):
  """Poisson-degree CSR with rows forced into every arm: empty (row 3),
  take-all (row 4, deg k), window (row 5, deg k+1; row 6, deg w) and
  beyond-window hubs (rows 7 and 8)."""
  w = default_window(k) if w is None else w
  rng = np.random.default_rng(seed)
  deg = rng.poisson(max(k, 4), n)
  deg[3], deg[4], deg[5], deg[6] = 0, k, k + 1, w
  deg[7], deg[8] = w + 1, 3 * w + 5
  indptr = np.zeros(n + 1, np.int64)
  np.cumsum(deg, out=indptr[1:])
  indices = rng.integers(0, n, int(indptr[-1])).astype(np.int32)
  return indptr, indices


def _seeds(n, b=40, seed=1):
  rng = np.random.default_rng(seed)
  s = rng.integers(0, n, b).astype(np.int32)
  s[:6] = [3, 4, 5, 6, 7, 8]
  s[6] = n + 3                      # out of range: clamps to degree 0
  s[-3:] = -1                       # INVALID_ID-padded tail
  return s


def _jax_draws(key, b, k, w):
  k_rand, k_win = jax.random.split(key)
  u = jax.random.uniform(k_rand, (b, k))
  g = jax.random.gumbel(k_win, (b, w), dtype=jnp.float32)
  return np.array(u), np.array(g)     # writable copies for torch


def _port(indptr, indices, seeds, k, u, g, fn=sample_one_hop):
  res = fn(torch.from_numpy(indptr), torch.from_numpy(indices),
           torch.from_numpy(seeds), k, torch.from_numpy(u),
           torch.from_numpy(g))
  assert res.nbrs.dtype == torch.int32 and res.mask.dtype == torch.bool
  return res.nbrs.numpy(), res.mask.numpy()


#: fanouts on both sides of every lane-group width the kernel takes on
#: the card (4, 8, 16 and 32 lanes a row), with the default windows (64
#: up to 256) and a 256-wide window at a small k
FANOUT_CASES = [(1, None), (2, None), (4, None), (5, None), (5, 256),
                (8, None), (15, None), (16, None), (17, None), (32, None)]


@pytest.mark.parametrize(
    'k,window', FANOUT_CASES,
    ids=[str(k) if w is None else f'{k}-w{w}' for k, w in FANOUT_CASES])
def test_plain_byte_equal_to_jax_xla_and_pallas(k, window):
  w = default_window(k) if window is None else window
  indptr, indices = _csr(k, w=w)
  n = len(indptr) - 1
  seeds = _seeds(n)
  deg = np.diff(indptr)[np.clip(seeds, 0, n - 1)]
  valid = (seeds >= 0) & (seeds < n)
  # every arm is present in the batch
  assert (valid & (deg <= k)).any()
  assert (valid & (deg > k) & (deg <= w)).any()
  assert (valid & (deg > w)).any()
  key = jax.random.key(42 + k)
  u, g = _jax_draws(key, len(seeds), k, w)
  nbrs, mask = _port(indptr, indices, seeds, k, u, g)

  args = (jnp.asarray(indptr), jnp.asarray(indices), jnp.asarray(seeds), k,
          key)
  ref = jax_sample(*args, window=window, sort_locality=False)
  np.testing.assert_array_equal(np.asarray(ref.nbrs), nbrs)
  np.testing.assert_array_equal(np.asarray(ref.mask), mask)
  # the Pallas kernel takes windows up to its MAX_W (128); JAX samples
  # wider windows through the XLA sampler alone, as its callers do
  if fused_sample_supported(len(seeds), k, w, jnp.int32,
                            num_edges=len(indices)) is None:
    fused = jax_fused(*args, window=window, sort_locality=False,
                      interpret=True)
    np.testing.assert_array_equal(np.asarray(fused.nbrs), nbrs)
    np.testing.assert_array_equal(np.asarray(fused.mask), mask)
  else:
    assert w > MAX_W
  assert (nbrs[seeds < 0] == -1).all() and not mask[seeds < 0].any()


def test_tie_order_is_value_desc_index_asc():
  # equal Gumbels: lax.top_k keeps the lower window index first, and
  # so must the port (torch.topk does not promise any tie order)
  k, n = 3, 4
  w = default_window(k)
  deg = np.array([6, 10, 2, 9])
  indptr = np.zeros(n + 1, np.int64)
  np.cumsum(deg, out=indptr[1:])
  indices = np.arange(indptr[-1], dtype=np.int32) * 10
  seeds = np.array([0, 1, 3, 2], np.int32)
  g = np.zeros((4, w), np.float32)
  g[0, [1, 4, 5]] = 2.0             # three-way tie at the top
  g[1, [2, 7]] = 5.0                # tie at the top, then all-equal rest
  g[1, 9] = 4.0
  g[2, :] = 1.0                     # every entry ties
  u = np.full((4, k), 0.5, np.float32)
  nbrs, mask = _port(indptr, indices, seeds, k, u, g)
  for row, s in enumerate(seeds):
    d = int(deg[s])
    if d <= k:
      expect = np.arange(d)
    else:
      gm = jnp.where(jnp.arange(w) < d, jnp.asarray(g[row]), -jnp.inf)
      expect = np.asarray(jax.lax.top_k(gm, k)[1])
    got = (nbrs[row][mask[row]] - indices[indptr[s]]) // 10
    np.testing.assert_array_equal(got, expect)
  np.testing.assert_array_equal(
      (nbrs[0] - indices[indptr[0]]) // 10, [1, 4, 5])
  np.testing.assert_array_equal(
      (nbrs[1] - indices[indptr[1]]) // 10, [2, 7, 9])


def test_hub_arm_truncates_in_f32():
  # off = min(trunc(f32(u) * f32(deg)), deg - 1): u just below 1 must
  # land on the last neighbor, never past it
  k = 2
  w = default_window(k)
  d = w + 7
  indptr = np.array([0, d], np.int64)
  indices = np.arange(d, dtype=np.int32)
  u = np.array([[np.nextafter(np.float32(1), np.float32(0)), 0.5]],
               np.float32)
  g = np.zeros((1, w), np.float32)
  nbrs, mask = _port(indptr, indices, np.array([0], np.int32), k, u, g)
  expect = np.minimum((u[0] * np.float32(d)).astype(np.int32), d - 1)
  np.testing.assert_array_equal(nbrs[0], expect)
  assert mask.all()


def test_fused_wrapper_runs_plain_version_on_cpu():
  k = 5
  indptr, indices = _csr(k, seed=4)
  seeds = _seeds(len(indptr) - 1, seed=5)
  u, g = _jax_draws(jax.random.key(3), len(seeds), k, default_window(k))
  calls = sample_one_hop.calls
  launches = sample_one_hop_fused.launches
  got = _port(indptr, indices, seeds, k, u, g, fn=sample_one_hop_fused)
  ref = _port(indptr, indices, seeds, k, u, g)
  np.testing.assert_array_equal(got[0], ref[0])
  np.testing.assert_array_equal(got[1], ref[1])
  assert sample_one_hop.calls == calls + 2
  assert sample_one_hop_fused.launches == launches


def test_no_fallback_off_the_cpu():
  # a tensor that is not on the CPU never takes the plain version: the
  # wrapper launches the kernel or raises
  k, w = 3, default_window(3)
  meta = dict(device='meta')
  calls = sample_one_hop.calls
  with pytest.raises(ValueError):
    sample_one_hop_fused(torch.empty(5, dtype=torch.int64, **meta),
                         torch.empty(9, dtype=torch.int32, **meta),
                         torch.empty(2, dtype=torch.int32, **meta), k,
                         torch.empty(2, k, **meta),
                         torch.empty(2, w, **meta))
  assert sample_one_hop.calls == calls
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match='CUDA'):
      _build.kernel('sample_one_hop', 'glt_sample_one_hop', ())


def test_window_and_shape_contract():
  indptr, indices = _csr(4)
  seeds = torch.zeros(2, dtype=torch.int32)
  args = (torch.from_numpy(indptr), torch.from_numpy(indices), seeds)
  with pytest.raises(ValueError, match='window'):
    k = 33                          # default_window(33) = 264 > 256
    sample_one_hop_fused(*args, k, torch.zeros(2, k),
                         torch.zeros(2, default_window(k)))
  with pytest.raises(ValueError, match='draws'):
    sample_one_hop_fused(*args, 4, torch.zeros(3, 4), torch.zeros(2, 64))


def test_lookup_degree():
  indptr, _ = _csr(4)
  nodes = np.array([0, 3, 8, -1, 500], np.int32)
  got = lookup_degree(torch.from_numpy(indptr), torch.from_numpy(nodes))
  deg = np.diff(indptr)
  np.testing.assert_array_equal(got.numpy(),
                                [deg[0], 0, deg[8], 0, 0])
