"""Negative sampling against the JAX package: `edge_in_csr`,
`sample_negative` in every mode, `RandomNegativeSampler`, and the draws'
integer-candidate streams.

The port takes its candidates from a ``candidates(stream, trials, r,
high)`` provider; the tests replay JAX's ``randint`` keys through it
(``split(key)`` into the row stream 0 and the column stream 1; the
sampler's key is ``fold_in(key(seed), step)``).  Tolerance: byte-equal,
dtypes included.
"""
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphlearn_tpu.data import Dataset as JaxDataset
from graphlearn_tpu.ops.negative import edge_in_csr as jax_edge_in_csr
from graphlearn_tpu.ops.negative import sample_negative as jax_sample_negative
from graphlearn_tpu.sampler import RandomNegativeSampler as JaxNegSampler
from graphlearn_tpu_torch.data import Dataset
from graphlearn_tpu_torch.data.topology import CSRTopo
from graphlearn_tpu_torch.ops import (CounterDraws, TorchDraws, edge_in_csr,
                                      sample_negative)
from graphlearn_tpu_torch.sampler import RandomNegativeSampler


def _csr(kind: str, seed: int = 0, n: int = 60):
  """A sorted CSR: random degrees with empty rows and a hub, every edge
  in one row, or one edge."""
  rng = np.random.default_rng(seed)
  if kind == 'random':
    deg = rng.integers(0, 6, n)
    deg[::5] = 0
    deg[3] = 45
  elif kind == 'one_row':
    deg = np.zeros(n, np.int64)
    deg[n // 2] = 3 * n
  else:
    deg = np.zeros(n, np.int64)
    deg[-1] = 1
  rows = np.repeat(np.arange(n), deg)
  cols = rng.integers(0, n, rows.shape[0])
  topo = CSRTopo((rows, cols), num_nodes=n)
  return np.asarray(topo.indptr, np.int64), np.asarray(topo.indices, np.int32)


def jax_candidates(key):
  """The candidates of one JAX `sample_negative` call with ``key``."""
  def candidates(stream, trials, r, high):
    k = jax.random.split(key)[stream]
    return torch.from_numpy(np.array(jax.random.randint(
        k, (trials, r), 0, high, dtype=jnp.int32)))
  return candidates


def jax_neg_draws(seed, triplet=False):
  """A ``neg_draws(step, stream, trials, r, high)`` provider that replays
  a JAX sampler's negative keys, ``fold_in(key(seed), step)``: split
  into the row and column streams (binary), or whole (triplet)."""
  base = jax.random.key(seed)

  def neg_draws(step, stream, trials, r, high):
    key = jax.random.fold_in(base, step)
    if not triplet:
      key = jax.random.split(key)[stream]
    return torch.from_numpy(np.array(jax.random.randint(
        key, (trials, r), 0, high, dtype=jnp.int32)))
  return neg_draws


def _same(got: torch.Tensor, ref, what):
  ref = np.asarray(ref)
  assert got.numpy().dtype == ref.dtype, what
  np.testing.assert_array_equal(got.numpy(), ref, err_msg=what)


@pytest.mark.parametrize('kind', ['random', 'one_row', 'one_edge'])
def test_edge_in_csr_matches_jax(kind):
  """Existing edges (every edge of the graph), random pairs, invalid
  rows (-1, -7) and the rows of every length."""
  indptr, indices = _csr(kind)
  n = indptr.shape[0] - 1
  rng = np.random.default_rng(1)
  src = np.repeat(np.arange(n), np.diff(indptr)).astype(np.int32)
  rows = np.concatenate([src, rng.integers(-7, n, 400)]).astype(np.int32)
  cols = np.concatenate([indices, rng.integers(0, n, 400)]).astype(np.int32)
  rows[-3:] = -1
  ref = jax_edge_in_csr(jnp.asarray(indptr.astype(np.int32)),
                        jnp.asarray(indices), jnp.asarray(rows),
                        jnp.asarray(cols))
  got = edge_in_csr(torch.from_numpy(indptr), torch.from_numpy(indices),
                    torch.from_numpy(rows), torch.from_numpy(cols))
  _same(got, ref, kind)
  assert bool(got[:len(src)].all()) and not bool(got[rows < 0].any())


def test_edge_in_csr_without_edges():
  """A graph with no edge (where the JAX function cannot gather): no
  pair is an edge."""
  got = edge_in_csr(torch.zeros(5, dtype=torch.int64),
                    torch.zeros(0, dtype=torch.int32),
                    torch.tensor([0, 3, -1], dtype=torch.int32),
                    torch.tensor([1, 0, 2], dtype=torch.int32))
  assert got.dtype == torch.bool and not bool(got.any())


@pytest.mark.parametrize('strict', [True, False])
@pytest.mark.parametrize('padding', [True, False])
@pytest.mark.parametrize('num_cols', [None, 17])
def test_sample_negative_matches_jax(strict, padding, num_cols):
  """A dense graph (half the pairs are edges, and a row holding every
  column), so some slots find no non-edge in 5 trials: the padding
  fallback and the mask both show."""
  n = 24
  rng = np.random.default_rng(2)
  adj = rng.random((n, n)) < 0.5
  adj[4] = True
  rows, cols = np.nonzero(adj)
  topo = CSRTopo((rows, cols), num_nodes=n)
  indptr = np.asarray(topo.indptr, np.int64)
  indices = np.asarray(topo.indices, np.int32)
  for seed in range(3):
    key = jax.random.key(seed)
    ref = jax_sample_negative(jnp.asarray(indptr.astype(np.int32)),
                              jnp.asarray(indices), 200, key,
                              strict=strict, padding=padding,
                              num_cols=num_cols)
    got = sample_negative(torch.from_numpy(indptr),
                          torch.from_numpy(indices), 200,
                          jax_candidates(key), strict=strict,
                          padding=padding, num_cols=num_cols)
    for f in ('rows', 'cols', 'mask'):
      _same(getattr(got, f), getattr(ref, f), f'{f} seed {seed}')
    if strict and not padding:
      assert not bool(got.mask.all())          # the mask shows
    if num_cols is not None:
      assert int(got.cols.max()) < num_cols


@pytest.mark.parametrize('padding', [True, False])
def test_random_negative_sampler_matches_jax(padding):
  indptr, indices = _csr('random', seed=4)
  n = indptr.shape[0] - 1
  rows = np.repeat(np.arange(n), np.diff(indptr))
  jds = JaxDataset().init_graph((rows, indices), num_nodes=n)
  ds = Dataset().init_graph((rows, indices), num_nodes=n, device='cpu')
  js = JaxNegSampler(jds.get_graph(), seed=3)
  ts = RandomNegativeSampler(ds.get_graph(), device='cpu',
                             neg_draws=jax_neg_draws(3))
  for req, trials in ((50, 5), (7, 1), (130, 3)):
    ref = js.sample(req, trials_num=trials, padding=padding)
    got = ts.sample(req, trials_num=trials, padding=padding)
    _same(got, ref, f'req {req}')
    assert got.shape == (2, req)


def test_candidate_streams():
  """The integer candidates of both providers: shape, dtype, range, a
  wider draw extending a narrower one, coordinates and streams moving
  the values; and a digest of recorded values."""
  cd = CounterDraws(7, 'cpu')
  a = cd.ints((1, 0, 2, 0), 5, 40, 1000)
  assert a.shape == (5, 40) and a.dtype == torch.int32
  assert int(a.min()) >= 0 and int(a.max()) < 1000
  assert torch.equal(cd.ints((1, 0, 2, 0), 5, 80, 1000)[:, :40], a)
  assert torch.equal(cd.negatives(1, None, 2, 0, 5, 40, 1000), a)
  tensor_coords = tuple(torch.tensor([1, 0, 2, 0]).unbind(0))
  assert torch.equal(cd.ints(tensor_coords, 5, 40, 1000), a)
  for other in (cd.ints((1, 0, 2, 1), 5, 40, 1000),
                cd.ints((2, 0, 2, 0), 5, 40, 1000),
                CounterDraws(8, 'cpu').ints((1, 0, 2, 0), 5, 40, 1000)):
    assert not torch.equal(a, other)
  # spread over the range: every tenth of [0, 1000) is hit
  big = cd.ints((3,), 8, 500, 1000)
  assert len(torch.unique(big // 100)) == 10
  td = TorchDraws(7, 'cpu')
  b = td.negatives(3, 0, 5, 40, 1000)
  assert b.shape == (5, 40) and b.dtype == torch.int32
  assert int(b.min()) >= 0 and int(b.max()) < 1000
  assert torch.equal(td.negatives(3, 0, 5, 40, 1000), b)
  assert not torch.equal(td.negatives(3, 1, 5, 40, 1000), b)
  h = hashlib.sha256()
  for t in (a, b, cd.ints((9, 9), 3, 7, 2_000_000_000)):
    h.update(t.numpy().tobytes())
  assert h.hexdigest() == ('a3e1a542893acb83a9e6ff1ef98fe31f'
                           '409e25d1dd8dc0cd890c10ff069db2c8')
