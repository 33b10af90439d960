"""Random walks against the JAX package: `random_walk` (dead ends,
invalid starts, restarts), `node2vec_walk` (exact and truncated
windows), `walk_edges`, an edgeless graph, the walk draw streams, and
the DeepWalk skip-gram loss of `chip_smoke.py` against the example's
(`examples/deepwalk.py:108-125`) written in `jax.numpy`.

The port replays JAX's keys through a walk draws provider: ``keys =
split(key, L)``; step ``t`` draws its offsets ``randint(kk, (B,), 0,
max(deg, 1))`` and its restarts ``uniform(kr, (B,))`` after ``kk, kr =
split(keys[t])``, and node2vec its Gumbels ``-log(-log(uniform(keys[t],
(B, W), 1e-20, 1)))``, the tensor itself injected.  Tolerances: walks
and pairs byte-equal; the loss and its gradients within 1e-5.
"""
import hashlib
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphlearn_tpu.ops import node2vec_walk as jax_node2vec
from graphlearn_tpu.ops import random_walk as jax_random_walk
from graphlearn_tpu.ops import walk_edges as jax_walk_edges
from graphlearn_tpu_torch.data.topology import CSRTopo
from graphlearn_tpu_torch.ops import (CounterDraws, TorchDraws, WalkDraws,
                                      node2vec_walk, random_walk, walk_edges)

ROOT = Path(__file__).resolve().parent.parent
N = 80


def _chip_smoke():
  spec = importlib.util.spec_from_file_location('chip_smoke',
                                                ROOT / 'chip_smoke.py')
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def _graph(seed=0, n=N):
  """A CSR (columns sorted within rows) with dead ends (the last 10
  nodes have no out-edges), a hub of degree 40 and small rows."""
  rng = np.random.default_rng(seed)
  deg = rng.integers(1, 6, n)
  deg[:2] = 40
  deg[-10:] = 0
  rows = np.repeat(np.arange(n), deg)
  cols = rng.integers(0, n, rows.shape[0])
  topo = CSRTopo((rows, cols), num_nodes=n)
  return np.asarray(topo.indptr, np.int64), topo.indices, int(deg.max())


def _starts(seed=1, b=48):
  s = np.random.default_rng(seed).integers(0, N, b).astype(np.int32)
  s[:3] = [N - 1, N - 2, 0]          # dead ends first, then the hub
  s[-4:] = -1                        # invalid starts
  return s


class JaxWalkDraws:
  """Replays the JAX walkers' draws (module docstring)."""

  def __init__(self, key, length):
    self.keys = jax.random.split(key, length)

  def ints(self, t, high):
    kk, _ = jax.random.split(self.keys[t])
    return torch.from_numpy(np.array(jax.random.randint(
        kk, (high.shape[0],), 0, jnp.asarray(high.numpy()))))

  def uniform(self, t, b):
    _, kr = jax.random.split(self.keys[t])
    return torch.from_numpy(np.array(jax.random.uniform(kr, (b,))))

  def gumbel(self, t, b, w):
    u = jax.random.uniform(self.keys[t], (b, w), minval=1e-20, maxval=1.0)
    return torch.from_numpy(np.array(-jnp.log(-jnp.log(u))))


def _same(got, ref, what):
  ref = np.asarray(ref)
  assert got.numpy().dtype == ref.dtype, what
  np.testing.assert_array_equal(got.numpy(), ref, err_msg=what)


@pytest.mark.parametrize('restart', [0.0, 0.3])
@pytest.mark.parametrize('length', [1, 6])
def test_random_walk_matches_jax(restart, length):
  """Dead ends go invalid for good (a restart brings the walk back),
  invalid starts stay invalid; every step byte-equal to JAX's."""
  indptr, indices, _ = _graph()
  starts = _starts()
  key = jax.random.key(11)
  ref = jax_random_walk(jnp.asarray(indptr), jnp.asarray(indices),
                        jnp.asarray(starts), key, walk_length=length,
                        restart_prob=restart)
  got = random_walk(torch.from_numpy(indptr), torch.from_numpy(indices),
                    torch.from_numpy(starts), length, restart_prob=restart,
                    draws=JaxWalkDraws(key, length))
  _same(got, ref, 'walks')
  assert got.shape == (len(starts), length + 1)
  w = got.numpy()
  assert (w[:, 0] == starts).all() and (w[-4:] == -1).all()
  if restart == 0.0:
    assert (w[0, 1:] == -1).all()            # a dead-end start
  else:
    assert ((w[0, 1:] == -1) | (w[0, 1:] == starts[0])).all()


@pytest.mark.parametrize('p,q', [(1.0, 1.0), (0.25, 4.0), (4.0, 0.5)])
@pytest.mark.parametrize('truncate', [False, True], ids=['exact', 'window8'])
def test_node2vec_walk_matches_jax(p, q, truncate):
  """Second-order walks over the full rows and over an 8-wide window
  (the hub truncated), byte-equal to JAX's with its Gumbels injected."""
  indptr, indices, max_deg = _graph(seed=2)
  starts = _starts(seed=3)
  w = 8 if truncate else max_deg
  key = jax.random.key(13)
  ref = jax_node2vec(jnp.asarray(indptr), jnp.asarray(indices),
                     jnp.asarray(starts), key, walk_length=5, p=p, q=q,
                     max_degree=w)
  got = node2vec_walk(torch.from_numpy(indptr), torch.from_numpy(indices),
                      torch.from_numpy(starts), 5, p=p, q=q, max_degree=w,
                      draws=JaxWalkDraws(key, 5))
  _same(got, ref, 'node2vec walks')
  # every step is an edge (within the window)
  wk = got.numpy()
  for a, b in zip(wk[:, :-1].reshape(-1), wk[:, 1:].reshape(-1)):
    if a >= 0 and b >= 0:
      assert b in indices[indptr[a]:indptr[a] + w]


@pytest.mark.parametrize('window', [1, 2, 3])
def test_walk_edges_match_jax(window):
  walks = np.random.default_rng(4).integers(-1, N, (20, 7)).astype(np.int32)
  rs, rd = jax_walk_edges(jnp.asarray(walks), window=window)
  s, d = walk_edges(torch.from_numpy(walks), window=window)
  _same(s, rs, 'src')
  _same(d, rd, 'dst')
  assert s.shape == (sum(20 * (7 - o) for o in range(1, window + 1)),)


def test_edgeless_graph():
  """No edge anywhere: every walk is its start and then -1, in both
  walkers, as in JAX."""
  indptr = np.zeros(6, np.int64)
  indices = np.zeros(0, np.int32)
  starts = np.array([0, 3, -1, 5], np.int32)
  key = jax.random.key(0)
  for fn, jfn, kw in ((random_walk, jax_random_walk, {}),
                      (node2vec_walk, jax_node2vec, {'max_degree': 4})):
    ref = jfn(jnp.asarray(indptr), jnp.asarray(indices), jnp.asarray(starts),
              key, walk_length=3, **kw)
    got = fn(torch.from_numpy(indptr), torch.from_numpy(indices),
             torch.from_numpy(starts), 3, draws=JaxWalkDraws(key, 3), **kw)
    _same(got, ref, fn.__name__)
    assert (got[:, 1:] == -1).all()


def test_walk_draw_streams():
  """The walk streams: ``row_ints`` in each row's own range (a bound of
  1 gives 0), coordinates moving the values, the counter draws equal for
  int and tensor coordinates; the default walks reproducible; and a
  digest of recorded values (the older streams keep theirs in
  `test_torch_negative` and `test_torch_hetero`)."""
  high = torch.tensor([1, 2, 3, 1000, 1 << 31] * 40)
  cd, td = CounterDraws(7, 'cpu'), TorchDraws(7, 'cpu')
  outs = []
  for prov in (cd, td):
    a = prov.row_ints((3, 0), high)
    assert a.dtype == torch.int32 and a.shape == high.shape
    assert bool((a.long() >= 0).all()) and bool((a.long() < high).all())
    assert bool((a[high == 1] == 0).all())
    assert torch.equal(prov.row_ints((3, 0), high), a)
    assert not torch.equal(prov.row_ints((4, 0), high), a)
    outs.append(a)
  assert torch.equal(cd.row_ints(tuple(torch.tensor([3, 0]).unbind(0)),
                                 high), outs[0])
  walk = WalkDraws(cd)
  assert torch.equal(walk.ints(3, high), outs[0])
  u, g = walk.uniform(2, 9), walk.gumbel(2, 9, 5)
  assert u.shape == (9,) and g.shape == (9, 5) and u.dtype == torch.float32
  assert bool(((u > 0) & (u < 1)).all())
  indptr, indices, _ = _graph()
  t = (torch.from_numpy(indptr), torch.from_numpy(indices),
       torch.from_numpy(_starts()))
  w1 = random_walk(*t, 6, restart_prob=0.2, seed=5)
  assert torch.equal(w1, random_walk(*t, 6, restart_prob=0.2, seed=5))
  assert not torch.equal(w1, random_walk(*t, 6, restart_prob=0.2, seed=6))
  n1 = node2vec_walk(*t, 4, p=0.5, q=2.0, seed=5)
  h = hashlib.sha256()
  for x in outs + [u, g, w1, n1]:
    h.update(x.numpy().tobytes())
  assert h.hexdigest() == WALK_DIGEST


#: recorded values of `test_walk_draw_streams`
WALK_DIGEST = ('e8f3359d96c0dde2dc1d282d5bb9e86d'
               'cae8557744ec59cbf1011cbbe80c43b8')


def test_skipgram_loss_and_grads_match_jax():
  """`chip_smoke.skipgram_loss` against the example's loss in
  `jax.numpy` on the same embeddings, pairs (some masked) and
  negatives: the loss and both tables' gradients within 1e-5."""
  cs = _chip_smoke()
  rng = np.random.default_rng(5)
  n, d, e, k = 50, 8, 64, 4
  emb = rng.normal(0, 0.3, (n, d)).astype(np.float32)
  ctx = rng.normal(0, 0.3, (n, d)).astype(np.float32)
  src = rng.integers(0, n, e).astype(np.int32)
  dst = rng.integers(0, n, e).astype(np.int32)
  src[:5] = -1
  dst[3:9] = -1
  neg = rng.integers(0, n, (e, k)).astype(np.int32)

  def jax_loss(p):
    ok = (src >= 0) & (dst >= 0)
    s = jnp.where(ok, src, 0)
    dd = jnp.where(ok, dst, 0)
    es = p['emb'][s]
    pos = jnp.einsum('ed,ed->e', es, p['ctx'][dd])
    negs = jnp.einsum('ed,end->en', es, p['ctx'][neg])
    loss = -jax.nn.log_sigmoid(pos) - jax.nn.log_sigmoid(-negs).sum(1)
    return jnp.where(ok, loss, 0).sum() / jnp.maximum(ok.sum(), 1)
  ref, grads = jax.value_and_grad(jax_loss)(
      {'emb': jnp.asarray(emb), 'ctx': jnp.asarray(ctx)})
  te = torch.nn.Parameter(torch.from_numpy(emb))
  tc = torch.nn.Parameter(torch.from_numpy(ctx))
  loss = cs.skipgram_loss(torch, te, tc, torch.from_numpy(src),
                          torch.from_numpy(dst), torch.from_numpy(neg))
  loss.backward()
  np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-5, atol=1e-5)
  np.testing.assert_allclose(te.grad.numpy(), np.asarray(grads['emb']),
                             rtol=1e-5, atol=1e-5)
  np.testing.assert_allclose(tc.grad.numpy(), np.asarray(grads['ctx']),
                             rtol=1e-5, atol=1e-5)
