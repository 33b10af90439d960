"""The port's GNS pieces against the JAX package: the inducer, the
membership bitmask, the visit sketch, the biased sampler (plain version
and the fused wrapper's CPU path) and the owner bucketing.

Draws are made here from JAX keys with the discipline of
`graphlearn_tpu/ops/gns.py::sample_one_hop_gns` (``k_rand, k_win =
split(key)``; ``u = uniform(k_rand, [B, k])``, ``v = uniform(k_win, [B,
k])``) and handed to the port.  Tolerance: none — every comparison is
byte-equal, at boosts whose multiples are exact in f32 (16 and 3), where
every cumulative weight is an exact integer whatever the summation
order.  The unbiasedness test is statistical: 4 standard errors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphlearn_tpu.ops import gns as jgns
from graphlearn_tpu.ops import unique as junique
from graphlearn_tpu.ops.neighbor import sample_one_hop as jax_uniform
from graphlearn_tpu.ops.pallas_sample import sample_one_hop_fused as jax_fused
from graphlearn_tpu.parallel.dist_sampler import \
    bucket_by_owner as jax_bucket
from graphlearn_tpu.parallel.exchange import capacity_spec as jax_capacity
from graphlearn_tpu_torch.ops import (default_window, gns, induce_next,
                                      init_node, sample_one_hop_fused,
                                      sample_one_hop_gns,
                                      sample_one_hop_gns_fused, unique_stable)
from graphlearn_tpu_torch.parallel import bucket_by_owner, capacity_spec
from graphlearn_tpu_torch.parallel.exchange import MIN_EXCHANGE_CAP


def _t(a):
  return torch.from_numpy(np.array(a))


# -- the inducer -----------------------------------------------------------

@pytest.mark.parametrize('capacity', [6, 16, 64])
def test_unique_stable_matches_jax(capacity):
  rng = np.random.default_rng(capacity)
  x = rng.integers(-1, 20, 48).astype(np.int32)
  valid = rng.random(48) < 0.8
  for v in (None, valid):
    ref = junique.unique_stable(jnp.asarray(x), capacity,
                                valid=None if v is None else jnp.asarray(v))
    got = unique_stable(_t(x), capacity, valid=None if v is None else _t(v))
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(ref.values))
    np.testing.assert_array_equal(got.inverse.numpy(),
                                  np.asarray(ref.inverse))
    assert int(got.count) == int(ref.count)
    assert got.inverse.dtype == torch.int32


@pytest.mark.parametrize('capacity', [10, 24, 200])
def test_init_node_and_induce_next_match_jax(capacity):
  """Two hops, including overflow past the capacity at the small sizes
  (the latest-appearing ids drop, earlier local indices stay)."""
  rng = np.random.default_rng(capacity + 1)
  seeds = np.array([5, 3, 5, -1, 9, 2], np.int32)
  jstate, jloc = junique.init_node(jnp.asarray(seeds), capacity)
  state, loc = init_node(_t(seeds), capacity)
  np.testing.assert_array_equal(loc.numpy(), np.asarray(jloc))
  src = np.asarray(jloc)
  for k in (4, 3):
    f = src.shape[0]
    nbrs = rng.integers(0, 40, (f, k)).astype(np.int32)
    mask = rng.random((f, k)) < 0.7
    nbrs = np.where(mask, nbrs, -1).astype(np.int32)
    jstate, jr, jc, jprev = junique.induce_next(
        jstate, jnp.asarray(src), jnp.asarray(nbrs), jnp.asarray(mask))
    state, r, c, prev = induce_next(state, _t(src), _t(nbrs), _t(mask))
    np.testing.assert_array_equal(state.nodes.numpy(),
                                  np.asarray(jstate.nodes))
    assert int(state.count) == int(jstate.count)
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    assert int(prev) == int(jprev)
    src = np.repeat(np.arange(f, dtype=np.int32), k)[:f * k]
    src = np.where(np.arange(f * k) % 5 == 4, -1, src).astype(np.int32)
  if capacity == 10:
    assert int(state.count) == capacity            # overflowed


@pytest.mark.parametrize('capacity', [10, 24, 200])
def test_stacked_inducer_rows_match_jax(capacity):
  """``R`` tables advanced at once (``[R, B]`` seeds, ``[R, F, k]``
  neighbors: the mesh samplers' stacked form) give every row what JAX's
  inducer gives that row alone, over two hops with overflow."""
  rng = np.random.default_rng(capacity + 7)
  rows = 3
  seeds = rng.integers(-1, 12, (rows, 6)).astype(np.int32)
  state, loc = init_node(_t(seeds), capacity)
  jrows = [junique.init_node(jnp.asarray(s), capacity) for s in seeds]
  np.testing.assert_array_equal(loc.numpy(),
                                np.stack([np.asarray(j[1]) for j in jrows]))
  jstates = [j[0] for j in jrows]
  src = loc.numpy()
  for k in (4, 3):
    f = src.shape[1]
    nbrs = rng.integers(0, 40, (rows, f, k)).astype(np.int32)
    mask = rng.random((rows, f, k)) < 0.7
    nbrs = np.where(mask, nbrs, -1).astype(np.int32)
    state, r, c, prev = induce_next(state, _t(src), _t(nbrs), _t(mask))
    for i in range(rows):
      jstates[i], jr, jc, jprev = junique.induce_next(
          jstates[i], jnp.asarray(src[i]), jnp.asarray(nbrs[i]),
          jnp.asarray(mask[i]))
      np.testing.assert_array_equal(state.nodes[i].numpy(),
                                    np.asarray(jstates[i].nodes))
      assert int(state.count[i]) == int(jstates[i].count)
      np.testing.assert_array_equal(r[i].numpy(), np.asarray(jr))
      np.testing.assert_array_equal(c[i].numpy(), np.asarray(jc))
      assert int(prev[i]) == int(jprev)
    src = np.where(np.arange(f * k) % 5 == 4, -1,
                   np.repeat(np.arange(f, dtype=np.int32), k)).astype(
                       np.int32)[None].repeat(rows, 0)


# -- the membership bitmask and the sketch ---------------------------------

def _bits_fixture(n=203, parts=3, seed=0):
  rng = np.random.default_rng(seed)
  bounds = np.linspace(0, n, parts + 1).astype(np.int64)
  hot = np.array([7, 0, 11][:parts], np.int64)
  residents = {0: rng.integers(-3, n + 50, 40).astype(np.int64),
               2: rng.integers(0, n, 9).astype(np.int64)}
  return bounds, hot, residents


def test_bitmask_construction_byte_equal():
  n = 203
  bounds, hot, residents = _bits_fixture(n)
  res = residents[0]
  np.testing.assert_array_equal(
      gns.cached_set_bits(n, bounds, hot, res),
      jgns.cached_set_bits(n, bounds, hot, res))
  base = gns.cached_set_bits(n, bounds, hot, np.empty(0, np.int64))
  np.testing.assert_array_equal(gns.set_resident_bits(base, res, n),
                                jgns.set_resident_bits(base, res, n))
  for by_dev in (residents, {}, {1: residents[2]}):
    t, r = gns.dedup_requester_bits(n, bounds, hot, by_dev)
    jt, jr = jgns.dedup_requester_bits(n, bounds, hot, by_dev)
    np.testing.assert_array_equal(t, jt)
    np.testing.assert_array_equal(r, jr)
    assert t.dtype == np.uint8 and r.dtype == np.int32


def test_bitmask_lookup_byte_equal_every_form():
  n = 203
  bounds, hot, residents = _bits_fixture(n)
  table, row_index = jgns.dedup_requester_bits(n, bounds, hot, residents)
  rng = np.random.default_rng(1)
  ids = rng.integers(-2, n, (17, 6)).astype(np.int32)
  req = rng.integers(0, 4, 17).astype(np.int32)
  forms = [(table[0], None), (table[row_index], req),
           ((table, row_index), req)]
  for bits, r in forms:
    jbits = (tuple(jnp.asarray(a) for a in bits) if isinstance(bits, tuple)
             else jnp.asarray(bits))
    tbits = (tuple(_t(a) for a in bits) if isinstance(bits, tuple)
             else _t(bits))
    ref = jgns.bitmask_lookup(jbits, jnp.asarray(ids),
                              None if r is None else jnp.asarray(r))
    got = gns.bitmask_lookup(tbits, _t(ids), None if r is None else _t(r))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert gns.is_per_requester(tbits) == jgns.is_per_requester(jbits)
  with pytest.raises(ValueError, match='req'):
    gns.bitmask_lookup((_t(table), _t(row_index)), _t(ids))


def test_sketch_scores_match_jax():
  a, b = gns.DecayedSketch(slots=97, decay=0.9), jgns.DecayedSketch(
      slots=97, decay=0.9)
  rng = np.random.default_rng(3)
  for i in range(6):
    ids = rng.integers(-1, 5000, 300)
    counts = rng.integers(1, 9, 300) if i % 2 else None
    assert a.update(ids, counts) == b.update(ids, counts)
  np.testing.assert_array_equal(a.scores, b.scores)
  probe = np.arange(-1, 5000)
  np.testing.assert_array_equal(a.score(probe), b.score(probe))


def test_knob_resolution(monkeypatch):
  for env in (jgns.GNS_ENV, jgns.BOOST_ENV, jgns.DECAY_ENV, jgns.SKETCH_ENV):
    monkeypatch.delenv(env, raising=False)
  assert gns.resolve_boost() == jgns.resolve_boost() == 16.0
  monkeypatch.setenv('GLT_GNS', '1')
  monkeypatch.setenv('GLT_GNS_BOOST', '3')
  monkeypatch.setenv('GLT_GNS_DECAY', '7')
  monkeypatch.setenv('GLT_GNS_SKETCH', 'x')
  assert gns.gns_enabled() and not gns.gns_enabled(False)
  assert gns.resolve_boost() == jgns.resolve_boost() == 3.0
  assert gns.resolve_decay() == jgns.resolve_decay() == 1.0
  assert gns.resolve_sketch_slots() == jgns.resolve_sketch_slots()


# -- the biased sampler ------------------------------------------------------

def _csr(k, n=160, seed=0, w=None):
  """Poisson-degree CSR with rows forced into every arm: empty (row 3),
  take-all (row 4), window (rows 5, 6: k+1 and w), hubs (rows 7, 8)."""
  w = default_window(k) if w is None else w
  rng = np.random.default_rng(seed)
  deg = rng.poisson(max(k + 2, 4), n)
  deg[3], deg[4], deg[5], deg[6] = 0, k, k + 1, w
  deg[7], deg[8] = w + 1, 3 * w + 5
  indptr = np.zeros(n + 1, np.int64)
  np.cumsum(deg, out=indptr[1:])
  indices = rng.integers(0, n, int(indptr[-1])).astype(np.int32)
  return indptr, indices


def _seeds(n, b=48, seed=1):
  rng = np.random.default_rng(seed)
  s = rng.integers(0, n, b).astype(np.int32)
  s[:6] = [3, 4, 5, 6, 7, 8]
  s[6] = n + 3                      # out of range: degree 0
  s[10] = s[11] = 5                 # a repeated seed
  s[-3:] = -1
  return s


def _gns_draws(key, b, k):
  k_rand, k_win = jax.random.split(key)
  return (np.array(jax.random.uniform(k_rand, (b, k))),
          np.array(jax.random.uniform(k_win, (b, k))))


def _bits_forms(n, parts=3, seed=2):
  """The three bitmask forms over one dedup table, with requesters."""
  rng = np.random.default_rng(seed)
  bounds = np.linspace(0, n, parts + 1).astype(np.int64)
  hot = np.full(parts, 9, np.int64)
  residents = {0: rng.integers(0, n, 40).astype(np.int64),
               1: rng.integers(0, n, 25).astype(np.int64)}
  table, row_index = jgns.dedup_requester_bits(n, bounds, hot, residents)
  return {'shared': (table[1], None),
          'stack': (table[row_index], parts + 1),
          'dedup': ((table, row_index), parts + 1)}


def _port_bits(bits):
  return tuple(_t(a) for a in bits) if isinstance(bits, tuple) else _t(bits)


def _jax_bits(bits):
  return (tuple(jnp.asarray(a) for a in bits) if isinstance(bits, tuple)
          else jnp.asarray(bits))


def _eq(got, ref):
  np.testing.assert_array_equal(got.nbrs.numpy(), np.asarray(ref.nbrs))
  np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
  assert got.weights.dtype == torch.float32
  np.testing.assert_array_equal(got.weights.numpy(), np.asarray(ref.weights))


def _jit_differs_by_the_rewrite_alone(jit, got, indptr, indices, seeds,
                                      bits, req, boost, w):
  """At k = 1, JAX under jit against the port: the same ids and mask,
  and weights that differ only where total / (deg * wgt) and the
  source's (total / deg) / wgt round apart, by 1 ulp there."""
  np.testing.assert_array_equal(got.nbrs.numpy(), np.asarray(jit.nbrs))
  np.testing.assert_array_equal(got.mask.numpy(), np.asarray(jit.mask))
  n = len(indptr) - 1
  ok = (seeds >= 0) & (seeds < n)
  row = np.clip(seeds, 0, n - 1)
  deg = np.where(ok, np.diff(indptr)[row], 0)
  lane = np.arange(w)
  inside = lane[None, :] < deg[:, None]
  pos = np.clip(indptr[row][:, None] + lane, 0, len(indices) - 1)
  ids = np.where(inside, indices[pos], -1)
  one, b = np.float32(1), np.float32(boost)
  wgt = one + b * gns.bitmask_lookup(bits, _t(ids), req=req).numpy(
      ).astype(np.float32)
  total = np.where(inside, wgt, np.float32(0)).sum(1, dtype=np.float32)
  picked = one + b * gns.bitmask_lookup(bits, got.nbrs, req=req).numpy(
      )[:, 0].astype(np.float32)
  medium = (deg > 1) & (deg <= w)
  d = np.maximum(deg, 1).astype(np.float32)
  port = got.weights.numpy()[:, 0]
  np.testing.assert_array_equal(port[medium],
                                ((total / d) / picked)[medium])
  want = np.where(medium, total / (d * picked), port)
  np.testing.assert_array_equal(np.asarray(jit.weights)[:, 0], want)
  ulps = np.abs(port.view(np.int32).astype(np.int64)
                - want.view(np.int32).astype(np.int64))
  assert ulps.max() <= 1


#: fanouts on both sides of every lane-group width of the GNS kernel (4,
#: 8, 16, 32 lanes a row), each at its default window, and k 5 at the
#: kernel's largest window
GNS_CASES = [(k, None) for k in (1, 2, 4, 5, 8, 15, 16, 17, 32)] + [(5, 256)]


@pytest.mark.parametrize('form', ['shared', 'stack', 'dedup'])
@pytest.mark.parametrize('boost', [16.0, 3.0])
@pytest.mark.parametrize(
    'k,window', GNS_CASES,
    ids=[str(k) if w is None else f'{k}-w{w}' for k, w in GNS_CASES])
def test_gns_plain_byte_equal_to_jax_xla(k, window, boost, form):
  indptr, indices = _csr(k, seed=k, w=window)
  n = len(indptr) - 1
  seeds = _seeds(n, seed=k + 1)
  bits, nreq = _bits_forms(n)[form]
  req = (None if nreq is None else np.random.default_rng(k).integers(
      0, nreq, seeds.shape[0]).astype(np.int32))
  w = default_window(k) if window is None else window
  deg = np.diff(indptr)[np.clip(seeds, 0, n - 1)]
  ok = (seeds >= 0) & (seeds < n)
  assert (ok & (deg <= k)).any() and (ok & (deg > w)).any()
  assert (ok & (deg > k) & (deg <= w)).any()
  key = jax.random.key(100 + k)
  u, v = _gns_draws(key, len(seeds), k)
  jargs = (jnp.asarray(indptr), jnp.asarray(indices), jnp.asarray(seeds), k,
           key, _jax_bits(bits), boost)
  jreq = None if req is None else jnp.asarray(req)
  targs = (_t(indptr), _t(indices), _t(seeds), k, _t(u), _t(v),
           _port_bits(bits), boost)
  treq = None if req is None else _t(req)
  # at k = 1 no broadcast separates the weight's two divisions, and
  # XLA's simplifier rewrites the source's (total / deg) / w into total /
  # (deg * w) under jit, 1 ulp off on some rows; the port keeps the
  # source's formula, so there the JAX function runs op by op
  with jax.disable_jit(k == 1):
    ref = jgns.sample_one_hop_gns(*jargs, req=jreq, window=window,
                                  sort_locality=False)
    ref_sorted = jgns.sample_one_hop_gns(*jargs, req=jreq, window=window,
                                         sort_locality=True)
  got = sample_one_hop_gns(*targs, req=treq, window=window)
  _eq(got, ref)
  if k == 1:
    _jit_differs_by_the_rewrite_alone(
        jgns.sample_one_hop_gns(*jargs, req=jreq, window=window,
                                sort_locality=False),
        got, indptr, indices, seeds, _port_bits(bits), treq, boost, w)
  # the wrapper's CPU path, in the sorted order: draws follow sorted rows
  got = sample_one_hop_gns_fused(*targs, req=treq, window=window,
                                 sort_locality=True)
  _eq(got, ref_sorted)
  m = got.mask.numpy()
  wts = got.weights.numpy()
  assert (wts[~m] == 0).all() and (wts[m] > 0).all()
  assert (got.nbrs.numpy()[seeds < 0] == -1).all()


@pytest.mark.parametrize('boost', [16.0, 3.0])
@pytest.mark.parametrize('sort_locality', [False, True])
@pytest.mark.parametrize('form', ['shared', 'dedup'])
def test_gns_plain_byte_equal_to_pallas_interpret(form, sort_locality,
                                                  boost):
  k = 8
  indptr, indices = _csr(k, seed=11)
  n = len(indptr) - 1
  seeds = _seeds(n, seed=12)
  bits, nreq = _bits_forms(n)[form]
  req = (None if nreq is None else np.random.default_rng(5).integers(
      0, nreq, seeds.shape[0]).astype(np.int32))
  key = jax.random.key(7)
  u, v = _gns_draws(key, len(seeds), k)
  ref = jax_fused(jnp.asarray(indptr), jnp.asarray(indices),
                  jnp.asarray(seeds), k, key, bits=_jax_bits(bits),
                  boost=boost, req=None if req is None else jnp.asarray(req),
                  sort_locality=sort_locality, interpret=True)
  got = sample_one_hop_gns_fused(
      _t(indptr), _t(indices), _t(seeds), k, _t(u), _t(v), _port_bits(bits),
      boost, req=None if req is None else _t(req),
      sort_locality=sort_locality)
  _eq(got, ref)


def test_boundary_draws_and_zero_draws():
  """A draw landing exactly on a cumulative boundary takes the next slot
  (``<=``, searchsorted side='right'), a draw of 0 the first slot, a
  draw just below 1 the last (clamped to ``deg - 1``); weights are
  ``(total / deg) / w``."""
  k, deg = 4, 16
  indptr = np.array([0, deg], np.int64)
  indices = np.arange(deg, dtype=np.int32) * 10
  # id 0 cached: weights [17, 1, ..., 1], cum [17, 18, ..., 32], total 32
  bits = torch.from_numpy(gns.cached_set_bits(200, [0, 200], [0], [0]))
  v = np.array([[0.0, 17 / 32, 18 / 32,
                 np.nextafter(np.float32(1), np.float32(0))]], np.float32)
  res = sample_one_hop_gns_fused(
      _t(indptr), _t(indices), _t(np.array([0], np.int32)), k,
      torch.zeros(1, k), _t(v), bits, 16.0)
  assert res.nbrs.tolist() == [[0, 10, 20, 150]]
  np.testing.assert_array_equal(
      res.weights.numpy(), np.array([[np.float32(2) / np.float32(17), 2, 2,
                                      2]], np.float32))
  # draws exactly on the boundaries between window positions 6/7, 7/8,
  # 14/15, 15/16, 30/31 and 31/32 (the edges of the kernel's lane shares
  # at 8 and 16 entries a lane): ids 30, 200, 400, 500 cached, so cum[e]
  # = e + 1 + 16 * #{cached <= e} and total = 128, and every v * total
  # is exact; each draw takes the slot after its boundary
  deg = 64
  indptr = np.array([0, deg], np.int64)
  indices = np.arange(deg, dtype=np.int32) * 10
  bits = torch.from_numpy(gns.cached_set_bits(700, [0, 700], [0],
                                              [30, 200, 400, 500]))
  slots = np.array([7, 8, 15, 16, 31, 32])
  cum = slots + 16 * (slots - 1 >= 3) + 16 * (slots - 1 >= 20)
  v = (cum / 128).astype(np.float32)[None]
  k = len(slots)
  res = sample_one_hop_gns_fused(
      _t(indptr), _t(indices), _t(np.array([0], np.int32)), k,
      torch.zeros(1, k), _t(v), bits, 16.0)
  assert res.nbrs.tolist() == [(slots * 10).tolist()]
  assert res.mask.all()
  np.testing.assert_array_equal(res.weights.numpy(),
                                np.full((1, k), 2, np.float32))


def test_uniform_sort_locality_matches_jax():
  k = 5
  indptr, indices = _csr(k, seed=21)
  seeds = _seeds(len(indptr) - 1, seed=22)
  key = jax.random.key(3)
  k_rand, k_win = jax.random.split(key)
  u = np.array(jax.random.uniform(k_rand, (len(seeds), k)))
  g = np.array(jax.random.gumbel(k_win, (len(seeds), default_window(k)),
                                 dtype=jnp.float32))
  got = sample_one_hop_fused(_t(indptr), _t(indices), _t(seeds), k, _t(u),
                             _t(g), sort_locality=True)
  ref = jax_uniform(jnp.asarray(indptr), jnp.asarray(indices),
                    jnp.asarray(seeds), k, key, sort_locality=True)
  np.testing.assert_array_equal(got.nbrs.numpy(), np.asarray(ref.nbrs))
  np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
  assert got.weights is None


def test_gns_unbiased_on_port_draws():
  """The boost skews draws toward the cached set, and the weighted
  estimator ``Σ w·f / k`` of the neighbor mean is unbiased (the
  `tests/test_gns.py` monte-carlo check, on torch's own draws)."""
  deg, k, trials = 16, 4, 2000
  indptr = torch.tensor([0, deg] + [deg] * deg, dtype=torch.int64)
  indices = torch.arange(1, deg + 1, dtype=torch.int32)
  bits = torch.from_numpy(gns.cached_set_bits(deg + 1, [0, deg + 1], [0],
                                              np.arange(1, 5)))
  seeds = torch.zeros(trials, dtype=torch.int32)
  gen = torch.Generator().manual_seed(0)
  u = torch.rand(trials, k, generator=gen)
  v = torch.rand(trials, k, generator=gen)
  res = sample_one_hop_gns(indptr, indices, seeds, k, u, v, bits, 8.0)
  nbrs, wts = res.nbrs.numpy(), res.weights.numpy()
  assert res.mask.all() and (nbrs >= 1).all()
  assert (nbrs <= 4).mean() > 0.5
  est = (wts * nbrs).sum(axis=1) / k
  se = est.std() / np.sqrt(trials)
  assert abs(est.mean() - np.arange(1, deg + 1).mean()) < 4 * se + 1e-6


def test_gns_wrapper_cpu_counts_and_contract():
  k = 4
  indptr, indices = _csr(k, seed=31)
  seeds = _seeds(len(indptr) - 1, seed=32)
  bits, _ = _bits_forms(len(indptr) - 1)['shared']
  u = torch.rand(len(seeds), k)
  args = (_t(indptr), _t(indices), _t(seeds), k, u, u, _t(bits), 16.0)
  calls = sample_one_hop_gns.calls
  launches = sample_one_hop_gns_fused.launches
  sample_one_hop_gns_fused(*args, sort_locality=True)
  assert sample_one_hop_gns.calls == calls + 1
  assert sample_one_hop_gns_fused.launches == launches
  with pytest.raises(ValueError, match='draws'):
    sample_one_hop_gns_fused(*args[:4], u[:3], u, *args[6:])
  with pytest.raises(ValueError, match='window'):
    sample_one_hop_gns_fused(*args, window=300)
  with pytest.raises(ValueError, match='req'):
    sample_one_hop_gns_fused(*args[:6], (args[6][None], torch.zeros(
        2, dtype=torch.int32)), 16.0)
  calls = sample_one_hop_gns.calls
  meta = dict(device='meta')
  with pytest.raises(ValueError):
    sample_one_hop_gns_fused(
        torch.empty(5, dtype=torch.int64, **meta),
        torch.empty(9, dtype=torch.int32, **meta),
        torch.empty(2, dtype=torch.int32, **meta), k,
        torch.empty(2, k, **meta), torch.empty(2, k, **meta),
        torch.empty(4, dtype=torch.uint8, **meta), 16.0)
  assert sample_one_hop_gns.calls == calls     # off the CPU: no plain


# -- the owner bucketing and the capacity ----------------------------------

@pytest.mark.parametrize('capacity', [None, 3, 8])
def test_bucket_by_owner_matches_jax(capacity):
  rng = np.random.default_rng(0 if capacity is None else capacity)
  f, parts = 40, 4
  ids = rng.integers(-1, 100, f).astype(np.int32)
  owner = (np.abs(ids) % parts).astype(np.int32)
  owner[5] = parts                  # a valid id past every owner
  ref = jax_bucket(jnp.asarray(ids), jnp.asarray(owner), parts, None,
                   capacity)
  got = bucket_by_owner(_t(ids), _t(owner), parts, capacity)
  for g, r in zip(got, ref):
    np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize('n', [7, 64, 1000, 153_600])
def test_capacity_spec_matches_jax_dense(n):
  for parts in (1, 4):
    for slack in (None, 1.0, 2.0):
      ref = jax_capacity(n, parts, slack, layout='dense')
      got = capacity_spec(n, parts, slack)
      assert (None if got is None else (got.layout, got.capacity)) == \
          (None if ref is None else (ref.layout, ref.capacity))
  assert MIN_EXCHANGE_CAP == 64
