"""The GNS sampler's edge-id arm in the port against the JAX package: the
plain `ops.gns.sample_one_hop_gns(edge_ids=, with_edge_ids=)` and the
fused wrapper's CPU path (`sample_one_hop_gns_fused`, in the sorted
order too) against JAX's XLA `ops/gns.py::sample_one_hop_gns` and, at
one fanout, its Pallas kernel in interpret mode
(`ops/pallas_sample.py::sample_one_hop_fused(bits=...)`).

Each case runs with ``edge_ids=None`` (the slots' CSR positions) and with
a permutation of ``[0, E)`` (``edge_ids[pos]``), with a shared bitmask
and with the per-requester dedup pair.  Draws are JAX's (``k_rand, k_win
= split(key)``), handed to the port.  Tolerance: none — ids, mask,
weights and edge ids byte-equal (boost 16, whose multiples are exact in
f32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphlearn_tpu.ops import gns as jgns
from graphlearn_tpu.ops.pallas_sample import sample_one_hop_fused as jax_fused
from graphlearn_tpu_torch.ops import (sample_one_hop_gns,
                                      sample_one_hop_gns_fused)
from test_torch_gns import (_bits_forms, _csr, _eq, _gns_draws, _jax_bits,
                            _port_bits, _seeds, _t)

BOOST = 16.0
#: fanouts on both sides of the kernel's lane-group widths, and k 5 at
#: the largest window
CASES = [(2, None), (5, None), (16, None), (17, None), (5, 256)]


def _edge_ids(e, seed):
  return np.random.default_rng(seed).permutation(e).astype(np.int32)


def _eq_eids(got, ref):
  _eq(got, ref)
  assert got.eids is not None and got.eids.dtype == torch.int32
  np.testing.assert_array_equal(got.eids.numpy(),
                                np.asarray(ref.eids).astype(np.int32))
  m = got.mask.numpy()
  assert (got.eids.numpy()[~m] == -1).all()


@pytest.mark.parametrize('ids', [False, True], ids=['positions', 'edge_ids'])
@pytest.mark.parametrize('form', ['shared', 'dedup'])
@pytest.mark.parametrize(
    'k,window', CASES,
    ids=[str(k) if w is None else f'{k}-w{w}' for k, w in CASES])
def test_gns_edge_ids_byte_equal_to_jax_xla(k, window, form, ids):
  indptr, indices = _csr(k, seed=30 + k, w=window)
  n = len(indptr) - 1
  seeds = _seeds(n, seed=k + 3)
  eid = _edge_ids(len(indices), k) if ids else None
  bits, nreq = _bits_forms(n)[form]
  req = (None if nreq is None else np.random.default_rng(k + 9).integers(
      0, nreq, seeds.shape[0]).astype(np.int32))
  key = jax.random.key(200 + k)
  u, v = _gns_draws(key, len(seeds), k)
  jargs = (jnp.asarray(indptr), jnp.asarray(indices), jnp.asarray(seeds), k,
           key, _jax_bits(bits), BOOST,
           None if eid is None else jnp.asarray(eid))
  jreq = None if req is None else jnp.asarray(req)
  targs = (_t(indptr), _t(indices), _t(seeds), k, _t(u), _t(v),
           _port_bits(bits), BOOST)
  tkw = dict(req=None if req is None else _t(req), window=window,
             edge_ids=None if eid is None else _t(eid), with_edge_ids=True)
  for sort_locality in (False, True):
    ref = jgns.sample_one_hop_gns(*jargs, req=jreq, window=window,
                                  with_edge_ids=True,
                                  sort_locality=sort_locality)
    if not sort_locality:
      _eq_eids(sample_one_hop_gns(*targs, **tkw), ref)
    _eq_eids(sample_one_hop_gns_fused(*targs, sort_locality=sort_locality,
                                      **tkw), ref)
  # every valid slot's edge id names the edge its neighbor came from
  got = sample_one_hop_gns(*targs, **tkw)
  m = got.mask.numpy()
  pos = got.eids.numpy()[m] if eid is None else np.argsort(eid)[
      got.eids.numpy()[m]]
  np.testing.assert_array_equal(indices[pos], got.nbrs.numpy()[m])
  row = np.broadcast_to(seeds[:, None], m.shape)[m]
  assert ((pos >= indptr[row]) & (pos < indptr[row + 1])).all()
  # without the arm the outputs are those of the arm, without eids
  plain = sample_one_hop_gns(*targs, req=tkw['req'], window=window)
  assert plain.eids is None
  _eq(plain, jgns.sample_one_hop_gns(*jargs, req=jreq, window=window,
                                     sort_locality=False))


@pytest.mark.parametrize('ids', [False, True], ids=['positions', 'edge_ids'])
@pytest.mark.parametrize('sort_locality', [False, True])
def test_gns_edge_ids_byte_equal_to_pallas_interpret(sort_locality, ids):
  k = 8
  indptr, indices = _csr(k, seed=41)
  n = len(indptr) - 1
  seeds = _seeds(n, seed=42)
  eid = _edge_ids(len(indices), 43) if ids else None
  bits, nreq = _bits_forms(n)['dedup']
  req = np.random.default_rng(44).integers(0, nreq, seeds.shape[0]).astype(
      np.int32)
  key = jax.random.key(45)
  u, v = _gns_draws(key, len(seeds), k)
  ref = jax_fused(jnp.asarray(indptr), jnp.asarray(indices),
                  jnp.asarray(seeds), k, key,
                  None if eid is None else jnp.asarray(eid),
                  bits=_jax_bits(bits), boost=BOOST, req=jnp.asarray(req),
                  with_edge_ids=True, sort_locality=sort_locality,
                  interpret=True)
  got = sample_one_hop_gns_fused(
      _t(indptr), _t(indices), _t(seeds), k, _t(u), _t(v), _port_bits(bits),
      BOOST, req=_t(req), sort_locality=sort_locality,
      edge_ids=None if eid is None else _t(eid), with_edge_ids=True)
  _eq_eids(got, ref)


def test_edge_id_contract():
  """int32 ids of one per edge, or positions that fit int32; an empty
  CSR writes -1 everywhere."""
  k = 4
  indptr, indices = _csr(k, seed=50)
  n = len(indptr) - 1
  seeds = _seeds(n, seed=51)
  bits, _ = _bits_forms(n)['shared']
  u = torch.rand(len(seeds), k)
  args = (_t(indptr), _t(indices), _t(seeds), k, u, u, _port_bits(bits),
          BOOST)
  for bad in (torch.arange(len(indices), dtype=torch.int64),
              torch.arange(len(indices) - 1, dtype=torch.int32)):
    with pytest.raises(ValueError, match='edge_ids'):
      sample_one_hop_gns_fused(*args, edge_ids=bad, with_edge_ids=True)
  # ids without the flag are ignored
  res = sample_one_hop_gns_fused(
      *args, edge_ids=torch.arange(len(indices), dtype=torch.int32))
  assert res.eids is None
  empty = sample_one_hop_gns(torch.zeros(n + 1, dtype=torch.int64),
                             torch.zeros(0, dtype=torch.int32), _t(seeds), k,
                             u, u, _port_bits(bits), BOOST,
                             with_edge_ids=True)
  assert (empty.eids == -1).all() and not empty.mask.any()
