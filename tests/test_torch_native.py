"""The port's native host library against the JAX package's: the same C
sources, built separately (the port's with ``c++`` into
``build/glt_torch/``), must draw, relabel and serialize byte for byte
alike.  Both libraries are loaded in this one process; their SysV queues
are ``IPC_PRIVATE`` and their symbols stay local to each library.
"""
import ctypes
import pickle

import ml_dtypes
import numpy as np
import pytest

from graphlearn_tpu import native as jax_native
from graphlearn_tpu_torch import native
from graphlearn_tpu_torch.distributed import rpc

N = 300


def _graph(seed=0, n=N, e=3000):
  rng = np.random.default_rng(seed)
  rows = rng.integers(0, n, e)
  rows[:200] = 7                       # one hub past every fanout
  cols = rng.integers(0, n, e)
  keep = rows != 11                    # node 11 has no out-edges
  return rows[keep], cols[keep]


@pytest.fixture(scope='module')
def csr():
  rows, cols = _graph()
  port = native.coo_to_csr(rows, cols, N)
  ref = jax_native.coo_to_csr(rows, cols, N)
  for a, b in zip(port, ref):
    assert a.tobytes() == b.tobytes()
  return port


def test_library_built_from_the_port_sources():
  path = native.lib_path()
  assert path.parent.name == 'glt_torch'
  assert path.parent.parent.name == 'build'
  assert native.CSRC.parts[-3:] == ('graphlearn_tpu_torch', 'csrc', 'host')
  assert path.name.startswith('libglt_host-') and path.suffix == '.so'
  lib = native.lib()
  assert lib._name == str(path) and path.exists()
  assert lib._name != jax_native.lib()._name
  # the draws' row seeding, verbatim in the port's copy
  src = (native.CSRC / 'cpu_ops.cc').read_text()
  assert ('splitmix64(seed) ^ splitmix64((uint64_t)v * 0x9e3779b9ull + b)'
          in src)


@pytest.mark.parametrize('k,with_eids,given_eids', [
    (3, False, False), (5, True, False), (4, True, True), (1, False, False),
])
def test_sample_one_hop_byte_equal(csr, k, with_eids, given_eids):
  indptr, indices, perm = csr
  seeds = np.array([7, 11, 0, -1, N + 5, 42, 7, 299], np.int64)
  eids = perm * 3 + 1 if given_eids else None
  for seed in (0, 12345, 2 ** 40 + 7):
    got = native.sample_one_hop(indptr, indices, seeds, k, seed=seed,
                                edge_ids=eids, with_edge_ids=with_eids)
    ref = jax_native.sample_one_hop(indptr, indices, seeds, k, seed=seed,
                                    edge_ids=eids, with_edge_ids=with_eids)
    for a, b in zip(got, ref):
      if b is None:
        assert a is None
      else:
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
  assert got[1][1].sum() == 0 and got[1][0].sum() == k   # empty row, hub


@pytest.mark.parametrize('strict,padding', [(True, False), (True, True),
                                            (False, False)])
def test_negative_sample_byte_equal(csr, strict, padding):
  indptr, indices, _ = csr
  for seed in (1, 99):
    got = native.negative_sample(indptr, indices, 257, trials=3,
                                 strict=strict, padding=padding, seed=seed)
    ref = jax_native.negative_sample(indptr, indices, 257, trials=3,
                                     strict=strict, padding=padding,
                                     seed=seed)
    assert got[0].tobytes() == ref[0].tobytes()
    assert got[1].tobytes() == ref[1].tobytes()


def test_cal_nbr_prob_equal(csr):
  indptr, indices, _ = csr
  prob = np.random.default_rng(3).random(N).astype(np.float32)
  assert native.cal_nbr_prob(indptr, indices, prob, 4).tobytes() == \
      jax_native.cal_nbr_prob(indptr, indices, prob, 4).tobytes()


def test_inducer_sequence_byte_equal(csr):
  """init -> two induce_next hops -> a hetero induce_from into a second
  table -> nodes_since: every output equal to the JAX inducer's."""
  indptr, indices, _ = csr
  outs = []
  for mod in (native, jax_native):
    ind = mod.CpuInducer(capacity_hint=8)
    other = mod.CpuInducer(capacity_hint=8)
    seq = [ind.init_nodes(np.array([7, 3, 7, 250], np.int64))]
    frontier = ind.all_nodes()
    for h, k in enumerate((4, 3)):
      nbrs, mask, _ = mod.sample_one_hop(indptr, indices, frontier, k,
                                         seed=h + 10)
      before = ind.num_nodes
      new, rl, cl = ind.induce_next(frontier, nbrs, mask)
      seq += [new, rl, cl, ind.nodes_since(before)]
      frontier = new
    nbrs, mask, _ = mod.sample_one_hop(indptr, indices, ind.all_nodes(), 2,
                                       seed=5)
    src_local = np.arange(ind.num_nodes, dtype=np.int32)
    seq += list(other.induce_from(src_local, nbrs, mask))
    seq += [other.all_nodes(), np.array([ind.num_nodes, other.num_nodes])]
    ind.clear()
    seq.append(np.array([ind.num_nodes]))
    outs.append(seq)
  for a, b in zip(*outs):
    assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _message():
  rng = np.random.default_rng(4)
  return {
      'f32': rng.standard_normal((5, 3)).astype(np.float32),
      'f64': rng.standard_normal(4),
      'i32': np.arange(6, dtype=np.int32).reshape(2, 3),
      'i64': np.arange(-3, 3, dtype=np.int64),
      'u8': np.arange(7, dtype=np.uint8),
      'b': np.array([True, False, True]),
      'i16': np.array([-2, 5], np.int16),
      'u16': np.array([65535], np.uint16),
      'f16': np.array([0.5, -1.25], np.float16),
      'bf16': np.array([1.5, -2.0], ml_dtypes.bfloat16),
      'scalar': np.int64(42),
      'zero_d': np.array(3.5, np.float32),
      'empty': np.zeros((0, 4), np.float32),
      'strided': np.arange(20, dtype=np.int64)[::3],
      '#SEQ': np.int64(9),
  }


def test_tensor_map_bytes_equal_and_parse_across():
  msg = _message()
  wire = native.serialize_tensor_map(msg)
  assert wire == jax_native.serialize_tensor_map(msg)
  for parsed in (native.parse_tensor_map(wire),
                 jax_native.parse_tensor_map(wire),
                 native.parse_tensor_map(np.frombuffer(wire, np.uint8))):
    assert list(parsed) == list(msg)
    for k, v in msg.items():
      v = np.asarray(v)
      assert parsed[k].dtype == v.dtype and parsed[k].shape == v.shape
      assert parsed[k].tobytes() == np.ascontiguousarray(v).tobytes()
  with pytest.raises(ValueError):
    native.parse_tensor_map(b'\0' * 16)


def test_unsupported_dtype_raises_and_rpc_sends_pickle():
  msg = {'c': np.array([1 + 2j])}
  with pytest.raises(KeyError):
    native.serialize_tensor_map(msg)
  kind, payload = rpc._encode_obj(msg)
  assert kind == rpc.KIND_PICKLE
  assert pickle.loads(payload)['c'][0] == 1 + 2j
  kind, payload = rpc._encode_obj({'a': np.arange(3)})
  assert kind == rpc.KIND_TENSOR_MAP
  assert payload == jax_native.serialize_tensor_map({'a': np.arange(3)})


def test_shm_queue_pickle_timed_and_oversize():
  q = native.ShmQueue(num_slots=3, slot_bytes=4096)
  assert q.num_slots == 3 and q.slot_bytes == 4096 and q.empty()
  assert q.get_timed(0.05) is None
  twin = pickle.loads(pickle.dumps(q))      # attach by shmid
  twin.put({'x': np.arange(4)})
  assert q.qsize() == 1
  out = q.get_timed(1.0)
  assert out['x'].tolist() == [0, 1, 2, 3]
  with pytest.raises(ValueError, match='exceeds slot size'):
    q.put({'big': np.zeros(8192, np.uint8)})
  # the wire bytes of the JAX package's queue are the port's
  jq = jax_native.ShmQueue(num_slots=2, slot_bytes=4096)
  jq.put(_message())
  q.put_bytes(jq.get_bytes())
  got = q.get()
  assert native.serialize_tensor_map(got) == \
      native.serialize_tensor_map(_message())
  for h in (twin, q, jq):
    h.close()


def test_symbols_resolve_inside_each_library():
  """Both libraries export ``glt_queue_size``; each library's internal
  calls resolve to its own copy (RTLD_LOCAL)."""
  for mod in (native, jax_native):
    q = mod.ShmQueue(num_slots=2, slot_bytes=1024)
    q.put({'a': np.arange(2)})
    assert mod.lib().glt_queue_empty(ctypes.c_void_p(q._h)) == 0
    assert q.qsize() == 1
    q.get()
    q.close()
