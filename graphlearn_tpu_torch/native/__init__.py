"""ctypes bindings for the port's native host runtime
(``graphlearn_tpu_torch/csrc/host/``).

The port's copy of the JAX package's `native/__init__.py`: the
cross-process shm queue and tensor-map serialization of the producer
pipeline, and the CPU sampling ops the sampling workers run
(`sample_one_hop`, `negative_sample`, `CpuInducer`, `coo_to_csr`,
`cal_nbr_prob`).  Host code only: the library is built with the system
``c++`` (``-O3 -std=c++17 -shared -fPIC -pthread``), never ``nvcc``, on
first use into ``build/glt_torch/`` beside the package, under a file
name carrying a hash of its sources and flags, so an edited source is
rebuilt and a stale library is never loaded.  A library that does not
build or load raises: nothing here degrades to a slower path.

The sampling draws are those of the JAX package's library (each row
seeded with ``splitmix64(seed) ^ splitmix64(v * 0x9e3779b9 + b)``), so
the two produce byte-equal messages from the same seeds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

CSRC = Path(__file__).resolve().parent.parent / 'csrc' / 'host'
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / 'build' / \
    'glt_torch'
SOURCES = ('shm_queue.cc', 'tensor_map.cc', 'cpu_ops.cc', 'inducer.cc')
HEADERS = ('common.h',)
CXX_FLAGS = ('-O3', '-std=c++17', '-shared', '-fPIC', '-pthread')

_lib = None
_cxx_version: Optional[str] = None
_lock = threading.Lock()

# numpy dtype <-> wire code (keep stable: messages cross processes, and
# the JAX package's library reads the same codes).
_DTYPE_CODES = {
    np.dtype(np.float32): 0, np.dtype(np.float64): 1,
    np.dtype(np.int32): 2, np.dtype(np.int64): 3,
    np.dtype(np.uint8): 4, np.dtype(np.bool_): 5,
    np.dtype(np.int16): 6, np.dtype(np.uint16): 7,
    np.dtype(np.float16): 8,
}
try:  # bfloat16 has a numpy dtype only through ml_dtypes
  import ml_dtypes as _ml
  _DTYPE_CODES[np.dtype(_ml.bfloat16)] = 9
except ImportError:
  pass
_CODE_DTYPES = {v: k for k, v in _DTYPE_CODES.items()}


def _compiler() -> str:
  return os.environ.get('CXX', 'c++')


def compiler_version() -> str:
  """``c++ --version``'s first line (run once a process): part of the
  library's name, so a tree copied to a machine with another toolchain
  builds its own library instead of loading a foreign one."""
  global _cxx_version
  if _cxx_version is None:
    res = subprocess.run([_compiler(), '--version'], capture_output=True,
                         text=True)
    if res.returncode != 0:
      raise RuntimeError(f'{_compiler()} --version failed: {res.stderr}')
    _cxx_version = res.stdout.splitlines()[0] if res.stdout else ''
  return _cxx_version


def lib_path() -> Path:
  """Where the library for the current sources, flags and compiler
  lives."""
  h = hashlib.sha256(' '.join(CXX_FLAGS).encode())
  h.update(compiler_version().encode())
  for name in SOURCES + HEADERS:
    h.update(name.encode())
    h.update((CSRC / name).read_bytes())
  return BUILD_DIR / f'libglt_host-{h.hexdigest()[:16]}.so'


def build() -> Path:
  """Compile the host sources with ``c++`` unless the library for these
  sources is already there.  Concurrent processes (test workers, sampling
  processes) each write a private file and publish it atomically."""
  out = lib_path()
  if out.exists():
    return out
  out.parent.mkdir(parents=True, exist_ok=True)
  tmp = out.with_suffix(f'.{os.getpid()}.{threading.get_ident()}.tmp')
  cmd = [_compiler(), *CXX_FLAGS, '-o', str(tmp),
         *[str(CSRC / s) for s in SOURCES]]
  res = subprocess.run(cmd, capture_output=True, text=True)
  if res.returncode != 0:
    raise RuntimeError(f'building the native host library failed '
                       f'({" ".join(cmd)}):\n{res.stdout}{res.stderr}')
  os.replace(tmp, out)
  return out


def lib() -> ctypes.CDLL:
  """The loaded native library (built on first use)."""
  global _lib
  if _lib is None:
    with _lock:
      if _lib is None:
        l = ctypes.CDLL(str(build()))
        _declare(l)
        _lib = l
  return _lib


def _declare(l):
  u64, i64, i32 = ctypes.c_uint64, ctypes.c_int64, ctypes.c_int32
  p = ctypes.c_void_p
  l.glt_queue_create.restype = p
  l.glt_queue_create.argtypes = [u64, u64]
  l.glt_queue_attach.restype = p
  l.glt_queue_attach.argtypes = [ctypes.c_int]
  l.glt_queue_shmid.restype = ctypes.c_int
  l.glt_queue_shmid.argtypes = [p]
  l.glt_queue_slot_bytes.restype = u64
  l.glt_queue_slot_bytes.argtypes = [p]
  l.glt_queue_num_slots.restype = u64
  l.glt_queue_num_slots.argtypes = [p]
  l.glt_queue_size.restype = u64
  l.glt_queue_size.argtypes = [p]
  l.glt_queue_put.restype = ctypes.c_int
  l.glt_queue_put.argtypes = [p, p, u64]
  l.glt_queue_get.restype = i64
  l.glt_queue_get.argtypes = [p, p, u64]
  l.glt_queue_get_timed.restype = i64
  l.glt_queue_get_timed.argtypes = [p, p, u64, i64]
  l.glt_queue_empty.restype = ctypes.c_int
  l.glt_queue_empty.argtypes = [p]
  l.glt_queue_detach.argtypes = [p]
  l.glt_queue_detach.restype = None

  u16p = np.ctypeslib.ndpointer(np.uint16, flags='C')
  u8p = np.ctypeslib.ndpointer(np.uint8, flags='C')
  u64p = np.ctypeslib.ndpointer(np.uint64, flags='C')
  i64p = np.ctypeslib.ndpointer(np.int64, flags='C')
  i32p = np.ctypeslib.ndpointer(np.int32, flags='C')
  f32p = np.ctypeslib.ndpointer(np.float32, flags='C')

  l.glt_tmap_size.restype = u64
  l.glt_tmap_size.argtypes = [ctypes.c_uint32, u16p, u8p, u64p]
  l.glt_tmap_write.restype = u64
  l.glt_tmap_write.argtypes = [
      ctypes.c_uint32, u16p, ctypes.c_char_p, u8p, u8p, u64p, u64p,
      ctypes.POINTER(ctypes.c_void_p), p]
  l.glt_tmap_count.restype = ctypes.c_uint32
  l.glt_tmap_count.argtypes = [p, u64]
  l.glt_tmap_parse.restype = ctypes.c_int
  l.glt_tmap_parse.argtypes = [p, u64, u16p, p, u8p, u8p, u64p, u64p, u64p]

  l.glt_coo_to_csr.restype = None
  l.glt_coo_to_csr.argtypes = [i64p, i64p, i64, i64, i64p, i64p, i64p]
  l.glt_sample_one_hop.restype = None
  l.glt_sample_one_hop.argtypes = [i64p, i64p, p, i64p, i64, i64, i64,
                                   u64, i64p, u8p, p]
  l.glt_cal_nbr_prob.restype = None
  l.glt_cal_nbr_prob.argtypes = [i64p, i64p, f32p, i64, i64, f32p]
  l.glt_negative_sample.restype = i64
  l.glt_negative_sample.argtypes = [i64p, i64p, i64, i64, i64,
                                    ctypes.c_int, ctypes.c_int, u64,
                                    i64p, i64p]

  l.glt_inducer_create.restype = p
  l.glt_inducer_create.argtypes = [i64]
  l.glt_inducer_destroy.argtypes = [p]
  l.glt_inducer_destroy.restype = None
  l.glt_inducer_clear.argtypes = [p]
  l.glt_inducer_clear.restype = None
  l.glt_inducer_num_nodes.restype = i64
  l.glt_inducer_num_nodes.argtypes = [p]
  l.glt_inducer_init.restype = None
  l.glt_inducer_init.argtypes = [p, i64p, i64, i32p]
  l.glt_inducer_induce.restype = i64
  l.glt_inducer_induce.argtypes = [p, i64p, i64p, u8p, i64, i64, i32p, i32p]
  l.glt_inducer_nodes_since.restype = None
  l.glt_inducer_nodes_since.argtypes = [p, i64, i64, i64p]
  l.glt_inducer_induce_pair.restype = i64
  l.glt_inducer_induce_pair.argtypes = [p, i32p, i64p, u8p, i64, i64,
                                        i32p, i32p]


# ---------------------------------------------------------------------------
# Serialization: Dict[str, np.ndarray] <-> bytes
# ---------------------------------------------------------------------------
def serialize_tensor_map(msg: Dict[str, np.ndarray]) -> bytes:
  """Flat-binary serialize (see ``csrc/host/tensor_map.cc``).  Raises
  ``KeyError`` for a dtype the wire format has no code for."""
  return _serialize(msg).tobytes()


def _serialize(msg: Dict[str, np.ndarray]) -> np.ndarray:
  """The wire bytes of ``msg`` as a uint8 array, written once by the
  library (into calloc'd memory: the alignment padding it skips must
  read as zeros, as in the JAX package's bytes)."""
  l = lib()

  def _contig(v):
    v = np.asarray(v)
    # NB: np.ascontiguousarray would promote 0-d to 1-d; preserve rank.
    return v if v.flags['C_CONTIGUOUS'] else np.ascontiguousarray(v)
  items = [(k, _contig(v)) for k, v in msg.items()]
  n = len(items)
  key_bytes = b''.join(k.encode() for k, _ in items)
  key_lens = np.array([len(k.encode()) for k, _ in items], np.uint16)
  dtypes = np.array([_DTYPE_CODES[v.dtype] for _, v in items], np.uint8)
  ndims = np.array([v.ndim for _, v in items], np.uint8)
  shapes = np.array([d for _, v in items for d in v.shape], np.uint64)
  if shapes.size == 0:
    shapes = np.zeros(1, np.uint64)
  nbytes = np.array([v.nbytes for _, v in items], np.uint64)
  datas = (ctypes.c_void_p * n)(
      *[v.ctypes.data_as(ctypes.c_void_p).value for _, v in items])
  size = l.glt_tmap_size(n, key_lens, ndims, nbytes)
  out = np.zeros(int(size), np.uint8)
  written = l.glt_tmap_write(n, key_lens, key_bytes, dtypes, ndims,
                             shapes, nbytes, datas, out.ctypes.data)
  assert written == size, (written, size)
  return out


def parse_tensor_map(buf) -> Dict[str, np.ndarray]:
  """Inverse of :func:`serialize_tensor_map`.  ``buf`` is ``bytes`` or a
  uint8 array; the returned arrays are views into it (read-only for
  ``bytes``), so a message is not copied again after it arrived."""
  l = lib()
  arr = np.frombuffer(buf, np.uint8) if not isinstance(buf, np.ndarray) \
      else buf
  base = arr.ctypes.data
  n = l.glt_tmap_count(base, len(arr))
  if n == 0 and len(arr) >= 12:
    raise ValueError('bad tensor-map buffer')
  key_lens = np.zeros(max(n, 1), np.uint16)
  dtypes = np.zeros(max(n, 1), np.uint8)
  ndims = np.zeros(max(n, 1), np.uint8)
  # Caps the buffer itself bounds (keys and shapes are read out of it);
  # left uninitialized, so only the pages the parse writes are touched.
  keys_buf = np.empty(max(len(arr), 1), np.uint8)
  shapes = np.empty(max(len(arr) // 8, 8), np.uint64)
  nbytes = np.zeros(max(n, 1), np.uint64)
  offs = np.zeros(max(n, 1), np.uint64)
  rc = l.glt_tmap_parse(base, len(arr), key_lens, keys_buf.ctypes.data,
                        dtypes,
                        ndims, shapes, nbytes, offs)
  if rc != 0:
    raise ValueError('malformed tensor-map buffer')
  out: Dict[str, np.ndarray] = {}
  kpos = 0
  spos = 0
  for i in range(n):
    key = keys_buf[kpos:kpos + key_lens[i]].tobytes().decode()
    kpos += key_lens[i]
    shape = tuple(int(s) for s in shapes[spos:spos + ndims[i]])
    spos += ndims[i]
    dt = _CODE_DTYPES[int(dtypes[i])]
    start = int(offs[i])
    out[key] = arr[start:start + int(nbytes[i])].view(dt).reshape(shape)
  return out


# ---------------------------------------------------------------------------
# ShmQueue: cross-process bounded message queue
# ---------------------------------------------------------------------------
class ShmQueue:
  """Fixed-slot MPMC ring in SysV shm (see ``csrc/host/shm_queue.cc``).

  Picklable: pickling captures the shmid; unpickling re-attaches.  The
  segment is ``IPC_PRIVATE`` and marked for removal at creation, so two
  queues never share a key and the kernel reclaims it when the last
  process detaches.
  """

  def __init__(self, num_slots: int, slot_bytes: int,
               _shmid: Optional[int] = None):
    self._l = lib()
    if _shmid is None:
      self._h = self._l.glt_queue_create(num_slots, slot_bytes)
      if not self._h:
        raise OSError('shmget failed (check kernel.shmmax)')
    else:
      self._h = self._l.glt_queue_attach(_shmid)
      if not self._h:
        raise OSError(f'shmat({_shmid}) failed')

  @property
  def shmid(self) -> int:
    return self._l.glt_queue_shmid(self._h)

  @property
  def slot_bytes(self) -> int:
    return self._l.glt_queue_slot_bytes(self._h)

  @property
  def num_slots(self) -> int:
    return self._l.glt_queue_num_slots(self._h)

  def qsize(self) -> int:
    return self._l.glt_queue_size(self._h)

  def empty(self) -> bool:
    return bool(self._l.glt_queue_empty(self._h))

  def put_bytes(self, data):
    """Enqueue one message's bytes (``bytes`` or a uint8 array)."""
    ptr = data.ctypes.data if isinstance(data, np.ndarray) else data
    rc = self._l.glt_queue_put(self._h, ptr, len(data))
    if rc != 0:
      raise ValueError(
          f'message of {len(data)} bytes exceeds slot size '
          f'{self.slot_bytes}')

  def _get_array(self, timeout: Optional[float] = None):
    """One message's bytes as a uint8 array (one copy out of the slot,
    into memory nothing zeroed first); ``None`` on a timeout."""
    cap = int(self.slot_bytes)
    buf = np.empty(cap, np.uint8)
    if timeout is None:
      n = self._l.glt_queue_get(self._h, buf.ctypes.data, cap)
    else:
      n = self._l.glt_queue_get_timed(self._h, buf.ctypes.data, cap,
                                      int(timeout * 1000))
      if n == -2:
        return None
    if n < 0:
      raise ValueError('message exceeded receive buffer')
    return buf[:n]

  def get_bytes(self) -> bytes:
    return self._get_array().tobytes()

  def get_bytes_timed(self, timeout: float):
    """Dequeue with a timeout (seconds); ``None`` when nothing arrived
    — consumers run liveness watchdogs between waits."""
    a = self._get_array(timeout)
    return None if a is None else a.tobytes()

  def get_timed(self, timeout: float):
    a = self._get_array(timeout)
    return None if a is None else parse_tensor_map(a)

  def put(self, msg: Dict[str, np.ndarray]):
    self.put_bytes(_serialize(msg))

  def get(self) -> Dict[str, np.ndarray]:
    return parse_tensor_map(self._get_array())

  def close(self):
    if getattr(self, '_h', None):
      self._l.glt_queue_detach(self._h)
      self._h = None

  def __del__(self):
    try:
      self.close()
    except Exception:
      pass

  def __reduce__(self):
    return (ShmQueue, (0, 0, self.shmid))


# ---------------------------------------------------------------------------
# CPU op wrappers
# ---------------------------------------------------------------------------
def coo_to_csr(rows: np.ndarray, cols: np.ndarray, num_nodes: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
  """Counting-sort COO->CSR; returns (indptr, indices, edge_perm)."""
  l = lib()
  rows = np.ascontiguousarray(rows, np.int64)
  cols = np.ascontiguousarray(cols, np.int64)
  e = len(rows)
  indptr = np.zeros(num_nodes + 1, np.int64)
  indices = np.zeros(e, np.int64)
  perm = np.zeros(e, np.int64)
  l.glt_coo_to_csr(rows, cols, e, num_nodes, indptr, indices, perm)
  return indptr, indices, perm


def sample_one_hop(indptr: np.ndarray, indices: np.ndarray,
                   seeds: np.ndarray, k: int, seed: int = 0,
                   edge_ids: Optional[np.ndarray] = None,
                   with_edge_ids: bool = False):
  """Dense uniform one-hop sample on the host: ``[B, k]`` neighbors, a
  validity mask and (``with_edge_ids``) edge ids, the layout of the
  card's `ops.sample_one_hop`."""
  if k > 256:
    raise ValueError('fanout must be <= 256')
  l = lib()
  indptr = np.ascontiguousarray(indptr, np.int64)
  indices = np.ascontiguousarray(indices, np.int64)
  seeds = np.ascontiguousarray(seeds, np.int64)
  b = len(seeds)
  nbrs = np.empty((b, k), np.int64)
  mask = np.empty((b, k), np.uint8)
  eids = np.empty((b, k), np.int64) if with_edge_ids else None
  eid_ptr = (eids.ctypes.data_as(ctypes.c_void_p) if with_edge_ids
             else None)
  src_eids = (np.ascontiguousarray(edge_ids, np.int64)
              .ctypes.data_as(ctypes.c_void_p)
              if edge_ids is not None else None)
  l.glt_sample_one_hop(indptr, indices, src_eids, seeds, b,
                       len(indptr) - 1, k, seed, nbrs, mask, eid_ptr)
  return nbrs, mask.astype(bool), eids


def cal_nbr_prob(indptr, indices, prob_in, k: int) -> np.ndarray:
  l = lib()
  indptr = np.ascontiguousarray(indptr, np.int64)
  indices = np.ascontiguousarray(indices, np.int64)
  prob_in = np.ascontiguousarray(prob_in, np.float32)
  n = len(indptr) - 1
  out = np.zeros(n, np.float32)
  l.glt_cal_nbr_prob(indptr, indices, prob_in, n, k, out)
  return out


def negative_sample(indptr, indices, req_num: int, trials: int = 5,
                    strict: bool = True, padding: bool = False,
                    seed: int = 0):
  l = lib()
  indptr = np.ascontiguousarray(indptr, np.int64)
  indices = np.ascontiguousarray(indices, np.int64)
  n = len(indptr) - 1
  rows = np.empty(req_num, np.int64)
  cols = np.empty(req_num, np.int64)
  cnt = l.glt_negative_sample(indptr, indices, n, req_num, trials,
                              int(strict), int(padding), seed, rows, cols)
  return rows[:cnt], cols[:cnt]


class CpuInducer:
  """Stateful dedup/relabel on the host, the twin of the card's inducer
  (`ops/unique.py`); see ``csrc/host/inducer.cc``."""

  def __init__(self, capacity_hint: int = 1024):
    self._l = lib()
    self._h = self._l.glt_inducer_create(capacity_hint)

  def __del__(self):
    try:
      if getattr(self, '_h', None):
        self._l.glt_inducer_destroy(self._h)
        self._h = None
    except Exception:
      pass

  def clear(self):
    self._l.glt_inducer_clear(self._h)

  @property
  def num_nodes(self) -> int:
    return self._l.glt_inducer_num_nodes(self._h)

  def init_nodes(self, seeds: np.ndarray) -> np.ndarray:
    seeds = np.ascontiguousarray(seeds, np.int64)
    out = np.empty(len(seeds), np.int32)
    self._l.glt_inducer_init(self._h, seeds, len(seeds), out)
    return out

  def induce_next(self, srcs: np.ndarray, nbrs: np.ndarray,
                  mask: np.ndarray):
    """Returns (new_nodes, row_local, col_local); edges are
    neighbor->seed (message-passing direction)."""
    srcs = np.ascontiguousarray(srcs, np.int64)
    nbrs = np.ascontiguousarray(nbrs, np.int64)
    mask = np.ascontiguousarray(mask, np.uint8)
    b, k = nbrs.shape
    rows = np.empty((b, k), np.int32)
    cols = np.empty((b, k), np.int32)
    before = self.num_nodes
    n_new = self._l.glt_inducer_induce(self._h, srcs, nbrs, mask, b, k,
                                       rows, cols)
    new_nodes = np.empty(n_new, np.int64)
    if n_new:
      self._l.glt_inducer_nodes_since(self._h, before, n_new, new_nodes)
    return new_nodes, rows, cols

  def all_nodes(self) -> np.ndarray:
    return self.nodes_since(0)

  def nodes_since(self, start: int) -> np.ndarray:
    """Global ids of table slots ``[start, num_nodes)`` in local-id
    order — the nodes first discovered after a hop snapshot."""
    n = self.num_nodes - int(start)
    out = np.empty(max(n, 0), np.int64)
    if n > 0:
      self._l.glt_inducer_nodes_since(self._h, start, n, out)
    return out

  def induce_from(self, src_local: np.ndarray, nbrs: np.ndarray,
                  mask: np.ndarray):
    """Hetero hop: the frontier's local ids come from a *different*
    (source-type) inducer; neighbors insert into THIS table.  Returns
    (new_nodes, row_local, col_local), edges neighbor->seed like
    `induce_next`."""
    src_local = np.ascontiguousarray(src_local, np.int32)
    nbrs = np.ascontiguousarray(nbrs, np.int64)
    mask = np.ascontiguousarray(mask, np.uint8)
    b, k = nbrs.shape
    rows = np.empty((b, k), np.int32)
    cols = np.empty((b, k), np.int32)
    before = self.num_nodes
    n_new = self._l.glt_inducer_induce_pair(self._h, src_local, nbrs, mask,
                                            b, k, rows, cols)
    new_nodes = np.empty(n_new, np.int64)
    if n_new:
      self._l.glt_inducer_nodes_since(self._h, before, n_new, new_nodes)
    return new_nodes, rows, cols
