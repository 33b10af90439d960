"""Build the port's CUDA sources (``csrc/*.cu``) and load them.

Each source is compiled by ``nvcc`` into its own shared library with a
plain C interface, for ``sm_90a`` (Hopper), on first CUDA use, and
loaded with `ctypes`.  A ``csrc/*.cpp`` source (host code only: the
locality greedy) is built and loaded the same way.  The build directory is ``build/glt_torch/``
beside the package (gitignored) unless a caller names another; a
library's file name carries a hash of its source and flags, so an
edited source is rebuilt and a stale library is never loaded.
`build_all` starts one ``nvcc`` per source, all at once.

With ``GLT_AOT_CACHE_DIR`` set (or a `serving.aot_cache.
AotExecutableCache` passed), a library missing from the build directory
is first looked up in that durable cache under its `fingerprint`: a hit
is copied in and loaded, a miss runs ``nvcc`` and publishes the result,
so a second process on the same machine builds nothing.  A restored
library that does not load is treated as corrupt: it is removed, rebuilt
and republished (one ``aot.cache_miss``), never run half-loaded.
`NVCC_RUNS` counts the ``nvcc`` processes this process started.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parent.parent / 'build' / 'glt_torch'
SOURCES = ('sample_one_hop', 'sample_one_hop_gns', 'gather_rows',
           'merge_ranks', 'csr_window_gather', 'push_rows', 'cold_gather',
           'locality_greedy')
NVCC_FLAGS = ('-gencode=arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v')

#: ``nvcc`` processes started by this process (guarded by `_count_lock`)
NVCC_RUNS = 0

_lock = threading.Lock()
_count_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, ctypes._CFuncPtr] = {}
_nvcc_version: Optional[str] = None


def nvcc() -> str:
  found = shutil.which('nvcc')
  if found:
    return found
  home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
  path = os.path.join(home, 'bin', 'nvcc')
  if not os.path.exists(path):
    raise RuntimeError('nvcc not found (looked on PATH and under '
                       f'{home}/bin); the CUDA kernels cannot be built')
  return path


def nvcc_version() -> str:
  """``nvcc --version``'s output (run once a process)."""
  global _nvcc_version
  if _nvcc_version is None:
    _nvcc_version = subprocess.run([nvcc(), '--version'],
                                   capture_output=True, text=True,
                                   check=True).stdout.strip()
  return _nvcc_version


def compute_capability() -> list:
  return list(torch.cuda.get_device_capability())


def _source(name: str) -> Path:
  """``csrc/<name>.cu``, or ``csrc/<name>.cpp`` for host code."""
  cu = CSRC / f'{name}.cu'
  return cu if cu.exists() else CSRC / f'{name}.cpp'


def _source_bytes(name: str) -> bytes:
  src = _source(name).read_bytes()
  for hdr in sorted(CSRC.glob('*.cuh')):
    src += hdr.read_bytes()
  return src


def _lib_path(name: str, build_dir: Path) -> Path:
  src = _source_bytes(name)
  tag = hashlib.sha256(src + ' '.join(NVCC_FLAGS).encode()).hexdigest()
  return build_dir / f'{name}-{tag[:16]}.so'


def fingerprint(name: str) -> dict:
  """Everything that shapes ``name``'s library: the cache key material
  (`serving.aot_cache.fingerprint_key`)."""
  return {'program': name,
          'source_sha256': hashlib.sha256(_source_bytes(name)).hexdigest(),
          'nvcc_flags': list(NVCC_FLAGS),
          'nvcc_version': nvcc_version(),
          'compute_capability': compute_capability(),
          'torch': torch.__version__,
          'cuda': torch.version.cuda}


def _start_nvcc(name: str, out: Path) -> subprocess.Popen:
  """One ``nvcc`` compiling ``name``'s source into ``out``."""
  cmd = [nvcc(), *NVCC_FLAGS, '-o', str(out), str(_source(name))]
  return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)


def _write_atomic(path: Path, payload: bytes) -> None:
  tmp = path.with_suffix(f'.{os.getpid()}.{threading.get_ident()}.tmp')
  tmp.write_bytes(payload)
  os.replace(tmp, path)


def _resolve_cache(aot_cache):
  if aot_cache == 'env':
    from .serving import aot_cache as aot_mod
    return aot_mod.from_env()
  return aot_cache


def build_all(names: Optional[Iterable[str]] = None, build_dir=None,
              aot_cache='env') -> Dict[str, dict]:
  """Make every named library present in ``build_dir`` (default
  `BUILD_DIR`): a library already there is kept; else a hit in
  ``aot_cache`` (``'env'``: ``GLT_AOT_CACHE_DIR``, None: no cache) is
  copied in; else ``nvcc`` builds it (one each, all started together)
  and the cache publishes it.  Returns ``{name: {'path', 'secs',
  'ptxas', 'source'}}`` with ``source`` one of ``present``,
  ``restored``, ``built``.  Raises RuntimeError with the compiler's
  output on failure."""
  return _build(names, build_dir, _resolve_cache(aot_cache), restore=True)


def _build(names, build_dir, cache, restore: bool) -> Dict[str, dict]:
  global NVCC_RUNS
  names = tuple(SOURCES if names is None else names)
  build_dir = Path(BUILD_DIR if build_dir is None else build_dir)
  build_dir.mkdir(parents=True, exist_ok=True)
  procs, info = {}, {}
  for name in names:
    path = _lib_path(name, build_dir)
    info[name] = {'path': str(path), 'secs': 0.0, 'ptxas': '',
                  'source': 'present'}
    if path.exists():
      continue
    fp = fingerprint(name) if cache is not None else None
    if fp is not None and restore:
      t0 = time.perf_counter()
      payload = cache.load(fp)
      if payload is not None:
        _write_atomic(path, payload)
        info[name].update(source='restored',
                          secs=time.perf_counter() - t0)
        continue
    tmp = path.with_suffix(f'.{os.getpid()}.{threading.get_ident()}.tmp')
    procs[name] = (_start_nvcc(name, tmp), tmp, path, time.perf_counter(),
                   fp)
    with _count_lock:
      NVCC_RUNS += 1
  failed = []
  for name, (proc, tmp, path, t0, fp) in procs.items():
    log, _ = proc.communicate()
    info[name].update(secs=time.perf_counter() - t0, ptxas=log or '')
    if proc.returncode != 0:
      failed.append(f'{_source(name).name} (nvcc exit {proc.returncode}):'
                    f'\n{log}')
      continue
    os.replace(tmp, path)       # atomic: a concurrent build sees all
    info[name]['source'] = 'built'
    if fp is not None:
      cache.save(fp, path.read_bytes())
  if failed:
    raise RuntimeError('CUDA kernel build failed:\n' + '\n'.join(failed))
  return info


def _load(path: str) -> ctypes.CDLL:
  return ctypes.CDLL(path)


def load_library(name: str) -> ctypes.CDLL:
  """``csrc/<name>.cu``'s library, built or restored by `build_all`
  into `BUILD_DIR`, loaded.  A restored library that fails to load is
  corrupt: it is removed and rebuilt with ``nvcc`` (which republishes
  it)."""
  cache = _resolve_cache('env')
  info = _build([name], None, cache, restore=True)[name]
  try:
    return _load(info['path'])
  except OSError as e:
    if info['source'] != 'restored':
      raise
    error = e
  from .serving.aot_cache import _tick, fingerprint_key
  from .telemetry.recorder import recorder
  os.unlink(info['path'])
  recorder.emit('aot.cache_miss', program=name,
                key=fingerprint_key(fingerprint(name)), reason='corrupt',
                error=f'{type(error).__name__}: {error}'[:200])
  _tick('aot.cache_misses_total')
  info = _build([name], None, cache, restore=False)[name]
  return _load(info['path'])


def kernel(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
  """The C entry point ``symbol`` of ``csrc/<name>.cu``, built and
  loaded on first use, with ``argtypes`` set (every pointer and the
  stream must be ``c_void_p``, or ctypes cuts them to 32 bits) and an
  int return (the ``cudaError_t`` of the launch)."""
  key = f'{name}:{symbol}'
  fn = _fns.get(key)
  if fn is not None:
    return fn
  with _lock:
    if key not in _fns:
      if not torch.cuda.is_available():
        raise RuntimeError(f'kernel {name} needs CUDA, which is not '
                           'available')
      if name not in _libs:
        _libs[name] = load_library(name)
      fn = getattr(_libs[name], symbol)
      fn.argtypes = list(argtypes)
      fn.restype = ctypes.c_int
      _fns[key] = fn
  return _fns[key]


def check(err: int, name: str) -> None:
  """Raise when a launch returned a CUDA error (a refused launch never
  runs, and `torch.cuda.synchronize` would not report it)."""
  if err != 0:
    raise RuntimeError(f'CUDA kernel {name} failed to launch: cudaError '
                       f'{err}')
