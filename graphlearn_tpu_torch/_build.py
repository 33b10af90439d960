"""Build the port's CUDA sources (``csrc/*.cu``) and load them.

Each source is compiled by ``nvcc`` into its own shared library with a
plain C interface, for ``sm_90a`` (Hopper), on first CUDA use, and
loaded with `ctypes`.  The build directory is ``build/glt_torch/``
beside the package (gitignored); a library's file name
carries a hash of its source and flags, so an edited source is rebuilt
and a stale library is never loaded.  `build_all` starts one ``nvcc``
per source, all at once.
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
           'merge_ranks', 'csr_window_gather', 'push_rows')
NVCC_FLAGS = ('-gencode=arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas=-v')

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, ctypes._CFuncPtr] = {}


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


def _lib_path(name: str) -> Path:
  src = (CSRC / f'{name}.cu').read_bytes()
  for hdr in sorted(CSRC.glob('*.cuh')):
    src += hdr.read_bytes()
  tag = hashlib.sha256(src + ' '.join(NVCC_FLAGS).encode()).hexdigest()
  return BUILD_DIR / f'{name}-{tag[:16]}.so'


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
  """Compile every named source that has no up-to-date library, one
  ``nvcc`` each, all started together.  Returns ``{name: {'path',
  'secs', 'ptxas'}}`` (``secs`` 0 for a library that was already
  built).  Raises RuntimeError with the compiler's output on failure."""
  names = tuple(SOURCES if names is None else names)
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  procs, info = {}, {}
  for name in names:
    path = _lib_path(name)
    info[name] = {'path': str(path), 'secs': 0.0, 'ptxas': ''}
    if path.exists():
      continue
    tmp = path.with_suffix(f'.{os.getpid()}.{threading.get_ident()}.tmp')
    cmd = [nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')]
    procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True),
                   tmp, path, time.perf_counter())
  failed = []
  for name, (proc, tmp, path, t0) in procs.items():
    log, _ = proc.communicate()
    info[name]['secs'] = time.perf_counter() - t0
    info[name]['ptxas'] = log
    if proc.returncode != 0:
      failed.append(f'{name}.cu (nvcc exit {proc.returncode}):\n{log}')
      continue
    os.replace(tmp, path)       # atomic: a concurrent build sees all
  if failed:
    raise RuntimeError('CUDA kernel build failed:\n' + '\n'.join(failed))
  return info


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
        _libs[name] = ctypes.CDLL(build_all([name])[name]['path'])
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
