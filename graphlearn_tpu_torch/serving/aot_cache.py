"""A durable, fingerprinted store of the port's built kernel libraries.

The JAX package persists each serving bucket's compiled executable under
``GLT_AOT_CACHE_DIR`` so that a restarted or autoscaled replica does not
recompile.  A port replica compiles nothing per bucket (a dispatch is
eager torch); what a fresh process compiles is its kernels, one ``nvcc``
per ``csrc/*.cu`` (`_build`).  So the port's cache holds the built
shared libraries, keyed by everything that shapes one: the kernel name,
the sha256 of its source and headers, the ``nvcc`` flags and ``nvcc
--version``, the card's compute capability and the torch and CUDA
versions (`_build.fingerprint`).  `_build.build_all` asks the cache
before it runs ``nvcc`` and publishes what it builds.

The JAX cache's rules hold:

  * **atomic publish** — an entry is written to a same-directory tmp
    file and ``os.replace``'d into place: a reader (or a second process
    warming from the same directory) sees the whole entry or none;
  * **checksum** — every entry carries the sha256 of its payload; a
    torn or garbage file or a checksum mismatch is a miss (reason
    ``corrupt``) and the caller runs ``nvcc``, never loads bad bytes;
  * **stale skip** — the stored fingerprint is compared field for field
    with the requested one; a mismatch is a miss (reason ``stale``);
  * **write failures absorbed** — a failed save costs the next process
    an ``nvcc`` run, this one nothing.

An entry is one file ``<key>.aotx``: a magic line, one JSON header line
(format, fingerprint, sha256, size, saved_at) and the payload bytes.
Chaos site ``aot.cache`` (``op`` ``'save'`` / ``'load'``): ``fail``
raises into the absorbing arms; ``corrupt`` scrambles the payload after
its checksum is taken, so a later load meets a real bad entry.
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from pathlib import Path
from typing import Any, Dict, Optional

AOT_CACHE_DIR_ENV = 'GLT_AOT_CACHE_DIR'

#: entry format version (a bump stale-skips old files)
_FORMAT = 1
_MAGIC = b'GLT-AOT-LIB\n'


def cache_dir_from_env() -> Optional[str]:
  return os.environ.get(AOT_CACHE_DIR_ENV) or None


def from_env() -> Optional['AotExecutableCache']:
  """The process's cache, or None when ``GLT_AOT_CACHE_DIR`` is unset
  (the default: every fresh process runs ``nvcc``)."""
  d = cache_dir_from_env()
  return AotExecutableCache(d) if d else None


def fingerprint_key(fingerprint: Dict[str, Any]) -> str:
  """Stable file-name key of one fingerprint dict: sha256 over its
  sorted-key JSON (the fingerprint is also stored in the entry and
  compared on load, so a collision is a stale skip, not a wrong
  library)."""
  blob = json.dumps(fingerprint, sort_keys=True, default=repr)
  return hashlib.sha256(blob.encode()).hexdigest()[:32]


def _tick(name: str) -> None:
  from ..telemetry.live import live
  live.counter(name).inc()


class AotExecutableCache:
  """Directory of built kernel libraries, one file per fingerprint,
  shared safely between concurrent processes."""

  def __init__(self, root):
    self.root = Path(root)
    self.root.mkdir(parents=True, exist_ok=True)
    from ..telemetry.memaccount import register_tier

    def _aot_bytes():
      try:
        return sum(p.stat().st_size for p in self.root.glob('*.aotx'))
      except OSError:
        return 0

    register_tier('aot', _aot_bytes)

  def path(self, fingerprint: Dict[str, Any]) -> Path:
    return self.root / f'{fingerprint_key(fingerprint)}.aotx'

  # -- read side ------------------------------------------------------------
  def load(self, fingerprint: Dict[str, Any]) -> Optional[bytes]:
    """The payload stored for ``fingerprint``; None on an absent,
    unreadable, corrupt or stale entry (one ``aot.cache_miss`` event
    with the reason — the caller runs ``nvcc``)."""
    from ..telemetry.recorder import recorder
    from ..testing import chaos
    key = fingerprint_key(fingerprint)
    program = fingerprint.get('program')
    path = self.root / f'{key}.aotx'
    t0 = time.perf_counter()

    def miss(reason: str) -> None:
      recorder.emit('aot.cache_miss', program=program, key=key,
                    reason=reason)
      _tick('aot.cache_misses_total')

    try:
      chaos.aot_cache_faults('load')
      blob = path.read_bytes()
    except chaos.InjectedFault:
      miss('unreadable')
      return None
    except FileNotFoundError:
      miss('absent')
      return None
    except OSError:
      miss('unreadable')
      return None
    try:
      if not blob.startswith(_MAGIC):
        raise ValueError('no entry header')
      head_end = blob.index(b'\n', len(_MAGIC))
      head = json.loads(blob[len(_MAGIC):head_end])
      payload = blob[head_end + 1:]
      stored_fp, stored_sha = head['fingerprint'], head['sha256']
      fmt, size = head['format'], head['size']
    except (ValueError, KeyError, TypeError):
      miss('corrupt')                # torn or garbage file
      return None
    if fmt != _FORMAT or stored_fp != fingerprint:
      miss('stale')
      return None
    if (size != len(payload)
        or hashlib.sha256(payload).hexdigest() != stored_sha):
      miss('corrupt')
      return None
    recorder.emit('aot.cache_hit', program=program, key=key,
                  secs=round(time.perf_counter() - t0, 6))
    _tick('aot.cache_hits_total')
    return payload

  # -- write side -----------------------------------------------------------
  def save(self, fingerprint: Dict[str, Any], payload: bytes) -> bool:
    """Publish ``payload`` atomically under ``fingerprint``.  Returns
    False, absorbing the error, on any failure."""
    from ..testing import chaos
    path = self.path(fingerprint)
    tmp = path.with_name(f'{path.name}.tmp.{os.getpid()}')
    try:
      actions = chaos.aot_cache_faults('save')
      payload = bytes(payload)
      head = {'format': _FORMAT, 'fingerprint': fingerprint,
              'sha256': hashlib.sha256(payload).hexdigest(),
              'size': len(payload), 'saved_at': time.time()}
      if 'corrupt' in actions:
        # scrambled after the checksum is taken: a durable bad entry
        buf = bytearray(payload)
        buf[::7] = bytes(b ^ 0xFF for b in buf[::7])
        payload = bytes(buf)
      tmp.write_bytes(_MAGIC + json.dumps(head, sort_keys=True).encode()
                      + b'\n' + payload)
      os.replace(tmp, path)
      return True
    except (OSError, TypeError, chaos.InjectedFault):   # absorbed
      try:
        tmp.unlink(missing_ok=True)
      except OSError:
        pass
      return False

  def entries(self) -> list:
    return sorted(p.name for p in self.root.glob('*.aotx'))
