"""The kernel-build cache (`serving.aot_cache`, `_build.build_all`): the
contracts of ``tests/test_aot_cache.py`` on the port's libraries, with a
stub compiler (this machine has no ``nvcc``) that writes a recognisable
library per source and counts as an ``nvcc`` run.

A "second process" is a fresh, empty build directory over the same
cache directory: a build there that runs no compiler can only come from
the cache.  `fingerprint_key` must equal the JAX package's for the same
fingerprint dict.
"""
import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch

from graphlearn_tpu.serving import aot_cache as jax_aot
from graphlearn_tpu_torch import _build
from graphlearn_tpu_torch.serving import (AotExecutableCache, ServingEngine,
                                          aot_cache)
from graphlearn_tpu_torch.telemetry import recorder
from graphlearn_tpu_torch.telemetry.live import live
from graphlearn_tpu_torch.testing import chaos
from test_torch_serving import BUCKETS, FANOUTS, _port_dataset

ALL = len(_build.SOURCES)


class _Proc:
  returncode = 0

  def communicate(self):
    return ('ptxas info: stub', None)


class _Failed(_Proc):
  returncode = 1

  def communicate(self):
    return ('error: stub compiler refused', None)


def _stub_lib(name):
  return b'LIB:' + name.encode() + b':' + hashlib.sha256(
      _build._source_bytes(name)).hexdigest().encode()


@pytest.fixture(autouse=True)
def stub_compiler(monkeypatch):
  """``nvcc`` replaced by a writer of ``_stub_lib(name)``; a library
  loads when its bytes start with ``LIB:``."""
  def start(name, out):
    Path(out).write_bytes(_stub_lib(name))
    return _Proc()

  def load(path):
    data = Path(path).read_bytes()
    if not data.startswith(b'LIB:'):
      raise OSError(f'{path}: invalid ELF header')
    return data

  monkeypatch.setattr(_build, '_start_nvcc', start)
  monkeypatch.setattr(_build, '_load', load)
  monkeypatch.setattr(_build, 'nvcc_version', lambda: 'stub nvcc 12.8')
  monkeypatch.setattr(_build, 'compute_capability', lambda: [9, 0])
  monkeypatch.delenv(aot_cache.AOT_CACHE_DIR_ENV, raising=False)
  chaos.uninstall()
  recorder.enable()
  recorder.clear()
  yield
  chaos.uninstall()
  recorder.clear()
  recorder.disable()


def _build_in(build_dir, cache, names=None):
  """(info, nvcc runs) of one build into ``build_dir``."""
  before = _build.NVCC_RUNS
  info = _build.build_all(names, build_dir=build_dir, aot_cache=cache)
  return info, _build.NVCC_RUNS - before


def _reasons():
  return [e['reason'] for e in recorder.events('aot.cache_miss')]


def test_second_process_restores_every_library(tmp_path):
  """The warm-start pin: a fresh build directory over a populated cache
  runs no compiler and gets byte-identical libraries."""
  cache = AotExecutableCache(tmp_path / 'cache')
  info1, runs1 = _build_in(tmp_path / 'b1', cache)
  assert runs1 == ALL and len(cache.entries()) == ALL
  assert {v['source'] for v in info1.values()} == {'built'}
  assert _reasons() == ['absent'] * ALL
  recorder.clear()
  info2, runs2 = _build_in(tmp_path / 'b2', cache)
  assert runs2 == 0
  assert {v['source'] for v in info2.values()} == {'restored'}
  assert len(recorder.events('aot.cache_hit')) == ALL
  for name in _build.SOURCES:
    assert (Path(info2[name]['path']).read_bytes()
            == Path(info1[name]['path']).read_bytes() == _stub_lib(name))
  info3, runs3 = _build_in(tmp_path / 'b2', cache)
  assert runs3 == 0 and {v['source'] for v in info3.values()} == {'present'}
  assert live.counter('aot.cache_hits_total').value() >= ALL


def test_env_knob_routes_builds_through_cache(tmp_path, monkeypatch):
  monkeypatch.setenv(aot_cache.AOT_CACHE_DIR_ENV, str(tmp_path / 'env'))
  _, runs = _build_in(tmp_path / 'b1', 'env')
  assert runs == ALL
  assert len(AotExecutableCache(tmp_path / 'env').entries()) == ALL
  _, runs = _build_in(tmp_path / 'b2', 'env')
  assert runs == 0
  monkeypatch.delenv(aot_cache.AOT_CACHE_DIR_ENV)
  assert aot_cache.from_env() is None
  _, runs = _build_in(tmp_path / 'b3', 'env')       # no cache: nvcc again
  assert runs == ALL


def test_corrupt_entry_falls_back_to_nvcc_and_republishes(tmp_path):
  cache = AotExecutableCache(tmp_path / 'cache')
  _build_in(tmp_path / 'b1', cache)
  fp = _build.fingerprint('gather_rows')
  path = cache.path(fp)
  blob = bytearray(path.read_bytes())
  blob[-3:] = bytes(b ^ 0xAA for b in blob[-3:])   # payload bytes only
  path.write_bytes(bytes(blob))
  recorder.clear()
  info, runs = _build_in(tmp_path / 'b2', cache)
  assert runs == 1 and info['gather_rows']['source'] == 'built'
  assert _reasons() == ['corrupt']
  assert Path(info['gather_rows']['path']).read_bytes() == \
      _stub_lib('gather_rows')
  assert cache.load(fp) == _stub_lib('gather_rows')   # republished


def test_garbage_file_and_stale_fingerprint_skip(tmp_path):
  cache = AotExecutableCache(tmp_path / 'cache')
  _build_in(tmp_path / 'b1', cache)
  cache.path(_build.fingerprint('sample_one_hop')).write_bytes(
      b'not an entry at all')
  stale = dict(_build.fingerprint('push_rows'), torch='0.0')
  # an entry stored under push_rows' key whose fingerprint has drifted
  victim = cache.path(_build.fingerprint('push_rows'))
  cache.save(stale, _stub_lib('push_rows'))
  victim.write_bytes(cache.path(stale).read_bytes())
  recorder.clear()
  info, runs = _build_in(tmp_path / 'b2', cache)
  assert runs == 2
  assert sorted(_reasons()) == ['corrupt', 'stale']
  assert info['sample_one_hop']['source'] == 'built'


def test_other_toolchain_is_another_library(tmp_path, monkeypatch):
  """A different ``nvcc`` (or card, torch, flags, source) keys another
  entry: nothing is restored across it."""
  cache = AotExecutableCache(tmp_path / 'cache')
  _build_in(tmp_path / 'b1', cache)
  monkeypatch.setattr(_build, 'nvcc_version', lambda: 'stub nvcc 13.0')
  _, runs = _build_in(tmp_path / 'b2', cache)
  assert runs == ALL and len(cache.entries()) == 2 * ALL
  monkeypatch.setattr(_build, 'compute_capability', lambda: [10, 0])
  _, runs = _build_in(tmp_path / 'b3', cache)
  assert runs == ALL and len(cache.entries()) == 3 * ALL


def test_chaos_fail_write_absorbed(tmp_path):
  chaos.install('aot.cache:fail:1:op=save;aot.cache:fail:2:op=save')
  cache = AotExecutableCache(tmp_path / 'cache')
  _, runs = _build_in(tmp_path / 'b1', cache, names=['push_rows',
                                                     'gather_rows'])
  assert runs == 2 and cache.entries() == []
  assert not list((tmp_path / 'cache').glob('*.tmp.*'))
  chaos.uninstall()
  _, runs = _build_in(tmp_path / 'b2', cache, names=['push_rows'])
  assert runs == 1                             # the cache was never fed


def test_chaos_fail_read_is_a_miss(tmp_path):
  cache = AotExecutableCache(tmp_path / 'cache')
  _build_in(tmp_path / 'b1', cache, names=['push_rows'])
  chaos.install('aot.cache:fail:1:op=load')
  recorder.clear()
  _, runs = _build_in(tmp_path / 'b2', cache, names=['push_rows'])
  assert runs == 1 and _reasons() == ['unreadable']


def test_chaos_corrupt_write_caught_on_later_load(tmp_path):
  chaos.install({'faults': [{'site': 'aot.cache', 'action': 'corrupt',
                             'op': 'save', 'nth': 1, 'count': 99}]})
  cache = AotExecutableCache(tmp_path / 'cache')
  _build_in(tmp_path / 'b1', cache)
  assert len(cache.entries()) == ALL           # published, but bad
  chaos.uninstall()
  recorder.clear()
  info, runs = _build_in(tmp_path / 'b2', cache)
  assert runs == ALL and _reasons() == ['corrupt'] * ALL
  assert all(Path(v['path']).read_bytes().startswith(b'LIB:')
             for v in info.values())


def test_atomic_publish_leaves_no_tmp(tmp_path):
  cache = AotExecutableCache(tmp_path / 'cache')
  _build_in(tmp_path / 'b1', cache)
  names = [p.name for p in (tmp_path / 'cache').iterdir()]
  assert len(names) == ALL and all(n.endswith('.aotx') for n in names)
  assert all(p.suffix == '.so' for p in (tmp_path / 'b1').iterdir())
  gauge = live.snapshot()['memory.tier_bytes{tier=aot}']
  assert gauge == sum(p.stat().st_size
                      for p in (tmp_path / 'cache').iterdir())


def test_restored_library_that_fails_to_load_is_rebuilt(tmp_path,
                                                       monkeypatch):
  """Skip-to-rebuild extends to load time: a restored library whose
  bytes pass the checksum but do not load is removed, rebuilt with
  nvcc and republished, with one ``aot.cache_miss`` (corrupt)."""
  monkeypatch.setenv(aot_cache.AOT_CACHE_DIR_ENV, str(tmp_path / 'cache'))
  monkeypatch.setattr(_build, 'BUILD_DIR', tmp_path / 'b2')
  cache = AotExecutableCache(tmp_path / 'cache')
  _build_in(tmp_path / 'b1', cache, names=['push_rows'])
  fp = _build.fingerprint('push_rows')
  assert cache.save(fp, b'\x7fELF truncated')      # a sound entry of junk
  recorder.clear()
  before = _build.NVCC_RUNS
  lib = _build.load_library('push_rows')
  assert lib == _stub_lib('push_rows')
  assert _build.NVCC_RUNS - before == 1
  assert len(recorder.events('aot.cache_hit')) == 1
  assert _reasons() == ['corrupt']
  assert cache.load(fp) == _stub_lib('push_rows')


def test_library_that_was_built_and_fails_to_load_raises(tmp_path,
                                                         monkeypatch):
  monkeypatch.setattr(_build, '_start_nvcc', lambda name, out: (
      Path(out).write_bytes(b'junk'), _Proc())[1])
  monkeypatch.setattr(_build, 'BUILD_DIR', tmp_path / 'b')
  with pytest.raises(OSError):
    _build.load_library('push_rows')


def test_failed_compile_raises_and_publishes_nothing(tmp_path, monkeypatch):
  monkeypatch.setattr(_build, '_start_nvcc', lambda name, out: _Failed())
  cache = AotExecutableCache(tmp_path / 'cache')
  with pytest.raises(RuntimeError, match='stub compiler refused'):
    _build_in(tmp_path / 'b1', cache, names=['push_rows'])
  assert cache.entries() == []


def test_fingerprint_key_matches_jax():
  for fp in (_build.fingerprint('gather_rows'),
             {'program': 'x', 'cap': 4, 'avals': ['(4,):int32'],
              'nested': {'b': [1, 2], 'a': None}},
             {}):
    assert aot_cache.fingerprint_key(fp) == jax_aot.fingerprint_key(fp)
  fp = _build.fingerprint('gather_rows')
  assert fp['nvcc_flags'] == list(_build.NVCC_FLAGS)
  assert fp['compute_capability'] == [9, 0]
  assert fp['torch'] == torch.__version__
  assert aot_cache.fingerprint_key(fp) != aot_cache.fingerprint_key(
      _build.fingerprint('push_rows'))


def test_engine_counts_nvcc_runs_since_it_was_built(tmp_path):
  """`compile_count` is the warm pin: an engine made before a build
  counts its nvcc runs, one made after counts none.  On the CPU the
  warmup builds nothing."""
  eng = ServingEngine(_port_dataset(), FANOUTS, seed=1, buckets=BUCKETS,
                      device='cpu')
  w = eng.warmup(aot_cache=AotExecutableCache(tmp_path / 'cache'))
  assert w['compiles'] == 0 and w['aot_restored'] == 0
  assert all(w['buckets'].values())
  _build_in(tmp_path / 'b1', None)
  assert eng.compile_count() == ALL
  later = ServingEngine(_port_dataset(), FANOUTS, seed=1, buckets=BUCKETS,
                        device='cpu')
  assert later.compile_count() == 0
  st = later.compile_status()
  assert st['compiles'] == 0 and st['model_version'] == 0
  assert np.array_equal(eng.infer([3, 5]).nodes, later.infer([3, 5]).nodes)
