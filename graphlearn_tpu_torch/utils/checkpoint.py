"""Durable data-plane snapshots: `SnapshotManager`.

The port's copy of the snapshot half of the JAX package's
`utils/checkpoint.py`, over numpy and pickle only.  A snapshot payload
is a tree of nested dicts whose leaves are numpy arrays or scalars (the
DataPlaneState protocol: ``state_dict()`` / ``load_state_dict()``).
`_flatten` turns it into ``{path: leaf}``; the leaves go into one
``leaves.npz`` and the paths into ``paths.pkl``.

Each save is written to ``step_<n>.tmp`` and renamed to ``step_<n>``
(atomic publish): a kill mid-write leaves the previous snapshot as the
durable latest.  The ``checkpoint.io`` chaos seam fires inside the
write (``fail``: nothing lands; ``truncate``: a partial tmp, then
death before the rename).
"""
from __future__ import annotations

import pickle
import shutil
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

#: published snapshots kept (an unreadable newest falls back to the
#: one before it)
_KEEP = 2


def _flatten(tree: Any, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
  """Nested dicts -> ``[(key path, leaf), ...]`` in insertion order."""
  if isinstance(tree, dict):
    out = []
    for k, v in tree.items():
      out.extend(_flatten(v, prefix + (k,)))
    return out
  return [(prefix, np.asarray(tree))]


def _unflatten(items: List[Tuple[Tuple, Any]]) -> Any:
  if len(items) == 1 and items[0][0] == ():
    return items[0][1]
  root: Dict = {}
  for path, leaf in items:
    node = root
    for k in path[:-1]:
      node = node.setdefault(k, {})
    node[path[-1]] = leaf
  return root


class Checkpointer:
  """Step-indexed snapshots of a nested-dict tree under one directory,
  keeping the newest `_KEEP`."""

  def __init__(self, directory):
    self.directory = Path(directory)

  def _step_dir(self, step: int) -> Path:
    return self.directory / f'step_{int(step):012d}'

  def all_steps(self) -> List[int]:
    if not self.directory.exists():
      return []
    out = []
    for p in self.directory.iterdir():
      if p.name.startswith('step_') and p.suffix != '.tmp':
        try:
          out.append(int(p.name[5:]))
        except ValueError:
          continue
    return sorted(out)

  def save(self, step: int, tree: Any) -> Path:
    from ..testing import chaos
    self.directory.mkdir(parents=True, exist_ok=True)
    d = self._step_dir(step)
    tmp = d.with_suffix('.tmp')
    if tmp.exists():
      shutil.rmtree(tmp)
    faults = chaos.on('checkpoint.io', step=int(step),
                      path=str(self.directory))
    if any(f.action == 'fail' for f in faults):
      raise OSError(f'injected checkpoint write failure (step {step})')
    items = _flatten(tree)
    tmp.mkdir(parents=True)
    np.savez(tmp / 'leaves.npz',
             **{f'l{i}': leaf for i, (_, leaf) in enumerate(items)})
    with open(tmp / 'paths.pkl', 'wb') as f:
      pickle.dump([path for path, _ in items], f, protocol=5)
    if any(f.action == 'truncate' for f in faults):
      with open(tmp / 'leaves.npz', 'r+b') as f:
        f.truncate(max(f.seek(0, 2) // 2, 1))
      raise OSError(f'injected truncated checkpoint write (step {step})')
    if d.exists():
      shutil.rmtree(d)
    tmp.rename(d)                      # atomic publish
    for s in self.all_steps()[:-_KEEP]:
      shutil.rmtree(self._step_dir(s), ignore_errors=True)
    return d

  def restore(self, step: int) -> Any:
    d = self._step_dir(step)
    with open(d / 'paths.pkl', 'rb') as f:
      paths = pickle.load(f)
    with np.load(d / 'leaves.npz') as data:
      leaves = [data[f'l{i}'] for i in range(len(paths))]
    return _unflatten(list(zip(paths, leaves)))


class SnapshotManager:
  """Durable snapshots ``{'plane': ..., 'progress': ...}`` for one
  owner, every ``every`` boundaries (`due`).

  A FAILED save (disk full, an injected ``checkpoint.io`` fault) is
  absorbed: `save` returns False and the failure lands in telemetry —
  losing one snapshot's durability must not kill what it protects.
  """

  def __init__(self, directory, every: int = 1):
    self._ckpt = Checkpointer(directory)
    self.every = max(int(every), 1)
    self._save_idx = 0
    self._boundaries = 0
    self._last_save_mono: Optional[float] = None
    self._last_restore_mono: Optional[float] = None
    from ..telemetry.live import live
    # bound methods pinned once: close()'s fn-identity check compares
    # against these exact objects
    self._age_fns = (self._save_age, self._restore_age)
    live.gauge('snapshot.save_age_seconds', fn=self._age_fns[0])
    live.gauge('snapshot.restore_age_seconds', fn=self._age_fns[1])

  def close(self) -> None:
    """Unregister this manager's age gauges (a newer manager's gauges
    survive an old one's close)."""
    from ..telemetry.live import live
    live.unregister_gauge('snapshot.save_age_seconds', fn=self._age_fns[0])
    live.unregister_gauge('snapshot.restore_age_seconds',
                          fn=self._age_fns[1])

  def _save_age(self) -> Optional[float]:
    if self._last_save_mono is None:
      return None
    return round(time.monotonic() - self._last_save_mono, 3)

  def _restore_age(self) -> Optional[float]:
    if self._last_restore_mono is None:
      return None
    return round(time.monotonic() - self._last_restore_mono, 3)

  @property
  def directory(self) -> Path:
    return self._ckpt.directory

  def due(self) -> bool:
    """Tick one boundary; True when this boundary should save (every
    Nth, counting from the first)."""
    due = self._boundaries % self.every == 0
    self._boundaries += 1
    return due

  def save(self, plane: dict, progress: dict) -> bool:
    """Write one snapshot; returns False (and records the failure)
    instead of raising when the write fails."""
    from ..telemetry.live import metrics
    from ..telemetry.recorder import recorder
    self._save_idx += 1
    t0 = time.perf_counter()
    try:
      self._ckpt.save(self._save_idx, {'plane': plane,
                                       'progress': progress})
    except OSError as e:
      metrics.inc('snapshot.save_failures_total')
      recorder.emit('snapshot.save', index=self._save_idx, ok=False,
                    error=str(e), dir=str(self.directory))
      return False
    self._last_save_mono = time.monotonic()
    metrics.inc('snapshot.saves_total')
    recorder.emit('snapshot.save', index=self._save_idx, ok=True,
                  secs=round(time.perf_counter() - t0, 4),
                  dir=str(self.directory))
    return True

  def restore_latest(self) -> Optional[dict]:
    """The newest READABLE snapshot payload (None when there is none).
    An unreadable newest snapshot is skipped for the next older one;
    only when every retained snapshot is unreadable does the newest
    error propagate."""
    from ..telemetry.recorder import recorder
    first_err = None
    for step in reversed(self._ckpt.all_steps()):
      try:
        out = self._ckpt.restore(step)
      except Exception as e:          # noqa: BLE001 — skip to older
        first_err = first_err if first_err is not None else e
        recorder.emit('snapshot.restore', index=step, ok=False,
                      dir=str(self.directory), error=repr(e))
        continue
      self._save_idx = step           # later saves continue the index
      self._last_restore_mono = time.monotonic()
      recorder.emit('snapshot.restore', index=step, ok=True,
                    dir=str(self.directory))
      return out
    if first_err is not None:
      raise first_err
    return None
