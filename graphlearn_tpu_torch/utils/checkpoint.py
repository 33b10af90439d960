"""Checkpoints of train state and the data plane (the JAX package's
`utils/checkpoint.py`, over numpy and pickle only).

  * `Checkpointer` — step-indexed trees under one directory, the newest
    ``max_to_keep`` kept.  ``restore(template=)`` VALIDATES the loaded
    tree against the template (structure, per-leaf dtype and shape) and
    raises `CheckpointMismatchError` naming the first diverging path: a
    stale checkpoint must fail loudly, not restore garbage.
  * the **DataPlaneState protocol** and `SnapshotManager` — durable
    mid-epoch snapshots of every stateful data-plane component (batcher
    cursors and their RNGs, sampler step counters, cold-cache rings,
    fused-epoch chunk progress), so a preempted process resumes with
    byte-identical remaining batches.

A tree is nested dicts, lists and tuples whose leaves are numpy arrays
or scalars (torch CPU tensors are taken through ``np.asarray``).
`_flatten` turns it into ``[(path, leaf), ...]``; the leaves go into one
``leaves.npz`` and the paths into ``paths.pkl``.  A path names a leaf
in JAX's ``keystr`` form (``['plane']['batcher']['rng']``, ``[0]`` for a
list entry), so the port and JAX report the same first diverging path
for the same trees; dict keys are visited in sorted order, as JAX
flattens them.

DataPlaneState protocol (duck-typed):

  * ``state_dict() -> dict`` — a tree of numpy-compatible leaves (packed
    bytes via `pack_rng_state` / `pack_bytes`) capturing everything
    needed to resume;
  * ``load_state_dict(state) -> None`` — restore from such a tree (leaves
    come back as 0-d numpy arrays; coerce with ``int()``).

Usage::

    ckpt = Checkpointer('/ckpts/run1')
    ckpt.save(step, tree)                   # keeps the newest K
    tree = ckpt.restore(template=tree)      # None if empty
    step = ckpt.latest_step()

    snap = SnapshotManager('/ckpts/run1/plane', every=2)
    fused.attach_snapshots(snap)            # saves at chunk boundaries
    # after a preemption, in a fresh process:
    fused.attach_snapshots(SnapshotManager('/ckpts/run1/plane'))
    fused.restore_from_snapshot()           # loads model + optimizer
    fused.run()                             # finishes the epoch

Each save is written to ``step_<n>.tmp`` and renamed to ``step_<n>``
(atomic publish): a kill mid-write leaves the previous snapshot as the
durable latest.  The ``checkpoint.io`` chaos seam fires inside the
write (``fail``: nothing lands; ``truncate``: a partial tmp, then death
before the rename).

Env knobs: ``GLT_SNAPSHOT_DIR`` (the default snapshot root: drivers that
were not handed a manager build one from it), ``GLT_SNAPSHOT_EVERY``
(chunk boundaries between saves, default 1).
"""
from __future__ import annotations

import os
import pickle
import shutil
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

SNAPSHOT_DIR_ENV = 'GLT_SNAPSHOT_DIR'
SNAPSHOT_EVERY_ENV = 'GLT_SNAPSHOT_EVERY'


class CheckpointMismatchError(ValueError):
  """A restored checkpoint does not match the caller's template: the
  tree structure differs, or a leaf's dtype or shape diverges.  ``path``
  names the first diverging tree path."""

  def __init__(self, msg: str, path: str = ''):
    super().__init__(msg)
    self.path = path


# -- trees --------------------------------------------------------------------

def _keys(d: dict) -> list:
  try:
    return sorted(d)
  except TypeError:
    return list(d)


def _entry(kind: str, key) -> str:
  """One path element in JAX's ``keystr`` form."""
  return f'[{key!r}]' if kind == 'd' else f'[{key}]'


def _flatten(tree: Any, prefix: Tuple = (), empties: bool = False
             ) -> List[Tuple[Tuple, Any]]:
  """A tree -> ``[(path, leaf), ...]`` in JAX's flatten order; a path is a
  tuple of ``(kind, key)`` pairs, kind ``'d'`` (dict), ``'l'`` (list) or
  ``'t'`` (tuple).  None is an empty subtree, as in JAX.  With
  ``empties`` an empty container is kept as a zero-size leaf under the
  path element ``('e', kind)``, so it survives a save."""
  if isinstance(tree, (dict, list, tuple)):
    kind = ('d' if isinstance(tree, dict) else
            'l' if isinstance(tree, list) else 't')
    if not tree:
      return ([(prefix + (('e', kind),), np.zeros(0, np.uint8))]
              if empties else [])
    keys = _keys(tree) if kind == 'd' else range(len(tree))
    out = []
    for k in keys:
      out.extend(_flatten(tree[k], prefix + ((kind, k),), empties))
    return out
  if tree is None:
    return []
  return [(prefix, tree)]


def _unflatten(items: List[Tuple[Tuple, Any]]) -> Any:
  empty = {'d': dict, 'l': list, 't': tuple}
  if len(items) == 1 and len(items[0][0]) <= 1:
    path, leaf = items[0]
    if not path:
      return leaf
    if path[0][0] == 'e':
      return empty[path[0][1]]()
  root: Dict = {}
  kinds: Dict[int, str] = {}
  for path, leaf in items:
    if path[-1][0] == 'e':
      path, leaf = path[:-1], empty[path[-1][1]]()
    node = root
    for depth, (kind, key) in enumerate(path):
      kinds[id(node)] = kind
      if depth == len(path) - 1:
        node[key] = leaf
      else:
        node = node.setdefault(key, {})

  def build(node):
    if not isinstance(node, dict) or id(node) not in kinds:
      return node
    kind = kinds[id(node)]
    if kind == 'd':
      return {k: build(v) for k, v in node.items()}
    seq = [build(node[i]) for i in sorted(node)]
    return seq if kind == 'l' else tuple(seq)
  return build(root)


def _structure(tree: Any):
  """A hashable signature of a tree's containers (JAX's treedef
  equality: container types, dict keys, sequence lengths)."""
  if isinstance(tree, dict):
    return ('d', tuple((k, _structure(tree[k])) for k in _keys(tree)))
  if isinstance(tree, (list, tuple)):
    return ('l' if isinstance(tree, list) else 't',
            tuple(_structure(v) for v in tree))
  if tree is None:
    return None
  return '*'


def _leaf_paths(tree: Any) -> Dict[str, Any]:
  return {''.join(_entry(k, key) for k, key in path): leaf
          for path, leaf in _flatten(tree)}


def validate_tree(restored: Any, template: Any) -> None:
  """Raise `CheckpointMismatchError` (first diverging path) unless
  ``restored`` matches ``template`` in structure and per-leaf dtype and
  shape.  Scalar against 0-d array is tolerated (a snapshot brings
  python ints back as 0-d arrays)."""
  if _structure(restored) != _structure(template):
    r_paths = set(_leaf_paths(restored))
    t_paths = set(_leaf_paths(template))
    diverging = sorted((r_paths - t_paths) | (t_paths - r_paths))
    path = diverging[0] if diverging else '<root>'
    raise CheckpointMismatchError(
        f'checkpoint tree structure does not match the template (first '
        f'diverging path: {path}; checkpoint has {len(r_paths)} leaves, '
        f'template {len(t_paths)})', path=path)
  r_leaves = _leaf_paths(restored)
  for path, t_leaf in _leaf_paths(template).items():
    r_arr, t_arr = np.asarray(r_leaves[path]), np.asarray(t_leaf)
    if r_arr.shape != t_arr.shape:
      raise CheckpointMismatchError(
          f'checkpoint leaf {path} has shape {r_arr.shape}, template '
          f'expects {t_arr.shape}', path=path)
    if r_arr.dtype != t_arr.dtype:
      raise CheckpointMismatchError(
          f'checkpoint leaf {path} has dtype {r_arr.dtype}, template '
          f'expects {t_arr.dtype}', path=path)


def to_numpy(tree: Any) -> Any:
  """Every leaf of ``tree`` as a numpy array (torch tensors are copied to
  the host)."""
  if isinstance(tree, dict):
    return {k: to_numpy(v) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return type(tree)(to_numpy(v) for v in tree)
  if tree is None:
    return None
  if hasattr(tree, 'detach'):                  # a torch tensor
    return tree.detach().cpu().numpy()
  return np.asarray(tree)


def pack_bytes(obj: Any) -> np.ndarray:
  """Pickle a host object into a uint8 array, so it rides a numpy-leaf
  tree (an RNG state holds 128-bit ints numpy cannot hold)."""
  return np.frombuffer(pickle.dumps(obj, protocol=5), np.uint8).copy()


def unpack_bytes(arr) -> Any:
  return pickle.loads(np.asarray(arr, np.uint8).tobytes())


def pack_rng_state(rng: np.random.Generator) -> np.ndarray:
  """A numpy Generator's whole bit-generator state as one leaf."""
  return pack_bytes(rng.bit_generator.state)


def restore_rng_state(rng: np.random.Generator, packed) -> None:
  rng.bit_generator.state = unpack_bytes(packed)


# -- the store ---------------------------------------------------------------

class Checkpointer:
  """Step-indexed trees under one directory (created on the first save),
  keeping the newest ``max_to_keep``."""

  def __init__(self, directory, max_to_keep: int = 3):
    self.directory = Path(directory)
    self.max_to_keep = max(int(max_to_keep), 1)

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

  def latest_step(self) -> Optional[int]:
    steps = self.all_steps()
    return steps[-1] if steps else None

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
    items = _flatten(to_numpy(tree), empties=True)
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
    for s in self.all_steps()[:-self.max_to_keep]:
      shutil.rmtree(self._step_dir(s), ignore_errors=True)
    return d

  def restore(self, template: Any = None,
              step: Optional[int] = None) -> Optional[Any]:
    """Load the given (default: the newest) step; None when there is
    none.  With ``template`` the tree is validated against it
    (`validate_tree`)."""
    step = step if step is not None else self.latest_step()
    if step is None:
      return None
    d = self._step_dir(step)
    with open(d / 'paths.pkl', 'rb') as f:
      paths = pickle.load(f)
    with np.load(d / 'leaves.npz') as data:
      leaves = [data[f'l{i}'] for i in range(len(paths))]
    out = _unflatten(list(zip(paths, leaves)))
    if template is not None:
      validate_tree(out, to_numpy(template))
    return out


# -- data-plane snapshots -----------------------------------------------------

def snapshot_dir_from_env() -> Optional[str]:
  """``GLT_SNAPSHOT_DIR``: the opt-in that lets a driver build its own
  `SnapshotManager` when none was attached."""
  return os.environ.get(SNAPSHOT_DIR_ENV) or None


def snapshot_every_from_env(default: int = 1) -> int:
  try:
    return max(int(os.environ.get(SNAPSHOT_EVERY_ENV, default)), 1)
  except ValueError:
    return default


class SnapshotManager:
  """Durable snapshots for one job: one directory and a save cadence
  (``every`` boundaries between saves, default ``GLT_SNAPSHOT_EVERY``).
  A payload is ``{'plane': <component states>, 'progress': <the epoch
  and chunk cursor, partial stats>, 'train': <model and optimizer
  state>}``, written through `Checkpointer`; the snapshot index is the
  Checkpointer step, so `restore_latest` reads the newest published
  one.

  A FAILED save (disk full, an injected ``checkpoint.io`` fault) is
  absorbed: `save` returns False and the failure lands in telemetry —
  losing one snapshot's durability must not kill what it protects.
  """

  def __init__(self, directory=None, every: Optional[int] = None,
               max_to_keep: int = 2):
    directory = directory or snapshot_dir_from_env()
    if directory is None:
      raise ValueError('SnapshotManager needs a directory (argument or '
                       f'{SNAPSHOT_DIR_ENV})')
    self._ckpt = Checkpointer(directory, max_to_keep=max_to_keep)
    self.every = (max(int(every), 1) if every is not None
                  else snapshot_every_from_env())
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

  def save(self, plane: dict, progress: dict, train: Any = None) -> bool:
    """Write one snapshot; returns False (and records the failure)
    instead of raising when the write fails."""
    from ..telemetry.live import metrics
    from ..telemetry.recorder import recorder
    payload = {'plane': plane, 'progress': progress}
    if train is not None:
      payload['train'] = train
    self._save_idx += 1
    t0 = time.perf_counter()
    try:
      self._ckpt.save(self._save_idx, payload)
    except OSError as e:
      metrics.inc('snapshot.save_failures_total')
      recorder.emit('snapshot.save', index=self._save_idx, ok=False,
                    error=str(e), dir=str(self.directory))
      return False
    self._last_save_mono = time.monotonic()
    metrics.inc('snapshot.saves_total')
    recorder.emit('snapshot.save', index=self._save_idx, ok=True,
                  secs=round(time.perf_counter() - t0, 4),
                  dir=str(self.directory), epoch=_scalar(progress.get(
                      'epoch')), next_chunk=_scalar(progress.get(
                          'next_chunk')))
    return True

  def restore_latest(self) -> Optional[dict]:
    """The newest READABLE snapshot payload (None when there is none).
    An unreadable newest snapshot is skipped for the next older one;
    only when every retained snapshot is unreadable does the newest
    error propagate."""
    from ..telemetry.recorder import recorder
    t0 = time.perf_counter()
    first_err = None
    for step in reversed(self._ckpt.all_steps()):
      try:
        out = self._ckpt.restore(step=step)
      except Exception as e:          # noqa: BLE001 — skip to older
        first_err = first_err if first_err is not None else e
        recorder.emit('snapshot.restore', index=step, ok=False,
                      dir=str(self.directory), error=repr(e))
        continue
      self._save_idx = step           # later saves continue the index
      self._last_restore_mono = time.monotonic()
      progress = out.get('progress', {}) if isinstance(out, dict) else {}
      recorder.emit('snapshot.restore', index=step, ok=True,
                    secs=round(time.perf_counter() - t0, 4),
                    dir=str(self.directory),
                    epoch=_scalar(progress.get('epoch')),
                    next_chunk=_scalar(progress.get('next_chunk')))
      return out
    if first_err is not None:
      raise first_err
    return None


def _scalar(v):
  """0-d-array-tolerant int coercion for progress fields."""
  if v is None:
    return None
  return int(np.asarray(v))
