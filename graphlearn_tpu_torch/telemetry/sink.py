"""File-based bench artifact sink.

The port's copy of the JAX package's `telemetry/sink.py`.  A bench's
aggregate JSON on stdout can outgrow the tail a harness keeps, so the
FULL artifact goes to a file (:func:`write_artifact`, atomic tmp+rename) and stdout
carries only a short summary line (:func:`summary_line`) that is
guaranteed to fit the tail — it degrades by dropping optional keys, and
always names the artifact file it summarizes.

Deliberately import-light (json/os/tempfile only) so it can be loaded
DIRECTLY by file path, keeping a bench process free of the package
import chain and of torch.  Importing it as
`graphlearn_tpu_torch.telemetry.sink` still works but executes the
package ``__init__`` (and thus torch).
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, Optional

#: env override for the artifact file path.
ARTIFACT_ENV = 'GLT_BENCH_ARTIFACT'
DEFAULT_ARTIFACT = 'BENCH_ARTIFACT.json'

#: env override for the per-record JSONL sidecar the sweep benchmarks
#: append to (one line per configuration, across subprocesses).
RECORDS_ENV = 'GLT_BENCH_RECORDS'
DEFAULT_RECORDS = 'BENCH_ARTIFACT.jsonl'

#: a harness may keep only the last 2000 chars of stdout; the summary
#: stays well under it so the trailing newline (and any wrapper prefix)
#: can never push the line's leading '{' out of the tail window.
SUMMARY_LIMIT = 1900

#: summary key order: earlier keys survive when the line must shrink.
#: 'regression' (the bench gate's compact verdict, telemetry.regress)
#: sits right behind the headline so a FAIL stays visible even when
#: the line degrades to its minimum.
_SUMMARY_KEYS = (
    'metric', 'value', 'unit', 'regression', 'vs_baseline', 'protocol',
    'fused_epoch_secs', 'fused_vs_baseline', 'fused_layout',
    'epoch_secs_min_med_max', 'epoch_floor_secs',
    'sampled_edges_per_sec_M_min_med_max', 'train_step_mfu',
    'fused_epoch_secs_bf16', 'fused_hetero_epoch_secs',
    'fused_compile_secs', 'fused_error', 'fused_suspect_elision',
    'achieved_hbm_frac', 'sessions', 'steps_per_epoch',
)
#: dist sub-keys lifted into the summary (the full dist dict can be
#: arbitrarily large — scale-envelope rows etc. live in the artifact).
_DIST_KEYS = ('padding_waste_pct', 'drop_rate_pct', 'seeds_per_sec',
              'edges_per_sec_per_chip', 'num_parts', 'error')


def artifact_path(path: Optional[str] = None) -> str:
  return path or os.environ.get(ARTIFACT_ENV) or DEFAULT_ARTIFACT


def records_path(path: Optional[str] = None) -> str:
  return path or os.environ.get(RECORDS_ENV) or DEFAULT_RECORDS


def write_artifact(obj: Dict, path: Optional[str] = None) -> str:
  """Write the full artifact JSON atomically; returns the path.  A
  reader never sees a half-written file (tmp + os.replace), and a kill
  between phases leaves the previous complete artifact in place."""
  dest = artifact_path(path)
  d = os.path.dirname(os.path.abspath(dest))
  fd, tmp = tempfile.mkstemp(prefix='.bench_artifact.', dir=d)
  try:
    with os.fdopen(fd, 'w') as f:
      json.dump(obj, f, indent=1, sort_keys=True)
      f.write('\n')
    os.replace(tmp, dest)
  except BaseException:
    try:
      os.unlink(tmp)
    except OSError:
      pass
    raise
  return dest


def append_record(rec: Dict, path: Optional[str] = None) -> str:
  """Append one JSON line to the records sidecar (the sweep
  benchmarks' file artifact).  One write per line keeps concurrent
  sweep subprocesses line-atomic on POSIX."""
  dest = records_path(path)
  with open(dest, 'a') as f:
    f.write(json.dumps(rec) + '\n')
  return dest


def summary_line(art: Dict, artifact: Optional[str] = None,
                 limit: int = SUMMARY_LIMIT) -> str:
  """A one-line JSON summary of ``art`` guaranteed to be at most
  ``limit`` characters: headline keys in priority order, dropped from
  the tail until the line fits.  Always parseable; always carries
  ``artifact`` (the file holding the full JSON) when given."""
  picked = {}
  for k in _SUMMARY_KEYS:
    v = art.get(k)
    if v is not None:
      picked[k] = v
  dist = art.get('dist')
  if isinstance(dist, dict):
    dsum = {k: dist[k] for k in _DIST_KEYS if dist.get(k) is not None}
    if dsum:
      picked['dist'] = dsum
  if artifact is not None:
    picked['artifact'] = artifact
  line = json.dumps(picked)
  while len(line) > limit and picked:
    # drop the lowest-priority droppable key ('metric'/'value'/
    # 'regression'/'artifact' go last: they are the whole point of
    # the line — a regression FAIL must survive any degradation)
    order = [k for k in picked
             if k not in ('metric', 'value', 'regression', 'artifact')]
    victim = order[-1] if order else next(iter(picked))
    del picked[victim]
    line = json.dumps(picked)
  return line[:limit]
