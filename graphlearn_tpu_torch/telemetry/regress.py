"""Bench regression gate: artifact vs baseline.

The port's copy of the JAX package's `telemetry/regress.py`, with the
same metric table and verdicts.  It compares the
freshly written ``BENCH_ARTIFACT.json`` against a committed
``BENCH_BASELINE.json`` and FAILS (nonzero) with a per-metric report
when any headline metric regresses past a threshold (default 20%).
On the FIRST run — the bench trajectory starts empty — the artifact
itself becomes the baseline (verdict ``BASELINE_CREATED``), so the
gate bootstraps without manual setup; commit the baseline file to pin
it.

Deliberately import-light (json/os only), like `sink.py`: a bench script can
load it directly by file path without importing torch or the package.
Also a CLI::

    python graphlearn_tpu_torch/telemetry/regress.py ARTIFACT [BASELINE]
        [--threshold 0.2] [--update-baseline]

Env overrides: ``GLT_BENCH_BASELINE`` (baseline path),
``GLT_REGRESS_THRESHOLD`` (fractional slowdown tolerance).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

BASELINE_ENV = 'GLT_BENCH_BASELINE'
THRESHOLD_ENV = 'GLT_REGRESS_THRESHOLD'
DEFAULT_BASELINE = 'BENCH_BASELINE.json'
DEFAULT_THRESHOLD = 0.2

#: headline metrics the gate tracks: (dotted key, direction[, opts]).
#: 'lower' = smaller is better (times), 'higher' = bigger is better
#: (rates), 'present' = the key must exist as a number.  Keys absent
#: from either side are SKIPPED, not failed — phases degrade day to
#: day and a missing phase is not a regression.  The optional third
#: element is a per-metric options dict:
#:   'threshold'    — override the global slowdown tolerance
#:   'pin_baseline' — compare against a FIXED value instead of the
#:                    recorded baseline (absolute acceptance lines
#:                    that must not drift with the trajectory)
#:   'when'         — ('present' only) the guard applies only when
#:                    this other dotted key exists in the artifact
#:                    (i.e. the owning phase actually ran)
#:   'same'         — dotted context key (or tuple of keys) that must
#:                    hold the SAME value in artifact and baseline for
#:                    the comparison to apply; any mismatch SKIPS the
#:                    metric (e.g. rows measured under different
#:                    partitioners are not comparable — re-bootstrap
#:                    the baseline to re-arm the guard)
METRICS: Tuple[Tuple, ...] = (
    ('value', 'lower'),                       # the headline epoch time
    ('fused_epoch_secs', 'lower'),
    ('fused_epoch_secs_bf16', 'lower'),
    ('fused_hetero_epoch_secs', 'lower'),
    ('fused_subgraph_ms_per_step', 'lower'),
    ('train_step_mfu', 'higher'),
    ('dist.seeds_per_sec', 'higher'),
    ('dist.edges_per_sec_per_chip', 'higher'),
    # exchange-efficiency guard: the P=16 / P=64 rows of the
    # dist scale envelope — a PR that regresses padding waste or
    # throughput at scale fails the gate.  A 'pNN' path segment
    # selects the envelope row with num_parts == NN.
    ('dist.scale_envelope.p16.padding_waste_pct', 'lower'),
    ('dist.scale_envelope.p16.seeds_per_sec', 'higher'),
    ('dist.scale_envelope.p64.padding_waste_pct', 'lower'),
    ('dist.scale_envelope.p64.seeds_per_sec', 'higher'),
    # resilience guard: the host server->client loader path
    # WITH the retry/idempotency layer on, no faults injected — the
    # retry layer must not silently slow the fault-free hot path
    ('dist.chaos.fault_free_seeds_per_sec', 'higher'),
    # cold-cache guard: the tiered mesh-loader row — the
    # HBM victim cache + double-buffered cold overlay must keep the
    # tiered store's throughput and its on-device cache hit rate from
    # silently regressing back to the static-split numbers
    ('dist.tiered.seeds_per_sec', 'higher'),
    ('dist.feature.cache_hit_rate', 'higher'),
    # cache-aware sampling guard: the GNS-on tiered row —
    # the sampler-side bias must keep beating the budget/universe
    # hit-rate ceiling AND hold the tiered throughput line (a PR that
    # silently un-biases the sampler or taxes the biased step fails
    # here, not in a notebook)
    ('dist.gns.cache_hit_rate', 'higher'),
    ('dist.gns.seeds_per_sec', 'higher'),
    # preemption-resume guard: restoring a mid-epoch
    # snapshot and re-entering the epoch must stay cheap — a resume
    # that re-executes half the epoch (replayed_batches creeping up)
    # or a restore path that grew a slow sync would erode exactly the
    # recovery-time story the snapshot layer exists for
    ('dist.resume.restore_secs', 'lower'),
    ('dist.resume.replayed_batches', 'lower'),
    # the snapshot-overhead acceptance line: snapshotting throughput
    # over the same run's no-snapshot line (~1.0 when saves are in
    # the noise).  Guarded as a positive RATIO, not the signed
    # overhead pct, whose healthy baseline straddles zero (the
    # cur/base slowdown math inverts on a negative baseline).
    ('dist.resume.snap_over_nosnap_ratio', 'higher'),
    # online-serving guard: the Zipf open-loop traffic row
    # (bench_serving.py) — tail latency and sustained completion rate
    # of the coalescing tier must not silently erode (shed_rate is
    # reported in the artifact; a healthy baseline of 0 makes it
    # ungateable by ratio, so the latency/throughput pair carries the
    # guard)
    ('dist.serving.p99_ms', 'lower'),
    ('dist.serving.qps', 'higher'),
    # fleet-failover guard: the kill-one-replica-mid-bench
    # acceptance run — sustained fleet completion rate must hold, and
    # failed/dropped requests must stay at the baseline (0: a zero
    # baseline skips here by the ratio rules, so the HARD zero-failure
    # gate is bench_serving's nonzero exit; this key catches drift
    # once any baseline records a nonzero count)
    ('dist.serving.fleet_qps', 'higher'),
    ('dist.serving.failover_failed_requests', 'lower'),
    # streaming-ingestion guard: the freshness-vs-
    # throughput open loop — sustained WAL->delta-CSR->publish
    # events/s must hold, and the serving p99 measured DURING
    # steady-state ingest must not erode (the zero-shed contract is
    # bench_ingest's nonzero exit, stamped into ingest_pin)
    ('dist.ingest.events_per_sec', 'higher'),
    ('dist.ingest.p99_during_ingest_ms', 'lower'),
    # elastic-failover guard: classification -> first
    # served batch must stay fast after a mid-epoch owner kill, and
    # the epoch must stay EXACTLY complete (1.0 — the hard
    # byte-identity/one-adoption gate is the worker's nonzero exit,
    # stamped into failover_pin)
    ('dist.failover.recovery_secs', 'lower'),
    ('dist.failover.completed_ratio', 'higher'),
    # traffic-attribution guard: the cross-partition byte
    # share at the P=16 envelope must not creep up (locality erosion
    # is invisible in throughput until it is not), and the top-K
    # hot-range coverage the GNS/exchange hotness export sees must
    # not collapse (a flat histogram means the sketch export lost the
    # skew signal the cold-tier placement feeds on)
    ('dist.attribution.cross_partition_bytes_frac', 'lower'),
    ('dist.attribution.hot_range_coverage', 'higher'),
    # locality co-design guard: the GLT_PARTITIONER=
    # locality envelope arm — the cross-partition byte share bought by
    # the relabel + replica set must not creep back toward random, and
    # the locality arm's throughput must hold its line.  Both guards
    # only compare rows measured under the SAME partitioner identity
    # ('same'): a baseline recorded under a different placement is
    # skipped, never silently ratcheted against
    ('dist.locality.cross_partition_bytes_frac', 'lower',
     {'same': 'dist.locality.partitioner'}),
    ('dist.locality.seeds_per_sec', 'higher',
     {'same': 'dist.locality.partitioner'}),
    # request-tracing guard: tracing-ON serve cost over
    # tracing-OFF on the same closed-loop schedule.  Pinned against a
    # FIXED 1.0 baseline with a 5% tolerance, so the gate reads
    # exactly "ratio <= 1.05" — a drifting recorded baseline must
    # never ratchet the acceptance line upward
    ('dist.serving.tracing_overhead_ratio', 'lower',
     {'threshold': 0.05, 'pin_baseline': 1.0}),
    # capacity-signal guard: whenever the fleet phase ran
    # at all, the replicas' EWMA capacity model must have exported a
    # live fleet.headroom_qps — the gauge's VALUE swings with load
    # (ungateable by ratio), but its absence means the autoscaler's
    # admission signal silently died
    ('dist.serving.fleet_headroom_qps', 'present',
     {'when': 'dist.serving.fleet_qps'}),
    # Pallas fused-pipeline guards (bench_pallas_sample.py):
    # the dispatcher-threaded FusedEpoch step with the kernels OFF —
    # the threading (window-table staging, trace-time dispatch)
    # must not tax the default path
    ('pallas.fused_step_ms', 'lower'),
    # the pinned-host zero-copy cold gather at split<1, pinned against
    # the FIXED untiered XLA gather line (1.355 GB/s) —
    # the tiered store must not fall back behind the line the pinned
    # buffer exists to beat.  Hardware-only: the bench stamps the key
    # None on CPU, so the guard skips cleanly there
    ('pallas.feature_lookup_gbps', 'higher', {'pin_baseline': 1.355}),
    # the host delta-CSR merge rate (platform-independent; the device
    # kernel row is reported alongside, unguarded until a TPU baseline
    # lands)
    ('pallas.delta_merge_events_per_sec', 'higher'),
    # elastic-autoscaling guards (bench_autoscale.py): the
    # diurnal open loop's p99 with the ElasticController closing the
    # loop must not erode vs its own history (the hold-vs-static gate
    # is the worker's nonzero exit, stamped into autoscale_pin)
    ('dist.autoscale.p99_held_ms', 'lower'),
    # SLO burn outside the chaos incident window, pinned against the
    # FIXED burn budget of 1.0 with zero tolerance — the gate reads
    # exactly "burn_max < 1 outside the incident", never a drifting
    # recorded baseline
    ('dist.autoscale.burn_max', 'lower',
     {'threshold': 0.0, 'pin_baseline': 1.0}),
    # planned-handoff degraded window, pinned to ZERO: cur/0.5 - 1
    # > 0 the moment even one batch degrades across the cutover —
    # the whole point of fence-then-one-bump is that this is 0, not
    # merely small
    ('dist.autoscale.handoff_degraded_batches', 'lower',
     {'threshold': 0.0, 'pin_baseline': 0.5}),
)


def baseline_path(path: Optional[str] = None) -> str:
  return path or os.environ.get(BASELINE_ENV) or DEFAULT_BASELINE


def threshold_from_env(default: float = DEFAULT_THRESHOLD) -> float:
  try:
    return float(os.environ.get(THRESHOLD_ENV, default))
  except ValueError:
    return default


def _walk(obj: Dict, dotted: str):
  cur = obj
  for part in dotted.split('.'):
    if isinstance(cur, list):
      # 'pNN' selects the list element whose num_parts == NN (the
      # scale-envelope row addressing used by the exchange guard)
      if not (part.startswith('p') and part[1:].isdigit()):
        return None
      want = int(part[1:])
      cur = next((r for r in cur if isinstance(r, dict)
                  and r.get('num_parts') == want), None)
      continue
    if not isinstance(cur, dict):
      return None
    cur = cur.get(part)
  return cur


def _get(obj: Dict, dotted: str):
  cur = _walk(obj, dotted)
  return cur if isinstance(cur, (int, float)) else None


def _context(obj: Dict, dotted: str):
  """A 'same'-clause context value: any scalar (strings included —
  partitioner identities are the motivating case)."""
  cur = _walk(obj, dotted)
  return cur if isinstance(cur, (str, int, float, bool)) else None


def compare(artifact: Dict, baseline: Dict,
            threshold: float = DEFAULT_THRESHOLD) -> Dict:
  """Per-metric comparison.  Returns a verdict dict::

      {'status': 'PASS'|'FAIL', 'threshold': 0.2,
       'metrics': [{'key', 'direction', 'current', 'baseline',
                    'change_pct', 'status'}, ...],
       'regressed': ['fused_epoch_secs', ...]}

  ``change_pct`` is signed so that POSITIVE always means SLOWER
  (time up, or rate down), regardless of direction.
  """
  rows: List[Dict] = []
  regressed: List[str] = []
  for entry in METRICS:
    key, direction = entry[0], entry[1]
    opts = entry[2] if len(entry) > 2 else {}
    thr = opts.get('threshold', threshold)
    cur = _get(artifact, key)
    same = opts.get('same')
    if same is not None:
      same_keys = (same,) if isinstance(same, str) else tuple(same)
      if any(_context(artifact, k) != _context(baseline, k)
             for k in same_keys):
        rows.append({'key': key, 'direction': direction,
                     'current': cur, 'baseline': _get(baseline, key),
                     'change_pct': None, 'status': 'skipped'})
        continue
    if direction == 'present':
      gate = opts.get('when')
      if gate is not None and _get(artifact, gate) is None:
        rows.append({'key': key, 'direction': direction,
                     'current': cur, 'baseline': _get(baseline, key),
                     'change_pct': None, 'status': 'skipped'})
        continue
      status = 'ok' if cur is not None else 'regressed'
      if status == 'regressed':
        regressed.append(key)
      rows.append({'key': key, 'direction': direction, 'current': cur,
                   'baseline': _get(baseline, key),
                   'change_pct': 0.0 if cur is not None else 100.0,
                   'status': status})
      continue
    base = opts.get('pin_baseline')
    if base is None:
      base = _get(baseline, key)
    if cur is None or base is None or base == 0:
      rows.append({'key': key, 'direction': direction, 'current': cur,
                   'baseline': base, 'change_pct': None,
                   'status': 'skipped'})
      continue
    if direction == 'lower':
      slowdown = cur / base - 1.0
    else:
      # a rate collapsing to 0 is a total regression; the slowdown is
      # CLAMPED finite so the verdict stays strict-JSON (an Infinity
      # token in the artifact would make the whole file unparseable —
      # the exact failure mode the sink exists to prevent)
      slowdown = min(base / cur - 1.0 if cur else 1e4, 1e4)
    status = 'regressed' if slowdown > thr else 'ok'
    if status == 'regressed':
      regressed.append(key)
    rows.append({'key': key, 'direction': direction, 'current': cur,
                 'baseline': base,
                 'change_pct': round(100.0 * slowdown, 2),
                 'status': status})
  return {'status': 'FAIL' if regressed else 'PASS',
          'threshold': threshold, 'metrics': rows,
          'regressed': regressed}


def format_report(verdict: Dict) -> str:
  """Human-readable per-metric report (every line names its key, so a
  FAIL is actionable from the log alone)."""
  lines = [f"bench regression gate: {verdict['status']} "
           f"(threshold {verdict['threshold'] * 100:.0f}%)"]
  if verdict.get('baseline_created'):
    lines[0] = ('bench regression gate: BASELINE_CREATED '
                f"-> {verdict.get('baseline_path')} (first run; commit "
                'it to pin the trajectory)')
    if verdict.get('unguarded'):
      lines.append(
          '  WARNING: baseline lacks tracked metrics '
          f"{verdict['unguarded']} — these stay UNGUARDED until a "
          'complete run re-bootstraps (delete the baseline or pass '
          '--update-baseline after a full run)')
    return '\n'.join(lines)
  if verdict['status'] == 'ERROR':
    lines.append(f"  {verdict.get('error')}")
    return '\n'.join(lines)
  for m in verdict['metrics']:
    if m['status'] == 'skipped':
      lines.append(f"  [skip] {m['key']}: missing on one side "
                   f"(current={m['current']}, baseline={m['baseline']})")
      continue
    if m['direction'] == 'present':
      tag = 'FAIL' if m['status'] == 'regressed' else ' ok '
      state = ('MISSING (required while its phase ran)'
               if m['current'] is None else f"present ({m['current']})")
      lines.append(f"  [{tag}] {m['key']}: {state}")
      continue
    tag = 'FAIL' if m['status'] == 'regressed' else ' ok '
    lines.append(
        f"  [{tag}] {m['key']}: {m['current']} vs baseline "
        f"{m['baseline']} ({m['change_pct']:+.1f}% "
        f"{'slower' if m['change_pct'] >= 0 else 'faster'})")
  return '\n'.join(lines)


def summary(verdict: Dict) -> str:
  """Compact verdict for the artifact's bounded stdout summary line
  (`sink._SUMMARY_KEYS` carries it near the front)."""
  if verdict.get('baseline_created'):
    return 'BASELINE_CREATED'
  if verdict['status'] != 'FAIL':
    return verdict['status']
  worst = max((m for m in verdict['metrics']
               if m['status'] == 'regressed'),
              key=lambda m: m['change_pct'])
  return (f"FAIL {worst['key']} {worst['change_pct']:+.1f}%"
          + (f" (+{len(verdict['regressed']) - 1} more)"
             if len(verdict['regressed']) > 1 else ''))


def _write_json_atomic(path: str, obj: Dict) -> None:
  """tmp + rename, like the sink's artifact write: a kill mid-write
  must never leave a truncated baseline to poison every later gate."""
  import tempfile
  d = os.path.dirname(os.path.abspath(path))
  fd, tmp = tempfile.mkstemp(prefix='.bench_baseline.', dir=d)
  try:
    with os.fdopen(fd, 'w') as f:
      json.dump(obj, f, indent=1, sort_keys=True)
      f.write('\n')
    os.replace(tmp, path)
  except BaseException:
    try:
      os.unlink(tmp)
    except OSError:
      pass
    raise


def check(artifact, baseline: Optional[str] = None,
          threshold: Optional[float] = None,
          update_baseline: bool = False) -> Tuple[Dict, int]:
  """The gate: compare artifact vs baseline, return ``(verdict,
  exit_code)`` — 0 PASS / baseline bootstrapped, 1 regression, 2 the
  gate could not run.  ``artifact`` is the aggregate dict itself or a
  path to it (callers holding the fresh in-memory aggregate pass the
  dict, so a stale file on disk can never be gated by accident).

  A MISSING baseline is created from the artifact (first run — the
  intended bootstrap).  A CORRUPT baseline is rc 2, NOT recreated: a
  regressed run must never get to re-base the trajectory onto its own
  slow numbers through a conveniently broken file; fix or delete the
  baseline explicitly.  ``update_baseline`` rewrites it after a PASS
  (explicit re-basing)."""
  bp = baseline_path(baseline)
  thr = threshold_from_env() if threshold is None else float(threshold)
  if isinstance(artifact, dict):
    art = artifact
  else:
    with open(artifact) as f:
      art = json.load(f)
  if not os.path.exists(bp):
    _write_json_atomic(bp, art)
    # a partial first run (a crashed phase) pins a baseline with
    # holes, and compare() SKIPS keys missing from either side — name
    # the uncovered metrics loudly so the hole is a choice, not a
    # surprise (re-bootstrap from a complete run to close it)
    missing = [e[0] for e in METRICS if _get(art, e[0]) is None]
    return ({'status': 'PASS', 'baseline_created': True,
             'baseline_path': bp, 'threshold': thr, 'metrics': [],
             'regressed': [], 'unguarded': missing}, 0)
  try:
    with open(bp) as f:
      base = json.load(f)
  except (json.JSONDecodeError, ValueError) as e:
    return ({'status': 'ERROR', 'baseline_path': bp, 'threshold': thr,
             'metrics': [], 'regressed': [],
             'error': f'baseline is corrupt ({e}); fix or delete it '
                      'to re-bootstrap'}, 2)
  verdict = compare(art, base, thr)
  verdict['baseline_path'] = bp
  if update_baseline and verdict['status'] == 'PASS':
    _write_json_atomic(bp, art)
    verdict['baseline_updated'] = True
  return verdict, (1 if verdict['status'] == 'FAIL' else 0)


def main(argv: Optional[List[str]] = None) -> int:
  import argparse
  ap = argparse.ArgumentParser(
      description='Compare a bench artifact against the committed '
                  'baseline; exit 1 on regression.')
  ap.add_argument('artifact')
  ap.add_argument('baseline', nargs='?', default=None)
  ap.add_argument('--threshold', type=float, default=None,
                  help='fractional slowdown tolerance (default 0.2)')
  ap.add_argument('--update-baseline', action='store_true',
                  help='rewrite the baseline from this artifact after '
                       'a PASS')
  args = ap.parse_args(argv)
  try:
    verdict, rc = check(args.artifact, args.baseline,
                        threshold=args.threshold,
                        update_baseline=args.update_baseline)
  except (OSError, ValueError) as e:
    # infra failure (missing/corrupt artifact, unwritable baseline
    # dir) is rc 2, never rc 1 — a CI keying on the exit code must
    # not misread it as a perf regression
    print(f'bench regression gate: ERROR — could not run '
          f'({type(e).__name__}: {e})')
    return 2
  print(format_report(verdict))
  return rc


if __name__ == '__main__':
  import sys
  sys.exit(main())
