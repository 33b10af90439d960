"""The offline telemetry tools: the port's `telemetry.export`,
`telemetry.report`, `telemetry.sink` and `telemetry.regress` against the
JAX package's.

One recorder trace (nested spans, serving requests and sheds, resilience
events) written as JSON lines by the port's recorder loads in both
packages and gives equal Chrome traces, equal span tables and an equal
CLI output.  The regression gate gives equal verdicts, report text and
return codes on the same artifact and baseline: a first run bootstraps
the baseline (0), an equal run passes (0), a guarded metric 30% worse
fails (1), a corrupt baseline cannot be gated (2), and the tracing-cost
line is pinned at 1.05 against a fixed 1.0.  `sink.summary_line` is
equal, and both import-light modules load by file path with torch
unavailable.  Every file goes under ``tmp_path``.
"""
import contextlib
import copy
import importlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

jexport = importlib.import_module('graphlearn_tpu.telemetry.export')
jreport = importlib.import_module('graphlearn_tpu.telemetry.report')
jregress = importlib.import_module('graphlearn_tpu.telemetry.regress')
jsink = importlib.import_module('graphlearn_tpu.telemetry.sink')
pexport = importlib.import_module('graphlearn_tpu_torch.telemetry.export')
preport = importlib.import_module('graphlearn_tpu_torch.telemetry.report')
pregress = importlib.import_module('graphlearn_tpu_torch.telemetry.regress')
psink = importlib.import_module('graphlearn_tpu_torch.telemetry.sink')
prec = importlib.import_module('graphlearn_tpu_torch.telemetry.recorder')
PKG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'graphlearn_tpu_torch', 'telemetry')


@pytest.fixture(scope='module')
def trace(tmp_path_factory):
  """A JSON-lines trace the port's recorder wrote."""
  from graphlearn_tpu_torch.telemetry import span
  path = str(tmp_path_factory.mktemp('trace') / 'flight.jsonl')
  rec = prec.recorder
  rec.enable(path)
  rec.clear()
  rng = np.random.default_rng(0)
  try:
    for b in range(4):
      with span('batch', scope='DistNeighborLoader', batch=b + 1):
        with span('sample.exchange', step=b + 1, batch=64):
          pass
        with span('feature.lookup', step=b + 1):
          pass
        with span('stitch'):
          pass
    for i in range(12):
      rec.emit('serving.request', seeds=int(rng.integers(1, 4)), bucket=4,
               coalesced=2, ok=bool(i % 5), latency_ms=float(
                   rng.exponential(3.0)))
    rec.emit('serving.shed', reason='deadline', seeds=1, queue_depth=3)
    rec.emit('serving.failover', replica='r0', event='redrive',
             state='dead', redriven=1)
    rec.emit('snapshot.save', path='x', step=3, ok=True, secs=0.01)
  finally:
    rec.disable()
  return path


def test_chrome_trace_equal_to_jax(trace):
  jev, pev = jexport.load_events(trace), pexport.load_events(trace)
  assert pev == jev
  assert json.dumps(pexport.to_chrome_trace(pev), sort_keys=True) == \
      json.dumps(jexport.to_chrome_trace(jev), sort_keys=True)
  assert pexport.span_durations(pev) == jexport.span_durations(jev)
  assert pexport.span_children(pev) == jexport.span_children(jev)
  x = [e for e in pexport.to_chrome_trace(pev)['traceEvents']
       if e.get('ph') == 'X']
  assert len(x) == 16


def test_report_tables_equal_to_jax(trace):
  ev = pexport.load_events(trace)
  ph, jh = preport.histograms_from_events(ev), jreport.histograms_from_events(
      ev)
  table = preport.format_table(ph)
  assert table == jreport.format_table(jh)
  for stage in ('batch', 'sample.exchange', 'feature.lookup', 'stitch'):
    assert stage in table
  assert preport.format_table(ph, baseline=ph) == \
      jreport.format_table(jh, baseline=jh)
  assert preport.format_serving_table(ev) == jreport.format_serving_table(ev)
  assert preport.format_resilience_table(ev) == \
      jreport.format_resilience_table(ev)
  assert preport.serving_percentiles(ev) == jreport.serving_percentiles(ev)


def _run_main(mod, argv):
  out = io.StringIO()
  with contextlib.redirect_stdout(out):
    rc = mod.main(argv)
  return rc, out.getvalue()


def test_report_main_equal_to_jax(trace, tmp_path):
  outs = []
  for name, mod in (('jax', jreport), ('port', preport)):
    chrome = str(tmp_path / f'{name}.json')
    rc, text = _run_main(mod, [trace, '--chrome', chrome])
    outs.append((rc, text.replace(chrome, 'OUT'),
                 json.load(open(chrome))))
  assert outs[0] == outs[1]
  assert outs[1][0] == 0
  # the module runs as a CLI
  res = subprocess.run([sys.executable, '-m',
                        'graphlearn_tpu_torch.telemetry.report', trace],
                       capture_output=True, text=True, timeout=120,
                       cwd=os.path.dirname(os.path.dirname(PKG)))
  assert res.returncode == 0 and 'sample.exchange' in res.stdout


def _artifact():
  return {'metric': 'epoch_secs', 'value': 1.25,
          'dist': {'seeds_per_sec': 81234.5,
                   'serving': {'p99_ms': 12.5, 'qps': 950.0,
                               'fleet_qps': 2400.0,
                               'failover_failed_requests': 0,
                               'tracing_overhead_ratio': 1.02,
                               'fleet_headroom_qps': 310.0},
                   'scale_envelope': [
                       {'num_parts': 16, 'padding_waste_pct': 41.0,
                        'seeds_per_sec': 52000.0},
                       {'num_parts': 64, 'padding_waste_pct': 63.0,
                        'seeds_per_sec': 21000.0}]}}


def _gate(mod, art, base_path):
  verdict, rc = mod.check(art, base_path)
  verdict = dict(verdict)
  return rc, verdict, mod.format_report(verdict), mod.summary(verdict)


def test_regress_verdicts_equal_to_jax(tmp_path):
  art = _artifact()
  worse = copy.deepcopy(art)
  worse['dist']['serving']['p99_ms'] *= 1.3         # 30% slower
  costly = copy.deepcopy(art)
  costly['dist']['serving']['tracing_overhead_ratio'] = 1.06
  no_headroom = copy.deepcopy(art)
  del no_headroom['dist']['serving']['fleet_headroom_qps']
  cases = [('bootstrap', art, 0), ('pass', art, 0), ('slower', worse, 1),
           ('tracing', costly, 1), ('headroom', no_headroom, 1)]
  results = {}
  for name, mod in (('jax', jregress), ('port', pregress)):
    base = str(tmp_path / f'{name}_baseline.json')
    seen = []
    for case, a, want in cases:
      rc, verdict, text, summ = _gate(mod, a, base)
      assert rc == want, (name, case, text)
      seen.append((case, rc, {k: v for k, v in verdict.items()
                              if k != 'baseline_path'},
                   text.replace(base, 'BASE'), summ))
    with open(base, 'w') as f:
      f.write('{not json')
    rc, verdict, text, summ = _gate(mod, art, base)
    seen.append(('corrupt', rc, verdict['status'],
                 text.replace(base, 'BASE'), summ))
    results[name] = seen
  assert results['port'] == results['jax']
  by_case = {c[0]: c for c in results['port']}
  assert by_case['bootstrap'][4] == 'BASELINE_CREATED'
  assert by_case['slower'][4].startswith('FAIL dist.serving.p99_ms +30.0%')
  assert by_case['tracing'][4].startswith(
      'FAIL dist.serving.tracing_overhead_ratio +6.0%')
  assert by_case['corrupt'][1] == 2
  rows = {m['key']: m for m in by_case['pass'][2]['metrics']}
  pinned = rows['dist.serving.tracing_overhead_ratio']
  assert pinned['baseline'] == 1.0 and pinned['status'] == 'ok'
  assert rows['dist.scale_envelope.p16.seeds_per_sec']['status'] == 'ok'


def test_regress_main_equal_to_jax(tmp_path):
  art = tmp_path / 'artifact.json'
  art.write_text(json.dumps(_artifact()))
  outs = []
  for name, mod in (('jax', jregress), ('port', pregress)):
    base = str(tmp_path / f'{name}.json')
    runs = []
    for argv in ([str(art), base], [str(art), base, '--threshold', '0.1'],
                 [str(tmp_path / 'missing.json'), base]):
      rc, text = _run_main(mod, argv)
      runs.append((rc, text.replace(base, 'BASE')))
    outs.append(runs)
  assert outs[0] == outs[1]
  assert [r[0] for r in outs[1]] == [0, 0, 2]


def test_sink_summary_and_artifact_equal_to_jax(tmp_path):
  art = _artifact()
  art['regression'] = 'PASS'
  art['filler'] = ['x' * 50] * 80
  for limit in (2000, 120, 40):
    got = psink.summary_line(art, artifact='A.json', limit=limit)
    assert got == jsink.summary_line(art, artifact='A.json', limit=limit)
    assert len(got) <= limit
  paths = []
  for name, mod in (('jax', jsink), ('port', psink)):
    p = mod.write_artifact(art, str(tmp_path / f'{name}.json'))
    mod.append_record({'row': 1}, str(tmp_path / f'{name}.jsonl'))
    paths.append((json.load(open(p)), open(
        tmp_path / f'{name}.jsonl').read()))
  assert paths[0] == paths[1]


@pytest.mark.parametrize('module', ['sink', 'regress'])
def test_loads_by_file_path_without_torch(module, tmp_path):
  """A bench script loads the module by its path with no torch importable."""
  code = (
      'import importlib.util, json, sys\n'
      'sys.modules["torch"] = None\n'
      'sys.modules["numpy"] = None\n'
      f'spec = importlib.util.spec_from_file_location("m", {os.path.join(PKG, module + ".py")!r})\n'
      'm = importlib.util.module_from_spec(spec)\n'
      'spec.loader.exec_module(m)\n'
      'print(json.dumps(sorted(k for k, v in sys.modules.items() '
      'if v is not None and k.startswith(("torch", "graphlearn")))))\n')
  res = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, timeout=60, cwd=str(tmp_path))
  assert res.returncode == 0, res.stderr
  assert json.loads(res.stdout) == []
