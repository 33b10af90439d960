"""The event-kind and span-name registry of the port
(`graphlearn_tpu_torch/telemetry/schema.py`), checked statically in both
directions against both packages' sources.

Every ``<recorder>.emit('<kind>', ...)`` and every ``span('<name>', ...)``
/ ``tracer.span('<name>', ...)`` call in ``graphlearn_tpu_torch/`` is
registered in the port's `EVENT_KINDS` / `SPAN_NAMES`, with the JAX
package's text where JAX registers it too.  Every registered entry
without a call site in the port either stands in `NOT_EMITTED` with its
reason, or is emitted in the JAX package only by modules that ROADMAP
Queue 1 still lists (read from the JAX sources as text), so the table
cannot rot in either direction.
"""
import ast
import re
from collections import defaultdict
from pathlib import Path

from graphlearn_tpu.telemetry import schema as jax_schema
from graphlearn_tpu_torch.telemetry import schema

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / 'graphlearn_tpu_torch'
JAX = ROOT / 'graphlearn_tpu'


def call_sites(pkg: Path):
  """(kinds, spans, dynamic): literal first arguments of ``*.emit(...)``
  and ``span(...)`` / ``*.span(...)`` calls, by name -> {module}, and the
  calls whose first argument is not a literal."""
  kinds, spans = defaultdict(set), defaultdict(set)
  dynamic = []
  for path in sorted(pkg.rglob('*.py')):
    rel = str(path.relative_to(pkg))
    for node in ast.walk(ast.parse(path.read_text())):
      if not isinstance(node, ast.Call) or not node.args:
        continue
      f = node.func
      name = (f.attr if isinstance(f, ast.Attribute)
              else f.id if isinstance(f, ast.Name) else None)
      if name not in ('emit', 'span'):
        continue
      arg = node.args[0]
      if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        (kinds if name == 'emit' else spans)[arg.value].add(rel)
      elif name == 'emit' or isinstance(f, ast.Name):
        dynamic.append(f'{rel}:{node.lineno}')
  return kinds, spans, dynamic


def queue1_listed(mod: str) -> bool:
  """Whether ROADMAP Queue 1 names the JAX module ``mod`` (a path under
  ``graphlearn_tpu/``) or a directory holding it."""
  text = (ROOT / 'ROADMAP.md').read_text()
  q1 = text[text.index('### Queue 1'):text.index('### Queue 2')]
  for tok in re.findall(r'`([^`\s]+)`', q1):
    tok = tok.split(':')[0]
    tok = tok[len('graphlearn_tpu/'):] if tok.startswith(
        'graphlearn_tpu/') else tok
    if tok == mod or (tok.endswith('/') and mod.startswith(tok)):
      return True
  return False


PORT_KINDS, PORT_SPANS, PORT_DYNAMIC = call_sites(PORT)
JAX_KINDS, JAX_SPANS, _ = call_sites(JAX)


def test_every_emit_and_span_is_a_literal():
  # the tracer's own `span(self, name, ...)` method and the decorator
  # forward a caller's literal; nothing else may hide a kind
  assert PORT_DYNAMIC == [], PORT_DYNAMIC


def test_every_port_kind_registered_with_jax_text():
  assert PORT_KINDS, 'the scan found no emit call'
  for kind, mods in sorted(PORT_KINDS.items()):
    assert kind in schema.EVENT_KINDS, (kind, sorted(mods))
    if kind in jax_schema.EVENT_KINDS:
      assert schema.EVENT_KINDS[kind] == jax_schema.EVENT_KINDS[kind], kind


def test_every_port_span_registered_with_jax_text():
  expected = {'batch', 'sample.exchange', 'feature.lookup', 'stitch',
              'exchange.layout', 'exchange.stage', 'fused.epoch',
              'fused.dispatch', 'feature.cold_overlay', 'serving.infer',
              'serving.route', 'serving.queue_wait',
              'serving.dispatch_slice', 'serving.sample_collect',
              'serving.cold_fill'}
  assert expected <= set(PORT_SPANS)
  for name, mods in sorted(PORT_SPANS.items()):
    assert name in schema.SPAN_NAMES, (name, sorted(mods))
    if name in jax_schema.SPAN_NAMES:
      assert schema.SPAN_NAMES[name] == jax_schema.SPAN_NAMES[name], name


def test_jax_tables_copied_verbatim():
  for table, jtable in ((schema.EVENT_KINDS, jax_schema.EVENT_KINDS),
                        (schema.SPAN_NAMES, jax_schema.SPAN_NAMES),
                        (schema.METRIC_LABELS, jax_schema.METRIC_LABELS)):
    assert {k: table[k] for k in jtable} == jtable
  port_only = set(schema.EVENT_KINDS) - set(jax_schema.EVENT_KINDS)
  assert port_only == {'stream.publish'}
  assert set(schema.SPAN_NAMES) == set(jax_schema.SPAN_NAMES)
  assert schema.registered('stream.publish')


def _unemitted(table, port_sites, jax_sites):
  missing = {}
  for name in table:
    if name in port_sites:
      continue
    if name in schema.NOT_EMITTED:
      continue
    mods = sorted(jax_sites.get(name, ()))
    missing[name] = [m for m in mods if not queue1_listed(m)]
  return missing


def test_unemitted_kinds_come_from_unported_jax_modules():
  left = _unemitted(schema.EVENT_KINDS, PORT_KINDS, JAX_KINDS)
  assert left, 'every kind emitted: the host runtime landed?'
  for kind, unlisted in left.items():
    assert kind in JAX_KINDS, f'{kind}: registered, emitted nowhere'
    assert unlisted == [], (
        f'{kind} is emitted by JAX modules {unlisted} that ROADMAP Queue 1 '
        'no longer lists: port the emitter or list the module')


def test_unemitted_spans_come_from_unported_jax_modules():
  left = _unemitted(schema.SPAN_NAMES, PORT_SPANS, JAX_SPANS)
  for name, unlisted in left.items():
    assert name in JAX_SPANS, f'{name}: registered, opened nowhere'
    assert unlisted == [], (name, unlisted)


def test_not_emitted_entries_stay_true():
  for name, reason in schema.NOT_EMITTED.items():
    assert reason
    assert name in schema.EVENT_KINDS or name in schema.SPAN_NAMES
    assert name not in PORT_KINDS and name not in PORT_SPANS, name
    assert name in JAX_KINDS or name in JAX_SPANS, name
