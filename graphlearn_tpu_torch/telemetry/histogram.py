"""Fixed-bucket log2 latency histograms, mergeable by summing keys.

The port's copy of the JAX package's `telemetry/histogram.py`.  One
histogram per span kind: bucket ``b`` counts latencies in
``[2^(b-1), 2^b)`` microseconds (bucket 0 is the sub-microsecond
underflow, the last bucket absorbs overflow).  The bucket count is
FIXED (`NUM_BUCKETS`) so two histograms always align, and the encoding
is a flat ``{key: count}`` dict in the global `Metrics` store
(``span.<kind>.hist.b<ii>`` + ``.count`` / ``.secs``), so two
snapshots merge by summing per key; :func:`from_snapshot` decodes a
snapshot back into `Histogram` objects for the report CLI.

Recording costs two dict increments and a bit_length — cheap enough
for the per-batch host path (`spans.span` only records when the flight
recorder is on).
"""
from __future__ import annotations

from typing import Dict, List, Optional

#: fixed bucket count: bucket 27's upper edge is 2^27 us ~ 134 s,
#: beyond any per-batch stage this layer times; longer spans land in
#: the overflow bucket (quantiles then report its upper edge, ~134 s).
NUM_BUCKETS = 28

#: metric-key layout (the wire format of the cross-host merge)
KEY_PREFIX = 'span.'
HIST_SEP = '.hist.'


def bucket_index(secs: float) -> int:
  """Log2 bucket of a latency: 0 for < 1 us, else
  ``floor(log2(us)) + 1``, clamped to the fixed bucket range."""
  us = int(secs * 1e6)
  if us <= 0:
    return 0
  return min(us.bit_length(), NUM_BUCKETS - 1)


def bucket_upper_edge_secs(idx: int) -> float:
  """Upper edge of bucket ``idx`` in seconds (2^idx microseconds)."""
  return (1 << idx) / 1e6


def record(kind: str, secs: float, registry=None) -> None:
  """Tick one latency into ``kind``'s histogram in the metrics
  registry (the global one by default).  The three keys of one
  observation go through ``inc_many`` (one lock acquisition) so a
  concurrent snapshot — the live ops scrape — can never see a torn
  histogram (``count != sum(buckets)``)."""
  if registry is None:
    from .live import metrics
    registry = metrics
  base = f'{KEY_PREFIX}{kind}{HIST_SEP}'
  pairs = ((f'{base}b{bucket_index(secs):02d}', 1.0),
           (f'{base}count', 1.0), (f'{base}secs', secs))
  inc_many = getattr(registry, 'inc_many', None)
  if inc_many is not None:
    inc_many(pairs)
  else:                           # bare-Metrics lookalikes in tests
    for k, v in pairs:
      registry.inc(k, v)


class Histogram:
  """Decoded per-kind latency histogram (counts + total seconds)."""

  def __init__(self, kind: str,
               buckets: Optional[List[float]] = None,
               count: float = 0.0, secs: float = 0.0):
    self.kind = kind
    self.buckets = list(buckets) if buckets else [0.0] * NUM_BUCKETS
    if len(self.buckets) != NUM_BUCKETS:
      self.buckets += [0.0] * (NUM_BUCKETS - len(self.buckets))
    self.count = count
    self.secs = secs

  def add(self, secs: float) -> None:
    self.buckets[bucket_index(secs)] += 1
    self.count += 1
    self.secs += secs

  def merge(self, other: 'Histogram') -> 'Histogram':
    """Element-wise sum (the same op `gather_metrics` performs on the
    flat encoding) — histograms merge exactly, unlike quantiles."""
    for i, c in enumerate(other.buckets):
      self.buckets[i] += c
    self.count += other.count
    self.secs += other.secs
    return self

  def quantile(self, q: float) -> float:
    """Approximate quantile in seconds: the upper edge of the bucket
    where the cumulative count crosses ``q * count`` (log2-bounded
    error — a 2x envelope, which is what stage attribution needs)."""
    if self.count <= 0:
      return 0.0
    target = q * self.count
    run = 0.0
    for i, c in enumerate(self.buckets):
      run += c
      if run >= target:
        return bucket_upper_edge_secs(i)
    return bucket_upper_edge_secs(NUM_BUCKETS - 1)

  @property
  def mean(self) -> float:
    return self.secs / self.count if self.count else 0.0

  def to_flat(self) -> Dict[str, float]:
    """Flat ``{metric_key: value}`` encoding (inverse of
    :func:`from_snapshot`)."""
    base = f'{KEY_PREFIX}{self.kind}{HIST_SEP}'
    out = {f'{base}b{i:02d}': c
           for i, c in enumerate(self.buckets) if c}
    out[f'{base}count'] = self.count
    out[f'{base}secs'] = self.secs
    return out


def from_snapshot(snap: Dict[str, float]) -> Dict[str, Histogram]:
  """Decode a metrics snapshot (or a `gather_metrics` ``aggregate``
  dict) into ``{kind: Histogram}``.  Keys not matching the
  ``span.<kind>.hist.*`` layout are ignored, so the full registry
  snapshot can be passed as-is."""
  out: Dict[str, Histogram] = {}
  for key, val in snap.items():
    if not key.startswith(KEY_PREFIX) or HIST_SEP not in key:
      continue
    head, leaf = key.rsplit(HIST_SEP, 1)
    kind = head[len(KEY_PREFIX):]
    h = out.setdefault(kind, Histogram(kind))
    if leaf == 'count':
      h.count = val
    elif leaf == 'secs':
      h.secs = val
    elif leaf.startswith('b'):
      try:
        idx = int(leaf[1:])
      except ValueError:
        continue
      if 0 <= idx < NUM_BUCKETS:
        h.buckets[idx] = val
  return out
