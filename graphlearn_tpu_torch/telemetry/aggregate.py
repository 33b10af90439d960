"""Derived exchange health from the mesh loader's counters: the port's
copy of the JAX package's `telemetry/aggregate.py::exchange_summary`
(the rest of that module gathers host snapshots across processes, which
the port's one-process mesh does not need)."""
from __future__ import annotations

from typing import Dict


def exchange_summary(stats: Dict[str, float]) -> Dict[str, float]:
  """Derived exchange health from a ``dist.*`` counter dict (the
  `exchange_stats` key vocabulary): padding waste and drop rate per
  loss channel, and the cold tier's hit rate when it saw lookups."""
  def g(k):
    return float(stats.get(k, 0))

  fr_off, fr_drop = g('dist.frontier.offered'), g('dist.frontier.dropped')
  fr_slots = g('dist.frontier.slots')
  ft_off, ft_drop = g('dist.feature.offered'), g('dist.feature.dropped')
  ft_slots = g('dist.feature.slots')
  sent_fr = fr_off - fr_drop
  sent_ft = ft_off - ft_drop
  out = {
      'frontier_padding_waste_pct': round(
          100.0 * (1 - sent_fr / fr_slots), 4) if fr_slots else None,
      'frontier_drop_rate_pct': round(
          100.0 * fr_drop / fr_off, 4) if fr_off else None,
      'feature_padding_waste_pct': round(
          100.0 * (1 - sent_ft / ft_slots), 4) if ft_slots else None,
      'feature_drop_rate_pct': round(
          100.0 * ft_drop / ft_off, 4) if ft_off else None,
      'negative_lost': g('dist.negative.lost'),
  }
  lookups = g('dist.feature.cold_lookups')
  if lookups:
    out['cold_hit_rate'] = round(
        1.0 - g('dist.feature.cold_misses') / lookups, 4)
  return out
