"""Derived exchange health from the mesh loader's counters and the
per-hop padding fill of the fused mesh epochs: the port's copies of the
JAX package's `telemetry/aggregate.py::exchange_summary` and
`per_hop_padding` (the rest of that module gathers host snapshots
across processes, which the port's one-process mesh does not need)."""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


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


def per_hop_padding(nsn, batch_size: int,
                    fanouts: Sequence[int]) -> List[Dict]:
  """Per-hop node counts and padding fill from ``[..., H+1]`` new-node
  counts per hop (hop 0 the seeds): leading axes are summed and the
  capacities scaled by their multiplicity.  Hop ``h`` has capacity
  ``batch * prod(fanouts[:h])``; ``fill`` is the share of it that holds
  nodes."""
  arr = np.asarray(nsn, np.int64)
  mult = int(np.prod(arr.shape[:-1])) if arr.ndim > 1 else 1
  flat = arr.reshape(-1, arr.shape[-1]).sum(axis=0)
  caps = [batch_size]
  for k in fanouts:
    caps.append(caps[-1] * int(k))
  out = []
  for h in range(len(flat)):
    cap = caps[h] * mult if h < len(caps) else None
    row = {'hop': h, 'nodes': int(flat[h])}
    if cap:
      row['capacity'] = int(cap)
      row['fill'] = round(float(flat[h]) / cap, 6)
    out.append(row)
  return out
