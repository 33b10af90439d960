"""Per-tier memory accounting: `register_tier`.

The port's copy of `register_tier` from the JAX package's
`telemetry/memaccount.py`.  Each memory owner (the streaming graph's
published view, the WAL, the tiered feature store) registers a
zero-argument byte callback under a fixed ``tier=`` label; two gauges
per tier: ``memory.tier_bytes``
(scrape-time occupancy) and ``memory.tier_peak_bytes`` (high-watermark
since registration, tracked at scrape).  Registering a tier again
replaces its callbacks (latest instance wins).
"""
from __future__ import annotations

from typing import Callable, Optional

from .live import live

#: the tier vocabulary of the port's owners (the ``tier=`` label values):
#: ``cold_cache`` is a tiered store's victim ring on the card,
#: ``pinned_host`` its cold block in page-locked host memory
TIERS = ('streaming', 'wal', 'cold_cache', 'pinned_host')


def register_tier(tier: str, fn: Callable[[], Optional[float]]) -> None:
  """Export ``fn()`` bytes as the ``tier=<tier>`` gauges."""
  if tier not in TIERS:
    raise ValueError(f'unknown memory tier {tier!r}; the vocabulary is '
                     f'{TIERS}')
  state = {'peak': None}

  def current() -> Optional[float]:
    v = fn()
    if v is None:
      return None
    v = float(v)
    if state['peak'] is None or v > state['peak']:
      state['peak'] = v
    return v

  def peak() -> Optional[float]:
    current()
    return state['peak']

  live.gauge('memory.tier_bytes', labels={'tier': tier}, fn=current)
  live.gauge('memory.tier_peak_bytes', labels={'tier': tier}, fn=peak)
