"""Per-tier memory accounting and the serve-capacity headroom model.

The port's copy of `register_tier` and `CapacityModel` from the JAX
package's `telemetry/memaccount.py`.

* `register_tier`: each memory owner (the streaming graph's published
  view, the WAL, the tiered feature store, the kernel-build cache on
  disk) registers a zero-argument byte callback under a fixed ``tier=``
  label; two gauges per tier: ``memory.tier_bytes`` (scrape-time
  occupancy) and ``memory.tier_peak_bytes`` (high-watermark since
  registration, tracked at scrape).  Registering a tier again replaces
  its callbacks (latest instance wins).
* `CapacityModel`: a per-bucket EWMA of coalesced-dispatch serve cost
  (seconds per request, fed by the serving frontend after every
  dispatch).  Traffic-weighting the per-bucket costs gives the
  replica's sustainable rate for its current mix; minus the SLO
  tracker's short-window qps that is the ``fleet.headroom_qps`` gauge.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

from .live import live

#: the tier vocabulary of the port's owners (the ``tier=`` label values):
#: ``cold_cache`` is a tiered store's victim ring on the card,
#: ``pinned_host`` its cold block in page-locked host memory, ``aot`` the
#: kernel-build cache's entries on disk
TIERS = ('streaming', 'wal', 'cold_cache', 'pinned_host', 'aot')

#: EWMA smoothing of a bucket's dispatch cost (the last ~10 dispatches
#: dominate)
_ALPHA = 0.2


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


class CapacityModel:
  """Per-bucket EWMA serve-cost model → ``fleet.headroom_qps``.

  Args:
    slo: the frontend's `SloTracker` (its short-window qps is the
      traffic already carried; None = headroom is the raw capacity).
    registry: `LiveRegistry` to export on (None = the global one).

  The executor is serial, so with per-request cost ``c_b`` for bucket
  ``b`` and observed request mix ``w_b`` the sustainable rate is
  ``1 / Σ (w_b/Σw) · c_b``.
  """

  def __init__(self, slo=None, registry=None):
    self._registry = live if registry is None else registry
    self._slo = slo
    self._lock = threading.Lock()
    self._cost: Dict[int, float] = {}     # bucket -> EWMA secs/request
    self._weight: Dict[int, float] = {}   # bucket -> requests seen
    # one bound method, pinned: unregister compares callbacks by identity
    self._headroom_fn = self._headroom
    self._registry.gauge('fleet.headroom_qps', fn=self._headroom_fn)

  def observe(self, bucket: int, requests: int, secs: float) -> None:
    """Fold one coalesced dispatch (``requests`` riders served in
    ``secs`` of executor wall time) into its bucket's cost EWMA."""
    if requests <= 0 or secs < 0:
      return
    per_req = float(secs) / float(requests)
    with self._lock:
      prev = self._cost.get(bucket)
      self._cost[bucket] = (per_req if prev is None
                            else prev + _ALPHA * (per_req - prev))
      self._weight[bucket] = \
          self._weight.get(bucket, 0.0) + float(requests)

  def capacity_qps(self) -> Optional[float]:
    """Traffic-weighted sustainable request rate (None before the first
    dispatch)."""
    with self._lock:
      total_w = sum(self._weight.values())
      if not total_w:
        return None
      mean_cost = sum(self._weight[b] * self._cost[b]
                      for b in self._cost) / total_w
    if mean_cost <= 0:
      return None
    return 1.0 / mean_cost

  def _headroom(self) -> Optional[float]:
    cap = self.capacity_qps()
    if cap is None:
      return None
    carried = 0.0
    if self._slo is not None:
      st = self._slo._cached_stats(self._slo.windows[0])
      if st['count']:
        carried = float(st['qps'])
    return round(max(cap - carried, 0.0), 3)

  def snapshot(self) -> dict:
    with self._lock:
      return {'cost_secs_per_request': dict(self._cost),
              'requests_seen': dict(self._weight)}

  def close(self) -> None:
    """Unregister the headroom gauge (a closed frontend must not evict
    its replacement's)."""
    self._registry.unregister_gauge('fleet.headroom_qps',
                                    fn=self._headroom_fn)
