"""Host-side region timing: the JAX package's `utils/profiling.py`
`metrics` and `trace`.

`metrics` is the port's process-global counter store
(`telemetry.live.metrics`), which the loaders, channels and the RPC
layer tick.  `trace` marks a host region on the torch profiler's
timeline (`torch.profiler.record_function`) and accumulates its wall
time in the registry as ``<name>.secs`` / ``<name>.calls``.
"""
from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

from ..telemetry.live import Metrics, metrics

__all__ = ['Metrics', 'metrics', 'trace']


@contextlib.contextmanager
def trace(name: str, registry: Optional[Metrics] = None) -> Iterator[None]:
  """Annotate a host-side region: a profiler range and a wall-clock
  timer in ``registry`` (default `metrics`)."""
  import torch
  reg = registry if registry is not None else metrics
  t0 = time.perf_counter()
  try:
    with torch.profiler.record_function(name):
      yield
  finally:
    reg.inc_many(((f'{name}.secs', time.perf_counter() - t0),
                  (f'{name}.calls', 1.0)))
