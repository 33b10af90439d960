"""The kernel wrappers' launch counts.  Each wrapper adds one to its
``launches`` where it launches its kernel, and nowhere else; `counted`
registers it where it is defined, so code that accounts for launches it
did not see at the Python call (a replayed CUDA graph's) walks
`LAUNCH_COUNTED` instead of naming the wrappers."""
from __future__ import annotations

from typing import Callable, List

#: every wrapper that counts its kernel's launches
LAUNCH_COUNTED: List[Callable] = []


def counted(fn: Callable) -> Callable:
  """Give ``fn`` a ``launches`` count of 0 and register it."""
  fn.launches = 0
  LAUNCH_COUNTED.append(fn)
  return fn
