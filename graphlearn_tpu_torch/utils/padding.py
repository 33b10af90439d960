"""Static-shape padding helpers.

The port keeps the JAX package's static-shape contract: ragged outputs
become fixed capacities with ``INVALID_ID`` where a slot is empty.
"""
from __future__ import annotations

#: Sentinel for an invalid/padded node or edge id.
INVALID_ID = -1


def round_up(x: int, multiple: int) -> int:
  return -(-int(x) // int(multiple)) * int(multiple)


def next_power_of_two(x: int) -> int:
  if x <= 1:
    return 1
  return 1 << (int(x) - 1).bit_length()
