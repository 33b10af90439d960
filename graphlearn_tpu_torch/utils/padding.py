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


def max_sampled_nodes(batch_size: int, num_neighbors) -> int:
  """Worst-case unique-node capacity of a multi-hop sample: the seeds
  plus every hop's full frontier (``B + B*k1 + B*k1*k2 + ...``)."""
  total = frontier = int(batch_size)
  for k in num_neighbors:
    frontier *= int(k)
    total += frontier
  return total


def max_sampled_edges(batch_size: int, num_neighbors) -> int:
  """Worst-case sampled-edge capacity of a multi-hop sample
  (``B*k1 + B*k1*k2 + ...``)."""
  total = 0
  frontier = int(batch_size)
  for k in num_neighbors:
    frontier *= int(k)
    total += frontier
  return total
