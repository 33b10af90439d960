"""Process identity for the host runtime (the JAX package's
`distributed/dist_context.py`).

Reference `distributed/dist_context.py:20-183`: every participating
process declares a role (worker / server / client) and a rank within
that role; global ranks interleave servers first then clients
(`dist_context.py:152-166`).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional


class DistRole(enum.Enum):
  WORKER = 1
  SERVER = 2
  CLIENT = 3


@dataclass
class DistContext:
  """Who this process is in the deployment."""
  role: DistRole
  rank: int
  world_size: int
  group_name: str = ''
  num_servers: int = 0
  num_clients: int = 0

  @property
  def is_worker(self) -> bool:
    return self.role == DistRole.WORKER

  @property
  def is_server(self) -> bool:
    return self.role == DistRole.SERVER

  @property
  def is_client(self) -> bool:
    return self.role == DistRole.CLIENT

  @property
  def global_rank(self) -> int:
    """Servers occupy global ranks [0, num_servers); clients follow
    (reference `dist_context.py:152-166`)."""
    if self.role == DistRole.CLIENT:
      return self.num_servers + self.rank
    return self.rank

  @property
  def global_world_size(self) -> int:
    if self.role == DistRole.WORKER:
      return self.world_size
    return self.num_servers + self.num_clients


_context: Optional[DistContext] = None


def init_worker_group(world_size: int, rank: int,
                      group_name: str = 'worker') -> DistContext:
  """Declare this process a collocated worker
  (reference `init_worker_group`, `dist_context.py:169`)."""
  global _context
  _context = DistContext(role=DistRole.WORKER, rank=rank,
                         world_size=world_size, group_name=group_name)
  return _context


def _set_context(ctx: DistContext) -> DistContext:
  global _context
  _context = ctx
  return ctx


def get_context() -> Optional[DistContext]:
  return _context
