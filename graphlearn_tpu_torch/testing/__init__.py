"""Test harnesses the port's code calls into: `chaos` (seeded fault
injection at the streaming slice's seams)."""
from . import chaos

__all__ = ['chaos']
