"""Device resolution for the port's entry points.

Every entry point takes a ``device`` argument that defaults to
``'cuda'``.  Without CUDA that default raises: the port never moves to
the CPU on its own, a caller who wants the CPU says so.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
  """``device`` as a concrete `torch.device` (``'cuda'`` becomes the
  current card's index).  Raises RuntimeError when a CUDA device is
  asked for and CUDA is not available."""
  dev = torch.device(device)
  if dev.type == 'cuda':
    if not torch.cuda.is_available():
      raise RuntimeError(
          'CUDA is not available; pass device="cpu" to run on the CPU')
    if dev.index is None:
      dev = torch.device('cuda', torch.cuda.current_device())
  return dev
