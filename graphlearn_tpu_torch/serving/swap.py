"""Drain-free hot model swap for the serving tier.

The port's copy of the JAX package's `serving/swap.py`.  `hot_swap`
moves a running frontend onto new model params without dropping a
request:

  1. **quiesce, don't flush** — admission enters ``draining``: new
     arrivals are refused typed (``reason='draining'`` with a
     ``retry_after_ms`` hint) while queued requests stay queued; the
     executor finishes its in-flight coalesced run and parks at the
     dispatch gate, so the swap happens between runs.
  2. **validate before admitting** — the candidate runs a probe batch
     through the coalesced path and the per-seed `offline_reference`,
     both under the candidate and one held graph version: sampled nodes
     byte-equal, logits within ``atol``.
  3. **commit or roll back** — parity passes: `ServingEngine.set_params`
     installs the candidate and bumps ``model_version``.  It fails: the
     prior version keeps serving and the caller gets a typed
     :class:`SwapParityError`.

Either way the drain window closes and the queue resumes; every attempt
emits one ``serving.swap`` event.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np

from ..telemetry.live import live
from ..telemetry.recorder import recorder


class SwapValidationError(ValueError):
  """The candidate params cannot replace the installed ones (keys,
  shapes or dtypes differ): refused before the drain window opens."""


class SwapParityError(RuntimeError):
  """The candidate failed the offline-reference parity probe: the
  coalesced path and the per-seed reference disagreed under it.  The
  swap rolled back; the prior version is still serving and nothing was
  dropped.  ``max_err`` is the worst logit divergence observed."""

  def __init__(self, msg: str, max_err: Optional[float] = None):
    super().__init__(msg)
    self.max_err = max_err


class SwapAbortedError(RuntimeError):
  """The swap never reached its probe: the executor did not quiesce
  within the gate timeout (a stuck in-flight dispatch).  The prior
  version was never displaced; an executor-health signal, not a parity
  verdict."""


def _tick(outcome: str) -> None:
  live.counter('serving.swaps_total', labels={'outcome': outcome}).inc()


def _parity_probe(engine, params, probe_seeds, atol: float) -> float:
  """The candidate through the coalesced path and the per-seed offline
  reference, under one held graph version; returns the max divergence
  (raises `SwapParityError` past ``atol``, on a non-finite divergence,
  or when the sampled nodes differ)."""
  with engine.hold_graph():
    cand = engine.infer(probe_seeds, params=params)
    ref = engine.offline_reference(probe_seeds, params=params)
  if not np.array_equal(cand.nodes, ref.nodes):
    raise SwapParityError(
        'candidate sampled different nodes through the coalesced path '
        'than the per-seed reference; rolled back')
  max_err = 0.0
  for a, b in ((cand.logits, ref.logits), (cand.x, ref.x)):
    if a is None or b is None:
      continue
    err = float(np.max(np.abs(np.asarray(a, np.float64)
                              - np.asarray(b, np.float64))))
    max_err = max(max_err, err)
    if not np.isfinite(err) or err > atol:
      raise SwapParityError(
          f'candidate parity probe diverged (max |Δ| = {err:.3e} > '
          f'{atol:.1e}) between the coalesced path and the per-seed '
          'offline reference; rolled back', max_err=err)
  return max_err


def hot_swap(frontend, params, version: Optional[int] = None,
             probe_seeds=None, atol: float = 1e-4,
             gate_timeout_s: float = 30.0) -> dict:
  """Swap the frontend's engine onto ``params`` (a state dict) without
  dropping a request.  Returns ``{'version', 'parity_max_err',
  'drained_ms'}``; raises `SwapValidationError` (refused up front),
  `SwapParityError` (probe failed, rolled back) or `SwapAbortedError`
  (the executor did not quiesce).  ``probe_seeds`` defaults to 4 ids
  spread over the node space; ``atol`` is the logit tolerance (logits
  agree across bucket shapes to float tolerance)."""
  engine = frontend.engine
  if engine.model is None:
    raise SwapValidationError('hot_swap needs a model-serving engine')
  try:
    engine.validate_params(params)
  except ValueError as e:
    raise SwapValidationError(str(e)) from e
  if probe_seeds is None:
    n = engine.num_nodes
    probe_seeds = np.unique(
        np.linspace(0, n - 1, num=min(4, n)).astype(np.int64))
  t0 = time.monotonic()
  admission = frontend.admission
  with frontend._swap_lock:
    admission.set_draining(True)
    gate_acquired = False
    try:
      gate_acquired = frontend._dispatch_gate.acquire(
          timeout=gate_timeout_s)
      if not gate_acquired:
        drained_ms = 1e3 * (time.monotonic() - t0)
        recorder.emit('serving.swap', version=version, ok=False,
                      rolled_back=False, parity_max_err=None,
                      drained_ms=round(drained_ms, 3),
                      error=f'executor did not quiesce within '
                            f'{gate_timeout_s}s')
        _tick('aborted')
        raise SwapAbortedError(
            f'executor did not quiesce within {gate_timeout_s}s '
            '(in-flight dispatch stuck) — swap aborted, prior version '
            'still serving')
      try:
        max_err = _parity_probe(engine, params, probe_seeds, atol)
        new_version = engine.set_params(params, version)
      except Exception as e:        # noqa: BLE001 — any probe or commit
        # failure rolls back: the prior version keeps serving
        if not isinstance(e, SwapParityError):
          e = SwapParityError(
              f'swap probe failed ({type(e).__name__}: {e}) — rolled '
              'back, prior version still serving')
        drained_ms = 1e3 * (time.monotonic() - t0)
        recorder.emit('serving.swap', version=version, ok=False,
                      rolled_back=True,
                      parity_max_err=getattr(e, 'max_err', None),
                      drained_ms=round(drained_ms, 3),
                      error=f'{type(e).__name__}: {e}'[:200])
        _tick('rolled_back')
        raise e
    finally:
      if gate_acquired:
        frontend._dispatch_gate.release()
      admission.set_draining(False)
  drained_ms = 1e3 * (time.monotonic() - t0)
  recorder.emit('serving.swap', version=new_version, ok=True,
                rolled_back=False, parity_max_err=round(max_err, 9),
                drained_ms=round(drained_ms, 3))
  _tick('ok')
  return {'version': new_version, 'parity_max_err': max_err,
          'drained_ms': round(drained_ms, 3)}
