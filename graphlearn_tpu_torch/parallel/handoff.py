"""Planned `PartitionBook` handoff: move a range between live positions
with no degraded window (the JAX package's `parallel/handoff.py`).

The scheduled twin of crash adoption (`failover`): nothing died, so the
move is fenced — the source keeps serving the range until the
destination holds a byte-identical copy, and the cutover is ONE book
bump.  No request is routed to a position without the range's bytes, so
the epoch completes byte-identical to the run without a handoff.

The seam ladder (each phase is a ``handoff.transfer`` chaos seam with
``op`` = the seam name, and emits one ``handoff.transfer`` recorder
event):

  1. **snapshot** — write the range's durable shard from the source's
     current stacks (`failover.shard_payload`, atomic publish);
  2. **transfer** — the destination loads it under the adoption deadline
     and validates it (`failover.validate_shard_payload`);
  3. **fence** — the destination's ack: the loaded payload must equal
     what the source serves now; only then is it staged on
     ``dataset.adopted_shards``.  The book still routes to the source;
  4. **cutover** — `PartitionBook.transfer`: one version bump.  Readers
     fence at their next dispatch and serve the staged shard from the
     destination;
  5. **drain** — the source's in-flight work finishes on its pinned
     view; a fault here is after the cutover and is absorbed.

A fault at any seam before the cutover unwinds to the source: the staged
shard is dropped, the book is untouched, and `HandoffAbortedError` names
the seam.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np

from .failover import (NoDurableShardError, ShardStore, _load_with_deadline,
                       adopt_timeout_s, dataset_meta, shard_dir_from_env,
                       shard_payload, validate_shard_payload)
from .partition_book import AdoptionRefusedError, PartitionBook

#: the seam ladder in execution order (``handoff.transfer:<action>:1:
#: op=<seam>`` targets one)
SEAMS = ('snapshot', 'transfer', 'fence', 'cutover', 'drain')


class HandoffAbortedError(RuntimeError):
  """A planned handoff unwound before its cutover: the source keeps the
  range (book untouched, staged shard dropped).  ``seam`` names where
  the ladder stopped."""

  def __init__(self, msg: str, seam: Optional[str] = None,
               partition: Optional[int] = None):
    super().__init__(msg)
    self.seam = seam
    self.partition = partition


def _ack_payload(ds, rng: int, payload: Dict[str, np.ndarray]) -> None:
  """The fence's destination ack: every array of the transferred payload
  equals what the source serves from its live stacks right now."""
  for key, want in shard_payload(ds, rng).items():
    got = payload.get(key)
    if got is None or not np.array_equal(np.asarray(got), want):
      raise HandoffAbortedError(
          f'destination ack failed for partition {int(rng)}: transferred '
          f'shard field {key!r} is not byte-identical to the live range '
          '(stale durable copy?)', seam='fence', partition=int(rng))


def handoff(ds, rng: int, to: int, store: Optional[ShardStore] = None,
            frm: Optional[int] = None) -> Dict:
  """Move range ``rng`` from its current owner to position ``to`` through
  the fenced seam ladder.  Returns ``partition``, ``frm``, ``to``,
  ``version``, ``secs`` and ``drain_fault``.  Raises
  `HandoffAbortedError`, `AdoptionRefusedError` or `NoDurableShardError`,
  with the book untouched and nothing staged, whenever the ladder stops
  before the cutover."""
  from ..telemetry.recorder import recorder
  from ..testing import chaos
  book: PartitionBook = ds.partition_book
  rng, to = int(rng), int(to)
  frm = int(book.view().owners[rng]) if frm is None else int(frm)
  if store is None:
    d = shard_dir_from_env()
    if d is None:
      raise NoDurableShardError(
          'no shard store configured (GLT_SHARD_DIR unset) — a planned '
          'handoff needs the durable-shard transfer path')
    store = ShardStore(d)

  t0 = time.monotonic()
  staged = False
  seam = 'snapshot'

  def _emit(phase: str, **extra) -> None:
    recorder.emit('handoff.transfer', partition=rng, frm=frm, to=to,
                  phase=phase, version=book.version,
                  secs=round(time.monotonic() - t0, 6), **extra)

  try:
    chaos.handoff_transfer_check('snapshot', partition=rng)
    store.save_shard(rng, shard_payload(ds, rng))
    store.save_meta(dataset_meta(ds))
    _emit('snapshot')

    seam = 'transfer'
    chaos.handoff_transfer_check('transfer', partition=rng)
    payload = _load_with_deadline(store, rng, adopt_timeout_s())
    payload = validate_shard_payload(ds, store, payload)
    _emit('transfer')

    seam = 'fence'
    chaos.handoff_transfer_check('fence', partition=rng)
    _ack_payload(ds, rng, payload)
    if rng in ds.adopted_shards:
      raise HandoffAbortedError(
          f'range {rng} already carries a staged/adopted shard — refusing '
          'to overwrite a prior ownership move', seam='fence',
          partition=rng)
    ds.adopted_shards[rng] = payload
    staged = True
    _emit('fence')

    # the only change of the routing authority in the ladder; its chaos
    # check sits before it, so a cutover-seam fault still unwinds
    seam = 'cutover'
    chaos.handoff_transfer_check('cutover', partition=rng)
    view = book.transfer(rng, frm, to)
    _emit('cutover')
  except BaseException as e:
    if staged:
      ds.drop_adopted(rng)
    _emit('rollback', error=f'{type(e).__name__}: {e}', at_seam=seam)
    if isinstance(e, (AdoptionRefusedError, NoDurableShardError,
                      HandoffAbortedError)):
      raise
    raise HandoffAbortedError(
        f'handoff of partition {rng} to {to} aborted at the {seam} seam '
        f'({type(e).__name__}: {e}) — source retains ownership',
        seam=seam, partition=rng) from e

  drain_fault = None
  try:
    chaos.handoff_transfer_check('drain', partition=rng)
  except Exception as e:              # noqa: BLE001 — absorbed by design
    drain_fault = f'{type(e).__name__}: {e}'
  secs = time.monotonic() - t0
  _emit('drain', error=drain_fault)
  return {'partition': rng, 'frm': frm, 'to': to,
          'version': int(view.version), 'secs': secs,
          'drain_fault': drain_fault}
