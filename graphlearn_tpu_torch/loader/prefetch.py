"""Background-thread batch prefetch (the JAX package's
`loader/prefetch.py`).

A tiered store's lookup brings the batch's ids to the host, so each
batch waits for the card once.  `PrefetchIterator` hides that: a worker
thread produces the NEXT batches — sampling, the cold-tier fill, their
launches — while the caller's step runs.  Loaders expose it as
``prefetch=N`` (0 = off, the default; 2 = double buffering).

**Streams.**  On the card the worker runs under its own CUDA stream.
On the default stream it would queue behind the trainer's model
kernels, and each of its host synchronisations (the ids' copy to the
host) would wait for the model step: the overlap would be lost.  After
each batch the worker records an event on its stream; `__next__` makes
the consumer's current stream wait for that event and marks every
tensor of the batch as used on it (`record_stream`), so the caching
allocator does not hand the memory to the worker again while the
consumer still reads it.

**Order.**  One worker produces the batches in order, so every draw
counter advances as it does without prefetch: batches are byte-equal
between ``prefetch=0`` and ``prefetch=N``.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import torch


class PrefetchingLoader:
  """Mixin: epoch iteration with optional background prefetch.

  Subclasses implement ``_produce(seed_iter)`` (one batch, or raise
  StopIteration), keep their seed source at ``self._batcher`` and set
  ``self.prefetch`` and ``self._prefetch_device`` (the device whose
  stream the worker uses).  Each epoch runs on a private seed iterator;
  ``iter(loader)`` starts a new epoch, while ``iter()`` on the returned
  iterator continues it (the same for prefetch 0 and > 0); starting an
  epoch closes and joins the previous epoch's worker, so an abandoned
  epoch can neither take the next one's batches nor leak its thread.
  A loader with an ``_adaptive`` controller (`parallel.dist_sampler.
  AdaptiveSlack`) retunes it between epochs, after that join.
  """

  prefetch: int = 0
  _prefetch_device: Optional[torch.device] = None

  def __iter__(self):
    ctl = getattr(self, '_adaptive', None)
    if ctl is not None:
      # join a live worker BEFORE retuning: a worker mid-_produce must
      # not sample at the new capacity while the finished epoch's
      # counters are read
      self.close()
      if getattr(self, '_epoch_count', 0) > 0:
        ctl.on_epoch_end()
      self._epoch_count = getattr(self, '_epoch_count', 0) + 1
    return self._start_epoch(iter(self._batcher))

  def _start_epoch(self, seed_iter):
    # close AND join the previous worker: it may be mid-_produce, and
    # two producers on one loader would race its draw counter
    self.close()
    if self.prefetch:
      it = PrefetchIterator(self._epoch_gen(seed_iter), self.prefetch,
                            device=self._prefetch_device)
      self._active_prefetch = it
      return it
    return _SyncEpochIterator(self, seed_iter)

  def close(self) -> None:
    """Stop an abandoned prefetch worker and drop its buffered batches.
    Call after breaking out of a ``prefetch > 0`` epoch early."""
    prev = getattr(self, '_active_prefetch', None)
    if prev is not None:
      prev.close()
      prev.join()
      self._active_prefetch = None

  def _epoch_gen(self, seed_iter):
    while True:
      try:
        yield self._produce(seed_iter)
      except StopIteration:
        return

  def _produce(self, seed_iter):
    raise NotImplementedError

  def _pipeline_acquire(self, seed_iter):
    """First half of the one-deep dispatch/finish pipeline: batch k's
    in-flight handle (dispatched during batch k-1), or at epoch start
    its raw seeds for the caller to dispatch; StopIteration at epoch
    end.  The state is keyed on the seed iterator, so a new or
    abandoned epoch never consumes a stale in-flight batch."""
    if getattr(self, '_pending_src', None) is not seed_iter:
      self._pending, self._pending_src = None, seed_iter
    cur, self._pending = self._pending, None
    if cur is None:
      return None, next(seed_iter)     # StopIteration ends the epoch
    return cur, None

  def _pipelined(self, acquired, seed_iter, dispatch_flat, finish):
    """Second half: dispatch batch k+1's device work before batch k's
    host finish (``finish``), so the host half of batch k overlaps
    batch k+1's sampling on the card.  Batches are byte-equal to the
    unpipelined order."""
    cur, flat = acquired
    if cur is None:
      cur = dispatch_flat(flat)
    try:
      self._pending = dispatch_flat(next(seed_iter))
    except StopIteration:
      pass
    return finish(cur)


class _SyncEpochIterator:
  """One synchronous epoch: ``iter()`` returns itself, so a warm-up
  ``next()`` followed by a for-loop continues the epoch."""

  def __init__(self, loader: PrefetchingLoader, seed_iter):
    self._loader = loader
    self._seed_iter = seed_iter

  def __iter__(self):
    return self

  def __next__(self):
    return self._loader._produce(self._seed_iter)


class _Failure:
  """An exception crossing the thread boundary."""

  def __init__(self, exc: BaseException):
    self.exc = exc


def _tensors(item):
  """Every tensor of a batch (a `Batch`'s fields and metadata, or a
  plain container)."""
  if isinstance(item, torch.Tensor):
    yield item
  elif isinstance(item, dict):
    for v in item.values():
      yield from _tensors(v)
  elif isinstance(item, (list, tuple)):
    for v in item:
      yield from _tensors(v)
  elif hasattr(item, 'FIELDS'):
    for f in item.FIELDS:
      yield from _tensors(getattr(item, f, None))


class PrefetchIterator:
  """Iterate ``it`` on a daemon worker thread, ``depth`` items ahead.

  With a CUDA ``device`` the worker produces under its own stream and
  hands each item over behind an event (module docstring).  Exceptions
  raised by the producer re-raise at the consumer's ``__next__``;
  abandoning the iterator stops the worker (the bounded queue is
  polled against a stop flag, so the thread never blocks on a reader
  that went away).
  """

  _DONE = object()

  def __init__(self, it: Iterator, depth: int = 2,
               device: Optional[torch.device] = None):
    self._q: queue.Queue = queue.Queue(maxsize=max(1, int(depth)))
    self._stop = threading.Event()
    dev = None if device is None else torch.device(device)
    self._device = dev if dev is not None and dev.type == 'cuda' else None
    self._thread = threading.Thread(
        target=self._run, args=(it,), daemon=True, name='glt-prefetch')
    self._thread.start()

  def _run(self, it) -> None:
    try:
      if self._device is None:
        for item in it:
          if not self._put((item, None)):
            return
      else:
        stream = torch.cuda.Stream(self._device)
        with torch.cuda.device(self._device), torch.cuda.stream(stream):
          for item in it:
            ev = torch.cuda.Event()
            ev.record(stream)
            if not self._put((item, ev)):
              return
      self._put(self._DONE)
    except BaseException as e:           # noqa: BLE001 — forwarded
      self._put(_Failure(e))

  def _put(self, item) -> bool:
    while not self._stop.is_set():
      try:
        self._q.put(item, timeout=0.1)
        return True
      except queue.Full:
        continue
    return False

  def __iter__(self):
    return self

  def __next__(self):
    if self._stop.is_set():
      raise StopIteration
    got = self._q.get()
    if got is self._DONE:
      self._stop.set()
      raise StopIteration
    if isinstance(got, _Failure):
      self._stop.set()
      raise got.exc
    item, ev = got
    if ev is not None:
      cur = torch.cuda.current_stream(self._device)
      cur.wait_event(ev)
      for t in _tensors(item):
        if t.device.type == 'cuda':
          t.record_stream(cur)
    return item

  def close(self) -> None:
    """Stop the worker and drop buffered batches."""
    self._stop.set()
    try:
      while True:
        self._q.get_nowait()
    except queue.Empty:
      pass

  def join(self, timeout: Optional[float] = None) -> None:
    """Wait for the worker thread to exit (call after `close`)."""
    self._thread.join(timeout)

  def __del__(self):
    try:
      self.close()
    except Exception:                    # noqa: BLE001 — teardown
      pass
