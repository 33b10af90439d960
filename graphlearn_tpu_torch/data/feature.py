"""Two-tier node feature store: hot rows on the card, cold rows in host
memory (the JAX package's `data/feature.py`).

* **Hot tier**: the first ``split_ratio`` of the rows (callers sort them
  hottest-first, `data.reorder.sort_by_in_degree`) as one ``[H, D]``
  tensor on the device, read through the fused remap + mask + row-gather
  kernel (`ops.gather_rows`).
* **Cold tier**: the remaining rows in host memory.  On the card they
  are a page-locked block (`data.cold_cache.PinnedColdBuffer`) that the
  cold-gather kernel (`ops.cold_gather`) reads a batch's miss rows from
  straight into the batch; a victim cache on the card
  (`data.cold_cache.DeviceColdCache`) serves the cold rows that recur.

A lookup on a mixed table brings the ids to the host once (the cache
policy runs there, as in the JAX package), gathers the hot rows on the
card, serves the cache's hits, fills the misses through the kernel and
admits them to the cache.  The output is byte-equal to the JAX
package's, whatever the cache holds.  On the CPU the same path runs the
kernels' plain versions.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..ops.gather_rows import gather_rows
from ..testing import chaos
from ..utils import convert_to_array, resolve_device
from ..utils.tensor import PinnedStaging
from .cold_cache import (DeviceColdCache, PinnedColdBuffer,
                         emit_cache_events, resolve_cache_rows)


#: a tiered lookup's parts, as `Feature.lookup_secs` sums them: the ids'
#: copy to the host (it waits for the stream), the host remap and
#: hot/cold split, the hot-tier gather, the cache lookup, the cold fill
#: (K6) and the cache's serve and admission (their uploads and
#: launches; the kernels run asynchronously)
LOOKUP_PARTS = ('d2h', 'split', 'hot_gather', 'cache_lookup', 'cold_fill',
                'admission')


def _device_gather(hot: torch.Tensor, ids: torch.Tensor,
                   id2index: Optional[torch.Tensor]) -> torch.Tensor:
  """``[B]`` global ids -> ``[B, D]`` rows: ``id2index`` remap, clamp,
  zero rows for invalid (``< 0``) or unmapped ids — the JAX
  `data/feature.py::_device_gather` contract, in one kernel launch."""
  return gather_rows(hot, ids, id2index)


def _as_tensor(data) -> torch.Tensor:
  if isinstance(data, torch.Tensor):
    return data
  return torch.from_numpy(np.ascontiguousarray(convert_to_array(data)))


class Feature:
  """Feature table addressed by global ids, split between the card and
  host memory.

  Args:
    feature_array: ``[N, D]`` (or ``[N]``) numpy array or torch tensor;
      rows hottest-first when ``split_ratio < 1``.  A tensor already on
      the card is the hot tier as it is (``split_ratio`` must be 1).
    id2index: optional ``[max_id+1]`` map from global id to table row
      (``-1`` = unmapped); identity when ``None``.
    split_ratio: the fraction of rows kept on the card: ``1.0`` all,
      ``0.0`` none (every row served from host memory).
    device: the card (default ``'cuda'``), or ``'cpu'``.
    dtype: optional storage dtype of the device tiers (e.g.
      ``torch.bfloat16``), applied once when they are built.
    cold_cache_rows: the victim cache's rows over the cold tier:
      ``'auto'`` (``GLT_COLD_CACHE_ROWS``, else 15% of the cold rows), an
      int, or 0 for none.  Only a mixed table (``0 < hot < N``) has one.
  """

  def __init__(self, feature_array, id2index=None,
               split_ratio: float = 1.0, device='cuda',
               dtype: Optional[torch.dtype] = None,
               cold_cache_rows='auto'):
    self._device = resolve_device(device)
    self._dtype = dtype
    self.split_ratio = float(split_ratio)
    if (isinstance(feature_array, torch.Tensor)
        and feature_array.device.type != 'cpu'):
      if self.split_ratio != 1.0:
        raise ValueError('device-resident feature input requires '
                         'split_ratio == 1.0 (a cold tier lives on the host '
                         'by definition)')
      feats = feature_array if feature_array.ndim > 1 else feature_array[
          :, None]
      self._host = None
      self._hot = feats.to(self._device, dtype or feats.dtype).contiguous()
      n = self.hot_rows = int(feats.shape[0])
    else:
      feats = _as_tensor(feature_array)
      self._host = feats if feats.ndim > 1 else feats[:, None]
      self._hot = None
      n = int(self._host.shape[0])
      self.hot_rows = max(0, min(int(round(n * self.split_ratio)), n))
    self._id2index_host = (None if id2index is None else
                           np.asarray(convert_to_array(id2index), np.int64))
    self._id2index = None
    self._cache_rows = (resolve_cache_rows(cold_cache_rows, n - self.hot_rows)
                        if 0 < self.hot_rows < n else 0)
    self._cold_cache: Optional[DeviceColdCache] = None
    self._pinned_cold: Optional[PinnedColdBuffer] = None
    self._staging = PinnedStaging(pin=self._device.type == 'cuda')
    self._ready = False
    #: valid ids looked up, and those past the hot tier (the cache's
    #: denominator), over the tiered path
    self.cold_stats = {'lookups': 0, 'cold_lookups': 0}
    #: host seconds of the tiered lookups by part (`LOOKUP_PARTS`),
    #: summed since construction; a caller resets it to read a window
    self.lookup_secs = dict.fromkeys(LOOKUP_PARTS, 0.0)

  def lazy_init(self) -> None:
    """Build the device tiers on first use: the hot rows, the id map,
    the victim cache and the cold block."""
    if self._ready:
      return
    dev, n = self._device, self.size(0)
    if self._hot is None and self.hot_rows > 0:
      hot = self._host[:self.hot_rows]
      self._hot = hot.to(dev, self._dtype or hot.dtype).contiguous()
    if self._id2index_host is not None:
      self._id2index = torch.from_numpy(self._id2index_host).to(
          dev, torch.int32)
    if self._cache_rows:
      self._cold_cache = DeviceColdCache(self._cache_rows, self.feature_dim,
                                         self.dtype, dev)
    if self.hot_rows < n:
      self._pinned_cold = PinnedColdBuffer(self._host[self.hot_rows:],
                                           self.feature_dim, self._dtype,
                                           dev)
    self._ready = True

  @property
  def _table(self) -> torch.Tensor:
    return self._host if self._host is not None else self._hot

  @property
  def shape(self):
    return tuple(self._table.shape)

  @property
  def dtype(self) -> torch.dtype:
    return self._dtype or self._table.dtype

  @property
  def device(self) -> torch.device:
    return self._device

  @property
  def feature_dim(self) -> int:
    return int(self._table.shape[1])

  def size(self, dim: int = 0) -> int:
    return int(self._table.shape[dim])

  @property
  def is_tiered(self) -> bool:
    return self.hot_rows < self.size(0)

  @property
  def hot_tier(self) -> Optional[torch.Tensor]:
    """The device rows ``[0, hot_rows)`` (None when there are none)."""
    self.lazy_init()
    return self._hot

  @property
  def id2index(self) -> Optional[torch.Tensor]:
    """The device id->row map (int32), or None."""
    self.lazy_init()
    return self._id2index

  @property
  def cold_cache(self) -> Optional[DeviceColdCache]:
    self.lazy_init()
    return self._cold_cache

  # -- lookup -------------------------------------------------------------
  def _remap(self, ids: np.ndarray):
    """Host ids -> ``(valid, rows)``: invalid (``< 0``) and unmapped ids
    are not valid, and their rows read 0."""
    valid = ids >= 0
    idx = np.where(valid, ids, 0).astype(np.int64)
    if self._id2index_host is not None:
      idx = self._id2index_host[idx]
      valid &= idx >= 0             # partial maps hold -1 for unmapped ids
      idx = np.where(valid, idx, 0)
    return valid, idx

  def get(self, ids, scope: str = 'feature') -> torch.Tensor:
    """Rows by global id, on the device; invalid ids (``< 0``) and
    unmapped ids give zero rows.

    A table wholly on the card is one gather, with no host step.  A
    tiered table brings the ids to the host once (``scope`` labels the
    lookup's cache counters and events: ``'feature'`` for the loaders,
    ``'serving'`` for the serving engine).
    """
    self.lazy_init()
    if not self.is_tiered:
      return _device_gather(self._hot, _as_tensor(ids).to(self._device),
                            self._id2index)
    secs, t = self.lookup_secs, [time.perf_counter()]

    def tick(part):
      now = time.perf_counter()
      secs[part] += now - t[0]
      t[0] = now

    ids_h = (ids.cpu().numpy() if isinstance(ids, torch.Tensor)
             else np.asarray(ids))
    tick('d2h')
    valid, idx = self._remap(ids_h)
    cold_sel = valid & (idx >= self.hot_rows)
    self.cold_stats['lookups'] += int(valid.sum())
    self.cold_stats['cold_lookups'] += int(cold_sel.sum())
    tick('split')
    dev = self._device
    if self.hot_rows:
      hot_ids = np.where(valid & ~cold_sel, idx, -1).astype(np.int32)
      out = gather_rows(self._hot, torch.from_numpy(hot_ids).to(dev))
      if cold_sel.any():
        # the JAX package's seam: on the mixed path only
        chaos.cold_service_check('feature')
    else:
      out = torch.zeros((len(ids_h), self.feature_dim), dtype=self.dtype,
                        device=dev)
    tick('hot_gather')
    if not cold_sel.any():
      return out
    cache = self._cold_cache
    miss_sel = cold_sel
    if cache is not None:
      hit, slot = cache.lookup(idx, cold_sel)
      miss_sel = cold_sel & ~hit
    tick('cache_lookup')
    pos = np.nonzero(miss_sel)[0]
    m = len(pos)
    # (pos, rel) as int32, staged in one reusable (pinned, on a card)
    # buffer and uploaded in one copy that does not wait for the card
    ids = self._staging.take(2 * m, 1, torch.int32).view(-1)
    ids_h = ids.numpy()
    ids_h[:m] = pos
    np.subtract(idx[pos], self.hot_rows, out=ids_h[m:], casting='unsafe')
    ids = ids.to(dev, non_blocking=True)
    self._staging.record()
    self._pinned_cold.gather(out, ids[:m], ids[m:])
    tick('cold_fill')
    if cache is not None:
      out = cache.serve_hits(out, hit, slot)
      admits, evicts = cache.admit(out, idx, miss_sel)
      emit_cache_events(scope, int(hit.sum()), len(pos), admits, evicts)
    tick('admission')
    return out

  __getitem__ = get

  # -- DataPlaneState: the victim cache only (the tables are rebuilt
  # from the dataset) -----------------------------------------------------
  def state_dict(self) -> dict:
    self.lazy_init()
    if self._cold_cache is None:
      return {'has_cache': 0}
    return {'has_cache': 1, 'cache': self._cold_cache.state_dict()}

  def load_state_dict(self, state: dict) -> None:
    self.lazy_init()
    if not int(np.asarray(state.get('has_cache', 0))):
      return
    if self._cold_cache is None:
      return                       # no cache this run: the warmth is lost
    self._cold_cache.load_state_dict(state['cache'])

  def host_get(self, ids=None) -> torch.Tensor:
    """A host gather (a CPU tensor in the source dtype); the whole
    table when ``ids`` is None."""
    if self._host is None:
      self._host = self._hot.cpu()
    if ids is None:
      return self._host
    ids = np.asarray(ids)
    valid, idx = self._remap(ids)
    out = torch.zeros((len(ids), self.feature_dim), dtype=self._host.dtype)
    out[torch.from_numpy(valid)] = self._host[torch.from_numpy(idx[valid])]
    return out

  def close(self) -> None:
    """Release the page-locked cold block (the store is unusable on the
    card afterwards)."""
    if self._pinned_cold is not None:
      self._pinned_cold.close()

  def __repr__(self):
    return (f'Feature(shape={self.shape}, split_ratio={self.split_ratio}, '
            f'hot_rows={self.hot_rows}, device={str(self.device)!r})')
