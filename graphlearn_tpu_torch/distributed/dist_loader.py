"""Trainer-side loader over a sample channel.

The JAX package's `distributed/dist_loader.py`; reference
`distributed/dist_loader.py:49-383`: pick a worker mode (collocated /
mp / remote), run the epoch protocol (produce_all, then recv exactly
the expected number of messages), and collate each flat
``SampleMessage`` into the training batch.  Ragged host messages are
padded to **static capacities** (``INVALID_ID`` ids, zero rows) so
every batch has the same shapes, then copied to ``device`` (default
``'cuda'``) as the port's `Batch` / `HeteroBatch` of torch tensors —
the collate is the only place a torch tensor is made; every process
boundary carries numpy.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence, Union

import numpy as np

from ..channel import (ChannelBase, MpChannel, RemoteReceivingChannel,
                       SampleMessage, ShmChannel)
from ..loader.transform import Batch, HeteroBatch
from ..typing import as_str, reverse_edge_type
from ..utils.device import resolve_device
from ..utils.padding import (INVALID_ID, max_sampled_edges,
                             max_sampled_nodes, next_power_of_two,
                             round_up)
from ..utils.profiling import metrics, trace
from .dist_options import (CollocatedDistSamplingWorkerOptions,
                           HostSamplingConfig,
                           MpDistSamplingWorkerOptions,
                           RemoteDistSamplingWorkerOptions)
from .dist_sampling_producer import (CollocatedSamplingProducer,
                                     MpSamplingProducer)
from .host_dataset import HostDataset, HostHeteroDataset

WorkerOptions = Union[CollocatedDistSamplingWorkerOptions,
                      MpDistSamplingWorkerOptions,
                      RemoteDistSamplingWorkerOptions]


def edge_capacity(batch_size: int, fanouts: Sequence[int]) -> int:
  """Static bound on total sampled edges across hops — the ONE
  worst-case count (`utils.padding.max_sampled_edges`) rounded to the
  loader's lane multiple."""
  return max(round_up(max_sampled_edges(batch_size, fanouts), 8), 8)


class PaddedRows:
  """A feature table's rows padded with zero rows to ``cap``, as the JAX
  package's collate pads them on the host: the padding is made on the
  destination device instead, so only the real rows cross the host
  link (a padded products batch is ~375 MB, its real rows ~310 MB)."""

  def __init__(self, rows: np.ndarray, cap: int):
    self.rows = rows if rows.flags.writeable else rows.copy()
    self.cap = int(cap)

  def to(self, device):
    import torch
    rows = torch.from_numpy(self.rows)
    out = torch.zeros((self.cap,) + tuple(rows.shape[1:]), dtype=rows.dtype,
                      device=device)
    out[:len(rows)].copy_(rows)
    return out


class DistLoader:
  """Channel-fed loader base (reference `dist_loader.py:49-383`).

  Args:
    dataset: `HostDataset` (sampling world's shard).
    num_neighbors: per-hop fanouts.
    input_nodes: seed ids.
    batch_size / shuffle / drop_last: epoch iteration controls.
    worker_options: deployment mode selector.
    device: where collated batches land (default ``'cuda'``; raises
      without CUDA unless the caller asks for ``'cpu'``).
  """

  def __init__(self, dataset: Optional[HostDataset], num_neighbors,
               input_nodes, batch_size: int = 512, shuffle: bool = False,
               drop_last: bool = False,
               worker_options: Optional[WorkerOptions] = None,
               with_edge: bool = False, device='cuda',
               seed: int = 0, sampling_config=None):
    if isinstance(num_neighbors, dict):
      self.fanouts = {tuple(k): [int(x) for x in v]
                      for k, v in num_neighbors.items()}
    else:
      self.fanouts = [int(k) for k in num_neighbors]
    self.batch_size = int(batch_size)
    # hetero node seeds come as ``(node_type, ids)`` (the reference's
    # hetero ``input_nodes`` contract, `loader/node_loader.py`)
    if (isinstance(input_nodes, (tuple, list)) and len(input_nodes) == 2
        and isinstance(input_nodes[0], str)):
      ntype, input_nodes = input_nodes
      if sampling_config is None:
        sampling_config = HostSamplingConfig(sampling_type='node',
                                             input_type=ntype)
      elif sampling_config.input_type is None:
        # copy: the caller's config object may be shared across loaders
        import dataclasses
        sampling_config = dataclasses.replace(sampling_config,
                                              input_type=ntype)
    seeds = np.asarray(input_nodes)
    self.seeds = seeds if seeds.ndim > 1 else seeds.reshape(-1)
    self.shuffle = shuffle
    self.drop_last = drop_last
    self.with_edge = with_edge
    self.device = resolve_device(device)
    #: per-phase wall seconds of the batches yielded so far: ``recv``
    #: (channel wait + parse), ``collate`` (host padding) and ``copy``
    #: (host to ``device``, synchronised on a card)
    self.phase_secs = {'recv': 0.0, 'collate': 0.0, 'copy': 0.0}
    self.opts = worker_options or CollocatedDistSamplingWorkerOptions()
    self.sampling_config = sampling_config
    self._epoch_iter = None
    self._expected = 0
    self._received = 0
    self.is_hetero = isinstance(dataset, HostHeteroDataset)
    meta = None
    if dataset is None and isinstance(self.opts,
                                      RemoteDistSamplingWorkerOptions):
      # remote mode without a local dataset: the server's meta carries
      # what capacity planning needs (reference loaders likewise fetch
      # `get_dataset_meta` first, `dist_loader.py:202`)
      from .dist_client import get_client
      client = get_client()
      if client is not None:
        sr = self.opts.server_rank
        idx = (sr[0] if isinstance(sr, (list, tuple)) else (sr or 0))
        meta = client.get_dataset_meta(idx)
        self.is_hetero = bool(meta.get('hetero'))
    if self.is_hetero:
      etypes = (dataset.edge_types if dataset is not None
                else tuple(tuple(e) for e in meta['edge_types']))
      num_nodes = (dataset.num_nodes if dataset is not None
                   else meta['num_nodes'])
      self._init_hetero_caps(etypes, num_nodes)
    else:
      if isinstance(self.fanouts, dict):
        raise ValueError(
            'dict-valued num_neighbors implies a hetero dataset: pass a '
            'HostHeteroDataset, or init_client() first so the remote '
            "server's hetero meta is reachable")
      # link/subgraph modes feed more node seeds into expansion per
      # seed-batch slot (endpoints + negatives)
      exp_seeds = (sampling_config.expansion_seeds(self.batch_size)
                   if sampling_config is not None else self.batch_size)
      if dataset is not None:
        num_nodes = dataset.num_nodes
      elif meta is not None:
        num_nodes = meta['num_nodes']
      else:
        num_nodes = 1 << 30
      self.node_cap = round_up(
          min(max_sampled_nodes(exp_seeds, self.fanouts),
              exp_seeds + num_nodes), 8)
      self.edge_cap = edge_capacity(exp_seeds, self.fanouts)
      self.batch_cap = exp_seeds

    self.channel: Optional[ChannelBase] = None
    self._producer = None
    if isinstance(self.opts, MpDistSamplingWorkerOptions):
      self.channel = ShmChannel(self.opts.resolved_capacity(),
                                self.opts.resolved_size())
      self._producer = MpSamplingProducer(
          dataset, self.fanouts, self.batch_size, self.channel,
          self.opts, with_edge=with_edge, shuffle=shuffle, seed=seed,
          sampling_config=sampling_config)
      self._producer.init()
    elif isinstance(self.opts, RemoteDistSamplingWorkerOptions):
      from .dist_client import get_client
      client = get_client()
      assert client is not None, (
          'init_client() before RemoteDistSamplingWorkerOptions loaders')
      self._remote = client.create_sampling_producer(
          self.opts, self.fanouts, self.batch_size, self.seeds,
          with_edge=with_edge, shuffle=shuffle, seed=seed,
          sampling_config=sampling_config)
      self.channel = RemoteReceivingChannel(
          self._remote.fetch, self._num_batches(),
          self.opts.prefetch_size)
    else:
      self._producer = CollocatedSamplingProducer(
          dataset, self.fanouts, self.batch_size, with_edge=with_edge,
          collect_features=self.opts.collect_features, shuffle=shuffle,
          seed=seed, sampling_config=sampling_config)

  def _init_hetero_caps(self, etypes, num_nodes) -> None:
    """Static per-type capacity plan for hetero collation — the same
    planner the device hetero sampler plans with
    (`sampler/hetero_neighbor_sampler.py::_plan_capacities`)."""
    from ..sampler.hetero_neighbor_sampler import (_plan_capacities,
                                                   normalize_fanouts)
    cfg = self.sampling_config
    if cfg is not None and cfg.sampling_type == 'subgraph':
      # the reference's SubGraphOp is homogeneous-only
      # (`include/subgraph_op_base.h`); reject at construction, not
      # as an opaque worker crash at iteration time
      raise ValueError('subgraph sampling is homogeneous-only')
    assert cfg is not None and cfg.input_type is not None, (
        'hetero loading needs a seed type: pass input_nodes=(ntype, ids) '
        'or edge_label_index=(etype, pairs)')
    etypes, fanouts, num_hops = normalize_fanouts(tuple(etypes),
                                                  self.fanouts)
    input_sizes = cfg.hetero_input_sizes(self.batch_size)
    ntypes, table_cap, _, edge_caps = _plan_capacities(
        etypes, fanouts, input_sizes, num_hops, dict(num_nodes))
    self.h_ntypes = ntypes
    self.h_node_cap = table_cap
    self.h_seed_cap = input_sizes
    self.h_edge_cap = {}
    for et in etypes:
      total = sum(ec.get(et, 0) for ec in edge_caps)
      if total > 0:
        self.h_edge_cap[reverse_edge_type(et)] = round_up(total, 8)
    self.h_num_hops = num_hops
    self.batch_cap = self.batch_size

  def _num_batches(self) -> int:
    n = len(self.seeds)
    if self.drop_last:
      return n // self.batch_size
    return (n + self.batch_size - 1) // self.batch_size

  def __len__(self) -> int:
    return self._num_batches()

  # -- epoch protocol (reference `__iter__`/`__next__`,
  # `dist_loader.py:246-272`) ---------------------------------------------
  def __iter__(self):
    self._seen_seqs = set()       # '#SEQ' stamps delivered this epoch
    self._degraded_lost = set()   # seqs written off in degraded mode
    if isinstance(self.opts, MpDistSamplingWorkerOptions):
      self._expected = self._producer.produce_all(self.seeds,
                                                  drop_last=self.drop_last)
      self._received = 0
    elif isinstance(self.opts, RemoteDistSamplingWorkerOptions):
      expected = self._remote.start_new_epoch(drop_last=self.drop_last)
      self.channel.reset(expected)
      self._expected = expected
      self._received = 0
    else:
      self._epoch_iter = self._producer.epoch(self.seeds,
                                              drop_last=self.drop_last)
    return self

  def __next__(self) -> Batch:
    from ..telemetry import spans
    # epoch exhaustion surfaces BEFORE the per-batch 'batch' root
    # span opens — an epoch end is not a batch and must not emit a
    # phantom near-zero span pair into the histogram/trace.  In
    # collocated mode that means the in-process sampling (inside
    # next()) runs outside the span; the channel-fed modes (the
    # production deployments) keep full recv+collate coverage.
    if self._epoch_iter is not None:
      msg = next(self._epoch_iter)
      with spans.span('batch', scope=type(self).__name__):
        return self._collate_batch(msg)
    if self._received >= self._expected:
      raise StopIteration
    with spans.span('batch', scope=type(self).__name__):
      with spans.span('recv'):
        t0 = time.perf_counter()
        with trace('dist_loader.recv'):
          msg = self._recv_current_epoch()
        self.phase_secs['recv'] += time.perf_counter() - t0
      self._received += 1
      return self._collate_batch(msg)

  def _collate_batch(self, msg: SampleMessage) -> Batch:
    """Collate under a 'collate' span carrying the producer's
    cross-process span context (injected into the message by the
    channel) as producer_trace/producer_span link fields."""
    from ..telemetry import spans
    # every channel receive path already stripped-and-parked the
    # message's '#SPAN' (ChannelTelemetry._park_span) — the parked
    # context is the one source of the producer link
    link = spans.link_fields(getattr(self.channel,
                                     'last_span_context', None))
    with spans.span('collate', **link):
      t0 = time.perf_counter()
      with trace('dist_loader.collate'):
        batch = self._collate_fn(msg)
      t1 = time.perf_counter()
      with trace('dist_loader.copy'):
        batch = self._to_device(batch)
      t2 = time.perf_counter()
    self.phase_secs['collate'] += t1 - t0
    self.phase_secs['copy'] += t2 - t1
    metrics.inc('dist_loader.batches')
    return batch

  def _to_device(self, batch):
    """Every numpy array of a collated batch (metadata included) as a
    torch tensor on ``self.device``; on a card the copy is complete when
    this returns, so its time is the copy's."""
    import torch
    dev = self.device

    def conv(v):
      if isinstance(v, PaddedRows):
        return v.to(dev)
      if isinstance(v, np.ndarray):
        # a message field passed through as is may be a read-only view
        # of the received bytes
        return torch.from_numpy(v if v.flags.writeable else v.copy()).to(dev)
      if isinstance(v, dict):
        return {k: conv(x) for k, x in v.items()}
      return v
    for name in batch.FIELDS:
      setattr(batch, name, conv(getattr(batch, name)))
    if dev.type == 'cuda':
      torch.cuda.synchronize(dev)
    return batch

  #: timed-wait granularity of the supervision poll loops.
  RECV_POLL_SECS = 5.0

  def _recv_current_epoch(self) -> SampleMessage:
    """Receive, discarding stale-epoch messages left in the channel by
    an early-terminated previous epoch (`RemoteReceivingChannel` does
    its own stamp + '#SEQ' filtering).  Blocking waits are liveness-
    guarded: every wait is timed, and each timeout runs supervision —
    mp mode restarts dead workers and replays their unacked batches;
    remote mode heartbeats the servers.  Irrecoverable loss raises
    `PeerLostError` with diagnostics, or — ``GLT_DEGRADED_OK=1`` —
    finishes the epoch on survivors with the loss flagged in telemetry
    (a ``peer.lost`` event with ``degraded=True``)."""
    from ..telemetry.recorder import recorder
    from .resilience import PeerLostError, degraded_ok
    if isinstance(self.opts, RemoteDistSamplingWorkerOptions):
      while True:
        try:
          msg = self.channel.recv_timeout(self.RECV_POLL_SECS)
        except StopIteration:
          raise
        except PeerLostError as e:
          # the fallback ladder: ADOPT the dead server's
          # producers on a survivor (exact completion) → degraded
          # write-off (GLT_DEGRADED_OK) → typed raise
          if self._try_adopt_server(e):
            continue
          if not degraded_ok() or not hasattr(self._remote,
                                              'drop_server'):
            # single-server loaders have no survivors to finish on —
            # degraded mode needs a multi-server plan to fall back to
            e.peer_health = dict(getattr(self, '_peer_health', {}))
            raise
          # finish on survivors: write off what the dead peer still
          # owed (its planned fetches + this failed one) and keep
          # draining the rest of the plan
          owed = 1
          if e.peer is not None:
            owed += self._remote.drop_server(e.peer)
          self.channel.reduce_expected(owed)
          self._expected -= owed
          recorder.emit('peer.lost', peer=e.peer, peer_kind='server',
                        degraded=True, lost_batches=owed,
                        received=self._received,
                        expected=self._expected)
          if self._received >= self._expected:
            raise StopIteration from e
          continue
        if msg is not None:
          return msg
        # clean poll timeout: distinguish slow from dead via the
        # heartbeat (a dead server's in-flight fetch will also raise,
        # but the probe surfaces sooner and feeds diagnostics)
        self._probe_servers()
      # not reached
    cur = self._producer.current_epoch
    while True:
      # timed semaphore wait: blocking fast path, and ANY crashed
      # worker surfaces on the next timeout (a dead worker may hold an
      # outstanding seed slice that will never arrive).  The timed
      # recv itself closes the message-arrived-then-died race: a
      # message present at raise-decision time was drained.
      msg = self.channel.recv_timeout(self.RECV_POLL_SECS)
      if msg is None:
        _, lost = self._producer.supervise(self._seen_seqs)
        fresh_lost = set(lost) - self._degraded_lost
        if fresh_lost:
          if not degraded_ok():
            dead = self._producer.dead_worker_exitcodes()
            raise PeerLostError(
                f'{len(dead)} sampling worker(s) unrecoverable (exit '
                f'codes {dead}, restart budget spent) with '
                f'{self._expected - self._received} batch(es) '
                f'outstanding, {len(fresh_lost)} of them lost for '
                f'good; received {self._received}/{self._expected}',
                received=self._received, expected=self._expected,
                outstanding=len(fresh_lost))
          self._degraded_lost |= fresh_lost
          self._expected -= len(fresh_lost)
          recorder.emit('peer.lost', peer_kind='worker', degraded=True,
                        lost_batches=len(fresh_lost),
                        received=self._received,
                        expected=self._expected)
          if self._received >= self._expected:
            raise StopIteration
        continue
      stamp = msg.get('#EPOCH')
      if stamp is not None and int(np.asarray(stamp)) != cur:
        continue
      seq = msg.get('#SEQ')
      if seq is not None:
        seq = int(np.asarray(seq))
        if seq in self._seen_seqs:
          # replayed batch whose original got through (worker-restart
          # replay, or a resumed epoch's re-produced prefix)
          self.replayed_discarded = getattr(self, 'replayed_discarded',
                                            0) + 1
          continue
        if seq in self._degraded_lost:
          # written off as lost, then arrived after all (the worker's
          # send raced its own death): the epoch accounting already
          # subtracted it — delivering now would end the epoch one
          # batch early and silently drop a different healthy batch
          continue
        self._seen_seqs.add(seq)
      return msg

  def _try_adopt_server(self, err) -> bool:
    """Elastic server failover: a dead sampling server's producers are
    RECREATED on a
    survivor — same seed slice, same seed offset, fast-forwarded to
    the current epoch — so the epoch finishes with EXACTLY the
    expected batch set, byte-identical (the channel's (source, seq)
    dedup + source-routed replacement fetches absorb the re-produced
    prefix).  Opt-in via ``GLT_SHARD_DIR`` (the operator's
    declaration that every partition is re-loadable at a survivor —
    replicated host datasets serve it directly); absent that, or
    without a multi-server plan, returns False and the documented
    ``GLT_DEGRADED_OK`` ladder applies."""
    import time as _time
    from ..parallel.failover import shard_dir_from_env
    from ..parallel.partition_book import AdoptionRefusedError
    from ..telemetry.recorder import recorder
    if (shard_dir_from_env() is None
        or not hasattr(self._remote, 'adopt_server')
        or err.peer is None):
      return False
    from .dist_client import get_client
    client = get_client()
    if client is None:
      return False
    t0 = _time.monotonic()
    try:
      info = self._remote.adopt_server(client, int(err.peer))
    except AdoptionRefusedError as e:
      recorder.emit('peer.lost', peer=err.peer, peer_kind='server',
                    degraded=False, adopted=False,
                    refused=str(e)[:200])
      return False
    secs = _time.monotonic() - t0
    if info['recreated']:
      from ..telemetry.live import live
      live.counter('partition.adoptions_total').inc()
      live.gauge('partition.recovery_secs').set(secs)
      recorder.emit('partition.adopt', partition=int(err.peer),
                    survivor=int(info['survivor']),
                    version=len(getattr(self._remote, '_adopted', ())),
                    owed=int(info['owed']), secs=round(secs, 6),
                    scope='server')
    return True

  def _probe_servers(self) -> None:
    """Heartbeat every server this loader draws from (remote mode).
    Fetch-path errors carry the authoritative failure; the probe's job
    is the diagnostics trail — the last observed health of every peer
    is kept at ``self._peer_health`` and attached to the
    `PeerLostError` (``.peer_health``) when the epoch finally fails,
    so the log tells slow-peer from dead-peer without reconstruction."""
    import time as _time
    from .dist_client import get_client
    client = get_client()
    if client is None:
      return
    idxs = (self._remote.server_indices
            if hasattr(self._remote, 'server_indices')
            else [self._remote._server_idx])
    health = getattr(self, '_peer_health', None)
    if health is None:
      health = self._peer_health = {}
    for idx in idxs:
      hb = client.heartbeat(idx)
      health[idx] = {'at': round(_time.time(), 3),
                     'alive': hb is not None,
                     'producers': (hb or {}).get('producers')}

  # -- message -> static-shape Batch (reference `dist_loader.py:286-383`) --
  def _collate_fn(self, msg: SampleMessage):
    if int(np.asarray(msg.get('#IS_HETERO', 0))):
      return self._collate_hetero(msg)
    nc, ec = self.node_cap, self.edge_cap
    ids = msg['ids']
    c = len(ids)
    node = np.full(nc, INVALID_ID, np.int32)
    node[:c] = ids
    e = len(msg['rows'])
    if e > ec:
      # induced-subgraph messages can exceed the sampled-tree bound;
      # grow in power-of-two buckets so consumers see few shapes
      ec = next_power_of_two(e)
    edge_index = np.full((2, ec), INVALID_ID, np.int32)
    edge_index[0, :e] = msg['rows']
    edge_index[1, :e] = msg['cols']
    x = y = edge = edge_attr = None
    if 'nfeats' in msg:
      x = PaddedRows(msg['nfeats'], nc)
    if 'nlabels' in msg:
      y = np.zeros(nc, msg['nlabels'].dtype)
      y[:c] = msg['nlabels']
    if 'eids' in msg:
      edge = np.full(ec, INVALID_ID, np.int64)
      edge[:e] = msg['eids']
    if 'efeats' in msg:
      de = msg['efeats'].shape[1]
      edge_attr = np.zeros((ec, de), msg['efeats'].dtype)
      edge_attr[:e] = msg['efeats']
    batch = np.full(self.batch_cap, INVALID_ID, np.int64)
    batch[:len(msg['batch'])] = msg['batch']
    out = Batch(
        x=x, y=y, edge_index=edge_index, edge_attr=edge_attr, node=node,
        node_mask=node >= 0, edge_mask=edge_index[0] >= 0, edge=edge,
        batch=batch, batch_size=self.batch_size,
        num_sampled_nodes=msg.get('num_sampled_nodes'),
        metadata=self._collate_metadata(msg))
    return out

  def _collate_hetero(self, msg: SampleMessage) -> HeteroBatch:
    """Flat hetero message -> static-shape `HeteroBatch` (the hetero
    arm of reference `dist_loader.py:286-383`, keys ``f'{type}.x'``
    etc.).  Every batch pads to the SAME per-type capacities so the
    training step sees one set of shapes."""
    node_d, nm_d, x_d, y_d = {}, {}, {}, {}
    md = {'seed_local': {}, 'num_sampled_nodes': {}}
    for nt in self.h_ntypes:
      cap = self.h_node_cap[nt]
      ids = msg.get(f'{nt}.ids')
      node = np.full(cap, INVALID_ID, np.int32)
      c = 0
      if ids is not None:
        c = len(ids)
        node[:c] = ids
      node_d[nt] = node
      nm_d[nt] = node >= 0
      feats = msg.get(f'{nt}.nfeats')
      if feats is not None:
        x_d[nt] = PaddedRows(feats, cap)
      labels = msg.get(f'{nt}.nlabels')
      if labels is not None:
        y = np.zeros(cap, labels.dtype)
        y[:c] = labels
        y_d[nt] = y
      sl = msg.get(f'{nt}.seed_local')
      if sl is not None:
        out = np.full(self.h_seed_cap.get(nt, len(sl)), INVALID_ID,
                      np.int64)
        out[:len(sl)] = sl
        md['seed_local'][nt] = out
      ns = msg.get(f'{nt}.num_sampled')
      if ns is not None:
        md['num_sampled_nodes'][nt] = ns
    ei_d, em_d, edge_d = {}, {}, {}
    ea_d = {}
    for et, ecap in self.h_edge_cap.items():
      key = as_str(et)
      rows = msg.get(f'{key}.rows')
      edge_index = np.full((2, ecap), INVALID_ID, np.int32)
      # every batch carries the SAME edge_dict key set (padded when an
      # etype sampled nothing) so consumers see one structure across
      # the epoch
      ev = (np.full(ecap, INVALID_ID, np.int64)
            if self.with_edge else None)
      if rows is not None:
        e = len(rows)
        edge_index[0, :e] = rows
        edge_index[1, :e] = msg[f'{key}.cols']
        eids = msg.get(f'{key}.eids')
        if ev is not None and eids is not None:
          ev[:e] = eids
        efeats = msg.get(f'{key}.efeats')
        if efeats is not None:
          ea = np.zeros((ecap, efeats.shape[1]), efeats.dtype)
          ea[:e] = efeats
          ea_d[et] = ea
      if ev is not None:
        edge_d[et] = ev
      ei_d[et] = edge_index
      em_d[et] = edge_index[0] >= 0
    cfg = self.sampling_config
    seed_t = cfg.input_type
    batch_t = seed_t if isinstance(seed_t, str) else seed_t[0]
    batch = np.full(self.batch_cap, INVALID_ID, np.int64)
    batch[:len(msg['batch'])] = msg['batch']
    extra = self._collate_metadata(msg)
    extra.pop('seed_local', None)    # homo key; hetero built per type
    md.update(extra)
    if self.with_edge:
      md['edge_dict'] = edge_d
    out = HeteroBatch(
        x_dict=x_d, y_dict=y_d, edge_index_dict=ei_d, node_dict=node_d,
        edge_attr_dict=ea_d,
        node_mask_dict=nm_d, edge_mask_dict=em_d,
        batch_dict={batch_t: batch}, batch_size=self.batch_size,
        metadata=md)
    return out

  def _collate_metadata(self, msg: SampleMessage) -> dict:
    """Lift ``#META.*`` keys into batch metadata, statically padded so
    tail batches keep the epoch's shapes (the link/subgraph label
    contracts of reference `dist_loader.py:286-383`)."""
    md = {'seed_local': msg.get('seed_local')}
    cfg = self.sampling_config
    bs = self.batch_size
    explicit_mask = None
    for k, v in msg.items():
      if not k.startswith('#META.'):
        continue
      name = k[len('#META.'):]
      if name == 'edge_label_index':
        cap = cfg.label_cap(bs) if cfg else bs
        out = np.full((2, cap), INVALID_ID, np.int64)
        out[:, :v.shape[1]] = v
        md[name] = out
        md['edge_label_mask'] = np.arange(cap) < v.shape[1]
      elif name == 'edge_label':
        cap = cfg.label_cap(bs) if cfg else bs
        out = np.zeros(cap, v.dtype)
        out[:len(v)] = v
        md[name] = out
      elif name == 'edge_label_mask':
        # producer-supplied validity (strict-negative ok flags); folded
        # into the width-derived mask after the loop
        explicit_mask = np.asarray(v, bool)
      elif name in ('src_index', 'dst_pos_index', 'mapping'):
        out = np.full(bs, INVALID_ID, np.int64)
        out[:len(v)] = v
        md[name] = out
        if name == 'src_index':
          # seed validity, not emission width: padded tail slots carry
          # si = -1 and must read invalid (matches the mesh samplers)
          md['pair_mask'] = out >= 0
      elif name == 'dst_neg_index':
        amount = v.shape[1]
        out = np.full((bs, amount), INVALID_ID, np.int64)
        out[:len(v)] = v
        md[name] = out
      else:
        md[name] = v
    if explicit_mask is not None:
      cap = cfg.label_cap(bs) if cfg else bs
      padded = np.zeros(cap, bool)
      padded[:len(explicit_mask)] = explicit_mask
      base = md.get('edge_label_mask')
      md['edge_label_mask'] = padded if base is None else padded & base
    return md

  # -- DataPlaneState (utils.checkpoint): mid-epoch snapshot/resume --------
  def state_dict(self) -> dict:
    """Epoch cursor for the mp (subprocess-producer) mode: producer
    positions + the '#SEQ' stamps already delivered this epoch.  A
    resumed epoch re-produces from the same (epoch, shuffle) and the
    consumer discards the already-seen prefix — remaining batches are
    byte-identical (batch content is a function of (epoch, seq))."""
    if not isinstance(self.opts, MpDistSamplingWorkerOptions):
      raise ValueError(
          'DistLoader snapshots cover the mp producer mode; remote '
          "mode's producers live in the server process (snapshot "
          'there), and collocated mode has no durable position')
    seen = np.asarray(sorted(getattr(self, '_seen_seqs', ())), np.int64)
    return {'producer': self._producer.state_dict(), 'seen': seen,
            'expected': int(self._expected)}

  def load_state_dict(self, state: dict) -> None:
    if not isinstance(self.opts, MpDistSamplingWorkerOptions):
      raise ValueError('DistLoader snapshots cover the mp mode')
    self._producer.load_state_dict(state['producer'], mid_epoch=True)
    self._resume_state = {
        'seen': set(int(s) for s in np.asarray(state['seen'])),
        'expected': int(np.asarray(state['expected']))}

  def resume_epoch(self):
    """Finish the interrupted epoch (call after `load_state_dict`):
    the producer re-dispatches the same epoch, already-delivered seqs
    are discarded on arrival (counted in ``replayed_discarded``), and
    the returned iterator yields exactly the remaining batches —
    byte-identical to what an uninterrupted epoch would have
    produced.  (``iter(loader)`` afterwards starts the NEXT epoch;
    this iterator does not re-trigger the epoch protocol.)"""
    r = getattr(self, '_resume_state', None)
    if r is None:
      raise ValueError('resume_epoch() needs load_state_dict() first')
    self._resume_state = None
    self._seen_seqs = set(r['seen'])
    self._degraded_lost = set()
    self.replayed_discarded = 0
    expected = self._producer.produce_all(self.seeds,
                                          drop_last=self.drop_last)
    # the snapshot's expected wins when degraded mode had already
    # written batches off before the snapshot
    self._expected = min(expected, r['expected'])
    self._received = len(self._seen_seqs)
    return _ResumedEpochIterator(self)

  def shutdown(self) -> None:
    # idempotent: __del__ re-enters after an explicit shutdown, and a
    # second remote destroy against a since-departed server would
    # waste its one-shot teardown attempt on a dead socket
    if getattr(self, '_shutdown_done', False):
      return
    self._shutdown_done = True
    if self._producer is not None and hasattr(self._producer, 'shutdown'):
      self._producer.shutdown()
    if isinstance(self.opts, RemoteDistSamplingWorkerOptions):
      self._remote.destroy()
    if self.channel is not None:
      self.channel.close()

  def __del__(self):
    try:
      self.shutdown()
    except Exception:
      pass


class _ResumedEpochIterator:
  """Continues an interrupted epoch WITHOUT re-entering the loader's
  epoch protocol: ``for batch in loader.resume_epoch()`` must not hit
  `DistLoader.__iter__` (which would dispatch a fresh epoch over the
  one just resumed)."""

  def __init__(self, loader: 'DistLoader'):
    self._loader = loader

  def __iter__(self):
    return self

  def __next__(self):
    return DistLoader.__next__(self._loader)


class DistNeighborLoader(DistLoader):
  """Node-wise distributed loader (reference
  `distributed/dist_neighbor_loader.py:27-94`)."""


class DistLinkNeighborLoader(DistLoader):
  """Link-prediction distributed loader (reference
  `distributed/dist_link_neighbor_loader.py:30-153`): seed edges +
  negatives sampled in the producers, link-label metadata
  (``edge_label_index``/``edge_label`` or triplet indices) collated
  statically padded.

  Args:
    edge_label_index: ``[2, E]`` (or ``(rows, cols)``) seed edges.
    edge_label: optional integer labels (binary mode applies the
      reference's +1 shift: 0 becomes the negative class).
    neg_sampling: ``'binary'`` / ``'triplet'`` or
      ``(mode, amount)``.
  """

  def __init__(self, dataset, num_neighbors, edge_label_index,
               edge_label=None, neg_sampling=None, **kwargs):
    input_type = None
    if (isinstance(edge_label_index, (tuple, list))
        and len(edge_label_index) == 2
        and isinstance(edge_label_index[0], (tuple, list))
        and len(edge_label_index[0]) == 3
        and all(isinstance(t, str) for t in edge_label_index[0])):
      # hetero seeds: (edge_type, pairs) — the reference's hetero
      # `edge_label_index` contract (`loader/link_loader.py`)
      input_type, edge_label_index = edge_label_index
      input_type = tuple(input_type)
    if isinstance(edge_label_index, (tuple, list)):
      rows, cols = edge_label_index
    else:
      ei = np.asarray(edge_label_index)
      rows, cols = ei[0], ei[1]
    mode, amount = None, 1.0
    if neg_sampling is not None:
      if isinstance(neg_sampling, (tuple, list)):
        mode, amount = neg_sampling[0], float(neg_sampling[1])
      elif isinstance(neg_sampling, str):
        mode = neg_sampling
      else:  # NegativeSampling-like
        mode = neg_sampling.mode
        amount = float(neg_sampling.amount)
    cols_arr = [np.asarray(rows, np.int64), np.asarray(cols, np.int64)]
    if edge_label is not None:
      lab = np.asarray(edge_label, np.int64)
      if mode == 'binary':
        lab = lab + 1     # reference +1 shift (`link_loader.py:146-186`)
      cols_arr.append(lab)
    seeds = np.stack(cols_arr, axis=1)
    cfg = HostSamplingConfig(sampling_type='link', neg_mode=mode,
                             neg_amount=amount, input_type=input_type)
    super().__init__(dataset, num_neighbors, seeds,
                     sampling_config=cfg, **kwargs)


class DistSubGraphLoader(DistLoader):
  """Induced-subgraph distributed loader (reference
  `distributed/dist_subgraph_loader.py:28-89`): each batch message is
  the enclosing subgraph of its seed set, with ``mapping`` locating
  the seeds in the node table (SEAL-style)."""

  def __init__(self, dataset, num_neighbors, input_nodes, **kwargs):
    super().__init__(dataset, num_neighbors, input_nodes,
                     sampling_config=HostSamplingConfig(
                         sampling_type='subgraph'),
                     **kwargs)
