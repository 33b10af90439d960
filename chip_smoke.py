#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, ingest, window-gather,
per-batch training, fused tree training, tiered feature store, GNS
training and partitioned mesh paths on one NVIDIA card.

Run from the repository root, with one CUDA card visible::

    python3 chip_smoke.py            # what the checks below need
    python3 chip_smoke.py --profile  # adds torch.profiler phases

Phases, one JSON line each; any failure exits nonzero:

  env     card (``nvidia-smi`` name and power limit), torch and CUDA
          versions; TF32 matmuls off.
  build   the seven CUDA kernels compiled from
          ``graphlearn_tpu_torch/csrc`` (one ``nvcc`` per source, started
          together).
  graph   the ogbn-products-scale synthetic graph (2,449,029 nodes,
          average degree 25, 0.3 hub mixture — the recipe of
          ``benchmarks/common.py``), CSR-sorted on the card from a seed,
          and a ``[N, 100]`` f32 feature table.
  kernel  each kernel against its plain PyTorch version on the card at
          the shapes the serving path gives it (byte-equal required):
          the sampler at every hop of a 16-seed bucket with fanouts
          [15, 10, 5] plus row sets forced through each arm, the row
          gather over a 16-seed tree in f32 and bf16, the delta-merge
          ranks (K4) of one 4,096-event batch into the products graph
          (with ``sort_ms``, a stable `torch.sort` of the same (row,
          column) keys plus the inverse-permutation scatter: a two-call
          yardstick the port never calls, and ``ranks_alone_ms``, the
          publish's ranks phase of that batch through
          `merge_delta_csr_device` on an idle card), of a hub burst
          (4,096 events from 64 products rows, ~64 new columns a row:
          the kernel's wide class), of a 1-row 1 x 1 call
          (``floor_ms``) and of
          `forced_merge_cases`: the first port's 96-row forced set (empty
          rows, base rows up to 8,192 wide, new-column rows up to 512
          wide, ties on both sides), every pair of base widths
          0/1/31/32/33/127/128/129/8,192 and new widths
          0/1/2/31/32/33/64/512, a row of 20,000 new columns (past one
          block's shared memory), every column tied, signed extremes,
          sorted and reverse-sorted segments, 1 / 4,095 / 100,003 rows of
          the products CSR; non-contiguous row ids throughout.  Then the forced
          sets of the sampler (k 1/4/5/8/15/16/17/32 at the default
          window and at 256, on 150,001, 20,001 and 1,001 rows: every arm,
          invalid and out-of-range seeds, top Gumbels tied across
          lane-group boundaries) and of the row
          gather (rows of 2 to 402 bytes that
          take each lane-group width and vector size, int32/int64 ids,
          with and without id2index, invalid ids and ids past N), each
          byte-equal to the plain version.  Times are the
          device time of one call by CUDA events (the host's enqueue
          hidden behind a busy card), median of 30, with the L2 cache
          flushed before each call; `torch.index_select` is the
          one-call yardstick for the gather.
  serve   `ServingEngine` with ``TreeSAGE(100, 256, 47, 3)`` behind a
          running `ServingFrontend`; 256 requests of 1-16 seeds from 4
          client threads; every future must resolve, launch counts must
          show the kernels (never the plain versions) served; 16
          requests held against `offline_reference`; a small graph
          served on the card and on the CPU must agree.
  ingest  the serve phase's engine and model over a `StreamingGraph` of
          the same products CSR, with an `IngestPipeline` (WAL in a
          temporary directory) applying 8 batches of 4,096 uniform
          edges while 4 closed-loop clients keep serving the serve
          phase's requests; events/s, per-publish milliseconds (host
          shift, ranks = upload + kernel + download, host scatter,
          device-twin copy), serving latency during ingest.  Checks: no
          failed request, lag 0, one rank-kernel launch per publish,
          the engine served the newest version, the final CSR equals a
          stable sort of all edges on the card, and 16 quiesced
          requests equal a static engine over that CSR.
  chaos   on a small graph on the card: a kill at the ``ingest.apply``
          seam, recovery in a new pipeline over the same WAL, and a
          graph byte-identical to a fault-free run.
  window  the window-gather entry point (the port of
          ``benchmarks/bench_pallas_window.py``): `csr_window_gather` on
          the products ``indices`` at 8,192 starts x 128, 30
          back-to-back calls on distinct seed sets timed by CUDA
          events, GB/s counted as B * w * 4 bytes per call; the same for
          the plain version, one `index_select` over precomputed flat
          positions and one full K1 hop at k = 15 as context; then one
          call of each under the kernel timer (L2 flushed), and the
          kernel at every forced width over the same starts under both
          timers.  Checks:
          byte-equal to the plain version on every timed input and on
          the forced sets (`forced_window_sets`: w 1/3/16/33/64/127/128/
          129/200/256 at 1 / 7 / 8,192 / 100,003 rows, int64 and int32
          starts of every residue mod 4 at both ends of the array,
          negative and past E, over the products ``indices``, the same
          one element in, 37 ids and one id), 30 launches and no plain
          call in the timed run.
  kernel  K1 at the three hops and K2 at the feature gather of one
          1,024-seed per-batch training step (inputs recorded from the
          path), against their plain versions.
  train   BASELINE config 1: `Dataset` with the products CSR, features
          and labels ``argmax(x @ P)`` on the card -> `NeighborLoader`
          ([15, 10, 5], batch 1,024, shuffled, seed 0) over the first
          n // 12 of a seeded permutation (200 steps) ->
          `make_supervised_step` with ``GraphSAGE(100, 256, 47, 3)``
          and Adam(3e-3): 3 warm steps, 2 timed epochs, 5 synchronised
          steps split into sample / collate / model, eval accuracy on
          20 test batches; then the sampling burst (30 batches of 1,024
          uniform seeds, one synchronise, sampled edges/s) and the
          feature-gather roofline (2^20 ids of stride 2 through K2,
          `index_select` and a contiguous copy).  Checks: 3 K1 and 1 K2
          launches per step, no plain call, epochs above the HBM floor,
          every valid node's ``x`` row and label equal to its source,
          ``edge_index`` inside the node count, finite losses falling,
          accuracy above 1/47.
  kernel  K1 at the three unsorted hops and K2 at the four level
          gathers (1,024 / 15,360 / 153,600 / 768,000 ids x 100 f32) of
          the tree epoch's first warm step (inputs recorded from the
          path), against their plain versions; each level's ids must be
          the ids its hop sampled and its table the source features.
  tree_train  `FusedTreeEpoch` with ``TreeSAGE(100, 256, 47, 3)``,
          Adam(3e-3), chunks of 100 steps over the same split: one warm
          and 3 timed epochs, `evaluate` on the test split.  Checks: 3
          K1 and 4 K2 launches per step, no plain call, finite losses
          falling across epochs, accuracy above 1/47.
  train_cross_check  a 4,000-node graph on the card and on the CPU with
          the same CPU-made draws: 3 `NeighborLoader` batches byte-equal
          (node, x, y, edge_index, edge_mask), their GraphSAGE step
          losses and 2 tree-epoch steps' losses within 1e-5.
  kernel  the cold-row gather (K6) against its plain version on forced
          shapes (`forced_cold_sets`: rows of 4, 12, 200 (bf16 x 100),
          400 and 1,024 bytes, M = 0 / 1 / 7 miss rows with ``rel`` at 0
          and Nc - 1, over `pin_memory` blocks, a block one row into its
          allocation and a registered `PinnedColdBuffer`; a block that is
          not page-locked must raise), byte-equal with the rows outside
          ``pos`` untouched; ``link`` is the best of 5 runs of a 256 MiB
          pinned -> device copy (the rate reached); K6's bound is its
          link bytes over the link's published peak.
  tiered_serve  `bench_serving.py`'s tiered engine: the products table
          pulled to the host, sorted by in-degree (`sort_by_in_degree`)
          and tiered at split 0.5 (1,224,514 hot rows on the card, the
          cold half registered as page-locked host memory, a 183,678-row
          'auto' victim cache), the serve phase's model and frontend, 256
          requests of 1-16 seeds drawn as Zipf(1.1) ranks over a fixed
          permutation, 4 clients; p50/p99, requests/s, fill ms, hit rate,
          miss rows a dispatch.  Checks: 3 K1, 1 K2 and (with misses) 1
          K6 launch a dispatch, no plain call; 16 requests' x byte-equal
          to the fully-hot engine's and logits within 1e-5.  Then a
          `kernel` line: K6 at the last dispatch's miss set.
  tiered_train  BASELINE config 1's step over the same sort at split 0.2
          (489,806 hot rows, 1,959,223 cold rows pinned, a 293,884-row
          cache): `NeighborLoader` at ``prefetch=0`` and then 2 over the
          same seeds, 3 warm + 20 timed steps each, the device idle share
          of 3 more, the ``prefetch=0`` step split into sample / collate /
          model.  Checks: both runs' batches byte-equal (the warm ones
          whole, the timed ones by digest), x rows and labels equal their
          source, 3 K1 + 1 K2 + 1 K6 launches a batch, no plain call,
          losses falling.  A `kernel` line: K6 at a batch's miss set.
  feature_lookup  `bench_feature.py`'s sweep over 8 recorded node sets:
          GB/s at split 1.0 / 0.5 / 0.2 with no cache, and at split 0.2
          with caches of 0 / 5% / 15% of the cold rows (hit rates).
  tiered_cross_check  a 4,000-node tiered graph on the card (the loader
          at ``prefetch=2``) and on the CPU with the same draws: 4 batches
          byte-equal and equal cache counters; a tiered engine's nodes and
          x; a split-0 bf16 store.
  gns_data  the products graph relabelled into a tiered `DistDataset`
          (split 0.3: 734,709 hot rows on the card, the whole table in
          pinned host memory), the train phase's labels.
  kernel  the GNS sampler kernel against its plain version (byte-equal
          nbrs, mask and weights) at the three hops of a 1,024-seed
          training batch with the run's own bits table, timed on a
          forced set a fanout at boosts 16 and 3, then on
          `forced_gns_cases` (k 1/4/5/8/15/16/17/32 at the default
          window and 256, on 150,001 / 20,001 / 1,001 rows, and k 40 at
          256 on 20,001 rows, boosts 16 and 3: rows of deg 0, <= k,
          k + 1, (k, w], w and > w, invalid and out-of-range seeds, ids
          past the bits table's last byte, a three-row table of random /
          empty / full masks read through per-row requesters, draws of
          0, just below 1 and exactly on the cum boundaries at window
          positions 7/8, 15/16 and 31/32; the same rows with half of
          them padding; the kernel alone with table rows out of range;
          at boost 16 the kernel alone timed on the rows and on their
          half-padding form);
          then the row gather kernel against its plain version at the
          two gathers of one training dispatch (the hot-tier features,
          ~938k ids x 100 f32, and the labels, 1 int32 column).
  gns_train  `DistNeighborLoader(gns=True)` -> `make_dp_supervised_step`
          with ``GraphSAGE(100, 256, 47, 3)`` and Adam(1e-3), batch
          1,024, fanouts [15, 10, 5], a cache of 734,709 rows: 2 warm
          and 8 timed steps (dispatch / cold overlay / model, each closed
          by a synchronise), 8 more steps in the loader's own pipelined
          order timed as one window, then the loader alone with GNS on
          and off over the same seeds (seeds/s, hit rates).  Checks: 3
          GNS and 2 row-gather launches per dispatch and no plain call,
          no exchange drops, every valid node's ``x`` row and label
          equal to its source row and label, weights 0 on masked and > 0
          on valid edges (some not 1), finite losses falling.
  gns_cross_check  a small tiered graph on the card and on the CPU with
          the same draws: 4 batches byte-equal (node, x, y, edge_index,
          edge_weight), logits within 1e-4 after one step.
  mesh_data  the products graph as two `DistDataset`s of 8 partitions on
          the card (`bench.py`'s ``dist_worker`` layout; the partitions
          share the one card): untiered (shards ``[8, 306,129, 100]``
          f32) and tiered at split 0.3 (91,839 hot rows a partition, the
          whole table in pinned host memory).
  mesh_loader  the untiered store through `DistNeighborLoader([15, 10,
          5], batch_size=512, shuffle=True, seed=0,
          exchange_slack='adaptive')`: 3 epochs of 4 batches over the
          first 512 x 8 x 4 seeds of a seeded permutation; seeds/s,
          sampled edges/s per partition, padding waste and slack rung per
          epoch, drop rate.  Checks: 24 K1 and 16 K2 launches per
          dispatch (one per owner a hop; one per owner a table), no plain
          call, every valid node's ``x`` row and label equal its source.
  kernel  K1 and K2 at the first `mesh_loader` batch's own calls (24
          sampler calls, 16 gathers), each against its plain version,
          one line per hop and per table summed over the 8 owners.
  kernel  K5 (`push_rows`, the owner push of `rdma_gather`) at one
          `mesh_loader` batch's node table ``[8, 468,992]``, capacity
          117,248: the `rdma_gather` entry point's run (1 launch, no
          plain call), the whole ``[8, 8, 117,248, 100]`` buffer
          byte-equal to `push_rows_plain`, `rdma_gather` byte-equal to
          `dist_gather_multi` on the whole ``[8, 468,992, 100]`` result;
          K5, its plain version and `index_select` over the precomputed
          flat positions timed as the other kernels, and the whole
          `rdma_gather` against the whole `dist_gather_multi`.  Forced
          set: invalid ids, partition-0 ids at capacity 8 (drops), bf16
          D = 100 and 3, the int32 label column, f32 D = 3.
  mesh_train  the tiered store through `DistNeighborLoader(gns=True,
          cold_cache_rows=91,839)` (the equal-HBM victim cache), batch
          512 x 8, into `make_dp_supervised_step` with ``GraphSAGE(100,
          256, 47, 3)`` and Adam(1e-3): 2 warm and 6 timed steps
          (dispatch / cold overlay / model, each closed by a
          synchronise), then `make_dp_eval_step` on 4 test batches.
          Checks: 24 GNS and 16 row-gather launches per dispatch, no plain
          call, no exchange drop at slack 2.0, ``x`` rows and labels equal
          their source, weights 0 on masked and > 0 on valid edges,
          finite losses falling, eval accuracy above 1/47.  Before the
          timed steps, `kernel` lines: the last warm dispatch's 24 GNS
          calls and 16 gathers against their plain versions.  ``windows``:
          the cold overlay's parts a dispatch (node-table copy to the
          host, `hot_split_host`, cache lookup and serve, host gather and
          copy, admission) in the synchronised window, 6 more steps in
          the loader's own order timed as one window, and a second
          loader, `DistNeighborLoader(prefetch=2)` over the same seeds
          (2 warm + 6 timed steps as one window, same checks on
          launches, drops and the warm batches' rows), each window with
          the device idle share of 3 more steps.
  mesh_cross_check  a 4,000-node graph at P = 4 on the card and on the
          CPU with the same CPU-made draws: 4 batches byte-equal untiered
          and 4 tiered with GNS, `rdma_gather` equal, logits within 1e-4
          after one DP step.

``--profile`` adds `profile` (serving) and `profile_train` (kernel time
by name and the device idle share of 3 steps of the per-batch, tree,
GNS and mesh training paths).  A ``wall`` line gives the script's
seconds.  It prints the ``{"kernels": [...]}``
line (seven kernels; `merge_ranks` also with ``floor_ms``,
``hub_burst_ms``, ``sort_ms`` and ``forced_ms`` by case) before the last
and ends with
``{"ok": true, "device": {...}}``.  Without CUDA, or without the
``graphlearn_tpu_torch`` package beside it, it exits nonzero and prints
no result.
"""
from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

NUM_NODES = 2_449_029               # ogbn-products node count
AVG_DEG = 25
DEVICE = 'cuda'
FEAT_DIM = 100
FANOUTS = (15, 10, 5)
BUCKETS = (1, 2, 4, 8, 16)
HBM_BYTES_PER_S = 3.35e12           # H100 SXM HBM3
#: the host link's peak one way: PCIe Gen5 x16, 128 GB/s both ways
#: (NVIDIA's H100 SXM data sheet)
LINK_BYTES_PER_S = 64e9
REPS = 30
N_REQUESTS = 256
N_CLIENTS = 4
INGEST_BATCHES = 8
INGEST_EVENTS = 4096
GNS_BATCH = 1024
GNS_SPLIT = 0.3
GNS_CLASSES = 47
GNS_WARM = 2
GNS_TIMED = 8
WINDOW_BATCH = 8192
WINDOW_W = 128
WINDOW_ITERS = 30
TRAIN_BATCH = 1024
TRAIN_LR = 3e-3
TRAIN_WARM = 3
TRAIN_EPOCHS = 2
TRAIN_SPLIT_STEPS = 5
TREE_EPOCHS = 3
EVAL_BATCHES = 20
BURST_ITERS = 30
ROOFLINE_IDS = 1 << 20
ROOFLINE_ITERS = 20
EVENTS_SLEEP_CYCLES = 20_000_000    # ~10 ms at the H100's SM clock
MESH_PARTS = 8                      # `bench.py`'s DIST_PARTS
MESH_BATCH = 512                    # per partition, `bench.py`'s DIST_BATCH
MESH_EPOCHS = 3
MESH_BATCHES_PER_EPOCH = 4
MESH_SPLIT = 0.3
MESH_WARM = 2
MESH_TIMED = 6
MESH_EVAL_BATCHES = 4


def emit(phase: str, **fields) -> None:
  print(json.dumps({'phase': phase, **fields}), flush=True)


def products_graph(torch, device, seed=0):
  """The `benchmarks/common.py` recipe on the card: uniform sources,
  targets uniform or (30%) squared-uniform hubs; CSR sorted by
  (row, col)."""
  n, e = NUM_NODES, NUM_NODES * AVG_DEG
  g = torch.Generator(device=device).manual_seed(seed)
  rows = torch.randint(0, n, (e,), generator=g, device=device)
  hub = torch.rand(e, generator=g, device=device) < 0.3
  u = torch.rand(e, generator=g, device=device)
  cols = torch.where(hub, (u * u * n).long(), (u * n).long())
  del hub, u
  key = torch.sort(rows * n + cols).values
  del cols
  indptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
  indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
  indices = (key % n).to(torch.int32)
  return indptr, indices


def arm_graph(torch, device, k, w, rows=4096, seed=1):
  """A CSR whose rows cycle through every sampler arm: empty, take-all
  (1..k), window (k+1..w) and beyond-window hubs (w+1..4w)."""
  rng = np.random.default_rng(seed + k)
  kind = np.arange(rows) % 4
  deg = np.where(kind == 0, 0, np.where(
      kind == 1, rng.integers(1, k + 1, rows), np.where(
          kind == 2, rng.integers(k + 1, w + 1, rows),
          rng.integers(w + 1, 4 * w + 1, rows))))
  indptr = np.zeros(rows + 1, np.int64)
  np.cumsum(deg, out=indptr[1:])
  indices = rng.integers(0, rows, int(indptr[-1])).astype(np.int32)
  seeds = rng.permutation(rows).astype(np.int32)
  seeds[::97] = -1
  return (torch.from_numpy(indptr).to(device),
          torch.from_numpy(indices).to(device),
          torch.from_numpy(seeds).to(device))


class Timer:
  """Device time of one call by CUDA events, median over `REPS` warm
  calls.  Before each call a 128 MiB buffer is rewritten, so the 50 MB
  L2 starts cold as it does for a serving dispatch's scattered reads,
  and the card is kept busy for a few milliseconds (`torch.cuda._sleep`)
  while the host enqueues the events and the call: the events then
  time the device work, not the Python wrapper's launch overhead
  (that overhead shows in the serve phase's latencies)."""

  SLEEP_CYCLES = 5_000_000          # ~3 ms at the H100's SM clock

  def __init__(self, torch):
    self.torch = torch
    self.flush = torch.empty(128 << 20, dtype=torch.uint8, device=DEVICE)

  def __call__(self, fn) -> float:
    torch = self.torch
    for _ in range(3):
      fn()
    times = []
    for _ in range(REPS):
      self.flush.zero_()
      start = torch.cuda.Event(enable_timing=True)
      end = torch.cuda.Event(enable_timing=True)
      torch.cuda._sleep(self.SLEEP_CYCLES)
      start.record()
      fn()
      end.record()
      end.synchronize()
      times.append(start.elapsed_time(end))
    return float(np.median(times))


def sample_bytes(deg: np.ndarray, k: int, w: int) -> int:
  """Bytes the sampler must move for these rows, by arm: the seed and
  its two indptr entries, the draws its arm reads (a Gumbel per window
  entry in degree, or k uniforms), the neighbor ids it returns, and the
  ``[k]`` int32 + bool outputs."""
  deg = deg.astype(np.int64)
  take = np.clip(deg, 0, k)
  draws = np.where((deg > k) & (deg <= w), deg, np.where(deg > w, k, 0))
  per_row = 4 + 16 * (deg >= 0) + 4 * draws + 4 * take + 5 * k
  return int(per_row.sum())


def sync(torch) -> None:
  if DEVICE == 'cuda':
    torch.cuda.synchronize()


def check_sampler(torch, ops, timer, indptr, indices, seeds, k, u, g):
  before = ops.sample_one_hop_fused.launches
  got = ops.sample_one_hop_fused(indptr, indices, seeds, k, u, g)
  ref = ops.sample_one_hop(indptr, indices, seeds, k, u, g)
  sync(torch)
  if not (torch.equal(got.nbrs, ref.nbrs) and torch.equal(got.mask,
                                                          ref.mask)):
    bad = int((got.nbrs != ref.nbrs).sum())
    raise AssertionError(f'sampler kernel != plain version (k={k}, '
                         f'{bad} slots differ)')
  err = int((got.nbrs.long() - ref.nbrs.long()).abs().max())
  deg = ops.lookup_degree(indptr, seeds).cpu().numpy()
  deg = np.where(seeds.cpu().numpy() >= 0, deg, -1)
  w = g.shape[1]
  nbytes = sample_bytes(deg, k, w)
  rec = {
      'rows': int(seeds.numel()), 'k': k, 'w': w,
      'arms': {'empty_or_invalid': int((deg <= 0).sum()),
               'take_all': int(((deg > 0) & (deg <= k)).sum()),
               'window': int(((deg > k) & (deg <= w)).sum()),
               'hub': int((deg > w).sum())},
      'byte_equal': True, 'max_abs_err': err,
      'kernel_ms': timer(lambda: ops.sample_one_hop_fused(
          indptr, indices, seeds, k, u, g)),
      'plain_ms': timer(lambda: ops.sample_one_hop(
          indptr, indices, seeds, k, u, g)),
      'bytes': nbytes, 'bound_us': nbytes / HBM_BYTES_PER_S * 1e6}
  rec['launches'] = ops.sample_one_hop_fused.launches - before
  return got, rec


def check_gather(torch, ops, timer, table, ids):
  before = ops.gather_rows.launches
  got = ops.gather_rows(table, ids)
  ref = ops.gather_rows_plain(table, ids)
  sync(torch)
  if not torch.equal(got.view(torch.uint8), ref.view(torch.uint8)):
    raise AssertionError(f'gather kernel != plain version ({table.dtype})')
  err = float((got.float() - ref.float()).abs().max())
  safe = ids.clamp(min=0).long()
  n_valid = int((ids >= 0).sum())
  row = table.shape[1] * table.element_size()
  nbytes = ids.numel() * ids.element_size() + n_valid * row \
      + ids.numel() * row
  rec = {'ids': int(ids.numel()), 'valid': n_valid,
         'dtype': str(table.dtype).replace('torch.', ''),
         'row_bytes': row, 'byte_equal': True, 'max_abs_err': err,
         'kernel_ms': timer(lambda: ops.gather_rows(table, ids)),
         'plain_ms': timer(lambda: ops.gather_rows_plain(table, ids)),
         'library_ms': timer(lambda: torch.index_select(table, 0, safe)),
         'bytes': nbytes, 'bound_us': nbytes / HBM_BYTES_PER_S * 1e6}
  rec['launches'] = ops.gather_rows.launches - before
  return rec


#: K2's forced row layouts: (row bytes, element dtype, base offset in
#: elements).  Rows of at most 16 bytes take one thread a row; 24-256
#: bytes lane groups of 4, 2, 4, 8 and 16 lanes; 200 (bf16, 8-byte
#: vectors), 400 (16-byte; 4-byte at a 4-byte base offset) and the
#: 402-byte slice at an odd 2-byte offset (2-byte vectors) the wide
#: path.
GATHER_LAYOUTS = ((2, 'int16', 0), (4, 'int32', 0), (8, 'int32', 0),
                  (12, 'int32', 0), (16, 'int32', 0), (24, 'int32', 0),
                  (32, 'int32', 0), (64, 'int32', 0), (128, 'int32', 0),
                  (256, 'int32', 0), (200, 'bfloat16', 0),
                  (400, 'float32', 0), (400, 'float32', 1),
                  (402, 'int16', 1))


def forced_gather_sets(torch, ops, n=100_003, b=70_001, seed=11):
  """K2 against its plain version (byte-equal) on every row layout of
  `GATHER_LAYOUTS`, each with int32 and int64 ids, with and without an
  ``id2index`` (shorter than the id range, with unmapped entries), the
  ids holding repeats, invalid ids and ids past N; ``b`` is a multiple
  of no block's row count, and the small counts 3,001 and 1,001 take
  the wide path's smaller row counts a warp."""
  gen = torch.Generator(device=DEVICE).manual_seed(seed)
  rng = np.random.default_rng(seed)
  ids = rng.integers(0, n, b)
  ids[::13] = -1
  ids[5::17] = -7
  ids[7::19] = n + rng.integers(0, 5, len(ids[7::19]))
  ids[:4] = (0, n - 1, n - 1, 0)
  id2 = rng.permutation(n)[:n - 1_000].astype(np.int32)
  id2[::23] = -1
  # b, and two small counts (1 and 2 wide rows a warp on the H100)
  id_sets = {(dt, m, nb): (
      torch.from_numpy(ids[:nb].astype(dt)).to(DEVICE),
      None if not m else torch.from_numpy(id2).to(DEVICE))
      for dt in (np.int32, np.int64) for m in (False, True)
      for nb in (b, 3_001, 1_001)}
  checked = []
  for row_bytes, dtype, offset in GATHER_LAYOUTS:
    dt = getattr(torch, dtype)
    item = torch.empty(0, dtype=dt).element_size()
    d = row_bytes // item
    if dt.is_floating_point:
      flat = torch.randn(n * d + offset, generator=gen, device=DEVICE)
      flat = flat.to(dt)
    else:
      info = torch.iinfo(dt)
      flat = torch.randint(info.min, info.max, (n * d + offset,),
                           generator=gen, device=DEVICE, dtype=dt)
    table = flat[offset:].view(n, d)
    for (dt_ids, with_map, nb), (ids_t, m) in id_sets.items():
      got = ops.gather_rows(table, ids_t, m)
      ref = ops.gather_rows_plain(table, ids_t, m)
      if not torch.equal(got.view(torch.uint8), ref.view(torch.uint8)):
        raise AssertionError(
            f'gather kernel != plain version ({row_bytes} B rows, {nb} '
            f'{np.dtype(dt_ids).name} ids, id2index {with_map})')
    checked.append({'row_bytes': row_bytes, 'dtype': dtype,
                    'base_offset_bytes': offset * item})
    del flat, table
  return {'ids': [b, 3_001, 1_001], 'table_rows': n, 'layouts': checked,
          'cases': len(checked) * len(id_sets), 'byte_equal': True}


#: K1's forced fanouts: both sides of every lane-group width (4, 8, 16,
#: 32 lanes a row)
SAMPLER_FANOUTS = (1, 4, 5, 8, 15, 16, 17, 32)


def forced_sampler_sets(torch, ops, seed=13):
  """K1 against its plain version (byte-equal) at every k of
  `SAMPLER_FANOUTS`, at the default window and at 256, on 150,001 and
  20,001 rows (lane groups of clamp(next_pow2(k), 4, 32) lanes, two
  passes and one pass a warp) and 1,001 (a warp a row): rows of every
  arm (deg 0, deg <= k, k < deg <= w, deg > w), invalid and
  out-of-range seeds, eight Gumbels tied at the top across lane-group
  boundaries (columns 3, 4, 7, 8, 15, 16, 31, 32), ties every 7th
  column, and u just below 1."""
  from graphlearn_tpu_torch.ops import default_window
  sets = [(k, w, rows) for k in SAMPLER_FANOUTS
          for w in sorted({default_window(k), 256})
          for rows in (150_001, 20_001, 1_001)]
  out = []
  for k, w, rows in sets:
    indptr, indices, seeds = arm_graph(torch, DEVICE, k, w, rows=rows,
                                       seed=seed)
    seeds[3::101] = rows + 3
    gen = torch.Generator(device=DEVICE).manual_seed(seed + k + w)
    u = torch.rand(rows, k, device=DEVICE, generator=gen)
    u[::11, 0] = float(np.nextafter(np.float32(1), np.float32(0)))
    g = torch.rand(rows, w, device=DEVICE, generator=gen)
    g[:, ::7] = 0.5
    top = [c for c in (3, 4, 7, 8, 15, 16, 31, 32) if c < w]
    g[:, top] = 2.0
    got = ops.sample_one_hop_fused(indptr, indices, seeds, k, u, g)
    ref = ops.sample_one_hop(indptr, indices, seeds, k, u, g)
    if not (torch.equal(got.nbrs, ref.nbrs)
            and torch.equal(got.mask, ref.mask)):
      bad = int((got.nbrs != ref.nbrs).sum())
      raise AssertionError(f'sampler kernel != plain version (forced '
                           f'k={k}, w={w}, {rows} rows, {bad} slots)')
    out.append({'k': k, 'w': w, 'rows': rows})
  return {'sets': out, 'byte_equal': True}


def merge_bytes(n_rows: int, n_base: int, n_events: int) -> int:
  """Bytes the rank kernel must move: per dirty row its base start and
  width, segment offset and count and output offset (five int64); every
  base column and new column read once; one int32 rank written per
  column."""
  return n_rows * 40 + 4 * (n_base + n_events) * 2


def merge_case(torch, ops, indptr_h, indptr, indices, rows, seg_cnt,
               seg_cols):
  """One `merge_ranks` call over a CSR (``indptr_h`` on the host,
  ``indptr`` and ``indices`` on the card): the dirty ``rows`` (any ids,
  in this order) with ``seg_cnt`` new columns each, ``seg_cols`` their
  columns row after row in event order.  Returns ``(kernel, plain,
  shape)``: the kernel's and the plain version's calls on the card's
  inputs, and the shape's numbers.  A tree whose `merge_ranks` still
  takes row ids and ``indptr`` (no ``ops.rank_rows``: the first port's
  interface) is called that way, so this script times both trees'
  kernels on the same shapes."""
  rows = np.asarray(rows, np.int64)
  seg_cnt = np.asarray(seg_cnt, np.int64)
  start = indptr_h[rows]
  base_cnt = indptr_h[rows + 1] - start
  seg_off = np.zeros(len(rows), np.int64)
  np.cumsum(seg_cnt[:-1], out=seg_off[1:])
  base_out = np.zeros(len(rows), np.int64)
  np.cumsum(base_cnt[:-1], out=base_out[1:])
  n_base = int(base_cnt.sum())

  def up(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(DEVICE)

  cols = up(seg_cols, np.int32)
  if hasattr(ops, 'rank_rows'):
    args = (ops.rank_rows(start, base_cnt, seg_off, seg_cnt, base_out,
                          DEVICE), indices, cols)
  else:
    args = (up(rows, np.int64), indptr, indices, up(seg_off, np.int64),
            up(seg_cnt, np.int32), cols, up(base_out, np.int64), n_base)
  shape = {'rows': len(rows), 'base_cols': n_base,
           'events': int(seg_cnt.sum()),
           'max_base_width': int(base_cnt.max()),
           'max_new_width': int(seg_cnt.max()),
           'empty_base_rows': int((base_cnt == 0).sum()),
           'empty_new_rows': int((seg_cnt == 0).sum())}
  return (lambda: ops.merge_ranks(*args),
          lambda: ops.merge_ranks_plain(*args), shape)


def check_merge_ranks(torch, ops, timer, case, time_plain=True):
  """The rank kernel against its plain version on one `merge_case`:
  byte-equal, then the kernel (and unless told not to, the plain
  version) timed."""
  kernel, plain, shape = case
  before = ops.merge_ranks.launches
  got = kernel()
  ref = plain()
  sync(torch)
  if not all(torch.equal(g, r) for g, r in zip(got, ref)):
    bad = int((got[0] != ref[0]).sum() + (got[1] != ref[1]).sum())
    raise AssertionError(f'merge_ranks kernel != plain version ({bad} '
                         f'ranks differ, {shape})')
  err = max(int((g.long() - r.long()).abs().max()) if g.numel() else 0
            for g, r in zip(got, ref))
  del got, ref
  nbytes = merge_bytes(shape['rows'], shape['base_cols'], shape['events'])
  rec = dict(shape, byte_equal=True, max_abs_err=err,
             kernel_ms=timer(kernel), bytes=nbytes,
             bound_us=nbytes / HBM_BYTES_PER_S * 1e6)
  if time_plain:
    rec['plain_ms'] = timer(plain)
  rec['launches'] = ops.merge_ranks.launches - before
  return rec


def path_merge_case(torch, ops, indptr, indices, indptr_h, src, dst):
  """The `merge_case` of one segment over the products CSR, its rows
  and columns made the way `merge_delta_csr_device` makes them."""
  ri = ops.rank_inputs(indptr_h, src)
  return merge_case(torch, ops, indptr_h, indptr, indices, ri.rows,
                    ri.seg_cnt, dst[ri.order])


def sort_yardstick(torch, timer, indptr, indices, rows, src, dst):
  """``sort_ms``: a stable `torch.sort` of the (row, column) keys of the
  dirty rows' base columns followed by the new edges in event order, as
  `static_csr` builds them, then the scatter of the inverse permutation
  (every element's position in the sorted order): two calls, timed as
  the rank kernel is.  A yardstick only; the port never calls it."""
  n = NUM_NODES
  rows_t = torch.from_numpy(np.asarray(rows, np.int64)).to(DEVICE)
  cnt = indptr[rows_t + 1] - indptr[rows_t]
  base_rows = torch.repeat_interleave(rows_t, cnt)
  out = torch.cumsum(cnt, 0) - cnt
  pos = (torch.repeat_interleave(indptr[rows_t] - out, cnt)
         + torch.arange(base_rows.numel(), device=DEVICE))
  key = torch.cat([base_rows * n + indices[pos].long(),
                   torch.from_numpy(np.asarray(src, np.int64) * n
                                    + np.asarray(dst, np.int64)).to(DEVICE)])
  iota = torch.arange(key.numel(), device=DEVICE)
  rank = torch.empty_like(iota)

  def sort_and_scatter():
    rank[torch.sort(key, stable=True).indices] = iota

  return timer(sort_and_scatter)


def ranks_alone_ms(torch, indptr_h, indices_h, indices, src, dst, n=3):
  """The publish's ``ranks`` phase of one segment over the products CSR
  (`merge_delta_csr_device`'s ``timings['ranks']``: the host's rank
  inputs and launch plan, the upload, the kernel, the download) with
  nothing else running: the median of ``n`` merges, host clock."""
  from graphlearn_tpu_torch.ops import merge_delta_csr_device
  from graphlearn_tpu_torch.streaming import DeltaSegment
  eids = np.arange(indices_h.size, dtype=np.int64)
  seg = DeltaSegment(src=src, dst=dst,
                     eids=np.arange(len(src), dtype=np.int64) + eids.size)
  times = []
  for _ in range(n):
    t = {}
    merge_delta_csr_device(indptr_h, indices_h, eids, seg,
                           indices_dev=indices, device=DEVICE, timings=t)
    times.append(t['ranks'] * 1e3)
  return float(np.median(times))


def own_csr(torch, rng, widths, draw):
  """A CSR whose odd rows have ``widths`` sorted columns from
  ``draw(size)`` and whose even rows (never dirty) 0-3: the dirty
  rows' ids, returned, are not contiguous."""
  n = len(widths)
  deg = np.zeros(2 * n, np.int64)
  deg[1::2] = widths
  deg[0::2] = rng.integers(0, 4, n)
  indptr = np.zeros(2 * n + 1, np.int64)
  np.cumsum(deg, out=indptr[1:])
  indices = np.concatenate([np.sort(draw(int(d))) for d in deg])
  return (indptr, torch.from_numpy(indptr).to(DEVICE),
          torch.from_numpy(indices.astype(np.int32)).to(DEVICE),
          2 * np.arange(n) + 1)


INT32_MAX = 2 ** 31 - 1
#: base and new widths every pair of which `forced_merge_cases` runs:
#: each side of the kernel's narrow limits (128 base, 32 new) and of a
#: warp, and an 8,192-wide base row
MERGE_BASE_WIDTHS = (0, 1, 31, 32, 33, 127, 128, 129, 8192)
MERGE_NEW_WIDTHS = (0, 1, 2, 31, 32, 33, 64, 512)
#: new columns of the row past one wide block's shared memory (8,192
#: keys): three tiles
MERGE_PAST_TILE = 20_000
MERGE_MANY_ROWS = 100_003


def forced_merge_cases(torch, ops, indptr_h, indptr, indices, path_rows,
                       seed=3):
  """``[(name, merge_case)]`` that force every branch of the rank
  kernel: the first port's 96-row forced set (unchanged, so its time stays
  comparable), every pair of `MERGE_BASE_WIDTHS` x `MERGE_NEW_WIDTHS`,
  a row past one block's shared memory, every column tied, signed
  extremes (int32 min and max, -1, 0, int32 max - 1), new columns
  already sorted and reverse-sorted, and over the products CSR 1 row,
  the path's 4,095 rows with 1-48 new columns and 100,003 rows (more
  than one wave of warps) in random order.  Own CSRs make the dirty
  rows' ids non-contiguous."""
  rng = np.random.default_rng(seed)
  cases = []

  # the first port's forced set: empty rows, base rows up to 8,192 wide,
  # new-column rows up to 512 wide, columns from [0, 64)
  n = 96
  deg = rng.integers(0, 40, n)
  deg[:4] = 0
  deg[4:8] = (8192, 2049, 4000, 2048)
  cnt = rng.integers(1, 6, n)
  cnt[[0, 4, 8]] = 512
  cnt[[5, 9]] = (300, 200)
  cnt[10:14] = 0
  ip = np.zeros(n + 1, np.int64)
  np.cumsum(deg, out=ip[1:])
  idx = np.concatenate([np.sort(rng.integers(0, 64, d))
                        for d in deg]).astype(np.int32)
  cols = rng.integers(0, 64, int(cnt.sum())).astype(np.int32)
  cases.append(('forced set', merge_case(
      torch, ops, ip, torch.from_numpy(ip).to(DEVICE),
      torch.from_numpy(idx).to(DEVICE), np.arange(n), cnt, cols)))

  def small(size):
    return rng.integers(0, 64, size)

  def segments(cnt, draw, order=None):
    segs = [draw(int(c)) for c in cnt]
    if order == 'sorted':
      segs = [np.sort(s) for s in segs]
    elif order == 'reversed':
      segs = [np.sort(s)[::-1] for s in segs]
    return np.concatenate(segs).astype(np.int32)

  def own(name, base_w, new_w, draw, order=None):
    ip, ip_d, idx_d, rows = own_csr(torch, rng, base_w, draw)
    cases.append((name, merge_case(torch, ops, ip, ip_d, idx_d, rows, new_w,
                                   segments(new_w, draw, order))))

  pairs = list(itertools.product(MERGE_BASE_WIDTHS, MERGE_NEW_WIDTHS))
  base_w = np.array([b for b, _ in pairs])
  new_w = np.array([s for _, s in pairs])
  own('every width pair', base_w, new_w, small)
  own('past a tile', np.array([1000, 0, 40]),
      np.array([MERGE_PAST_TILE, 8193, 3]),
      lambda size: rng.integers(0, 5000, size))
  own('every column tied', np.array([40, 200, 8192, 0, 128, 3, 33]),
      np.array([20, 64, 512, 33, 32, 1000, 0]),
      lambda size: np.full(size, 7))
  extremes = np.array([-2 ** 31, -1, 0, INT32_MAX - 1, INT32_MAX])
  own('signed extremes', base_w, new_w, lambda size: rng.choice(extremes,
                                                                size))
  own('sorted segments', base_w, new_w, small, 'sorted')
  own('reverse-sorted segments', base_w, new_w, small, 'reversed')

  def products(name, rows, cnt):
    cases.append((name, merge_case(
        torch, ops, indptr_h, indptr, indices, rows, cnt,
        rng.integers(0, NUM_NODES, int(np.sum(cnt))))))

  products('R = 1', rng.integers(0, NUM_NODES, 1), np.array([5]))
  products(f'R = {len(path_rows):,}', path_rows,
           rng.integers(1, 49, len(path_rows)))
  products(f'R = {MERGE_MANY_ROWS:,}',
           rng.choice(NUM_NODES, MERGE_MANY_ROWS, replace=False),
           rng.integers(1, 4, MERGE_MANY_ROWS))
  return cases


def merge_kernel(torch, ops, timer, indptr, indices, indptr_h, indices_h):
  """K4's kernel lines: the path's 4,096-event batch (with `sort_ms` and
  `ranks_alone_ms`), the hub burst (4,096 events from 64 products rows),
  the 1 x 1 floor and every forced case, each byte-equal to the plain
  version."""
  rng = np.random.default_rng(4)
  src = rng.integers(0, NUM_NODES, INGEST_EVENTS)
  dst = rng.integers(0, NUM_NODES, INGEST_EVENTS)
  path = path_merge_case(torch, ops, indptr, indices, indptr_h, src, dst)
  k4 = check_merge_ranks(torch, ops, timer, path)
  path_rows = ops.rank_inputs(indptr_h, src).rows
  k4['sort_ms'] = sort_yardstick(torch, timer, indptr, indices, path_rows,
                                 src, dst)
  k4['ranks_alone_ms'] = ranks_alone_ms(torch, indptr_h, indices_h, indices,
                                        src, dst)
  emit('kernel', kernel='merge_ranks', shape='4,096-event batch', **k4)
  hubs = rng.choice(NUM_NODES, 64, replace=False)
  hub_src = rng.choice(hubs, INGEST_EVENTS)
  hub = check_merge_ranks(torch, ops, timer, path_merge_case(
      torch, ops, indptr, indices, indptr_h, hub_src, dst))
  emit('kernel', kernel='merge_ranks', shape='hub burst', **hub)
  ip, ip_d, idx_d, rows = own_csr(torch, rng, [1], lambda size:
                                  rng.integers(0, 64, size))
  floor = check_merge_ranks(torch, ops, timer, merge_case(
      torch, ops, ip, ip_d, idx_d, rows, [1], [7]), time_plain=False)
  emit('kernel', kernel='merge_ranks', shape='floor: 1 row, 1 x 1', **floor)
  forced = {}
  for name, case in forced_merge_cases(torch, ops, indptr_h, indptr,
                                       indices, path_rows):
    rec = check_merge_ranks(torch, ops, timer, case,
                            time_plain=name == 'forced set')
    emit('kernel', kernel='merge_ranks', shape=name, **rec)
    forced[name] = rec
  return k4, hub, floor, forced


def serve(torch, ds):
  from graphlearn_tpu_torch.models import TreeSAGE
  from graphlearn_tpu_torch.ops import (gather_rows, gather_rows_plain,
                                        sample_one_hop,
                                        sample_one_hop_fused)
  from graphlearn_tpu_torch.serving import ServingEngine, ServingFrontend
  eng = ServingEngine(ds, FANOUTS, model=TreeSAGE(FEAT_DIM, 256, 47, 3),
                      seed=0, buckets=BUCKETS, device=DEVICE)
  eng.init_params(torch.Generator().manual_seed(0))
  warm = eng.warmup()
  fe = ServingFrontend(eng, max_wait_ms=2.0, default_deadline_ms=10_000.0)
  rng = np.random.default_rng(0)
  reqs = [rng.integers(0, NUM_NODES, int(rng.integers(1, 17)))
          for _ in range(N_REQUESTS)]
  results, lat, errors = [None] * len(reqs), [0.0] * len(reqs), []

  def client(lo):
    for i in range(lo, len(reqs), N_CLIENTS):
      t0 = time.perf_counter()
      try:
        results[i] = fe.submit(reqs[i]).result(60.0)
      except Exception as e:       # noqa: BLE001 — counted, then fatal
        errors.append(f'request {i}: {type(e).__name__}: {e}')
      lat[i] = (time.perf_counter() - t0) * 1e3

  for fn in (sample_one_hop_fused, gather_rows):
    fn.launches = 0
  for fn in (sample_one_hop, gather_rows_plain):
    fn.calls = 0
  threads = [threading.Thread(target=client, args=(i,))
             for i in range(N_CLIENTS)]
  t0 = time.perf_counter()
  for t in threads:
    t.start()
  for t in threads:
    t.join()
  wall = time.perf_counter() - t0
  launches = {'sample_one_hop': sample_one_hop_fused.launches,
              'gather_rows': gather_rows.launches}
  plain_calls = sample_one_hop.calls + gather_rows_plain.calls
  fe.shutdown()
  stats = fe.stats()
  if errors or stats['failed'] or any(r is None for r in results):
    raise AssertionError(f'serving failed: {errors[:3]} stats={stats}')
  d = stats['dispatches']
  if not (launches['sample_one_hop'] == len(FANOUTS) * d
          and launches['gather_rows'] >= d > 0 and plain_calls == 0):
    raise AssertionError(f'launch counts {launches}, plain calls '
                         f'{plain_calls}, dispatches {d}')
  for i, res in enumerate(results):
    n = len(reqs[i])
    if (res.nodes.shape != (n, eng.tree_width)
        or res.logits.shape != (n, 47)
        or not np.isfinite(res.logits).all()):
      raise AssertionError(f'request {i}: bad result shapes/values')
  worst = 0.0
  for i in range(16):
    ref = eng.offline_reference(reqs[i])
    if ref.nodes.tobytes() != results[i].nodes.tobytes():
      raise AssertionError(f'request {i}: nodes differ from offline')
    np.testing.assert_allclose(results[i].logits, ref.logits, rtol=1e-5,
                               atol=1e-5)
    worst = max(worst, float(np.abs(results[i].logits - ref.logits).max()))
  emit('serve', requests=len(reqs), clients=N_CLIENTS,
       seeds=int(sum(len(r) for r in reqs)), dispatches=d,
       failed=stats['failed'], shed=stats['shed'],
       warmup_secs=warm['secs'], wall_secs=wall,
       requests_per_s=len(reqs) / wall,
       latency_ms={'p50': float(np.percentile(lat, 50)),
                   'p99': float(np.percentile(lat, 99)),
                   'max': float(np.max(lat))},
       launches=launches, plain_calls=plain_calls,
       offline_checked=16, offline_logits_max_abs_diff=worst)
  return eng, launches, reqs, lat


def small_cross_check(torch):
  """A small graph served on the card (kernels) and on the CPU (plain
  versions) with the same CPU-made draws: nodes byte-equal, logits
  within 1e-5."""
  from graphlearn_tpu_torch.data import Dataset
  from graphlearn_tpu_torch.models import TreeSAGE
  from graphlearn_tpu_torch.ops import hash_draws
  from graphlearn_tpu_torch.serving import ServingEngine
  rng = np.random.default_rng(5)
  n = 3000
  rows = rng.integers(0, n, n * 20)
  rows = np.concatenate([rows, np.full(300, 7)])      # one hub row
  cols = rng.integers(0, n, rows.shape[0])
  feats = rng.standard_normal((n, 16)).astype(np.float32)

  def cpu_draws(seed_ids, t, f, k, w):
    u, g = hash_draws(3, seed_ids.cpu(), t, f, k, w)
    return u.to(seed_ids.device), g.to(seed_ids.device)

  out = {}
  seeds = np.array([7, 1, 2, 3, 999, 2999, 15], np.int64)
  for dev in (DEVICE, 'cpu'):
    ds = (Dataset().init_graph((rows, cols), num_nodes=n, device=dev)
          .init_node_features(feats, device=dev))
    eng = ServingEngine(ds, FANOUTS, model=TreeSAGE(16, 32, 7, 3),
                        seed=3, buckets=(8,), device=dev, draws=cpu_draws)
    eng.init_params(torch.Generator().manual_seed(1))
    out[dev] = eng.infer(seeds)
  card, cpu = out[DEVICE], out['cpu']
  if card.nodes.tobytes() != cpu.nodes.tobytes():
    raise AssertionError('card and CPU trees differ on the small graph')
  np.testing.assert_allclose(card.logits, cpu.logits, rtol=1e-5, atol=1e-5)
  emit('cross_check', nodes_byte_equal=True,
       logits_max_abs_diff=float(np.abs(card.logits - cpu.logits).max()))


def static_csr(torch, indptr_h, indices, batches):
  """The CSR of the base edges (in CSR order) followed by every ingested
  event, built on the card by a STABLE sort on ``row * N + col`` — the
  counterpart of `coo_to_csr`; edge ids are positions in that order."""
  n = NUM_NODES
  deg = torch.from_numpy(np.diff(indptr_h)).to(DEVICE)
  base_rows = torch.repeat_interleave(torch.arange(n, device=DEVICE), deg)
  src = torch.from_numpy(np.concatenate([b[0] for b in batches])).to(DEVICE)
  dst = torch.from_numpy(np.concatenate([b[1] for b in batches])).to(DEVICE)
  key = torch.cat([base_rows * n + indices.long(), src * n + dst])
  rows = torch.cat([base_rows, src])
  del base_rows
  eids = torch.sort(key, stable=True).indices
  out_indices = (key[eids] % n).to(torch.int32)
  out_indptr = torch.zeros(n + 1, dtype=torch.int64, device=DEVICE)
  out_indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
  return out_indptr, out_indices, eids


def ingest(torch, feat, indptr, indices, indptr_h, indices_h, reqs,
           serve_lat):
  """Serve the serve phase's requests from 4 closed-loop clients while
  an `IngestPipeline` applies `INGEST_BATCHES` uniform batches to a
  `StreamingGraph` of the products CSR; then hold the final graph and
  16 quiesced requests against a static construction."""
  import shutil
  import tempfile
  from graphlearn_tpu_torch.data import Dataset
  from graphlearn_tpu_torch.models import TreeSAGE
  from graphlearn_tpu_torch.ops import (gather_rows, gather_rows_plain,
                                        merge_ranks, merge_ranks_plain,
                                        sample_one_hop,
                                        sample_one_hop_fused)
  from graphlearn_tpu_torch.serving import ServingEngine, ServingFrontend
  from graphlearn_tpu_torch.streaming import IngestPipeline, StreamingGraph
  from graphlearn_tpu_torch.telemetry import recorder
  from graphlearn_tpu_torch.utils import next_power_of_two
  t0 = time.perf_counter()
  cap = next_power_of_two(indices_h.size)
  sg = StreamingGraph(indptr_h, indices_h, num_nodes=NUM_NODES,
                      reserve_edges=cap, device=DEVICE)
  stream_secs = time.perf_counter() - t0
  eng = ServingEngine(Dataset(node_features=feat).attach_stream(sg),
                      FANOUTS, model=TreeSAGE(FEAT_DIM, 256, 47, 3),
                      seed=0, buckets=BUCKETS, device=DEVICE)
  eng.init_params(torch.Generator().manual_seed(0))
  fe = ServingFrontend(eng, max_wait_ms=2.0, default_deadline_ms=10_000.0)
  wal_dir = tempfile.mkdtemp(prefix='glt_wal_')
  pipe = IngestPipeline(sg, wal_dir=wal_dir, compact_every=0)
  rng = np.random.default_rng(11)
  batches = [(rng.integers(0, NUM_NODES, INGEST_EVENTS),
              rng.integers(0, NUM_NODES, INGEST_EVENTS))
             for _ in range(INGEST_BATCHES)]
  done = threading.Event()
  lat, during, errors, ingest_walls = [], [], [], []
  lock = threading.Lock()

  def ingest_loop():
    try:
      for src, dst in batches:
        t = time.perf_counter()
        pipe.ingest(src, dst)
        ingest_walls.append(time.perf_counter() - t)
    except Exception as e:         # noqa: BLE001 — counted, then fatal
      errors.append(f'ingest: {type(e).__name__}: {e}')
    finally:
      done.set()

  def client(c):
    i = c
    while i < N_REQUESTS or not done.is_set():
      live_ingest = not done.is_set()
      t = time.perf_counter()
      try:
        res = fe.submit(reqs[i % len(reqs)]).result(60.0)
        if not np.isfinite(res.logits).all():
          raise AssertionError('non-finite logits')
      except Exception as e:       # noqa: BLE001 — counted, then fatal
        errors.append(f'request {i}: {type(e).__name__}: {e}')
      with lock:
        lat.append((time.perf_counter() - t) * 1e3)
        during.append(live_ingest and not done.is_set())
      i += N_CLIENTS

  recorder.enable()
  recorder.clear()
  for fn in (sample_one_hop_fused, gather_rows, merge_ranks):
    fn.launches = 0
  for fn in (sample_one_hop, gather_rows_plain, merge_ranks_plain):
    fn.calls = 0
  threads = [threading.Thread(target=ingest_loop)] + [
      threading.Thread(target=client, args=(c,)) for c in range(N_CLIENTS)]
  t0 = time.perf_counter()
  for t in threads:
    t.start()
  threads[0].join()
  ingest_wall = time.perf_counter() - t0
  for t in threads[1:]:
    t.join()
  launches = {'sample_one_hop': sample_one_hop_fused.launches,
              'gather_rows': gather_rows.launches,
              'merge_ranks': merge_ranks.launches}
  plain_calls = (sample_one_hop.calls + gather_rows_plain.calls
                 + merge_ranks_plain.calls)
  fe.shutdown()
  stats = fe.stats()
  health = pipe.health()
  pubs = recorder.events('stream.publish')
  recorder.disable()
  pipe.close()
  shutil.rmtree(wal_dir, ignore_errors=True)
  d = stats['dispatches']
  if errors or stats['failed']:
    raise AssertionError(f'ingest phase failed: {errors[:3]} '
                         f'stats={stats}')
  if health['lag_events'] != 0 or not health['healthy']:
    raise AssertionError(f'ingest lag after the run: {health}')
  if not (launches['merge_ranks'] == len(batches) == len(pubs)
          and launches['sample_one_hop'] == len(FANOUTS) * d
          and launches['gather_rows'] >= d > 0 and plain_calls == 0):
    raise AssertionError(f'launch counts {launches}, plain calls '
                         f'{plain_calls}, dispatches {d}, publishes '
                         f'{len(pubs)}')
  if sg.edge_capacity != cap:
    raise AssertionError(f'edge capacity moved: {cap} -> '
                         f'{sg.edge_capacity}')

  # the final CSR against a stable sort of every edge on the card
  view = sg.pin()
  ref_indptr, ref_indices, ref_eids = static_csr(torch, indptr_h, indices,
                                                 batches)
  e = view.num_edges
  for name, got, ref in (
      ('indptr', torch.from_numpy(view.indptr).to(DEVICE), ref_indptr),
      ('indices', torch.from_numpy(view.indices).to(DEVICE), ref_indices),
      ('edge_ids', torch.from_numpy(view.edge_ids).to(DEVICE), ref_eids),
      ('indptr_dev', view.indptr_dev, ref_indptr),
      ('indices_dev', view.indices_dev[:e], ref_indices)):
    if got.dtype != ref.dtype or not torch.equal(got, ref):
      raise AssertionError(f'final {name} differs from the static CSR')
  del ref_eids

  # quiesced: the stream engine against a static engine over that CSR
  static = ServingEngine(
      Dataset(node_features=feat).init_graph(
          (ref_indptr, ref_indices), layout='CSR', num_nodes=NUM_NODES,
          device=DEVICE),
      FANOUTS, model=TreeSAGE(FEAT_DIM, 256, 47, 3), seed=0,
      buckets=BUCKETS, device=DEVICE)
  static.init_params(torch.Generator().manual_seed(0))
  worst = 0.0
  for i in range(16):
    got, want = eng.infer(reqs[i]), static.infer(reqs[i])
    if got.nodes.tobytes() != want.nodes.tobytes():
      raise AssertionError(f'quiesced request {i}: nodes differ from the '
                           'static engine')
    np.testing.assert_allclose(got.logits, want.logits, rtol=1e-5,
                               atol=1e-5)
    worst = max(worst, float(np.abs(got.logits - want.logits).max()))
  if eng.graph_version != sg.version or sg.version != 1 + len(batches):
    raise AssertionError(f'engine version {eng.graph_version}, stream '
                         f'{sg.version}')

  def split(key):
    vals = [p[key] for p in pubs]
    return {'mean': float(np.mean(vals)), 'max': float(np.max(vals))}

  lat_in = [x for x, f in zip(lat, during) if f]
  events = len(batches) * INGEST_EVENTS
  emit('ingest', batches=len(batches), events_per_batch=INGEST_EVENTS,
       base_edges=int(indices_h.size), final_edges=e, edge_capacity=cap,
       stream_build_secs=stream_secs, ingest_wall_secs=ingest_wall,
       events_per_s=events / ingest_wall,
       ingest_call_ms=[x * 1e3 for x in ingest_walls],
       publish_ms={k: split(f'{k}_ms') for k in
                   ('shift', 'ranks', 'scatter', 'copy', 'total')},
       versions_published=len(pubs), final_version=sg.version,
       engine_version=eng.graph_version, final_lag=health['lag_events'],
       requests=len(lat), requests_during_ingest=len(lat_in),
       dispatches=d, failed=stats['failed'], shed=stats['shed'],
       latency_during_ingest_ms={
           'p50': float(np.percentile(lat_in, 50)),
           'p99': float(np.percentile(lat_in, 99)),
           'max': float(np.max(lat_in))} if lat_in else None,
       latency_serve_phase_ms={
           'p50': float(np.percentile(serve_lat, 50)),
           'p99': float(np.percentile(serve_lat, 99))},
       launches=launches, plain_calls=plain_calls,
       final_csr_byte_equal=True, quiesced_checked=16,
       quiesced_logits_max_abs_diff=worst)
  return launches


def chaos_recover(torch):
  """Kill at the ``ingest.apply`` seam on a small graph on the card,
  recover in a new pipeline over the same WAL (compacting every 2
  batches, so recovery restores a snapshot and replays the tail), and
  hold the graph to a fault-free run's, device twins included."""
  import shutil
  import tempfile
  from graphlearn_tpu_torch.streaming import IngestPipeline, StreamingGraph
  from graphlearn_tpu_torch.testing import chaos
  rng = np.random.default_rng(21)
  n = 5000
  rows, cols = rng.integers(0, n, 20 * n), rng.integers(0, n, 20 * n)
  batches = [(rng.integers(0, n, 300), rng.integers(0, n, 300))
             for _ in range(6)]

  def drive(wal_dir, plan):
    def fresh():
      return IngestPipeline(
          StreamingGraph.from_coo(rows, cols, num_nodes=n, device=DEVICE),
          wal_dir=wal_dir, compact_every=2)
    pipe, kills = fresh(), 0
    if plan:
      chaos.install(plan)
    try:
      for src, dst in batches:
        try:
          pipe.ingest(src, dst)
        except chaos.ChaosKilledError:
          kills += 1
          pipe.close()
          pipe = fresh()
    finally:
      chaos.uninstall()
    view = pipe.stream.pin()
    pipe.close()
    return view, kills

  root = tempfile.mkdtemp(prefix='glt_chaos_')
  try:
    ref, _ = drive(os.path.join(root, 'ref'), None)
    got, kills = drive(os.path.join(root, 'kill'), 'ingest.apply:kill:3')
  finally:
    shutil.rmtree(root, ignore_errors=True)
  same = (kills == 1 and got.version == ref.version
          and all(np.array_equal(getattr(got, k), getattr(ref, k))
                  for k in ('indptr', 'indices', 'edge_ids'))
          and torch.equal(got.indptr_dev, ref.indptr_dev)
          and torch.equal(got.indices_dev, ref.indices_dev))
  if not same:
    raise AssertionError(f'recovered graph differs (kills={kills})')
  emit('chaos', site='ingest.apply', action='kill', kills=kills,
       version=got.version, edges=got.num_edges, byte_identical=True)


def make_labels(torch, feats):
  """Learnable labels: ``argmax(feats @ P)`` for a seeded ``[100, 47]``
  P, int32 on the card."""
  proj = torch.randn(FEAT_DIM, GNS_CLASSES, device=DEVICE,
                     generator=torch.Generator(device=DEVICE).manual_seed(2))
  return torch.argmax(feats @ proj, dim=1).to(torch.int32)


def train_splits():
  """BASELINE config 1's split (`bench.py:227`): the first ``n // 12``
  of a seeded permutation trains (200 batches of 1,024); the next
  `EVAL_BATCHES` batches are the test split."""
  perm = np.random.default_rng(0).permutation(NUM_NODES)
  n_train = NUM_NODES // 12
  return perm[:n_train], perm[n_train:n_train + EVAL_BATCHES * TRAIN_BATCH]


def events_ms(torch, fns) -> float:
  """Device ms of ``fns`` called back to back, by two CUDA events; the
  card sleeps first (`torch.cuda._sleep`) while the host enqueues, so
  the events time the device work, not the host's launch rate."""
  sync(torch)
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  torch.cuda._sleep(EVENTS_SLEEP_CYCLES)
  start.record()
  for fn in fns:
    fn()
  end.record()
  end.synchronize()
  return start.elapsed_time(end)


#: K3's forced widths: odd widths, both sides of a 32-id step, of 128
#: (a lane's four loads before its stores) and of 192, and 256
WINDOW_WIDTHS = (1, 3, 16, 33, 64, 127, 128, 129, 200, 256)
#: K3's forced row counts: fewer rows than a block takes, a row count
#: that is not a multiple of a block's, the path's, and more than a wave
WINDOW_ROWS = (1, 7, 8_192, 100_003)


def forced_window_sets(torch, indices, seed=19):
  """K3 against its plain version (byte-equal) at every width of
  `WINDOW_WIDTHS` and row count of `WINDOW_ROWS`, with int64 and int32
  starts, over four arrays: the products ``indices``; the same one
  element in (a base that is not 16-byte aligned, so every width takes
  a 16-byte load); 37 ids (E < w from w 64 on); and one id.  The starts
  hold 0-3, E-4 to E-1, E-w to E-w+3 (every residue mod 4 near both
  ends), -1, -w-3, E, E+12,345 and -2^20, then uniform starts in [-8,
  E+8).  Returns the number of cases."""
  from graphlearn_tpu_torch.ops import window_gather as wg
  rng = np.random.default_rng(seed)
  arrays = {'products': indices, 'products[1:]': indices[1:],
            'E=37': torch.from_numpy(rng.integers(
                0, 1 << 30, 37).astype(np.int32)).to(DEVICE),
            'E=1': torch.tensor([123456], dtype=torch.int32, device=DEVICE)}
  cases = 0
  for name, ind in arrays.items():
    e = ind.numel()
    for w in WINDOW_WIDTHS:
      special = np.array([0, 1, 2, 3, e - 4, e - 3, e - 2, e - 1, e - w,
                          e - w + 1, e - w + 2, e - w + 3, -1, -w - 3, e,
                          e + 12_345, -(1 << 20)], np.int64)
      for rows in WINDOW_ROWS:
        st = rng.integers(-8, e + 8, rows)
        n_sp = min(rows, len(special))
        st[:n_sp] = np.roll(special, -w)[:n_sp]
        st = torch.from_numpy(st).to(DEVICE)
        for s in (st, st.to(torch.int32)):
          got = wg.csr_window_gather(ind, s, w)
          ref = wg.csr_window_gather_plain(ind, s, w)
          if got.shape != (rows, w) or not torch.equal(got, ref):
            raise AssertionError(f'window kernel != plain version (forced '
                                 f'{name}, w={w}, {rows} rows, {s.dtype})')
          cases += 1
  return cases


def window(torch, ops, timer, indptr, indices):
  """Path C, the window-gather entry point (the port's
  `benchmarks/bench_pallas_window.py`): `csr_window_gather` over the
  products ``indices`` at 8,192 starts x 128, 30 back-to-back calls on
  distinct seed sets; beside it the plain version, one `index_select`
  over the flat positions (built outside the timed calls) and one full
  K1 hop at k = 15 over the same seeds.  Byte-equal on every timed
  input and on the forced set."""
  from graphlearn_tpu_torch.ops import window_gather as wg
  b, w, iters = WINDOW_BATCH, WINDOW_W, WINDOW_ITERS
  e = indices.numel()
  rng = np.random.default_rng(0)
  seeds = [torch.from_numpy(rng.integers(0, NUM_NODES, b).astype(
      np.int32)).to(DEVICE) for _ in range(iters)]
  starts = [indptr[s.long()] for s in seeds]
  lane = torch.arange(w, device=DEVICE)
  flat = [(s[:, None] + lane).clamp(max=e - 1).reshape(-1) for s in starts]
  for s, f in zip(starts, flat):
    got = wg.csr_window_gather(indices, s, w)
    if not (torch.equal(got, wg.csr_window_gather_plain(indices, s, w))
            and torch.equal(got.reshape(-1), indices[f])):
      raise AssertionError('window kernel != plain version (path input)')
  forced = forced_window_sets(torch, indices)
  k = FANOUTS[0]
  kw = ops.default_window(k)
  gen = torch.Generator(device=DEVICE).manual_seed(15)
  draws = [(torch.rand(b, k, device=DEVICE, generator=gen),
            -torch.log(-torch.log(torch.rand(b, kw, device=DEVICE,
                                             generator=gen).clamp_(
                                                 min=1e-30))))
           for _ in range(iters)]
  calls = {
      'kernel': [lambda s=s: wg.csr_window_gather(indices, s, w)
                 for s in starts],
      'plain': [lambda s=s: wg.csr_window_gather_plain(indices, s, w)
                for s in starts],
      'library': [lambda f=f: torch.index_select(indices, 0, f)
                  for f in flat],
      'k1_hop': [lambda s=s, d=d: ops.sample_one_hop_fused(
          indptr, indices, s, k, *d) for s, d in zip(seeds, draws)]}
  for fns in calls.values():
    fns[0]()
  # the path's run: counts zeroed just before, read just after
  wg.csr_window_gather.launches = 0
  wg.csr_window_gather_plain.calls = 0
  total = {'kernel': events_ms(torch, calls['kernel'])}
  launches = wg.csr_window_gather.launches
  plain_calls = wg.csr_window_gather_plain.calls
  if launches != iters or plain_calls != 0:
    raise AssertionError(f'window launches {launches}, plain calls '
                         f'{plain_calls}')
  for name in ('plain', 'library', 'k1_hop'):
    total[name] = events_ms(torch, calls[name])
  ms = {n: t / iters for n, t in total.items()}
  # one call at a time under the common timer (L2 flushed), as the other
  # kernels are timed
  flushed = {n: timer(calls[n][0]) for n in ('kernel', 'plain', 'library')}
  # the kernel at every forced width over the path's starts, under both
  # timers (after the path's counts were read)
  forced_ms = {}
  for width in WINDOW_WIDTHS:
    fns = [lambda s=s, x=width: wg.csr_window_gather(indices, s, x)
           for s in starts]
    fns[0]()
    forced_ms[str(width)] = {
        'back_to_back': events_ms(torch, fns) / iters,
        'flushed': timer(fns[0])}
  per_call = b * w * 4
  gbps = {n: per_call / (ms[n] / 1e3) / 1e9 for n in
          ('kernel', 'plain', 'library')}
  nbytes = b * starts[0].element_size() + 2 * per_call
  rec = {'batch': b, 'w': w, 'iters': iters, 'starts_dtype': 'int64',
         'byte_equal': True, 'max_abs_err': 0, 'forced_sets': forced,
         'ms_per_call': ms, 'gbps': gbps, 'ms_flushed': flushed,
         'forced_width_ms': forced_ms,
         'k1_hop_k': k, 'k1_hop_window': kw,
         'k1_hop_m_seeds_per_s': b / (ms['k1_hop'] / 1e3) / 1e6,
         'bytes': nbytes, 'bound_ms': nbytes / HBM_BYTES_PER_S * 1e3,
         'hbm_share': {n: gbps[n] * 1e9 / HBM_BYTES_PER_S for n in gbps},
         'launches': launches, 'plain_calls': plain_calls}
  emit('window', **rec)
  emit('kernel', kernel='csr_window_gather',
       shape=f'{b} starts x {w}, {iters} back-to-back calls',
       byte_equal=True, max_abs_err=0, kernel_ms=ms['kernel'],
       plain_ms=ms['plain'], library_ms=ms['library'],
       kernel_ms_flushed=flushed['kernel'], plain_ms_flushed=flushed['plain'],
       library_ms_flushed=flushed['library'], bytes=nbytes,
       bound_us=nbytes / HBM_BYTES_PER_S * 1e6, launches=launches)
  del draws, calls, flat
  return rec


class TrainRecorder:
  """Wraps a training path's sampler kernel calls (through the module
  ``smod`` the path calls it from) and the feature store's row gather to
  keep the kernel inputs of the path's first step: the sampler's per
  hop (rows in the order the kernel sees them: sorted when the path asks
  for ``sort_locality``) and the first ``gathers`` row gathers'."""

  def __init__(self, torch, smod, gathers):
    import graphlearn_tpu_torch.data.feature as fmod
    self.torch, self.fmod, self.smod = torch, fmod, smod
    self.n_gathers = gathers
    self.real_sample = smod.sample_one_hop_fused
    self.real_gather = fmod.gather_rows
    self.hops, self.gathers = [], []

  def sample(self, indptr, indices, seeds, k, u, gumbel,
             sort_locality=False):
    torch = self.torch
    if len(self.hops) < len(FANOUTS):
      rows = seeds
      if sort_locality:
        rows = seeds[torch.argsort(torch.where(
            seeds >= 0, seeds, torch.iinfo(seeds.dtype).max),
            stable=True)].contiguous()
      self.hops.append((indptr, indices, rows, k, u, gumbel))
    return self.real_sample(indptr, indices, seeds, k, u, gumbel,
                            sort_locality=sort_locality)

  def gather(self, table, ids, id2index=None):
    if len(self.gathers) < self.n_gathers:
      self.gathers.append((table, ids))
    return self.real_gather(table, ids, id2index)

  def __enter__(self):
    self.smod.sample_one_hop_fused = self.sample
    self.fmod.gather_rows = self.gather
    return self

  def __exit__(self, *exc):
    self.smod.sample_one_hop_fused = self.real_sample
    self.fmod.gather_rows = self.real_gather


def check_batch(torch, batch, feats, labels) -> None:
  """Every valid node's ``x`` row and label equal its source; padded
  rows zero; valid edges inside the node count, masked ones -1."""
  node = batch.node
  ok = node >= 0
  src = node[ok].long()
  if not torch.equal(batch.x[ok], feats[src]):
    raise AssertionError('a gathered x row differs from its source row')
  if not torch.equal(batch.y[ok], labels[src]):
    raise AssertionError('a gathered label differs from its source label')
  if bool(batch.x[~ok].any()) or bool(batch.y[~ok].any()):
    raise AssertionError('a padded node slot holds a non-zero row')
  count = int(ok.sum())
  ei, em = batch.edge_index, batch.edge_mask
  if not (bool(((ei[:, em] >= 0) & (ei[:, em] < count)).all())
          and bool((ei[:, ~em] == -1).all())):
    raise AssertionError('edge_index outside the node count')


def reset_counts(ops) -> None:
  """Zero every kernel wrapper's launch count and plain version's call
  count (just before a path runs)."""
  for fn in (ops.sample_one_hop_fused, ops.sample_one_hop_gns_fused,
             ops.gather_rows, ops.csr_window_gather):
    fn.launches = 0
  for fn in (ops.sample_one_hop, ops.sample_one_hop_gns,
             ops.gather_rows_plain, ops.csr_window_gather_plain):
    fn.calls = 0


def read_counts(ops) -> tuple:
  """``(launches by kernel, plain calls)`` since `reset_counts`."""
  launches = {'sample_one_hop': ops.sample_one_hop_fused.launches,
              'sample_one_hop_gns': ops.sample_one_hop_gns_fused.launches,
              'gather_rows': ops.gather_rows.launches,
              'csr_window_gather': ops.csr_window_gather.launches}
  plain = (ops.sample_one_hop.calls + ops.sample_one_hop_gns.calls
           + ops.gather_rows_plain.calls + ops.csr_window_gather_plain.calls)
  return launches, plain


def sage_step_flops(node_cap: int) -> int:
  """`bench.py:164-177`: forward + backward matmul FLOPs of one
  per-batch GraphSAGE step on the padded node table (two matmuls per
  layer, backward twice the forward)."""
  dims = [FEAT_DIM, 256, 256, GNS_CLASSES]
  fwd = sum(2 * node_cap * i * o * 2 for i, o in zip(dims[:-1], dims[1:]))
  return 3 * fwd


def tree_step_flops() -> int:
  """`bench.py:148-161`: forward + backward matmul FLOPs of one tree
  step (layer ``l`` runs its matmul pair on every level that still
  matters)."""
  sizes = [TRAIN_BATCH]
  for k in FANOUTS:
    sizes.append(sizes[-1] * k)
  dims = [FEAT_DIM, 256, 256, GNS_CLASSES]
  layers = len(FANOUTS)
  fwd = sum(2 * sum(sizes[:layers - l]) * dims[l] * dims[l + 1] * 2
            for l in range(layers))
  return 3 * fwd


def train(torch, ops, timer, ds, feats, labels, train_idx, test_idx,
          prof=False):
  """Path A, BASELINE config 1 as `bench.py:220-408` runs it:
  `NeighborLoader` -> `make_supervised_step` with ``GraphSAGE(100, 256,
  47, 3)`` and Adam(3e-3).  3 warm steps (the first one's kernel inputs
  recorded; K1 and K2 held against their plain versions on them), then
  `TRAIN_EPOCHS` timed epochs, a few synchronised steps split into
  sample / collate / model, eval accuracy, the sampling burst and the
  feature-gather roofline."""
  import graphlearn_tpu_torch.sampler.neighbor_sampler as smod
  from graphlearn_tpu_torch.loader import NeighborLoader
  from graphlearn_tpu_torch.models import (GraphSAGE, make_eval_step,
                                           make_supervised_step)
  from graphlearn_tpu_torch.sampler import NeighborSampler, NodeSamplerInput
  ds.init_node_labels(labels)
  loader = NeighborLoader(ds, FANOUTS, train_idx, batch_size=TRAIN_BATCH,
                          shuffle=True, seed=0, device=DEVICE)
  sampler = loader.sampler
  node_cap = sampler.node_capacity(TRAIN_BATCH)
  steps = len(loader)
  model = GraphSAGE(FEAT_DIM, 256, GNS_CLASSES, num_layers=3).to(DEVICE)
  model.reset_parameters(torch.Generator().manual_seed(0))
  opt = torch.optim.Adam(model.parameters(), lr=TRAIN_LR, eps=1e-8)
  step = make_supervised_step(model, opt, TRAIN_BATCH)
  warm_losses = []
  t0 = time.perf_counter()
  with TrainRecorder(torch, smod, 1) as rec:
    for batch in itertools.islice(iter(loader), TRAIN_WARM):
      warm_losses.append(float(step(batch)[0]))
      check_batch(torch, batch, feats, labels)
  warm_secs = time.perf_counter() - t0
  hop_recs = []
  for t in range(len(FANOUTS)):
    _, r = check_sampler(torch, ops, timer, *rec.hops[t])
    emit('kernel', kernel='sample_one_hop', shape=f'train hop {t}', **r)
    hop_recs.append(r)
  gather_rec = check_gather(torch, ops, timer, *rec.gathers[0])
  emit('kernel', kernel='gather_rows', shape='train features', **gather_rec)
  del rec, batch

  # the path's run: TRAIN_EPOCHS full epochs
  reset_counts(ops)
  epoch_secs, epoch_losses = [], []
  for _ in range(TRAIN_EPOCHS):
    sync(torch)
    t = time.perf_counter()
    losses = [step(b)[0] for b in loader]
    sync(torch)
    epoch_secs.append(time.perf_counter() - t)
    epoch_losses.append(torch.stack(losses).cpu().numpy())
  launches, plain = read_counts(ops)
  runs = steps * TRAIN_EPOCHS
  if not (launches['sample_one_hop'] == len(FANOUTS) * runs
          and launches['gather_rows'] == runs
          and launches['sample_one_hop_gns'] == 0 and plain == 0):
    raise AssertionError(f'launch counts {launches}, plain calls {plain}, '
                         f'steps {runs}')
  floor = steps * node_cap * FEAT_DIM * 4 / HBM_BYTES_PER_S
  if min(epoch_secs) < floor:
    raise AssertionError(f'epoch {min(epoch_secs)} s under the floor '
                         f'{floor} s: a broken measurement')
  all_losses = np.concatenate([warm_losses] + epoch_losses)
  if not (np.isfinite(all_losses).all()
          and epoch_losses[-1][-10:].mean() < np.mean(warm_losses)):
    raise AssertionError(f'losses do not fall: warm {warm_losses}, last '
                         f'{epoch_losses[-1][-10:]}')

  # a few synchronised steps split into sample / collate / model
  parts = {'sample': [], 'collate': [], 'model': []}
  seed_it = iter(loader._batcher)
  for _ in range(TRAIN_SPLIT_STEPS):
    seeds = next(seed_it)
    sync(torch)
    t0 = time.perf_counter()
    out = sampler.sample_from_nodes(NodeSamplerInput(node=seeds))
    sync(torch)
    t1 = time.perf_counter()
    batch = loader._collate_fn(out)
    sync(torch)
    t2 = time.perf_counter()
    step(batch)
    sync(torch)
    t3 = time.perf_counter()
    for key, a, z in (('sample', t0, t1), ('collate', t1, t2),
                      ('model', t2, t3)):
      parts[key].append((z - a) * 1e3)
    check_batch(torch, batch, feats, labels)
  del batch, out
  if prof:
    it = iter(loader)
    profile_train(torch, lambda: step(next(it))[0], 'train')
    del it

  ev = make_eval_step(model, TRAIN_BATCH)
  counts = [ev(b) for b in NeighborLoader(ds, FANOUTS, test_idx,
                                          batch_size=TRAIN_BATCH, seed=1,
                                          device=DEVICE)]
  correct = int(sum(c for c, _ in counts))
  total = int(sum(t for _, t in counts))
  if not correct / total > 1 / GNS_CLASSES:
    raise AssertionError(f'eval accuracy {correct}/{total}')
  del model, opt, step, loader

  # the sampling burst (`benchmarks/common.py:163-188`)
  bs = NeighborSampler(ds.get_graph(), FANOUTS, seed=11, device=DEVICE)
  seeds_all = torch.from_numpy(np.random.default_rng(1).integers(
      0, NUM_NODES, (BURST_ITERS, TRAIN_BATCH)).astype(np.int32)).to(DEVICE)
  bs.sample_from_nodes(NodeSamplerInput(node=seeds_all[0]))
  sync(torch)
  t = time.perf_counter()
  total_edges = sum(bs.sample_from_nodes(NodeSamplerInput(node=s))
                    .edge_mask.sum() for s in seeds_all)
  edges = int(total_edges)
  burst_secs = time.perf_counter() - t

  # the feature-gather roofline (`bench.py:456-507`): 2^20 ids of
  # stride 2, the rows' bytes counted once as JAX counts them
  grows = ROOFLINE_IDS
  starts = np.random.default_rng(3).integers(0, NUM_NODES - 2 * grows,
                                             ROOFLINE_ITERS)
  ar = torch.arange(grows, dtype=torch.int64, device=DEVICE) * 2
  ids = [ar + int(s) for s in starts]
  gb = ROOFLINE_ITERS * grows * FEAT_DIM * 4 / 1e9

  def rate(fns):
    fns[0]()
    return gb / (events_ms(torch, fns) / 1e3)
  roof = {'gather_rows': rate([lambda i=i: ops.gather_rows(feats, i)
                               for i in ids]),
          'index_select': rate([lambda i=i: torch.index_select(feats, 0, i)
                                for i in ids]),
          'contiguous_copy': rate([lambda s=s: feats[s:s + grows].clone()
                                   for s in starts])}
  del ids, ar

  secs = float(np.median(epoch_secs))
  flops = sage_step_flops(node_cap)
  med = {k: float(np.median(v)) for k, v in parts.items()}
  emit('train', batch=TRAIN_BATCH, fanouts=list(FANOUTS),
       model=f'GraphSAGE({FEAT_DIM}->256->{GNS_CLASSES}, 3 layers)',
       optimizer=f'Adam({TRAIN_LR})', train_seeds=len(train_idx),
       steps_per_epoch=steps, node_capacity=node_cap,
       warm_steps=TRAIN_WARM, warm_secs=warm_secs, warm_losses=warm_losses,
       epochs=TRAIN_EPOCHS, epoch_secs_runs=epoch_secs, epoch_secs=secs,
       epoch_floor_secs=floor, step_ms=secs / steps * 1e3,
       train_seeds_per_s=len(train_idx) / secs,
       epoch_mean_losses=[float(x.mean()) for x in epoch_losses],
       last_losses=[float(x) for x in epoch_losses[-1][-5:]],
       split_steps=TRAIN_SPLIT_STEPS, step_ms_by_part={
           'median': med, 'all': parts},
       train_step_flops=flops, tflops=flops * steps / secs / 1e12,
       eval_accuracy=correct / total, eval_seeds=total,
       burst={'batches': BURST_ITERS, 'batch': TRAIN_BATCH, 'edges': edges,
              'secs': burst_secs, 'edges_per_s': edges / burst_secs},
       gather_roofline={'ids': grows, 'iters': ROOFLINE_ITERS,
                        'gbps': roof,
                        'hbm_share': {k: v * 1e9 / HBM_BYTES_PER_S
                                      for k, v in roof.items()}},
       launches=launches, plain_calls=plain, x_rows_byte_equal=True,
       y_byte_equal=True)
  return launches, hop_recs, gather_rec


def tree_train(torch, ops, timer, ds, feats, train_idx, test_idx,
               prof=False):
  """Path B, the fused tree epoch of `bench.py:252-312`:
  `FusedTreeEpoch` with ``TreeSAGE(100, 256, 47, 3)``, Adam(3e-3),
  chunks of 100 steps; one warm epoch (its first step's kernel inputs
  recorded: K1 at the three unsorted hops and K2 at the four level
  gathers held against their plain versions on them), `TREE_EPOCHS`
  timed, then `evaluate` on the test split."""
  import graphlearn_tpu_torch.loader.fused_tree as ftmod
  from graphlearn_tpu_torch.loader import FusedTreeEpoch
  from graphlearn_tpu_torch.models import TreeSAGE
  model = TreeSAGE(FEAT_DIM, 256, GNS_CLASSES, num_layers=3).to(DEVICE)
  model.reset_parameters(torch.Generator().manual_seed(0))
  opt = torch.optim.Adam(model.parameters(), lr=TRAIN_LR, eps=1e-8)
  fused = FusedTreeEpoch(ds, FANOUTS, train_idx, model, opt,
                         batch_size=TRAIN_BATCH, shuffle=True, seed=0,
                         max_steps_per_program=100, device=DEVICE)
  steps = len(fused)
  t0 = time.perf_counter()
  with TrainRecorder(torch, ftmod, len(FANOUTS) + 1) as rec:
    warm = fused.run().losses.cpu().numpy()
  warm_secs = time.perf_counter() - t0
  hop_recs, level_recs = [], []
  levels = [rec.gathers[0][1]]
  for t in range(len(FANOUTS)):
    got, r = check_sampler(torch, ops, timer, *rec.hops[t])
    emit('kernel', kernel='sample_one_hop', shape=f'tree hop {t}', **r)
    hop_recs.append(r)
    levels.append(got.nbrs.reshape(-1))
  for t, (table, ids) in enumerate(rec.gathers):
    # the step gathered the level its sampler produced, from the source
    # feature table
    if not (torch.equal(ids, levels[t]) and torch.equal(table, feats)):
      raise AssertionError(f'tree level {t} gathered other ids or rows')
    r = check_gather(torch, ops, timer, table, ids)
    emit('kernel', kernel='gather_rows', shape=f'tree level {t}', **r)
    level_recs.append(r)
  del rec, levels
  reset_counts(ops)
  runs, epoch_losses = [], []
  for _ in range(TREE_EPOCHS):
    sync(torch)
    t = time.perf_counter()
    stats = fused.run()
    sync(torch)
    runs.append(time.perf_counter() - t)
    epoch_losses.append(stats.losses.cpu().numpy())
  launches, plain = read_counts(ops)
  n = steps * TREE_EPOCHS
  if not (launches['sample_one_hop'] == len(FANOUTS) * n
          and launches['gather_rows'] == (len(FANOUTS) + 1) * n
          and launches['sample_one_hop_gns'] == 0 and plain == 0):
    raise AssertionError(f'launch counts {launches}, plain calls {plain}, '
                         f'steps {n}')
  means = [float(warm.mean())] + [float(x.mean()) for x in epoch_losses]
  if not (np.isfinite(np.concatenate([warm] + epoch_losses)).all()
          and means[-1] < means[0]):
    raise AssertionError(f'tree losses do not fall: {means}')
  acc = fused.evaluate(test_idx)
  if not acc > 1 / GNS_CLASSES:
    raise AssertionError(f'tree eval accuracy {acc}')
  if prof:
    seeds = np.stack(list(itertools.islice(iter(fused._batcher), 3)))
    it = fused._steps(seeds, 1000)
    profile_train(torch, lambda: fused._train_step(*next(it))[0], 'tree')
  secs = float(np.median(runs))
  flops = tree_step_flops()
  emit('tree_train', batch=TRAIN_BATCH, fanouts=list(FANOUTS),
       model=f'TreeSAGE({FEAT_DIM}->256->{GNS_CLASSES}, 3 layers)',
       optimizer=f'Adam({TRAIN_LR})', max_steps_per_program=100,
       steps_per_epoch=steps, warm_secs=warm_secs, epochs=TREE_EPOCHS,
       epoch_secs_runs=runs, epoch_secs=secs, step_ms=secs / steps * 1e3,
       train_seeds_per_s=len(train_idx) / secs, tree_step_flops=flops,
       tflops=flops * steps / secs / 1e12, epoch_mean_losses=means,
       eval_accuracy=acc, launches=launches, plain_calls=plain)
  return launches, hop_recs, level_recs


def train_cross_check(torch):
  """A small graph (4,000 nodes, one hub row) on the card and on the
  CPU with the same CPU-made draws: 3 `NeighborLoader` batches
  byte-equal (node, x, y, edge_index, edge_mask) and their GraphSAGE
  step losses within 1e-5; 2 `FusedTreeEpoch` steps' losses within
  1e-5."""
  from graphlearn_tpu_torch.data import Dataset
  from graphlearn_tpu_torch.loader import FusedTreeEpoch, NeighborLoader
  from graphlearn_tpu_torch.models import (GraphSAGE, TreeSAGE,
                                           make_supervised_step)
  from graphlearn_tpu_torch.ops import TorchDraws
  rng = np.random.default_rng(12)
  n = 4000
  rows = np.concatenate([np.repeat(np.arange(n), 12), np.full(300, 7)])
  cols = np.where(rng.random(rows.shape[0]) < 0.3,
                  rng.integers(0, 40, rows.shape[0]),
                  rng.integers(0, n, rows.shape[0]))
  feats = rng.standard_normal((n, 16)).astype(np.float32)
  labels = rng.integers(0, 7, n).astype(np.int32)
  cpu = TorchDraws(6, 'cpu')
  out, losses, tree_losses = {}, {}, {}
  for dev in (DEVICE, 'cpu'):
    def draws(step, hop, r, k, w, dev=dev):
      return tuple(t.to(dev) for t in cpu(step, hop, r, k, w))

    def tree_draws(epoch, chunk, step, hop, r, k, w, dev=dev):
      return tuple(t.to(dev) for t in cpu.draw((epoch, chunk or 0, step,
                                                hop), r, k, w))
    ds = (Dataset().init_graph((rows, cols), num_nodes=n, device=dev)
          .init_node_features(feats, device=dev).init_node_labels(labels))
    lo = NeighborLoader(ds, FANOUTS, np.arange(n), batch_size=64,
                        shuffle=True, seed=1, draws=draws, device=dev)
    batches = list(itertools.islice(iter(lo), 3))
    out[dev] = [(b.node.cpu(), b.x.cpu(), b.y.cpu(), b.edge_index.cpu(),
                 b.edge_mask.cpu()) for b in batches]
    model = GraphSAGE(16, 32, 7, num_layers=3).to(dev)
    model.reset_parameters(torch.Generator().manual_seed(3))
    step = make_supervised_step(
        model, torch.optim.Adam(model.parameters(), lr=TRAIN_LR, eps=1e-8),
        64)
    losses[dev] = np.array([float(step(b)[0]) for b in batches])
    tm = TreeSAGE(16, 32, 7, num_layers=3).to(dev)
    tm.reset_parameters(torch.Generator().manual_seed(4))
    fused = FusedTreeEpoch(
        ds, FANOUTS, np.arange(128), tm,
        torch.optim.Adam(tm.parameters(), lr=TRAIN_LR, eps=1e-8),
        batch_size=64, seed=2, draws=tree_draws, device=dev)
    tree_losses[dev] = fused.run().losses.cpu().numpy()
  for i, (a, c) in enumerate(zip(out[DEVICE], out['cpu'])):
    for name, x, y in zip(('node', 'x', 'y', 'edge_index', 'edge_mask'),
                          a, c):
      if x.dtype != y.dtype or not torch.equal(x, y):
        raise AssertionError(f'card and CPU differ: batch {i} {name}')
  diff = float(np.abs(losses[DEVICE] - losses['cpu']).max())
  tdiff = float(np.abs(tree_losses[DEVICE] - tree_losses['cpu']).max())
  if not (diff <= 1e-5 and tdiff <= 1e-5 and len(tree_losses['cpu']) == 2):
    raise AssertionError(f'losses differ: per-batch {diff}, tree {tdiff}')
  emit('train_cross_check', batches=3, byte_equal=True,
       loss_max_abs_diff=diff, tree_steps=2, tree_loss_max_abs_diff=tdiff)


#: the single-card tiered store's phases: `bench_serving.py`'s tiered
#: engine at split 0.5 and BASELINE config 1's step over
#: `bench_feature.py`'s split-0.2 store, both sorted by in-degree with the
#: 'auto' victim cache (15% of the cold rows)
TIERED_SERVE_SPLIT = 0.5
TIERED_TRAIN_SPLIT = 0.2
TIERED_WARM = 3
TIERED_TIMED = 20
TIERED_SPLIT_STEPS = 3
TIERED_PROFILE_STEPS = 3
ZIPF_A = 1.1
LOOKUP_SPLITS = (1.0, 0.5, 0.2)
LOOKUP_BUDGETS = (0.0, 0.05, 0.15)
LOOKUP_SETS = 8
#: K6's forced row layouts (columns, dtype): rows of 4, 12, 200 (bf16 x
#: 100), 400 and 1,024 bytes, over a block of `COLD_FORCED_ROWS` rows
COLD_LAYOUTS = ((1, 'float32'), (3, 'float32'), (100, 'bfloat16'),
                (100, 'float32'), (256, 'float32'))
COLD_FORCED_ROWS = 10_007
#: bytes of the pinned -> device copy that measures the host link's rate,
#: and how many runs of it (each a median of `REPS`) are timed
LINK_COPY_BYTES = 256 << 20
LINK_COPY_RUNS = 5


def zipf_requests(n_requests=N_REQUESTS, seed=0):
  """`bench_serving.make_schedule`'s seeds: Zipf(1.1) ranks mapped through
  a fixed permutation (hotness apart from id order), here 1-16 seeds a
  request as the serve phase's sizes."""
  rng = np.random.default_rng(seed)
  perm = rng.permutation(NUM_NODES)
  sizes = rng.integers(1, 17, n_requests)
  return [perm[(rng.zipf(ZIPF_A, int(k)) - 1) % NUM_NODES].astype(np.int64)
          for k in sizes]


def tiered_dataset(torch, indptr, indices, feats_h, split, cache_rows='auto',
                   labels=None):
  """A `Dataset` over the products CSR whose features are the host table
  sorted by in-degree (`sort_by_in_degree`, read from the card's CSR)
  and tiered at ``split``; the device tiers built."""
  from graphlearn_tpu_torch.data import Dataset
  from graphlearn_tpu_torch.data.reorder import sort_by_in_degree
  ds = (Dataset().init_graph((indptr, indices), layout='CSR',
                             num_nodes=NUM_NODES, device=DEVICE)
        .init_node_features(feats_h, sort_func=sort_by_in_degree,
                            split_ratio=split, device=DEVICE,
                            cold_cache_rows=cache_rows))
  if labels is not None:
    ds.init_node_labels(labels)
  ds.node_features.lazy_init()
  return ds


def link_rate(torch, timer) -> dict:
  """The host link's rate reached: `LINK_COPY_RUNS` runs of a
  `LINK_COPY_BYTES` pinned -> device copy, each timed as the kernels are
  (median of 30); the fastest run is the rate, beside the link's
  peak."""
  src = torch.empty(LINK_COPY_BYTES, dtype=torch.uint8).pin_memory()
  dst = torch.empty(LINK_COPY_BYTES, dtype=torch.uint8, device=DEVICE)
  runs = [timer(lambda: dst.copy_(src, non_blocking=True))
          for _ in range(LINK_COPY_RUNS)]
  ms = min(runs)
  return {'bytes': LINK_COPY_BYTES, 'ms': ms, 'runs_ms': runs,
          'gbps': LINK_COPY_BYTES / ms / 1e6,
          'peak_gbps': LINK_BYTES_PER_S / 1e9,
          'share_of_peak': LINK_COPY_BYTES / ms / LINK_BYTES_PER_S * 1e3}


def cold_bytes(m: int, row: int) -> tuple:
  """``(link bytes, device bytes)`` K6 must move for ``m`` miss rows of
  ``row`` bytes: each row crosses the host link once; on the card the
  ``pos`` and ``rel`` ids are read and each row written once."""
  return m * row, m * (16 + row)


def check_cold(torch, ops, timer, b, cold, pos, rel, time_it=True):
  """K6 against its plain version on the same inputs (the ``[b, D]``
  output starting from the same random rows): byte-equal, the rows
  outside ``pos`` untouched; timed with the plain version, a pinned ->
  device copy of the same bytes (``library_ms``) and its bound (the link
  bytes over the link's peak, or the device bytes over HBM's)."""
  d = cold.shape[1]
  init = torch.randn(b, d, device=DEVICE,
                     generator=torch.Generator(device=DEVICE).manual_seed(
                         b)).to(cold.dtype)
  m = int(pos.numel())
  before = ops.cold_gather.launches
  got = ops.cold_gather(init.clone(), cold, pos, rel)
  launched = ops.cold_gather.launches - before
  ref = ops.cold_gather_plain(init.clone(), cold, pos, rel)
  sync(torch)
  if launched != (m > 0):
    raise AssertionError(f'cold_gather launched {launched} times for '
                         f'{m} rows')
  if not torch.equal(got.view(torch.uint8), ref.view(torch.uint8)):
    bad = int((got != ref).any(dim=1).sum())
    raise AssertionError(f'cold_gather != plain version ({cold.dtype}, '
                         f'{d} columns, {bad} rows differ)')
  keep = torch.ones(b, dtype=torch.bool, device=DEVICE)
  keep[pos] = False
  if not torch.equal(got[keep], init[keep]):
    raise AssertionError('cold_gather wrote a row outside pos')
  row = d * cold.element_size()
  link_b, dev_b = cold_bytes(m, row)
  bound = max(link_b / LINK_BYTES_PER_S, dev_b / HBM_BYTES_PER_S) * 1e3
  rec = {'rows': m, 'out_rows': b, 'cold_rows': int(cold.shape[0]),
         'dtype': str(cold.dtype).replace('torch.', ''), 'row_bytes': row,
         'byte_equal': True, 'max_abs_err': float(
             (got.float() - ref.float()).abs().max()) if b else 0.0,
         'link_bytes': link_b, 'bound_ms': bound, 'launches': launched}
  if time_it and m:
    out = init.clone()
    src = torch.empty(link_b, dtype=torch.uint8).pin_memory()
    dst = torch.empty(link_b, dtype=torch.uint8, device=DEVICE)
    rec['kernel_ms'] = timer(lambda: ops.cold_gather(out, cold, pos, rel))
    rec['plain_ms'] = timer(lambda: ops.cold_gather_plain(out, cold, pos,
                                                          rel))
    rec['library_ms'] = timer(lambda: dst.copy_(src, non_blocking=True))
    rec['achieved_gbps'] = link_b / rec['kernel_ms'] / 1e6
    rec['link_share'] = bound / rec['kernel_ms']
    rec['copy_share'] = rec['library_ms'] / rec['kernel_ms']
  return rec


def forced_cold_sets(torch, ops, timer, seed=23):
  """K6 on forced shapes: every `COLD_LAYOUTS` row width at M = 0 (no
  launch), 1 and 7 miss rows with ``rel`` at 0 and at Nc - 1, over a
  `pin_memory` block; the 12-byte layout also through a block that
  starts one row into its allocation, and through a registered block
  (`PinnedColdBuffer`); a block that is not page-locked must raise."""
  from graphlearn_tpu_torch.data.cold_cache import PinnedColdBuffer
  rng = np.random.default_rng(seed)
  cases = {}
  b, nc = 64, COLD_FORCED_ROWS
  for cols, dt in COLD_LAYOUTS:
    dtype = getattr(torch, dt)
    host = torch.from_numpy(rng.standard_normal((nc + 1, cols)).astype(
        np.float32)).to(dtype)
    blocks = {'pinned': host[:nc].clone().pin_memory()}
    if cols == 3:
      blocks['offset'] = host.clone().pin_memory()[1:]
      registered = PinnedColdBuffer(host[:nc], cols, device=DEVICE)
      blocks['registered'] = registered.rows
    for kind, cold in blocks.items():
      for m in (0, 1, 7):
        pos = rng.choice(b, m, replace=False).astype(np.int64)
        rel = rng.integers(0, cold.shape[0], m).astype(np.int64)
        if m:
          rel[0], rel[-1] = 0, cold.shape[0] - 1
        rec = check_cold(torch, ops, timer, b, cold,
                         torch.from_numpy(pos).to(DEVICE),
                         torch.from_numpy(rel).to(DEVICE),
                         time_it=(m == 7))
        cases[f'{cols}x{dt} {kind} M={m}'] = rec
    if cols == 3:
      registered.close()
  try:
    ops.cold_gather(torch.zeros(4, 3, device=DEVICE), torch.zeros(8, 3),
                    torch.zeros(1, dtype=torch.int64, device=DEVICE),
                    torch.zeros(1, dtype=torch.int64, device=DEVICE))
  except ValueError:
    pass
  else:
    raise AssertionError('cold_gather took a block that is not pinned')
  return cases


class ColdRecorder:
  """Wraps the cold fill the tiered `Feature` reaches
  (`data.cold_cache.cold_gather`): counts the calls with miss rows and
  keeps the last such call's inputs ``(out rows, cold, pos, rel)``."""

  def __init__(self):
    import graphlearn_tpu_torch.data.cold_cache as cmod
    self.mod = cmod
    self.real = cmod.cold_gather
    self.misses, self.last = [], None

  def __call__(self, out, cold, pos, rel):
    m = int(pos.numel())
    self.misses.append(m)
    if m:
      self.last = (out.shape[0], cold, pos.clone(), rel.clone())
    return self.real(out, cold, pos, rel)

  def __enter__(self):
    self.mod.cold_gather = self
    return self

  def __exit__(self, *exc):
    self.mod.cold_gather = self.real


def reset_tiered_counts(ops) -> None:
  reset_counts(ops)
  ops.cold_gather.launches = 0
  ops.cold_gather_plain.calls = 0


def read_tiered_counts(ops) -> tuple:
  launches, plain = read_counts(ops)
  launches['cold_gather'] = ops.cold_gather.launches
  return launches, plain + ops.cold_gather_plain.calls


def cache_rates(feat, before: dict) -> dict:
  """The victim cache's counts since ``before`` and its hit rate over the
  cold lookups."""
  now = feat.cold_cache.stats.snapshot()
  d = {k: now[k] - before[k] for k in now}
  cold = d['hits'] + d['misses']
  d['hit_rate'] = d['hits'] / cold if cold else 0.0
  return d


def tiered_serve(torch, ops, timer, indptr, indices, feats_h, ds_hot):
  """`bench_serving.py`'s tiered engine on the card: the products table
  sorted by in-degree at split 0.5 (1,224,514 hot rows on the card, the
  cold half pinned on the host, the 'auto' cache), ``TreeSAGE(100, 256,
  47, 3)`` behind a `ServingFrontend`, 256 Zipf(1.1) requests of 1-16
  seeds from 4 clients.  Checks: every request served, 3 K1 and 1 K2
  launches a dispatch, K6 on every dispatch with misses, no plain call;
  x byte-equal and logits within 1e-5 against the fully-hot engine."""
  from graphlearn_tpu_torch.models import TreeSAGE
  from graphlearn_tpu_torch.serving import ServingEngine, ServingFrontend
  t0 = time.perf_counter()
  ds = tiered_dataset(torch, indptr, indices, feats_h, TIERED_SERVE_SPLIT)
  setup_secs = time.perf_counter() - t0
  f = ds.node_features
  eng = ServingEngine(ds, FANOUTS, model=TreeSAGE(FEAT_DIM, 256, 47, 3),
                      seed=0, buckets=BUCKETS, device=DEVICE)
  eng.init_params(torch.Generator().manual_seed(0))
  warm = eng.warmup()
  fe = ServingFrontend(eng, max_wait_ms=2.0, default_deadline_ms=10_000.0)
  reqs = zipf_requests()
  results, lat, errors = [None] * len(reqs), [0.0] * len(reqs), []
  fills = []
  real_fill = eng._tiered_fill

  def recorded_fill(nodes_h):
    # the engine's own fill timer (host time, no sync), read per dispatch
    out = real_fill(nodes_h)
    fills.append(eng.last_cold_fill[1] * 1e3)
    return out

  def client(lo):
    for i in range(lo, len(reqs), N_CLIENTS):
      t = time.perf_counter()
      try:
        results[i] = fe.submit(reqs[i]).result(60.0)
      except Exception as e:       # noqa: BLE001 — counted, then fatal
        errors.append(f'request {i}: {type(e).__name__}: {e}')
      lat[i] = (time.perf_counter() - t) * 1e3

  eng._tiered_fill = recorded_fill
  stats0 = f.cold_cache.stats.snapshot()
  lookups0 = f.cold_stats['lookups']
  f.lookup_secs = dict.fromkeys(f.lookup_secs, 0.0)
  reset_tiered_counts(ops)
  threads = [threading.Thread(target=client, args=(i,))
             for i in range(N_CLIENTS)]
  with ColdRecorder() as rec:
    t0 = time.perf_counter()
    for t in threads:
      t.start()
    for t in threads:
      t.join()
    wall = time.perf_counter() - t0
  launches, plain = read_tiered_counts(ops)
  del eng._tiered_fill
  fe.shutdown()
  st = fe.stats()
  if errors or st['failed'] or any(r is None for r in results):
    raise AssertionError(f'tiered serving failed: {errors[:3]} stats={st}')
  d = st['dispatches']
  with_misses = sum(1 for m in rec.misses if m)
  if not (launches['sample_one_hop'] == len(FANOUTS) * d
          and launches['gather_rows'] == d == len(fills)
          and launches['cold_gather'] == with_misses > 0 and plain == 0):
    raise AssertionError(f'tiered serve launches {launches}, plain {plain}, '
                         f'dispatches {d}, with misses {with_misses}')
  for i, res in enumerate(results):
    if (res.logits.shape != (len(reqs[i]), 47)
        or not np.isfinite(res.logits).all()):
      raise AssertionError(f'tiered request {i}: bad result')
  rates = cache_rates(f, stats0)

  # the fully-hot engines at the same seeds: x byte-equal (model-less),
  # logits within 1e-5 (the same params)
  hot_x = ServingEngine(ds_hot, FANOUTS, seed=0, buckets=BUCKETS,
                        device=DEVICE)
  tier_x = ServingEngine(ds, FANOUTS, seed=0, buckets=BUCKETS, device=DEVICE)
  hot_m = ServingEngine(ds_hot, FANOUTS, model=TreeSAGE(FEAT_DIM, 256, 47, 3),
                        params=eng.model.state_dict(), seed=0,
                        buckets=BUCKETS, device=DEVICE)
  worst = 0.0
  for i in range(16):
    a, b = tier_x.infer(reqs[i]), hot_x.infer(reqs[i])
    if (a.nodes.tobytes() != b.nodes.tobytes()
        or a.x.tobytes() != b.x.tobytes()):
      raise AssertionError(f'tiered request {i}: x differs from the hot '
                           'engine')
    ref = hot_m.infer(reqs[i]).logits
    np.testing.assert_allclose(results[i].logits, ref, rtol=1e-5, atol=1e-5)
    worst = max(worst, float(np.abs(results[i].logits - ref).max()))
  misses = np.array(rec.misses)
  emit('tiered_serve', split_ratio=TIERED_SERVE_SPLIT, hot_rows=f.hot_rows,
       cold_rows=NUM_NODES - f.hot_rows,
       hot_bytes=f.hot_rows * FEAT_DIM * 4,
       cold_pinned_bytes=(NUM_NODES - f.hot_rows) * FEAT_DIM * 4,
       cache_rows=f.cold_cache.capacity,
       cache_bytes=f.cold_cache.capacity * FEAT_DIM * 4,
       setup_secs=setup_secs, requests=len(reqs), clients=N_CLIENTS,
       seeds=int(sum(len(r) for r in reqs)), zipf_a=ZIPF_A, dispatches=d,
       failed=st['failed'], shed=st['shed'], warmup_secs=warm['secs'],
       wall_secs=wall, requests_per_s=len(reqs) / wall,
       latency_ms={'p50': float(np.percentile(lat, 50)),
                   'p99': float(np.percentile(lat, 99)),
                   'max': float(np.max(lat))},
       cold_fill_ms={'median': float(np.median(fills)),
                     'mean': float(np.mean(fills)),
                     'p99': float(np.percentile(fills, 99)),
                     'source': 'ServingEngine.last_cold_fill (host time, '
                               'no sync)'},
       unique_rows_per_dispatch=(f.cold_stats['lookups'] - lookups0) / d,
       miss_rows_per_dispatch={'mean': float(misses.mean()),
                               'max': int(misses.max())},
       dispatches_with_misses=with_misses, cache=rates,
       lookup_ms_by_part={k: v * 1e3 / d for k, v in f.lookup_secs.items()},
       launches=launches, plain_calls=plain, hot_engine_checked=16,
       x_byte_equal_to_hot=True, logits_max_abs_diff_to_hot=worst)
  k6 = check_cold(torch, ops, timer, *rec.last)
  emit('kernel', kernel='cold_gather', shape='tiered serve dispatch misses',
       **k6)
  f.close()
  return launches, k6


def digest(torch, tensors):
  """A position-weighted int64 sum of each tensor's 4- or 8-byte words
  (one device reduction each): equal batches give equal digests."""
  out = []
  for t in tensors:
    v = t.contiguous().view(-1)
    if v.element_size() == 4:
      v = v.view(torch.int32)
    v = v.long()
    w = torch.arange(v.numel(), device=v.device) % 65521 + 1
    out.append((v * w).sum())
  return torch.stack(out)


def device_idle(torch, run, n) -> dict:
  """The device's idle share over ``n`` calls of ``run()`` (each returns
  a loss; one synchronise at the end): the union of the CUDA kernel
  intervals in a `torch.profiler` trace over the window's wall time, so
  kernels of two streams that overlap count once."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity
  sync(torch)
  with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    for _ in range(n):
      loss = run()
    float(loss)
    sync(torch)
    wall_ms = (time.perf_counter() - t0) * 1e3
  spans = sorted((ev.time_range.start, ev.time_range.end)
                 for ev in prof.events()
                 if ev.device_type == DeviceType.CUDA)
  busy, end = 0.0, -1.0
  for a, z in spans:
    if z <= end:
      continue
    busy += z - max(a, end)
    end = z
  busy_ms = busy / 1e3
  return {'steps': n, 'wall_ms': wall_ms, 'device_busy_ms': busy_ms,
          'device_idle_share': 1 - busy_ms / wall_ms}


def tiered_train(torch, ops, timer, indptr, indices, feats_h, feats, labels,
                 train_idx):
  """BASELINE config 1's per-batch step over `bench_feature.py`'s tiered
  store: the products table sorted by in-degree at split 0.2 (489,806
  hot rows, 1,959,223 cold rows pinned, the 'auto' cache), batch 1,024,
  ``GraphSAGE(100, 256, 47, 3)``, Adam(3e-3); `NeighborLoader` with
  ``prefetch=0``, then ``prefetch=2`` over the same seeds (the model
  re-initialised alike): 3 warm and 20 timed steps each, the device's
  idle share over 3 more.  Checks: the runs' batches byte-equal (whole
  warm batches, digests of the timed ones), every valid node's x row and
  label equal to its source, per batch 3 K1, 1 K2 and 1 K6 launches and
  no plain call, the losses falling."""
  from graphlearn_tpu_torch.loader import NeighborLoader
  from graphlearn_tpu_torch.models import GraphSAGE, make_supervised_step
  from graphlearn_tpu_torch.sampler import NodeSamplerInput
  t0 = time.perf_counter()
  ds = tiered_dataset(torch, indptr, indices, feats_h, TIERED_TRAIN_SPLIT,
                      labels=labels)
  setup_secs = time.perf_counter() - t0
  f = ds.node_features
  runs, warm_batches, digests, k6 = {}, None, {}, None
  for pf in (0, 2):
    # the worker runs ahead of the consumer: launches, K6 calls and cache
    # counts are taken over the loader's whole life, against the batches
    # it produced
    reset_tiered_counts(ops)
    stats0 = f.cold_cache.stats.snapshot()
    f.lookup_secs = dict.fromkeys(f.lookup_secs, 0.0)
    with ColdRecorder() as rec:
      loader = NeighborLoader(ds, FANOUTS, train_idx, batch_size=TRAIN_BATCH,
                              shuffle=True, seed=0, device=DEVICE, prefetch=pf)
      sampler = loader.sampler
      model = GraphSAGE(FEAT_DIM, 256, GNS_CLASSES, num_layers=3).to(DEVICE)
      model.reset_parameters(torch.Generator().manual_seed(0))
      opt = torch.optim.Adam(model.parameters(), lr=TRAIN_LR, eps=1e-8)
      step = make_supervised_step(model, opt, TRAIN_BATCH)
      it = iter(loader)
      losses, warm = [], []
      for _ in range(TIERED_WARM):
        batch = next(it)
        losses.append(float(step(batch)[0]))
        check_batch(torch, batch, feats, labels)
        warm.append([batch.node, batch.x, batch.y, batch.edge_index])
      if warm_batches is None:
        warm_batches = warm
      else:
        for i, (a, b) in enumerate(zip(warm_batches, warm)):
          for name, x, y in zip(('node', 'x', 'y', 'edge_index'), a, b):
            if x.dtype != y.dtype or not torch.equal(x, y):
              raise AssertionError(f'tiered prefetch=2 batch {i} {name} '
                                   'differs from prefetch=0')
      del warm, batch
      digs, timed_losses = [], []
      sync(torch)
      t = time.perf_counter()
      for _ in range(TIERED_TIMED):
        batch = next(it)
        timed_losses.append(step(batch)[0])
        digs.append(digest(torch, (batch.node, batch.x, batch.y,
                                   batch.edge_index)))
      sync(torch)
      wall = time.perf_counter() - t
      loader.close()
    produced = sampler._step
    launches, plain = read_tiered_counts(ops)
    rates = cache_rates(f, stats0)
    with_misses = sum(1 for m in rec.misses if m)
    if not (launches['sample_one_hop'] == len(FANOUTS) * produced
            and launches['gather_rows'] == produced
            and launches['cold_gather'] == with_misses == produced
            and plain == 0 and produced >= TIERED_WARM + TIERED_TIMED):
      raise AssertionError(f'tiered train (prefetch={pf}) launches '
                           f'{launches}, plain {plain}, batches {produced}, '
                           f'with misses {with_misses}')
    digests[pf] = torch.stack(digs).cpu()
    losses += [float(x) for x in timed_losses]
    if not (np.isfinite(losses).all()
            and np.mean(losses[-5:]) < np.mean(losses[:TIERED_WARM])):
      raise AssertionError(f'tiered train losses do not fall: {losses}')
    miss_mean = float(np.mean(rec.misses))
    lookup = {k: v * 1e3 / produced for k, v in f.lookup_secs.items()}
    if k6 is None:
      k6 = check_cold(torch, ops, timer, *rec.last)
      emit('kernel', kernel='cold_gather', shape='tiered train batch misses',
           **k6)
    del rec, batch, digs
    parts = None
    if pf == 0:
      # synchronised steps split into sample / collate / model
      parts = {'sample': [], 'collate': [], 'model': []}
      seed_it = iter(loader._batcher)
      for _ in range(TIERED_SPLIT_STEPS):
        seeds = next(seed_it)
        sync(torch)
        a = time.perf_counter()
        out = sampler.sample_from_nodes(NodeSamplerInput(node=seeds))
        sync(torch)
        b = time.perf_counter()
        batch = loader._collate_fn(out)
        sync(torch)
        c = time.perf_counter()
        step(batch)
        sync(torch)
        z = time.perf_counter()
        for key, u, v in (('sample', a, b), ('collate', b, c),
                          ('model', c, z)):
          parts[key].append((v - u) * 1e3)
      del batch, out
    it = iter(loader)
    idle = device_idle(torch, lambda: step(next(it))[0], TIERED_PROFILE_STEPS)
    loader.close()
    del it, model, opt, step, loader
    runs[pf] = {'step_ms': wall / TIERED_TIMED * 1e3,
                'seeds_per_s': TIERED_TIMED * TRAIN_BATCH / wall,
                'wall_secs': wall, 'batches_produced': produced,
                'losses': losses, 'cache': rates,
                'miss_rows_per_batch': miss_mean,
                'lookup_ms_by_part': lookup,
                'launches': launches, 'plain_calls': plain,
                'device_idle': idle}
    if parts is not None:
      runs[pf]['step_ms_by_part'] = {
          'median': {k: float(np.median(v)) for k, v in parts.items()},
          'all': parts}
  if not torch.equal(digests[0], digests[2]):
    raise AssertionError('tiered prefetch=2 timed batches differ from '
                         'prefetch=0')
  emit('tiered_train', split_ratio=TIERED_TRAIN_SPLIT, hot_rows=f.hot_rows,
       cold_rows=NUM_NODES - f.hot_rows,
       hot_bytes=f.hot_rows * FEAT_DIM * 4,
       cold_pinned_bytes=(NUM_NODES - f.hot_rows) * FEAT_DIM * 4,
       cache_rows=f.cold_cache.capacity,
       cache_bytes=f.cold_cache.capacity * FEAT_DIM * 4,
       setup_secs=setup_secs, batch=TRAIN_BATCH, fanouts=list(FANOUTS),
       model=f'GraphSAGE({FEAT_DIM}->256->{GNS_CLASSES}, 3 layers)',
       optimizer=f'Adam({TRAIN_LR})', warm_steps=TIERED_WARM,
       timed_steps=TIERED_TIMED, runs={f'prefetch={k}': v
                                       for k, v in runs.items()},
       batches_byte_equal=True, x_rows_byte_equal=True, y_byte_equal=True,
       k6_ms_per_batch=k6['kernel_ms'])
  return runs, k6, ds


def feature_lookup(torch, ds_hot, ds_t, train_idx):
  """`bench_feature.py`'s lookup sweep, reduced to `LOOKUP_SETS` node
  sets (the node tables of 1,024-seed [15, 10, 5] samples): GB/s (the
  lookups' output bytes over their wall time, closed by a synchronise,
  after one warm pass) at split 1.0 / 0.5 / 0.2 with no cache, then at
  split 0.2 with caches of 0 / 5% / 15% of the cold rows and their hit
  rates over the timed pass."""
  from graphlearn_tpu_torch.data import Feature
  from graphlearn_tpu_torch.sampler import NeighborSampler, NodeSamplerInput
  sampler = NeighborSampler(ds_hot.get_graph(), FANOUTS, seed=5,
                            device=DEVICE)
  rng = np.random.default_rng(6)
  sets = [sampler.sample_from_nodes(NodeSamplerInput(
      node=rng.choice(train_idx, TRAIN_BATCH).astype(np.int32))
  ).node.cpu().numpy() for _ in range(LOOKUP_SETS)]
  src = ds_t.node_features
  table, id_map = src._host, src._id2index_host

  def measure(feat):
    for ids in sets:
      feat.get(ids)
    stats0 = (feat.cold_cache.stats.snapshot()
              if feat.cold_cache is not None else None)
    sync(torch)
    t = time.perf_counter()
    nbytes = 0
    for ids in sets:
      out = feat.get(ids)
      nbytes += out.numel() * out.element_size()
    sync(torch)
    secs = time.perf_counter() - t
    rec = {'gbps': nbytes / secs / 1e9, 'bytes': nbytes, 'secs': secs}
    if stats0 is not None:
      rec['cache'] = cache_rates(feat, stats0)
    return rec

  sweep = {'1.0': measure(ds_hot.node_features)}
  for split in LOOKUP_SPLITS[1:]:
    f = Feature(table, id2index=id_map, split_ratio=split, device=DEVICE,
                cold_cache_rows=0)
    sweep[str(split)] = measure(f)
    f.close()
  cold_rows = NUM_NODES - int(round(NUM_NODES * TIERED_TRAIN_SPLIT))
  budgets = {}
  for frac in LOOKUP_BUDGETS:
    rows = int(cold_rows * frac)
    f = Feature(table, id2index=id_map, split_ratio=TIERED_TRAIN_SPLIT,
                device=DEVICE, cold_cache_rows=rows)
    budgets[str(frac)] = dict(measure(f), cache_rows=rows)
    f.close()
  emit('feature_lookup', node_sets=LOOKUP_SETS,
       ids_per_set=int(sets[0].size), row_bytes=FEAT_DIM * 4,
       gbps_by_split=sweep, cache_split_ratio=TIERED_TRAIN_SPLIT,
       gbps_by_cache_budget=budgets)


def tiered_cross_check(torch):
  """A small graph (4,000 nodes) tiered on the card and on the CPU with
  the same CPU-made draws: 4 `NeighborLoader` batches (``prefetch=2`` on
  the card, 0 on the CPU) byte-equal in node, x, y and edge_index, equal
  cache counters; a tiered `ServingEngine` (split 0.5) byte-equal in
  nodes and x; a bf16 store wholly on the host (split 0) byte-equal."""
  from graphlearn_tpu_torch.data import Dataset, Feature
  from graphlearn_tpu_torch.data.reorder import sort_by_in_degree
  from graphlearn_tpu_torch.loader import NeighborLoader
  from graphlearn_tpu_torch.ops import TorchDraws, hash_draws
  from graphlearn_tpu_torch.serving import ServingEngine
  rng = np.random.default_rng(13)
  n = 4000
  rows = np.concatenate([np.repeat(np.arange(n), 12), np.full(300, 7)])
  cols = np.where(rng.random(rows.shape[0]) < 0.3,
                  rng.integers(0, 40, rows.shape[0]),
                  rng.integers(0, n, rows.shape[0]))
  feats = rng.standard_normal((n, 16)).astype(np.float32)
  labels = rng.integers(0, 7, n).astype(np.int32)
  cpu = TorchDraws(7, 'cpu')
  out, stats, served, host_only = {}, {}, {}, {}
  ids = rng.integers(-1, n, 777)
  for dev in (DEVICE, 'cpu'):
    def draws(step, hop, r, k, w, dev=dev):
      return tuple(t.to(dev) for t in cpu(step, hop, r, k, w))

    def serve_draws(seed_ids, t, f, k, w):
      u, g = hash_draws(3, seed_ids.cpu(), t, f, k, w)
      return u.to(seed_ids.device), g.to(seed_ids.device)
    ds = (Dataset().init_graph((rows, cols), num_nodes=n, device=dev)
          .init_node_features(feats, sort_func=sort_by_in_degree,
                              split_ratio=0.3, device=dev,
                              cold_cache_rows=64)
          .init_node_labels(labels))
    # one whole epoch of 4 batches: the card's worker produces no batch
    # past them, so the cache counters compare
    lo = NeighborLoader(ds, FANOUTS, np.arange(256) * 15, batch_size=64,
                        shuffle=True, seed=1, draws=draws, device=dev,
                        prefetch=2 if dev == DEVICE else 0)
    out[dev] = [(b.node.cpu(), b.x.cpu(), b.y.cpu(), b.edge_index.cpu())
                for b in lo]
    stats[dev] = ds.node_features.cold_cache.stats.snapshot()
    ds.node_features.close()
    ds_s = (Dataset().init_graph((rows, cols), num_nodes=n, device=dev)
            .init_node_features(feats, split_ratio=0.5, device=dev,
                                cold_cache_rows=32))
    eng = ServingEngine(ds_s, FANOUTS, seed=3, buckets=(8,), device=dev,
                        draws=serve_draws)
    served[dev] = [eng.infer(np.array(s)) for s in
                   ([7, 1, 2, 3, 999, 2999, 15], [7, 7, 40], [3999])]
    ds_s.node_features.close()
    f0 = Feature(feats, split_ratio=0.0, device=dev, dtype=torch.bfloat16)
    host_only[dev] = f0.get(ids).cpu().view(torch.int16)
    f0.close()
  if not len(out[DEVICE]) == len(out['cpu']) == 4:
    raise AssertionError(f'tiered cross check: {len(out[DEVICE])} and '
                         f'{len(out["cpu"])} batches')
  for i, (a, c) in enumerate(zip(out[DEVICE], out['cpu'])):
    for name, x, y in zip(('node', 'x', 'y', 'edge_index'), a, c):
      if x.dtype != y.dtype or not torch.equal(x, y):
        raise AssertionError(f'tiered card and CPU differ: batch {i} {name}')
  if stats[DEVICE] != stats['cpu'] or not stats['cpu']['hits']:
    raise AssertionError(f'cache counters differ: {stats}')
  for a, c in zip(served[DEVICE], served['cpu']):
    if (a.nodes.tobytes() != c.nodes.tobytes()
        or a.x.tobytes() != c.x.tobytes()):
      raise AssertionError('tiered serving differs between card and CPU')
  if not torch.equal(host_only[DEVICE], host_only['cpu']):
    raise AssertionError('the split-0 bf16 store differs between card and '
                         'CPU')
  emit('tiered_cross_check', batches=4, byte_equal=True, cache=stats['cpu'],
       serving_dispatches=3, split0_bf16_byte_equal=True)


def gns_bytes(deg: np.ndarray, k: int, w: int) -> int:
  """Bytes the GNS sampler must move for these rows: the seed, its
  bits-table row index and two indptr entries; for ``deg > k`` the k
  draws of its arm; the window ids and their bit bytes on the medium
  arm (``k < deg <= w``), the ids it returns on the others; and 9 bytes
  out per slot (int32 id, bool mask, f32 weight)."""
  deg = deg.astype(np.int64)
  medium = (deg > k) & (deg <= w)
  reads = np.where(medium, 5 * deg, 4 * np.clip(deg, 0, k))
  per_row = 8 + 16 * (deg >= 0) + 4 * k * (deg > k) + reads + 9 * k
  return int(per_row.sum())


def check_gns(torch, ops, timer, indptr, indices, seeds, k, u, v, bits,
              boost, req, w):
  """The GNS kernel against its plain version on the same rows (seeds
  in the order the kernel sees them): byte-equal nbrs, mask, weights."""
  before = ops.sample_one_hop_gns_fused.launches
  args = (indptr, indices, seeds, k, u, v, bits, boost)
  got = ops.sample_one_hop_gns_fused(*args, req=req, window=w)
  ref = ops.sample_one_hop_gns(*args, req=req, window=w)
  sync(torch)
  same = (torch.equal(got.nbrs, ref.nbrs) and torch.equal(got.mask, ref.mask)
          and torch.equal(got.weights.view(torch.int32),
                          ref.weights.view(torch.int32)))
  if not same:
    bad = int((got.nbrs != ref.nbrs).sum()
              + (got.weights != ref.weights).sum())
    raise AssertionError(f'GNS kernel != plain version (k={k}, boost='
                         f'{boost}, {bad} slots differ)')
  err = max(int((got.nbrs.long() - ref.nbrs.long()).abs().max()),
            float((got.weights - ref.weights).abs().max()))
  deg = ops.lookup_degree(indptr, seeds).cpu().numpy()
  deg = np.where(seeds.cpu().numpy() >= 0, deg, -1)
  m = got.mask
  nbytes = gns_bytes(deg, k, w)
  # the kernel alone: the table row of each seed resolved outside the
  # timed call (the wrapper's small ops are timed as wrapper_ms)
  table = ops.gns.bits_table(bits)
  rows = ops.gns.bits_rows(bits, req, seeds.numel(), seeds.device
                           ).contiguous()
  rec = {
      'rows': int(seeds.numel()), 'k': k, 'w': w, 'boost': boost,
      'table_rows': int(table.shape[0]),
      'arms': {'empty_or_invalid': int((deg <= 0).sum()),
               'take_all': int(((deg > 0) & (deg <= k)).sum()),
               'window': int(((deg > k) & (deg <= w)).sum()),
               'hub': int((deg > w).sum())},
      'weights_ne_1': int(((got.weights != 1.0) & m).sum()),
      'byte_equal': True, 'max_abs_err': err,
      'kernel_ms': timer(lambda: ops.fused_sample.gns_kernel(
          indptr, indices, seeds, k, u, v, table, rows, boost, w)),
      'wrapper_ms': timer(lambda: ops.sample_one_hop_gns_fused(
          *args, req=req, window=w)),
      'plain_ms': timer(lambda: ops.sample_one_hop_gns(
          *args, req=req, window=w)),
      'bytes': nbytes, 'bound_us': nbytes / HBM_BYTES_PER_S * 1e6}
  rec['launches'] = ops.sample_one_hop_gns_fused.launches - before
  return rec


#: window positions m whose cum boundary (between m - 1 and m) the
#: forced GNS draws land on: the edges of the kernel's lane shares
GNS_BOUNDARIES = (7, 8, 15, 16, 31, 32)


def boundary_draws(torch, ops, indptr, indices, seeds, bits, req, boost,
                   w, ms=GNS_BOUNDARIES):
  """``(v [B, len(ms)], ok [B, len(ms)])``: per row the draw ``v`` with
  ``fl(v * max(total, 1e-9)) == cum[m - 1]`` exactly (the row's cum as
  the plain version computes it), found by stepping ``cum[m - 1] /
  total`` one ulp at a time; ``ok`` where the row is on the medium arm
  with ``m < deg`` and the step found one."""
  e = indices.numel()
  n = indptr.numel() - 1
  s = torch.where(seeds >= 0, seeds.long(), 0).clamp(max=n)
  start = indptr[s]
  deg = ops.lookup_degree(indptr, seeds).long()
  lane = torch.arange(w, device=seeds.device)
  in_deg = lane[None, :] < deg[:, None]
  ids = indices[(start[:, None] + lane[None, :]).clamp(0, max(e - 1, 0))]
  cached = ops.gns.bitmask_lookup(bits, torch.where(in_deg, ids, -1),
                                  req=req)
  wgt = torch.where(in_deg, 1.0 + torch.tensor(boost, device=seeds.device)
                    * cached.float(), 0.0)
  cum = torch.cumsum(wgt, dim=1)
  scale = cum[:, -1].clamp(min=1e-9)
  out_v, out_ok = [], []
  for m in ms:
    target = cum[:, min(m, w) - 1]
    v = target / scale
    for _ in range(4):
      p = v * scale
      v = torch.where(p < target, torch.nextafter(v, torch.ones_like(v)),
                      torch.where(p > target,
                                  torch.nextafter(v, torch.zeros_like(v)),
                                  v))
    ok = (v * scale == target) & (deg > m) & (deg <= w) & (v < 1)
    out_v.append(v)
    out_ok.append(ok)
  return torch.stack(out_v, 1), torch.stack(out_ok, 1)


def gns_forced_graph(torch, k, w, rows, seed):
  """A CSR for the GNS kernel's forced sets: rows cycle through deg 0,
  deg <= k, deg = k + 1, k < deg <= w (three in eight), deg = w and
  deg > w; ids run to ``rows + 39`` (the last ones past the bits
  table's last byte) and every 53rd is -1; the seeds are a permutation
  with every 97th -1 and every 101st past N."""
  rng = np.random.default_rng(seed + 31 * k + w)
  kind = np.arange(rows) % 8
  med = rng.integers(k + 1, w + 1, rows) if w > k else np.full(rows, w)
  deg = np.select(
      [kind == 0, kind == 1, kind == 2, kind == 4, kind == 5],
      [0, rng.integers(1, k + 1, rows), min(k + 1, w + 1), w,
       rng.integers(w + 1, 4 * w + 1, rows)], med)
  indptr = np.zeros(rows + 1, np.int64)
  np.cumsum(deg, out=indptr[1:])
  indices = rng.integers(0, rows + 40, int(indptr[-1])).astype(np.int32)
  indices[::53] = -1
  seeds = rng.permutation(rows).astype(np.int32)
  seeds[::97] = -1
  seeds[3::101] = rows + 3
  return (torch.from_numpy(indptr).to(DEVICE),
          torch.from_numpy(indices).to(DEVICE),
          torch.from_numpy(seeds).to(DEVICE))


def forced_gns_sets(torch, ops, k, w, rows=4096, seed=7, boost=16.0):
  """Inputs of one forced GNS set (`gns_forced_graph`): a three-row
  dedup table (random bits, nothing cached, everything cached; ``nbytes
  = ceil(rows / 8)``, so the ids past ``rows`` read the last byte) read
  through per-row requesters; draws of 0 (v on every third row's first
  slot), just below 1 (v on the next row's last slot, u on every 11th
  row's first), and exactly on the cum boundaries of `GNS_BOUNDARIES`
  (every other slot of the medium rows, where ``m < deg``).  Returns
  ``(indptr, indices, seeds, u, v, bits, req, n_boundary)``."""
  indptr, indices, seeds = gns_forced_graph(torch, k, w, rows, seed)
  rng = np.random.default_rng(seed + k)
  nbytes = (rows + 7) // 8
  table = np.stack([rng.integers(0, 256, nbytes).astype(np.uint8),
                    np.zeros(nbytes, np.uint8),
                    np.full(nbytes, 255, np.uint8)])
  bits = (torch.from_numpy(table).to(DEVICE),
          torch.from_numpy(np.array([0, 1, 2, 0], np.int32)).to(DEVICE))
  req = torch.from_numpy(rng.integers(0, 4, rows).astype(np.int32)).to(
      DEVICE)
  gen = torch.Generator(device=DEVICE).manual_seed(seed + k + w)
  below_1 = float(np.nextafter(np.float32(1), np.float32(0)))
  u = torch.rand(rows, k, device=DEVICE, generator=gen)
  u[::11, 0] = below_1
  v = torch.rand(rows, k, device=DEVICE, generator=gen)
  bv, ok = boundary_draws(torch, ops, indptr, indices, seeds, bits, req,
                          boost, w)
  r = torch.arange(rows, device=DEVICE)[:, None]
  j = torch.arange(k, device=DEVICE)[None, :]
  pick = (r + j) % len(GNS_BOUNDARIES)
  on = ((r + j) % 2 == 0) & torch.gather(ok, 1, pick.expand(rows, k))
  v = torch.where(on, torch.gather(bv, 1, pick.expand(rows, k)), v)
  v[0::3, 0] = 0.0
  v[1::3, k - 1] = below_1
  return indptr, indices, seeds, u, v, bits, req, int(on.sum())


#: K1-GNS's forced row counts: two passes, one pass and a warp a row at
#: every lane-group width (K1's, `forced_sampler_sets`)
FORCED_ROWS = (150_001, 20_001, 1_001)
#: K1-GNS's forced shapes past 64 slots a tile, where a warp loads and
#: stores its last slots in turn: k 40 at window 256 on 20,001 rows
#: (two passes of a row a warp, 80 slots)
GNS_WIDE = ((40, 256, 20_001),)


def forced_gns_cases(torch, ops, timer, seed=17):
  """K1-GNS against its plain version (byte-equal nbrs, mask and the
  weights' bits) at every k of `SAMPLER_FANOUTS`, at the default window
  and at 256, on `FORCED_ROWS`, and at `GNS_WIDE`: boosts 16 and 3
  through the wrapper; the same rows with their second half padding
  (seed -1, valid seeds ascending first, as the mesh hands each owner);
  and the kernel alone with table rows out of ``[0, T-1]`` against the
  plain version's clamped stack form.  At boost 16 the kernel alone is
  timed (`Timer`) on the rows and on their half-padding form."""
  from graphlearn_tpu_torch.ops import default_window
  out, cases_run = [], 0
  shapes = [(k, w, rows) for k in SAMPLER_FANOUTS
            for w in sorted({default_window(k), 256})
            for rows in FORCED_ROWS] + list(GNS_WIDE)

  def same(got, ref):
    return (torch.equal(got.nbrs, ref.nbrs)
            and torch.equal(got.mask, ref.mask)
            and torch.equal(got.weights.view(torch.int32),
                            ref.weights.view(torch.int32)))

  for k, w, rows in shapes:
    for boost in (16.0, 3.0):
      indptr, indices, seeds, u, v, bits, req, n_b = forced_gns_sets(
          torch, ops, k, w, rows, seed, boost)
      args = (indptr, indices, seeds, k, u, v, bits, boost)
      cases = {'wrapper': (args, req)}
      if boost == 16.0:
        valid = torch.sort(seeds[seeds >= 0]).values[:rows // 2]
        half = torch.full_like(seeds, -1)
        half[:valid.numel()] = valid
        cases['half padding'] = ((indptr, indices, half, k, u, v, bits,
                                  boost), req)
      rec = {'k': k, 'w': w, 'rows': rows, 'boost': boost,
             'boundary_draws': n_b}
      for name, (a, rq) in cases.items():
        got = ops.sample_one_hop_gns_fused(*a, req=rq, window=w)
        ref = ops.sample_one_hop_gns(*a, req=rq, window=w)
        if not same(got, ref):
          raise AssertionError(
              f'GNS kernel != plain version (forced k={k}, w={w}, '
              f'{rows} rows, boost {boost}, {name})')
        cases_run += 1
        if boost == 16.0:
          table = ops.gns.bits_table(bits)
          trows = ops.gns.bits_rows(bits, rq, rows, DEVICE).contiguous()
          rec[f'{name.replace(" ", "_")}_kernel_ms'] = timer(
              lambda a=a, table=table, trows=trows: (
                  ops.fused_sample.gns_kernel(*a[:6], table, trows, boost,
                                              w)))
      if boost == 16.0:
        # the kernel clamps its table rows; the stack form's plain
        # version clamps req the same way
        table = bits[0]
        raw = torch.from_numpy(np.random.default_rng(k).integers(
            -3, table.shape[0] + 3, rows).astype(np.int32)).to(DEVICE)
        got = ops.fused_sample.gns_kernel(indptr, indices, seeds, k, u, v,
                                          table, raw, boost, w)
        ref = ops.sample_one_hop_gns(*args[:6], table, boost, req=raw,
                                     window=w)
        if not same(got, ref):
          raise AssertionError(
              f'GNS kernel != plain version (forced k={k}, w={w}, '
              f'{rows} rows, table rows out of range)')
        cases_run += 1
      if n_b == 0:
        raise AssertionError(f'no boundary draw at k={k}, w={w}')
      out.append(rec)
  return {'sets': out, 'cases': cases_run, 'byte_equal': True}


def gns_data(torch, indptr, indices, feats, labels):
  """The GNS training path's dataset: the products graph as COO, the
  `make_labels` labels, the tiered `DistDataset` (split 0.3) on the
  card."""
  from graphlearn_tpu_torch.parallel import DistDataset
  t0 = time.perf_counter()
  deg = indptr[1:] - indptr[:-1]
  rows = torch.repeat_interleave(
      torch.arange(NUM_NODES, device=DEVICE), deg)
  ds = DistDataset.from_full_graph(1, rows, indices, node_feat=feats,
                                   node_label=labels, num_nodes=NUM_NODES,
                                   split_ratio=GNS_SPLIT, device=DEVICE)
  del rows
  sync(torch)
  nf = ds.node_features
  hot = int(nf.hot_counts[0])
  emit('gns_data', nodes=NUM_NODES, edges=int(indices.numel()),
       split_ratio=GNS_SPLIT, hot_rows=hot, cold_rows=NUM_NODES - hot,
       hot_bytes=hot * FEAT_DIM * 4,
       cold_host_bytes=int(nf.cold_host.numel()) * 4,
       cold_host_pinned=bool(nf.cold_host.is_pinned()),
       classes=int(labels.max()) + 1, secs=time.perf_counter() - t0)
  return ds


def gns_kernel(torch, ops, timer, path_hops):
  """The GNS kernel against its plain version at the three hops of one
  1,024-seed batch of the training path (its own bits table, the seeds
  in the order the kernel sees them), timed on a forced set at each
  fanout at boosts 16 and 3, then on `forced_gns_cases`.
  Returns ``(per-hop records, forced cases)``."""
  recs = []
  for t, a in enumerate(path_hops):
    rec = check_gns(torch, ops, timer, *a)
    emit('kernel', kernel='sample_one_hop_gns', shape=f'train hop {t}',
         **rec)
    recs.append(rec)
  for k in FANOUTS:
    w = ops.default_window(k)
    for boost in (16.0, 3.0):
      indptr, indices, seeds, u, v, bits, req, _ = forced_gns_sets(
          torch, ops, k, w, boost=boost)
      rec = check_gns(torch, ops, timer, indptr, indices, seeds, k, u, v,
                      bits, boost, req, w)
      if min(rec['arms'].values()) == 0:
        raise AssertionError(f'GNS forced set missed an arm: {rec["arms"]}')
      emit('kernel', kernel='sample_one_hop_gns', shape='forced set',
           **rec)
  forced = forced_gns_cases(torch, ops, timer)
  emit('kernel', kernel='sample_one_hop_gns', shape='forced sets', **forced)
  return recs, forced


class PathRecorder:
  """Wraps the mesh sampler's kernel calls (the GNS sampler with
  ``gns``, else the uniform one) and its row gathers to keep the latest
  dispatch's kernel inputs: its ``hops x parts`` sampler calls (hop-major,
  each with its rows in the order the kernel sees them) and its ``tables
  x parts`` gathers (the hot-tier features, then the labels, each owner
  in turn)."""

  def __init__(self, torch, mod, gns=True, parts=1, tables=2):
    self.torch, self.mod, self.gns = torch, mod, gns
    self.name = 'sample_one_hop_gns_fused' if gns else 'sample_one_hop_fused'
    self.real = getattr(mod, self.name)
    self.real_gather = mod.gather_rows
    self.n_samples, self.n_gathers = len(FANOUTS) * parts, tables * parts
    self.samples, self.calls = {}, 0
    self.gathers, self.gather_calls = {}, 0

  def gather(self, table, ids, id2index=None):
    self.gathers[self.gather_calls % self.n_gathers] = (table, ids)
    self.gather_calls += 1
    return self.real_gather(table, ids, id2index)

  def __call__(self, indptr, indices, seeds, k, u, v, *rest, req=None,
               window=None, sort_locality=False):
    torch = self.torch
    order = torch.argsort(torch.where(seeds >= 0, seeds,
                                      torch.iinfo(seeds.dtype).max),
                          stable=True)
    args = (indptr, indices, seeds[order].contiguous(), k, u, v)
    if self.gns:
      args += tuple(rest) + (req[order].contiguous(), window)
    self.samples[self.calls % self.n_samples] = args
    self.calls += 1
    kw = dict(req=req, window=window) if self.gns else {}
    return self.real(indptr, indices, seeds, k, u, v, *rest,
                     sort_locality=sort_locality, **kw)

  def sample_calls(self) -> list:
    return [self.samples[i] for i in range(self.n_samples)]

  def gather_calls_in_order(self) -> list:
    return [self.gathers[i] for i in range(self.n_gathers)]

  def __enter__(self):
    setattr(self.mod, self.name, self)
    self.mod.gather_rows = self.gather
    return self

  def __exit__(self, *exc):
    setattr(self.mod, self.name, self.real)
    self.mod.gather_rows = self.real_gather


def summed(recs) -> dict:
  """Kernel records of one hop's (or one table's) per-owner calls, the
  sizes and times summed over the owners."""
  out = {'owners': len(recs), 'byte_equal': True,
         'max_abs_err': max(r['max_abs_err'] for r in recs)}
  for key in ('rows', 'ids', 'valid', 'bytes', 'bound_us', 'kernel_ms',
              'wrapper_ms', 'plain_ms', 'library_ms'):
    if key in recs[0]:
      out[key] = sum(r[key] for r in recs)
  for key in ('k', 'w', 'boost', 'dtype', 'row_bytes'):
    if key in recs[0]:
      out[key] = recs[0][key]
  return out


def check_mesh_path(torch, ops, timer, rec, path) -> dict:
  """Every sampler and row-gather call of one recorded mesh dispatch held
  against its plain version (byte-equal), each timed; one ``kernel`` line
  per hop and per table, summed over the owners."""
  per_hop, per_table = [], []
  for t in range(len(FANOUTS)):
    calls = rec.sample_calls()[t * MESH_PARTS:(t + 1) * MESH_PARTS]
    if rec.gns:
      recs = [check_gns(torch, ops, timer, *a) for a in calls]
    else:
      recs = [check_sampler(torch, ops, timer, *a)[1] for a in calls]
    per_hop.append(summed(recs))
    emit('kernel', kernel='sample_one_hop_gns' if rec.gns else
         'sample_one_hop', shape=f'{path} hop {t}, {MESH_PARTS} owners',
         **per_hop[-1])
  calls = rec.gather_calls_in_order()
  for t, what in enumerate(('hot-tier features', 'labels')):
    recs = [check_gather(torch, ops, timer, *a)
            for a in calls[t * MESH_PARTS:(t + 1) * MESH_PARTS]]
    per_table.append(summed(recs))
    emit('kernel', kernel='gather_rows',
         shape=f'{path} {what}, {MESH_PARTS} owners', **per_table[-1])
  return {'hops': per_hop, 'gathers': per_table}


def hit_rates(stats: dict) -> dict:
  return {k: stats[f'dist.feature.{k}'] for k in (
      'lookups', 'cold_lookups', 'cold_misses', 'cache_hits',
      'cache_admits', 'hot_hit_rate', 'cache_hit_rate')}


def gns_train(torch, ops, timer, ds, feats, labels, prof=False):
  """GNS-biased GraphSAGE training on the tiered store: 2 warm steps
  (their last dispatch's kernel inputs recorded and checked), 8 timed
  steps (dispatch / cold overlay / model, each closed by a synchronise),
  checks on every timed batch, 8 steps in the loader's pipelined order
  timed as one window; then the loader alone with GNS on and off over
  the same seeds for seeds/s and hit rates."""
  import graphlearn_tpu_torch.parallel.dist_sampler as dsm
  from graphlearn_tpu_torch.models import GraphSAGE
  from graphlearn_tpu_torch.parallel import (DistNeighborLoader,
                                             make_dp_supervised_step)
  seeds = np.arange(NUM_NODES)
  cache_rows = int(ds.node_features.hot_counts.max())    # equal budget
  loader = DistNeighborLoader(ds, FANOUTS, seeds, batch_size=GNS_BATCH,
                              shuffle=True, seed=0,
                              cold_cache_rows=cache_rows, gns=True,
                              device=DEVICE)
  s = loader.sampler
  model = GraphSAGE(FEAT_DIM, 256, GNS_CLASSES, num_layers=3).to(DEVICE)
  model.reset_parameters(torch.Generator().manual_seed(0))
  opt = torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-8)
  step = make_dp_supervised_step(model, opt, GNS_BATCH, s.mesh)
  new2old = torch.from_numpy(ds.new2old).to(DEVICE)
  it = iter(loader)
  losses = []
  t0 = time.perf_counter()
  with PathRecorder(torch, dsm) as rec:
    for _ in range(GNS_WARM):
      loss, _ = step(next(it))
      losses.append(float(loss))
  warm_secs = time.perf_counter() - t0
  path_hops = rec.sample_calls()
  kernel_recs, gns_forced = gns_kernel(torch, ops, timer, path_hops)
  gather_recs = []
  for t, what in ((0, 'train hot-tier features'), (1, 'train labels')):
    g = check_gather(torch, ops, timer, *rec.gathers[t])
    emit('kernel', kernel='gather_rows', shape=what, **g)
    gather_recs.append(g)
  del path_hops, rec

  parts = {'dispatch': [], 'overlay': [], 'model': []}

  def timed(fn, key):
    def wrapped(*a):
      sync(torch)
      t = time.perf_counter()
      out = fn(*a)
      sync(torch)
      parts[key].append((time.perf_counter() - t) * 1e3)
      return out
    return wrapped

  s._dispatch_nodes = timed(s._dispatch_nodes, 'dispatch')
  s._finish_nodes = timed(s._finish_nodes, 'overlay')
  for fn in (ops.sample_one_hop_gns_fused, ops.sample_one_hop_fused,
             ops.gather_rows):
    fn.launches = 0
  for fn in (ops.sample_one_hop_gns, ops.sample_one_hop,
             ops.gather_rows_plain):
    fn.calls = 0
  disp0 = s._step_cnt
  walls, wmin, n_weights_ne_1 = [], None, 0
  for _ in range(GNS_TIMED):
    t = time.perf_counter()
    batch = next(it)
    t_model = time.perf_counter()
    loss, correct = step(batch)
    losses.append(float(loss))
    parts['model'].append((time.perf_counter() - t_model) * 1e3)
    walls.append((time.perf_counter() - t) * 1e3)
    node, x = batch.node[0], batch.x[0]
    ok = node >= 0
    src = new2old[node[ok].long()]
    if not torch.equal(x[ok], feats[src]):
      raise AssertionError('a gathered x row differs from its source row')
    if not torch.equal(batch.y[0][ok], labels[src]):
      raise AssertionError('a gathered label differs from its source label')
    ew, em = batch.metadata['edge_weight'][0], batch.edge_mask[0]
    if not (bool((ew[~em] == 0).all()) and bool((ew[em] > 0).all())):
      raise AssertionError('edge weights: masked != 0 or valid <= 0')
    n_weights_ne_1 += int(((ew != 1.0) & em).sum())
  dispatches = s._step_cnt - disp0
  launches = {'sample_one_hop_gns': ops.sample_one_hop_gns_fused.launches,
              'gather_rows': ops.gather_rows.launches,
              'sample_one_hop': ops.sample_one_hop_fused.launches}
  plain = (ops.sample_one_hop_gns.calls + ops.sample_one_hop.calls
           + ops.gather_rows_plain.calls)
  st = s.exchange_stats()
  if not (launches['sample_one_hop_gns'] == len(FANOUTS) * dispatches
          and launches['gather_rows'] == 2 * dispatches
          and launches['sample_one_hop'] == 0 and plain == 0
          and dispatches == GNS_TIMED):
    raise AssertionError(f'launch counts {launches}, plain calls {plain}, '
                         f'dispatches {dispatches}')
  if st['dist.frontier.dropped'] or st['dist.feature.dropped']:
    raise AssertionError(f'exchange drops: {st}')
  if n_weights_ne_1 == 0:
    raise AssertionError('every GNS weight is 1: the bias never engaged')
  if not (np.isfinite(losses).all()
          and np.mean(losses[-3:]) < losses[0]):
    raise AssertionError(f'losses {losses}')
  del s._dispatch_nodes, s._finish_nodes
  # the loader's own order (batch k+1 dispatched before batch k's
  # overlay), no synchronise inside: one window over GNS_TIMED steps
  sync(torch)
  t = time.perf_counter()
  pipelined_losses = [step(next(it))[0] for _ in range(GNS_TIMED)]
  pipelined_losses = [float(x) for x in pipelined_losses]
  pipelined_secs = time.perf_counter() - t
  if not np.isfinite(pipelined_losses).all():
    raise AssertionError(f'pipelined losses {pipelined_losses}')
  if prof:
    profile_train(torch, lambda: step(next(it))[0], 'gns_train')
  del it, loader, batch

  def loader_only(gns):
    lo = DistNeighborLoader(ds, FANOUTS, seeds, batch_size=GNS_BATCH,
                            shuffle=True, seed=0, cold_cache_rows=cache_rows,
                            gns=gns, device=DEVICE)
    it2 = iter(lo)
    for _ in range(GNS_WARM):
      next(it2)
    sync(torch)
    t = time.perf_counter()
    for _ in range(GNS_TIMED):
      b = next(it2)
    b.x.sum().item()
    secs = time.perf_counter() - t
    out = hit_rates(lo.sampler.exchange_stats())
    out['seeds_per_s'] = GNS_TIMED * GNS_BATCH / secs
    out['batches'] = GNS_WARM + GNS_TIMED
    del it2, lo
    return out

  on, off = loader_only(True), loader_only(False)
  counts = np.diff(ds.graph.bounds)
  cold_universe = int(np.maximum(counts - ds.node_features.hot_counts,
                                 0).sum())
  med = {k: float(np.median(v)) for k, v in parts.items()}
  emit('gns_train', batch=GNS_BATCH, fanouts=list(FANOUTS),
       model=f'GraphSAGE({FEAT_DIM}->256->{GNS_CLASSES}, 3 layers)',
       optimizer='Adam(1e-3)', warm_steps=GNS_WARM, timed_steps=GNS_TIMED,
       warm_secs=warm_secs, losses=losses,
       step_ms={'median': float(np.median(walls)),
                'mean': float(np.mean(walls)), 'all': walls},
       step_ms_by_part={'median': med,
                        'mean': {k: float(np.mean(v))
                                 for k, v in parts.items()}},
       train_seeds_per_s_synced=GNS_BATCH * 1e3 / float(np.median(walls)),
       pipelined_secs=pipelined_secs,
       train_seeds_per_s_pipelined=GNS_TIMED * GNS_BATCH / pipelined_secs,
       pipelined_losses=pipelined_losses,
       loader_gns_on=on, loader_gns_off=off,
       budget_over_universe=cache_rows / max(cold_universe, 1),
       cache_rows=cache_rows, cold_universe=cold_universe,
       node_capacity=s.node_capacity(GNS_BATCH),
       exchange={k: v for k, v in st.items() if k.startswith('dist.')
                 and not k.startswith('dist.feature.c')},
       launches=launches, dispatches=dispatches, plain_calls=plain,
       weights_ne_1=n_weights_ne_1, x_rows_byte_equal=True,
       y_byte_equal=True)
  return launches, kernel_recs, gather_recs, gns_forced


def gns_cross_check(torch):
  """A small tiered graph on the card and on the CPU with the same
  CPU-made draws: 4 batches byte-equal (node, x, y, edge_index,
  edge_weight) while the cache admits between them; logits within 1e-4
  after one training step."""
  from graphlearn_tpu_torch.models import GraphSAGE
  from graphlearn_tpu_torch.parallel import (DistDataset, DistNeighborLoader,
                                             TorchDraws,
                                             make_dp_supervised_step)
  rng = np.random.default_rng(8)
  n = 4000
  rows = np.repeat(np.arange(n), 12)
  cols = np.where(rng.random(n * 12) < 0.3, rng.integers(0, 40, n * 12),
                  rng.integers(0, n, n * 12))
  feats = rng.standard_normal((n, 16)).astype(np.float32)
  labels = rng.integers(0, 7, n).astype(np.int32)
  cpu_draws = TorchDraws(5, 'cpu')
  out, logits, admits = {}, {}, {}
  for dev in (DEVICE, 'cpu'):
    def draws(*a, dev=dev, **kw):
      return tuple(t.to(dev) for t in cpu_draws(*a, **kw))
    ds = DistDataset.from_full_graph(1, rows, cols, node_feat=feats,
                                     node_label=labels, num_nodes=n,
                                     split_ratio=0.3, device=dev)
    lo = DistNeighborLoader(ds, FANOUTS, np.arange(n), batch_size=64,
                            shuffle=True, seed=1, cold_cache_rows=300,
                            gns=True, draws=draws, device=dev)
    batches = list(itertools.islice(iter(lo), 4))
    out[dev] = [(b.node.cpu(), b.x.cpu(), b.y.cpu(), b.edge_index.cpu(),
                 b.metadata['edge_weight'].cpu()) for b in batches]
    admits[dev] = lo.sampler.exchange_stats()['dist.feature.cache_admits']
    model = GraphSAGE(16, 32, 7, num_layers=3).to(dev)
    model.reset_parameters(torch.Generator().manual_seed(3))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-8)
    make_dp_supervised_step(model, opt, 64, lo.sampler.mesh)(batches[0])
    b = batches[1]
    with torch.no_grad():
      logits[dev] = model(b.x[0], b.edge_index[0], b.edge_mask[0],
                          edge_weight=b.metadata['edge_weight'][0]).cpu()
  for i, (a, c) in enumerate(zip(out[DEVICE], out['cpu'])):
    for name, x, y in zip(('node', 'x', 'y', 'edge_index', 'edge_weight'),
                          a, c):
      if x.dtype != y.dtype or not torch.equal(x, y):
        raise AssertionError(f'card and CPU differ: batch {i} {name}')
  diff = float((logits[DEVICE] - logits['cpu']).abs().max())
  if not diff <= 1e-4 or admits[DEVICE] == 0:
    raise AssertionError(f'logits differ by {diff}; admits {admits}')
  emit('gns_cross_check', batches=4, byte_equal=True,
       cache_admits=admits[DEVICE], logits_max_abs_diff=diff)


def mesh_data(torch, indptr, indices, feats, labels):
  """The mesh paths' two stores of the products graph at P = 8
  partitions on the card (`bench.py`'s ``DIST_PARTS``): untiered (every
  shard wholly on the card) and tiered at split 0.3 (the hot rows on the
  card, the whole table in pinned host memory), both with the `train`
  phase's labels."""
  from graphlearn_tpu_torch.parallel import DistDataset
  t0 = time.perf_counter()
  deg = indptr[1:] - indptr[:-1]
  rows = torch.repeat_interleave(
      torch.arange(NUM_NODES, device=DEVICE), deg)
  stores = {}
  for name, split in (('untiered', 1.0), ('tiered', MESH_SPLIT)):
    stores[name] = DistDataset.from_full_graph(
        MESH_PARTS, rows, indices, node_feat=feats, node_label=labels,
        num_nodes=NUM_NODES, split_ratio=split, device=DEVICE)
  del rows
  sync(torch)
  u, t = stores['untiered'], stores['tiered']
  g = u.graph
  emit('mesh_data', parts=MESH_PARTS, nodes=NUM_NODES,
       edges=int(indices.numel()), bounds=g.bounds.tolist(),
       shard_shape=list(u.node_features.shards.shape),
       shard_bytes=u.node_features.shards.numel() * 4,
       csr_bytes=(g.indptr.numel() * 8 + g.indices.numel() * 4
                  + g.edge_ids.numel() * 8),
       split_ratio=MESH_SPLIT,
       hot_counts=t.node_features.hot_counts.tolist(),
       hot_bytes=t.node_features.shards.numel() * 4,
       cold_host_bytes=t.node_features.cold_host.numel() * 4,
       cold_host_pinned=bool(t.node_features.cold_host.is_pinned()),
       secs=time.perf_counter() - t0)
  return u, t


def check_mesh_batch(torch, batch, feats, labels, new2old) -> int:
  """Every valid node's ``x`` row and label of a stacked mesh batch
  equal its source; returns the valid node count."""
  node = batch.node
  ok = node >= 0
  src = new2old[node[ok].long()]
  if not torch.equal(batch.x[ok], feats[src]):
    raise AssertionError('a mesh x row differs from its source row')
  if not torch.equal(batch.y[ok], labels[src]):
    raise AssertionError('a mesh label differs from its source label')
  return int(ok.sum())


def mesh_loader(torch, ops, timer, ds, feats, labels):
  """`bench.py`'s ``dist_worker`` adaptive phase at products scale: the
  untiered store, `DistNeighborLoader([15, 10, 5], batch_size=512,
  shuffle=True, seed=0, exchange_slack='adaptive')` over the first 512 x
  8 x 4 seeds of the seeded permutation, 3 epochs of 4 batches (each
  batch timed to its synchronise; the checks outside the clock).  The
  first batch's kernel inputs are recorded (inside its clock) and every
  one of its 24 sampler and 16 gather calls is held against its plain
  version after the run."""
  import graphlearn_tpu_torch.parallel.dist_sampler as dsm
  from graphlearn_tpu_torch.parallel import DistNeighborLoader
  seeds = np.random.default_rng(0).permutation(NUM_NODES)[
      :MESH_BATCH * MESH_PARTS * MESH_BATCHES_PER_EPOCH]
  loader = DistNeighborLoader(ds, FANOUTS, seeds, batch_size=MESH_BATCH,
                              shuffle=True, seed=0,
                              exchange_slack='adaptive', device=DEVICE)
  s = loader.sampler
  new2old = torch.from_numpy(ds.new2old).to(DEVICE)
  waste, slack, batch_ms, edges, valid = [], [], [], 0, 0
  reset_counts(ops)
  for _ in range(MESH_EPOCHS):
    prev = s.exchange_stats()
    it = iter(loader)                   # retunes the slack
    slack.append(loader._adaptive.slack)
    while True:
      sync(torch)
      t = time.perf_counter()
      try:
        if batch_ms:
          b = next(it)
        else:
          with PathRecorder(torch, dsm, gns=False, parts=MESH_PARTS) as rec:
            b = next(it)
      except StopIteration:
        break
      n_edges = int(b.edge_mask.sum())          # synchronises
      batch_ms.append((time.perf_counter() - t) * 1e3)
      edges += n_edges
      valid += check_mesh_batch(torch, b, feats, labels, new2old)
    st = s.exchange_stats()
    sent = ((st['dist.frontier.offered'] - prev['dist.frontier.offered'])
            - (st['dist.frontier.dropped'] - prev['dist.frontier.dropped']))
    slots = st['dist.frontier.slots'] - prev['dist.frontier.slots']
    waste.append(100.0 * (1 - sent / max(slots, 1)))
  launches, plain = read_counts(ops)
  batches, secs = len(batch_ms), sum(batch_ms) / 1e3
  per_dispatch = len(FANOUTS) * MESH_PARTS       # K1: one per owner a hop
  if not (launches['sample_one_hop'] == per_dispatch * batches
          and launches['gather_rows'] == 2 * MESH_PARTS * batches
          and launches['sample_one_hop_gns'] == 0 and plain == 0
          and batches == MESH_EPOCHS * MESH_BATCHES_PER_EPOCH):
    raise AssertionError(f'mesh loader launches {launches}, plain {plain}, '
                         f'batches {batches}')
  path = check_mesh_path(torch, ops, timer, rec, 'mesh loader')
  del rec
  st = s.exchange_stats()
  node_table = b.node
  emit('mesh_loader', parts=MESH_PARTS, batch=MESH_BATCH,
       fanouts=list(FANOUTS), epochs=MESH_EPOCHS, batches=batches,
       exchange_slack='adaptive', slack_by_epoch=slack,
       slack_final=loader._adaptive.slack,
       pinned=loader._adaptive._pinned,
       pin_reason=loader._adaptive._pin_reason,
       padding_waste_pct_by_epoch=waste,
       drop_rate_pct=100.0 * st['dist.frontier.dropped']
       / max(st['dist.frontier.offered'], 1),
       feature_drop_rate_pct=100.0 * st['dist.feature.dropped']
       / max(st['dist.feature.offered'], 1),
       secs=secs, batch_ms=batch_ms,
       seeds_per_s=batches * MESH_BATCH * MESH_PARTS / secs,
       seeds_per_s_after_first=(batches - 1) * MESH_BATCH * MESH_PARTS
       / (secs - batch_ms[0] / 1e3),
       sampled_edges=edges,
       edges_per_s_per_partition=edges / secs / MESH_PARTS,
       node_capacity=s.node_capacity(MESH_BATCH), valid_nodes=valid,
       exchange={k: v for k, v in st.items()
                 if k.startswith(('dist.frontier', 'dist.feature.o',
                                  'dist.feature.d', 'dist.feature.s'))},
       launches=launches, launches_per_dispatch={
           'sample_one_hop': per_dispatch, 'gather_rows': 2 * MESH_PARTS},
       plain_calls=plain, x_rows_byte_equal=True, y_byte_equal=True)
  return launches, node_table, path


def check_push(torch, timer, recv, starts, table, what, rec_times=False):
  """K5 against its plain version on the same receive ids (byte-equal,
  the whole buffer); with ``rec_times`` both timed and `index_select`
  over the precomputed flat positions beside them."""
  from graphlearn_tpu_torch.parallel import push_rows, push_rows_plain
  got = push_rows(recv, starts, table)
  ref = push_rows_plain(recv, starts, table)
  sync(torch)
  if got.shape != ref.shape or not torch.equal(got.view(torch.uint8),
                                               ref.view(torch.uint8)):
    raise AssertionError(f'push_rows kernel != plain version ({what})')
  err = float((got.float() - ref.float()).abs().max())
  p, _, c = recv.shape
  row = table.shape[2] * table.element_size()
  n_valid = int((recv >= 0).sum())
  nbytes = recv.numel() * 4 + p * 8 + n_valid * row + recv.numel() * row
  rec = {'what': what, 'parts': p, 'capacity': c,
         'slots': recv.numel(), 'valid_slots': n_valid,
         'dtype': str(table.dtype).replace('torch.', ''), 'row_bytes': row,
         'byte_equal': True, 'max_abs_err': err, 'bytes': nbytes,
         'bound_us': nbytes / HBM_BYTES_PER_S * 1e6}
  if rec_times:
    local = (recv.long() - starts[:, None, None]).clamp(
        0, table.shape[1] - 1)
    own = torch.arange(p, device=DEVICE)[:, None, None] * table.shape[1]
    pos = (own + local).transpose(0, 1).reshape(-1)
    flat = table.view(-1, table.shape[2])
    if not torch.equal(flat.index_select(0, pos).view(torch.uint8),
                       got.reshape(-1, table.shape[2]).view(torch.uint8)):
      raise AssertionError('index_select over the push positions differs')
    del got, ref
    rec['kernel_ms'] = timer(lambda: push_rows(recv, starts, table))
    rec['plain_ms'] = timer(lambda: push_rows_plain(recv, starts, table))
    rec['library_ms'] = timer(lambda: torch.index_select(flat, 0, pos))
  return rec


def k5_kernel(torch, timer, ds, nodes):
  """K5 at one `mesh_loader` batch's node table (``[8, 468,992]``, the
  capacity ``capacity_spec(468,992, 8, 2.0)``): the path's run of the
  `rdma_gather` entry point (counts zeroed just before, read just
  after), the kernel against its plain version on the whole ``[8, 8,
  117,248, 100]`` buffer, `rdma_gather` against `dist_gather_multi` on
  the whole ``[8, 468,992, 100]`` result, timings, and the forced set."""
  from graphlearn_tpu_torch.parallel import (dist_gather_multi, make_mesh,
                                             push_rows, push_rows_plain,
                                             rdma_gather)
  from graphlearn_tpu_torch.parallel.exchange import (capacity_spec,
                                                      plan_exchange)
  from graphlearn_tpu_torch.parallel.partition_book import range_owner_fn
  mesh = make_mesh(MESH_PARTS, device=DEVICE)
  shards = ds.node_features.shards
  bounds = torch.from_numpy(ds.graph.bounds).to(DEVICE)
  starts = bounds[:-1].contiguous()
  cap = capacity_spec(nodes.shape[1], MESH_PARTS, 2.0)

  def plan_recv(ids, capacity):
    plan = plan_exchange(ids, range_owner_fn(bounds), MESH_PARTS, mesh,
                         capacity)
    return plan.recv.reshape(MESH_PARTS, MESH_PARTS, plan.cap).to(
        torch.int32)

  # the path's run
  push_rows.launches = 0
  push_rows_plain.calls = 0
  out = rdma_gather(mesh, shards, bounds, nodes, capacity=cap)
  sync(torch)
  launches, plain = push_rows.launches, push_rows_plain.calls
  if launches != 1 or plain != 0:
    raise AssertionError(f'rdma_gather launches {launches}, plain {plain}')
  (ref,), stats = dist_gather_multi(mesh, (shards,), bounds, nodes,
                                    capacity=cap)
  if not torch.equal(out.view(torch.uint8), ref.view(torch.uint8)):
    raise AssertionError('rdma_gather != dist_gather_multi')
  dropped = int(stats[1])
  del out, ref
  rec = check_push(torch, timer, plan_recv(nodes, cap), starts, shards,
                   'mesh batch node table', rec_times=True)
  rec['rdma_gather_ms'] = timer(
      lambda: rdma_gather(mesh, shards, bounds, nodes, capacity=cap))
  rec['dist_gather_multi_ms'] = timer(
      lambda: dist_gather_multi(mesh, (shards,), bounds, nodes,
                                capacity=cap))
  rec.update(ids=list(nodes.shape), exchange_dropped=dropped,
             rdma_gather_byte_equal=True, launches=launches,
             plain_calls=plain)
  emit('kernel', kernel='push_rows', shape='mesh batch node table', **rec)
  # the forced set
  rng = np.random.default_rng(11)
  rand = torch.from_numpy(rng.integers(0, NUM_NODES, (MESH_PARTS, 4096))
                          .astype(np.int32)).to(DEVICE)
  rand[:, ::10] = -1
  zero_owned = torch.arange(12, dtype=torch.int32,
                            device=DEVICE).repeat(MESH_PARTS, 1)
  labels = ds.node_labels
  forced = (
      ('invalid ids, f32 D=100', shards, rand, None),
      ('partition 0 ids at capacity 8 (drops)', shards, zero_owned, 8),
      ('bf16 D=100', shards.to(torch.bfloat16), nodes, cap),
      ('bf16 D=3', shards[..., :3].to(torch.bfloat16).contiguous(), nodes,
       cap),
      ('int32 label column', labels, nodes, cap),
      ('f32 D=3', shards[..., :3].contiguous(), nodes, cap))
  for what, table, ids, capacity in forced:
    got = rdma_gather(mesh, table, bounds, ids, capacity=capacity)
    (alt,), _ = dist_gather_multi(mesh, (table,), bounds, ids,
                                  capacity=capacity)
    if not torch.equal(got.view(torch.uint8), alt.view(torch.uint8)):
      raise AssertionError(f'rdma_gather != dist_gather_multi ({what})')
    if capacity == 8:                   # 12 ids an owner-0 bucket: 4 drop
      kept = (got[..., 0] != 0).sum(1)
      if bool((kept != 8).any()):
        raise AssertionError(f'capacity 8 kept {kept.tolist()}')
    t3 = table if table.ndim == 3 else table[..., None]
    frec = check_push(torch, timer, plan_recv(ids, capacity), starts, t3,
                      what)
    emit('kernel', kernel='push_rows', shape='forced set', **frec)
    del got, alt, table
  return rec


def mesh_train(torch, ops, timer, ds, feats, labels, train_idx, test_idx,
               prof=False):
  """`bench.py`'s ``dist_worker`` tiered GNS row with training on top:
  the tiered store, `DistNeighborLoader(gns=True, cold_cache_rows=
  91,839)` (the equal-HBM victim cache), batch 512 x 8 partitions ->
  `make_dp_supervised_step` with ``GraphSAGE(100, 256, 47, 3)`` and
  Adam(1e-3): 2 warm steps (their last dispatch's 24 GNS and 16 gather
  calls held against the plain versions), 6 timed steps (dispatch / cold
  overlay / model, each closed by a synchronise), then
  `make_dp_eval_step` on 4 test batches."""
  import graphlearn_tpu_torch.parallel.dist_sampler as dsm
  from graphlearn_tpu_torch.models import GraphSAGE
  from graphlearn_tpu_torch.parallel import (DistNeighborLoader,
                                             make_dp_eval_step,
                                             make_dp_supervised_step)
  cache_rows = int(ds.node_features.hot_counts.max())    # equal budget
  loader = DistNeighborLoader(ds, FANOUTS, train_idx, batch_size=MESH_BATCH,
                              shuffle=True, seed=0,
                              cold_cache_rows=cache_rows, gns=True,
                              device=DEVICE)
  s = loader.sampler
  model = GraphSAGE(FEAT_DIM, 256, GNS_CLASSES, num_layers=3).to(DEVICE)
  model.reset_parameters(torch.Generator().manual_seed(0))
  opt = torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-8)
  step = make_dp_supervised_step(model, opt, MESH_BATCH, s.mesh)
  new2old = torch.from_numpy(ds.new2old).to(DEVICE)
  it = iter(loader)
  losses = []
  t0 = time.perf_counter()
  with PathRecorder(torch, dsm, gns=True, parts=MESH_PARTS) as rec:
    for _ in range(MESH_WARM):
      losses.append(float(step(next(it))[0]))
  warm_secs = time.perf_counter() - t0
  path = check_mesh_path(torch, ops, timer, rec, 'mesh train')
  del rec
  parts = {'dispatch': [], 'overlay': [], 'model': []}

  def timed(fn, key):
    def wrapped(*a):
      sync(torch)
      t = time.perf_counter()
      out = fn(*a)
      sync(torch)
      parts[key].append((time.perf_counter() - t) * 1e3)
      return out
    return wrapped

  s._dispatch_nodes = timed(s._dispatch_nodes, 'dispatch')
  s._finish_nodes = timed(s._finish_nodes, 'overlay')
  reset_counts(ops)
  disp0 = s._step_cnt
  s.overlay_secs = dict.fromkeys(dsm.OVERLAY_PARTS, 0.0)
  walls, n_ne_1, correct, seen = [], 0, 0, 0
  for _ in range(MESH_TIMED):
    t = time.perf_counter()
    batch = next(it)
    t_model = time.perf_counter()
    loss, c = step(batch)
    losses.append(float(loss))
    parts['model'].append((time.perf_counter() - t_model) * 1e3)
    walls.append((time.perf_counter() - t) * 1e3)
    correct += int(c)
    seen += int((batch.batch >= 0).sum())
    check_mesh_batch(torch, batch, feats, labels, new2old)
    ew, em = batch.metadata['edge_weight'], batch.edge_mask
    if not (bool((ew[~em] == 0).all()) and bool((ew[em] > 0).all())):
      raise AssertionError('mesh edge weights: masked != 0 or valid <= 0')
    n_ne_1 += int(((ew != 1.0) & em).sum())
  dispatches = s._step_cnt - disp0
  launches, plain = read_counts(ops)
  per_dispatch = {'sample_one_hop_gns': len(FANOUTS) * MESH_PARTS,
                  'gather_rows': 2 * MESH_PARTS}
  st = s.exchange_stats()
  if not (all(launches[k] == v * dispatches
              for k, v in per_dispatch.items())
          and launches['sample_one_hop'] == 0 and plain == 0
          and dispatches == MESH_TIMED):
    raise AssertionError(f'mesh train launches {launches}, plain {plain}, '
                         f'dispatches {dispatches}')
  if st['dist.frontier.dropped'] or st['dist.feature.dropped']:
    raise AssertionError(f'mesh exchange drops: {st}')
  if n_ne_1 == 0:
    raise AssertionError('every mesh GNS weight is 1: the bias never engaged')
  if not (np.isfinite(losses).all()
          and np.mean(losses[-3:]) < losses[0]):
    raise AssertionError(f'mesh losses {losses}')
  # prefetch=0: the synchronised window's overlay parts, then
  # `MESH_TIMED` steps in the loader's own (unsynchronised) order timed
  # as one window, and the idle share of 3 more
  overlay = {k: v * 1e3 / dispatches for k, v in s.overlay_secs.items()}
  del s._dispatch_nodes, s._finish_nodes
  sync(torch)
  t = time.perf_counter()
  window = [step(next(it))[0] for _ in range(MESH_TIMED)]
  losses += [float(x) for x in window]
  unsynced = (time.perf_counter() - t) / MESH_TIMED * 1e3
  windows = {'prefetch=0': {
      'steps': MESH_TIMED, 'step_ms': unsynced,
      'train_seeds_per_s': MESH_BATCH * MESH_PARTS * 1e3 / unsynced,
      'step_ms_median_synced': float(np.median(walls)),
      'overlay_ms_by_part_synced': overlay,
      'device_idle': device_idle(torch, lambda: step(next(it))[0], 3)}}
  if prof:
    profile_train(torch, lambda: step(next(it))[0], 'mesh_train')
  del it, batch
  windows['prefetch=2'] = mesh_prefetch_window(
      torch, ops, ds, feats, labels, train_idx, cache_rows, step, losses)
  ev_loader = DistNeighborLoader(ds, FANOUTS, test_idx,
                                 batch_size=MESH_BATCH, shuffle=False,
                                 cold_cache_rows=cache_rows, gns=False,
                                 device=DEVICE)
  ev_step = make_dp_eval_step(model, MESH_BATCH, ev_loader.sampler.mesh)
  ev_correct = ev_total = 0
  t = time.perf_counter()
  for b in itertools.islice(iter(ev_loader), MESH_EVAL_BATCHES):
    c, n = ev_step(b)
    ev_correct += int(c)
    ev_total += int(n)
  eval_secs = time.perf_counter() - t
  acc = ev_correct / max(ev_total, 1)
  if not acc > 1.0 / GNS_CLASSES:
    raise AssertionError(f'mesh eval accuracy {acc}')
  med = {k: float(np.median(v)) for k, v in parts.items()}
  emit('mesh_train', parts=MESH_PARTS, batch=MESH_BATCH,
       fanouts=list(FANOUTS), split_ratio=MESH_SPLIT, cache_rows=cache_rows,
       model=f'GraphSAGE({FEAT_DIM}->256->{GNS_CLASSES}, 3 layers)',
       optimizer='Adam(1e-3)', warm_steps=MESH_WARM, timed_steps=MESH_TIMED,
       warm_secs=warm_secs, losses=losses,
       step_ms={'median': float(np.median(walls)),
                'mean': float(np.mean(walls)), 'all': walls},
       step_ms_by_part={'median': med, 'all': parts},
       train_seeds_per_s_synced=MESH_BATCH * MESH_PARTS * 1e3
       / float(np.median(walls)),
       train_accuracy_timed=correct / max(seen, 1),
       eval_batches=MESH_EVAL_BATCHES, eval_seeds=ev_total,
       eval_accuracy=acc, eval_secs=eval_secs,
       node_capacity=s.node_capacity(MESH_BATCH),
       exchange={k: v for k, v in st.items() if k.startswith('dist.')},
       launches=launches, launches_per_dispatch=per_dispatch,
       dispatches=dispatches, plain_calls=plain, weights_ne_1=n_ne_1,
       x_rows_byte_equal=True, y_byte_equal=True, windows=windows)
  return launches, path


def mesh_prefetch_window(torch, ops, ds, feats, labels, train_idx,
                         cache_rows, step, losses) -> dict:
  """The mesh step with ``prefetch=2`` over the same seeds: a new
  loader (its own victim cache) whose worker thread dispatches and runs
  the cold overlay on its own stream while the model trains; 2 warm
  steps (their batches checked against the source), `MESH_TIMED` steps
  timed as one window, the device's idle share over 3 more steps, the
  overlay's parts per dispatch as the worker saw them over the loader's
  life.  Checks: 24 GNS and 16 row-gather launches a dispatch, no plain
  call, no drop, finite losses."""
  import graphlearn_tpu_torch.parallel.dist_sampler as dsm
  from graphlearn_tpu_torch.parallel import DistNeighborLoader
  loader = DistNeighborLoader(ds, FANOUTS, train_idx, batch_size=MESH_BATCH,
                              shuffle=True, seed=0,
                              cold_cache_rows=cache_rows, gns=True,
                              prefetch=2, device=DEVICE)
  s = loader.sampler
  new2old = torch.from_numpy(ds.new2old).to(DEVICE)
  reset_counts(ops)
  it = iter(loader)
  for _ in range(MESH_WARM):
    batch = next(it)
    losses.append(float(step(batch)[0]))
    check_mesh_batch(torch, batch, feats, labels, new2old)
  del batch
  sync(torch)
  t = time.perf_counter()
  window = [step(next(it))[0] for _ in range(MESH_TIMED)]
  losses += [float(x) for x in window]
  wall = time.perf_counter() - t
  idle = device_idle(torch, lambda: step(next(it))[0], 3)
  loader.close()
  # the worker runs ahead of the consumer: launches and overlay seconds
  # are counted over the loader's whole life, against its dispatches
  dispatches = s._step_cnt
  launches, plain = read_counts(ops)
  st = s.exchange_stats()
  if not (launches['sample_one_hop_gns']
          == len(FANOUTS) * MESH_PARTS * dispatches
          and launches['gather_rows'] == 2 * MESH_PARTS * dispatches
          and plain == 0 and dispatches >= MESH_WARM + MESH_TIMED + 3):
    raise AssertionError(f'mesh prefetch launches {launches}, plain '
                         f'{plain}, dispatches {dispatches}')
  if st['dist.frontier.dropped'] or st['dist.feature.dropped']:
    raise AssertionError(f'mesh exchange drops: {st}')
  if not np.isfinite(losses).all():
    raise AssertionError(f'mesh losses {losses}')
  return {'steps': MESH_TIMED, 'step_ms': wall / MESH_TIMED * 1e3,
          'train_seeds_per_s': MESH_BATCH * MESH_PARTS * MESH_TIMED / wall,
          'dispatches': dispatches,
          'overlay_ms_by_part': {k: v * 1e3 / dispatches
                                 for k, v in s.overlay_secs.items()},
          'device_idle': idle, 'launches': launches, 'plain_calls': plain}


def mesh_cross_check(torch):
  """A small graph at P = 4 on the card and on the CPU with the same
  CPU-made draws: 4 batches byte-equal untiered (node, x, y,
  edge_index) and tiered with GNS (and edge_weight), `rdma_gather`
  equal on both, logits within 1e-4 after one DP step."""
  from graphlearn_tpu_torch.models import GraphSAGE
  from graphlearn_tpu_torch.parallel import (DistDataset, DistNeighborLoader,
                                             TorchDraws,
                                             make_dp_supervised_step,
                                             make_mesh, rdma_gather)
  rng = np.random.default_rng(9)
  n, parts = 4000, 4
  rows = np.repeat(np.arange(n), 12)
  cols = np.where(rng.random(n * 12) < 0.3, rng.integers(0, 40, n * 12),
                  rng.integers(0, n, n * 12))
  feats = rng.standard_normal((n, 16)).astype(np.float32)
  labels = rng.integers(0, 7, n).astype(np.int32)
  cpu_draws = TorchDraws(6, 'cpu')
  out, logits, gathered = {}, {}, {}
  for dev in (DEVICE, 'cpu'):
    def draws(*a, dev=dev, **kw):
      return tuple(t.to(dev) for t in cpu_draws(*a, **kw))
    out[dev] = []
    for split, gns in ((1.0, False), (0.3, True)):
      ds = DistDataset.from_full_graph(parts, rows, cols, node_feat=feats,
                                       node_label=labels, num_nodes=n,
                                       split_ratio=split, device=dev)
      lo = DistNeighborLoader(ds, FANOUTS, np.arange(n), batch_size=64,
                              shuffle=True, seed=1, cold_cache_rows=300,
                              gns=gns, draws=draws, device=dev)
      batches = list(itertools.islice(iter(lo), 4))
      for b in batches:
        ew = b.metadata.get('edge_weight')
        out[dev].append((b.node.cpu(), b.x.cpu(), b.y.cpu(),
                         b.edge_index.cpu(),
                         None if ew is None else ew.cpu()))
      if split == 1.0:
        gathered[dev] = rdma_gather(
            make_mesh(parts, device=dev), ds.node_features.shards,
            ds.graph.bounds, batches[0].node, capacity=256).cpu()
    model = GraphSAGE(16, 32, 7, num_layers=3).to(dev)
    model.reset_parameters(torch.Generator().manual_seed(3))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-8)
    make_dp_supervised_step(model, opt, 64, lo.sampler.mesh)(batches[0])
    b = batches[1]
    with torch.no_grad():
      logits[dev] = model(b.x[2], b.edge_index[2], b.edge_mask[2],
                          edge_weight=b.metadata['edge_weight'][2]).cpu()
  for i, (a, c) in enumerate(zip(out[DEVICE], out['cpu'])):
    for name, x, y in zip(('node', 'x', 'y', 'edge_index', 'edge_weight'),
                          a, c):
      if (x is None) != (y is None) or (x is not None and (
          x.dtype != y.dtype or not torch.equal(x, y))):
        raise AssertionError(f'mesh card and CPU differ: batch {i} {name}')
  if not torch.equal(gathered[DEVICE], gathered['cpu']):
    raise AssertionError('rdma_gather differs between card and CPU')
  diff = float((logits[DEVICE] - logits['cpu']).abs().max())
  if not diff <= 1e-4:
    raise AssertionError(f'mesh logits differ by {diff}')
  emit('mesh_cross_check', parts=parts, batches=len(out['cpu']),
       byte_equal=True, rdma_gather_equal=True, logits_max_abs_diff=diff)


def profile_train(torch, run_step, path, n=3):
  """Device time by kernel over ``n`` training steps of ``path``
  (``run_step()`` runs one and returns its loss; no synchronise inside):
  the top kernels, the port's kernels, and the device idle share of
  the window."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity
  sync(torch)
  with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    for _ in range(n):
      loss = run_step()
    float(loss)
    sync(torch)
    wall_ms = (time.perf_counter() - t0) * 1e3
  rows = []
  for ev in prof.key_averages():
    if ev.device_type != DeviceType.CUDA:
      continue
    rows.append((ev.self_device_time_total / 1e3, ev.key, ev.count))
  rows.sort(reverse=True)
  busy = sum(r[0] for r in rows)
  mine = {g: sum(r[0] for r in rows if g in r[1])
          for g in ('sample_one_hop_kernel', 'sample_gns_kernel',
                    'gather_rows_kernel', 'push_rows_kernel')}
  emit('profile_train', path=path, steps=n, wall_ms=wall_ms,
       device_busy_ms=busy, device_idle_share=1 - busy / wall_ms,
       port_kernels_ms=mine,
       top=[{'name': k[:90], 'device_ms': ms, 'count': c}
            for ms, k, c in rows[:15]])


def profile(torch, eng):
  """Device time by kernel over 20 warm 16-seed dispatches (kernel
  events only, so a torch op and the kernel it launched are not both
  counted), grouped into the port's kernels, matmuls, copies and the
  rest (mostly the elementwise ops of the draws and the model)."""
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity
  n = 20
  seeds = np.random.default_rng(9).integers(0, NUM_NODES, 16)
  for _ in range(3):
    eng.infer(seeds)
  sync(torch)
  with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    for i in range(n):
      eng.infer(seeds + i)
    sync(torch)
    wall_ms = (time.perf_counter() - t0) * 1e3
  groups = {'sample_one_hop_kernel': 0.0, 'gather_rows_kernel': 0.0,
            'matmul': 0.0, 'memcpy': 0.0, 'other': 0.0}
  launches = dict.fromkeys(groups, 0)
  top = []
  for ev in prof.key_averages():
    if ev.device_type != DeviceType.CUDA:
      continue
    us = ev.self_device_time_total
    name = ev.key
    group = next((g for g in ('sample_one_hop_kernel', 'gather_rows_kernel')
                  if g in name), None)
    if group is None:
      low = name.lower()
      group = ('matmul' if 'gemm' in low or 'xmma' in low else
               'memcpy' if 'memcpy' in low else 'other')
    groups[group] += us / 1e3
    launches[group] += ev.count
    top.append((us, name, ev.count))
  top.sort(reverse=True)
  busy_ms = sum(groups.values())
  emit('profile', dispatches=n, seeds_per_dispatch=16, wall_ms=wall_ms,
       device_busy_ms=busy_ms, device_idle_share=1 - busy_ms / wall_ms,
       device_ms_by_group=groups, launches_by_group=launches,
       device_us_per_launch={
           g: groups[g] * 1e3 / launches[g]
           for g in ('sample_one_hop_kernel', 'gather_rows_kernel')
           if launches[g]},
       top=[{'name': k[:70], 'device_ms': us / 1e3, 'count': c}
            for us, k, c in top[:10]])


def main(argv) -> int:
  t_start = time.perf_counter()
  import torch
  if not torch.cuda.is_available():
    print('chip_smoke: CUDA is not available', file=sys.stderr)
    return 2
  root = os.path.dirname(os.path.abspath(__file__))
  sys.path.insert(0, root)
  try:
    import graphlearn_tpu_torch  # noqa: F401
  except ImportError as e:
    print(f'chip_smoke: the graphlearn_tpu_torch package is not beside '
          f'this script ({e})', file=sys.stderr)
    return 2

  # -- env --------------------------------------------------------------
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True,
      check=True).stdout.strip().splitlines()[0]
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  name = torch.cuda.get_device_name(0)
  print(smi, flush=True)
  emit('env', nvidia_smi=smi, device=name,
       device_count=torch.cuda.device_count(), torch=torch.__version__,
       cuda=torch.version.cuda, python=sys.version.split()[0],
       matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
       cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
  kernels = run(torch, argv)
  emit('wall', secs=time.perf_counter() - t_start)
  print(json.dumps({'kernels': kernels}), flush=True)
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': name,
      'count': torch.cuda.device_count()}}), flush=True)
  return 0


def run(torch, argv) -> list:
  """Every phase after env; returns the ``kernels`` summary."""
  from graphlearn_tpu_torch import _build, ops
  from graphlearn_tpu_torch.data import Dataset
  from graphlearn_tpu_torch.ops import default_window, hash_draws

  # -- build ------------------------------------------------------------
  t0 = time.perf_counter()
  info = _build.build_all()
  emit('build', wall_secs=time.perf_counter() - t0,
       kernels={k: {'secs': v['secs'],
                    'ptxas': [ln.strip() for ln in v['ptxas'].splitlines()
                              if 'registers' in ln or 'spill' in ln]}
                for k, v in info.items()})

  # -- graph ------------------------------------------------------------
  t0 = time.perf_counter()
  indptr, indices = products_graph(torch, DEVICE)
  feats = torch.randn(NUM_NODES, FEAT_DIM, device=DEVICE,
                      generator=torch.Generator(device=DEVICE).manual_seed(1))
  ds = (Dataset().init_graph((indptr, indices), layout='CSR',
                             num_nodes=NUM_NODES, device=DEVICE)
        .init_node_features(feats, device=DEVICE))
  sync(torch)
  deg = indptr[1:] - indptr[:-1]
  emit('graph', nodes=NUM_NODES, edges=int(indices.numel()),
       max_degree=int(deg.max()), mean_degree=float(deg.float().mean()),
       feature_shape=list(feats.shape), secs=time.perf_counter() - t0,
       bytes={'csr': indptr.numel() * 8 + indices.numel() * 4,
              'features': feats.numel() * 4})

  # -- kernel vs plain --------------------------------------------------
  timer = Timer(torch)
  seeds16 = torch.from_numpy(np.random.default_rng(2).integers(
      0, NUM_NODES, 16).astype(np.int32)).to(DEVICE)
  frontier, levels, hops = seeds16, [seeds16], []
  width = 1
  for t, k in enumerate(FANOUTS):
    w = default_window(k)
    u, g = hash_draws(0, seeds16, t, width, k, w)
    res, rec = check_sampler(torch, ops, timer, indptr, indices, frontier,
                             k, u, g)
    emit('kernel', kernel='sample_one_hop', shape=f'hop {t}', **rec)
    hops.append(rec)
    frontier = res.nbrs.reshape(-1)
    levels.append(frontier)
    width *= k
  for k in FANOUTS:
    w = default_window(k)
    a_indptr, a_indices, a_seeds = arm_graph(torch, DEVICE, k, w)
    gen = torch.Generator(device=DEVICE).manual_seed(k)
    u = torch.rand(a_seeds.numel(), k, device=DEVICE, generator=gen)
    g = torch.rand(a_seeds.numel(), w, device=DEVICE, generator=gen)
    g[:, ::7] = 0.5                                   # ties in every row
    _, rec = check_sampler(torch, ops, timer, a_indptr, a_indices, a_seeds,
                           k, u, g)
    if min(rec['arms'].values()) == 0:
      raise AssertionError(f'arm check missed an arm: {rec["arms"]}')
    emit('kernel', kernel='sample_one_hop', shape='every arm', **rec)
  k1_forced = forced_sampler_sets(torch, ops)
  emit('kernel', kernel='sample_one_hop', shape='forced sets', **k1_forced)
  k2_forced = forced_gather_sets(torch, ops)
  emit('kernel', kernel='gather_rows', shape='forced sets', **k2_forced)
  tree = torch.cat([lvl.view(16, -1) for lvl in levels], dim=1).reshape(-1)
  gathers = [check_gather(torch, ops, timer, feats, tree)]
  emit('kernel', kernel='gather_rows', shape='16-seed tree', **gathers[0])
  feats_bf16 = feats.to(torch.bfloat16)
  gathers.append(check_gather(torch, ops, timer, feats_bf16, tree))
  emit('kernel', kernel='gather_rows', shape='16-seed tree', **gathers[1])
  del feats_bf16
  indptr_h, indices_h = indptr.cpu().numpy(), indices.cpu().numpy()
  k4, k4_hub, k4_floor, k4_forced = merge_kernel(torch, ops, timer, indptr,
                                                 indices, indptr_h, indices_h)

  # -- serve ------------------------------------------------------------
  eng, launches, reqs, serve_lat = serve(torch, ds)
  small_cross_check(torch)
  if '--profile' in argv:
    profile(torch, eng)
  del eng

  # -- ingest -----------------------------------------------------------
  ingest_launches = ingest(torch, ds.node_features, indptr, indices,
                           indptr_h, indices_h, reqs, serve_lat)
  chaos_recover(torch)

  # -- the window-gather entry point ------------------------------------
  win = window(torch, ops, timer, indptr, indices)

  # -- per-batch training and the fused tree epoch ----------------------
  labels = make_labels(torch, feats)
  train_idx, test_idx = train_splits()
  train_launches, train_hops, train_gather = train(
      torch, ops, timer, ds, feats, labels, train_idx, test_idx,
      prof='--profile' in argv)
  tree_launches, tree_hops, tree_levels = tree_train(
      torch, ops, timer, ds, feats, train_idx, test_idx,
      prof='--profile' in argv)
  train_cross_check(torch)
  torch.cuda.empty_cache()

  # -- the single-card tiered store and its cold gather (K6) ------------
  link = link_rate(torch, timer)
  k6_forced = forced_cold_sets(torch, ops, timer)
  emit('kernel', kernel='cold_gather', shape='forced sets', link=link,
       cases=k6_forced)
  feats_h = feats.cpu()
  tserve_launches, k6_serve = tiered_serve(torch, ops, timer, indptr,
                                           indices, feats_h, ds)
  ttrain_runs, k6_train, ds_t = tiered_train(
      torch, ops, timer, indptr, indices, feats_h, feats, labels, train_idx)
  feature_lookup(torch, ds, ds_t, train_idx)
  ds_t.node_features.close()
  del ds_t, feats_h
  tiered_cross_check(torch)
  torch.cuda.empty_cache()

  # -- GNS-biased training over the tiered store ------------------------
  ds_g = gns_data(torch, indptr, indices, feats, labels)
  gns_launches, gns_hops, gathers_train, gns_forced = gns_train(
      torch, ops, timer, ds_g, feats, labels, prof='--profile' in argv)
  del ds_g
  gns_cross_check(torch)

  # -- the partitioned mesh engine at P = 8 on the card ------------------
  del ds
  torch.cuda.empty_cache()
  ds_u, ds_t = mesh_data(torch, indptr, indices, feats, labels)
  loader_launches, node_table, loader_path = mesh_loader(
      torch, ops, timer, ds_u, feats, labels)
  k5 = k5_kernel(torch, timer, ds_u, node_table)
  del ds_u, node_table
  torch.cuda.empty_cache()
  mesh_launches, mesh_path = mesh_train(torch, ops, timer, ds_t, feats,
                                        labels, train_idx, test_idx,
                                        prof='--profile' in argv)
  del ds_t
  torch.cuda.empty_cache()
  mesh_cross_check(torch)

  # -- summary ----------------------------------------------------------
  f32 = gathers[0]

  def per_hop(hops):
    return [{'rows': h['rows'], 'k': h['k'], 'ms': h['kernel_ms'],
             'bound_ms': h['bound_us'] / 1e3, 'plain_ms': h['plain_ms']}
            for h in hops]

  def mesh_shape(what, hops):
    return {'shape': f'{what}, {MESH_PARTS} owners a hop, hops of '
                     + '/'.join(str(h['rows']) for h in hops)
                     + ' rows, k 15/10/5',
            'ms': sum(h['kernel_ms'] for h in hops),
            'plain_ms': sum(h['plain_ms'] for h in hops),
            'bound_ms': sum(h['bound_us'] for h in hops) / 1e3,
            'max_abs_err': max(h['max_abs_err'] for h in hops),
            'byte_equal': True, 'hops': per_hop(hops)}

  mesh_gathers = loader_path['gathers'] + mesh_path['gathers']
  kernels = [
      {'name': 'sample_one_hop', 'route': 'cuda',
       'source': 'graphlearn_tpu_torch/csrc/sample_one_hop.cu',
       'replaces': 'graphlearn_tpu/ops/pallas_sample.py:247',
       'launches': launches['sample_one_hop'],
       'max_abs_err': max(h['max_abs_err']
                          for h in hops + loader_path['hops']),
       'ms': sum(h['kernel_ms'] for h in hops),
       'plain_ms': sum(h['plain_ms'] for h in hops),
       'bound_ms': sum(h['bound_us'] for h in hops) / 1e3,
       'bound_by': 'bytes',
       'library_ms': None, 'byte_equal': True,
       'shape': '16-seed dispatch, hops of 16/240/2400 rows, k 15/10/5',
       'hops': per_hop(hops), 'forced_sets': len(k1_forced['sets']),
       'launches_by_path': {'serve': launches['sample_one_hop'],
                            'train': train_launches['sample_one_hop'],
                            'tree_train': tree_launches['sample_one_hop'],
                            'tiered_serve': tserve_launches['sample_one_hop'],
                            'tiered_train': {
                                k: r['launches']['sample_one_hop']
                                for k, r in ttrain_runs.items()},
                            'mesh_loader':
                                loader_launches['sample_one_hop']},
       'train_shape': {
           'shape': '1,024-seed per-batch step, hops of '
                    + '/'.join(str(h['rows']) for h in train_hops)
                    + ' rows, k 15/10/5',
           'ms': sum(h['kernel_ms'] for h in train_hops),
           'plain_ms': sum(h['plain_ms'] for h in train_hops),
           'bound_ms': sum(h['bound_us'] for h in train_hops) / 1e3,
           'max_abs_err': max(h['max_abs_err'] for h in train_hops),
           'byte_equal': True, 'hops': per_hop(train_hops)},
       'tree_shape': {
           'shape': '1,024-seed tree step, unsorted hops of '
                    + '/'.join(str(h['rows']) for h in tree_hops)
                    + ' rows, k 15/10/5',
           'ms': sum(h['kernel_ms'] for h in tree_hops),
           'plain_ms': sum(h['plain_ms'] for h in tree_hops),
           'bound_ms': sum(h['bound_us'] for h in tree_hops) / 1e3,
           'max_abs_err': max(h['max_abs_err'] for h in tree_hops),
           'byte_equal': True, 'hops': per_hop(tree_hops)},
       'mesh_shape': mesh_shape('mesh loader batch of 8 x 512 seeds',
                                loader_path['hops'])},
      {'name': 'gather_rows', 'route': 'cuda',
       'source': 'graphlearn_tpu_torch/csrc/gather_rows.cu',
       'replaces': 'graphlearn_tpu/ops/pallas_gather.py:152',
       'launches': launches['gather_rows'],
       'max_abs_err': max(g['max_abs_err']
                          for g in gathers + gathers_train + [train_gather]
                          + tree_levels + mesh_gathers),
       'ms': f32['kernel_ms'],
       'plain_ms': f32['plain_ms'], 'bound_ms': f32['bound_us'] / 1e3,
       'bound_by': 'bytes', 'library_ms': f32['library_ms'],
       'byte_equal': True,
       'shape': f'{f32["ids"]} ids x {FEAT_DIM} f32 (16-seed tree)',
       'forced_sets': k2_forced['cases'],
       'train_shapes': [
           {'shape': f'{g["ids"]} ids x {g["row_bytes"]} B {g["dtype"]}',
            'ms': g['kernel_ms'], 'plain_ms': g['plain_ms'],
            'bound_ms': g['bound_us'] / 1e3, 'library_ms': g['library_ms'],
            'byte_equal': True}
           for g in [train_gather] + tree_levels + gathers_train],
       'mesh_shapes': [
           {'shape': f'{g["ids"]} ids x {g["row_bytes"]} B {g["dtype"]} '
                     f'over {MESH_PARTS} owners',
            'ms': g['kernel_ms'], 'plain_ms': g['plain_ms'],
            'bound_ms': g['bound_us'] / 1e3, 'library_ms': g['library_ms'],
            'byte_equal': True}
           for g in mesh_gathers],
       'launches_by_path': {'serve': launches['gather_rows'],
                            'train': train_launches['gather_rows'],
                            'tree_train': tree_launches['gather_rows'],
                            'tiered_serve': tserve_launches['gather_rows'],
                            'tiered_train': {
                                k: r['launches']['gather_rows']
                                for k, r in ttrain_runs.items()},
                            'gns_train': gns_launches['gather_rows'],
                            'mesh_loader': loader_launches['gather_rows'],
                            'mesh_train': mesh_launches['gather_rows']}},
      {'name': 'merge_ranks', 'route': 'cuda',
       'source': 'graphlearn_tpu_torch/csrc/merge_ranks.cu',
       'replaces': 'graphlearn_tpu/ops/pallas_delta.py:99',
       'launches': ingest_launches['merge_ranks'],
       'max_abs_err': max(r['max_abs_err'] for r in
                          [k4, k4_hub, k4_floor, *k4_forced.values()]),
       'ms': k4['kernel_ms'],
       'plain_ms': k4['plain_ms'], 'bound_ms': k4['bound_us'] / 1e3,
       'bound_by': 'bytes', 'library_ms': None, 'byte_equal': True,
       'shape': f'{k4["events"]}-event batch, {k4["rows"]} dirty rows, '
                f'{k4["base_cols"]} base columns',
       'floor_ms': k4_floor['kernel_ms'],
       'hub_burst_ms': k4_hub['kernel_ms'],
       'hub_burst': {'rows': k4_hub['rows'],
                     'max_new_width': k4_hub['max_new_width'],
                     'plain_ms': k4_hub['plain_ms'],
                     'bound_ms': k4_hub['bound_us'] / 1e3},
       'sort_ms': k4['sort_ms'], 'ranks_alone_ms': k4['ranks_alone_ms'],
       'sort_yardstick': 'two calls: stable torch.sort of the (row, '
                         'column) keys + inverse-permutation scatter; '
                         'never called by the port',
       'forced_ms': {name: r['kernel_ms'] for name, r in k4_forced.items()},
       'forced_bound_ms': {name: r['bound_us'] / 1e3
                           for name, r in k4_forced.items()}},
      {'name': 'sample_one_hop_gns', 'route': 'cuda',
       'source': 'graphlearn_tpu_torch/csrc/sample_one_hop_gns.cu',
       'replaces': 'graphlearn_tpu/ops/pallas_sample.py:247 (gns arm :178)',
       'launches': gns_launches['sample_one_hop_gns'],
       'max_abs_err': max(h['max_abs_err']
                          for h in gns_hops + mesh_path['hops']),
       'ms': sum(h['kernel_ms'] for h in gns_hops),
       'plain_ms': sum(h['plain_ms'] for h in gns_hops),
       'bound_ms': sum(h['bound_us'] for h in gns_hops) / 1e3,
       'bound_by': 'bytes', 'library_ms': None, 'byte_equal': True,
       'shape': '1,024-seed training batch, hops of '
                + '/'.join(str(h['rows']) for h in gns_hops)
                + ' rows, k 15/10/5',
       'hops': per_hop(gns_hops), 'forced_sets': gns_forced['cases'],
       'launches_by_path': {
           'gns_train': gns_launches['sample_one_hop_gns'],
           'mesh_train': mesh_launches['sample_one_hop_gns']},
       'mesh_shape': mesh_shape('mesh train batch of 8 x 512 seeds',
                                mesh_path['hops'])},
      {'name': 'csr_window_gather', 'route': 'cuda',
       'source': 'graphlearn_tpu_torch/csrc/csr_window_gather.cu',
       'replaces': 'graphlearn_tpu/ops/pallas_window.py:82',
       'launches': win['launches'], 'max_abs_err': win['max_abs_err'],
       'ms': win['ms_per_call']['kernel'],
       'plain_ms': win['ms_per_call']['plain'],
       'bound_ms': win['bound_ms'], 'bound_by': 'bytes',
       'library_ms': win['ms_per_call']['library'], 'byte_equal': True,
       'shape': f'{win["batch"]} starts x {win["w"]} (int64 starts), '
                f'{win["iters"]} back-to-back calls',
       'flushed': {'ms': win['ms_flushed']['kernel'],
                   'plain_ms': win['ms_flushed']['plain'],
                   'library_ms': win['ms_flushed']['library'],
                   'timer': 'one call, L2 flushed, median of 30'},
       'forced_sets': win['forced_sets'],
       'forced_width_ms': win['forced_width_ms']},
      {'name': 'push_rows', 'route': 'cuda',
       'source': 'graphlearn_tpu_torch/csrc/push_rows.cu',
       'replaces': 'graphlearn_tpu/parallel/rdma_gather.py:71',
       'launches': k5['launches'], 'max_abs_err': k5['max_abs_err'],
       'ms': k5['kernel_ms'], 'plain_ms': k5['plain_ms'],
       'bound_ms': k5['bound_us'] / 1e3, 'bound_by': 'bytes',
       'library_ms': k5['library_ms'], 'byte_equal': True,
       'shape': f'ids {k5["ids"]} at capacity {k5["capacity"]}: '
                f'{k5["slots"]} slots x {k5["row_bytes"]} B',
       'launches_by_path': {'rdma_gather': k5['launches']},
       'rdma_gather_ms': k5['rdma_gather_ms'],
       'dist_gather_multi_ms': k5['dist_gather_multi_ms'],
       'rdma_gather_byte_equal_to_dist_gather_multi': True},
      {'name': 'cold_gather', 'route': 'cuda',
       'source': 'graphlearn_tpu_torch/csrc/cold_gather.cu',
       'replaces': 'graphlearn_tpu/data/cold_cache.py:507',
       'launches': tserve_launches['cold_gather'],
       'max_abs_err': max(r['max_abs_err'] for r in
                          [k6_serve, k6_train, *k6_forced.values()]),
       'ms': k6_serve['kernel_ms'], 'plain_ms': k6_serve['plain_ms'],
       'bound_ms': k6_serve['bound_ms'], 'bound_by': 'bytes',
       'library_ms': k6_serve['library_ms'], 'byte_equal': True,
       'shape': f'{k6_serve["rows"]} miss rows x {k6_serve["row_bytes"]} B '
                'of a tiered serve dispatch (pinned host -> card)',
       'bound_note': 'the miss bytes over the host link\'s peak (PCIe Gen5 '
                     f'x16, {LINK_BYTES_PER_S / 1e9:g} GB/s one way); '
                     'library_ms: a pinned -> device copy of the same bytes',
       'link_gbps': link['gbps'], 'link_peak_gbps': link['peak_gbps'],
       'train_shape': {
           'shape': f'{k6_train["rows"]} miss rows x '
                    f'{k6_train["row_bytes"]} B of a tiered train batch',
           'ms': k6_train['kernel_ms'], 'plain_ms': k6_train['plain_ms'],
           'bound_ms': k6_train['bound_ms'],
           'library_ms': k6_train['library_ms'],
           'achieved_gbps': k6_train['achieved_gbps'],
           'link_share': k6_train['link_share'],
           'copy_share': k6_train['copy_share'], 'byte_equal': True},
       'forced_sets': len(k6_forced),
       'forced_ms': {k: r['kernel_ms'] for k, r in k6_forced.items()
                     if 'kernel_ms' in r},
       'launches_by_path': {
           'tiered_serve': tserve_launches['cold_gather'],
           'tiered_train': {k: r['launches']['cold_gather']
                            for k, r in ttrain_runs.items()}}},
  ]
  return kernels


if __name__ == '__main__':
  sys.exit(main(sys.argv[1:]))
