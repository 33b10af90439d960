#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, ingest, window-gather,
per-batch training, fused epochs (tree, bf16 tree and subgraph, each
step a CUDA graph; the mesh's), tiered feature store, GNS training,
partitioned mesh (with sampled edges, its link engine, its induced
subgraph, random-walk, fused link and heterogeneous link engines),
heterogeneous-graph, link-prediction, enclosing-subgraph,
sampled-edge-id (edge features), heterogeneous link and random-walk
paths on one NVIDIA card.

Run from the repository root, with one CUDA card visible::

    python3 chip_smoke.py            # what the checks below need
    python3 chip_smoke.py --profile  # adds torch.profiler phases
    python3 chip_smoke.py --hetero   # build and the hetero phases alone
    python3 chip_smoke.py --link     # build, graph and the link phases
    python3 chip_smoke.py --edges    # build, graph, the edge and walk phases
    python3 chip_smoke.py --mesh-link   # build, graph, the mesh's edges
                                        # and link engine
    python3 chip_smoke.py --mesh-engines   # the mesh's subgraph, walk,
                                           # fused link and hetero link
    python3 chip_smoke.py --resume   # build, graph and the snapshot and
                                     # resume phases
    python3 chip_smoke.py --fleet    # build, graph and the rest of
                                     # serving (swap, fleet, autoscale, aot)
    python3 chip_smoke.py --locality # build, graph and the mesh at P = 16
                                     # and 64 (with the P = 64 locality
                                     # comparison the whole run leaves out)
    python3 chip_smoke.py --telemetry   # build, graph and the telemetry
                                        # group alone
    python3 chip_smoke.py --host     # build, graph and the host runtime
                                     # (mp producers, chaos and resume
                                     # rows, the serve RPC)

Phases, one JSON line each; any failure exits nonzero:

  env     card (``nvidia-smi`` name and power limit), torch and CUDA
          versions; TF32 matmuls off.
  build   the seven CUDA kernels and the locality greedy's host code
          compiled from
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
          served on the card and on the CPU must agree.  An `OpsServer`
          on an ephemeral port is scraped once half the requests are
          answered: ``/metrics`` parses strictly with the queue depth,
          shed rate, latency histogram and SLO burn rate (and
          ``/varz``).  After the drive, `measure_tracing_overhead`: 150
          single-seed requests untraced and traced, a warm-up lap and
          the best of 2 each, the ratio against 1.05 (a miss is reported
          in ``bench_gates_missed``: the bench's laps mint no trace, so
          the ratio is the host's lap-to-lap spread), and the same laps
          routed (each request traced), reported.
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
          and Adam(3e-3): 3 warm steps, 1 timed epoch, 5 synchronised
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
          Adam(3e-3, ``capturable=True``), chunks of 100 steps over the
          same split: one warm and 3 timed epochs, `evaluate` on the
          test split.  The first step runs eagerly (the warm-up), the
          rest replay the step captured as a CUDA graph.  Checks: 3 K1
          and 4 K2 launches per step (a replay counts its graph's), no
          plain call, finite losses falling across epochs, accuracy
          above 1/47, 2 captures (train, eval).
  kernel  K1 at the three sorted hops and K2 at the x gather (937,984
          ids x 100 f32) of the fused subgraph epoch's first step.
  fused_session  `bench.py:252-362` (the f32 tree epoch is
          `tree_train`'s): one tree step run eagerly and replayed from
          the same state, seeds and coordinates (bitwise equal), both
          timed by CUDA events over 20 steps; the bf16 tree epoch
          (``TreeSAGE(dtype=bfloat16)``, 1 warm + 2 timed); `FusedEpoch`
          with ``GraphSAGE(100, 256, 47, 3)`` and ``remat=True`` over
          1,024 x 96 seeds in one chunk (a capture run and a timed run:
          ms a step, the 200-step epoch estimated; the eager and the
          replayed step within 1e-4: its ``index_add_`` is atomic).
          Checks: launches per step as above (3 + 1 for the subgraph),
          no plain call, losses falling, accuracy above 1/47, 2
          captures per epoch object.
  train_cross_check  a 4,000-node graph on the card and on the CPU: 3
          `NeighborLoader` batches with the same CPU-made draws
          byte-equal (node, x, y, edge_index, edge_mask) and their
          GraphSAGE step losses within 1e-5; 2 tree-epoch and 3
          subgraph-epoch (remat) steps with the default counter draws,
          captured on the card and eager on the CPU, within 1e-5.
  kernel  K1 at the three hops and K2 at the four level gathers of the
          first step `resume_fused`'s resumed epoch runs (eagerly,
          before its capture), against their plain versions.
  resume_fused  snapshots and mid-epoch resume of the captured tree
          epoch (`tree_train`'s model and optimizer, chunks of 25 steps,
          under deterministic algorithms): a twin runs 2 epochs; a driver
          snapshotting every chunk is killed at the 4th chunk's
          ``fused.dispatch`` seam; a fresh driver (another init) restores
          and finishes the epoch, then runs the next.  Checks: losses,
          counts, parameters and Adam state bitwise the twin's in both
          epochs; 3 K1 and 4 K2 launches a resumed step.  ``restore_secs``,
          chunks skipped, save ms and bytes, and the epoch s with a
          snapshot every chunk against none (min of 3 each).
  kernel  the cold-row gather (K6) against its plain version on forced
          shapes (`forced_cold_sets`: rows of 4, 12, 200 (bf16 x 100),
          400, 512 and 1,024 bytes, M = 0 / 1 / 7 miss rows with ``rel``
          at 0 and Nc - 1 and 3,001 rows in runs of adjacent ``rel``
          (neighbours share 128-byte lines), int32 ids, over
          `pin_memory` blocks, a block one row into its allocation and a
          registered `PinnedColdBuffer`; int64 ids, mismatched id types
          and a block that is not page-locked must raise), byte-equal
          with the rows outside ``pos`` untouched; ``link`` is the best
          of 5 runs of a 256 MiB pinned -> device copy (the rate
          reached), ``thp`` the host's transparent-huge-page mode; K6's
          bound is its link bytes over the link's published peak.
  tiered_serve  `bench_serving.py`'s tiered engine: the products table
          pulled to the host, sorted by in-degree (`sort_by_in_degree`)
          and tiered at split 0.5 (1,224,514 hot rows on the card, the
          cold half registered as page-locked host memory, a 183,678-row
          'auto' victim cache), the serve phase's model and frontend, 256
          requests of 1-16 seeds drawn as Zipf(1.1) ranks over a fixed
          permutation, 4 clients; p50/p99, requests/s, fill ms, hit rate,
          miss rows a dispatch.  Checks: 3 K1, 1 K2 and (with misses) 1
          K6 launch a dispatch, no plain call; 16 requests' x byte-equal
          to the fully-hot engine's and logits within 1e-5; the serve
          phase's mid-run scrape, also with the cache hit rate.  Then a
          `kernel` line: K6 at the last dispatch's miss set.
  tiered_train  BASELINE config 1's step over the same sort at split 0.2
          (489,806 hot rows, 1,959,223 cold rows pinned, a 293,884-row
          cache): `NeighborLoader` at ``prefetch=0`` and then 2 over the
          same seeds, 3 warm + 6 timed steps each (with ``--profile``
          the device idle share of 3 more), the ``prefetch=0`` step
          split into sample / collate / model.  Checks: both runs' batches byte-equal (the warm ones
          whole, the timed ones by digest), x rows and labels equal their
          source, 3 K1 + 1 K2 + 1 K6 launches a batch, no plain call,
          losses falling.  A `kernel` line: K6 at a batch's miss set,
          then its diagnosis (`k6_diagnosis`): the same misses sorted by
          block row, read as one stream, over 512-byte rows, over a
          `pin_memory` block and over a huge-page-advised block, timed
          once each, in turn, beside their bounds and same-bytes copies,
          with how the host backs each block (``host_pages``).
  feature_lookup  `bench_feature.py`'s sweep over 2 recorded node sets:
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
          whole table in pinned host memory); both share one mod-sharded
          ``[8, 7,653,216, 8]`` f32 copy of an ``[E, 8]`` edge table by
          global edge id (the CSR position; 1.96 GB).
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
  resume_mesh  `bench_dist_loader.py --resume`'s row on the mesh loader
          (`mesh_train`'s tiered GNS loader over 16 batches of 512 x 8,
          ``prefetch=0``): reference epochs 1 and 2 give per-batch
          digests; a loader consumes 8 batches, saves and is dropped; a
          fresh one restores and `resume_epoch` finishes the epoch.  The
          resumed loader then times 2 epochs, with a snapshot every
          ``GLT_SNAPSHOT_EVERY`` (8) batches / without (the first held
          to the reference's epoch 2; ABBA's 4 epochs cut to AB).
          Checks: every digest the reference's, x rows and labels their
          source, 24 K1-GNS and 16 K2 launches a resumed dispatch (the
          first one's calls in `kernel` lines against the plain versions).
          The row's fields (``restore_secs``, ``replayed_batches``,
          ``resumed_batches``, ``consumed_before_kill``, seeds/s with and
          without snapshots, ``snapshot_overhead_pct``,
          ``snap_over_nosnap_ratio``) and ``snapshot_bytes``.
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

  kernel  K1 at both hops (8 owners each) and K2 at the feature and
          the label exchange (8 owners each) of the fused mesh paths'
          recorded steps: the per-batch DP loop's first batch and each
          fused epoch's last warm step (the tree's hops in arrival
          order, unsorted), against their plain versions.
  fused_mesh  `bench.py:845-942` on the untiered store (after the K5
          line): the per-batch DP loop (`DistNeighborLoader([10, 5],
          batch_size=512)` -> `make_dp_supervised_step`, ``GraphSAGE(100,
          64, 47, 2)``, Adam(3e-3), 512 x 8 x 4 seeds, 3 epochs), then
          `FusedDistEpoch` (3 runs: warm, recording its ``hop.padding``
          events, 1 timed, then `evaluate`) and `FusedDistTreeEpoch`
          with ``TreeSAGE(100, 64, 47, 2)`` (the same), all eager, the
          epochs drawing from their default `TorchDraws`: seeds/s each,
          ``fused_vs_per_batch``, exchange counters.  Checks: 16 K1 and
          16 K2 launches a step on every path, no plain call, finite
          losses, every seed counted.
  fused_mesh_cross_check  a 4,000-node graph at P = 4 on the card and
          on the CPU with the same CPU-made draws: 3 steps of
          `FusedDistEpoch` and of `FusedDistTreeEpoch` at [10, 5], per-step
          losses within 1e-5 and exchange counters equal.
  resume_fused_mesh  `fused_mesh`'s `FusedDistEpoch` at an epoch
          boundary, under deterministic algorithms: a driver saving at
          each epoch's end is killed at epoch 2's dispatch; a fresh
          driver restores, returns epoch 1's saved stats without a launch
          and reruns epoch 2 bitwise the uninterrupted run's (losses,
          counts, parameters, Adam state), 16 K1 and 16 K2 launches a
          step, its first step's calls in `kernel` lines against the
          plain versions.
  mesh_edges  `DistNeighborLoader(with_edge=True)` at `mesh_loader`'s
          settings ([15, 10, 5], 512 seeds a partition, shuffled) on the
          untiered store (K1 in its edge-id mode 2, ``edge_ids[pos]`` of
          each owner's shard) and on the tiered store with ``gns=True``
          (K1-GNS in mode 2): a recorded and 3 timed batches each.
          Checks: 24 sampler and 24 K2 launches a batch (edge rows,
          features, labels), no plain call, every recorded call in mode 2,
          every valid edge id naming its sampled edge in the global CSR
          and its ``edge_attr`` the table's row (on the card), ``x`` and
          labels equal their source.  `kernel` lines: the recorded batch's
          24 sampler calls and 24 gathers against their plain versions,
          the samplers also timed without the arm (``no_eids_ms``).  With
          ``--gns-ab FILE`` a ``gns_ab`` line: K1-GNS launches without
          edges of this tree against FILE's kernel (another tree's
          ``sample_one_hop_gns.cu``, built by the same ``nvcc``) at the
          recorded hops, parent / change / change / parent.
  mesh_link  `examples/distributed/dist_unsup_sage.py`'s engine at
          products scale: `DistLinkNeighborLoader([5, 5], binary, 1,024
          seed edges a partition, shuffled)` -> `make_dp_unsupervised_step`
          with ``GraphSAGE(100, 64, 32, 2)``, Adam(1e-3): on the untiered
          store 2 warm + 50 timed steps and the loader alone over 10
          batches; on the tiered store with ``gns=True, with_edge=True``
          2 + 20 steps.  Step ms, batches/s, losses, the exhausted-negative
          share, exchange counters.  Checks: 16 sampler launches a batch
          (16 K2, 24 with edge rows), no plain call, losses finite and
          falling, the kept negatives of 3 batches non-edges by a host
          lookup, edge ids and rows on the card; `kernel` lines for the
          first batch's calls.
  mesh_unsup  `dist_unsup_sage.py` end to end at its own size (2,000
          nodes, P = 8, [5, 5], batch 32, 4 epochs, Flax's init): epoch
          seconds and losses, and the intra-vs-inter cluster AUC beside
          the JAX package's on the CPU (0.8092).  Checks: AUC within
          0.03 of it, the loss falling, 16 K1 and 8 K2 launches a batch
          of the training and embedding loaders, no plain call; `kernel`
          lines for the first training batch's calls.
  mesh_link_cross_check  a 600-node tiered graph at P = 4 with an edge
          table on the card and on the CPU with the same CPU-made draws
          (hops and negatives): 3 binary link batches with ``gns=True,
          with_edge=True`` byte-equal (node, x, edges, edge rows and
          weights, link labels), 2 DP steps' losses within 1e-5.
  mesh_seal  `examples/seal_link_pred.py --mesh` at P = 8 on `seal`'s
          graph (Cora's size, the 256 target links removed):
          `DistSubGraphLoader([8], 2 seeds a partition)`, 8 links'
          enclosing subgraphs a batch, the full-window hop answered by
          K3 (exact: the shards' max degree); DRNL labels, SEAL's
          classifier, 3 epochs.  Checks: 8 K1 and 8 K3 launches a batch,
          no K2 and no plain call, the first batch's K1 and K3 calls
          byte-equal, every induced edge and every subgraph's edge count
          against the host, the test accuracy within 0.03 of JAX's mesh
          example on the CPU (0.8544).
  mesh_engines_cross_check  the SEAL graph's subgraph batches with edge
          ids on the card and on the CPU, the same CPU-made draws: 3
          batches byte-equal.
  mesh_subgraph  the subgraph engine at `bench_dist_loader.py
          --subgraph-worker`'s shape on the untiered products store
          ([5, 5], 32 seeds a partition, features and labels), once in
          one exchange of the closure and once in chunks of 512 with
          edge ids: seeds/s, ``n_chunks``, K3 a call at the path's
          ``S x max_degree``.  Checks: 16 K1, 16 K2 and 8 K3 a chunk (16
          with edge ids) a batch, no plain call, the first batch's calls
          byte-equal, induced edges and counts against the host, rows,
          labels and edge ids against their sources, the same subgraphs
          in both runs.
  mesh_walk  `DistRandomWalker` over all products nodes (length 8,
          65,536 starts a partition a call): walk steps/s; 8 K1 a walk
          step, no plain call, the first two steps' K1 calls byte-equal,
          4,096 walks' steps host-checked edges, card = CPU on a
          4,096-start slice; then `examples/deepwalk.py --mesh` at its
          size (1-NN accuracy within 0.03 of JAX's 0.8520).
  mesh_fused_link  `FusedDistLinkEpoch` at `mesh_link`'s setup (16
          steps an epoch) against the DP loop at the same draws: epoch 1
          of both under deterministic algorithms (losses within 1e-5,
          the first 2 batches byte-equal), epoch 2 timed (s a step, the
          ratio); 16 K1 and 16 K2 a step; `evaluate`'s AUC.
  mesh_hetero_link  `examples/hetero/bipartite_sage_unsup.py`'s BiSAGE
          on the heterogeneous mesh at P = 8:
          `DistHeteroLinkNeighborLoader(with_edge=True)` over a store
          with caller-global edge ids and an ``[E, 8]`` table an edge
          type, 512 edges a step, 10 epochs; held-out AUC within 0.03 of
          the single-card `hetero_link` AUC of the same run.  Checks: 32
          K1 and 32 K2 a step, the first step's calls byte-equal, edge
          ids, rows and kept negatives checked, one key set in every
          batch, triplet negatives, card = CPU on two batches.
  mag_graph  `bench.py:538-560`'s ogbn-mag-scale graph built on the card
          (`benchmarks/common.py:123-148`'s recipe per edge type): 736,389
          papers and 1,134,649 authors, ``cites`` P->P at average degree
          7, ``writes`` A->P at 7, ``rev_writes`` P->A at 4, 30% hub
          targets, uniform ``[N, 128]`` f32 features per type, learnable
          paper labels ``argmax((x - 0.5) @ P)`` over 349 classes.
  kernel  K1 at the five (hop, edge type) calls of the hetero step
          (hop 0: ``cites`` and ``rev_writes`` over 512 paper rows; hop
          1: all three edge types over 5,120 rows; k = 10) and K2 at its
          two type gathers (author 56,320 and paper 108,032 ids x 128
          f32: 512-byte rows), recorded from the first step of
          `hetero_train`, against their plain versions (byte-equal).
  hetero_train  `bench.py:517-597`, the hetero session:
          `FusedHeteroEpoch` with ``RGCN(128 -> 128 -> 349, 2 layers,
          target paper)`` and Adam(1e-3, ``capturable=True``), batch 512,
          fanouts [10, 10], 64 steps over ``permutation(736,389)[:512 *
          64]`` (seed 0) in one chunk: a warm epoch (the capture) and 2
          timed epochs, `evaluate` on the next 20 batches; one step run
          eagerly and replayed from the same state and both timed over
          20 steps; the same under `torch.use_deterministic_algorithms`
          bitwise equal.  Checks: 5 K1 and 2 K2 launches a step, no plain
          call, finite losses falling, accuracy above 1/349, 2 captures.
  kernel  the same five K1 and two K2 calls of the first per-batch
          `hetero_loader` step (fanouts [4, 4]: 256 / 1,024 rows).
  hetero_loader  `examples/hetero/train_hgt_mag.py`'s per-batch path:
          `NeighborLoader(ds, [4, 4], ('paper', train_idx),
          batch_size=256)` -> `make_hetero_supervised_step` with
          ``HGT(128 -> 64 -> 349, 2 layers, 2 heads, target paper)`` and
          Adam(1e-3), 20 steps each split into sample / collate / model.
          Checks: 5 K1 and 2 K2 launches a step, no plain call, finite
          losses, ``x`` rows and labels equal their source.
  hetero_cross_check  a three-type graph of 5,100 nodes under five edge
          types on the card and on the CPU: 3 `FusedHeteroEpoch` RGCN
          steps with the counter draws, losses within 1e-5, each step's
          sample (tables, counts, COO, masks) equal.

  link_train  BASELINE config 2, `examples/unsup_sage_ppi.py` at PPI's
          published size: `clustered_graph` (56,944 nodes, degree 14:
          797,216 edges, 121 clusters, 50 features) on the card,
          `LinkNeighborLoader([10, 10], batch 512, binary negatives 1.0,
          shuffled)` -> `make_unsupervised_step` with ``GraphSAGE(50 ->
          64 -> 64, 2 layers)`` and Adam(3e-3), 200 steps split into
          sample / collate / model (`kernel` lines: K1 at both hops and
          K2 at the x gather of the first step), the example's
          cluster-pair AUC of the embeddings; then `FusedLinkEpoch` over
          200 x 512 edges with Adam(capturable): a warm epoch (its first
          step's K1 and K2 calls against their plain versions) and a
          timed one, one step eagerly and replayed (ms and idle shares),
          the same under deterministic algorithms bitwise, `evaluate`'s
          AUC on 20 held-out batches.  Checks: 2 K1 and 1 K2 launches a
          step, no plain call, ``x`` rows equal their source, the label
          indices map to the seeds, losses falling, both AUCs above 0.5,
          2 captures.
  link_loader  `LinkNeighborLoader` on the products graph at [15, 10,
          5]: 20 binary batches of 1,024 random edges, then 10 triplet
          batches at amount 2; batches/s, endpoints a batch.  Checks: 3
          K1 and 1 K2 launches a batch, no plain call; every batch's label
          indices map to its seeds through ``node``; every negative is
          the first of its 5 candidates (replayed from the sampler's
          draws) that a host lookup finds no edge, JAX's strict rule.
          `kernel` lines: K1 at the three hops and K2 at the x gather of
          the first binary batch.
  seal    BASELINE config 3, `examples/seal_link_pred.py`: its
          `synthetic()` graph at Cora's size (2,708 nodes, 7 clusters,
          degree 6) less its 256 target links, 256 positive and 256
          negative links through `SubGraphLoader([8], batch 2)`, DRNL
          labels on the host, ``Embedding(16, 32) -> DGCNN(32, 2 classes,
          3 layers, k 30)`` with Adam(1e-3), 3 epochs over 80% of the
          links, tested on the rest (a `kernel` line: K1 at the closure,
          2 rows at k 8); then 256 products edges and 256
          `RandomNegativeSampler` pairs through the same loader on the
          products graph: links/s, the subgraph op alone, its ``[node_cap
          x max_degree]`` window.  Checks: 1 K1 launch a link, no K2 or
          plain call, losses falling, test accuracy above 0.5, no random
          negative an edge, every induced edge an edge and every
          subgraph's edge count the host's.
  link_cross_check  a 4,000-node clustered graph on the card and on the
          CPU: 2 `LinkNeighborLoader` batches in each negative mode and 3
          `SubGraphLoader` batches with the same CPU-made draws
          byte-equal, 2 `FusedLinkEpoch` steps with the counter draws
          within 1e-5, one DGCNN forward within 1e-5.

  edge_data  the products graph's edge ids, a seeded permutation of
          ``[0, E)`` (int32, 245 MB, so K1 reads ``edge_ids[pos]``), and
          an ``[E, 8]`` f32 edge table (1.96 GB; 8 is ogbn-proteins'
          edge-feature width) in a `Dataset` with the features and
          labels.
  kernel  K1 with the edge-id arm (CSR positions and the permutation's
          ids) on every arm's rows at k 15/10/5 and on the forced sets
          (`forced_sampler_sets(with_eids=True)`), byte-equal.
  edges   BASELINE config 1 with edges: `NeighborLoader([15, 10, 5],
          batch 1,024, with_edge=True)` -> ``GraphSAGE(100, 256, 47,
          3)``, Adam(3e-3): 2 warm + 20 timed steps, the loader alone
          over 20 more batches; the same without edges over the same
          seeds and draws (step ms, batches/s).  `kernel` lines: K1 at
          the three hops with the arm (ids), with positions and without
          it, each timed; K2 at the x and the 936,960-slot edge-row
          gathers.  Checks: 3 K1 and 2 K2 launches a with-edge batch (1
          K2 without), no plain call, the losses falling, 5 batches'
          edge ids looked up on the host (the inverse-permuted CSR
          position lies in the seed's row and holds the neighbor) and
          ``edge_attr`` equal to the table's rows.
  edge_loaders  `SubGraphLoader([8], 2, with_edge=True)` over 8 products
          edges' endpoints and 3 binary `LinkNeighborLoader` batches of
          1,024 with edges: ids and rows checked on the host, launches
          counted; K1 at the link batch's hops as in `edges`.
  edges_cross_check  a 4,000-node graph with an edge table on the card
          and on the CPU: 2 with-edge batches byte-equal (node, x,
          edge_index, edge_mask, edge, edge_attr).
  hetero_link  `examples/hetero/bipartite_sage_unsup.py` at its size
          (2,000 users, 400 items, degree 10, d 32): `LinkNeighborLoader
          ([8, 8], (user, clicks, item), binary 1.0, batch 512)` ->
          ``BiSAGE`` (a Linear a type, two `HeteroConv(make_conv=
          SAGEConv)` of 64) with Adam(3e-3), 10 epochs (360 steps; 4 K1
          and 2 K2 a step), the held-out AUC from per-type
          `NeighborLoader` embeddings (above 0.5); then a hetero link
          loader on `mag_graph`'s ``(author, writes, paper)``: 20 binary
          batches of 1,024 at [10, 10] (batches/s; 6 K1 and 2 K2 a
          batch) and 3 with ``with_edge`` and a ``[E_writes, 4]`` table
          under the emitted ``(paper, rev_writes, author)``: K1 and K2 at
          every call against their plain versions, every edge row
          checked against its endpoints and CSR position.
  walk    `random_walk` from all 2,449,029 products nodes (length 8),
          without and with restarts (0.15), `walk_edges` (window 2,
          ~36.7 M pairs), `node2vec_walk` from 262,144 starts (p 0.25,
          q 4, window 64): walk steps/s; 4,096 walks' steps each an edge
          by a host lookup (or a restart); card = CPU on a 4,096-start
          slice (counter draws); DeepWalk at `examples/deepwalk.py`'s
          size on the card and the CPU (1-NN accuracy above 1/6).

Then the ``fleet`` group (the rest of serving, at the
serve phase's width: the products graph, ``[N, 100]`` f32, fanouts [15,
10, 5], buckets 1-16, ``TreeSAGE(100, 256, 47, 3)``):

  swap    `hot_swap` under live traffic on the untiered engine (4
          clients, 256 requests of 1-16 seeds; drain sheds resubmitted
          after their hint): no drop, version + 1, every answer the old
          or the new params' (nodes byte-equal, logits within 1e-5), all
          after the swap the new ones'; a wrong-width state refused
          before the door drains; a candidate failing the probe
          (``atol=0``, or a NaN bias where cross-bucket logits are
          bitwise) rolled back with the answers bitwise unchanged.
  fleet   `bench_serving.py --fleet 3`: three tiered replicas (split 0.5,
          each its own `Feature`) behind a `FleetRouter`, a 5 s closed
          lap, then 20 s of open-loop Zipf(1.1) traffic at 0.7x its rate
          with r0 stalled 0.12 s a dispatch and killed mid-run: 0 failed,
          r0 evicted, redrives exactly once, recovery >= 0.6x, 32
          answers = a survivor's `offline_reference`, 3 K1 / 1 K2
          launches a dispatch, K6 on every dispatch with misses, no
          plain call; p50/p99, qps around the kill, ``device_idle``
          (``nvidia-smi`` utilization); then K1, K2 and K6 at a fleet
          dispatch's shapes against their plain versions.  Traced as
          the bench drives it (1-in-10 sampled, slower than 100 ms kept),
          with ``/fleet`` of `make_scraper` strictly parsed over HTTP
          every 0.15 s: >= 1 scrape, 0 failures, >= 2 replicas
          federated, a slow-tail trace of >= 5 spans (its Chrome
          rendering loaded), ``fleet_headroom_qps`` present.
  autoscale  `bench_autoscale.py`'s phases A (one static replica) and B
          (`ElasticController`, 1-3 replicas, the first spawn failed by
          ``scale.spawn:fail:1``), in two arms.  The bench's own arm
          (its 20,000-node replica at fanouts [5, 3], its knobs, its
          160 -> 20 req/s 9 s diurnal plan and its 50 ms dispatch delay)
          holds every gate the bench exits 1 on: >= 1 scale-out and
          scale-in, a rolled-back spawn, burn < 1.0 outside the incident
          windows, elastic p99 <= 1.05 x static + 5 ms, 0 failed
          requests.  The products arm (tiered products replicas, one
          cycle of 0.15x -> 1.3x -> 0.15x one replica's closed-loop
          rate, p99 target 2x the trough p50, no injected delay) holds
          the decision, failure and launch checks and reports its p99s
          and burn, and which bench gates it misses.  Both: every
          spawned replica at ``compile_count() == 0``, the launches of
          every dispatch counted.
  aot     the kernel-build cache: a child process (``--aot-child DIR``)
          with empty build and ``GLT_AOT_CACHE_DIR`` directories runs 7
          ``nvcc`` and publishes 7 entries, a second restores all 7 and
          runs none, both K1 and K2 digests = this process's; a scrambled
          entry misses (``corrupt``) and is rebuilt.

``--fleet`` runs build, graph and the group alone and prints the
``kernels`` line of its path (K1, K2, K6 at the fleet shapes) and the
result line.

Last in the whole run, the ``failover`` group (the mesh's partition
failover and planned handoff at P = 8, on `mesh_data`'s two stores):

  failover  `bench.py`'s failover row at products scale: the untiered
          store, `DistNeighborLoader([15, 10, 5], batch_size=512)` over
          10 batches, a fault-free epoch, then ``GLT_SHARD_DIR`` (the
          durable copy written) and ``partition.owner:kill:5:
          partition=4``: completion 1.0, every batch digest-equal, one
          adoption, book version 1, ``recovery_secs`` > 0; 24 K1 and 16
          K2 launches a batch, the adopted dispatch's calls (the lane
          reading the shard put on the card) byte-equal to the plain
          versions; the copy's bytes, write and recovery seconds.
  handoff  `bench_autoscale.py` phase C at that scale: `handoff(ds, 3,
          5)` after 3 batches, 0 degraded batches, 1 bump, 1 transfer,
          its seconds by seam.
  gns_failover  the tiered GNS loader of `mesh_train` killed mid-epoch:
          digest-equal, one adoption, the bitmask rebuilt at the fence,
          24 K1-GNS and 16 K2 launches a batch.

``--failover`` runs build, graph and the group alone and prints the
``kernels`` line of its path (K1, K2, K1-GNS) and the result line.

Then the ``locality`` group (the mesh at P = 16 and 64 partitions of the
card, `bench.py` phase 3c rebuilt in-process on the products graph):

  envelope_p16 / envelope_p64  the range-partitioned featureless store;
          `DistNeighborLoader([5, 5], shuffle=True,
          exchange_slack='adaptive')` at batch 64 (P = 16) / 32 (P = 64)
          a partition under the default layout (compact at both), the
          first batch (its seconds; its kernel inputs recorded), 5 epochs
          of 2 batches: waste and drops by epoch and cumulative,
          ``slack_final``, seeds/s, the attribution; then one epoch a
          layout (dense, compact, hier) at slack 1.25, the hier epoch's
          first dispatch recorded.  2P K1 launches a batch, no plain
          call; every recorded call (the compact and hier receive
          shapes) byte-equal to the plain version; the card's peak bytes.
  locality_p16  `bench_dist_loader._locality_comparison` under
          ``GLT_EXCHANGE_EWMA=1``, featured: the range arm and the
          locality arm (the greedy, compiled for the host; a replica
          cache of 0.35 N rows a partition), 4 epochs and a re-timed 2
          over 64 x 16 x 8 seeds: cross-partition byte and id fractions,
          locally served ids, steady seeds/s, drops, the greedy's host
          seconds, the edge cut, retunes; 2P K1 and P (range) or 3P
          (locality: exchange, replica overlay, own rows) K2 launches a
          batch, each arm's first dispatch byte-equal to the plain
          versions.  Then the rename twin: identity relabel and one
          epoch digest-equal, else it raises.
  rebalance  P = 16, ``node % 16`` with the hubs (the lowest 1% of ids)
          on partition 3, dense at slack 1.5: `rebalance_plan` and
          `execute_rebalance` after 3 of 8 batches; range 3 moves first,
          every batch digest-equal to the undisturbed epoch, one bump a
          move, no adoption, a lower cross-partition byte fraction,
          seconds by seam.
  locality_cross_check  card = CPU on the 20,000-node envelope graph:
          each layout's first P = 16 batch, the greedy's ``node_pb``
          (compiled vs numpy) and both relabels; both greedies' host
          microseconds a node.

Then the ``host`` group (the host runtime: sampling processes, shm
channels and the socket RPC feeding the card):

  host_mp_train  the products graph as a `distributed.HostDataset`
          staged into POSIX shared memory; `DistNeighborLoader` with 4
          ``forkserver`` sampling workers (batch 1,024, [15, 10, 5], a
          shm channel of 8 slots of 384 MB) collating onto the card and
          the ``train`` phase's ``GraphSAGE(100, 256, 47, 3)`` step; a
          warm and a timed epoch of 32 batches over a fixed subset of the
          train split.  Exactly 32 unique ``#SEQ`` an epoch, the loss
          falling, 3 batches digest-equal to their ``(epoch, seq)``
          sampled again here, every collate span linked to a worker's
          ``producer.sample`` span; seeds/s, ms a batch for recv,
          collate, copy and step, the card's idle share, message bytes,
          the channel's occupancy, the shm bytes.
  chaos_row  `bench_dist_loader.py --chaos`: a spawned server, a remote
          loader, 3 fault-free epochs, then worker 0 killed and two
          fetches dropped / delayed: exact accounting, a retry, the
          server's ``producer.restart`` and ``fault.injected``.
  resume_row  `bench_dist_loader.py --resume` on the mp path: snapshot
          overhead, then kill -> restore -> finish (consumed + resumed =
          the epoch, replayed >= consumed).
  serve_rpc  a spawned server's `ServingFrontend` on the card behind
          `DistServer.serve_infer`; a `FleetRouter` over a
          `RemoteReplica` and a `LocalReplica`: answers =
          `offline_reference`, the ``serving.rpc`` span across the
          process edge, exactly-once under dropped connections, a swap
          of numpy params over the wire, the server's K1 / K2 launches.
  host_group  the regression gate over ``dist.chaos.*`` /
          ``dist.resume.*``, the machine's shm limits, the wall time.

``--host`` runs build, graph and the group alone and prints no
``kernels`` or result line.

Last, the ``telemetry`` group: `mesh_loader`'s configuration on the
tiered P = 8 store, 4 batches with the recorder off and 4 writing JSON
lines (digest-equal, the same launches, no plain call), `report`'s stage
table (a ``batch``, ``sample.exchange``, ``feature.lookup`` and
``stitch`` row a batch) and the Chrome export, a post-mortem bundle with
the time-series rings (loaded, rendered), and the regression gate over
this run's figures written by `sink` (first check 0, second 0, a copy
30% slower 1).  ``--telemetry`` runs build, graph and the group alone and
prints no ``kernels`` or result line.

``--locality`` runs build, graph and the group alone, with the P = 64
locality comparison too (left out of the whole run: its two replica
caches alone take about 44 GB and its greedy and builds about a minute),
and prints the ``kernels`` line of its path (K1, K2) and the result line.
``--profile`` adds `profile` (serving) and `profile_train` (kernel time
by name and the device idle share of 3 steps of the per-batch, GNS
and mesh training paths), the tiered-train idle shares and the idle
shares of the eager and the replayed tree step and `profile_train` of
3 replayed tree and subgraph steps, whose trace must show 3 K1 and 4 K2
kernels a tree step and 3 K1 and 1 K2 a subgraph step, and the same
for the hetero step (5 K1 and 2 K2; without ``--profile`` a replay's
launches are inferred from its capture).  ``--hetero`` runs build and
the hetero phases alone (`mag_graph` to `hetero_cross_check`) and
prints no ``kernels`` or result line.
``--edges`` runs build, graph and the edge and walk phases alone
(`edge_data` to `walk`) and prints no ``kernels`` or result line.
``--mesh-link`` runs build, graph, `mesh_data` and the mesh's edge and
link phases alone (`mesh_edges` to `mesh_link_cross_check`; with
``--gns-ab FILE`` also the ``gns_ab`` line) and prints the ``kernels``
line of that path (K1, K1-GNS, K2) and the result line.
``--mesh-engines`` runs build, graph, `mesh_data` (untiered) and the
mesh engines' phases alone (`mesh_seal` to `mesh_fused_link`, then
`hetero_link`'s single-card bipartite AUC as ``bipartite_reference``
and `mesh_hetero_link`) and prints the ``kernels`` line of that path
(K1, K2, K3) and the result line.  In the whole run `mesh_seal` to
`mesh_fused_link` follow `mesh_link_cross_check` and `mesh_hetero_link`
follows `walk`.  Every line carries ``at_s``, the seconds since start.
``--link`` runs build, graph and the link phases alone (`link_train`
to `link_cross_check`; with ``--profile`` also `profile_train` of 3
per-batch and 3 replayed link steps, whose traces must show 2 K1 and 1
K2 kernels a step, and of 3 SEAL training steps) and
prints no ``kernels`` or result line.
``--resume`` runs build, graph and the snapshot and resume phases alone
(`resume_fused`, `mesh_data`, `resume_fused_mesh`, `resume_mesh`) and
prints no ``kernels`` or result line.
``--fused`` runs build, graph and the fused epochs' phases alone
(`tree_train`, `fused_session`, `train_cross_check`, `mesh_data`,
`fused_mesh`, `fused_mesh_cross_check`) and
prints no ``kernels`` or result line.  ``--k6`` runs build, graph and the
tiered phases up to `tiered_train` alone (K6's forced sets, diagnosis
and path shapes) and prints no ``kernels`` or result line: a quick A/B
of two trees' K6 in one call.  A ``wall`` line gives the script's
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
TRAIN_EPOCHS = 1                    # timed epochs (depth cut, 2 -> 1)
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


#: the flight recorder's ring (``GLT_TELEMETRY_EVENTS``) for the run
RECORDER_EVENTS = 1 << 17

#: the script's start, for each line's ``at_s``
T_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
  """One JSON line; ``at_s`` is the seconds since the script started."""
  print(json.dumps({'phase': phase, **fields,
                    'at_s': round(time.perf_counter() - T_START, 3)}),
        flush=True)


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

  def __init__(self, torch, reps=None):
    self.torch = torch
    self.reps = reps
    self.flush = torch.empty(128 << 20, dtype=torch.uint8, device=DEVICE)

  def __call__(self, fn) -> float:
    torch = self.torch
    for _ in range(3):
      fn()
    times = []
    for _ in range(REPS if self.reps is None else self.reps):
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


def edge_bytes(mask_valid: int, rows: int, k: int, mode: str) -> int:
  """Bytes K1's edge-id arm adds: ``[rows, k]`` int32 ``eids`` written,
  and with ``edge_ids`` one 4-byte id read a valid slot."""
  if mode == 'none':
    return 0
  return rows * k * 4 + (4 * mask_valid if mode == 'ids' else 0)


def check_sampler(torch, ops, timer, indptr, indices, seeds, k, u, g,
                  edge_ids=None, with_edge_ids=False, time_it=True):
  """K1 against its plain version on one call's inputs (byte-equal
  ``nbrs``, ``mask`` and, with ``with_edge_ids``, ``eids``), its bound
  and both times."""
  kw = {'edge_ids': edge_ids, 'with_edge_ids': with_edge_ids}
  before = ops.sample_one_hop_fused.launches
  got = ops.sample_one_hop_fused(indptr, indices, seeds, k, u, g, **kw)
  ref = ops.sample_one_hop(indptr, indices, seeds, k, u, g, **kw)
  sync(torch)
  if not (torch.equal(got.nbrs, ref.nbrs) and torch.equal(got.mask,
                                                          ref.mask)):
    bad = int((got.nbrs != ref.nbrs).sum())
    raise AssertionError(f'sampler kernel != plain version (k={k}, '
                         f'{bad} slots differ)')
  mode = ('none' if not with_edge_ids
          else 'positions' if edge_ids is None else 'ids')
  if with_edge_ids and not (got.eids.dtype == ref.eids.dtype == torch.int32
                            and torch.equal(got.eids, ref.eids)):
    bad = int((got.eids != ref.eids).sum())
    raise AssertionError(f'sampler kernel != plain version (k={k}, eids '
                         f'{mode}, {bad} slots differ)')
  err = int((got.nbrs.long() - ref.nbrs.long()).abs().max())
  if with_edge_ids:
    err = max(err, int((got.eids.long() - ref.eids.long()).abs().max()))
  deg = ops.lookup_degree(indptr, seeds).cpu().numpy()
  deg = np.where(seeds.cpu().numpy() >= 0, deg, -1)
  w = g.shape[1]
  nbytes = sample_bytes(deg, k, w) + edge_bytes(
      int(got.mask.sum()), int(seeds.numel()), k, mode)
  rec = {
      'rows': int(seeds.numel()), 'k': k, 'w': w, 'eids': mode,
      'arms': {'empty_or_invalid': int((deg <= 0).sum()),
               'take_all': int(((deg > 0) & (deg <= k)).sum()),
               'window': int(((deg > k) & (deg <= w)).sum()),
               'hub': int((deg > w).sum())},
      'byte_equal': True, 'max_abs_err': err,
      'bytes': nbytes, 'bound_us': nbytes / HBM_BYTES_PER_S * 1e6}
  if with_edge_ids:
    rec['no_eids_bound_ms'] = sample_bytes(deg, k, w) / HBM_BYTES_PER_S * 1e3
  if time_it:
    rec['kernel_ms'] = timer(lambda: ops.sample_one_hop_fused(
        indptr, indices, seeds, k, u, g, **kw))
    rec['plain_ms'] = timer(lambda: ops.sample_one_hop(
        indptr, indices, seeds, k, u, g, **kw))
  rec['launches'] = ops.sample_one_hop_fused.launches - before
  return got, rec


def check_gather(torch, ops, timer, table, ids, time_it=True):
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
         'bytes': nbytes, 'bound_us': nbytes / HBM_BYTES_PER_S * 1e6}
  if time_it:
    rec.update(
        kernel_ms=timer(lambda: ops.gather_rows(table, ids)),
        plain_ms=timer(lambda: ops.gather_rows_plain(table, ids)),
        library_ms=timer(lambda: torch.index_select(table, 0, safe)))
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


def forced_sampler_sets(torch, ops, seed=13, with_eids=False):
  """K1 against its plain version (byte-equal) at every k of
  `SAMPLER_FANOUTS`, at the default window and at 256, on 150,001 and
  20,001 rows (lane groups of clamp(next_pow2(k), 4, 32) lanes, two
  passes and one pass a warp) and 1,001 (a warp a row): rows of every
  arm (deg 0, deg <= k, k < deg <= w, deg > w), invalid and
  out-of-range seeds, eight Gumbels tied at the top across lane-group
  boundaries (columns 3, 4, 7, 8, 15, 16, 31, 32), ties every 7th
  column, and u just below 1.  With ``with_eids`` each set runs with
  the edge-id arm instead, in both modes (CSR positions, and a
  permutation's ids), ``eids`` byte-equal too."""
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
    modes = ((None, False),)
    if with_eids:
      perm = torch.randperm(indices.numel(), generator=gen, device=DEVICE)
      modes = ((None, True), (perm.to(torch.int32), True))
    for eid, on in modes:
      got = ops.sample_one_hop_fused(indptr, indices, seeds, k, u, g,
                                     edge_ids=eid, with_edge_ids=on)
      ref = ops.sample_one_hop(indptr, indices, seeds, k, u, g, eid, on)
      if not (torch.equal(got.nbrs, ref.nbrs)
              and torch.equal(got.mask, ref.mask)
              and (not on or torch.equal(got.eids, ref.eids))):
        bad = int((got.nbrs != ref.nbrs).sum())
        raise AssertionError(f'sampler kernel != plain version (forced '
                             f'k={k}, w={w}, {rows} rows, eids {on}, '
                             f'{bad} slots)')
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


#: `bench_serving.py`'s default latency SLO (``GLT_SERVING_SLO_P99_MS``):
#: the burn-rate gauges the mid-run scrape needs read a target, and the
#: fleet drive's tracer keeps every request slower than it
SLO_P99_MS = 100.0
#: `measure_tracing_overhead`: single-seed requests a lap, timed laps a
#: mode after one warm-up lap, and the bench's gate on the ratio (the
#: regression gate's pinned line).  The bench's laps submit to the
#: frontend, where no trace is minted, so the ratio is the host's
#: lap-to-lap spread: 0.984 and 1.052 in two runs on the H100's host.
#: A miss is reported (``bench_gates_missed``), not raised, as the
#: autoscale phase reports its burn gate
TRACE_REQUESTS = 150
TRACE_REPS = 2
TRACE_RATIO_MAX = 1.05
#: `federation_watch`'s period between strict ``/fleet`` scrapes
FED_WATCH_S = 0.15
#: this run's serving and mesh figures, for the telemetry group's
#: artifact (JAX's dotted keys) and its regression gate
TELEMETRY = {}


class slo_target:
  """``GLT_SERVING_SLO_P99_MS`` set to `SLO_P99_MS` while a frontend is
  built (its `SloTracker` reads the target then) and restored after, so
  later phases see the environment they had."""

  def __enter__(self):
    self.old = os.environ.get('GLT_SERVING_SLO_P99_MS')
    os.environ['GLT_SERVING_SLO_P99_MS'] = str(SLO_P99_MS)

  def __exit__(self, *exc):
    if self.old is None:
      del os.environ['GLT_SERVING_SLO_P99_MS']
    else:
      os.environ['GLT_SERVING_SLO_P99_MS'] = self.old


def http_get(url, timeout=10.0):
  """``(status, body text, ms)`` of one GET."""
  import urllib.request
  t = time.perf_counter()
  with urllib.request.urlopen(url, timeout=timeout) as r:
    body = r.read().decode('utf-8')
    status = r.status
  return status, body, (time.perf_counter() - t) * 1e3


class MidRunScrape:
  """`bench_serving.scrape_ops` on the port (gate 1): once half of a
  drive's ``total`` requests have been answered (`tick` after each),
  pull ``/metrics`` and ``/varz`` off the ops server, parse the text
  strictly and check the families the bench promises: the queue depth,
  the shed rate, the request-latency histogram, the SLO burn rate and,
  on the tiered engine, the cache hit rate."""

  def __init__(self, srv, total: int, require_cache: bool = False):
    self.srv, self.half, self.require_cache = srv, total // 2, require_cache
    self.out = {'scrape_ok': False,
                'error': 'the scrape thread did not complete'}
    self._n = 0
    self._lock = threading.Lock()
    self._at_half = threading.Event()
    self._thread = threading.Thread(target=self._run, daemon=True)
    self._thread.start()

  def tick(self) -> None:
    with self._lock:
      self._n += 1
      if self._n >= self.half:
        self._at_half.set()

  def _run(self) -> None:
    from graphlearn_tpu_torch.telemetry import parse_prometheus_text
    if not self._at_half.wait(600.0):
      self.out['error'] = 'half the drive never completed'
      return
    try:
      with self._lock:
        at = self._n
      _, text, metrics_ms = http_get(f'{self.srv.url}/metrics')
      samples = parse_prometheus_text(text)
      _, body, varz_ms = http_get(f'{self.srv.url}/varz')
      varz = json.loads(body)
      present = {
          'queue_depth': 'glt_serving_queue_depth' in samples,
          'shed_rate': 'glt_serving_shed_rate' in samples,
          'latency_hist': any(k.startswith(
              'glt_serving_request_latency_bucket') for k in samples),
          'slo_burn_rate': any(k.startswith('glt_serving_slo_burn_rate')
                               for k in samples)}
      if self.require_cache:
        present['cache_hit_rate'] = 'glt_cache_hit_rate' in samples
      self.out = {'scrape_ok': True, 'at_request': at,
                  'samples': len(samples),
                  'varz_keys': len(varz.get('metrics', {})),
                  'present': present, 'all_present': all(present.values()),
                  'metrics_ms': metrics_ms, 'varz_ms': varz_ms,
                  'metrics_bytes': len(text)}
    except Exception as e:          # noqa: BLE001 — reported, then gated
      self.out = {'scrape_ok': False, 'error': f'{type(e).__name__}: {e}'}

  def result(self, what: str) -> dict:
    """The scrape's block; raises unless it parsed with every family."""
    self._thread.join(60.0)
    if not (self.out.get('scrape_ok') and self.out.get('all_present')):
      raise AssertionError(f'{what}: mid-run ops scrape failed: {self.out}')
    TELEMETRY.setdefault('scrape_ms', []).extend(
        [self.out['metrics_ms'], self.out['varz_ms']])
    return self.out


def measure_tracing_overhead(submit, what: str) -> dict:
  """`bench_serving.measure_tracing_overhead` (gate 5): the same
  closed-loop schedule of `TRACE_REQUESTS` single-seed requests through
  ``submit`` with tracing off (``sample=0``) and on (``sample=1``), a
  warm-up lap of each, then the best of `TRACE_REPS` laps a mode; the
  traced over untraced wall-time ratio."""
  from graphlearn_tpu_torch.telemetry import tracer
  rng = np.random.default_rng(7)
  seeds = [np.asarray([s], np.int64)
           for s in rng.integers(0, NUM_NODES, TRACE_REQUESTS)]
  laps = {'untraced': [], 'traced': []}
  try:
    for rep in range(TRACE_REPS + 1):
      for mode, sample in (('untraced', 0), ('traced', 1)):
        tracer.configure(sample=sample, slow_ms=1e9, buffer=None)
        t0 = time.perf_counter()
        for s in seeds:
          submit(s).result(30.0)
        took = time.perf_counter() - t0
        if rep:
          laps[mode].append(took)
    minted = tracer.stats()['minted']
  finally:
    tracer.configure()
    tracer.clear()
  best = {m: min(v) for m, v in laps.items()}
  return {'what': what, 'requests': TRACE_REQUESTS, 'reps': TRACE_REPS,
          'lap_secs': laps, 'ratio': best['traced'] / best['untraced'],
          'traces_minted': minted}


def federation_watch(scraper, srv, stop, out: dict) -> None:
  """`bench_serving.federation_watch` (gate 2): while the drive runs,
  sweep the replicas and strictly parse ``/fleet`` over HTTP every
  `FED_WATCH_S`, counting scrapes, parse failures and the replicas each
  exposition federates."""
  import re
  from graphlearn_tpu_torch.telemetry import parse_prometheus_text
  while not stop.is_set():
    try:
      t = time.perf_counter()
      scraper.scrape()
      sweep_ms = (time.perf_counter() - t) * 1e3
      _, text, ms = http_get(f'{srv.url}/fleet', timeout=5.0)
      parse_prometheus_text(text)
      seen = len(set(re.findall(r'replica="([^"]+)"', text)))
      out['scrapes'] = out.get('scrapes', 0) + 1
      out.setdefault('fleet_ms', []).append(ms)
      out.setdefault('sweep_ms', []).append(sweep_ms)
      out['max_replicas_federated'] = max(
          out.get('max_replicas_federated', 0), seen)
    except Exception as e:          # noqa: BLE001 — every failure counts
      out['parse_failures'] = out.get('parse_failures', 0) + 1
      out.setdefault('errors', []).append(f'{type(e).__name__}: {e}')
    stop.wait(FED_WATCH_S)


def ms_summary(vals) -> dict:
  vals = sorted(vals)
  return {'n': len(vals), 'median': float(np.median(vals)) if vals else None,
          'max': vals[-1] if vals else None}


def serve(torch, ds):
  from graphlearn_tpu_torch.models import TreeSAGE
  from graphlearn_tpu_torch.ops import (gather_rows, gather_rows_plain,
                                        sample_one_hop,
                                        sample_one_hop_fused)
  from graphlearn_tpu_torch.serving import (FleetRouter, LocalReplica,
                                            ServingEngine, ServingFrontend)
  from graphlearn_tpu_torch.telemetry import OpsServer
  eng = ServingEngine(ds, FANOUTS, model=TreeSAGE(FEAT_DIM, 256, 47, 3),
                      seed=0, buckets=BUCKETS, device=DEVICE)
  eng.init_params(torch.Generator().manual_seed(0))
  warm = eng.warmup()
  with slo_target():
    fe = ServingFrontend(eng, max_wait_ms=2.0, default_deadline_ms=10_000.0)
  rng = np.random.default_rng(0)
  reqs = [rng.integers(0, NUM_NODES, int(rng.integers(1, 17)))
          for _ in range(N_REQUESTS)]
  results, lat, errors = [None] * len(reqs), [0.0] * len(reqs), []
  srv = OpsServer(port=0)
  watch = MidRunScrape(srv, len(reqs))

  def client(lo):
    for i in range(lo, len(reqs), N_CLIENTS):
      t0 = time.perf_counter()
      try:
        results[i] = fe.submit(reqs[i]).result(60.0)
      except Exception as e:       # noqa: BLE001 — counted, then fatal
        errors.append(f'request {i}: {type(e).__name__}: {e}')
      lat[i] = (time.perf_counter() - t0) * 1e3
      watch.tick()

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
  stats = fe.stats()
  scrape = watch.result('serve')
  # the tracing cost on the warm, idle engine after the drive: the
  # bench's laps (frontend submits) and the same laps routed, where
  # each traced request also mints, records its spans and is retained
  tracing = measure_tracing_overhead(fe.submit, 'frontend')
  router = FleetRouter([LocalReplica('r0', fe)], auto_start=False)
  routed = measure_tracing_overhead(router.submit, 'router')
  router.close()
  fe.shutdown()
  srv.close()
  missed = (['tracing_overhead_ratio']
            if tracing['ratio'] > TRACE_RATIO_MAX else [])
  TELEMETRY['gates_missed'] = missed
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
       offline_checked=16, offline_logits_max_abs_diff=worst,
       ops_scrape=scrape, tracing_overhead=tracing,
       routed_tracing_overhead=routed, bench_gates_missed=missed,
       reported_not_held=missed)
  TELEMETRY['serving'] = {
      'p99_ms': float(np.percentile(lat, 99)),
      'qps': len(reqs) / wall,
      'tracing_overhead_ratio': tracing['ratio']}
  TELEMETRY['routed_tracing_ratio'] = routed['ratio']
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
  for ``sort_locality``; the first ``hops`` calls, one a hop by default)
  and the first ``gathers`` row gathers'."""

  def __init__(self, torch, smod, gathers, hops=len(FANOUTS)):
    # ``edges``: each recorded hop's (edge_ids, with_edge_ids)
    import graphlearn_tpu_torch.data.feature as fmod
    self.torch, self.fmod, self.smod = torch, fmod, smod
    self.n_gathers, self.n_hops = gathers, hops
    self.real_sample = smod.sample_one_hop_fused
    self.real_gather = fmod.gather_rows
    self.hops, self.gathers, self.edges = [], [], []

  def sample(self, indptr, indices, seeds, k, u, gumbel,
             sort_locality=False, edge_ids=None, with_edge_ids=False):
    torch = self.torch
    if len(self.hops) < self.n_hops:
      self.edges.append((edge_ids, with_edge_ids))
      rows = seeds
      if sort_locality:
        rows = seeds[torch.argsort(torch.where(
            seeds >= 0, seeds, torch.iinfo(seeds.dtype).max),
            stable=True)].contiguous()
      # copies: a captured step's seeds are a static buffer that every
      # later replay overwrites
      self.hops.append((indptr, indices, rows.clone(), k, u.clone(),
                        gumbel.clone()))
    return self.real_sample(indptr, indices, seeds, k, u, gumbel,
                            sort_locality=sort_locality, edge_ids=edge_ids,
                            with_edge_ids=with_edge_ids)

  def gather(self, table, ids, id2index=None):
    if len(self.gathers) < self.n_gathers:
      self.gathers.append((table, ids.clone()))
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


def tree_train(torch, ops, timer, ds, feats, train_idx, test_idx):
  """Path B, the fused tree epoch of `bench.py:252-312`:
  `FusedTreeEpoch` with ``TreeSAGE(100, 256, 47, 3)``, Adam(3e-3,
  capturable), chunks of 100 steps; one warm epoch (its first step runs
  eagerly before the capture, and its kernel inputs are recorded: K1 at
  the three unsorted hops and K2 at the four level gathers held against
  their plain versions on them), `TREE_EPOCHS` timed, then `evaluate`
  on the test split.  Every later step is a replay of the captured
  graph, whose launches the driver counts a replay.  Returns the
  launches, the kernel records and the epoch object (`fused_session`
  goes on with it)."""
  import graphlearn_tpu_torch.loader.fused_tree as ftmod
  from graphlearn_tpu_torch.loader import FusedTreeEpoch
  from graphlearn_tpu_torch.models import TreeSAGE
  model = TreeSAGE(FEAT_DIM, 256, GNS_CLASSES, num_layers=3).to(DEVICE)
  model.reset_parameters(torch.Generator().manual_seed(0))
  opt = torch.optim.Adam(model.parameters(), lr=TRAIN_LR, eps=1e-8,
                         capturable=True)
  fused = FusedTreeEpoch(ds, FANOUTS, train_idx, model, opt,
                         batch_size=TRAIN_BATCH, shuffle=True, seed=0,
                         max_steps_per_program=100, device=DEVICE)
  steps = len(fused)
  reset_counts(ops)
  t0 = time.perf_counter()
  with TrainRecorder(torch, ftmod, len(FANOUTS) + 1) as rec:
    warm = fused.run().losses.cpu().numpy()
  warm_secs = time.perf_counter() - t0
  check_replay_counts(ops, 'tree warm epoch', steps,
                      len(FANOUTS), len(FANOUTS) + 1)
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
  launches = check_replay_counts(ops, 'tree epochs', steps * TREE_EPOCHS,
                                 len(FANOUTS), len(FANOUTS) + 1)
  means = [float(warm.mean())] + [float(x.mean()) for x in epoch_losses]
  if not (np.isfinite(np.concatenate([warm] + epoch_losses)).all()
          and means[-1] < means[0]):
    raise AssertionError(f'tree losses do not fall: {means}')
  acc = fused.evaluate(test_idx)
  if not acc > 1 / GNS_CLASSES:
    raise AssertionError(f'tree eval accuracy {acc}')
  if fused.compile_count() != 2:
    raise AssertionError(f'{fused.compile_count()} captures, not 2')
  secs = float(np.median(runs))
  flops = tree_step_flops()
  emit('tree_train', batch=TRAIN_BATCH, fanouts=list(FANOUTS),
       model=f'TreeSAGE({FEAT_DIM}->256->{GNS_CLASSES}, 3 layers)',
       optimizer=f'Adam({TRAIN_LR}, capturable)', max_steps_per_program=100,
       steps_per_epoch=steps, warm_secs=warm_secs, epochs=TREE_EPOCHS,
       epoch_secs_runs=runs, epoch_secs=secs, step_ms=secs / steps * 1e3,
       train_seeds_per_s=len(train_idx) / secs, tree_step_flops=flops,
       tflops=flops * steps / secs / 1e12, epoch_mean_losses=means,
       eval_accuracy=acc, captures=fused.compile_count(),
       launches=launches, plain_calls=0)
  return launches, hop_recs, level_recs, fused, {
      'epoch_secs': secs, 'runs': runs, 'warm_secs': warm_secs,
      'eval_accuracy': acc, 'means': means}


def check_replay_counts(ops, what, steps, k1, k2, k1_name='sample_one_hop'):
  """The launches since `reset_counts` are ``k1`` sampler and ``k2``
  row-gather launches a step over ``steps`` steps (eager steps count at
  the call, replays through the driver's per-graph count), with no
  plain call; returns the launches."""
  launches, plain = read_counts(ops)
  want = {k1_name: k1 * steps, 'gather_rows': k2 * steps}
  got = {k: launches[k] for k in want}
  others = sum(v for k, v in launches.items() if k not in want)
  if got != want or others or plain:
    raise AssertionError(f'{what}: launches {launches}, plain calls '
                         f'{plain}, want {want} over {steps} steps')
  return launches


def train_tensors(fused):
  """Every tensor a train step writes in place: the parameters and the
  optimizer's state."""
  out = [p.data for p in fused.model.parameters()]
  for st in fused.optimizer.state.values():
    out += [v for v in st.values() if hasattr(v, 'data_ptr')]
  return out


def eager_vs_replay(torch, fused):
  """One train step from the same state, seeds and coordinates, eagerly
  and as a replay of the captured graph: ``(bitwise, max abs diff over
  the loss, counts, parameters and optimizer state)``.  The state is
  put back between the two; the replayed step's state stays."""
  graph = fused._replays['train']
  seeds, coords = graph.seeds.clone(), graph.coords.clone()
  tensors = train_tensors(fused)
  start = [t.clone() for t in tensors]
  eager = [t.clone() for t in fused._train_step(seeds,
                                                tuple(coords.unbind(0)))]
  eager += [t.clone() for t in tensors]
  for t, s in zip(tensors, start):
    t.copy_(s)
  replay = [t.clone() for t in graph.replay(seeds, coords)] + tensors
  sync(torch)
  same = all(torch.equal(a, b) for a, b in zip(eager, replay))
  diff = max(float((a.double() - b.double()).abs().max())
             for a, b in zip(eager, replay) if a.numel())
  return same, diff


def step_ms(torch, run, n) -> float:
  """Milliseconds a step over ``n`` steps of ``run()`` back to back, by
  two CUDA events around them: the host's enqueue shows in the time."""
  sync(torch)
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(n):
    run()
  end.record()
  end.synchronize()
  return start.elapsed_time(end) / n


#: `fused_session`'s subgraph epoch: `bench.py`'s 96-step subset
SUB_STEPS = 96
#: steps timed eagerly and replayed in `fused_session`
STEP_COMPARE = 20
#: tolerance of a replayed subgraph step against the eager one (its
#: aggregation's `index_add_` adds in the order its atomics land)
SUBGRAPH_REPLAY_TOL = 1e-4
#: replayed steps traced under ``--profile``
PROFILE_STEPS = 3


def fused_session(torch, ops, timer, ds, feats, train_idx, test_idx, tree,
                  prof=False):
  """`bench.py:252-362`, the fused session, on the card.  The f32 tree
  epoch is `tree_train`'s (its epoch object ``tree``, captured): here
  one of its steps runs eagerly and as a replay from the same state
  (bitwise equal required) and both are timed.  Then the bf16 tree
  epoch (``TreeSAGE(dtype=bfloat16)``: one warm and 2 timed epochs) and
  `FusedEpoch` with ``GraphSAGE(100, 256, 47, 3)`` and ``remat=True``
  over ``train_idx[:1024 * 96]`` in one 96-step chunk (a capture run
  and a timed run; its first step's kernel inputs recorded and K1 at
  the three sorted hops and K2 at the x gather held against their plain
  versions), each with `evaluate`, the replay launch accounting and one
  capture each for training and evaluation."""
  import graphlearn_tpu_torch.sampler.neighbor_sampler as nsmod
  from graphlearn_tpu_torch.loader import FusedEpoch, FusedTreeEpoch
  from graphlearn_tpu_torch.models import GraphSAGE, TreeSAGE
  out = {'platform': 'gpu', 'fused_layout': 'tree',
         'tree_step_flops': tree_step_flops()}
  fused, f32 = tree
  steps = len(fused)
  out.update(epoch_secs_fused=f32['epoch_secs'],
             fused_epoch_runs=f32['runs'],
             fused_warm_secs=f32['warm_secs'],
             tree_eval_accuracy=f32['eval_accuracy'],
             train_step_tflops=tree_step_flops() / (f32['epoch_secs']
                                                    / steps) / 1e12)

  # -- the captured tree step against the eager step ------------------------
  same, diff = eager_vs_replay(torch, fused)
  if not same:
    raise AssertionError(f'a replayed tree step differs from the eager '
                         f'step (max abs diff {diff})')
  graph = fused._replays['train']
  seeds, coords = graph.seeds.clone(), graph.coords.clone()
  ctuple = tuple(coords.unbind(0))
  out['tree_step'] = {
      'replay_bitwise_equal_to_eager': True,
      'eager_ms': step_ms(torch, lambda: fused._train_step(seeds, ctuple),
                          STEP_COMPARE),
      'replayed_ms': step_ms(torch, lambda: graph.replay(seeds, coords),
                             STEP_COMPARE),
      'steps_timed': STEP_COMPARE}
  if prof:
    out['tree_step']['idle'] = {
        'eager': device_idle(torch, lambda: fused._train_step(
            seeds, ctuple)[0], 5),
        'replayed': device_idle(torch, lambda: graph.replay(
            seeds, coords)[0], 5)}
    check_traced(profile_train(torch, lambda: graph.replay(seeds, coords)[0],
                               'tree replayed', n=PROFILE_STEPS),
                 'tree replayed', PROFILE_STEPS, len(FANOUTS),
                 len(FANOUTS) + 1)
    out['tree_step']['traced_launches_checked'] = True

  # -- the bf16 tree epoch ---------------------------------------------------
  model16 = TreeSAGE(FEAT_DIM, 256, GNS_CLASSES, num_layers=3,
                     dtype=torch.bfloat16).to(DEVICE)
  model16.reset_parameters(torch.Generator().manual_seed(0))
  fused16 = FusedTreeEpoch(
      ds, FANOUTS, train_idx, model16,
      torch.optim.Adam(model16.parameters(), lr=TRAIN_LR, eps=1e-8,
                       capturable=True),
      batch_size=TRAIN_BATCH, shuffle=True, seed=0,
      max_steps_per_program=100, device=DEVICE)
  t0 = time.perf_counter()
  warm16 = fused16.run().losses.cpu().numpy()
  out['fused_bf16_warm_secs'] = time.perf_counter() - t0
  reset_counts(ops)
  runs16, losses16 = [], [warm16]
  for _ in range(2):
    sync(torch)
    t = time.perf_counter()
    stats = fused16.run()
    sync(torch)
    runs16.append(time.perf_counter() - t)
    losses16.append(stats.losses.cpu().numpy())
  launches16 = check_replay_counts(ops, 'bf16 tree epochs', 2 * steps,
                                   len(FANOUTS), len(FANOUTS) + 1)
  means16 = [float(x.mean()) for x in losses16]
  if not (np.isfinite(np.concatenate(losses16)).all()
          and means16[-1] < means16[0]):
    raise AssertionError(f'bf16 tree losses do not fall: {means16}')
  acc16 = fused16.evaluate(test_idx)
  if not (acc16 > 1 / GNS_CLASSES and fused16.compile_count() == 2):
    raise AssertionError(f'bf16 tree: accuracy {acc16}, '
                         f'{fused16.compile_count()} captures')
  out.update(fused_epoch_runs_bf16=runs16,
             fused_epoch_secs_bf16=float(np.median(runs16)),
             bf16_epoch_mean_losses=means16, bf16_eval_accuracy=acc16,
             bf16_launches=launches16)
  del fused16, model16

  # -- the subgraph epoch with remat ------------------------------------------
  sub_idx = train_idx[:TRAIN_BATCH * SUB_STEPS]
  model = GraphSAGE(FEAT_DIM, 256, GNS_CLASSES, num_layers=3).to(DEVICE)
  model.reset_parameters(torch.Generator().manual_seed(1))
  sub = FusedEpoch(ds, FANOUTS, sub_idx, model,
                   torch.optim.Adam(model.parameters(), lr=TRAIN_LR,
                                    eps=1e-8, capturable=True),
                   batch_size=TRAIN_BATCH, shuffle=True, seed=0, remat=True,
                   max_steps_per_program=SUB_STEPS, device=DEVICE)
  reset_counts(ops)
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  with TrainRecorder(torch, nsmod, 1) as rec:
    first = sub.run().losses.cpu().numpy()
  out['fused_subgraph_compile_secs'] = time.perf_counter() - t0
  out['fused_subgraph_peak_gb'] = torch.cuda.max_memory_allocated() / 1e9
  check_replay_counts(ops, 'subgraph capture run', SUB_STEPS,
                      len(FANOUTS), 1)
  sub_hops = []
  for t in range(len(FANOUTS)):
    _, r = check_sampler(torch, ops, timer, *rec.hops[t])
    emit('kernel', kernel='sample_one_hop', shape=f'fused subgraph hop {t}',
         **r)
    sub_hops.append(r)
  table, ids = rec.gathers[0]
  if not torch.equal(table, feats):
    raise AssertionError('the subgraph step gathered from another table')
  sub_gather = check_gather(torch, ops, timer, table, ids)
  emit('kernel', kernel='gather_rows', shape='fused subgraph x', **sub_gather)
  del rec
  reset_counts(ops)
  sync(torch)
  t0 = time.perf_counter()
  second = sub.run().losses.cpu().numpy()
  sub_dt = time.perf_counter() - t0
  sub_launches = check_replay_counts(ops, 'subgraph run', SUB_STEPS,
                                     len(FANOUTS), 1)
  if not (np.isfinite(np.concatenate([first, second])).all()
          and second.mean() < first.mean()):
    raise AssertionError(f'subgraph losses do not fall: {first.mean()} '
                         f'-> {second.mean()}')
  sub_acc = sub.evaluate(test_idx)
  if not (sub_acc > 1 / GNS_CLASSES and sub.compile_count() == 2):
    raise AssertionError(f'subgraph: accuracy {sub_acc}, '
                         f'{sub.compile_count()} captures')
  same, diff = eager_vs_replay(torch, sub)
  if not diff <= SUBGRAPH_REPLAY_TOL:
    raise AssertionError(f'a replayed subgraph step differs from the '
                         f'eager step by {diff}')
  sgraph = sub._replays['train']
  sseeds, scoords = sgraph.seeds.clone(), sgraph.coords.clone()
  sct = tuple(scoords.unbind(0))
  out['subgraph_step'] = {
      'replay_max_abs_diff_to_eager': diff, 'bitwise_equal': same,
      'tolerance': SUBGRAPH_REPLAY_TOL,
      'eager_ms': step_ms(torch, lambda: sub._train_step(sseeds, sct), 5),
      'replayed_ms': step_ms(torch, lambda: sgraph.replay(sseeds, scoords),
                             5),
      'steps_timed': 5}
  if prof:
    check_traced(profile_train(torch,
                               lambda: sgraph.replay(sseeds, scoords)[0],
                               'subgraph replayed', n=PROFILE_STEPS),
                 'subgraph replayed', PROFILE_STEPS, len(FANOUTS), 1)
    out['subgraph_step']['traced_launches_checked'] = True
  out.update(fused_subgraph_steps=SUB_STEPS,
             fused_subgraph_ms_per_step=1e3 * sub_dt / SUB_STEPS,
             fused_subgraph_epoch_secs_est=sub_dt / SUB_STEPS * steps,
             subgraph_mean_losses=[float(first.mean()),
                                   float(second.mean())],
             subgraph_eval_accuracy=sub_acc, subgraph_launches=sub_launches,
             captures={'tree_f32': fused.compile_count(),
                       'tree_bf16': 2, 'subgraph': sub.compile_count()},
             plain_calls=0)
  emit('fused_session', batch=TRAIN_BATCH, fanouts=list(FANOUTS),
       steps_per_epoch=steps,
       model_tree=f'TreeSAGE({FEAT_DIM}->256->{GNS_CLASSES}, 3 layers)',
       model_subgraph=f'GraphSAGE({FEAT_DIM}, 256, {GNS_CLASSES}, 3), '
                      'remat', optimizer=f'Adam({TRAIN_LR}, capturable)',
       **out)
  return {'tree_bf16': launches16, 'subgraph': sub_launches}, sub_hops, \
      sub_gather


#: `fused_mesh`'s shape: `bench.py:845-942`
FUSED_MESH_FANOUTS = (10, 5)
FUSED_MESH_HIDDEN = 64
FUSED_MESH_BATCHES = 4
#: epochs a fused mesh path runs: a warm one (its last step's kernel
#: inputs recorded), one with the flight recorder on, then the timed ones
#: (their median counts)
FUSED_MESH_RUNS = 3                 # (depth cut, 5 -> 3: one timed epoch)
#: epochs of the per-batch DP loop (its first batch warm and recorded)
FUSED_MESH_LOOP_EPOCHS = 3


def fused_mesh(torch, ops, timer, ds):
  """`bench.py:845-942` on the untiered P = 8 store: the per-batch DP
  loop (`DistNeighborLoader` -> `make_dp_supervised_step` with
  ``GraphSAGE(100, 64, 47, 2)`` and Adam(3e-3), batch 512 a partition,
  fanouts [10, 5], 512 x 8 x 4 seeds, 3 epochs; the first batch
  warm), then `FusedDistEpoch` (3 runs: a warm one, one with the flight
  recorder on for its ``hop.padding`` events, 1 timed (its seconds
  count), then `evaluate`) and `FusedDistTreeEpoch` with
  ``TreeSAGE(100, 64, 47, 2)`` (the same), all drawing from their
  default generator draws.  The loop's first batch and each fused
  epoch's last warm step are recorded, and every one of their 16 K1
  calls (one an owner a hop: sorted hops on the subgraph paths, the
  tree's arrival-order frontiers) and 16 K2 calls (the features, then
  the labels, one an owner) is held against its plain version after
  the path's run.  Checks: 16 K1 and 16 K2 launches a step on every
  path, no plain call, finite losses, every epoch's valid seeds.
  Returns the launches and the checked kernel records by path."""
  import graphlearn_tpu_torch.parallel.dist_sampler as dsm
  from graphlearn_tpu_torch.models import GraphSAGE, TreeSAGE
  from graphlearn_tpu_torch.parallel import (DistNeighborLoader,
                                             FusedDistEpoch,
                                             FusedDistTreeEpoch,
                                             make_dp_supervised_step)
  from graphlearn_tpu_torch.telemetry import recorder
  b, fan = MESH_BATCH, FUSED_MESH_FANOUTS
  per_step = len(fan) * MESH_PARTS
  n_seeds = b * MESH_PARTS * FUSED_MESH_BATCHES
  seeds = np.random.default_rng(0).permutation(NUM_NODES)[:n_seeds]

  def sage(seed, cls=GraphSAGE):
    m = cls(FEAT_DIM, FUSED_MESH_HIDDEN, GNS_CLASSES, num_layers=2).to(
        DEVICE)
    m.reset_parameters(torch.Generator().manual_seed(seed))
    return m, torch.optim.Adam(m.parameters(), lr=TRAIN_LR, eps=1e-8)

  def recording():
    return PathRecorder(torch, dsm, gns=False, parts=MESH_PARTS,
                        hops=len(fan))

  def check_path(rec, what):
    return check_mesh_path(torch, ops, timer, rec, f'fused_mesh {what}',
                           tables=('features', 'labels'))

  out, paths = {}, {}
  # -- the per-batch DP loop ---------------------------------------------
  model, opt = sage(0)
  loader = DistNeighborLoader(ds, fan, seeds, batch_size=b, shuffle=True,
                              seed=0, device=DEVICE)
  step = make_dp_supervised_step(model, opt, b, loader.sampler.mesh)
  it = iter(loader)
  t0 = time.perf_counter()
  with recording() as rec:
    batch = next(it)
  float(step(batch)[0])
  out['per_batch_warm_secs'] = time.perf_counter() - t0
  del batch
  reset_counts(ops)
  t0 = time.perf_counter()
  losses = [step(x)[0] for x in it]
  for _ in range(FUSED_MESH_LOOP_EPOCHS - 1):
    losses += [step(x)[0] for x in loader]
  pb_losses = torch.stack(losses).cpu().numpy()
  pb_dt = time.perf_counter() - t0
  pb_launches = check_replay_counts(ops, 'mesh per-batch loop', len(losses),
                                    per_step, per_step)
  pb_rate = len(losses) * b * MESH_PARTS / pb_dt
  del loader, it, step
  paths['per_batch'] = check_path(rec, 'per-batch loop')
  del rec

  def epochs(fused, name):
    runs, res = [], {}
    for r in range(FUSED_MESH_RUNS):
      if r == 1:
        recorder.clear()
        recorder.enable()
      reset_counts(ops)
      sync(torch)
      t = time.perf_counter()
      if r == 0:
        with recording() as rec:
          stats = fused.run()
      else:
        stats = fused.run()
      lv = stats.losses.cpu().numpy()
      runs.append(time.perf_counter() - t)
      if r == 1:
        recorder.disable()
        res['hop_padding'] = [
            {k: e[k] for k in ('hop', 'nodes', 'capacity', 'fill')}
            for e in recorder.events('hop.padding')
            if e.get('scope') == type(fused).__name__]
      res['launches'] = check_replay_counts(ops, name, len(fused), per_step,
                                            per_step)
      if not (np.isfinite(lv).all() and stats.seeds == n_seeds):
        raise AssertionError(f'{name}: losses {lv}, seeds {stats.seeds}')
      res.setdefault('mean_losses', []).append(float(lv.mean()))
    acc = fused.evaluate(seeds[:b * MESH_PARTS])
    st = fused.sampler.exchange_stats()
    res.update(runs_secs=runs,
               seeds_per_s=len(fused) * b * MESH_PARTS
               / float(np.median(runs[2:])),
               eval_accuracy=acc,
               exchange={k: v for k, v in st.items()
                         if k.startswith(('dist.frontier',
                                          'dist.feature.o',
                                          'dist.feature.d',
                                          'dist.feature.s'))})
    return res, rec

  model, opt = sage(1)
  fused = FusedDistEpoch(ds, fan, seeds, model, opt, batch_size=b,
                         shuffle=True, seed=0, device=DEVICE)
  sub, rec = epochs(fused, 'FusedDistEpoch')
  del fused
  paths['fused'] = check_path(rec, 'FusedDistEpoch')
  model, opt = sage(2, TreeSAGE)
  tfused = FusedDistTreeEpoch(ds, fan, seeds, model, opt, batch_size=b,
                              shuffle=True, seed=0, device=DEVICE)
  tree, rec = epochs(tfused, 'FusedDistTreeEpoch')
  del tfused
  paths['tree'] = check_path(rec, 'FusedDistTreeEpoch')
  del rec
  emit('fused_mesh', parts=MESH_PARTS, batch=b, fanouts=list(fan),
       seeds=n_seeds, steps_per_epoch=FUSED_MESH_BATCHES,
       model=f'GraphSAGE({FEAT_DIM}, {FUSED_MESH_HIDDEN}, {GNS_CLASSES}, '
             '2) / TreeSAGE (same widths)', optimizer=f'Adam({TRAIN_LR})',
       draws='TorchDraws at (epoch, step, hop, owner)',
       per_batch_seeds_per_s=pb_rate, per_batch_secs=pb_dt,
       per_batch_steps=len(losses),
       per_batch_mean_loss=float(pb_losses.mean()),
       fused_seeds_per_s=sub['seeds_per_s'],
       fused_vs_per_batch=sub['seeds_per_s'] / pb_rate,
       tree_seeds_per_s=tree['seeds_per_s'],
       tree_vs_per_batch=tree['seeds_per_s'] / pb_rate,
       fused=sub, tree=tree,
       launches_per_step={'sample_one_hop': per_step,
                          'gather_rows': per_step}, plain_calls=0,
       kernels_checked={k: {'hops': len(v['hops']),
                            'tables': len(v['gathers']),
                            'owners': MESH_PARTS}
                        for k, v in paths.items()}, **out)
  return {'per_batch': pb_launches, 'fused': sub['launches'],
          'tree': tree['launches']}, paths


def fused_mesh_cross_check(torch):
  """A 4,000-node graph at P = 4 on the card and on the CPU with the same
  CPU-made draws: 3 steps of `FusedDistEpoch` (``GraphSAGE``) and of
  `FusedDistTreeEpoch` (``TreeSAGE``) at fanouts [10, 5], their
  per-step losses within 1e-5 (the card's `index_add_` and matmuls sum
  in another order) and their exchange counters equal."""
  from graphlearn_tpu_torch.models import GraphSAGE, TreeSAGE
  from graphlearn_tpu_torch.parallel import (DistDataset, FusedDistEpoch,
                                             FusedDistTreeEpoch, TorchDraws)
  rng = np.random.default_rng(10)
  n, parts, b = 4000, 4, 64
  rows = np.repeat(np.arange(n), 12)
  cols = np.where(rng.random(n * 12) < 0.3, rng.integers(0, 40, n * 12),
                  rng.integers(0, n, n * 12))
  feats = rng.standard_normal((n, 16)).astype(np.float32)
  labels = rng.integers(0, 7, n).astype(np.int32)
  seeds = rng.permutation(n)[:3 * b * parts]
  cpu = TorchDraws(6, 'cpu')
  losses, stats = {}, {}
  for dev in (DEVICE, 'cpu'):
    def draws(e, s, h, r, k, w, gns=False, owner=0, dev=dev):
      return tuple(t.to(dev) for t in cpu.draw((e, s, h, owner), r, k, w,
                                               gns))
    ds = DistDataset.from_full_graph(parts, rows, cols, node_feat=feats,
                                     node_label=labels, num_nodes=n,
                                     split_ratio=1.0, device=dev)
    for cls, mcls in ((FusedDistEpoch, GraphSAGE),
                      (FusedDistTreeEpoch, TreeSAGE)):
      model = mcls(16, 32, 7, num_layers=2).to(dev)
      model.reset_parameters(torch.Generator().manual_seed(3))
      opt = torch.optim.Adam(model.parameters(), lr=TRAIN_LR, eps=1e-8)
      fused = cls(ds, FUSED_MESH_FANOUTS, seeds, model, opt, batch_size=b,
                  shuffle=True, seed=1, draws=draws, device=dev)
      key = (dev, cls.__name__)
      losses[key] = fused.run().losses.cpu().numpy()
      stats[key] = {k: v for k, v in fused.sampler.exchange_stats().items()
                    if k.startswith(('dist.frontier', 'dist.feature.o',
                                     'dist.feature.d', 'dist.feature.s'))}
  diffs = {}
  for name in ('FusedDistEpoch', 'FusedDistTreeEpoch'):
    card, host = losses[DEVICE, name], losses['cpu', name]
    diffs[name] = float(np.abs(card - host).max())
    if not (card.shape == host.shape == (3,) and np.isfinite(card).all()
            and diffs[name] <= 1e-5):
      raise AssertionError(f'{name}: card losses {card}, CPU {host}')
    if stats[DEVICE, name] != stats['cpu', name] or not stats[
        'cpu', name]['dist.frontier.offered']:
      raise AssertionError(f'{name}: exchange counters differ: card '
                           f'{stats[DEVICE, name]}, CPU {stats["cpu", name]}')
  emit('fused_mesh_cross_check', parts=parts, steps=3,
       fanouts=list(FUSED_MESH_FANOUTS), loss_max_abs_diff=diffs,
       exchange_equal=True,
       exchange={k: v for k, v in stats['cpu', 'FusedDistEpoch'].items()})


def train_cross_check(torch):
  """A small graph (4,000 nodes, one hub row) on the card and on the
  CPU: 3 `NeighborLoader` batches with the same CPU-made draws
  byte-equal (node, x, y, edge_index, edge_mask) and their GraphSAGE
  step losses within 1e-5; then the fused epochs with their default
  counter draws (the same values on both devices), captured on the card
  and eager on the CPU: 2 `FusedTreeEpoch` steps' and 3 `FusedEpoch`
  (remat) steps' losses within 1e-5."""
  from graphlearn_tpu_torch.data import Dataset
  from graphlearn_tpu_torch.loader import (FusedEpoch, FusedTreeEpoch,
                                           NeighborLoader)
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
  out, losses, tree_losses, sub_losses = {}, {}, {}, {}
  for dev in (DEVICE, 'cpu'):
    def draws(step, hop, r, k, w, dev=dev):
      return tuple(t.to(dev) for t in cpu(step, hop, r, k, w))

    def adam(model, dev=dev):
      return torch.optim.Adam(model.parameters(), lr=TRAIN_LR, eps=1e-8,
                              capturable=dev != 'cpu')
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
    fused = FusedTreeEpoch(ds, FANOUTS, np.arange(128), tm, adam(tm),
                           batch_size=64, seed=2, device=dev)
    tree_losses[dev] = fused.run().losses.cpu().numpy()
    sm = GraphSAGE(16, 32, 7, num_layers=3).to(dev)
    sm.reset_parameters(torch.Generator().manual_seed(5))
    sub = FusedEpoch(ds, FANOUTS, np.arange(192), sm, adam(sm),
                     batch_size=64, seed=3, remat=True, device=dev)
    sub_losses[dev] = sub.run().losses.cpu().numpy()
    if dev != 'cpu' and (fused.compile_count(), sub.compile_count()) != (1,
                                                                       1):
      raise AssertionError('the card did not capture the fused steps')
  for i, (a, c) in enumerate(zip(out[DEVICE], out['cpu'])):
    for name, x, y in zip(('node', 'x', 'y', 'edge_index', 'edge_mask'),
                          a, c):
      if x.dtype != y.dtype or not torch.equal(x, y):
        raise AssertionError(f'card and CPU differ: batch {i} {name}')
  diff = float(np.abs(losses[DEVICE] - losses['cpu']).max())
  tdiff = float(np.abs(tree_losses[DEVICE] - tree_losses['cpu']).max())
  sdiff = float(np.abs(sub_losses[DEVICE] - sub_losses['cpu']).max())
  if not (diff <= 1e-5 and tdiff <= 1e-5 and sdiff <= 1e-5
          and len(tree_losses['cpu']) == 2 and len(sub_losses['cpu']) == 3):
    raise AssertionError(f'losses differ: per-batch {diff}, tree {tdiff}, '
                         f'subgraph {sdiff}')
  emit('train_cross_check', batches=3, byte_equal=True,
       loss_max_abs_diff=diff, tree_steps=2, tree_loss_max_abs_diff=tdiff,
       subgraph_steps=3, subgraph_loss_max_abs_diff=sdiff,
       card_captured=True)


#: the single-card tiered store's phases: `bench_serving.py`'s tiered
#: engine at split 0.5 and BASELINE config 1's step over
#: `bench_feature.py`'s split-0.2 store, both sorted by in-degree with the
#: 'auto' victim cache (15% of the cold rows)
TIERED_SERVE_SPLIT = 0.5
TIERED_TRAIN_SPLIT = 0.2
TIERED_WARM = 3
TIERED_TIMED = 6                    # (depth cut, 12 -> 6)
TIERED_SPLIT_STEPS = 3
TIERED_PROFILE_STEPS = 3
ZIPF_A = 1.1
LOOKUP_SPLITS = (1.0, 0.5, 0.2)
LOOKUP_BUDGETS = (0.0, 0.05, 0.15)
LOOKUP_SETS = 2
#: K6's forced row layouts (columns, dtype): rows of 4, 12, 200 (bf16 x
#: 100), 400, 512 and 1,024 bytes, over a block of `COLD_FORCED_ROWS` rows
COLD_LAYOUTS = ((1, 'float32'), (3, 'float32'), (100, 'bfloat16'),
                (100, 'float32'), (128, 'float32'), (256, 'float32'))
COLD_FORCED_ROWS = 10_007
#: rows of K6's forced run sets: ``rel`` in runs of 1-9 adjacent rows
#: (neighbours share a 128-B line), ``pos`` a random permutation
COLD_RUN_ROWS = 3_001
COLD_RUN_OUT = 4_096
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


def cold_id_dtype(torch, ops):
  """The id type this tree's K6 wrapper takes: int32 (the JAX gather's),
  or int64 in a tree from before K6's redesign, so that an A/B call can
  drive the parent's kernel with this script.  Probed with no miss row,
  which launches nothing."""
  out = torch.zeros(1, 1, device=DEVICE)
  cold = torch.zeros(1, 1).pin_memory()
  ids = torch.zeros(0, dtype=torch.int32, device=DEVICE)
  try:
    ops.cold_gather(out, cold, ids, ids)
  except ValueError:
    return torch.int64
  return torch.int32


def k6_module():
  """``graphlearn_tpu_torch.ops.cold_gather`` (the package's ``ops``
  exports the wrapper under the module's name)."""
  import importlib
  return importlib.import_module('graphlearn_tpu_torch.ops.cold_gather')


def k6_kernel(ops):
  """K6's kernel alone, without the wrapper's plan step (the wrapper in
  a tree from before the plan step, which is then the same thing)."""
  return getattr(k6_module(), 'cold_gather_kernel', ops.cold_gather)


def k6_plans(ops) -> int:
  return getattr(ops.cold_gather, 'plans', 0)


def k6_expected_plans(m: int) -> int:
  """Plan steps the wrapper takes for ``m`` misses (none in a tree from
  before the plan step)."""
  lo = getattr(k6_module(), 'PLAN_MIN_ROWS', None)
  return int(lo is not None and m >= lo)


def check_cold(torch, ops, timer, b, cold, pos, rel, time_it=True,
               time_plain=True, fn=None):
  """K6 (the wrapper, or ``fn``) against its plain version on the same
  inputs (the ``[b, D]`` output starting from the same random rows):
  byte-equal, the rows outside ``pos`` untouched; timed with the plain
  version, a pinned -> device copy of the same bytes (``library_ms``) and
  its bound (the link bytes over the link's peak, or the device bytes
  over HBM's)."""
  fn = fn or ops.cold_gather
  d = cold.shape[1]
  init = torch.randn(b, d, device=DEVICE,
                     generator=torch.Generator(device=DEVICE).manual_seed(
                         b)).to(cold.dtype)
  m = int(pos.numel())
  before, plans0 = ops.cold_gather.launches, k6_plans(ops)
  got = fn(init.clone(), cold, pos, rel)
  launched = ops.cold_gather.launches - before
  plans = k6_plans(ops) - plans0
  ref = ops.cold_gather_plain(init.clone(), cold, pos, rel)
  sync(torch)
  want_plans = k6_expected_plans(m) if fn is ops.cold_gather else 0
  if launched != (m > 0) or plans != want_plans:
    raise AssertionError(f'cold_gather launched {launched} times with '
                         f'{plans} plan steps for {m} rows')
  if not torch.equal(got.view(torch.uint8), ref.view(torch.uint8)):
    bad = int((got != ref).any(dim=1).sum())
    raise AssertionError(f'cold_gather != plain version ({cold.dtype}, '
                         f'{d} columns, {bad} rows differ)')
  keep = torch.ones(b, dtype=torch.bool, device=DEVICE)
  keep[pos.long()] = False
  if not torch.equal(got[keep], init[keep]):
    raise AssertionError('cold_gather wrote a row outside pos')
  row = d * cold.element_size()
  link_b, dev_b = cold_bytes(m, row)
  bound = max(link_b / LINK_BYTES_PER_S, dev_b / HBM_BYTES_PER_S) * 1e3
  rec = {'rows': m, 'out_rows': b, 'cold_rows': int(cold.shape[0]),
         'dtype': str(cold.dtype).replace('torch.', ''), 'row_bytes': row,
         'ids': str(pos.dtype).replace('torch.', ''),
         'byte_equal': True, 'max_abs_err': float(
             (got.float() - ref.float()).abs().max()) if b else 0.0,
         'link_bytes': link_b, 'bound_ms': bound, 'launches': launched,
         'plans': plans}
  if time_it and m:
    out = init.clone()
    src = torch.empty(link_b, dtype=torch.uint8).pin_memory()
    dst = torch.empty(link_b, dtype=torch.uint8, device=DEVICE)
    rec['kernel_ms'] = timer(lambda: fn(out, cold, pos, rel))
    if time_plain:
      rec['plain_ms'] = timer(lambda: ops.cold_gather_plain(out, cold, pos,
                                                            rel))
    rec['library_ms'] = timer(lambda: dst.copy_(src, non_blocking=True))
    rec['achieved_gbps'] = link_b / rec['kernel_ms'] / 1e6
    rec['rows_per_us'] = m / rec['kernel_ms'] / 1e3
    rec['link_share'] = bound / rec['kernel_ms']
    rec['copy_share'] = rec['library_ms'] / rec['kernel_ms']
  return rec


def run_rels(rng, m: int, n: int) -> np.ndarray:
  """``m`` distinct rows of ``[0, n)`` in runs of 1-9 adjacent rows (a
  run's neighbours share 128-B lines of the block), at least one row
  apart, the first run at row 0 and the last ending at ``n - 1``; the
  runs in random order."""
  lens = rng.integers(1, 10, m)
  lens = lens[:int(np.searchsorted(np.cumsum(lens), m)) + 1]
  lens[-1] -= int(lens.sum()) - m
  k = len(lens)
  extra = np.zeros(k, np.int64)
  extra[1:] = rng.multinomial(n - m - (k - 1), np.full(k - 1, 1 / (k - 1)))
  starts = np.cumsum(np.concatenate([[0], lens[:-1] + 1])) + np.cumsum(extra)
  runs = [np.arange(s, s + ln) for s, ln in zip(starts, lens)]
  return np.concatenate([runs[i] for i in rng.permutation(k)])


def forced_cold_sets(torch, ops, timer, seed=23):
  """K6 on forced shapes: every `COLD_LAYOUTS` row width at M = 0 (no
  launch), 1 and 7 miss rows with ``rel`` at 0 and at Nc - 1, and at
  `COLD_RUN_ROWS` rows in runs of adjacent ``rel`` (`run_rels`), over a
  `pin_memory` block; the 12- and 400-byte layouts also through a block
  that starts one row into its allocation and through a registered
  block (`PinnedColdBuffer`).  Ids are the wrapper's type
  (`cold_id_dtype`); int64 ids, mismatched id types and a block that is
  not page-locked must raise."""
  from graphlearn_tpu_torch.data.cold_cache import PinnedColdBuffer
  rng = np.random.default_rng(seed)
  idt = cold_id_dtype(torch, ops)
  cases = {}
  nc = COLD_FORCED_ROWS
  for cols, dt in COLD_LAYOUTS:
    dtype = getattr(torch, dt)
    host = torch.from_numpy(rng.standard_normal((nc + 1, cols)).astype(
        np.float32)).to(dtype)
    blocks = {'pinned': host[:nc].clone().pin_memory()}
    registered = None
    if cols in (3, 100) and dt == 'float32':
      blocks['offset'] = host.clone().pin_memory()[1:]
      registered = PinnedColdBuffer(host[:nc], cols, device=DEVICE)
      blocks['registered'] = registered.rows
    for kind, cold in blocks.items():
      for m in (0, 1, 7, COLD_RUN_ROWS):
        b = COLD_RUN_OUT if m == COLD_RUN_ROWS else 64
        pos = rng.choice(b, m, replace=False).astype(np.int64)
        if m == COLD_RUN_ROWS:
          rel = run_rels(rng, m, cold.shape[0])
        else:
          rel = rng.integers(0, cold.shape[0], m).astype(np.int64)
          if m:
            rel[0], rel[-1] = 0, cold.shape[0] - 1
        rec = check_cold(torch, ops, timer, b, cold,
                         torch.from_numpy(pos).to(DEVICE, idt),
                         torch.from_numpy(rel).to(DEVICE, idt),
                         time_it=m >= 7)
        name = 'runs' if m == COLD_RUN_ROWS else f'M={m}'
        cases[f'{cols}x{dt} {kind} {name}'] = rec
    if registered is not None:
      registered.close()
  wrong = [(torch.zeros(4, 3, device=DEVICE), torch.zeros(8, 3), idt, idt,
            'a block that is not pinned')]
  pinned = torch.zeros(8, 3).pin_memory()
  if idt == torch.int32:
    wrong += [(torch.zeros(4, 3, device=DEVICE), pinned, torch.int64,
               torch.int64, 'int64 ids'),
              (torch.zeros(4, 3, device=DEVICE), pinned, torch.int32,
               torch.int64, 'mismatched id types')]
  for out, cold, pt, rt, what in wrong:
    try:
      ops.cold_gather(out, cold, torch.zeros(1, dtype=pt, device=DEVICE),
                      torch.zeros(1, dtype=rt, device=DEVICE))
    except ValueError:
      continue
    raise AssertionError(f'cold_gather took {what}')
  return cases


def thp_mode() -> dict:
  """The host's transparent-huge-page settings (the selected word)."""
  out = {}
  for key in ('enabled', 'defrag'):
    try:
      with open(f'/sys/kernel/mm/transparent_hugepage/{key}') as f:
        text = f.read()
      out[key] = text[text.index('[') + 1:text.index(']')]
    except (OSError, ValueError):
      out[key] = None
  return out


def huge_block(torch, shape, dtype):
  """An uninitialised CPU tensor on a 2 MiB boundary whose pages are
  advised huge (``madvise(MADV_HUGEPAGE)``) before anything touches
  them; its own storage starts at the boundary (what a registration and
  `is_pinned` read) and holds the larger allocation it lives in."""
  import ctypes
  huge = 2 << 20
  nbytes = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
  span = -(-nbytes // huge) * huge
  raw = torch.empty(span + huge, dtype=torch.uint8)
  at = raw.data_ptr() + (-raw.data_ptr() % huge)
  libc = ctypes.CDLL(None, use_errno=True)
  libc.madvise.argtypes = (ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int)
  if libc.madvise(at, span, 14) != 0:          # MADV_HUGEPAGE
    raise OSError(ctypes.get_errno(), 'madvise(MADV_HUGEPAGE) failed')
  buf = (ctypes.c_uint8 * nbytes).from_address(at)
  buf.owner = raw
  return torch.frombuffer(buf, dtype=torch.uint8).view(dtype).view(
      tuple(shape))


def host_pages(t) -> dict:
  """How the host backs a CPU tensor's bytes: its start's offset in a 2
  MiB page and, from ``/proc/self/smaps``, the kB of the mappings it
  spans and of those that are transparent huge pages."""
  lo = t.data_ptr()
  hi = lo + t.numel() * t.element_size()
  rec = {'start_mod_2m': lo % (2 << 20), 'mapped_kb': 0, 'anon_huge_kb': 0}
  try:
    with open('/proc/self/smaps') as f:
      inside = False
      for line in f:
        head = line.split()[0]
        if '-' in head and not head.endswith(':'):
          a, z = (int(x, 16) for x in head.split('-'))
          inside = a < hi and z > lo
        elif inside and head in ('Rss:', 'AnonHugePages:'):
          key = 'mapped_kb' if head == 'Rss:' else 'anon_huge_kb'
          rec[key] += int(line.split()[1])
  except OSError:
    pass
  return rec


#: timing rounds of K6's diagnosis cases, taken in turns
K6_DIAG_ROUNDS = 1


def k6_diagnosis(torch, ops, timer, b, cold, pos, rel):
  """What bounds K6: the kernel on variants of a tiered-train batch's
  miss set, each beside its bound and a pinned copy of the same bytes,
  all byte-equal to the plain version.  (a) the pairs as the path gives
  them; (b) sorted by ``rel`` (``pos`` permuted along: locality in the
  host block); (c) ``rel = arange(M)`` (a streaming read through the
  kernel at the same M); (d) (a) and (c) over a ``[Nc, 128]`` f32 block
  (512-byte rows, each starting on a 128-byte line); (e) (a) over a
  `pin_memory` (`cudaHostAlloc`) copy of the block instead of the
  registered one; (f) (a) and (b) over a 2 MiB-aligned copy advised huge
  pages (`huge_block`).  The kernel is timed in
  `K6_DIAG_ROUNDS` rounds, every case once a round in turn (the host
  link's rate drifts over seconds); ``kernel_ms`` is the median of the
  rounds' medians, ``rounds_ms`` each round's."""
  from graphlearn_tpu_torch.data.cold_cache import PinnedColdBuffer
  from graphlearn_tpu_torch.ops.cold_gather import (host_register,
                                                    host_unregister)
  order = torch.argsort(rel.long(), stable=True)
  stream = torch.arange(pos.numel(), dtype=rel.dtype, device=DEVICE)
  wide = PinnedColdBuffer(
      torch.nn.functional.pad(cold, (0, 128 - cold.shape[1])), 128,
      device=DEVICE)
  pinned = cold.clone().pin_memory()
  huge = huge_block(torch, cold.shape, cold.dtype)
  huge.copy_(cold)
  host_register(huge)
  cases = {
      '(a) path order': (cold, pos, rel),
      '(b) sorted by rel': (cold, pos[order], rel[order]),
      '(c) rel = arange(M)': (cold, pos, stream),
      '(d) 512-B rows, path order': (wide.rows, pos, rel),
      '(d) 512-B rows, rel = arange(M)': (wide.rows, pos, stream),
      '(e) pin_memory block, path order': (pinned, pos, rel),
      '(f) huge-page block, path order': (huge, pos, rel),
      '(f) huge-page block, sorted by rel': (huge, pos[order], rel[order]),
  }
  kern = k6_kernel(ops)
  fns = {tag: kern for tag in cases}
  cases['(g) wrapper (plan step + kernel), path order'] = (cold, pos, rel)
  fns['(g) wrapper (plan step + kernel), path order'] = ops.cold_gather
  recs = {}
  for tag, (blk, p, r) in cases.items():
    recs[tag] = check_cold(torch, ops, timer, b, blk, p, r, time_plain=False,
                           fn=fns[tag])
    recs[tag]['host_pages'] = host_pages(blk)
  rounds = {tag: [] for tag in cases}
  for _ in range(K6_DIAG_ROUNDS):
    for tag, (blk, p, r) in cases.items():
      out = torch.empty(b, blk.shape[1], dtype=blk.dtype, device=DEVICE)
      rounds[tag].append(timer(lambda: fns[tag](out, blk, p, r)))
  for tag, rec in recs.items():
    ms = float(np.median(rounds[tag]))
    rec.update(kernel_ms=ms, rounds_ms=rounds[tag],
               achieved_gbps=rec['link_bytes'] / ms / 1e6,
               rows_per_us=rec['rows'] / ms / 1e3,
               link_share=rec['bound_ms'] / ms,
               copy_share=rec['library_ms'] / ms)
    emit('kernel', kernel='cold_gather', shape=f'diagnosis {tag}', **rec)
  wide.close()
  host_unregister(huge)
  del wide, pinned, huge
  out = {tag: {k: r[k] for k in ('rows', 'row_bytes', 'kernel_ms',
                                 'rounds_ms', 'bound_ms', 'library_ms',
                                 'achieved_gbps', 'rows_per_us',
                                 'link_share', 'copy_share', 'host_pages')}
         for tag, r in recs.items()}
  out['plan_sweep'] = k6_plan_sweep(torch, ops, timer, b, cold, pos, rel)
  return out


#: miss counts of the plan-step sweep (subsets of a training batch's
#: misses; the batch's own count is added)
K6_PLAN_ROWS = (584, 4_096, 16_384, 65_536, 131_072)


def k6_plan_sweep(torch, ops, timer, b, cold, pos, rel) -> dict:
  """When the plan step pays: at each `K6_PLAN_ROWS` count (random
  subsets of the batch's misses, in the batch's order) and at the whole
  batch, the kernel alone on the pairs as given and in block order, the
  plan step alone (`cold_plan`: sort + permute), and the wrapper, each
  held byte-equal to the plain version; `K6_DIAG_ROUNDS` interleaved
  rounds, medians.  The plan pays where the kernel on the given order
  takes longer than the plan plus the kernel in block order."""
  cg = k6_module()
  kern = k6_kernel(ops)
  plan = getattr(cg, 'cold_plan', None)
  m = int(pos.numel())
  rng = np.random.default_rng(29)
  sets = {}
  for n in [k for k in K6_PLAN_ROWS if k < m] + [m]:
    keep = torch.from_numpy(np.sort(rng.choice(m, n, replace=False))).to(
        DEVICE)
    p, r = pos[keep], rel[keep]
    order = torch.argsort(r.long(), stable=True)
    fns = {'kernel_given_ms': (kern, p, r),
           'kernel_block_order_ms': (kern, p[order], r[order]),
           'wrapper_ms': (ops.cold_gather, p, r)}
    for name, (fn, pp, rr) in fns.items():
      check_cold(torch, ops, timer, b, cold, pp, rr, time_it=False, fn=fn)
    if plan is not None:
      fns['plan_ms'] = (lambda o, c, pp, rr: plan(pp, rr), p, r)
    sets[n] = fns
  out = torch.empty(b, cold.shape[1], dtype=cold.dtype, device=DEVICE)
  times = {n: {k: [] for k in fns} for n, fns in sets.items()}
  for _ in range(K6_DIAG_ROUNDS):
    for n, fns in sets.items():
      for name, (fn, pp, rr) in fns.items():
        times[n][name].append(timer(lambda: fn(out, cold, pp, rr)))
  res = {}
  for n, t in times.items():
    rec = {k: float(np.median(v)) for k, v in t.items()}
    if 'plan_ms' in rec:
      rec['plan_pays'] = bool(rec['kernel_given_ms'] > rec['plan_ms']
                              + rec['kernel_block_order_ms'])
    rec['plans'] = k6_expected_plans(n)
    res[str(n)] = rec
  emit('kernel', kernel='cold_gather', shape='diagnosis: plan-step sweep',
       rounds=K6_DIAG_ROUNDS, sweep=res)
  return res


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
  ops.cold_gather.plans = 0
  ops.cold_gather_plain.calls = 0


def read_tiered_counts(ops) -> tuple:
  """``(launches, plain calls)`` since `reset_tiered_counts`; the
  launches carry K6's plan steps as ``cold_gather_plans``."""
  launches, plain = read_counts(ops)
  launches['cold_gather'] = ops.cold_gather.launches
  launches['cold_gather_plans'] = ops.cold_gather.plans
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
  from graphlearn_tpu_torch.telemetry import OpsServer
  t0 = time.perf_counter()
  ds = tiered_dataset(torch, indptr, indices, feats_h, TIERED_SERVE_SPLIT)
  setup_secs = time.perf_counter() - t0
  f = ds.node_features
  eng = ServingEngine(ds, FANOUTS, model=TreeSAGE(FEAT_DIM, 256, 47, 3),
                      seed=0, buckets=BUCKETS, device=DEVICE)
  eng.init_params(torch.Generator().manual_seed(0))
  warm = eng.warmup()
  with slo_target():
    fe = ServingFrontend(eng, max_wait_ms=2.0, default_deadline_ms=10_000.0)
  reqs = zipf_requests()
  results, lat, errors = [None] * len(reqs), [0.0] * len(reqs), []
  srv = OpsServer(port=0)
  watch = MidRunScrape(srv, len(reqs), require_cache=True)
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
      watch.tick()

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
  scrape = watch.result('tiered serve')
  srv.close()
  st = fe.stats()
  if errors or st['failed'] or any(r is None for r in results):
    raise AssertionError(f'tiered serving failed: {errors[:3]} stats={st}')
  d = st['dispatches']
  with_misses = sum(1 for m in rec.misses if m)
  plans = sum(k6_expected_plans(m) for m in rec.misses)
  if not (launches['sample_one_hop'] == len(FANOUTS) * d
          and launches['gather_rows'] == d == len(fills)
          and launches['cold_gather'] == with_misses > 0
          and launches['cold_gather_plans'] == plans and plain == 0):
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
       x_byte_equal_to_hot=True, logits_max_abs_diff_to_hot=worst,
       ops_scrape=scrape)
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
                 train_idx, prof=False):
  """BASELINE config 1's per-batch step over `bench_feature.py`'s tiered
  store: the products table sorted by in-degree at split 0.2 (489,806
  hot rows, 1,959,223 cold rows pinned, the 'auto' cache), batch 1,024,
  ``GraphSAGE(100, 256, 47, 3)``, Adam(3e-3); `NeighborLoader` with
  ``prefetch=0``, then ``prefetch=2`` over the same seeds (the model
  re-initialised alike): 3 warm and `TIERED_TIMED` timed steps each, and
  with ``prof`` the device's idle share over 3 more (a `torch.profiler`
  window; its stop crashed some runs while the prefetch worker ran, so
  the default run leaves it out).  Checks: the runs' batches byte-equal (whole
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
    plans = sum(k6_expected_plans(m) for m in rec.misses)
    if not (launches['sample_one_hop'] == len(FANOUTS) * produced
            and launches['gather_rows'] == produced
            and launches['cold_gather'] == with_misses == produced
            and launches['cold_gather_plans'] == plans
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
      k6['diagnosis'] = k6_diagnosis(torch, ops, timer, *rec.last)
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
    idle = None
    if prof:
      it = iter(loader)
      idle = device_idle(torch, lambda: step(next(it))[0],
                         TIERED_PROFILE_STEPS)
      del it
    loader.close()
    del model, opt, step, loader
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
              boost, req, w, edge_ids=None, with_edge_ids=False):
  """The GNS kernel against its plain version on the same rows (seeds
  in the order the kernel sees them): byte-equal nbrs, mask, weights
  and, with ``with_edge_ids``, eids (the kernel then also timed without
  the edge-id arm, ``no_eids_ms``)."""
  before = ops.sample_one_hop_gns_fused.launches
  args = (indptr, indices, seeds, k, u, v, bits, boost)
  ekw = {'edge_ids': edge_ids, 'with_edge_ids': with_edge_ids}
  got = ops.sample_one_hop_gns_fused(*args, req=req, window=w, **ekw)
  ref = ops.sample_one_hop_gns(*args, req=req, window=w, **ekw)
  sync(torch)
  same = (torch.equal(got.nbrs, ref.nbrs) and torch.equal(got.mask, ref.mask)
          and torch.equal(got.weights.view(torch.int32),
                          ref.weights.view(torch.int32)))
  mode = ('none' if not with_edge_ids
          else 'positions' if edge_ids is None else 'ids')
  if with_edge_ids:
    same = same and (got.eids.dtype == ref.eids.dtype == torch.int32
                     and torch.equal(got.eids, ref.eids))
  if not same:
    bad = int((got.nbrs != ref.nbrs).sum()
              + (got.weights != ref.weights).sum())
    raise AssertionError(f'GNS kernel != plain version (k={k}, boost='
                         f'{boost}, eids {mode}, {bad} slots differ)')
  err = max(int((got.nbrs.long() - ref.nbrs.long()).abs().max()),
            float((got.weights - ref.weights).abs().max()))
  if with_edge_ids:
    err = max(err, int((got.eids.long() - ref.eids.long()).abs().max()))
  deg = ops.lookup_degree(indptr, seeds).cpu().numpy()
  deg = np.where(seeds.cpu().numpy() >= 0, deg, -1)
  m = got.mask
  nbytes = gns_bytes(deg, k, w) + edge_bytes(int(m.sum()),
                                             int(seeds.numel()), k, mode)
  # the kernel alone: the table row of each seed resolved outside the
  # timed call (the wrapper's small ops are timed as wrapper_ms)
  table = ops.gns.bits_table(bits)
  rows = ops.gns.bits_rows(bits, req, seeds.numel(), seeds.device
                           ).contiguous()
  rec = {
      'rows': int(seeds.numel()), 'k': k, 'w': w, 'boost': boost,
      'eids': mode, 'table_rows': int(table.shape[0]),
      'arms': {'empty_or_invalid': int((deg <= 0).sum()),
               'take_all': int(((deg > 0) & (deg <= k)).sum()),
               'window': int(((deg > k) & (deg <= w)).sum()),
               'hub': int((deg > w).sum())},
      'weights_ne_1': int(((got.weights != 1.0) & m).sum()),
      'byte_equal': True, 'max_abs_err': err,
      'kernel_ms': timer(lambda: ops.fused_sample.gns_kernel(
          indptr, indices, seeds, k, u, v, table, rows, boost, w, **ekw)),
      'wrapper_ms': timer(lambda: ops.sample_one_hop_gns_fused(
          *args, req=req, window=w, **ekw)),
      'plain_ms': timer(lambda: ops.sample_one_hop_gns(
          *args, req=req, window=w, **ekw)),
      'bytes': nbytes, 'bound_us': nbytes / HBM_BYTES_PER_S * 1e6}
  if with_edge_ids:
    plain_bytes = gns_bytes(deg, k, w)
    rec.update(no_eids_ms=timer(lambda: ops.fused_sample.gns_kernel(
        indptr, indices, seeds, k, u, v, table, rows, boost, w)),
        no_eids_bound_ms=plain_bytes / HBM_BYTES_PER_S * 1e3)
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
  each with its rows in the order the kernel sees them: ascending with
  ``sort_locality``, else in arrival order, and the edge-id arm it was
  launched with in ``edges``) and its ``tables x parts`` gathers (the
  edge rows with edge features, then the features, then the labels,
  each owner in turn)."""

  def __init__(self, torch, mod, gns=True, parts=1, tables=2,
               hops=len(FANOUTS), first=False):
    # ``first``: keep the first dispatch's calls instead of the latest's
    self.torch, self.mod, self.gns = torch, mod, gns
    self.first = first
    self.name = 'sample_one_hop_gns_fused' if gns else 'sample_one_hop_fused'
    self.real = getattr(mod, self.name)
    self.real_gather = mod.gather_rows
    self.hops, self.parts = hops, parts
    self.n_samples, self.n_gathers = hops * parts, tables * parts
    self.sorted_hops = {}
    self.samples, self.edges, self.calls = {}, {}, 0
    self.gathers, self.gather_calls = {}, 0

  def gather(self, table, ids, id2index=None):
    if not (self.first and self.gather_calls >= self.n_gathers):
      self.gathers[self.gather_calls % self.n_gathers] = (table, ids)
    self.gather_calls += 1
    return self.real_gather(table, ids, id2index)

  def __call__(self, indptr, indices, seeds, k, u, v, *rest, req=None,
               window=None, sort_locality=False, edge_ids=None,
               with_edge_ids=False):
    torch = self.torch
    if self.first and self.calls >= self.n_samples:
      self.calls += 1
      kw = dict(req=req, window=window) if self.gns else {}
      if with_edge_ids:
        kw.update(edge_ids=edge_ids, with_edge_ids=True)
      return self.real(indptr, indices, seeds, k, u, v, *rest,
                       sort_locality=sort_locality, **kw)
    if sort_locality and seeds.shape[0] > 1:
      order = torch.argsort(torch.where(seeds >= 0, seeds,
                                        torch.iinfo(seeds.dtype).max),
                            stable=True)
    else:
      order = torch.arange(seeds.shape[0], device=seeds.device)
    args = (indptr, indices, seeds[order].contiguous(), k, u, v)
    if self.gns:
      args += tuple(rest) + (req[order].contiguous(), window)
    self.samples[self.calls % self.n_samples] = args
    self.edges[self.calls % self.n_samples] = (edge_ids, with_edge_ids)
    self.sorted_hops[self.calls % self.n_samples // self.parts] = bool(
        sort_locality)
    self.calls += 1
    kw = dict(req=req, window=window) if self.gns else {}
    if with_edge_ids:
      kw.update(edge_ids=edge_ids, with_edge_ids=True)
    return self.real(indptr, indices, seeds, k, u, v, *rest,
                     sort_locality=sort_locality, **kw)

  def sample_calls(self) -> list:
    return [self.samples[i] for i in range(self.n_samples)]

  def edge_args(self) -> list:
    return [self.edges[i] for i in range(self.n_samples)]

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
              'wrapper_ms', 'plain_ms', 'library_ms', 'no_eids_ms',
              'no_eids_bound_ms'):
    if key in recs[0]:
      out[key] = sum(r[key] for r in recs)
  for key in ('k', 'w', 'boost', 'dtype', 'row_bytes', 'eids'):
    if key in recs[0]:
      out[key] = recs[0][key]
  return out


def check_mesh_path(torch, ops, timer, rec, path,
                    tables=('hot-tier features', 'labels'),
                    hop_names=None, parts=MESH_PARTS) -> dict:
  """Every sampler and row-gather call of one recorded mesh dispatch held
  against its plain version (byte-equal), each timed; one ``kernel`` line
  per hop (``hop_names[t]``, for a heterogeneous dispatch the hop and
  edge type of its ``t``-th sampler call) and per table, summed over the
  ``parts`` owners."""
  per_hop, per_table = [], []
  for t in range(rec.hops):
    at = slice(t * parts, (t + 1) * parts)
    calls = zip(rec.sample_calls()[at], rec.edge_args()[at])
    if rec.gns:
      recs = [check_gns(torch, ops, timer, *a, edge_ids=e, with_edge_ids=on)
              for a, (e, on) in calls]
    else:
      recs = []
      for a, (e, on) in calls:
        r = check_sampler(torch, ops, timer, *a, edge_ids=e,
                          with_edge_ids=on)[1]
        if on:
          r['no_eids_ms'] = check_sampler(torch, ops, timer, *a)[1][
              'kernel_ms']
        recs.append(r)
    per_hop.append(summed(recs))
    per_hop[-1]['sorted'] = rec.sorted_hops[t]
    name = f'hop {t}' if hop_names is None else hop_names[t]
    emit('kernel', kernel='sample_one_hop_gns' if rec.gns else
         'sample_one_hop', shape=f'{path} {name}, {parts} owners',
         **per_hop[-1])
  calls = rec.gather_calls_in_order()
  for t, what in enumerate(tables):
    recs = [check_gather(torch, ops, timer, *a)
            for a in calls[t * parts:(t + 1) * parts]]
    per_table.append(summed(recs))
    emit('kernel', kernel='gather_rows',
         shape=f'{path} {what}, {parts} owners', **per_table[-1])
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


def mesh_data(torch, indptr, indices, feats, labels, table=None,
              tiered=True):
  """The mesh paths' two stores of the products graph at P = 8
  partitions on the card (`bench.py`'s ``DIST_PARTS``): untiered (every
  shard wholly on the card) and tiered at split 0.3 (the hot rows on the
  card, the whole table in pinned host memory), both with the `train`
  phase's labels and, given an ``[E, 8]`` edge ``table`` (by global
  edge id, the CSR position here), its one mod-sharded copy."""
  from graphlearn_tpu_torch.parallel import (DistDataset,
                                             build_dist_edge_feature)
  t0 = time.perf_counter()
  deg = indptr[1:] - indptr[:-1]
  rows = torch.repeat_interleave(
      torch.arange(NUM_NODES, device=DEVICE), deg)
  ef = (build_dist_edge_feature(table, MESH_PARTS, device=DEVICE)
        if table is not None else None)
  stores = {'tiered': None}
  for name, split in (('untiered', 1.0), ('tiered', MESH_SPLIT)):
    if name == 'tiered' and not tiered:
      continue
    stores[name] = DistDataset.from_full_graph(
        MESH_PARTS, rows, indices, node_feat=feats, node_label=labels,
        num_nodes=NUM_NODES, split_ratio=split, edge_feat=ef,
        device=DEVICE)
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
       split_ratio=MESH_SPLIT if t is not None else None,
       **({} if t is None else dict(
           hot_counts=t.node_features.hot_counts.tolist(),
           hot_bytes=t.node_features.shards.numel() * 4,
           cold_host_bytes=t.node_features.cold_host.numel() * 4,
           cold_host_pinned=bool(t.node_features.cold_host.is_pinned()))),
       edge_shard_shape=None if ef is None else list(ef.shards.shape),
       edge_shard_bytes=0 if ef is None else ef.shards.numel() * 4,
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
  TELEMETRY['seeds_per_sec'] = batches * MESH_BATCH * MESH_PARTS / secs
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


#: the device functions each counted wrapper launches, by wrapper
#: the hetero session, `bench.py:514-597`: the ogbn-mag-scale schema
MAG_PAPER, MAG_AUTHOR, MAG_CLASSES, MAG_DIM = 736_389, 1_134_649, 349, 128
#: each edge type with its average out-degree and the seed of its CSR
#: (`bench.py:538-540`)
MAG_EDGES = ((('paper', 'cites', 'paper'), 7, 1),
             (('author', 'writes', 'paper'), 7, 2),
             (('paper', 'rev_writes', 'author'), 4, 3))
MAG_HUB_FRAC = 0.3
#: `bench.py:562`'s fused session: batch, fanouts, steps of its epoch
HETERO_BATCH = 512
HETERO_FANOUTS = (10, 10)
HETERO_STEPS = 64
HETERO_HIDDEN = 128
HETERO_LR = 1e-3
HETERO_EPOCHS = 2
#: `examples/hetero/train_hgt_mag.py`'s per-batch loader and HGT
HGT_BATCH = 256
HGT_FANOUTS = (4, 4)
HGT_HIDDEN = 64
HGT_HEADS = 2
HGT_STEPS = 20


def bipartite_csr(torch, n_src, n_dst, avg_deg, seed):
  """`benchmarks/common.py:123-148`'s recipe on the card for one edge
  type: uniform sources, targets uniform or (30%) squared-uniform hubs;
  CSR sorted by (row, col)."""
  e = n_src * avg_deg
  g = torch.Generator(device=DEVICE).manual_seed(seed)
  rows = torch.randint(0, n_src, (e,), generator=g, device=DEVICE)
  hub = torch.rand(e, generator=g, device=DEVICE) < MAG_HUB_FRAC
  u = torch.rand(e, generator=g, device=DEVICE)
  cols = torch.where(hub, (u * u * n_dst).long(), (u * n_dst).long())
  del hub, u
  key = torch.sort(rows * n_dst + cols).values
  del cols
  indptr = torch.zeros(n_src + 1, dtype=torch.int64, device=DEVICE)
  indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=n_src), 0)
  return indptr, (key % n_dst).to(torch.int32)


def mag_graph(torch):
  """`bench.py:538-560`'s graph on the card: papers and authors under
  ``cites``, ``writes`` and ``rev_writes``, uniform ``[N, 128]`` f32
  features per type, and learnable paper labels, ``argmax((x - 0.5) @
  P)`` for a random ``P [128, 349]`` (`bench.py`'s are random, which no
  accuracy check can read)."""
  from graphlearn_tpu_torch.data import Dataset
  from graphlearn_tpu_torch.typing import as_str
  t0 = time.perf_counter()
  counts = {'paper': MAG_PAPER, 'author': MAG_AUTHOR}
  edges = {et: bipartite_csr(torch, counts[et[0]], counts[et[2]], deg, s)
           for et, deg, s in MAG_EDGES}
  gen = torch.Generator(device=DEVICE).manual_seed(9)
  feats = {nt: torch.rand(counts[nt], MAG_DIM, generator=gen, device=DEVICE)
           for nt in ('paper', 'author')}
  proj = torch.randn(MAG_DIM, MAG_CLASSES, generator=gen, device=DEVICE)
  labels = torch.argmax((feats['paper'] - 0.5) @ proj, dim=1).to(
      torch.int32)
  ds = (Dataset().init_graph(edges, layout='CSR', num_nodes=counts,
                             device=DEVICE)
        .init_node_features(feats, device=DEVICE)
        .init_node_labels({'paper': labels}))
  sync(torch)
  sizes = torch.bincount(labels.long(), minlength=MAG_CLASSES)
  emit('mag_graph', nodes=counts,
       edges={as_str(et): int(ind.numel()) for et, (_, ind) in edges.items()},
       max_degree={as_str(et): int((ptr[1:] - ptr[:-1]).max())
                   for et, (ptr, _) in edges.items()},
       feature_shapes={nt: list(f.shape) for nt, f in feats.items()},
       classes=MAG_CLASSES, classes_present=int((sizes > 0).sum()),
       largest_class_share=float(sizes.max()) / MAG_PAPER,
       secs=time.perf_counter() - t0,
       bytes={'csr': sum(p.numel() * 8 + i.numel() * 4
                         for p, i in edges.values()),
              'features': sum(f.numel() * 4 for f in feats.values())})
  return ds, feats, labels


def hetero_hops(plan) -> list:
  """The sampler calls of one heterogeneous sample, in order: ``(hop,
  edge type, frontier rows, k)`` for each edge type with a planned
  frontier."""
  out = []
  for h in range(plan.num_hops):
    for et in plan.etypes:
      fan = plan.fanouts[et]
      k = fan[h] if h < len(fan) else 0
      rows = plan.frontier_caps[h].get(et[0], 0)
      if k > 0 and rows > 0:
        out.append((h, et, rows, k))
  return out


def check_hetero_path(torch, ops, timer, rec, hops, feats, what) -> tuple:
  """K1 at every recorded (hop, edge type) call and K2 at every recorded
  type gather of one heterogeneous step against their plain versions;
  each gather must read its type's source table.  Returns the
  records."""
  from graphlearn_tpu_torch.typing import as_str
  hop_recs, gather_recs = [], []
  for (h, et, rows, k), args in zip(hops, rec.hops):
    if args[2].numel() != rows or args[3] != k:
      raise AssertionError(f'{what}: hop {h} {et} sampled {args[2].numel()}'
                           f' rows at k {args[3]}, planned {rows} at {k}')
    _, r = check_sampler(torch, ops, timer, *args)
    r.update(hop=h, etype=as_str(et))
    emit('kernel', kernel='sample_one_hop',
         shape=f'{what} hop {h} {as_str(et)}', **r)
    hop_recs.append(r)
  for (table, ids), nt in zip(rec.gathers, sorted(feats)):
    if table.data_ptr() != feats[nt].data_ptr():
      raise AssertionError(f'{what}: the {nt} gather read another table')
    r = check_gather(torch, ops, timer, table, ids)
    r['ntype'] = nt
    emit('kernel', kernel='gather_rows', shape=f'{what} {nt} x', **r)
    gather_recs.append(r)
  if len(hop_recs) != len(hops) or len(gather_recs) != len(feats):
    raise AssertionError(f'{what}: recorded {len(hop_recs)} K1 and '
                         f'{len(gather_recs)} K2 calls')
  return hop_recs, gather_recs


def check_hetero_batch(torch, batch, feats, labels) -> None:
  """Every valid node's ``x`` row equals its type's source row and every
  paper's label its source label; padded rows zero; valid edges inside
  their types' node counts, masked ones -1."""
  count = {}
  for nt, node in batch.node_dict.items():
    ok = node >= 0
    count[nt] = int(ok.sum())
    if not torch.equal(batch.x_dict[nt][ok], feats[nt][node[ok].long()]):
      raise AssertionError(f'a gathered {nt} x row differs from its source')
    if bool(batch.x_dict[nt][~ok].any()):
      raise AssertionError(f'a padded {nt} slot holds a non-zero row')
  node = batch.node_dict['paper']
  ok = node >= 0
  if not torch.equal(batch.y_dict['paper'][ok], labels[node[ok].long()]):
    raise AssertionError('a gathered label differs from its source label')
  for (a, _, b), ei in batch.edge_index_dict.items():
    em = batch.edge_mask_dict[(a, _, b)]
    if not (bool(((ei[0, em] >= 0) & (ei[0, em] < count[a])).all())
            and bool(((ei[1, em] >= 0) & (ei[1, em] < count[b])).all())
            and bool((ei[:, ~em] == -1).all())):
      raise AssertionError(f'edge_index of {(a, _, b)} outside the tables')


def rgcn_step_flops(plan) -> int:
  """Forward + backward matmul FLOPs of one RGCN step on the padded
  tables: a layer's message matmul on every edge slot of each edge type
  and its self matmul on every table row (backward twice the
  forward)."""
  edges = {}
  for h, et, rows, k in hetero_hops(plan):
    edges[et] = edges.get(et, 0) + rows * k
  rows = sum(plan.table_caps.values())
  dims = [MAG_DIM, HETERO_HIDDEN, MAG_CLASSES]
  fwd = sum(2 * (sum(edges.values()) + rows) * i * o
            for i, o in zip(dims[:-1], dims[1:]))
  return 3 * fwd


def hetero_train(torch, ops, timer, ds, feats, labels, prof=False):
  """`bench.py:517-597`, the hetero session, on the card:
  `FusedHeteroEpoch` with ``RGCN(etypes, 128 -> 128 -> 349, 2 layers,
  target 'paper')`` and Adam(1e-3, capturable), batch 512, fanouts [10,
  10], 64 steps over ``permutation(736,389)[:512 * 64]`` (seed 0) in one
  chunk: a warm epoch (its first step eager, its kernel inputs recorded
  and every K1 and K2 call held against its plain version; then the
  capture) and `HETERO_EPOCHS` timed epochs, `evaluate` on the next 20
  batches of the permutation; one step eagerly and replayed from the
  same state (20 steps each timed); the same under
  `torch.use_deterministic_algorithms`, bitwise."""
  import graphlearn_tpu_torch.sampler.hetero_neighbor_sampler as hmod
  from graphlearn_tpu_torch.loader import FusedHeteroEpoch
  from graphlearn_tpu_torch.models import RGCN
  etypes = tuple(et for et, _, _ in MAG_EDGES)
  idx = np.random.default_rng(0).permutation(MAG_PAPER)
  n_train = HETERO_BATCH * HETERO_STEPS
  train_idx = idx[:n_train]
  test_idx = idx[n_train:n_train + HETERO_BATCH * EVAL_BATCHES]

  def new_model():
    model = RGCN(etypes, MAG_DIM, HETERO_HIDDEN, MAG_CLASSES, num_layers=2,
                 target_ntype='paper').to(DEVICE)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model, torch.optim.Adam(model.parameters(), lr=HETERO_LR,
                                   eps=1e-8, capturable=True)
  model, opt = new_model()
  fused = FusedHeteroEpoch(ds, HETERO_FANOUTS, ('paper', train_idx), model,
                           opt, batch_size=HETERO_BATCH, shuffle=True,
                           seed=0, max_steps_per_program=HETERO_STEPS,
                           device=DEVICE)
  plan = fused._plan
  hops = hetero_hops(plan)
  k1, k2 = len(hops), len(feats)
  steps = len(fused)
  reset_counts(ops)
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  with TrainRecorder(torch, hmod, k2, hops=k1) as rec:
    warm = fused.run().losses.cpu().numpy()
  warm_secs = time.perf_counter() - t0
  peak_gb = torch.cuda.max_memory_allocated() / 1e9
  check_replay_counts(ops, 'hetero warm epoch', steps, k1, k2)
  hop_recs, gather_recs = check_hetero_path(torch, ops, timer, rec, hops,
                                            feats, 'hetero fused')
  del rec
  reset_counts(ops)
  runs, epoch_losses = [], []
  for _ in range(HETERO_EPOCHS):
    sync(torch)
    t = time.perf_counter()
    stats = fused.run()
    sync(torch)
    runs.append(time.perf_counter() - t)
    epoch_losses.append(stats.losses.cpu().numpy())
  launches = check_replay_counts(ops, 'hetero epochs',
                                 steps * HETERO_EPOCHS, k1, k2)
  means = [float(warm.mean())] + [float(x.mean()) for x in epoch_losses]
  if not (np.isfinite(np.concatenate([warm] + epoch_losses)).all()
          and means[-1] < means[0]):
    raise AssertionError(f'hetero losses do not fall: {means}')
  acc = fused.evaluate(test_idx)
  if not acc > 1 / MAG_CLASSES:
    raise AssertionError(f'hetero eval accuracy {acc}')
  if fused.compile_count() != 2:
    raise AssertionError(f'{fused.compile_count()} captures, not 2')

  # one step eagerly and replayed from the same state, then both timed
  same, diff = eager_vs_replay(torch, fused)
  graph = fused._replays['train']
  seeds, coords = graph.seeds.clone(), graph.coords.clone()
  ctuple = tuple(coords.unbind(0))
  step = {'replay_max_abs_diff_to_eager': diff, 'bitwise_equal': same,
          'eager_ms': step_ms(torch, lambda: fused._train_step(seeds, ctuple),
                              STEP_COMPARE),
          'replayed_ms': step_ms(torch, lambda: graph.replay(seeds, coords),
                                 STEP_COMPARE),
          'steps_timed': STEP_COMPARE}
  if prof:
    step['idle'] = {
        'eager': device_idle(torch, lambda: fused._train_step(
            seeds, ctuple)[0], 5),
        'replayed': device_idle(torch, lambda: graph.replay(
            seeds, coords)[0], 5)}
    check_traced(profile_train(torch, lambda: graph.replay(seeds, coords)[0],
                               'hetero replayed', n=PROFILE_STEPS),
                 'hetero replayed', PROFILE_STEPS, k1, k2)
    step['traced_launches_checked'] = True

  # the same comparison with deterministic scatter-adds: a one-step epoch
  # captured under `torch.use_deterministic_algorithms`, bitwise
  torch.use_deterministic_algorithms(True, warn_only=True)
  try:
    det_model, det_opt = new_model()
    det = FusedHeteroEpoch(ds, HETERO_FANOUTS,
                           ('paper', train_idx[:HETERO_BATCH]), det_model,
                           det_opt, batch_size=HETERO_BATCH, seed=1,
                           device=DEVICE)
    det.run()
    det_same, det_diff = eager_vs_replay(torch, det)
  finally:
    torch.use_deterministic_algorithms(False)
  if not det_same:
    raise AssertionError(f'a replayed hetero step differs from the eager '
                         f'step under deterministic algorithms (max abs '
                         f'diff {det_diff})')
  step['deterministic'] = {'replay_bitwise_equal_to_eager': True,
                           'max_abs_diff': det_diff}
  del det, det_model, det_opt
  secs = float(np.median(runs))
  flops = rgcn_step_flops(plan)
  emit('hetero_train', batch=HETERO_BATCH, fanouts=list(HETERO_FANOUTS),
       model=f'RGCN({MAG_DIM}->{HETERO_HIDDEN}->{MAG_CLASSES}, 2 layers, '
             f'target paper)',
       optimizer=f'Adam({HETERO_LR}, capturable)',
       max_steps_per_program=HETERO_STEPS, steps_per_epoch=steps,
       table_caps=plan.table_caps,
       sampler_calls=[{'hop': h, 'etype': '__'.join(et), 'rows': r, 'k': k}
                      for h, et, r, k in hops],
       warm_secs=warm_secs, epochs=HETERO_EPOCHS, epoch_secs_runs=runs,
       epoch_secs=secs, step_ms=secs / steps * 1e3,
       train_seeds_per_s=n_train / secs, step=step,
       rgcn_step_flops=flops, tflops=flops * steps / secs / 1e12,
       peak_gb=peak_gb, epoch_mean_losses=means, eval_accuracy=acc,
       eval_seeds=len(test_idx), captures=fused.compile_count(),
       launches=launches, plain_calls=0)
  return launches, hop_recs, gather_recs


def hetero_loader(torch, ops, timer, ds, feats, labels):
  """`examples/hetero/train_hgt_mag.py`'s per-batch path at its widths:
  `NeighborLoader(ds, [4, 4], ('paper', train_idx), batch_size=256)`
  with ``HGT(hidden 64, heads 2, 2 layers, out 349, target 'paper')``
  and Adam(1e-3), `HGT_STEPS` steps, each split into sample / collate /
  model by synchronising; the first step's kernel inputs recorded and
  every K1 and K2 call held against its plain version."""
  import graphlearn_tpu_torch.sampler.hetero_neighbor_sampler as hmod
  from graphlearn_tpu_torch.loader import NeighborLoader
  from graphlearn_tpu_torch.models import HGT, make_hetero_supervised_step
  from graphlearn_tpu_torch.sampler import NodeSamplerInput
  idx = np.random.default_rng(1).permutation(MAG_PAPER)
  train_idx = idx[:int(MAG_PAPER * 0.8)]
  loader = NeighborLoader(ds, HGT_FANOUTS, ('paper', train_idx),
                          batch_size=HGT_BATCH, shuffle=True, seed=0,
                          device=DEVICE)
  sampler = loader.sampler
  hops = hetero_hops(sampler.plan({'paper': HGT_BATCH}))
  etypes = tuple(sorted(et for et, _, _ in MAG_EDGES))
  model = HGT(('author', 'paper'), etypes, MAG_DIM, HGT_HIDDEN, MAG_CLASSES,
              num_layers=2, heads=HGT_HEADS, target_ntype='paper').to(DEVICE)
  model.reset_parameters(torch.Generator().manual_seed(2))
  step = make_hetero_supervised_step(
      model, torch.optim.Adam(model.parameters(), lr=1e-3, eps=1e-8),
      HGT_BATCH, 'paper')
  parts = {'sample': [], 'collate': [], 'model': []}
  losses = []
  seed_it = iter(loader._batcher)
  reset_counts(ops)
  with TrainRecorder(torch, hmod, len(feats), hops=len(hops)) as rec:
    for _ in range(HGT_STEPS):
      seeds = next(seed_it)
      sync(torch)
      t0 = time.perf_counter()
      out = sampler.sample_from_nodes(NodeSamplerInput(node=seeds,
                                                       input_type='paper'))
      sync(torch)
      t1 = time.perf_counter()
      batch = loader._collate_fn(out)
      sync(torch)
      t2 = time.perf_counter()
      losses.append(step(batch)[0])
      sync(torch)
      t3 = time.perf_counter()
      for key, a, z in (('sample', t0, t1), ('collate', t1, t2),
                        ('model', t2, t3)):
        parts[key].append((z - a) * 1e3)
  launches, plain = read_counts(ops)
  if not (launches['sample_one_hop'] == len(hops) * HGT_STEPS
          and launches['gather_rows'] == len(feats) * HGT_STEPS
          and launches['sample_one_hop_gns'] == 0 and plain == 0):
    raise AssertionError(f'hetero loader: launch counts {launches}, plain '
                         f'calls {plain}, want {len(hops)} K1 and '
                         f'{len(feats)} K2 a step')
  check_hetero_batch(torch, batch, feats, labels)
  losses = torch.stack(losses).cpu().numpy()
  if not np.isfinite(losses).all():
    raise AssertionError(f'hetero loader losses {losses}')
  hop_recs, gather_recs = check_hetero_path(torch, ops, timer, rec, hops,
                                            feats, 'hetero loader')
  del rec, batch, out
  med = {k: float(np.median(v)) for k, v in parts.items()}
  emit('hetero_loader', batch=HGT_BATCH, fanouts=list(HGT_FANOUTS),
       model=f'HGT({MAG_DIM}->{HGT_HIDDEN}->{MAG_CLASSES}, 2 layers, '
             f'{HGT_HEADS} heads, target paper)', optimizer='Adam(0.001)',
       steps=HGT_STEPS, step_ms=sum(med.values()),
       step_ms_by_part={'median': med, 'all': parts},
       losses=[float(x) for x in losses], launches=launches,
       plain_calls=plain, x_rows_byte_equal=True, y_byte_equal=True)
  return launches, hop_recs, gather_recs


def hetero_cross_check(torch):
  """A small three-type graph (papers, authors, institutions under five
  edge types) on the card and on the CPU: 3 `FusedHeteroEpoch` RGCN
  steps with the default counter draws (the same values on both
  devices), captured on the card and eager on the CPU, losses within
  1e-5; then each step's sample, taken again from the same seeds and
  coordinates, equal on both (tables, counts, COO, masks)."""
  from graphlearn_tpu_torch.data import Dataset
  from graphlearn_tpu_torch.loader import FusedHeteroEpoch
  from graphlearn_tpu_torch.models import RGCN
  rng = np.random.default_rng(14)
  n = {'paper': 3000, 'author': 2000, 'institution': 100}
  crow = np.concatenate([np.repeat(np.arange(n['paper']), 6),
                         np.full(200, 11)])        # a hub past the window
  ccol = np.where(rng.random(crow.shape[0]) < 0.3,
                  rng.integers(0, 50, crow.shape[0]),
                  rng.integers(0, n['paper'], crow.shape[0]))
  wrow = np.repeat(np.arange(n['author']), 3)
  wcol = rng.integers(0, n['paper'] - 100, wrow.shape[0])
  arow = np.arange(n['author'])
  acol = rng.integers(0, n['institution'], n['author'])
  edges = {('paper', 'cites', 'paper'): (crow, ccol),
           ('author', 'writes', 'paper'): (wrow, wcol),
           ('paper', 'rev_writes', 'author'): (wcol, wrow),
           ('author', 'affiliated_with', 'institution'): (arow, acol),
           ('institution', 'rev_affiliated_with', 'author'): (acol, arow)}
  feats = {nt: rng.standard_normal((c, 16)).astype(np.float32)
           for nt, c in n.items()}
  labels = rng.integers(0, 7, n['paper']).astype(np.int32)
  batch, fan = 64, [4, 3]
  seeds = np.arange(3 * batch).reshape(3, batch).astype(np.int32)
  losses, samples = {}, {}
  for dev in (DEVICE, 'cpu'):
    ds = (Dataset().init_graph(edges, num_nodes=n, device=dev)
          .init_node_features(feats, device=dev)
          .init_node_labels({'paper': labels}))
    model = RGCN(sorted(edges), 16, 32, 7, num_layers=2,
                 target_ntype='paper').to(dev)
    model.reset_parameters(torch.Generator().manual_seed(6))
    opt = torch.optim.Adam(model.parameters(), lr=HETERO_LR, eps=1e-8,
                           capturable=dev != 'cpu')
    fused = FusedHeteroEpoch(ds, fan, ('paper', seeds.reshape(-1)), model,
                             opt, batch_size=batch, shuffle=False, seed=2,
                             device=dev)
    losses[dev] = fused.run().losses.cpu().numpy()
    if dev != 'cpu' and fused.compile_count() != 1:
      raise AssertionError('the card did not capture the hetero step')
    samples[dev] = []
    for i in range(3):
      out = fused._sample(torch.from_numpy(seeds[i]).to(dev),
                          fused._step_draws((1, None, i)))
      node, count, row, col, emask = out[:5]
      samples[dev].append(
          [t.cpu() for d in (node, count, row, col, emask)
           for _, t in sorted(d.items())])
  for i, (a, c) in enumerate(zip(samples[DEVICE], samples['cpu'])):
    if len(a) != len(c) or not all(x.dtype == y.dtype and torch.equal(x, y)
                                   for x, y in zip(a, c)):
      raise AssertionError(f'card and CPU sampled differently: step {i}')
  diff = float(np.abs(losses[DEVICE] - losses['cpu']).max())
  if not (diff <= 1e-5 and len(losses['cpu']) == 3):
    raise AssertionError(f'hetero losses differ by {diff}')
  emit('hetero_cross_check', nodes=n, steps=3, loss_max_abs_diff=diff,
       samples_equal=True, card_captured=True)


def hetero_phases(torch, ops, timer, prof=False) -> tuple:
  """The heterogeneous phases (`mag_graph`, `hetero_train`,
  `hetero_loader`, `hetero_cross_check`); the graph is freed after."""
  ds, feats, labels = mag_graph(torch)
  train = hetero_train(torch, ops, timer, ds, feats, labels, prof=prof)
  loader = hetero_loader(torch, ops, timer, ds, feats, labels)
  del ds, feats, labels
  torch.cuda.empty_cache()
  hetero_cross_check(torch)
  return train, loader


#: `examples/unsup_sage_ppi.py` at PPI's published size: 56,944 nodes,
#: 50 features, 121 label sets as clusters; degree 14 gives 797,216
#: edges (PPI: 818,716)
PPI_NODES, PPI_DEG, PPI_CLASSES, PPI_DIM = 56_944, 14, 121, 50
LINK_BATCH = 512
LINK_FANOUTS = (10, 10)
LINK_HIDDEN = 64
LINK_LR = 3e-3
#: per-batch steps and fused-epoch steps (cut: depth; an epoch is 1,558)
LINK_STEPS = 200
LINK_EVAL_BATCHES = 20
#: `link_loader`'s seed edges of the products graph
PRODUCTS_LINK_BATCH = 1024
PRODUCTS_BINARY_BATCHES = 20
PRODUCTS_TRIPLET_BATCHES = 10
#: `examples/seal_link_pred.py` at Cora's published size (2,708 nodes, 7
#: classes as clusters) at the example's degree 6
SEAL_NODES, SEAL_CLUSTERS, SEAL_DEG = 2708, 7, 6
SEAL_LINKS = 256
SEAL_FANOUTS = (8,)
SEAL_EPOCHS = 3
SEAL_HIDDEN, SEAL_MAX_LABEL, SEAL_K = 32, 16, 30
SEAL_LR = 1e-3
#: products edges (and as many random non-edges) extracted at scale
SEAL_SCALE_LINKS = 256
NEG_TRIALS = 5


def clustered_graph(n=8192, deg=8, classes=8, d=32, intra_p=0.7,
                    feat_signal=1.0, noise_std=0.5, seed=0):
  """`examples/_synthetic.py::clustered_graph`, copied: ``(rows, cols,
  feats, labels)`` of a label-clustered COO graph (an edge stays inside
  its source's class with probability ``intra_p``) whose features carry
  a faint class direction in noise."""
  rng = np.random.default_rng(seed)
  labels = rng.integers(0, classes, n).astype(np.int32)
  rows = np.repeat(np.arange(n), deg)
  order = np.argsort(labels, kind='stable')
  ptr = np.searchsorted(labels[order], np.arange(classes + 1))
  intra = np.empty(n * deg, dtype=np.int64)
  for c in range(classes):
    m = labels[rows] == c
    intra[m] = order[rng.integers(ptr[c], ptr[c + 1], m.sum())]
  cols = np.where(rng.random(n * deg) < intra_p, intra,
                  rng.integers(0, n, n * deg))
  proto = rng.normal(0, 1, (classes, d)).astype(np.float32)
  feats = (feat_signal * proto[labels]
           + rng.normal(0, noise_std, (n, d)).astype(np.float32))
  return rows, cols, feats, labels


def seal_graph(n=600, clusters=6, deg=6, seed=0):
  """`examples/seal_link_pred.py::synthetic`, copied: ``(rows, cols,
  clusters)`` of a graph whose edges stay inside their source's
  cluster."""
  rng = np.random.default_rng(seed)
  cl = rng.integers(0, clusters, n)
  rows = np.repeat(np.arange(n), deg)
  order = np.argsort(cl, kind='stable')
  ptr = np.searchsorted(cl[order], np.arange(clusters + 1))
  cols = np.empty(n * deg, dtype=np.int64)
  for c in range(clusters):
    m = cl[rows] == c
    cols[m] = order[rng.integers(ptr[c], ptr[c + 1], m.sum())]
  return rows, cols, cl


def drnl(nodes_valid, edge_index, edge_mask, s0, s1):
  """`examples/seal_link_pred.py::drnl`, copied: Double-Radius Node
  Labeling of one induced subgraph on the host (BFS from both
  endpoints; unreachable nodes 0, the endpoints 1)."""
  nloc = len(nodes_valid)
  adj = [[] for _ in range(nloc)]
  for r, c in zip(edge_index[0][edge_mask], edge_index[1][edge_mask]):
    adj[int(r)].append(int(c))
    adj[int(c)].append(int(r))

  def bfs(src):
    dist = np.full(nloc, -1, np.int32)
    dist[src] = 0
    q = [src]
    while q:
      nxt = []
      for u in q:
        for w in adj[u]:
          if dist[w] < 0:
            dist[w] = dist[u] + 1
            nxt.append(w)
      q = nxt
    return dist

  d0, d1 = bfs(s0), bfs(s1)
  lab = np.zeros(nloc, np.int32)
  ok = (d0 >= 0) & (d1 >= 0) & nodes_valid
  d = d0 + d1
  dmin = np.minimum(d0, d1)
  lab[ok] = 1 + dmin[ok] + (d[ok] // 2) * ((d[ok] // 2) + (d[ok] % 2) - 1)
  lab[s0] = lab[s1] = 1
  return lab


def seal_model(torch):
  """SEAL's classifier (`examples/seal_link_pred.py`'s ``SealDGCNN``) on
  the port's modules: ``Embedding(16, 32)`` over the clipped DRNL labels,
  then ``DGCNN(32, 2 classes, 3 layers, k)``; parameters from a seeded
  CPU generator."""
  from torch import nn
  from graphlearn_tpu_torch.models import DGCNN

  class Seal(nn.Module):
    def __init__(self):
      super().__init__()
      self.embed = nn.Embedding(SEAL_MAX_LABEL, SEAL_HIDDEN)
      self.dgcnn = DGCNN(SEAL_HIDDEN, SEAL_HIDDEN, 2, num_layers=3,
                         k=SEAL_K)

    def forward(self, lab, edge_index, edge_mask, node_mask):
      x = self.embed(lab.long().clamp(0, SEAL_MAX_LABEL - 1))
      return self.dgcnn(x, edge_index, edge_mask, node_mask)

  with torch.random.fork_rng(devices=[]):
    torch.manual_seed(0)
    return Seal()


def edge_lookup(indptr_h: np.ndarray, indices_h: np.ndarray):
  """A host membership test of (row, col) pairs in a CSR sorted by
  (row, col): a binary search of ``row * N + col`` in the edges' keys,
  independent of the port's `edge_in_csr`."""
  n = indptr_h.shape[0] - 1
  keys = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr_h)) * n \
      + indices_h.astype(np.int64)

  def is_edge(r, c):
    r, c = np.asarray(r, np.int64), np.asarray(c, np.int64)
    q = r * n + c
    at = np.minimum(np.searchsorted(keys, q), keys.shape[0] - 1)
    return (r >= 0) & (c >= 0) & (keys[at] == q)
  return is_edge


def strict_picks(is_edge, rows, cands):
  """JAX's strict rule on the host: the trial each slot of ``[trials,
  R]`` candidates keeps (its first that is not an edge from its row,
  else the last), and whether every trial was an edge."""
  trials = cands.shape[0]
  edge = np.stack([is_edge(rows[t], cands[t]) for t in range(trials)])
  pick = np.where((~edge).any(axis=0), np.argmax(~edge, axis=0), trials - 1)
  return pick, edge.all(axis=0)


def check_link_x(torch, batch, feats) -> None:
  """Every valid node's ``x`` row equals its source row, padded rows are
  zero, valid edges stay inside the node count."""
  node = batch.node
  ok = node >= 0
  if not torch.equal(batch.x[ok], feats[node[ok].long()]):
    raise AssertionError('a gathered x row differs from its source row')
  if bool(batch.x[~ok].any()):
    raise AssertionError('a padded node slot holds a non-zero row')
  count = int(ok.sum())
  ei, em = batch.edge_index, batch.edge_mask
  if not (bool(((ei[:, em] >= 0) & (ei[:, em] < count)).all())
          and bool((ei[:, ~em] == -1).all())):
    raise AssertionError('edge_index outside the node count')


def check_link_metadata(torch, node, seeds, md, src, dst, b) -> dict:
  """A link batch's label indices map back, through ``node``, to its
  seeds: the positive pairs to ``(src, dst)`` and the negative slots to
  the negative seeds; returns the negatives ``{'rows', 'cols'}`` (binary)
  or ``{'dst'}`` (triplet) on the host."""
  src = torch.from_numpy(np.asarray(src)).to(node.device)
  dst = torch.from_numpy(np.asarray(dst)).to(node.device)
  if not (torch.equal(seeds[:b], src) and torch.equal(seeds[b:2 * b], dst)):
    raise AssertionError('the seeds do not start with the seed edges')

  def through(local):
    return torch.where(local >= 0, node[local.long().clamp(min=0)], -1)
  if 'edge_label_index' in md:
    eli, em = md['edge_label_index'], md['edge_label_mask']
    nn_ = (seeds.shape[0] - 2 * b) // 2
    want = torch.stack([torch.cat([seeds[:b], seeds[2 * b:2 * b + nn_]]),
                        torch.cat([seeds[b:2 * b], seeds[2 * b + nn_:]])])
    got = through(eli)
    if not (bool((got[:, em] == want[:, em]).all())
            and bool(em[b:].all()) and bool((eli[:, em] >= 0).all())):
      raise AssertionError('edge_label_index does not map to the seeds')
    return {'rows': seeds[2 * b:2 * b + nn_].cpu().numpy(),
            'cols': seeds[2 * b + nn_:].cpu().numpy()}
  si, dp, dn = md['src_index'], md['dst_pos_index'], md['dst_neg_index']
  ok = md['pair_mask']
  negs = seeds[2 * b:].reshape(b, -1)
  if not (bool((through(si)[ok] == src[ok]).all())
          and bool((through(dp)[ok] == dst[ok]).all())
          and bool((through(dn) == negs).all())):
    raise AssertionError('the triplet indices do not map to the seeds')
  return {'dst': negs.cpu().numpy()}


def link_train(torch, ops, timer, prof=False):
  """BASELINE config 2, `examples/unsup_sage_ppi.py` at PPI's published
  size: the `clustered_graph` stand-in on the card, `LinkNeighborLoader
  ([10, 10], batch 512, NegativeSampling('binary', 1.0), shuffled)` ->
  `make_unsupervised_step` with ``GraphSAGE(50 -> 64 -> 64, 2 layers)``
  and Adam(3e-3): `LINK_STEPS` steps split into sample / collate / model
  (the first one's kernel inputs recorded); then `FusedLinkEpoch` over
  `LINK_STEPS` x 512 edges (Adam capturable): a warm epoch (its first
  step eager and recorded, then the capture) and a timed one, one step
  eagerly and replayed from the same state, the same under
  deterministic algorithms bitwise, `evaluate` on held-out edges; the
  example's cluster-pair AUC of the per-batch model's embeddings."""
  import graphlearn_tpu_torch.sampler.neighbor_sampler as smod
  from graphlearn_tpu_torch.data import Dataset
  from graphlearn_tpu_torch.loader import (FusedLinkEpoch, LinkNeighborLoader,
                                           NeighborLoader)
  from graphlearn_tpu_torch.models import GraphSAGE, make_unsupervised_step
  from graphlearn_tpu_torch.sampler import EdgeSamplerInput, NegativeSampling
  t0 = time.perf_counter()
  rows, cols, feats_h, cl = clustered_graph(
      n=PPI_NODES, deg=PPI_DEG, classes=PPI_CLASSES, d=PPI_DIM, intra_p=0.8,
      feat_signal=0.5, noise_std=1.0)
  n = PPI_NODES
  ds = (Dataset().init_graph((rows, cols), num_nodes=n, device=DEVICE)
        .init_node_features(feats_h, device=DEVICE))
  feats = torch.from_numpy(feats_h).to(DEVICE)
  sync(torch)
  graph_secs = time.perf_counter() - t0
  neg = NegativeSampling('binary', 1.0)

  def new_model(seed, capturable=False):
    model = GraphSAGE(PPI_DIM, LINK_HIDDEN, LINK_HIDDEN,
                      num_layers=2).to(DEVICE)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model, torch.optim.Adam(model.parameters(), lr=LINK_LR, eps=1e-8,
                                   capturable=capturable)

  # -- the per-batch path ----------------------------------------------------
  loader = LinkNeighborLoader(ds, LINK_FANOUTS, (rows, cols),
                              neg_sampling=neg, batch_size=LINK_BATCH,
                              shuffle=True, seed=0, device=DEVICE)
  sampler = loader.sampler
  model, opt = new_model(0)
  step = make_unsupervised_step(model, opt)
  parts = {'sample': [], 'collate': [], 'model': []}
  losses = []
  seed_it = iter(loader._batcher)
  reset_counts(ops)
  with TrainRecorder(torch, smod, 1, hops=len(LINK_FANOUTS)) as rec:
    for i in range(LINK_STEPS):
      r, c, _ = next(seed_it)
      sync(torch)
      t0 = time.perf_counter()
      out = sampler.sample_from_edges(EdgeSamplerInput(r, c,
                                                       neg_sampling=neg))
      sync(torch)
      t1 = time.perf_counter()
      batch = loader._collate_fn(out)
      sync(torch)
      t2 = time.perf_counter()
      losses.append(step(batch))
      sync(torch)
      t3 = time.perf_counter()
      for key, a, z in (('sample', t0, t1), ('collate', t1, t2),
                        ('model', t2, t3)):
        parts[key].append((z - a) * 1e3)
      if i == 0:
        check_link_x(torch, batch, feats)
        check_link_metadata(torch, batch.node, batch.batch, batch.metadata,
                            r, c, LINK_BATCH)
        endpoints = int(batch.batch.numel())
  launches, plain = read_counts(ops)
  k1 = len(LINK_FANOUTS)
  if not (launches['sample_one_hop'] == k1 * LINK_STEPS
          and launches['gather_rows'] == LINK_STEPS
          and launches['sample_one_hop_gns'] == 0 and plain == 0):
    raise AssertionError(f'link loader: launches {launches}, plain calls '
                         f'{plain}, want {k1} K1 and 1 K2 a step')
  losses = torch.stack(losses).cpu().numpy()
  early, late = float(losses[:20].mean()), float(losses[-20:].mean())
  if not (np.isfinite(losses).all() and late < early):
    raise AssertionError(f'link losses do not fall: {early} -> {late}')
  if prof:
    seed_it = iter(loader._batcher)
    check_traced(profile_train(torch, lambda: step(loader._collate_fn(
        sampler.sample_from_edges(EdgeSamplerInput(
            *next(seed_it)[:2], neg_sampling=neg)))), 'link per-batch',
        n=PROFILE_STEPS), 'link per-batch', PROFILE_STEPS, k1, 1)
  per_batch_hops = [check_sampler(torch, ops, timer, *a)[1]
                    for a in rec.hops]
  per_batch_gather = check_gather(torch, ops, timer, *rec.gathers[0])
  for h, r in enumerate(per_batch_hops):
    emit('kernel', kernel='sample_one_hop',
         shape=f'PPI link batch (per-batch) hop {h}', **r)
  emit('kernel', kernel='gather_rows', shape='PPI link batch (per-batch) x',
       **per_batch_gather)
  del rec, batch, out

  # -- the example's evaluation: cluster-pair AUC of the embeddings ----------
  emb = torch.zeros(n, LINK_HIDDEN, device=DEVICE)
  model.eval()
  with torch.no_grad():
    for b in NeighborLoader(ds, LINK_FANOUTS, np.arange(n),
                            batch_size=LINK_BATCH, device=DEVICE):
      e = model(b.x, b.edge_index, b.edge_mask)
      ok = b.batch >= 0
      emb[b.batch[ok].long()] = e[b.metadata['seed_local'][ok].long()]
  emb = emb.cpu().numpy()
  rng = np.random.default_rng(1)
  a = rng.integers(0, n, 4000)
  pos = np.array([rng.choice(np.nonzero(cl == cl[i])[0]) for i in a[:500]])
  negs = rng.integers(0, n, 500)
  pos_s = (emb[a[:500]] * emb[pos]).sum(1)
  neg_s = (emb[a[:500]] * emb[negs]).sum(1)
  auc = float((pos_s[:, None] > neg_s[None, :]).mean())
  if not auc > 0.5:
    raise AssertionError(f'cluster-pair AUC {auc}')

  # -- FusedLinkEpoch ---------------------------------------------------------
  perm = np.random.default_rng(0).permutation(rows.shape[0])
  n_train = LINK_BATCH * LINK_STEPS
  train_edges = (rows[perm[:n_train]], cols[perm[:n_train]])
  held = perm[n_train:n_train + LINK_BATCH * LINK_EVAL_BATCHES]
  fmodel, fopt = new_model(1, capturable=True)
  fused = FusedLinkEpoch(ds, LINK_FANOUTS, train_edges, fmodel, fopt,
                         LINK_BATCH, neg_sampling=neg, shuffle=True, seed=0,
                         max_steps_per_program=LINK_STEPS, device=DEVICE)
  steps = len(fused)
  reset_counts(ops)
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  with TrainRecorder(torch, smod, 1, hops=k1) as frec:
    warm = fused.run().losses.cpu().numpy()
  warm_secs = time.perf_counter() - t0
  check_replay_counts(ops, 'link warm epoch', steps, k1, 1)
  reset_counts(ops)
  sync(torch)
  t0 = time.perf_counter()
  stats = fused.run()
  sync(torch)
  epoch_secs = time.perf_counter() - t0
  peak_gb = torch.cuda.max_memory_allocated() / 1e9
  fused_launches = check_replay_counts(ops, 'link epoch', steps, k1, 1)
  timed = stats.losses.cpu().numpy()
  means = [float(warm.mean()), float(timed.mean())]
  if not (np.isfinite(np.concatenate([warm, timed])).all()
          and means[1] < means[0] and stats.seeds == n_train):
    raise AssertionError(f'fused link losses do not fall: {means}')
  fused_auc = fused.evaluate((rows[held], cols[held]))
  if not fused_auc > 0.5:
    raise AssertionError(f'FusedLinkEpoch held-out AUC {fused_auc}')
  if fused.compile_count() != 2:
    raise AssertionError(f'{fused.compile_count()} captures, not 2')
  fused_hops = [check_sampler(torch, ops, timer, *a)[1] for a in frec.hops]
  fused_gather = check_gather(torch, ops, timer, *frec.gathers[0])
  for h, r in enumerate(fused_hops):
    emit('kernel', kernel='sample_one_hop',
         shape=f'PPI FusedLinkEpoch step hop {h}', **r)
  emit('kernel', kernel='gather_rows', shape='PPI FusedLinkEpoch step x',
       **fused_gather)
  del frec

  same, diff = eager_vs_replay(torch, fused)
  graph = fused._replays['train']
  seeds, coords = graph.seeds.clone(), graph.coords.clone()
  ctuple = tuple(coords.unbind(0))
  step_rec = {
      'replay_max_abs_diff_to_eager': diff, 'bitwise_equal': same,
      'eager_ms': step_ms(torch, lambda: fused._train_step(seeds, ctuple),
                          STEP_COMPARE),
      'replayed_ms': step_ms(torch, lambda: graph.replay(seeds, coords),
                             STEP_COMPARE),
      'steps_timed': STEP_COMPARE,
      'idle': {'eager': device_idle(torch, lambda: fused._train_step(
                   seeds, ctuple)[0], 5),
               'replayed': device_idle(torch, lambda: graph.replay(
                   seeds, coords)[0], 5)}}
  if prof:
    check_traced(profile_train(torch, lambda: graph.replay(seeds, coords)[0],
                               'link replayed', n=PROFILE_STEPS),
                 'link replayed', PROFILE_STEPS, k1, 1)
    step_rec['traced_launches_checked'] = True
  torch.use_deterministic_algorithms(True, warn_only=True)
  try:
    dmodel, dopt = new_model(2, capturable=True)
    det = FusedLinkEpoch(ds, LINK_FANOUTS,
                         (train_edges[0][:LINK_BATCH],
                          train_edges[1][:LINK_BATCH]), dmodel, dopt,
                         LINK_BATCH, neg_sampling=neg, seed=1, device=DEVICE)
    det.run()
    det_same, det_diff = eager_vs_replay(torch, det)
  finally:
    torch.use_deterministic_algorithms(False)
  if not det_same:
    raise AssertionError(f'a replayed link step differs from the eager step '
                         f'under deterministic algorithms ({det_diff})')
  step_rec['deterministic'] = {'replay_bitwise_equal_to_eager': True,
                               'max_abs_diff': det_diff}
  del det, dmodel, dopt
  med = {k: float(np.median(v)) for k, v in parts.items()}
  emit('link_train', graph={'nodes': n, 'edges': int(rows.shape[0]),
                            'features': PPI_DIM, 'clusters': PPI_CLASSES,
                            'secs': graph_secs},
       batch=LINK_BATCH, fanouts=list(LINK_FANOUTS),
       negative_sampling='binary 1.0', endpoints_per_batch=endpoints,
       model=f'GraphSAGE({PPI_DIM}->{LINK_HIDDEN}->{LINK_HIDDEN}, 2 layers)',
       optimizer=f'Adam({LINK_LR})',
       per_batch={'steps': LINK_STEPS, 'step_ms': sum(med.values()),
                  'step_ms_by_part': {'median': med},
                  'loss_first_20': early, 'loss_last_20': late,
                  'launches': launches, 'plain_calls': plain,
                  'cluster_pair_auc': auc},
       fused={'steps_per_epoch': steps, 'warm_secs': warm_secs,
              'epoch_secs': epoch_secs,
              'edges_per_s': n_train / epoch_secs, 'peak_gb': peak_gb,
              'epoch_mean_losses': means, 'held_out_auc': fused_auc,
              'held_out_edges': int(held.shape[0]),
              'captures': fused.compile_count(), 'step': step_rec,
              'launches': fused_launches, 'plain_calls': 0})
  return {'launches': {'per_batch': launches, 'fused': fused_launches},
          'hops': per_batch_hops + fused_hops,
          'gathers': [per_batch_gather, fused_gather],
          'shape_hops': {'per_batch': per_batch_hops, 'fused': fused_hops}}


def link_loader(torch, ops, timer, indptr, indices, feats, is_edge):
  """`LinkNeighborLoader` on the products graph at [15, 10, 5]:
  `PRODUCTS_BINARY_BATCHES` binary batches of 1,024 random products
  edges, then `PRODUCTS_TRIPLET_BATCHES` triplet batches at amount 2;
  batches/s; every batch's metadata mapped back to its seeds through
  ``node``, and every negative held to JAX's strict rule on the host
  (its candidates replayed from the sampler's draws: the first that is
  not an edge, else the last); the first binary batch's K1 and K2 calls
  against their plain versions."""
  import graphlearn_tpu_torch.sampler.neighbor_sampler as smod
  from graphlearn_tpu_torch.data import Dataset
  from graphlearn_tpu_torch.loader import LinkNeighborLoader
  from graphlearn_tpu_torch.sampler import NegativeSampling
  ds = (Dataset().init_graph((indptr, indices), layout='CSR',
                             num_nodes=NUM_NODES, device=DEVICE)
        .init_node_features(feats, device=DEVICE))
  b = PRODUCTS_LINK_BATCH
  out, recs = {}, None
  for mode, amount, nb, seed in (('binary', 1.0, PRODUCTS_BINARY_BATCHES, 21),
                                 ('triplet', 2, PRODUCTS_TRIPLET_BATCHES,
                                  22)):
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    pos = torch.randint(0, indices.numel(), (nb * b,), generator=g,
                        device=DEVICE)
    src = (torch.searchsorted(indptr, pos, right=True) - 1).cpu().numpy()
    dst = indices[pos].cpu().numpy()
    loader = LinkNeighborLoader(ds, FANOUTS, (src, dst),
                                neg_sampling=NegativeSampling(mode, amount),
                                batch_size=b, seed=seed, device=DEVICE)
    kept = []
    reset_counts(ops)
    sync(torch)
    t0 = time.perf_counter()
    it = iter(loader)
    if recs is None:
      with TrainRecorder(torch, smod, 1) as recs:
        first = next(it)
    else:
      first = next(it)
    for bt in itertools.chain([first], it):
      kept.append((bt.node, bt.batch, bt.metadata))
      del bt
    sync(torch)
    secs = time.perf_counter() - t0
    launches, plain = read_counts(ops)
    if not (launches['sample_one_hop'] == len(FANOUTS) * nb
            and launches['gather_rows'] == nb and plain == 0):
      raise AssertionError(f'link loader ({mode}): launches {launches}, '
                           f'plain calls {plain}')
    check_link_x(torch, first, feats)
    endpoints, node_cap = int(first.batch.numel()), int(first.node.numel())
    del first
    rejected = fallbacks = 0
    for i, (node, seeds, md) in enumerate(kept):
      r, c = src[i * b:(i + 1) * b], dst[i * b:(i + 1) * b]
      negs = check_link_metadata(torch, node, seeds, md, r, c, b)
      step = 2 * i + 1                  # a link batch's negatives' step
      if mode == 'binary':
        got_r, got_c = negs['rows'], negs['cols']
        cand_r, cand_c = (loader.sampler.neg_draws(
            step, stream, NEG_TRIALS, got_r.shape[0],
            NUM_NODES).cpu().numpy() for stream in (0, 1))
      else:
        got_c = negs['dst'].reshape(-1)
        got_r = np.repeat(r, negs['dst'].shape[1])
        cand_c = loader.sampler.neg_draws(step, 0, NEG_TRIALS,
                                          got_c.shape[0],
                                          NUM_NODES).cpu().numpy()
        cand_r = np.broadcast_to(got_r, cand_c.shape)
      pick, all_edges = strict_picks(is_edge, cand_r, cand_c)
      slot = np.arange(pick.shape[0])
      if not (np.array_equal(got_r, cand_r[pick, slot])
              and np.array_equal(got_c, cand_c[pick, slot])):
        raise AssertionError(f'{mode} batch {i}: a negative is not its '
                             f'first non-edge candidate')
      rejected += int((is_edge(got_r, got_c) & ~all_edges).sum())
      fallbacks += int(all_edges.sum())
    if rejected:
      raise AssertionError(f'{mode}: {rejected} negatives are edges that '
                           f'the strict rule rejects')
    out[mode] = {'batches': nb, 'batches_per_s': nb / secs,
                 'edges_per_s': nb * b / secs,
                 'endpoints_per_batch': endpoints, 'node_cap': node_cap,
                 'negatives_that_are_edges': rejected,
                 'all_trials_edges': fallbacks, 'launches': launches,
                 'plain_calls': plain}
    del kept, loader
  hops = [check_sampler(torch, ops, timer, *a)[1] for a in recs.hops]
  gather = check_gather(torch, ops, timer, *recs.gathers[0])
  for h, r in enumerate(hops):
    emit('kernel', kernel='sample_one_hop',
         shape=f'products binary link batch hop {h}', **r)
  emit('kernel', kernel='gather_rows', shape='products binary link batch x',
       **gather)
  out['hop_rows'] = [h['rows'] for h in hops]
  emit('link_loader', batch=b, fanouts=list(FANOUTS),
       trials=NEG_TRIALS, strict_rule_checked_on_host=True, **out)
  del ds, recs
  torch.cuda.empty_cache()
  return {'launches': {m: out[m]['launches'] for m in ('binary', 'triplet')},
          'hops': hops, 'gathers': [gather]}


def seal(torch, ops, timer, indptr, indices, is_edge, prof=False):
  """BASELINE config 3, `examples/seal_link_pred.py`: the example's
  `synthetic()` graph at Cora's size with its 256 target links removed,
  256 positive and 256 negative links through `SubGraphLoader([8],
  batch 2)` (one link's enclosing subgraph a batch), DRNL labels on the
  host, SEAL's classifier (`seal_model`) trained with Adam(1e-3) for 3
  epochs over 80% of the links and tested on the rest; then extraction
  at scale: 256 products edges and 256 `RandomNegativeSampler` pairs
  through the same loader on the products graph (links/s, the subgraph
  op alone, its ``[node_cap x max_degree]`` window), every induced edge
  held against a host lookup and every subgraph's edge count against a
  host count."""
  import graphlearn_tpu_torch.sampler.neighbor_sampler as smod
  import torch.nn.functional as F
  from graphlearn_tpu_torch.data import Dataset
  from graphlearn_tpu_torch.loader import SubGraphLoader
  from graphlearn_tpu_torch.sampler import RandomNegativeSampler
  rows, cols, cl = seal_graph(n=SEAL_NODES, clusters=SEAL_CLUSTERS,
                              deg=SEAL_DEG)
  n = SEAL_NODES
  edge_set = set(zip(rows.tolist(), cols.tolist()))
  rng = np.random.default_rng(1)
  m = SEAL_LINKS
  pos_idx = rng.choice(len(rows), m, replace=False)
  pos = np.stack([rows[pos_idx], cols[pos_idx]], 1)
  pos_pairs = set(map(tuple, pos.tolist()))
  drop = np.fromiter(((r, c) in pos_pairs or (c, r) in pos_pairs
                      for r, c in zip(rows.tolist(), cols.tolist())), bool,
                     len(rows))
  ds = Dataset().init_graph((rows[~drop], cols[~drop]), num_nodes=n,
                            device=DEVICE)
  neg = []
  while len(neg) < m:
    u, v = rng.integers(0, n, 2)
    if (u, v) not in edge_set and (v, u) not in edge_set and u != v:
      neg.append((u, v))
  pairs = np.concatenate([pos, np.asarray(neg)])
  labels = np.concatenate([np.ones(m), np.zeros(m)]).astype(np.int64)
  order = rng.permutation(2 * m)
  pairs, labels = pairs[order], labels[order]
  loader = SubGraphLoader(ds, SEAL_FANOUTS, pairs.reshape(-1), batch_size=2,
                          seed=0, device=DEVICE)
  reset_counts(ops)
  sync(torch)
  t0 = time.perf_counter()
  sub = []
  with TrainRecorder(torch, smod, 0, hops=1) as rec:
    for i, batch in enumerate(loader):
      nmask = batch.node_mask.cpu().numpy()
      ei = batch.edge_index.cpu().numpy()
      em = batch.edge_mask.cpu().numpy()
      mapping = batch.metadata['mapping'].cpu().numpy()
      lab = drnl(nmask, ei, em, int(mapping[0]), int(mapping[1]))
      sub.append(tuple(torch.from_numpy(a).to(DEVICE)
                       for a in (lab, ei, em, nmask))
                 + (torch.tensor(labels[i], device=DEVICE),))
  extract_secs = time.perf_counter() - t0
  launches, plain = read_counts(ops)
  if not (launches['sample_one_hop'] == 2 * m and launches['gather_rows'] == 0
          and plain == 0):
    raise AssertionError(f'seal extraction: launches {launches}, plain '
                         f'calls {plain}, want 1 K1 a link')
  closure = [check_sampler(torch, ops, timer, *rec.hops[0])[1]]
  emit('kernel', kernel='sample_one_hop', shape='SEAL closure (2 seeds)',
       **closure[0])
  del rec
  model = seal_model(torch).to(DEVICE)
  opt = torch.optim.Adam(model.parameters(), lr=SEAL_LR)
  ntr = int(0.8 * len(sub))
  means = []
  t0 = time.perf_counter()
  for _ in range(SEAL_EPOCHS):
    tot = torch.zeros((), device=DEVICE)
    for lab, ei, em, nm, y in sub[:ntr]:
      opt.zero_grad(set_to_none=True)
      loss = F.cross_entropy(model(lab, ei, em, nm)[None], y[None])
      loss.backward()
      opt.step()
      tot += loss.detach()
    means.append(float(tot) / ntr)
  train_secs = time.perf_counter() - t0
  if prof:
    lab, ei, em, nm, y = sub[0]

    def seal_step():
      opt.zero_grad(set_to_none=True)
      loss = F.cross_entropy(model(lab, ei, em, nm)[None], y[None])
      loss.backward()
      opt.step()
      return loss.detach()
    profile_train(torch, seal_step, 'seal train', n=PROFILE_STEPS)
  model.eval()
  with torch.no_grad():
    correct = sum(int(torch.argmax(model(lab, ei, em, nm)) == y)
                  for lab, ei, em, nm, y in sub[ntr:])
  acc = correct / max(len(sub) - ntr, 1)
  if not (np.isfinite(means).all() and means[-1] < means[0] and acc > 0.5):
    raise AssertionError(f'SEAL: losses {means}, test accuracy {acc}')

  # -- extraction at scale on the products graph --------------------------
  dsp = Dataset().init_graph((indptr, indices), layout='CSR',
                             num_nodes=NUM_NODES, device=DEVICE)
  g = torch.Generator(device=DEVICE).manual_seed(23)
  at = torch.randint(0, indices.numel(), (SEAL_SCALE_LINKS,), generator=g,
                     device=DEVICE)
  psrc = torch.searchsorted(indptr, at, right=True) - 1
  negs = RandomNegativeSampler(dsp.get_graph(), seed=5,
                               device=DEVICE).sample(SEAL_SCALE_LINKS)
  links = torch.cat([torch.stack([psrc.to(torch.int32), indices[at]], 1),
                     negs.t()]).cpu().numpy()
  if is_edge(links[SEAL_SCALE_LINKS:, 0], links[SEAL_SCALE_LINKS:, 1]).any():
    raise AssertionError('a RandomNegativeSampler pair is an edge')
  sloader = SubGraphLoader(dsp, SEAL_FANOUTS, links.reshape(-1),
                           batch_size=2, seed=0, device=DEVICE)
  max_deg = dsp.get_graph().max_degree
  reset_counts(ops)
  sync(torch)
  t0 = time.perf_counter()
  kept = [(bt.node, bt.edge_index, bt.edge_mask) for bt in sloader]
  sync(torch)
  scale_secs = time.perf_counter() - t0
  slaunches, splain = read_counts(ops)
  nl = 2 * SEAL_SCALE_LINKS
  if not (slaunches['sample_one_hop'] == nl and slaunches['gather_rows'] == 0
          and splain == 0):
    raise AssertionError(f'seal at scale: launches {slaunches}, plain '
                         f'calls {splain}')
  indptr_h = indptr.cpu().numpy()
  indices_h = indices.cpu().numpy()
  induced = 0
  for node, ei, em in kept:
    node, ei, em = node.cpu().numpy(), ei.cpu().numpy(), em.cpu().numpy()
    u, v = node[ei[0][em]], node[ei[1][em]]
    if not is_edge(u, v).all():
      raise AssertionError('an induced edge is not an edge')
    valid = node[node >= 0]
    nbrs = [indices_h[indptr_h[x]:indptr_h[x + 1]] for x in valid]
    want = sum(int(np.isin(nb, valid).sum()) for nb in nbrs)
    if int(em.sum()) != want:
      raise AssertionError(f'an enclosing subgraph has {int(em.sum())} '
                           f'edges, the host counts {want}')
    induced += want
  node_cap = int(kept[-1][0].numel())
  last = kept[-1][0]
  op_ms = timer(lambda: ops.induced_subgraph(indptr, indices, last,
                                             max_degree=max_deg))
  window = node_cap * max_deg
  emit('seal', graph={'nodes': n, 'edges': int(rows.shape[0]),
                      'target_edges_removed': int(drop.sum()),
                      'clusters': SEAL_CLUSTERS, 'degree': SEAL_DEG},
       links=2 * m, fanouts=list(SEAL_FANOUTS), batch=2,
       model=f'Embedding({SEAL_MAX_LABEL}, {SEAL_HIDDEN}) -> '
             f'DGCNN({SEAL_HIDDEN}, 2 classes, 3 layers, k {SEAL_K})',
       optimizer=f'Adam({SEAL_LR})', epochs=SEAL_EPOCHS,
       extract_secs=extract_secs, train_secs=train_secs,
       train_steps_per_s=SEAL_EPOCHS * ntr / train_secs,
       epoch_mean_losses=means, test_links=len(sub) - ntr,
       test_accuracy=acc, launches=launches, plain_calls=plain,
       at_scale={'graph': 'products', 'links': nl,
                 'positive': SEAL_SCALE_LINKS,
                 'random_negatives': SEAL_SCALE_LINKS,
                 'links_per_s': nl / scale_secs, 'secs': scale_secs,
                 'node_cap': node_cap, 'max_degree': max_deg,
                 'window_slots': window, 'window_bytes_int32': window * 4,
                 'subgraph_op_ms': op_ms, 'induced_edges': induced,
                 'induced_edges_checked_on_host': True,
                 'launches': slaunches, 'plain_calls': splain})
  del dsp, kept
  return {'launches': {'train': launches, 'at_scale': slaunches},
          'hops': closure, 'node_cap': node_cap, 'max_degree': max_deg}


def link_cross_check(torch):
  """A 4,000-node clustered graph on the card and on the CPU: 2
  `LinkNeighborLoader` batches in each negative mode (none, binary,
  triplet) and 3 `SubGraphLoader` batches with the same CPU-made draws
  byte-equal; 2 `FusedLinkEpoch` steps with the default counter draws
  (captured on the card, eager on the CPU), losses within 1e-5; one
  SEAL `DGCNN` forward from the same parameters, logits within 1e-5."""
  from graphlearn_tpu_torch.data import Dataset
  from graphlearn_tpu_torch.loader import (FusedLinkEpoch, LinkNeighborLoader,
                                           SubGraphLoader)
  from graphlearn_tpu_torch.models import GraphSAGE
  from graphlearn_tpu_torch.ops import TorchDraws
  from graphlearn_tpu_torch.sampler import NegativeSampling
  rows, cols, feats, _ = clustered_graph(n=4000, deg=8, classes=8, d=16)
  rows = np.concatenate([rows, np.full(300, 7)])   # a hub past the window
  cols = np.concatenate([cols, np.arange(300)])
  cpu = TorchDraws(6, 'cpu')
  modes = (None, ('binary', 1.5), ('triplet', 2))
  out, fused_losses, logits = {}, {}, {}
  seal_net = seal_model(torch)
  for dev in (DEVICE, 'cpu'):
    def draws(step, hop, r, k, w, dev=dev):
      return tuple(t.to(dev) for t in cpu(step, hop, r, k, w))

    def neg_draws(step, stream, trials, r, high, dev=dev):
      return cpu.negatives(step, stream, trials, r, high).to(dev)
    ds = (Dataset().init_graph((rows, cols), num_nodes=4000, device=dev)
          .init_node_features(feats, device=dev))
    got = []
    for mode in modes:
      lo = LinkNeighborLoader(
          ds, [10, 5], (rows, cols),
          neg_sampling=None if mode is None else NegativeSampling(*mode),
          batch_size=64, shuffle=True, seed=1, draws=draws,
          neg_draws=neg_draws, device=dev)
      for bt in itertools.islice(iter(lo), 2):
        got.append([bt.node, bt.x, bt.edge_index, bt.edge_mask, bt.batch]
                   + [v for _, v in sorted(bt.metadata.items())])
    sl = SubGraphLoader(ds, [4, 3], np.arange(60), batch_size=4,
                        draws=draws, device=dev)
    for bt in itertools.islice(iter(sl), 3):
      got.append([bt.node, bt.edge_index, bt.edge_mask,
                  bt.metadata['mapping']])
    out[dev] = [[t.cpu() for t in ts] for ts in got]
    model = GraphSAGE(16, 32, 32, num_layers=2).to(dev)
    model.reset_parameters(torch.Generator().manual_seed(3))
    opt = torch.optim.Adam(model.parameters(), lr=LINK_LR, eps=1e-8,
                           capturable=dev != 'cpu')
    fused = FusedLinkEpoch(ds, [10, 5], (rows[:128], cols[:128]), model, opt,
                           64, seed=2, device=dev)
    fused_losses[dev] = fused.run().losses.cpu().numpy()
    if dev != 'cpu' and fused.compile_count() != 1:
      raise AssertionError('the card did not capture the link step')
    bt = got[-1]
    lab = torch.arange(bt[0].numel(), device=dev) % SEAL_MAX_LABEL
    with torch.no_grad():
      logits[dev] = seal_net.to(dev)(lab, bt[1], bt[2], bt[0] >= 0).cpu()
  for i, (a, c) in enumerate(zip(out[DEVICE], out['cpu'])):
    if len(a) != len(c) or not all(x.dtype == y.dtype and torch.equal(x, y)
                                   for x, y in zip(a, c)):
      raise AssertionError(f'card and CPU link/subgraph batch {i} differ')
  diff = float(np.abs(fused_losses[DEVICE] - fused_losses['cpu']).max())
  ldiff = float((logits[DEVICE] - logits['cpu']).abs().max())
  if not (diff <= 1e-5 and ldiff <= 1e-5 and len(fused_losses['cpu']) == 2):
    raise AssertionError(f'link losses differ by {diff}, DGCNN logits by '
                         f'{ldiff}')
  emit('link_cross_check', link_batches=2 * len(modes), subgraph_batches=3,
       byte_equal=True, fused_steps=2, fused_loss_max_abs_diff=diff,
       dgcnn_logits_max_abs_diff=ldiff, card_captured=True)


def link_phases(torch, ops, timer, indptr, indices, feats, prof=False):
  """The link-prediction and enclosing-subgraph phases (`link_train`,
  `link_loader`, `seal`, `link_cross_check`)."""
  train = link_train(torch, ops, timer, prof=prof)
  torch.cuda.empty_cache()
  is_edge = edge_lookup(indptr.cpu().numpy(), indices.cpu().numpy())
  loader = link_loader(torch, ops, timer, indptr, indices, feats, is_edge)
  seal_out = seal(torch, ops, timer, indptr, indices, is_edge, prof=prof)
  del is_edge
  link_cross_check(torch)
  return train, loader, seal_out


#: the edges phase: BASELINE config 1 with sampled edge ids and an edge
#: table of ogbn-proteins' published edge-feature width (8)
EDGE_DIM = 8
EDGE_WARM = 2
EDGE_STEPS = 20
EDGE_CHECK_BATCHES = 5
#: with-edge SubGraphLoader batches (2 seeds each) and binary link
#: batches (1,024 edges each) on the products graph
EDGE_SUB_BATCHES = 8
EDGE_LINK_BATCHES = 3
#: `examples/hetero/bipartite_sage_unsup.py` at its full size
BI_USERS, BI_ITEMS, BI_TASTE, BI_DEG, BI_DIM = 2000, 400, 8, 10, 32
BI_HIDDEN = 64
BI_FANOUTS = (8, 8)
BI_BATCH = 512
BI_EPOCHS = 10
BI_LR = 3e-3
BI_USER, BI_ITEM = 'user', 'item'
BI_ET = (BI_USER, 'clicks', BI_ITEM)
BI_ET_REV = (BI_ITEM, 'rev_clicks', BI_USER)
#: the hetero link loader on the mag graph's ``writes`` relation
MAG_WRITES = ('author', 'writes', 'paper')
MAG_LINK_BATCH = 1024
MAG_LINK_FANOUTS = (10, 10)
MAG_LINK_BATCHES = 20
MAG_EDGE_BATCHES = 3
MAG_EDGE_DIM = 4
#: random walks over the products graph and node2vec
WALK_LENGTH = 8
WALK_RESTART = 0.15
WALK_WINDOW = 2
N2V_STARTS = 262_144
N2V_P, N2V_Q, N2V_MAX_DEGREE = 0.25, 4.0, 64
WALK_CHECK = 4096
#: `examples/deepwalk.py` at its size
DW_NODES, DW_DEG, DW_CLASSES, DW_D, DW_INTRA = 2000, 8, 6, 4, 0.9
DW_DIM, DW_NEG, DW_EPOCHS, DW_PAIRS, DW_LR = 32, 4, 5, 4096, 0.05


def edge_table(torch, indices):
  """The products graph's edge ids, a seeded permutation of ``[0, E)``
  (int32, so K1 reads ``edge_ids[pos]``), and the ``[E, 8]`` f32 edge
  table they address."""
  gen = torch.Generator(device=DEVICE).manual_seed(31)
  perm = torch.randperm(indices.numel(), generator=gen, device=DEVICE).to(
      torch.int32)
  table = torch.rand(indices.numel(), EDGE_DIM, generator=gen, device=DEVICE)
  return perm, table


def inverse_ids(torch, perm) -> np.ndarray:
  """Each edge id's CSR position, on the host."""
  inv = torch.empty_like(perm)
  inv[perm.long()] = torch.arange(perm.numel(), dtype=torch.int32,
                                  device=perm.device)
  return inv.cpu().numpy()


def check_edge_batch(torch, batch, inv_h, indptr_h, indices_h, table,
                     transposed=True) -> int:
  """Every valid ``edge`` id, looked up on the host: its CSR position
  lies in the row of the edge's source (the seed side when
  ``transposed``: ``edge_index[1]``) and holds the other end;
  ``edge_attr`` equals the table's rows on the card; masked slots hold
  -1 and zero rows.  Returns the edges checked."""
  e, em = batch.edge, batch.edge_mask
  if not (torch.equal(batch.edge_attr[em], table[e[em].long()])
          and not bool(batch.edge_attr[~em].any())
          and bool((e[~em] == -1).all())):
    raise AssertionError('edge_attr differs from the edge table')
  node = batch.node.cpu().numpy()
  ei = batch.edge_index.cpu().numpy()
  ok = em.cpu().numpy()
  src, dst = (ei[1], ei[0]) if transposed else (ei[0], ei[1])
  src, dst = node[src[ok]].astype(np.int64), node[dst[ok]]
  pos = inv_h[e.cpu().numpy()[ok]].astype(np.int64)
  if not ((pos >= indptr_h[src]).all() and (pos < indptr_h[src + 1]).all()
          and (indices_h[pos] == dst).all()):
    raise AssertionError('a sampled edge id does not name its edge')
  return int(ok.sum())


def with_edge_hops(torch, ops, timer, rec, what) -> list:
  """K1 at each recorded hop of a with-edge step against its plain
  version with ``edge_ids``, with CSR positions and without the arm,
  each timed: the arm's cost at the same hop."""
  out = []
  for t, (args, (eid, on)) in enumerate(zip(rec.hops, rec.edges)):
    if not on or eid is None:
      raise AssertionError(f'{what} hop {t} ran without edge ids')
    _, r = check_sampler(torch, ops, timer, *args, edge_ids=eid,
                         with_edge_ids=True)
    _, rpos = check_sampler(torch, ops, timer, *args, with_edge_ids=True)
    _, rnone = check_sampler(torch, ops, timer, *args)
    r.update(no_eids_ms=rnone['kernel_ms'], no_eids_bound_ms=rnone[
        'bound_us'] / 1e3, no_eids_plain_ms=rnone['plain_ms'],
        positions_ms=rpos['kernel_ms'],
        positions_bound_ms=rpos['bound_us'] / 1e3, hop=t)
    emit('kernel', kernel='sample_one_hop', shape=f'{what} hop {t}', **r)
    out.append(r)
  return out


def check_recorded(torch, ops, timer, rec, what, timed=True):
  """K1 and K2 at every call `rec` kept, each against its plain version
  with the edge-id arm the path asked for (and timed with ``timed``);
  one ``kernel`` line a call.  Returns the K1 and K2 records."""
  hops, gathers = [], []
  for t, (args, (eid, on)) in enumerate(zip(rec.hops, rec.edges)):
    _, r = check_sampler(torch, ops, timer, *args, edge_ids=eid,
                         with_edge_ids=on, time_it=timed)
    r['call'] = t
    emit('kernel', kernel='sample_one_hop', shape=f'{what} call {t}', **r)
    hops.append(r)
  for t, (tab, ids) in enumerate(rec.gathers):
    r = check_gather(torch, ops, timer, tab, ids, time_it=timed)
    r['call'] = t
    emit('kernel', kernel='gather_rows', shape=f'{what} gather {t}', **r)
    gathers.append(r)
  if not (hops and gathers):
    raise AssertionError(f'{what}: no kernel call recorded')
  return hops, gathers


def edges(torch, ops, timer, ds, feats, labels, table, inv_h, indptr_h,
          indices_h) -> dict:
  """BASELINE config 1 with edges: `NeighborLoader([15, 10, 5], batch
  1,024, with_edge=True)` over the products graph whose edge ids are a
  permutation, with the ``[E, 8]`` edge table, into
  ``GraphSAGE(100, 256, 47, 3)`` and Adam(3e-3): `EDGE_WARM` warm steps
  (the first one's kernel inputs recorded) and `EDGE_STEPS` timed ones,
  then the loader alone over `EDGE_STEPS` more batches; the same without
  edges over the same seeds and draws.  Checks: 3 K1 and 2 K2 launches a
  with-edge batch (3 and 1 without), no plain call, the losses falling,
  `EDGE_CHECK_BATCHES` batches' edge ids and rows on the host; K1 with
  and without the edge-id arm at each hop, K2 at the edge rows."""
  import graphlearn_tpu_torch.sampler.neighbor_sampler as smod
  from graphlearn_tpu_torch.loader import NeighborLoader
  from graphlearn_tpu_torch.models import GraphSAGE, make_supervised_step
  seeds = train_splits()[0][:TRAIN_BATCH * (EDGE_WARM + 2 * EDGE_STEPS)]
  out, rec = {}, None
  for with_edge in (True, False):
    loader = NeighborLoader(ds, FANOUTS, seeds, batch_size=TRAIN_BATCH,
                            shuffle=True, seed=0, with_edge=with_edge,
                            device=DEVICE)
    model = GraphSAGE(FEAT_DIM, 256, GNS_CLASSES, num_layers=3).to(DEVICE)
    model.reset_parameters(torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(model.parameters(), lr=TRAIN_LR, eps=1e-8)
    step = make_supervised_step(model, opt, TRAIN_BATCH)
    it = iter(loader)
    losses = []
    for i in range(EDGE_WARM):
      if with_edge and i == 0:
        with TrainRecorder(torch, smod, 2) as rec:
          batch = next(it)
      else:
        batch = next(it)
      losses.append(float(step(batch)[0]))
      check_batch(torch, batch, feats, labels)
    del batch
    reset_counts(ops)
    sync(torch)
    t0 = time.perf_counter()
    losses += [step(b)[0] for b in itertools.islice(it, EDGE_STEPS)]
    sync(torch)
    step_secs = time.perf_counter() - t0
    kept = []
    t0 = time.perf_counter()
    for b in itertools.islice(it, EDGE_STEPS):
      if len(kept) < EDGE_CHECK_BATCHES:
        kept.append(b)
      del b
    sync(torch)
    load_secs = time.perf_counter() - t0
    launches, plain = read_counts(ops)
    runs = 2 * EDGE_STEPS
    k2 = 2 if with_edge else 1
    if not (launches['sample_one_hop'] == len(FANOUTS) * runs
            and launches['gather_rows'] == k2 * runs and plain == 0):
      raise AssertionError(f'edges (with_edge={with_edge}): launches '
                           f'{launches}, plain calls {plain}')
    losses = np.array([float(x) for x in losses])
    if not (np.isfinite(losses).all()
            and losses[-5:].mean() < losses[:EDGE_WARM].mean()):
      raise AssertionError(f'edges losses do not fall: {losses}')
    checked = 0
    for b in kept:
      check_batch(torch, b, feats, labels)
      if with_edge:
        checked += check_edge_batch(torch, b, inv_h, indptr_h, indices_h,
                                    table)
      elif b.edge is not None or b.edge_attr is not None:
        raise AssertionError('a batch without with_edge carries edges')
    key = 'with_edge' if with_edge else 'without_edge'
    out[key] = {'step_ms': step_secs / EDGE_STEPS * 1e3,
                'steps_per_s': EDGE_STEPS / step_secs,
                'loader_batches_per_s': EDGE_STEPS / load_secs,
                'edges_checked_on_host': checked,
                'edge_slots': int(kept[0].edge_index.shape[1]),
                'losses': losses.tolist(), 'launches': launches,
                'plain_calls': plain}
    del kept, loader, model, opt, step
  hops = with_edge_hops(torch, ops, timer, rec, 'edges batch')
  x_table, x_ids = rec.gathers[0]
  e_table, e_ids = rec.gathers[1]
  if e_table.data_ptr() != table.data_ptr() or x_table.data_ptr() != \
      feats.data_ptr():
    raise AssertionError('the edges batch gathered from other tables')
  gathers = [check_gather(torch, ops, timer, x_table, x_ids),
             check_gather(torch, ops, timer, e_table, e_ids)]
  for g, what in zip(gathers, ('x', 'edge_attr')):
    emit('kernel', kernel='gather_rows', shape=f'edges batch {what}', **g)
  out['hops'] = [{'rows': h['rows'], 'k': h['k'],
                  'ms': h['kernel_ms'], 'no_eids_ms': h['no_eids_ms'],
                  'positions_ms': h['positions_ms']} for h in hops]
  emit('edges', batch=TRAIN_BATCH, fanouts=list(FANOUTS),
       edge_dim=EDGE_DIM, edge_ids='seeded permutation of [0, E)', **out)
  del rec
  return {'launches': {k: out[k]['launches']
                       for k in ('with_edge', 'without_edge')},
          'hops': hops, 'gathers': gathers}


def edge_loaders(torch, ops, timer, ds, table, inv_h, indptr_h,
                 indices_h) -> dict:
  """`SubGraphLoader([8], batch 2, with_edge=True)` over
  `EDGE_SUB_BATCHES` products edges' endpoints and `LinkNeighborLoader
  ([15, 10, 5], batch 1,024, binary 1.0, with_edge=True)` over
  `EDGE_LINK_BATCHES` batches: every batch's edge ids and rows checked
  on the host; K1 (the closure without the arm, as JAX samples it; the
  link hops with it) and K2 (x and the edge rows) launches a batch."""
  import graphlearn_tpu_torch.sampler.neighbor_sampler as smod
  from graphlearn_tpu_torch.loader import LinkNeighborLoader, SubGraphLoader
  from graphlearn_tpu_torch.sampler import NegativeSampling
  rng = np.random.default_rng(25)
  e = indices_h.shape[0]
  pos = rng.integers(0, e, EDGE_SUB_BATCHES + EDGE_LINK_BATCHES * 1024)
  src = np.searchsorted(indptr_h, pos, side='right') - 1
  dst = indices_h[pos]
  out = {}
  n = EDGE_SUB_BATCHES
  sub = SubGraphLoader(ds, SEAL_FANOUTS, np.stack([src[:n], dst[:n]],
                                                  1).reshape(-1),
                       batch_size=2, with_edge=True, seed=25, device=DEVICE)
  reset_counts(ops)
  batches = list(sub)
  sync(torch)
  launches, plain = read_counts(ops)
  if not (launches['sample_one_hop'] == n * len(SEAL_FANOUTS)
          and launches['gather_rows'] == 2 * n and plain == 0):
    raise AssertionError(f'with-edge subgraphs: launches {launches}, plain '
                         f'calls {plain}')
  checked = sum(check_edge_batch(torch, b, inv_h, indptr_h, indices_h,
                                 table, transposed=False) for b in batches)
  out['subgraph'] = {'batches': n, 'edges_checked_on_host': checked,
                     'launches': launches, 'plain_calls': plain}
  del batches, sub
  link = LinkNeighborLoader(ds, FANOUTS, (src[n:], dst[n:]),
                            neg_sampling=NegativeSampling('binary', 1.0),
                            batch_size=1024, with_edge=True, seed=26,
                            device=DEVICE)
  reset_counts(ops)
  with TrainRecorder(torch, smod, 0) as rec:
    batches = list(link)
  sync(torch)
  launches, plain = read_counts(ops)
  nb = EDGE_LINK_BATCHES
  if not (launches['sample_one_hop'] == len(FANOUTS) * nb
          and launches['gather_rows'] == 2 * nb and plain == 0):
    raise AssertionError(f'with-edge link batches: launches {launches}, '
                         f'plain calls {plain}')
  checked = sum(check_edge_batch(torch, b, inv_h, indptr_h, indices_h, table)
                for b in batches)
  out['link'] = {'batches': nb, 'edges_checked_on_host': checked,
                 'launches': launches, 'plain_calls': plain}
  hops = with_edge_hops(torch, ops, timer, rec, 'with-edge link batch')
  emit('edge_loaders', **out)
  return {'launches': {k: v['launches'] for k, v in out.items()},
          'hops': hops}


def edges_cross_check(torch):
  """A 4,000-node graph with a ``[E, 8]`` edge table (COO-order edge
  ids) on the card and on the CPU: 2 with-edge `NeighborLoader` batches
  with the same CPU-made draws byte-equal (node, x, edge_index,
  edge_mask, edge, edge_attr)."""
  from graphlearn_tpu_torch.data import Dataset
  from graphlearn_tpu_torch.loader import NeighborLoader
  from graphlearn_tpu_torch.ops import TorchDraws
  rows, cols, feats, _ = clustered_graph(n=4000, deg=10, classes=7, d=16,
                                         seed=13)
  etab = np.random.default_rng(14).standard_normal(
      (rows.shape[0], EDGE_DIM)).astype(np.float32)
  cpu = TorchDraws(15, 'cpu')
  out = {}
  for dev in (DEVICE, 'cpu'):
    def draws(step, hop, r, k, w, dev=dev):
      return tuple(t.to(dev) for t in cpu(step, hop, r, k, w))
    ds = (Dataset().init_graph((rows, cols), num_nodes=4000, device=dev)
          .init_node_features(feats, device=dev)
          .init_edge_features(etab, device=dev))
    lo = NeighborLoader(ds, FANOUTS, np.arange(4000), batch_size=64,
                        shuffle=True, seed=1, with_edge=True, draws=draws,
                        device=dev)
    out[dev] = [[t.cpu() for t in (b.node, b.x, b.edge_index, b.edge_mask,
                                   b.edge, b.edge_attr)]
                for b in itertools.islice(iter(lo), 2)]
  for i, (a, c) in enumerate(zip(out[DEVICE], out['cpu'])):
    for name, x, y in zip(('node', 'x', 'edge_index', 'edge_mask', 'edge',
                           'edge_attr'), a, c):
      if x.dtype != y.dtype or not torch.equal(x, y):
        raise AssertionError(f'card and CPU differ: with-edge batch {i} '
                             f'{name}')
  emit('edges_cross_check', batches=2, byte_equal=True,
       edges=int((out['cpu'][0][3]).sum()))


def bipartite_synthetic(nu=BI_USERS, ni=BI_ITEMS, taste=BI_TASTE,
                        deg=BI_DEG, d=BI_DIM, seed=0):
  """`examples/hetero/bipartite_sage_unsup.py::synthetic`, copied:
  ``(rows, cols, user features, item features)`` of a user-item click
  graph where 80% of a user's clicks stay in its taste group."""
  rng = np.random.default_rng(seed)
  ut = rng.integers(0, taste, nu)
  it = rng.integers(0, taste, ni)
  rows = np.repeat(np.arange(nu), deg)
  match = rng.random(nu * deg) < 0.8
  by_taste = [np.nonzero(it == t)[0] for t in range(taste)]
  cols = np.empty(nu * deg, np.int64)
  for t in range(taste):
    m = ut[rows] == t
    pool = by_taste[t] if len(by_taste[t]) else np.arange(ni)
    cols[m] = pool[rng.integers(0, len(pool), m.sum())]
  cols[~match] = rng.integers(0, ni, (~match).sum())
  proto = rng.normal(0, 1, (taste, d)).astype(np.float32)
  ufeat = 0.5 * proto[ut] + rng.standard_normal((nu, d)).astype(np.float32)
  ifeat = 0.5 * proto[it] + rng.standard_normal((ni, d)).astype(np.float32)
  return rows, cols, ufeat, ifeat


def bisage_model(torch, etypes, dims, hidden=BI_HIDDEN):
  """The bipartite example's ``BiSAGE`` on the port's modules: a
  ``Linear(d, hidden)`` per node type (``lin_{type}``), then two
  ``HeteroConv(make_conv=SAGEConv)`` layers (``conv0``, ``conv1``) with
  a relu between them."""
  from graphlearn_tpu_torch.models import HeteroConv, SAGEConv

  class BiSAGE(torch.nn.Module):
    def __init__(self):
      super().__init__()
      for nt, d in dims.items():
        self.add_module(f'lin_{nt}', torch.nn.Linear(d, hidden))
      for i in range(2):
        self.add_module(f'conv{i}', HeteroConv(etypes, hidden, hidden,
                                               make_conv=SAGEConv))

    def forward(self, x_dict, edge_index_dict, edge_mask_dict):
      h = {nt: getattr(self, f'lin_{nt}')(x) for nt, x in x_dict.items()}
      h = self.conv0(h, edge_index_dict, edge_mask_dict)
      h = {nt: torch.relu(v) for nt, v in h.items()}
      return self.conv1(h, edge_index_dict, edge_mask_dict)
  return BiSAGE()


def bisage_loss(torch, h, metadata, src_type=BI_USER, dst_type=BI_ITEM):
  """The bipartite example's link loss: the endpoints' dot product under
  a sigmoid cross-entropy against ``min(edge_label, 1)``, averaged over
  the valid label slots."""
  import torch.nn.functional as F
  eli = metadata['edge_label_index']
  lab = torch.clamp(metadata['edge_label'], max=1).float()
  hu, hv = h[src_type], h[dst_type]
  eu = hu[eli[0].long().clamp(0, hu.shape[0] - 1)]
  ev = hv[eli[1].long().clamp(0, hv.shape[0] - 1)]
  logit = (eu * ev).sum(-1)
  ls = F.binary_cross_entropy_with_logits(logit, lab, reduction='none')
  w = (metadata['edge_label_mask'] & (eli[0] >= 0) & (eli[1] >= 0)).float()
  return (ls * w).sum() / torch.clamp(w.sum(), min=1.0)


def bipartite_link(torch, ops, timer) -> dict:
  """`examples/hetero/bipartite_sage_unsup.py` at its full size: the
  click graph (2,000 users, 400 items, degree 10) less 10% held out,
  `LinkNeighborLoader([8, 8], (user, clicks, item), binary 1.0, batch
  512, shuffled)` -> ``BiSAGE`` and Adam(3e-3) for `BI_EPOCHS` epochs;
  then every node embedded through a per-type `NeighborLoader` and the
  held-out clicks ranked against random pairs (AUC).  Checks: 4 K1 and 2
  K2 launches a batch, no plain call, K1 and K2 at every call of the
  first step and of the embedding loaders against their plain versions
  (the step's timed), the loss falling, AUC above 0.5."""
  import graphlearn_tpu_torch.sampler.hetero_neighbor_sampler as hmod
  from graphlearn_tpu_torch.data import Dataset
  from graphlearn_tpu_torch.loader import LinkNeighborLoader, NeighborLoader
  from graphlearn_tpu_torch.sampler import NegativeSampling
  from graphlearn_tpu_torch.typing import reverse_edge_type
  urow, icol, ufeat, ifeat = bipartite_synthetic()
  nu, ni = len(ufeat), len(ifeat)
  rng = np.random.default_rng(2)
  m = len(urow)
  perm = rng.permutation(m)
  heldout, tr = perm[:m // 10], perm[m // 10:]
  tr_u, tr_i = urow[tr], icol[tr]
  ds = (Dataset().init_graph({BI_ET: (tr_u, tr_i), BI_ET_REV: (tr_i, tr_u)},
                             layout='COO',
                             num_nodes={BI_USER: nu, BI_ITEM: ni},
                             device=DEVICE)
        .init_node_features({BI_USER: ufeat, BI_ITEM: ifeat},
                            device=DEVICE))
  loader = LinkNeighborLoader(ds, BI_FANOUTS, (BI_ET, (tr_u, tr_i)),
                              neg_sampling=NegativeSampling('binary', 1.0),
                              batch_size=BI_BATCH, shuffle=True, seed=0,
                              device=DEVICE)
  etypes = tuple(sorted(reverse_edge_type(et) for et in ds.get_graph()))
  with torch.random.fork_rng(devices=[]):
    torch.manual_seed(0)
    model = bisage_model(torch, etypes, {BI_USER: BI_DIM, BI_ITEM: BI_DIM})
  model = model.to(DEVICE)
  opt = torch.optim.Adam(model.parameters(), lr=BI_LR, eps=1e-8)
  reset_counts(ops)
  epoch_loss, steps = [], 0
  sync(torch)
  t0 = time.perf_counter()
  # the first step's 4 K1 and 2 K2 calls are kept
  with TrainRecorder(torch, hmod, 2, hops=4) as rec:
    for _ in range(BI_EPOCHS):
      tot = []
      for batch in loader:
        h = model(batch.x_dict, batch.edge_index_dict, batch.edge_mask_dict)
        loss = bisage_loss(torch, h, batch.metadata)
        opt.zero_grad()
        loss.backward()
        opt.step()
        tot.append(loss.detach())
        steps += 1
      epoch_loss.append(float(torch.stack(tot).mean()))
  sync(torch)
  train_secs = time.perf_counter() - t0
  launches, plain = read_counts(ops)
  if not (launches['sample_one_hop'] == 4 * steps
          and launches['gather_rows'] == 2 * steps and plain == 0):
    raise AssertionError(f'bipartite link: launches {launches}, plain '
                         f'calls {plain}, steps {steps}')
  if not (np.isfinite(epoch_loss).all() and epoch_loss[-1] < epoch_loss[0]):
    raise AssertionError(f'bipartite link losses do not fall: {epoch_loss}')

  def embed(ntype, count):
    emb = torch.zeros(count, BI_HIDDEN, device=DEVICE)
    el = NeighborLoader(ds, BI_FANOUTS, (ntype, np.arange(count)),
                        batch_size=BI_BATCH, device=DEVICE)
    with torch.no_grad():
      for b in el:
        h = model(b.x_dict, b.edge_index_dict, b.edge_mask_dict)[ntype]
        seeds = b.batch_dict[ntype]
        ok = seeds >= 0
        sl = b.metadata['seed_local']
        emb[seeds[ok].long()] = h[sl[ok].long()]
    return emb.cpu().numpy()
  hops, gathers = check_recorded(torch, ops, timer, rec,
                                 'bipartite link step')
  checked = {'step': [len(hops), len(gathers)]}
  embs = {}
  for ntype, count in ((BI_USER, nu), (BI_ITEM, ni)):
    # the first calls of the per-type embedding loader, checked untimed
    with TrainRecorder(torch, hmod, 2, hops=4) as erec:
      embs[ntype] = embed(ntype, count)
    eh, eg = check_recorded(torch, ops, timer, erec,
                            f'bipartite {ntype} embedding batch',
                            timed=False)
    checked[f'embed_{ntype}'] = [len(eh), len(eg)]
    hops, gathers = hops + eh, gathers + eg
  uemb, iemb = embs[BI_USER], embs[BI_ITEM]
  pos_s = (uemb[urow[heldout]] * iemb[icol[heldout]]).sum(1)
  neg_s = (uemb[rng.integers(0, nu, len(heldout))]
           * iemb[rng.integers(0, ni, len(heldout))]).sum(1)
  auc = float((pos_s[:, None] > neg_s[None, :]).mean())
  if not auc > 0.5:
    raise AssertionError(f'bipartite held-out AUC {auc}')
  return {'users': nu, 'items': ni, 'train_edges': int(len(tr)),
          'heldout': int(len(heldout)), 'epochs': BI_EPOCHS, 'steps': steps,
          'step_ms': train_secs / steps * 1e3, 'epoch_loss': epoch_loss,
          'heldout_auc': auc, 'launches': launches, 'plain_calls': plain,
          'k1_k2_checked': checked, 'hops': hops, 'gathers': gathers}


def mag_link(torch, ops, timer) -> dict:
  """A hetero link loader on the mag graph's ``(author, writes, paper)``
  relation: `LinkNeighborLoader([10, 10], batch 1,024, binary 1.0)` over
  `MAG_LINK_BATCHES` batches of random ``writes`` edges (batches/s; 6
  K1 and 2 K2 launches a batch); then with ``with_edge=True`` and a
  ``[E_writes, 4]`` f32 table under the emitted type ``(paper,
  rev_writes, author)`` (row ``e`` holds edge ``e``'s author, paper and
  CSR position: the graph is built from tensors, so the ids are
  positions) over `MAG_EDGE_BATCHES` batches: K1 and K2 at every call
  against their plain versions (the first batch's timed; so are the
  first batch's 6 K1 and 2 K2 calls without edges), every edge
  row checked against its endpoints and position, the label indices
  through ``node_dict``, negatives drawn in the paper space."""
  import graphlearn_tpu_torch.sampler.hetero_neighbor_sampler as hmod
  from graphlearn_tpu_torch.loader import LinkNeighborLoader
  from graphlearn_tpu_torch.sampler import NegativeSampling
  from graphlearn_tpu_torch.typing import as_str, reverse_edge_type
  ds, feats, _ = mag_graph(torch)
  g = ds.get_graph()[MAG_WRITES]
  e = g.indices.numel()
  gen = torch.Generator(device=DEVICE).manual_seed(27)
  n = MAG_LINK_BATCHES * MAG_LINK_BATCH
  pos = torch.randint(0, e, (n,), generator=gen, device=DEVICE)
  src = (torch.searchsorted(g.indptr, pos, right=True) - 1).cpu().numpy()
  dst = g.indices[pos].cpu().numpy()
  rev = reverse_edge_type(MAG_WRITES)
  # float32 holds the ids and positions exactly only below 2**24
  if not max(e, MAG_AUTHOR, MAG_PAPER) < 2 ** 24:
    raise AssertionError(f'the writes edge table cannot hold {e} edges '
                         f'exactly in float32')
  rows_of = torch.repeat_interleave(
      torch.arange(g.num_nodes, device=DEVICE), g.indptr[1:] - g.indptr[:-1])
  table = torch.stack([rows_of.float(), g.indices.float(),
                       torch.arange(e, device=DEVICE).float(),
                       torch.ones(e, device=DEVICE)], 1)
  del rows_of
  ds.init_edge_features({rev: table}, device=DEVICE)
  out = {}
  reset_counts(ops)
  loader = LinkNeighborLoader(ds, MAG_LINK_FANOUTS, (MAG_WRITES, (src, dst)),
                              neg_sampling=NegativeSampling('binary', 1.0),
                              batch_size=MAG_LINK_BATCH, seed=24,
                              device=DEVICE)
  sync(torch)
  t0 = time.perf_counter()
  nb = 0
  # the first batch's 6 K1 and 2 K2 calls are kept
  with TrainRecorder(torch, hmod, 2, hops=6) as prec:
    for b in loader:
      nb += 1
      del b
  sync(torch)
  secs = time.perf_counter() - t0
  launches, plain = read_counts(ops)
  if not (launches['sample_one_hop'] == 6 * nb
          and launches['gather_rows'] == 2 * nb and plain == 0):
    raise AssertionError(f'mag link loader: launches {launches}, plain '
                         f'calls {plain}')
  plain_hops, plain_gathers = check_recorded(torch, ops, timer, prec,
                                             'mag link batch')
  del prec
  out['loader'] = {'batches': nb, 'batches_per_s': nb / secs,
                   'edges_per_s': nb * MAG_LINK_BATCH / secs,
                   'launches': launches, 'plain_calls': plain,
                   'k1_checked': len(plain_hops),
                   'k2_checked': len(plain_gathers)}
  nb = MAG_EDGE_BATCHES
  m = nb * MAG_LINK_BATCH
  loader = LinkNeighborLoader(ds, MAG_LINK_FANOUTS,
                              (MAG_WRITES, (src[:m], dst[:m])),
                              neg_sampling=NegativeSampling('binary', 1.0),
                              batch_size=MAG_LINK_BATCH, seed=28,
                              with_edge=True, device=DEVICE)
  reset_counts(ops)
  with TrainRecorder(torch, hmod, 3 * nb, hops=6 * nb) as rec:
    batches = list(loader)
  sync(torch)
  launches, plain = read_counts(ops)
  if not (launches['sample_one_hop'] == 6 * nb
          and launches['gather_rows'] == 3 * nb and plain == 0):
    raise AssertionError(f'mag with-edge link: launches {launches}, plain '
                         f'calls {plain}')
  hops, gathers = [], []
  for i, (args, (eid, on)) in enumerate(zip(rec.hops, rec.edges)):
    if not on:
      raise AssertionError('a with-edge hetero hop ran without edge ids')
    _, r = check_sampler(torch, ops, timer, *args, edge_ids=eid,
                         with_edge_ids=True, time_it=i < 6)
    hops.append(r)
  for i, (tab, ids) in enumerate(rec.gathers):
    gathers.append(check_gather(torch, ops, timer, tab, ids,
                                time_it=i < 3))
  checked = 0
  indptr_w = g.indptr.cpu().numpy()
  indices_w = g.indices.cpu().numpy()
  for b in batches:
    if set(b.edge_attr_dict) != {rev}:
      raise AssertionError(f'edge_attr_dict holds {list(b.edge_attr_dict)}')
    ea = b.edge_attr_dict[rev]
    ei, em = b.edge_index_dict[rev], b.edge_mask_dict[rev]
    a = b.node_dict['author'][ei[1].clamp(min=0).long()]
    p = b.node_dict['paper'][ei[0].clamp(min=0).long()]
    if not (torch.equal(ea[em, 0], a[em].float())
            and torch.equal(ea[em, 1], p[em].float())
            and bool((ea[em, 3] == 1).all()) and not bool(ea[~em].any())):
      raise AssertionError('an edge row does not match its endpoints')
    posn = ea[em, 2].long().cpu().numpy()
    an = a[em].cpu().numpy()
    if not ((posn >= indptr_w[an]).all() and (posn < indptr_w[an + 1]).all()
            and (indices_w[posn] == p[em].cpu().numpy()).all()):
      raise AssertionError('a with-edge position does not name its edge')
    checked += int(em.sum())
    eli = b.metadata['edge_label_index']
    if not (int(eli[1].max()) < b.node_dict['paper'].numel()
            and int(eli[0].max()) < b.node_dict['author'].numel()):
      raise AssertionError('edge_label_index outside the type tables')
  emit('kernel', kernel='sample_one_hop',
       shape=f'mag with-edge link batch, {len(hops)} calls', **hops[0])
  emit('kernel', kernel='gather_rows',
       shape=f'mag with-edge link batch edge rows', **gathers[2])
  out['with_edge'] = {'batches': nb, 'relation': as_str(MAG_WRITES),
                      'table': as_str(rev), 'table_shape': list(table.shape),
                      'edges_checked': checked, 'k1_checked': len(hops),
                      'k2_checked': len(gathers), 'launches': launches,
                      'plain_calls': plain}
  del ds, feats, batches, rec, loader, table
  torch.cuda.empty_cache()
  return {'out': out, 'hops': hops, 'gathers': gathers,
          'plain_hops': plain_hops, 'plain_gathers': plain_gathers,
          'launches': {'loader': out['loader']['launches'],
                       'with_edge': launches}}


def hetero_link(torch, ops, timer) -> dict:
  """The `hetero_link` phase: `bipartite_link` and `mag_link`."""
  t0 = time.perf_counter()
  bi = bipartite_link(torch, ops, timer)
  mag = mag_link(torch, ops, timer)
  emit('hetero_link', bipartite={k: v for k, v in bi.items()
                                 if k not in ('hops', 'gathers')},
       mag=mag['out'], secs=time.perf_counter() - t0)
  # 'hops'/'gathers': every checked call; the timed ones by shape
  return {'launches': {'bipartite': bi['launches'], **mag['launches']},
          'bipartite_auc': bi['heldout_auc'],
          'hops': bi['hops'] + mag['plain_hops'] + mag['hops'],
          'gathers': bi['gathers'] + mag['plain_gathers'] + mag['gathers'],
          'timed': {'bipartite_step': ([h for h in bi['hops']
                                        if 'kernel_ms' in h],
                                       [g for g in bi['gathers']
                                        if 'kernel_ms' in g]),
                    'mag_link_batch': (mag['plain_hops'],
                                       mag['plain_gathers']),
                    'mag_with_edge_batch': (
                        [h for h in mag['hops'] if 'kernel_ms' in h],
                        [g for g in mag['gathers'] if 'kernel_ms' in g])}}


def skipgram_loss(torch, emb, ctx, src, dst, neg):
  """`examples/deepwalk.py`'s skip-gram loss: ``-log sigmoid(e_s . c_d)
  - sum log sigmoid(-e_s . c_n)`` over the valid pairs (either end -1 is
  masked), averaged."""
  import torch.nn.functional as F
  ok = (src >= 0) & (dst >= 0)
  s = torch.where(ok, src, 0).long()
  d = torch.where(ok, dst, 0).long()
  es = emb[s]
  pos = (es * ctx[d]).sum(1)
  negs = torch.einsum('ed,end->en', es, ctx[neg.long()])
  loss = -F.logsigmoid(pos) - F.logsigmoid(-negs).sum(1)
  return torch.where(ok, loss, 0.0).sum() / torch.clamp(ok.sum(), min=1)


def deepwalk(torch, dev, mesh_walks=None) -> dict:
  """`examples/deepwalk.py` at its size on ``dev``: the clustered graph
  (2,000 nodes, degree 8, 6 clusters), `random_walk` from every node an
  epoch (length 8, counter draws keyed by the epoch), `walk_edges`
  (window 2), skip-gram with 4 negatives a pair (drawn on the host, so
  the card and the CPU train alike) in batches of 4,096 pairs, Adam
  (0.05), 5 epochs; then the 1-NN cluster accuracy of 500 probes.
  ``mesh_walks(rows, cols, n)`` makes the example's ``--mesh`` arm: it
  returns ``gen_walks(epoch)``, the epoch's ``[n, L + 1]`` walks in
  input ids."""
  from graphlearn_tpu_torch.data.topology import CSRTopo
  from graphlearn_tpu_torch.ops import (CounterDraws, WalkDraws, random_walk,
                                        walk_edges)
  rows, cols, _, labels = clustered_graph(
      n=DW_NODES, deg=DW_DEG, classes=DW_CLASSES, d=DW_D,
      intra_p=DW_INTRA, seed=0)
  n = len(labels)
  topo = CSRTopo((rows, cols), num_nodes=n)
  indptr = torch.from_numpy(np.asarray(topo.indptr, np.int64)).to(dev)
  indices = torch.from_numpy(topo.indices).to(dev)
  gen_walks = mesh_walks(rows, cols, n) if mesh_walks is not None else None
  emb0 = np.random.default_rng(0).normal(0, 0.1, (n, DW_DIM)).astype(
      np.float32)
  emb = torch.nn.Parameter(torch.from_numpy(emb0).to(dev))
  ctx = torch.nn.Parameter(torch.from_numpy(emb0.copy()).to(dev))
  opt = torch.optim.Adam([emb, ctx], lr=DW_LR, eps=1e-8)
  gen = torch.Generator().manual_seed(7)
  losses, secs = [], []
  for epoch in range(DW_EPOCHS):
    if dev != 'cpu':
      torch.cuda.synchronize()
    t0 = time.perf_counter()
    if gen_walks is not None:
      walks = gen_walks(epoch)
    else:
      starts = torch.from_numpy(np.random.default_rng(epoch).permutation(
          n).astype(np.int32)).to(dev)
      walks = random_walk(indptr, indices, starts, WALK_LENGTH,
                          draws=WalkDraws(CounterDraws(epoch, dev)))
    src, dst = walk_edges(walks, window=WALK_WINDOW)
    order = torch.from_numpy(np.random.default_rng(500 + epoch).permutation(
        src.shape[0])).to(dev)
    tot = []
    for lo in range(0, order.shape[0] - DW_PAIRS + 1, DW_PAIRS):
      sl = order[lo:lo + DW_PAIRS]
      neg = torch.randint(0, n, (DW_PAIRS, DW_NEG), generator=gen).to(dev)
      loss = skipgram_loss(torch, emb, ctx, src[sl], dst[sl], neg)
      opt.zero_grad()
      loss.backward()
      opt.step()
      tot.append(loss.detach())
    losses.append(float(torch.stack(tot).mean()))
    if dev != 'cpu':
      torch.cuda.synchronize()
    secs.append(time.perf_counter() - t0)
  e = emb.detach().cpu().numpy()
  e = e / (np.linalg.norm(e, axis=1, keepdims=True) + 1e-9)
  probe = np.random.default_rng(9).permutation(n)[:500]
  sims = e[probe] @ e.T
  sims[np.arange(len(probe)), probe] = -np.inf
  acc = float((labels[sims.argmax(1)] == labels[probe]).mean())
  return {'accuracy': acc, 'epoch_losses': losses, 'epoch_secs': secs}


def walk(torch, indptr, indices, indptr_h, indices_h, is_edge) -> dict:
  """Random walks over the products graph: `random_walk` from all
  2,449,029 nodes (length 8) without and with restarts (0.15),
  `walk_edges` (window 2) over the first corpus, `node2vec_walk` from
  262,144 starts (p 0.25, q 4, window 64), each timed (walk steps/s);
  every consecutive pair of 4,096 walks an edge on the host (or, with
  restarts, a jump back to the start); the card equal to the CPU on a
  4,096-start slice; then DeepWalk on the card and on the CPU."""
  from graphlearn_tpu_torch.ops import (CounterDraws, WalkDraws,
                                        node2vec_walk, random_walk,
                                        walk_edges)
  t_phase = time.perf_counter()
  gen = torch.Generator(device=DEVICE).manual_seed(29)
  starts = torch.randperm(NUM_NODES, generator=gen, device=DEVICE).to(
      torch.int32)
  cpu_csr = (torch.from_numpy(indptr_h), torch.from_numpy(indices_h))
  out = {}

  def check(walks, what, restart=False):
    w = walks[:WALK_CHECK].cpu().numpy()
    a, b = w[:, :-1], w[:, 1:]
    both = (a >= 0) & (b >= 0)
    edge = is_edge(a[both], b[both])
    jump = (b == w[:, :1])[both] if restart else np.zeros_like(edge)
    if not (edge | jump).all():
      raise AssertionError(f'{what}: a walk step is not an edge')
    if not ((b[a < 0] < 0).all() or restart):
      raise AssertionError(f'{what}: a walk left a dead end')
    return {'steps_checked': int(both.sum()), 'restarts': int(
        (jump & ~edge).sum())}

  def timed(fn):
    sync(torch)
    t0 = time.perf_counter()
    res = fn()
    sync(torch)
    return res, time.perf_counter() - t0

  walks = None
  for restart in (0.0, WALK_RESTART):
    def run(dev, s):
      return random_walk(*((indptr, indices) if dev == DEVICE else cpu_csr),
                         s, WALK_LENGTH, restart_prob=restart,
                         draws=WalkDraws(CounterDraws(41, dev)))
    wk, secs = timed(lambda: run(DEVICE, starts))
    rec = check(wk, f'random_walk restart {restart}', restart > 0)
    if not torch.equal(wk[:WALK_CHECK].cpu(),
                       run('cpu', starts[:WALK_CHECK].cpu())):
      raise AssertionError(f'random_walk restart {restart}: card != CPU')
    out[f'random_walk_restart_{restart}'] = dict(
        starts=NUM_NODES, length=WALK_LENGTH, secs=secs,
        walk_steps_per_s=NUM_NODES * WALK_LENGTH / secs,
        valid_share=float((wk[:, -1] >= 0).float().mean()),
        card_equals_cpu=True, **rec)
    if walks is None:
      walks = wk
    del wk
  (src, dst), secs = timed(lambda: walk_edges(walks, window=WALK_WINDOW))
  out['walk_edges'] = {'window': WALK_WINDOW, 'pairs': int(src.numel()),
                       'valid_pairs': int((src >= 0).sum()), 'secs': secs}
  del walks, src, dst
  s2 = starts[:N2V_STARTS]

  def n2v(dev, s):
    return node2vec_walk(*((indptr, indices) if dev == DEVICE else cpu_csr),
                         s, WALK_LENGTH, p=N2V_P, q=N2V_Q,
                         max_degree=N2V_MAX_DEGREE,
                         draws=WalkDraws(CounterDraws(43, dev)))
  wk, secs = timed(lambda: n2v(DEVICE, s2))
  rec = check(wk, 'node2vec_walk')
  if not torch.equal(wk[:WALK_CHECK].cpu(), n2v('cpu',
                                                s2[:WALK_CHECK].cpu())):
    raise AssertionError('node2vec_walk: card != CPU')
  out['node2vec_walk'] = dict(
      starts=N2V_STARTS, length=WALK_LENGTH, p=N2V_P, q=N2V_Q,
      max_degree=N2V_MAX_DEGREE, secs=secs,
      walk_steps_per_s=N2V_STARTS * WALK_LENGTH / secs,
      card_equals_cpu=True, **rec)
  del wk
  dw = {DEVICE: deepwalk(torch, DEVICE), 'cpu': deepwalk(torch, 'cpu')}
  if not dw[DEVICE]['accuracy'] > 1 / DW_CLASSES:
    raise AssertionError(f'DeepWalk 1-NN accuracy {dw[DEVICE]["accuracy"]}')
  out['deepwalk'] = {'card': dw[DEVICE], 'cpu_rehearsal': dw['cpu'],
                     'chance': 1 / DW_CLASSES}
  emit('walk', secs=time.perf_counter() - t_phase, **out)
  return out


def edges_phases(torch, ops, timer, indptr, indices, feats) -> dict:
  """The edge-id and walk phases (`edges`, `edge_loaders`,
  `edges_cross_check`, `hetero_link`, `walk`) over the products graph,
  with its edge ids a permutation and the ``[E, 8]`` edge table; K1's
  forced sets and every arm with the edge-id arm."""
  from graphlearn_tpu_torch.data import Dataset
  from graphlearn_tpu_torch.ops import default_window
  t0 = time.perf_counter()
  perm, table = edge_table(torch, indices)
  ds = (Dataset().init_graph((indptr, indices), edge_ids=perm, layout='CSR',
                             num_nodes=NUM_NODES, device=DEVICE)
        .init_node_features(feats, device=DEVICE)
        .init_edge_features(table, device=DEVICE))
  labels = make_labels(torch, feats)
  ds.init_node_labels(labels)
  indptr_h, indices_h = indptr.cpu().numpy(), indices.cpu().numpy()
  inv_h = inverse_ids(torch, perm)
  sync(torch)
  emit('edge_data', edge_ids=int(perm.numel()),
       edge_table_shape=list(table.shape),
       bytes={'edge_ids': perm.numel() * 4, 'edge_table': table.numel() * 4},
       secs=time.perf_counter() - t0)
  arms = []
  for k in FANOUTS:
    w = default_window(k)
    a_indptr, a_indices, a_seeds = arm_graph(torch, DEVICE, k, w)
    gen = torch.Generator(device=DEVICE).manual_seed(k)
    u = torch.rand(a_seeds.numel(), k, device=DEVICE, generator=gen)
    g = torch.rand(a_seeds.numel(), w, device=DEVICE, generator=gen)
    eid = torch.randperm(a_indices.numel(), generator=gen,
                         device=DEVICE).to(torch.int32)
    for e in (None, eid):
      _, rec = check_sampler(torch, ops, timer, a_indptr, a_indices, a_seeds,
                             k, u, g, edge_ids=e, with_edge_ids=True,
                             time_it=False)
      arms.append(rec['arms'])
  forced = forced_sampler_sets(torch, ops, with_eids=True)
  emit('kernel', kernel='sample_one_hop', shape='forced sets with eids',
       sets=len(forced['sets']), every_arm=arms, byte_equal=True)
  ed = edges(torch, ops, timer, ds, feats, labels, table, inv_h, indptr_h,
             indices_h)
  el = edge_loaders(torch, ops, timer, ds, table, inv_h, indptr_h,
                    indices_h)
  del ds, perm, table, inv_h, labels
  torch.cuda.empty_cache()
  edges_cross_check(torch)
  hl = hetero_link(torch, ops, timer)
  is_edge = edge_lookup(indptr_h, indices_h)
  wk = walk(torch, indptr, indices, indptr_h, indices_h, is_edge)
  del is_edge
  return {'edges': ed, 'edge_loaders': el, 'hetero_link': hl, 'walk': wk,
          'forced_sets': len(forced['sets'])}


#: the mesh's edges and link engine: per-partition seed edges
#: of the link cells (`benchmarks/bench_dist_loader.py`'s ``--batch``),
#: `examples/distributed/dist_unsup_sage.py`'s fanouts and model
MESH_EDGE_BATCHES = 3
MESH_LINK_BATCH = 1024
MESH_LINK_FANOUTS = (5, 5)
MESH_LINK_HIDDEN = 64
MESH_LINK_OUT = 32
MESH_LINK_LR = 1e-3
MESH_LINK_WARM = 2
MESH_LINK_STEPS = 50                # (depth cut, 100 -> 50)
MESH_LINK_GNS_STEPS = 20
MESH_LINK_LOADER_BATCHES = 10      # (depth cut, 20 -> 10)
MESH_LINK_CHECK_BATCHES = 3
#: `dist_unsup_sage.py`'s `synthetic()` and its loop
UNSUP_NODES, UNSUP_CLUSTERS, UNSUP_DEG, UNSUP_DIM = 2000, 8, 6, 32
UNSUP_EPOCHS, UNSUP_BATCH = 4, 32
#: the intra-vs-inter cluster AUC `dist_unsup_sage.py` gives on the JAX
#: package (8 virtual CPU devices, run once with its defaults); the
#: `mesh_unsup` phase fails when the port's AUC is further from it than
#: `UNSUP_AUC_TOL`
UNSUP_JAX_AUC = 0.8092
UNSUP_AUC_TOL = 0.03


def mesh_edge_table(torch, num_edges: int):
  """The mesh's ``[E, 8]`` f32 edge table by global edge id: the input
  edge order, which for `mesh_data`'s COO is the products CSR position
  (1.96 GB, `EDGE_DIM` as in `edges`)."""
  gen = torch.Generator(device=DEVICE).manual_seed(32)
  return torch.rand(num_edges, EDGE_DIM, generator=gen, device=DEVICE)


def check_mesh_edges(torch, batch, table, indptr, indices, new2old) -> int:
  """Every valid ``edge`` id of a stacked mesh batch names its sampled
  edge in the global CSR (the id is the CSR position: it lies in the
  seed-side node's row and holds the neighbor), and ``edge_attr`` is the
  table's row for it; masked slots hold -1 and zero rows.  Returns the
  edges checked."""
  e, em = batch.edge, batch.edge_mask
  ea = batch.edge_attr
  if not (torch.equal(ea[em], table[e[em].long()])
          and not bool(ea[~em].any()) and bool((e[~em] == -1).all())):
    raise AssertionError('a mesh edge_attr row differs from the edge table')
  ei = batch.edge_index.long().clamp(min=0)
  node = batch.node.long()
  nbr = new2old[torch.gather(node, 1, ei[:, 0])]
  seed = new2old[torch.gather(node, 1, ei[:, 1])]
  eid = e.long().clamp(min=0)
  ok = ((indptr[seed] <= eid) & (eid < indptr[seed + 1])
        & (indices[eid].long() == nbr))
  if not bool(ok[em].all()):
    raise AssertionError('a mesh edge id does not name its sampled edge')
  return int(em.sum())


def edge_args_on(rec, what) -> None:
  """Every recorded sampler call ran the edge-id arm with ``edge_ids``
  (mode 2: the shards' global ids)."""
  for i, (e, on) in enumerate(rec.edge_args()):
    if not on or e is None:
      raise AssertionError(f'{what} call {i} ran without edge ids')


def gns_ab(torch, ops, timer, rec, source: str) -> dict:
  """K1-GNS launches without edges, this tree's kernel against the one
  built from ``source`` (another tree's ``sample_one_hop_gns.cu``), at
  each recorded mesh hop: per hop the owners' calls summed, timed in
  turns parent / change / change / parent (one process, one card)."""
  import ctypes
  from graphlearn_tpu_torch import _build
  from graphlearn_tpu_torch.ops import fused_sample as fs
  out_dir = os.path.join(os.path.dirname(_build.BUILD_DIR), 'gns_ab')
  os.makedirs(out_dir, exist_ok=True)
  lib = os.path.join(out_dir, 'parent_gns.so')
  subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, '-I',
                  str(_build.CSRC), '-o', lib, source], check=True,
                 capture_output=True)
  parent = ctypes.CDLL(lib).glt_sample_one_hop_gns
  parent.argtypes = list(fs._GNS_ARGTYPES[:-3]) + [ctypes.c_void_p]
  parent.restype = ctypes.c_int

  def kernel_args(a):
    # the table row of each seed resolved outside the timed calls
    indptr, indices, seeds, k, u, v, bits, boost, req, w = a
    rows = ops.gns.bits_rows(bits, req, seeds.numel(), seeds.device)
    return (indptr, indices, seeds, k, u, v, ops.gns.bits_table(bits),
            rows.contiguous(), boost, w)

  def launch_parent(a):
    indptr, indices, seeds, k, u, v, table, rows, boost, w = a
    b = seeds.shape[0]
    nbrs = torch.empty((b, k), dtype=torch.int32, device=seeds.device)
    mask = torch.empty((b, k), dtype=torch.bool, device=seeds.device)
    wts = torch.empty((b, k), dtype=torch.float32, device=seeds.device)
    err = parent(indptr.data_ptr(), indptr.numel() - 1, indices.data_ptr(),
                 indices.numel(), seeds.data_ptr(), b, u.data_ptr(),
                 v.data_ptr(), table.data_ptr(), table.shape[0],
                 table.shape[1], rows.data_ptr(), k, w,
                 float(boost), nbrs.data_ptr(), mask.data_ptr(),
                 wts.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _build.check(err, 'parent sample_one_hop_gns')
    return nbrs, mask, wts

  def launch_change(a):
    r = fs.gns_kernel(*a)
    return r.nbrs, r.mask, r.weights

  hops = []
  calls = [kernel_args(a) for a in rec.sample_calls()]
  for t in range(rec.hops):
    hop = calls[t * MESH_PARTS:(t + 1) * MESH_PARTS]
    for a in hop:
      p_out, c_out = launch_parent(a), launch_change(a)
      if not all(torch.equal(x, y) for x, y in zip(p_out, c_out)):
        raise AssertionError('the parent and this tree\'s GNS kernels '
                             'differ without edges')
    turns = {'parent': [], 'change': []}
    for who in ('parent', 'change', 'change', 'parent'):
      fn = launch_parent if who == 'parent' else launch_change
      turns[who].append(sum(timer(lambda a=a: fn(a)) for a in hop))
    hops.append({'hop': t, 'rows': sum(int(a[2].numel()) for a in hop),
                 'k': hop[0][3], 'parent_ms': turns['parent'],
                 'change_ms': turns['change'],
                 'change_over_parent': float(np.mean(turns['change'])
                                             / np.mean(turns['parent']))})
  emit('gns_ab', source=source, order='parent / change / change / parent',
       hops=hops)
  return {'hops': hops}


def mesh_edges(torch, ops, timer, ds_u, ds_t, table, indptr, indices, feats,
               labels, ab_source=None) -> dict:
  """`DistNeighborLoader(with_edge=True)` at `mesh_loader`'s settings
  ([15, 10, 5], 512 seeds a partition, shuffled) on both products
  stores with the mod-sharded ``[E, 8]`` edge table: untiered (K1's
  edge-id arm, mode 2, in every owner's hop) and tiered with
  ``gns=True`` (K1-GNS's arm).  A recorded batch and `MESH_EDGE_BATCHES`
  timed ones a store; every batch's ``x``, labels, edge ids and edge
  rows checked on the card; 24 sampler and 24 gather launches a batch;
  every recorded call (24 sampler calls, 24 gathers: edge rows,
  features, labels) held against its plain version, the sampler also
  timed without the arm."""
  import graphlearn_tpu_torch.parallel.dist_sampler as dsm
  from graphlearn_tpu_torch.parallel import DistNeighborLoader
  seeds = np.random.default_rng(0).permutation(NUM_NODES)[
      :MESH_BATCH * MESH_PARTS * (MESH_EDGE_BATCHES + 1)]
  out, paths, recs = {}, {}, {}
  for name, ds, gns in (('untiered', ds_u, False), ('tiered', ds_t, True)):
    # the tiered store's relabel orders each range by in-degree
    new2old = torch.from_numpy(ds.new2old).to(DEVICE)
    kw = {}
    if gns:
      kw['cold_cache_rows'] = int(ds.node_features.hot_counts.max())
    loader = DistNeighborLoader(ds, FANOUTS, seeds, batch_size=MESH_BATCH,
                                shuffle=True, seed=0, with_edge=True,
                                gns=gns, device=DEVICE, **kw)
    s = loader.sampler
    if not (s.collect_edge_features and s.ds.edge_features.mod_sharded
            and s.gns == gns):
      raise AssertionError(f'mesh_edges {name}: the sampler collects no '
                           'mod-sharded edge rows')
    reset_counts(ops)
    it = iter(loader)
    with PathRecorder(torch, dsm, gns=gns, parts=MESH_PARTS,
                      tables=3) as rec:
      b = next(it)
    checked = check_mesh_edges(torch, b, table, indptr, indices, new2old)
    check_mesh_batch(torch, b, feats, labels, new2old)
    batch_ms = []
    for _ in range(MESH_EDGE_BATCHES):
      sync(torch)
      t = time.perf_counter()
      b = next(it)
      n_edges = int(b.edge_mask.sum())              # synchronises
      batch_ms.append((time.perf_counter() - t) * 1e3)
      checked += check_mesh_edges(torch, b, table, indptr, indices, new2old)
      check_mesh_batch(torch, b, feats, labels, new2old)
    launches, plain = read_counts(ops)
    k1 = 'sample_one_hop_gns' if gns else 'sample_one_hop'
    other = 'sample_one_hop' if gns else 'sample_one_hop_gns'
    n = MESH_EDGE_BATCHES + 1
    if not (launches[k1] == len(FANOUTS) * MESH_PARTS * n
            and launches[other] == 0
            and launches['gather_rows'] == 3 * MESH_PARTS * n
            and plain == 0):
      raise AssertionError(f'mesh_edges {name}: launches {launches}, plain '
                           f'{plain}')
    edge_args_on(rec, f'mesh_edges {name}')
    if gns:
      ew, em = b.metadata['edge_weight'], b.edge_mask
      if not (bool((ew[~em] == 0).all()) and bool((ew[em] > 0).all())):
        raise AssertionError('mesh_edges: masked weight != 0 or valid <= 0')
    ef = ds.edge_features.shards
    tables = [g[0] for g in rec.gather_calls_in_order()[::MESH_PARTS]]
    if tables[0].data_ptr() != ef[0].data_ptr():
      raise AssertionError('mesh_edges: the first gathers are not the edge '
                           'rows')
    paths[name] = check_mesh_path(
        torch, ops, timer, rec, f'mesh_edges {name}',
        tables=('edge rows', 'features' if name == 'untiered'
                else 'hot-tier features', 'labels'))
    recs[name] = rec
    st = s.exchange_stats()
    out[name] = {'gns': gns, 'batch_ms': batch_ms,
                 'batches_per_s': 1e3 * len(batch_ms) / sum(batch_ms),
                 'edge_slots': int(b.edge.shape[1]),
                 'edges_checked_on_card': checked,
                 'sampled_edges_last': n_edges,
                 'launches': launches, 'plain_calls': plain,
                 'exchange': {k: v for k, v in st.items()
                              if k.startswith(('dist.frontier',
                                               'dist.feature.o',
                                               'dist.feature.d',
                                               'dist.feature.s'))}}
    del loader, it, b
  ab = gns_ab(torch, ops, timer, recs['tiered'], ab_source) \
      if ab_source else None
  del recs
  emit('mesh_edges', parts=MESH_PARTS, batch=MESH_BATCH,
       fanouts=list(FANOUTS), edge_dim=EDGE_DIM,
       edge_table='mod-sharded [E, 8] f32 by global edge id', **out)
  return {'launches': {k: v['launches'] for k, v in out.items()},
          'paths': paths, 'ab': ab}


def mesh_link_model(torch, in_dim, dev):
  from graphlearn_tpu_torch.models import GraphSAGE
  model = GraphSAGE(in_dim, MESH_LINK_HIDDEN, MESH_LINK_OUT,
                    num_layers=2).to(dev)
  model.reset_parameters(torch.Generator().manual_seed(0))
  return model


def mesh_link_seeds(indptr_h, indices_h, n, seed):
  """``n`` products edges at seeded CSR positions, as (src, dst)."""
  pos = np.random.default_rng(seed).integers(0, indices_h.shape[0], n)
  return np.searchsorted(indptr_h, pos, side='right') - 1, indices_h[pos]


def check_mesh_negatives(torch, batch, new2old_h, is_edge, b) -> tuple:
  """The kept negatives of a stacked binary link batch, mapped through
  ``node`` to input ids: none is an edge of the global CSR.  Returns
  (kept, exhausted) negative slots."""
  md = batch.metadata
  keep = md['edge_label_mask'][:, b:].cpu().numpy()
  eli = md['edge_label_index'][:, :, b:].cpu().numpy()
  node = batch.node.cpu().numpy()
  kept = 0
  for p in range(node.shape[0]):
    src = new2old_h[node[p][eli[p, 0][keep[p]]]]
    dst = new2old_h[node[p][eli[p, 1][keep[p]]]]
    if is_edge(src, dst).any():
      raise AssertionError('a kept mesh negative is an edge')
    kept += int(keep[p].sum())
  return kept, int(keep.size - keep.sum())


def mesh_link(torch, ops, timer, ds_u, ds_t, table, indptr, indices, feats,
              labels, indptr_h, indices_h) -> dict:
  """`examples/distributed/dist_unsup_sage.py`'s engine at products
  scale: `DistLinkNeighborLoader([5, 5], binary)` with 1,024 seed edges
  a partition (shuffled) -> `make_dp_unsupervised_step` with
  ``GraphSAGE(100, 64, 32, 2)`` and Adam(1e-3) on the untiered store
  (`MESH_LINK_WARM` warm steps, the first recorded, `MESH_LINK_STEPS`
  timed steps, the loader alone over `MESH_LINK_LOADER_BATCHES`), then
  on the tiered store with ``gns=True, with_edge=True``
  (`MESH_LINK_GNS_STEPS` steps).  Checks: 16 sampler launches a batch
  (and 16 gathers, 24 with edge rows), no plain call, every recorded
  call byte-equal to its plain version, the losses finite and falling,
  the kept negatives of `MESH_LINK_CHECK_BATCHES` batches non-edges by a
  host lookup, and with edges every id and row checked on the card."""
  import graphlearn_tpu_torch.parallel.dist_sampler as dsm
  from graphlearn_tpu_torch.parallel import (DistLinkNeighborLoader,
                                             make_dp_unsupervised_step)
  is_edge = edge_lookup(indptr_h, indices_h)
  out, paths = {}, {}
  b = MESH_LINK_BATCH
  for name, ds, gns, steps in (
      ('untiered', ds_u, False, MESH_LINK_STEPS),
      ('tiered_gns_with_edge', ds_t, True, MESH_LINK_GNS_STEPS)):
    new2old_h = ds.new2old
    new2old = torch.from_numpy(new2old_h).to(DEVICE)
    n_batches = MESH_LINK_WARM + steps + (
        MESH_LINK_LOADER_BATCHES if not gns else 0)
    src, dst = mesh_link_seeds(indptr_h, indices_h,
                               b * MESH_PARTS * n_batches, 40 + gns)
    kw = {}
    if gns:
      kw['cold_cache_rows'] = int(ds.node_features.hot_counts.max())
    loader = DistLinkNeighborLoader(
        ds, MESH_LINK_FANOUTS, (src, dst), neg_sampling='binary',
        batch_size=b, shuffle=True, seed=0, with_edge=gns, gns=gns,
        device=DEVICE, **kw)
    s = loader.sampler
    model = mesh_link_model(torch, FEAT_DIM, DEVICE)
    opt = torch.optim.Adam(model.parameters(), lr=MESH_LINK_LR, eps=1e-8)
    step = make_dp_unsupervised_step(model, opt, s.mesh)
    it = iter(loader)
    losses = []
    reset_counts(ops)
    tables = 3 if gns else 2
    for i in range(MESH_LINK_WARM):
      if i == 0:
        with PathRecorder(torch, dsm, gns=gns, parts=MESH_PARTS,
                          tables=tables,
                          hops=len(MESH_LINK_FANOUTS)) as rec:
          batch = next(it)
      else:
        batch = next(it)
      losses.append(step(batch))
    sync(torch)
    t0 = time.perf_counter()
    to_check = []
    for i in range(steps):
      batch = next(it)
      losses.append(step(batch))
      if i < MESH_LINK_CHECK_BATCHES:
        to_check.append(batch)
    sync(torch)
    secs = time.perf_counter() - t0
    kept = exhausted = checked = 0
    for batch in to_check:                 # outside the clock
      k_, x_ = check_mesh_negatives(torch, batch, new2old_h, is_edge, b)
      kept, exhausted = kept + k_, exhausted + x_
      check_mesh_batch(torch, batch, feats, labels, new2old)
      if gns:
        checked += check_mesh_edges(torch, batch, table, indptr, indices,
                                    new2old)
    del to_check
    loader_bps = None
    if not gns:
      sync(torch)
      t0 = time.perf_counter()
      for _ in range(MESH_LINK_LOADER_BATCHES):
        last = next(it)
      int(last.edge_mask.sum())
      loader_bps = MESH_LINK_LOADER_BATCHES / (time.perf_counter() - t0)
      del last
    launches, plain = read_counts(ops)
    n_run = MESH_LINK_WARM + steps + (0 if gns else
                                       MESH_LINK_LOADER_BATCHES)
    k1 = 'sample_one_hop_gns' if gns else 'sample_one_hop'
    other = 'sample_one_hop' if gns else 'sample_one_hop_gns'
    per = len(MESH_LINK_FANOUTS) * MESH_PARTS
    if not (launches[k1] == per * n_run and launches[other] == 0
            and launches['gather_rows'] == tables * MESH_PARTS * n_run
            and plain == 0):
      raise AssertionError(f'mesh_link {name}: launches {launches}, plain '
                           f'{plain}, batches {n_run}')
    if gns:
      edge_args_on(rec, 'mesh_link tiered')
    losses = np.array([float(x) for x in losses])
    half = len(losses) // 2
    if not (np.isfinite(losses).all()
            and losses[-5:].mean() < losses[:MESH_LINK_WARM + 3].mean()
            and (gns or losses[half:].mean() < losses[:half].mean())):
      raise AssertionError(f'mesh_link {name}: losses {losses}')
    paths[name] = check_mesh_path(
        torch, ops, timer, rec, f'mesh_link {name}',
        tables=(('edge rows', 'hot-tier features', 'labels') if gns
                else ('features', 'labels')))
    del rec
    st = s.exchange_stats()
    out[name] = {
        'gns': gns, 'steps': steps,
        'step_ms': secs / steps * 1e3,
        'batches_per_s_step': steps / secs,
        'loader_batches_per_s': loader_bps,
        'losses_first': losses[:5].tolist(),
        'losses_last': losses[-5:].tolist(),
        'loss_mean_first_half': float(losses[:half].mean()),
        'loss_mean_second_half': float(losses[half:].mean()),
        'negatives_kept_checked': kept,
        'negatives_masked_checked': exhausted,
        'negative_lost_share': st['dist.negative.lost'] / max(
            b * MESH_PARTS * n_run, 1),
        'edges_checked_on_card': checked, 'launches': launches,
        'plain_calls': plain,
        'exchange': {k: v for k, v in st.items()
                     if k.startswith(('dist.frontier', 'dist.feature.o',
                                      'dist.feature.d', 'dist.feature.s',
                                      'dist.negative'))}}
    del loader, it, batch, model, opt, step
  emit('mesh_link', parts=MESH_PARTS, batch_edges=b,
       fanouts=list(MESH_LINK_FANOUTS), neg_sampling='binary 1.0',
       model=f'GraphSAGE({FEAT_DIM}->{MESH_LINK_HIDDEN}->{MESH_LINK_OUT}, '
             '2 layers)', optimizer=f'Adam({MESH_LINK_LR})', **out)
  return {'launches': {k: v['launches'] for k, v in out.items()},
          'paths': paths}


def unsup_synthetic(n=UNSUP_NODES, clusters=UNSUP_CLUSTERS, deg=UNSUP_DEG,
                    d=UNSUP_DIM, seed=0):
  """`dist_unsup_sage.py`'s `synthetic()`: a clustered graph, 85% of the
  edges inside a cluster, noisy features with a faint cluster
  direction."""
  rng = np.random.default_rng(seed)
  cl = np.arange(n) % clusters
  rows = np.repeat(np.arange(n), deg)
  same = np.where(rng.random(n * deg) < 0.85,
                  (rows + clusters * rng.integers(1, n // clusters,
                                                  n * deg)) % n,
                  rng.integers(0, n, n * deg))
  proto = rng.normal(0, 1, (clusters, d)).astype(np.float32)
  feats = (0.3 * proto[cl]
           + rng.standard_normal((n, d)).astype(np.float32))
  return rows, same, feats, cl


def lecun_normal_(torch, model, seed: int) -> None:
  """Flax's default init, which the example's model starts from: each
  weight from a normal truncated at 2 standard deviations with variance
  1 / fan_in (variance-corrected), biases zero, a GAT attention vector
  Glorot-uniform; drawn on the CPU."""
  gen = torch.Generator().manual_seed(seed)
  with torch.no_grad():
    for name, p in model.named_parameters():
      if name.endswith('bias'):
        p.zero_()
        continue
      if name.rsplit('.', 1)[-1].startswith('att_'):
        # GAT's attention vectors: Flax's glorot_uniform
        bound = (6.0 / (p.shape[0] + p.shape[1])) ** 0.5
        p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=gen))
        continue
      std = (1.0 / p.shape[1]) ** 0.5 / 0.87962566103423978
      w = torch.empty(p.shape, dtype=torch.float32)
      torch.nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                  generator=gen)
      p.copy_(w)


def mesh_unsup(torch, ops, timer) -> dict:
  """`examples/distributed/dist_unsup_sage.py` end to end at its own
  size on the card: `synthetic()` (2,000 nodes, 8 clusters) at P = 8,
  `DistLinkNeighborLoader([5, 5], binary, batch 32, shuffled)` ->
  ``GraphSAGE(32, 64, 32, 2)`` (Flax's init) with Adam(1e-3) through
  `make_dp_unsupervised_step`, 4 epochs; then every node's embedding
  from a `DistNeighborLoader([5, 5], batch 64)` and the AUC of
  intra- against inter-cluster dot products over 2,000 random pairs.
  Checks: 16 K1 and 8 K2 launches a batch of either loader (no labels,
  so one gathered table), no plain call, and the first training batch's
  calls byte-equal to their plain versions."""
  import graphlearn_tpu_torch.parallel.dist_sampler as dsm
  from graphlearn_tpu_torch.models import GraphSAGE
  from graphlearn_tpu_torch.parallel import (DistDataset,
                                             DistLinkNeighborLoader,
                                             DistNeighborLoader,
                                             make_dp_unsupervised_step)
  rows, cols, feats, cl = unsup_synthetic()
  n = len(cl)
  dds = DistDataset.from_full_graph(MESH_PARTS, rows, cols, node_feat=feats,
                                    num_nodes=n, device=DEVICE)
  loader = DistLinkNeighborLoader(
      dds, list(MESH_LINK_FANOUTS), (rows, cols), neg_sampling='binary',
      batch_size=UNSUP_BATCH, shuffle=True, seed=0, device=DEVICE)
  model = GraphSAGE(UNSUP_DIM, MESH_LINK_HIDDEN, MESH_LINK_OUT,
                    num_layers=2).to(DEVICE)
  lecun_normal_(torch, model, 0)
  opt = torch.optim.Adam(model.parameters(), lr=MESH_LINK_LR, eps=1e-8)
  step = make_dp_unsupervised_step(model, opt, loader.sampler.mesh)
  hops = len(MESH_LINK_FANOUTS)

  def check_launches(what, batches):
    launches, plain = read_counts(ops)
    if not (launches['sample_one_hop'] == hops * MESH_PARTS * batches
            and launches['gather_rows'] == MESH_PARTS * batches
            and launches['sample_one_hop_gns'] == 0 and plain == 0):
      raise AssertionError(f'mesh_unsup {what}: launches {launches}, '
                           f'plain {plain}, batches {batches}')
    return launches

  epoch_secs, epoch_loss, steps, rec = [], [], 0, None
  reset_counts(ops)
  for _ in range(UNSUP_EPOCHS):
    sync(torch)
    t0 = time.perf_counter()
    it = iter(loader)
    tot = []
    if rec is None:
      with PathRecorder(torch, dsm, gns=False, parts=MESH_PARTS, tables=1,
                        hops=hops) as rec:
        tot.append(step(next(it)))
    tot += [step(batch) for batch in it]
    epoch_loss.append(float(torch.stack(tot).mean()))
    sync(torch)
    epoch_secs.append(time.perf_counter() - t0)
    steps = len(tot)
  train_launches = check_launches('training', UNSUP_EPOCHS * steps)
  nl = DistNeighborLoader(dds, list(MESH_LINK_FANOUTS), np.arange(n),
                          batch_size=64, device=DEVICE)
  emb = np.zeros((n, MESH_LINK_OUT), np.float32)
  model.eval()
  reset_counts(ops)
  with torch.no_grad():
    for batch in nl:
      seeds = batch.batch.cpu().numpy()
      for p in range(seeds.shape[0]):
        v = seeds[p] >= 0
        out = model(batch.x[p], batch.edge_index[p], batch.edge_mask[p])
        emb[dds.new2old[seeds[p][v]]] = out[:seeds.shape[1]].cpu().numpy()[v]
  embed_launches = check_launches('embedding loader', len(nl))
  path = check_mesh_path(torch, ops, timer, rec, 'mesh_unsup training',
                         tables=('features',))
  del rec
  rng = np.random.default_rng(1)
  a = rng.integers(0, n, 2000)
  b = rng.integers(0, n, 2000)
  same_cl = cl[a] == cl[b]
  score = (emb[a] * emb[b]).sum(1)
  auc = float((score[same_cl][:, None] > score[~same_cl][None, :]).mean())
  launches = {k: train_launches[k] + embed_launches[k]
              for k in train_launches}
  return {'auc': auc, 'epoch_secs': epoch_secs, 'epoch_loss': epoch_loss,
          'steps_per_epoch': steps, 'embed_batches': len(nl),
          'launches': launches, 'paths': {'untiered': path}}


class DevDraws:
  """A CPU draws provider's hop draws and negative candidates, moved to
  ``dev`` (the card and the CPU then sample from the same numbers)."""

  def __init__(self, base, dev):
    self.base, self.dev = base, dev

  def __call__(self, *a, **kw):
    return tuple(t.to(self.dev) for t in self.base(*a, **kw))

  def negatives(self, *a, **kw):
    return self.base.negatives(*a, **kw).to(self.dev)


def mesh_link_cross_check(torch):
  """A small mesh (600 nodes, P = 4, tiered at split 0.3, an ``[E, 8]``
  edge table) on the card and on the CPU with the same CPU-made draws
  (the negatives' too): 3 binary `DistLinkNeighborLoader` batches with
  ``gns=True, with_edge=True`` byte-equal (node, x, edge_index, edge,
  edge_attr, edge_weight, the link metadata), and 2
  `make_dp_unsupervised_step` losses within 1e-5."""
  from graphlearn_tpu_torch.parallel import (DistDataset,
                                             DistLinkNeighborLoader,
                                             TorchDraws,
                                             make_dp_unsupervised_step)
  rng = np.random.default_rng(17)
  n, parts = 600, 4
  rows = np.repeat(np.arange(n), 10)
  cols = np.where(rng.random(n * 10) < 0.3, rng.integers(0, 30, n * 10),
                  rng.integers(0, n, n * 10))
  feats = rng.standard_normal((n, 16)).astype(np.float32)
  etab = rng.standard_normal((rows.shape[0], EDGE_DIM)).astype(np.float32)
  cpu = TorchDraws(18, 'cpu')
  out, losses = {}, {}
  for dev in (DEVICE, 'cpu'):
    ds = DistDataset.from_full_graph(parts, rows, cols, node_feat=feats,
                                     num_nodes=n, split_ratio=0.3,
                                     edge_feat=etab, device=dev)
    lo = DistLinkNeighborLoader(ds, list(MESH_LINK_FANOUTS),
                                (rows[:400], cols[:400]),
                                neg_sampling='binary', batch_size=32,
                                shuffle=True, seed=3, with_edge=True,
                                gns=True, cold_cache_rows=40,
                                draws=DevDraws(cpu, dev), device=dev)
    batches = list(itertools.islice(iter(lo), 3))
    out[dev] = [[t.cpu() for t in (
        b.node, b.x, b.edge_index, b.edge_mask, b.edge, b.edge_attr,
        b.metadata['edge_weight'], b.metadata['edge_label_index'],
        b.metadata['edge_label'], b.metadata['edge_label_mask'])]
        for b in batches]
    model = mesh_link_model(torch, 16, dev)
    opt = torch.optim.Adam(model.parameters(), lr=MESH_LINK_LR, eps=1e-8)
    step = make_dp_unsupervised_step(model, opt, lo.sampler.mesh)
    losses[dev] = [float(step(b)) for b in batches[:2]]
  names = ('node', 'x', 'edge_index', 'edge_mask', 'edge', 'edge_attr',
           'edge_weight', 'edge_label_index', 'edge_label',
           'edge_label_mask')
  for i, (a, c) in enumerate(zip(out[DEVICE], out['cpu'])):
    for name, x, y in zip(names, a, c):
      if x.dtype != y.dtype or not torch.equal(x, y):
        raise AssertionError(f'mesh link card and CPU differ: batch {i} '
                             f'{name}')
  diff = max(abs(x - y) for x, y in zip(losses[DEVICE], losses['cpu']))
  if not diff <= 1e-5:
    raise AssertionError(f'mesh link losses differ by {diff}')
  emit('mesh_link_cross_check', parts=parts, batches=len(out['cpu']),
       byte_equal=True, losses={'card': losses[DEVICE],
                                'cpu': losses['cpu']},
       loss_max_abs_diff=diff)


def mesh_link_phases(torch, ops, timer, ds_u, ds_t, table, indptr, indices,
                     feats, labels, ab_source=None) -> dict:
  """The mesh's edge and link phases on `mesh_data`'s stores (with the
  mod-sharded edge table): `mesh_edges`, `mesh_link`, `mesh_unsup` and
  `mesh_link_cross_check`."""
  indptr_h, indices_h = indptr.cpu().numpy(), indices.cpu().numpy()
  me = mesh_edges(torch, ops, timer, ds_u, ds_t, table, indptr, indices,
                  feats, labels, ab_source=ab_source)
  ml = mesh_link(torch, ops, timer, ds_u, ds_t, table, indptr, indices,
                 feats, labels, indptr_h, indices_h)
  del indptr_h, indices_h
  un = mesh_unsup(torch, ops, timer)
  un['auc_minus_jax'] = un['auc'] - UNSUP_JAX_AUC
  un['within_tol_of_jax'] = bool(abs(un['auc_minus_jax']) <= UNSUP_AUC_TOL)
  emit('mesh_unsup', parts=MESH_PARTS, nodes=UNSUP_NODES,
       epochs=UNSUP_EPOCHS, batch=UNSUP_BATCH, jax_cpu_auc=UNSUP_JAX_AUC,
       tol=UNSUP_AUC_TOL, **{k: v for k, v in un.items() if k != 'paths'})
  if not (un['within_tol_of_jax'] and np.isfinite(un['epoch_loss']).all()
          and un['epoch_loss'][-1] < un['epoch_loss'][0]):
    raise AssertionError(f'mesh_unsup: AUC {un["auc"]} not within '
                         f'{UNSUP_AUC_TOL} of JAX\'s {UNSUP_JAX_AUC}, or '
                         f'losses {un["epoch_loss"]} not falling')
  mesh_link_cross_check(torch)
  return {'edges': me, 'link': ml, 'unsup': un}


#: the mesh engines (`mesh_engines_phases`, `--mesh-engines`): SEAL and
#: DeepWalk on the mesh at their examples' sizes, the subgraph engine at
#: `bench_dist_loader.py --subgraph-worker`'s shape ([5, 5], 32 seeds a
#: partition; one exchange of the closure, then chunks of 512 with edge
#: ids), walks over all products nodes, `FusedDistLinkEpoch` at
#: `mesh_link`'s setup and BiSAGE on the heterogeneous mesh
MESH_SUB_FANOUTS = (5, 5)
MESH_SUB_BATCH = 32
MESH_SUB_BATCHES = 8
MESH_SUB_CHUNK = 512
MESH_WALK_BATCH = 65_536            # starts a partition a walk call
FUSED_LINK_STEPS = 16               # steps an epoch (depth cut)
FUSED_LINK_EVAL_STEPS = 4
MESH_BI_BATCH = BI_BATCH // MESH_PARTS   # 512 seed edges a step
MESH_BI_CHECK_BATCHES = 2
MESH_BI_EDGE_DIM = 8
#: JAX's `examples/seal_link_pred.py --mesh --cpu --data <seal_graph>`
#: (`seal_graph` at `SEAL_NODES` written to an npz) and `examples/
#: deepwalk.py --mesh --cpu`, both on the 8-device virtual CPU mesh, run
#: once with their defaults: the SEAL test accuracy and the DeepWalk 1-NN
#: accuracy the mesh phases are held to within `ENGINES_ACC_TOL`
SEAL_MESH_JAX_ACC = 0.8544
DW_MESH_JAX_ACC = 0.8520
ENGINES_ACC_TOL = 0.03
#: the timer's repetitions for the mesh engines' recorded calls
ENGINES_PATH_REPS = 5


class WindowRecorder:
  """Keeps the mesh sampler's first ``n`` window-gather calls
  ``(indices, starts, w)`` (through the module ``mod`` that calls it)."""

  def __init__(self, mod, n):
    self.mod, self.n = mod, n
    self.real = mod.csr_window_gather
    self.calls = []

  def __call__(self, indices, starts, w):
    if len(self.calls) < self.n:
      self.calls.append((indices, starts, int(w)))
    return self.real(indices, starts, w)

  def __enter__(self):
    self.mod.csr_window_gather = self
    return self

  def __exit__(self, *exc):
    self.mod.csr_window_gather = self.real


def check_window(torch, ops, timer, indices, starts, w) -> dict:
  """K3 against its plain version on one call's inputs (byte-equal), its
  bound (the starts read, the ``[S, w]`` window read and written) and
  its times beside the plain version's and one `index_select` over the
  flat positions."""
  got = ops.csr_window_gather(indices, starts, w)
  ref = ops.csr_window_gather_plain(indices, starts, w)
  sync(torch)
  if not torch.equal(got, ref):
    raise AssertionError(f'window kernel != plain version (w={w}, '
                         f'{int((got != ref).sum())} slots differ)')
  s, e = starts.numel(), indices.numel()
  flat = (starts.clamp(0, e - 1)[:, None] + torch.arange(
      w, device=starts.device)).clamp(max=e - 1).reshape(-1)
  nbytes = s * starts.element_size() + 2 * s * w * 4
  return {'rows': s, 'w': w, 'byte_equal': True, 'max_abs_err': 0,
          'bytes': nbytes, 'bound_us': nbytes / HBM_BYTES_PER_S * 1e6,
          'kernel_ms': timer(lambda: ops.csr_window_gather(indices, starts,
                                                           w)),
          'plain_ms': timer(lambda: ops.csr_window_gather_plain(
              indices, starts, w)),
          'library_ms': timer(lambda: torch.index_select(indices, 0, flat))}


def check_windows(torch, ops, timer, wrec, what) -> list:
  """Every recorded K3 call, summed over each group of the 8 owners'
  calls (a chunk, or its edge-id twin), one ``kernel`` line a group."""
  out = []
  for g in range(len(wrec.calls) // MESH_PARTS):
    recs = [check_window(torch, ops, timer, *a)
            for a in wrec.calls[g * MESH_PARTS:(g + 1) * MESH_PARTS]]
    out.append(summed(recs))
    emit('kernel', kernel='csr_window_gather',
         shape=f'{what} window group {g}, {MESH_PARTS} owners', **out[-1])
  return out


def require_counts(ops, what, per_batch: dict, batches: int) -> dict:
  """The kernels' launches since `reset_counts` must be ``per_batch``
  times ``batches`` for every kernel (0 for the others), with no plain
  call."""
  launches, plain = read_counts(ops)
  want = {k: per_batch.get(k, 0) * batches for k in launches}
  if launches != want or plain:
    raise AssertionError(f'{what}: launches {launches}, want {want}, plain '
                         f'calls {plain}')
  return launches


def seal_links(n, rows, cols):
  """`seal`'s targets: ``SEAL_LINKS`` positive links (removed from the
  graph with their reverses) and as many non-edges, shuffled; returns
  ``(pairs [2m, 2], labels, kept edge mask)``."""
  edge_set = set(zip(rows.tolist(), cols.tolist()))
  rng = np.random.default_rng(1)
  m = SEAL_LINKS
  pos_idx = rng.choice(len(rows), m, replace=False)
  pos = np.stack([rows[pos_idx], cols[pos_idx]], 1)
  pos_pairs = set(map(tuple, pos.tolist()))
  drop = np.fromiter(((r, c) in pos_pairs or (c, r) in pos_pairs
                      for r, c in zip(rows.tolist(), cols.tolist())), bool,
                     len(rows))
  neg = []
  while len(neg) < m:
    u, v = rng.integers(0, n, 2)
    if (u, v) not in edge_set and (v, u) not in edge_set and u != v:
      neg.append((u, v))
  pairs = np.concatenate([pos, np.asarray(neg)])
  labels = np.concatenate([np.ones(m), np.zeros(m)]).astype(np.int64)
  order = rng.permutation(2 * m)
  return pairs[order], labels[order], ~drop


def check_induced(torch, batch, new2old, indptr_h, indices_h,
                  is_edge) -> int:
  """Every valid induced edge of a stacked subgraph batch maps through
  ``new2old`` to an edge of the host CSR (``is_edge``), and each
  partition's edge count equals the host's count of edges among its
  node table.  Returns the edges checked."""
  node = batch.node.cpu().numpy()
  ei = batch.edge_index.cpu().numpy()
  em = batch.edge_mask.cpu().numpy()
  inset = np.zeros(indptr_h.shape[0] - 1, bool)
  total = 0
  for p in range(node.shape[0]):
    old = new2old[node[p][node[p] >= 0]]
    u = new2old[node[p][ei[p, 0][em[p]]]]
    v = new2old[node[p][ei[p, 1][em[p]]]]
    if not is_edge(u, v).all():
      raise AssertionError('an induced mesh edge is not an edge')
    inset[old] = True
    want = sum(int(inset[indices_h[indptr_h[x]:indptr_h[x + 1]]].sum())
               for x in old)
    inset[old] = False
    if int(em[p].sum()) != want:
      raise AssertionError(f'a mesh subgraph has {int(em[p].sum())} edges, '
                           f'the host counts {want}')
    total += want
  return total


def mesh_seal(torch, ops, timer) -> dict:
  """`examples/seal_link_pred.py --mesh` at P = 8 on `seal`'s graph
  (Cora's size, the 256 target links removed): `DistSubGraphLoader([8],
  batch 2 a partition)`, one link's enclosing subgraph a partition, 8
  links a batch; DRNL labels on the host; `seal_model` trained as in
  `seal`.  Checks: 8 K1 and 8 K3 launches a batch (the exact window
  hop), no K2, no plain call; the first batch's K1 and K3 calls
  byte-equal to their plain versions; every induced edge and every
  partition's edge count held against the host; the test accuracy
  within `ENGINES_ACC_TOL` of JAX's mesh example."""
  import graphlearn_tpu_torch.parallel.dist_sampler as dsm
  import torch.nn.functional as F
  from graphlearn_tpu_torch.parallel import DistDataset, DistSubGraphLoader
  t_phase = time.perf_counter()
  rows, cols, _ = seal_graph(n=SEAL_NODES, clusters=SEAL_CLUSTERS,
                             deg=SEAL_DEG)
  n = SEAL_NODES
  pairs, labels, keep = seal_links(n, rows, cols)
  dds = DistDataset.from_full_graph(MESH_PARTS, rows[keep], cols[keep],
                                    num_nodes=n, device=DEVICE)
  loader = DistSubGraphLoader(dds, list(SEAL_FANOUTS), pairs.reshape(-1),
                              batch_size=2, collect_features=False, seed=0,
                              device=DEVICE)
  s = loader.sampler
  if not s.exact_window:
    raise AssertionError('mesh SEAL: the default window is not exact')
  g = dds.graph
  indptr_h = np.zeros(n + 1, np.int64)
  obs = np.lexsort((cols[keep], rows[keep]))
  indptr_h[1:] = np.cumsum(np.bincount(rows[keep], minlength=n))
  indices_h = cols[keep][obs]
  is_edge = edge_lookup(indptr_h, indices_h)
  reset_counts(ops)
  sync(torch)
  t0 = time.perf_counter()
  sub, checked = [], 0
  it = iter(loader)
  with PathRecorder(torch, dsm, gns=False, parts=MESH_PARTS, tables=0,
                    hops=len(SEAL_FANOUTS), first=True) as rec, \
      WindowRecorder(dsm, MESH_PARTS) as wrec:
    first = next(it)
  for i, batch in enumerate(itertools.chain([first], it)):
    checked += check_induced(torch, batch, dds.new2old, indptr_h, indices_h,
                             is_edge)
    nmask = batch.node_mask.cpu().numpy()
    ei = batch.edge_index.cpu().numpy()
    em = batch.edge_mask.cpu().numpy()
    mapping = batch.metadata['mapping'].cpu().numpy()
    for p in range(MESH_PARTS):
      link = i * MESH_PARTS + p
      if link >= len(labels) or mapping[p, 0] < 0:
        continue
      lab = drnl(nmask[p], ei[p], em[p], int(mapping[p, 0]),
                 int(mapping[p, 1]))
      sub.append(tuple(torch.from_numpy(a).to(DEVICE)
                       for a in (lab, ei[p], em[p], nmask[p]))
                 + (torch.tensor(labels[link], device=DEVICE),))
  extract_secs = time.perf_counter() - t0
  n_batches = len(loader)
  launches = require_counts(ops, 'mesh SEAL', {
      'sample_one_hop': MESH_PARTS * len(SEAL_FANOUTS),
      'csr_window_gather': MESH_PARTS}, n_batches)
  path = check_mesh_path(torch, ops, timer, rec, 'mesh SEAL', tables=())
  windows = check_windows(torch, ops, timer, wrec, 'mesh SEAL')
  del rec, wrec
  model = seal_model(torch).to(DEVICE)
  opt = torch.optim.Adam(model.parameters(), lr=SEAL_LR)
  ntr = int(0.8 * len(sub))
  means = []
  t0 = time.perf_counter()
  for _ in range(SEAL_EPOCHS):
    tot = torch.zeros((), device=DEVICE)
    for lab, ei, em, nm, y in sub[:ntr]:
      opt.zero_grad(set_to_none=True)
      loss = F.cross_entropy(model(lab, ei, em, nm)[None], y[None])
      loss.backward()
      opt.step()
      tot += loss.detach()
    means.append(float(tot) / ntr)
  train_secs = time.perf_counter() - t0
  model.eval()
  with torch.no_grad():
    correct = sum(int(torch.argmax(model(lab, ei, em, nm)) == y)
                  for lab, ei, em, nm, y in sub[ntr:])
  acc = correct / max(len(sub) - ntr, 1)
  out = dict(graph={'nodes': n, 'edges': int(keep.sum())},
             parts=MESH_PARTS, links=len(labels), batches=n_batches,
             subgraphs=len(sub), max_degree=s.max_degree,
             node_cap=int(first.node.shape[1]), extract_secs=extract_secs,
             links_per_s=len(sub) / extract_secs,
             induced_edges_checked=checked, train_secs=train_secs,
             epoch_mean_losses=means, test_links=len(sub) - ntr,
             test_accuracy=acc, jax_mesh_accuracy=SEAL_MESH_JAX_ACC,
             minus_jax=acc - SEAL_MESH_JAX_ACC, launches=launches,
             secs=time.perf_counter() - t_phase)
  emit('mesh_seal', **out)
  if not (len(sub) == len(labels) and np.isfinite(means).all()
          and means[-1] < means[0]
          and abs(acc - SEAL_MESH_JAX_ACC) <= ENGINES_ACC_TOL):
    raise AssertionError(f'mesh SEAL: {len(sub)} subgraphs, losses {means}, '
                         f'test accuracy {acc} (JAX {SEAL_MESH_JAX_ACC})')
  return {'launches': launches, 'hops': path['hops'], 'windows': windows,
          'out': out}


def mesh_subgraph(torch, ops, timer, ds, feats, labels, indptr_h,
                  indices_h, is_edge) -> dict:
  """The subgraph engine at products scale (`bench_dist_loader.py
  --subgraph-worker`'s shape on `mesh_data`'s untiered store): [5, 5]
  closures of 32 shuffled seeds a partition, features and labels
  collected, run once with one exchange of the whole closure and once
  in chunks of `MESH_SUB_CHUNK` with edge ids.  Checks: 16 K1 and 16 K2
  launches a batch and 8 K3 a chunk (16 with edge ids), no plain call,
  the first batch's calls byte-equal, every induced edge and each
  partition's edge count against the host, rows and labels equal their
  sources, the edge ids name their edges, and both runs the same
  subgraphs on the same seeds."""
  import graphlearn_tpu_torch.parallel.dist_sampler as dsm
  from graphlearn_tpu_torch.parallel import DistSubGraphLoader
  new2old = torch.from_numpy(ds.new2old).to(DEVICE)
  seeds = np.random.default_rng(1).integers(
      0, NUM_NODES, MESH_SUB_BATCH * MESH_PARTS * MESH_SUB_BATCHES)
  indptr = torch.from_numpy(indptr_h).to(DEVICE)
  indices = torch.from_numpy(indices_h).to(DEVICE)
  runs, kept = {}, {}
  for name, chunk, edge in (('one_exchange', None, False),
                            (f'chunk_{MESH_SUB_CHUNK}', MESH_SUB_CHUNK,
                             True)):
    loader = DistSubGraphLoader(ds, list(MESH_SUB_FANOUTS), seeds,
                                batch_size=MESH_SUB_BATCH, shuffle=True,
                                seed=0, hop_chunk=chunk, with_edge=edge,
                                device=DEVICE)
    s = loader.sampler
    node_cap = s.node_capacity(MESH_SUB_BATCH)
    n_chunks = -(-node_cap // (chunk or node_cap))
    per = {'sample_one_hop': MESH_PARTS * len(MESH_SUB_FANOUTS),
           'gather_rows': 2 * MESH_PARTS,
           'csr_window_gather': n_chunks * MESH_PARTS * (2 if edge else 1)}
    it = iter(loader)
    reset_counts(ops)
    with PathRecorder(torch, dsm, gns=False, parts=MESH_PARTS, tables=2,
                      hops=len(MESH_SUB_FANOUTS), first=True) as rec, \
        WindowRecorder(dsm, per['csr_window_gather']) as wrec:
      first = next(it)
    sync(torch)
    t0 = time.perf_counter()
    batches = [first] + list(it)
    sync(torch)
    secs = time.perf_counter() - t0
    launches = require_counts(ops, f'mesh subgraph {name}', per,
                              len(batches))
    checked = check_induced(torch, first, ds.new2old, indptr_h, indices_h,
                            is_edge)
    check_mesh_batch(torch, first, feats, labels, new2old)
    if edge:
      em = first.edge_mask
      e = first.edge.long().clamp(min=0)
      node = first.node.long()
      ei = first.edge_index.long().clamp(min=0)
      u = new2old[torch.gather(node, 1, ei[:, 0])]
      v = new2old[torch.gather(node, 1, ei[:, 1])]
      ok = ((indptr[u] <= e) & (e < indptr[u + 1])
            & (indices[e].long() == v))
      if not (bool(ok[em].all()) and bool((first.edge[~em] == -1).all())):
        raise AssertionError('a mesh subgraph edge id does not name its '
                             'edge')
    kept[name] = [b.edge_index for b in batches]
    path = check_mesh_path(torch, ops, timer, rec, f'mesh subgraph {name}',
                           tables=('features', 'labels'))
    windows = check_windows(torch, ops, timer, wrec,
                            f'mesh subgraph {name}')
    st = s.exchange_stats()
    runs[name] = {
        'hop_chunk': chunk, 'with_edge': edge, 'node_cap': node_cap,
        'max_degree': s.max_degree, 'n_chunks': n_chunks,
        # one owner's window reply: P requesters x the chunk x the width
        'reply_elements_per_owner': MESH_PARTS * min(chunk or node_cap,
                                                     node_cap)
        * s.max_degree,
        'batches': len(batches), 'secs_after_first': secs,
        'seeds_per_s': (len(batches) - 1) * MESH_SUB_BATCH * MESH_PARTS
        / secs,
        'induced_edges_first_batch': checked, 'launches': launches,
        'frontier_dropped': st['dist.frontier.dropped'],
        'path': path, 'windows': windows}
    del loader, it, batches, first, rec, wrec
  a, b = kept.values()
  if not all(torch.equal(x, y) for x, y in zip(a, b)):
    raise AssertionError('mesh subgraph: the chunked run gave other '
                         'subgraphs')
  emit('mesh_subgraph', parts=MESH_PARTS, fanouts=list(MESH_SUB_FANOUTS),
       batch=MESH_SUB_BATCH, same_subgraphs=True,
       **{k: {kk: vv for kk, vv in v.items() if kk not in ('path',
                                                            'windows')}
          for k, v in runs.items()})
  return runs


def mesh_walks_fn(torch, dev):
  """`examples/deepwalk.py --mesh`'s walk generator on ``dev``: the
  graph on a P = 8 store, `DistRandomWalker` (length `WALK_LENGTH`,
  seed 0), every node a start each epoch (a seeded permutation, -1
  padded to a multiple of P), the walks mapped back to input ids."""
  from graphlearn_tpu_torch.parallel import DistDataset, DistRandomWalker

  def make(rows, cols, n):
    ds = DistDataset.from_full_graph(MESH_PARTS, rows, cols, num_nodes=n,
                                     device=dev)
    walker = DistRandomWalker(ds, WALK_LENGTH, seed=0, device=dev)
    new2old = torch.from_numpy(ds.new2old).to(dev)

    def gen_walks(epoch):
      starts = ds.old2new[np.random.default_rng(epoch).permutation(n)]
      per = -(-n // MESH_PARTS)
      padded = np.full(per * MESH_PARTS, -1, np.int64)
      padded[:n] = starts
      w = walker.walk(padded.reshape(MESH_PARTS, per)).reshape(
          -1, WALK_LENGTH + 1)
      return torch.where(w >= 0, new2old[w.long().clamp(min=0)], -1).to(
          torch.int32)
    return gen_walks
  return make


def mesh_walk(torch, ops, timer, ds, indptr_h, indices_h, is_edge) -> dict:
  """The walk engine: walks of length `WALK_LENGTH` from all products
  nodes (shuffled) at P = 8, `MESH_WALK_BATCH` starts a partition a call,
  exact exchange; then `examples/deepwalk.py --mesh` at its size on the
  card.  Checks: 8 K1 launches a walk step, no plain call, the first
  call's first two steps' K1 calls byte-equal, every consecutive valid
  pair of the first `WALK_CHECK` walks an edge of the host CSR and an
  ended walk ended, the card's walks equal the CPU's on a `WALK_CHECK`-
  start slice, the DeepWalk 1-NN accuracy within `ENGINES_ACC_TOL` of
  JAX's mesh example."""
  import graphlearn_tpu_torch.parallel.dist_sampler as dsm
  from graphlearn_tpu_torch.parallel import (DistDataset, DistGraph,
                                             DistRandomWalker, TorchDraws)
  t_phase = time.perf_counter()
  walker = DistRandomWalker(ds, WALK_LENGTH, seed=0, device=DEVICE)
  gen = torch.Generator(device=DEVICE).manual_seed(31)
  perm = torch.randperm(NUM_NODES, generator=gen, device=DEVICE).cpu()
  starts = ds.old2new[perm.numpy()]
  per_call = MESH_WALK_BATCH * MESH_PARTS
  calls = -(-NUM_NODES // per_call)
  padded = np.full(calls * per_call, -1, np.int64)
  padded[:NUM_NODES] = starts
  padded = padded.reshape(calls, MESH_PARTS, MESH_WALK_BATCH)
  reset_counts(ops)
  with PathRecorder(torch, dsm, gns=False, parts=MESH_PARTS, tables=0,
                    hops=2, first=True) as rec:
    first = walker.walk(padded[0])
  sync(torch)
  t0 = time.perf_counter()
  rest = [walker.walk(padded[c]) for c in range(1, calls)]
  sync(torch)
  secs = time.perf_counter() - t0
  launches = require_counts(ops, 'mesh walk', {
      'sample_one_hop': MESH_PARTS * WALK_LENGTH}, calls)
  w = first.reshape(-1, WALK_LENGTH + 1)[:WALK_CHECK].cpu().numpy()
  old = np.where(w >= 0, ds.new2old[np.maximum(w, 0)], -1)
  a, b = old[:, :-1], old[:, 1:]
  both = (a >= 0) & (b >= 0)
  if not (is_edge(a[both], b[both]).all() and (b[a < 0] < 0).all()):
    raise AssertionError('mesh walk: a step is not an edge, or an ended '
                         'walk moved')
  valid_share = float((torch.cat([first] + rest, 1)[..., -1] >= 0).sum()
                      / NUM_NODES)
  path = check_mesh_path(torch, ops, timer, rec, 'mesh walk', tables=())
  del rec, first, rest
  # card = CPU on a slice, both from the same CPU-made draws
  g = ds.graph
  cpu_ds = DistDataset(DistGraph(g.indptr.cpu(), g.indices.cpu(),
                                 g.edge_ids.cpu(), g.bounds), device='cpu',
                       old2new=ds.old2new)
  sl = padded[0][:, :WALK_CHECK // MESH_PARTS]
  draws = TorchDraws(37, 'cpu')
  got = {dev: DistRandomWalker(d, WALK_LENGTH, draws=DevDraws(draws, dev),
                               device=dev).walk(sl).cpu()
         for dev, d in ((DEVICE, ds), ('cpu', cpu_ds))}
  if not torch.equal(got[DEVICE], got['cpu']):
    raise AssertionError('mesh walk: card != CPU')
  del cpu_ds, got
  dw = deepwalk(torch, DEVICE, mesh_walks=mesh_walks_fn(torch, DEVICE))
  out = {'starts': NUM_NODES, 'length': WALK_LENGTH, 'calls': calls,
         'starts_per_call': per_call,
         'secs_after_first': secs,
         'walk_steps_per_s': (calls - 1) * per_call * WALK_LENGTH / secs,
         'valid_share_at_end': valid_share, 'steps_checked': int(
             both.sum()), 'card_equals_cpu_starts': WALK_CHECK,
         'launches': launches, 'deepwalk': dw,
         'deepwalk_jax_mesh_accuracy': DW_MESH_JAX_ACC,
         'deepwalk_minus_jax': dw['accuracy'] - DW_MESH_JAX_ACC,
         'secs': time.perf_counter() - t_phase}
  emit('mesh_walk', **out)
  if not abs(dw['accuracy'] - DW_MESH_JAX_ACC) <= ENGINES_ACC_TOL:
    raise AssertionError(f'mesh DeepWalk accuracy {dw["accuracy"]} not '
                         f'within {ENGINES_ACC_TOL} of JAX\'s '
                         f'{DW_MESH_JAX_ACC}')
  return {'launches': launches, 'hops': path['hops'], 'out': out}


class LoaderDraws:
  """A fused mesh epoch's ``draws(epoch, step, ...)`` in the per-batch
  loader's ``draws(step, ...)`` form: loader step ``s`` (from 1) is step
  ``(s - 1) % steps`` of epoch ``(s - 1) // steps + 1``."""

  def __init__(self, draws, steps):
    self.draws, self.steps = draws, steps

  def _at(self, step):
    return (step - 1) // self.steps + 1, (step - 1) % self.steps

  def __call__(self, step, hop, rows, k, w, gns=False, owner=0):
    return self.draws(*self._at(step), hop, rows, k, w, gns, owner)

  def negatives(self, step, stream, trials, r, high, part=None):
    return self.draws.negatives(*self._at(step), stream, trials, r, high,
                                part=part)


def mesh_fused_link(torch, ops, timer, ds, indptr_h, indices_h) -> dict:
  """`FusedDistLinkEpoch` at `mesh_link`'s setup on the untiered
  products store ([5, 5], binary, 1,024 seed edges a partition,
  ``GraphSAGE(100, 64, 32, 2)``, Adam 1e-3; `FUSED_LINK_STEPS` steps an
  epoch) against the DP loop (`DistLinkNeighborLoader` +
  `make_dp_unsupervised_step`) at the same draws and initial
  parameters: epoch 1 of both under deterministic algorithms (losses
  within 1e-5), epoch 2 of both timed.  Checks: the first two batches
  byte-equal, the first step's K1 and K2 calls byte-equal, 16 K1 and 16
  K2 launches a step in both, no plain call, the losses falling; then
  `evaluate`'s AUC over held-out edges (reported: the features are
  noise)."""
  import graphlearn_tpu_torch.parallel.dist_sampler as dsm
  from graphlearn_tpu_torch.parallel import (DistLinkNeighborLoader,
                                             FusedDistLinkEpoch,
                                             make_dp_unsupervised_step)
  b = MESH_LINK_BATCH
  src, dst = mesh_link_seeds(indptr_h, indices_h,
                             b * MESH_PARTS * FUSED_LINK_STEPS, 50)
  hs, hd = mesh_link_seeds(indptr_h, indices_h,
                           b * MESH_PARTS * FUSED_LINK_EVAL_STEPS, 51)
  models = [mesh_link_model(torch, FEAT_DIM, DEVICE) for _ in range(2)]
  opts = [torch.optim.Adam(m.parameters(), lr=MESH_LINK_LR, eps=1e-8)
          for m in models]
  fe = FusedDistLinkEpoch(ds, MESH_LINK_FANOUTS, (src, dst), models[0],
                          opts[0], batch_size=b, neg_sampling='binary',
                          seed=0, device=DEVICE)
  lo = DistLinkNeighborLoader(ds, MESH_LINK_FANOUTS, (src, dst),
                              neg_sampling='binary', batch_size=b,
                              shuffle=True, seed=0,
                              draws=LoaderDraws(fe.draws, len(fe)),
                              device=DEVICE)
  step = make_dp_unsupervised_step(models[1], opts[1], lo.sampler.mesh)
  kept = []
  real_collate = fe._collate

  def collate(*a):
    batch = real_collate(*a)
    if len(kept) < 2:
      kept.append(batch)
    return batch
  fe._collate = collate
  per = {'sample_one_hop': 2 * MESH_PARTS, 'gather_rows': 2 * MESH_PARTS}
  losses, secs, launches = {}, {}, {}
  for epoch in (1, 2):
    deterministic = epoch == 1
    torch.use_deterministic_algorithms(deterministic, warn_only=True)
    try:
      reset_counts(ops)
      sync(torch)
      t0 = time.perf_counter()
      if epoch == 1:
        with PathRecorder(torch, dsm, gns=False, parts=MESH_PARTS, tables=2,
                          hops=len(MESH_LINK_FANOUTS), first=True) as rec:
          fused = fe.run().losses
      else:
        fused = fe.run().losses
      fused = fused.cpu().numpy()
      secs[f'fused_{epoch}'] = time.perf_counter() - t0
      launches[f'fused_{epoch}'] = require_counts(
          ops, f'FusedDistLinkEpoch epoch {epoch}', per, len(fe))
      loop_batches = []
      reset_counts(ops)
      sync(torch)
      t0 = time.perf_counter()
      loop = []
      for i, batch in enumerate(lo):
        loop.append(step(batch))
        if epoch == 1 and i < 2:
          loop_batches.append(batch)
      loop = torch.stack(loop).cpu().numpy()
      secs[f'loop_{epoch}'] = time.perf_counter() - t0
      launches[f'loop_{epoch}'] = require_counts(
          ops, f'mesh link DP loop epoch {epoch}', per, len(fe))
    finally:
      torch.use_deterministic_algorithms(False)
    losses[epoch] = (fused, loop)
    if epoch == 1:
      fe._collate = real_collate
      for i, (x, y) in enumerate(zip(kept, loop_batches)):
        for f in ('node', 'x', 'edge_index', 'edge_mask', 'batch'):
          if not torch.equal(getattr(x, f), getattr(y, f)):
            raise AssertionError(f'fused link batch {i} {f} != the loader')
        for k in ('edge_label_index', 'edge_label', 'edge_label_mask'):
          if not torch.equal(x.metadata[k], y.metadata[k]):
            raise AssertionError(f'fused link batch {i} {k} != the loader')
      del kept, loop_batches
  diff = {e: float(np.abs(f - l).max()) for e, (f, l) in losses.items()}
  allf = np.concatenate([losses[1][0], losses[2][0]])
  if not (diff[1] <= 1e-5 and np.isfinite(allf).all()
          and allf[-4:].mean() < allf[:4].mean()):
    raise AssertionError(f'FusedDistLinkEpoch: losses {losses}, max diff '
                         f'{diff}')
  path = check_mesh_path(torch, ops, timer, rec, 'FusedDistLinkEpoch step',
                         tables=('features', 'labels'))
  del rec
  t0 = time.perf_counter()
  auc = fe.evaluate((hs, hd))
  eval_secs = time.perf_counter() - t0
  steps = len(fe)
  out = {'steps_per_epoch': steps, 'batch_edges': b,
         'fanouts': list(MESH_LINK_FANOUTS),
         'fused_s_per_step': secs['fused_2'] / steps,
         'loop_s_per_step': secs['loop_2'] / steps,
         'fused_over_loop': secs['fused_2'] / secs['loop_2'],
         'deterministic_epoch_s': {'fused': secs['fused_1'],
                                   'loop': secs['loop_1']},
         'loss_max_abs_diff': diff,
         'losses_fused': allf.tolist(),
         'eval_auc': auc, 'eval_edges': int(len(hs)),
         'eval_secs': eval_secs, 'launches': launches,
         'batches_byte_equal': 2}
  emit('mesh_fused_link', **out)
  # the products recipe's features are noise: the AUC is reported, not
  # gated
  if not 0.0 <= auc <= 1.0:
    raise AssertionError(f'FusedDistLinkEpoch AUC {auc}')
  del fe, lo, step, models, opts
  return {'launches': launches, 'hops': path['hops'],
          'gathers': path['gathers'], 'out': out}


def bisage_dp_step(torch, model, opt):
  """The bipartite example's step data-parallel over a stacked
  `HeteroBatch`: the mean over the partitions of each piece's
  `bisage_loss`, its gradient (the mean of the pieces' gradients), one
  optimizer step.  The partitions run as one union graph
  (`union_graph`): one forward and one backward for all of them.
  Returns the loss."""
  import torch.nn.functional as F

  def step(stacked):
    model.train()
    opt.zero_grad(set_to_none=True)
    h = model(*union_graph(torch, stacked))
    md = stacked.metadata
    eli = md['edge_label_index'].long()                 # [P, 2, L]
    parts = eli.shape[0]
    at = torch.arange(parts, device=eli.device)[:, None]
    hu = h[BI_USER].reshape(parts, -1, h[BI_USER].shape[-1])
    hv = h[BI_ITEM].reshape(parts, -1, h[BI_ITEM].shape[-1])
    eu = hu[at, eli[:, 0].clamp(0, hu.shape[1] - 1)]
    ev = hv[at, eli[:, 1].clamp(0, hv.shape[1] - 1)]
    ls = F.binary_cross_entropy_with_logits(
        (eu * ev).sum(-1), torch.clamp(md['edge_label'], max=1).float(),
        reduction='none')
    w = (md['edge_label_mask'] & (eli[:, 0] >= 0)
         & (eli[:, 1] >= 0)).float()
    loss = ((ls * w).sum(1) / w.sum(1).clamp(min=1.0)).mean()
    loss.backward()
    opt.step()
    return loss.detach()
  return step


def bipartite_mesh_store(torch, dev, urow, icol, ufeat, ifeat, tr):
  """The click graph's training edges (ids: their indices into the whole
  click list) on a P = 8 heterogeneous store on ``dev`` with an ``[E,
  8]`` f32 table an edge type by global id, made on ``dev`` from a
  seed."""
  from graphlearn_tpu_torch.parallel import DistHeteroDataset
  m = len(urow)
  tabs = {}
  for i, et in enumerate((BI_ET, BI_ET_REV)):
    gen = torch.Generator(device=dev).manual_seed(60 + i)
    tabs[et] = torch.rand(m, MESH_BI_EDGE_DIM, generator=gen, device=dev)
  edges = {BI_ET: (urow[tr], icol[tr]), BI_ET_REV: (icol[tr], urow[tr])}
  ds = DistHeteroDataset.from_full_graph(
      MESH_PARTS, edges, node_feat_dict={BI_USER: ufeat, BI_ITEM: ifeat},
      num_nodes_dict={BI_USER: len(ufeat), BI_ITEM: len(ifeat)},
      edge_ids_dict={BI_ET: tr, BI_ET_REV: tr}, edge_feat_dict=tabs,
      device=dev)
  return ds, tabs


def check_hetero_link_batch(torch, batch, ds, tabs, urow, icol,
                            train_set) -> tuple:
  """A stacked bipartite link batch: every sampled edge id is a click
  from the seed-side node to the neighbor and its row the table's (-1
  and zero rows where masked), and the kept negatives are not training
  clicks.  Returns (edges checked, negatives kept)."""
  from graphlearn_tpu_torch.typing import reverse_edge_type
  emitted = {reverse_edge_type(et): et for et in (BI_ET, BI_ET_REV)}
  checked = 0
  for ret, e in batch.metadata['edge_dict'].items():
    et = emitted[ret]
    em = batch.edge_mask_dict[ret]
    ea = batch.edge_attr_dict[ret]
    if not (torch.equal(ea[em], tabs[et][e[em].long()])
            and not bool(ea[~em].any()) and bool((e[~em] == -1).all())):
      raise AssertionError(f'a hetero mesh edge row differs ({ret})')
    e_h, em_h = e.cpu().numpy(), em.cpu().numpy()
    ei = batch.edge_index_dict[ret].cpu().numpy()
    nb_t, sd_t = ret[0], ret[2]
    ends = (urow, icol) if et == BI_ET else (icol, urow)
    for p in range(MESH_PARTS):
      nb = ds.new2old[nb_t][batch.node_dict[nb_t][p].cpu().numpy()[
          ei[p, 0][em_h[p]]]]
      sd = ds.new2old[sd_t][batch.node_dict[sd_t][p].cpu().numpy()[
          ei[p, 1][em_h[p]]]]
      ids = e_h[p][em_h[p]]
      if not ((ends[0][ids] == sd).all() and (ends[1][ids] == nb).all()):
        raise AssertionError(f'a hetero mesh edge id does not name its '
                             f'edge ({ret})')
      checked += len(ids)
  md = batch.metadata
  eli = md['edge_label_index'].cpu().numpy()
  keep = md['edge_label_mask'].cpu().numpy()
  lab = md['edge_label'].cpu().numpy()
  kept = 0
  for p in range(MESH_PARTS):
    neg = keep[p] & (lab[p] == 0)
    u = ds.new2old[BI_USER][batch.node_dict[BI_USER][p].cpu().numpy()[
        eli[p, 0][neg]]]
    i = ds.new2old[BI_ITEM][batch.node_dict[BI_ITEM][p].cpu().numpy()[
        eli[p, 1][neg]]]
    if any((a, c) in train_set for a, c in zip(u.tolist(), i.tolist())):
      raise AssertionError('a kept hetero mesh negative is a click')
    kept += int(neg.sum())
  return checked, kept


def hetero_batch_tensors(batch) -> list:
  """Every tensor of a `HeteroBatch` by a sorted key, on the host."""
  out = []
  for f in batch.FIELDS:
    v = getattr(batch, f)
    if isinstance(v, dict):
      for k in sorted(v, key=str):
        x = v[k]
        if isinstance(x, dict):
          out += [(f, k, kk, x[kk].cpu()) for kk in sorted(x, key=str)]
        elif hasattr(x, 'cpu'):
          out.append((f, k, x.cpu()))
  return out


def mesh_hetero_link(torch, ops, timer, ref_auc) -> dict:
  """`examples/hetero/bipartite_sage_unsup.py`'s BiSAGE on the
  heterogeneous mesh at P = 8 with `bipartite_link`'s constants (the
  click graph less 10% held out, [8, 8], 512 seed edges a step (64 a
  partition), binary 1.0, `BI_EPOCHS` epochs, Adam 3e-3):
  `DistHeteroLinkNeighborLoader(with_edge=True)` over a store with
  caller-global edge ids and an ``[E, 8]`` table an edge type, then
  every node embedded through a `DistHeteroNeighborLoader` a type and
  the held-out clicks ranked as `bipartite_link` ranks them.  Checks: 32
  K1 and 32 K2 launches a step (4 (hop, edge type) calls and 4 tables of
  8 owners), no plain call, the first step's calls byte-equal, the edge
  ids, rows and kept negatives of `MESH_BI_CHECK_BATCHES` batches, the
  same key set in every batch, triplet batches' negatives, card = CPU on
  two batches, the losses falling and the AUC within `ENGINES_ACC_TOL`
  of the single-card ``ref_auc`` of the same run."""
  import graphlearn_tpu_torch.parallel.dist_sampler as dsm
  from graphlearn_tpu_torch.parallel import (DistHeteroLinkNeighborLoader,
                                             DistHeteroNeighborLoader,
                                             TorchDraws)
  from graphlearn_tpu_torch.typing import reverse_edge_type
  t_phase = time.perf_counter()
  timer = Timer(torch, reps=ENGINES_PATH_REPS)
  urow, icol, ufeat, ifeat = bipartite_synthetic()
  nu, ni = len(ufeat), len(ifeat)
  rng = np.random.default_rng(2)
  m = len(urow)
  perm = rng.permutation(m)
  heldout, tr = perm[:m // 10], perm[m // 10:]
  train_set = set(zip(urow[tr].tolist(), icol[tr].tolist()))
  ds, tabs = bipartite_mesh_store(torch, DEVICE, urow, icol, ufeat, ifeat,
                                  tr)
  seeds = (BI_ET, (urow[tr], icol[tr]))
  loader = DistHeteroLinkNeighborLoader(
      ds, BI_FANOUTS, seeds, neg_sampling='binary', batch_size=MESH_BI_BATCH,
      shuffle=True, seed=0, with_edge=True, device=DEVICE)
  etypes = tuple(sorted(reverse_edge_type(et) for et in ds.etypes))
  with torch.random.fork_rng(devices=[]):
    torch.manual_seed(0)
    model = bisage_model(torch, etypes, {BI_USER: BI_DIM, BI_ITEM: BI_DIM})
  model = model.to(DEVICE)
  opt = torch.optim.Adam(model.parameters(), lr=BI_LR, eps=1e-8)
  step = bisage_dp_step(torch, model, opt)
  hops = [f'hop {h} {"__".join(et)}' for h in range(len(BI_FANOUTS))
          for et in loader.sampler.etypes]
  tables = (f'x {BI_ITEM}', f'x {BI_USER}') + tuple(
      f'edge rows {"__".join(et)}' for et in sorted(tabs))
  reset_counts(ops)
  epoch_loss, steps, keys, checked, kept = [], 0, set(), 0, 0
  sync(torch)
  t0 = time.perf_counter()
  with PathRecorder(torch, dsm, gns=False, parts=MESH_PARTS,
                    tables=len(tables), hops=len(hops), first=True) as rec:
    for _ in range(BI_EPOCHS):
      tot = []
      for batch in loader:
        keys.add((tuple(sorted(batch.edge_index_dict)),
                  tuple(sorted(batch.metadata['edge_dict'])),
                  tuple(sorted(batch.edge_attr_dict))))
        if steps < MESH_BI_CHECK_BATCHES:
          c, k = check_hetero_link_batch(torch, batch, ds, tabs, urow, icol,
                                         train_set)
          checked, kept = checked + c, kept + k
        tot.append(step(batch))
        steps += 1
      epoch_loss.append(float(torch.stack(tot).mean()))
  sync(torch)
  train_secs = time.perf_counter() - t0
  launches = require_counts(ops, 'hetero mesh link', {
      'sample_one_hop': len(hops) * MESH_PARTS,
      'gather_rows': len(tables) * MESH_PARTS}, steps)
  if len(keys) != 1:
    raise AssertionError(f'hetero mesh link batches change keys: {keys}')
  if not (np.isfinite(epoch_loss).all() and epoch_loss[-1] < epoch_loss[0]):
    raise AssertionError(f'hetero mesh link losses {epoch_loss}')
  path = check_mesh_path(torch, ops, timer, rec, 'hetero mesh link step',
                         tables=tables, hop_names=hops)
  del rec
  # triplet mode on its first batches
  tl = DistHeteroLinkNeighborLoader(
      ds, BI_FANOUTS, seeds, neg_sampling=('triplet', 1),
      batch_size=MESH_BI_BATCH, shuffle=True, seed=1, with_edge=True,
      device=DEVICE)
  trip = 0
  for batch in itertools.islice(iter(tl), MESH_BI_CHECK_BATCHES):
    md = batch.metadata
    dn = md['dst_neg_index'].cpu().numpy()
    si = md['src_index'].cpu().numpy()
    for p in range(MESH_PARTS):
      u = ds.new2old[BI_USER][batch.node_dict[BI_USER][p].cpu().numpy()[
          si[p]]]
      for j in range(dn.shape[1]):
        for c in dn[p, j][dn[p, j] >= 0]:
          i = ds.new2old[BI_ITEM][int(batch.node_dict[BI_ITEM][p][c])]
          if (int(u[j]), int(i)) in train_set:
            raise AssertionError('a triplet hetero mesh negative is a click')
          trip += 1
  del tl

  def embed(ntype, count):
    emb = torch.zeros(count, BI_HIDDEN, device=DEVICE)
    new2old = torch.from_numpy(ds.new2old[ntype]).to(DEVICE)
    el = DistHeteroNeighborLoader(ds, BI_FANOUTS, (ntype, np.arange(count)),
                                  batch_size=MESH_BI_BATCH, device=DEVICE)
    model.eval()
    with torch.no_grad():
      for b in el:
        h = model(*union_graph(torch, b))[ntype].reshape(
            MESH_PARTS, -1, BI_HIDDEN)
        s = b.batch_dict[ntype]
        ok = s >= 0
        at = torch.arange(MESH_PARTS, device=s.device)[:, None].expand_as(s)
        emb[new2old[s[ok].long()]] = h[at[ok],
                                       b.metadata['seed_local'][ok].long()]
    return emb.cpu().numpy()
  uemb, iemb = embed(BI_USER, nu), embed(BI_ITEM, ni)
  pos_s = (uemb[urow[heldout]] * iemb[icol[heldout]]).sum(1)
  neg_s = (uemb[rng.integers(0, nu, len(heldout))]
           * iemb[rng.integers(0, ni, len(heldout))]).sum(1)
  auc = float((pos_s[:, None] > neg_s[None, :]).mean())
  # card = CPU on the first batches, from the same CPU-made draws
  cpu_draws = TorchDraws(19, 'cpu')
  got = {}
  for dev in (DEVICE, 'cpu'):
    dsd = (ds if dev == DEVICE else bipartite_mesh_store(
        torch, 'cpu', urow, icol, ufeat, ifeat, tr)[0])
    if dev == 'cpu':
      # the same tables on both sides
      for et, f in dsd.edge_features.items():
        f.shards = ds.edge_features[et].shards.cpu()
    lo = DistHeteroLinkNeighborLoader(
        dsd, BI_FANOUTS, seeds, neg_sampling='binary',
        batch_size=MESH_BI_BATCH, shuffle=True, seed=4, with_edge=True,
        draws=DevDraws(cpu_draws, dev), device=dev)
    got[dev] = [hetero_batch_tensors(b)
                for b in itertools.islice(iter(lo), 2)]
  for i, (x, y) in enumerate(zip(got[DEVICE], got['cpu'])):
    if len(x) != len(y):
      raise AssertionError(f'hetero mesh link batch {i}: key sets differ')
    for a, c in zip(x, y):
      if a[:-1] != c[:-1] or a[-1].dtype != c[-1].dtype or not torch.equal(
          a[-1], c[-1]):
        raise AssertionError(f'hetero mesh link card != CPU: batch {i} '
                             f'{a[:-1]}')
  out = {'users': nu, 'items': ni, 'train_edges': int(len(tr)),
         'heldout': int(len(heldout)), 'epochs': BI_EPOCHS, 'steps': steps,
         'batch_a_partition': MESH_BI_BATCH,
         'step_ms': train_secs / steps * 1e3, 'epoch_loss': epoch_loss,
         'heldout_auc': auc, 'single_card_auc': ref_auc,
         'minus_single_card': auc - ref_auc,
         'edges_checked': checked, 'negatives_kept_checked': kept,
         'triplet_negatives_checked': trip, 'card_equals_cpu_batches': 2,
         'launches': launches, 'secs': time.perf_counter() - t_phase}
  emit('mesh_hetero_link', **out)
  if not abs(auc - ref_auc) <= ENGINES_ACC_TOL:
    raise AssertionError(f'hetero mesh link AUC {auc} not within '
                         f'{ENGINES_ACC_TOL} of the single card\'s {ref_auc}')
  del ds, loader, model, opt
  return {'launches': launches, 'hops': path['hops'],
          'gathers': path['gathers'], 'out': out}


def mesh_engines_cross_check(torch):
  """The subgraph engine at the SEAL example's size on the card and on
  the CPU with the same CPU-made draws: the first 3 batches with edge
  ids byte-equal (node, edge_index, edge_mask, edge, mapping)."""
  from graphlearn_tpu_torch.parallel import (DistDataset, DistSubGraphLoader,
                                             TorchDraws)
  rows, cols, _ = seal_graph(n=SEAL_NODES, clusters=SEAL_CLUSTERS,
                             deg=SEAL_DEG)
  pairs, _, keep = seal_links(SEAL_NODES, rows, cols)
  draws = TorchDraws(23, 'cpu')
  out = {}
  for dev in (DEVICE, 'cpu'):
    dds = DistDataset.from_full_graph(MESH_PARTS, rows[keep], cols[keep],
                                      num_nodes=SEAL_NODES, device=dev)
    lo = DistSubGraphLoader(dds, list(SEAL_FANOUTS), pairs.reshape(-1),
                            batch_size=2, collect_features=False,
                            with_edge=True, draws=DevDraws(draws, dev),
                            device=dev)
    out[dev] = [[t.cpu() for t in (b.node, b.edge_index, b.edge_mask,
                                   b.edge, b.metadata['mapping'])]
                for b in itertools.islice(iter(lo), 3)]
  for i, (a, c) in enumerate(zip(out[DEVICE], out['cpu'])):
    for x, y in zip(a, c):
      if x.dtype != y.dtype or not torch.equal(x, y):
        raise AssertionError(f'mesh subgraph card != CPU (batch {i})')
  emit('mesh_engines_cross_check', parts=MESH_PARTS, batches=3,
       byte_equal=True)


def mesh_engines_phases(torch, ops, timer, ds, feats, labels, indptr,
                        indices) -> dict:
  """The mesh's subgraph, walk and fused link engines on `mesh_data`'s
  untiered store (phases A, B and C; the hetero link phase D runs on
  its own graph, `mesh_hetero_link`)."""
  indptr_h, indices_h = indptr.cpu().numpy(), indices.cpu().numpy()
  is_edge = edge_lookup(indptr_h, indices_h)
  timer = Timer(torch, reps=ENGINES_PATH_REPS)
  out = {'seal': mesh_seal(torch, ops, timer)}
  mesh_engines_cross_check(torch)
  out['subgraph'] = mesh_subgraph(torch, ops, timer, ds, feats, labels,
                                  indptr_h, indices_h, is_edge)
  torch.cuda.empty_cache()
  out['walk'] = mesh_walk(torch, ops, timer, ds, indptr_h, indices_h,
                          is_edge)
  torch.cuda.empty_cache()
  out['fused_link'] = mesh_fused_link(torch, ops, timer, ds, indptr_h,
                                      indices_h)
  torch.cuda.empty_cache()
  return out


def engines_kernels(me: dict) -> dict:
  """The mesh engines' ``kernels``-line parts: K1 / K2 / K3 shapes, their
  errors and launches by path."""
  sub = me['subgraph']
  k1_paths = {'mesh_seal': me['seal']['hops'],
              **{f'mesh_subgraph.{k}': r['path']['hops']
                 for k, r in sub.items()},
              'mesh_walk': me['walk']['hops'],
              'mesh_fused_link': me['fused_link']['hops'],
              'mesh_hetero_link': me['hetero_link']['hops']}
  k2_paths = {**{f'mesh_subgraph.{k}': r['path']['gathers']
                 for k, r in sub.items()},
              'mesh_fused_link': me['fused_link']['gathers'],
              'mesh_hetero_link': me['hetero_link']['gathers']}
  k3_paths = {'mesh_seal': me['seal']['windows'],
              **{f'mesh_subgraph.{k}': r['windows'] for k, r in sub.items()}}

  def launches(name):
    return {'mesh_seal': me['seal']['launches'][name],
            **{f'mesh_subgraph.{k}': r['launches'][name]
               for k, r in sub.items()},
            'mesh_walk': me['walk']['launches'][name],
            **{f'mesh_fused_link.{k}': v[name]
               for k, v in me['fused_link']['launches'].items()},
            'mesh_hetero_link': me['hetero_link']['launches'][name]}
  k3_shapes = [
      {'shape': f'{p} window group {i}: {g["rows"]} starts x {g["w"]} over '
                f'{MESH_PARTS} owners',
       'ms': g['kernel_ms'], 'plain_ms': g['plain_ms'],
       'bound_ms': g['bound_us'] / 1e3, 'library_ms': g['library_ms'],
       'ms_per_call': g['kernel_ms'] / MESH_PARTS, 'byte_equal': True}
      for p, gs in k3_paths.items() for i, g in enumerate(gs)]
  return {
      'k1': {'max_abs_err': max(h['max_abs_err'] for hs in k1_paths.values()
                                for h in hs),
             'shapes': {k: hops_shape(k, hs) for k, hs in k1_paths.items()},
             'launches_by_path': launches('sample_one_hop')},
      'k2': {'max_abs_err': max(g['max_abs_err'] for gs in k2_paths.values()
                                for g in gs),
             'shapes': [mesh_gather_shape(f'{k} table {i}', g)
                        for k, gs in k2_paths.items()
                        for i, g in enumerate(gs)],
             'launches_by_path': launches('gather_rows')},
      'k3': {'max_abs_err': 0, 'shapes': k3_shapes,
             'launches_by_path': {
                 k: v for k, v in launches('csr_window_gather').items()
                 if k.startswith(('mesh_seal', 'mesh_subgraph'))}}}


def mesh_engines_kernels(me: dict) -> list:
  """The ``kernels`` entries of the mesh engines alone
  (``--mesh-engines``): K1, K2 and K3 at their first recorded shapes,
  launches from the phases' runs."""
  ek = engines_kernels(me)
  k1 = ek['k1']['shapes']['mesh_subgraph.one_exchange']
  k2 = ek['k2']['shapes'][0]
  k3 = ek['k3']['shapes'][1]
  common = {'route': 'cuda', 'bound_by': 'bytes', 'byte_equal': True}
  return [
      {'name': 'sample_one_hop', **common,
       'source': 'graphlearn_tpu_torch/csrc/sample_one_hop.cu',
       'replaces': 'graphlearn_tpu/ops/pallas_sample.py:247',
       'launches': sum(ek['k1']['launches_by_path'].values()),
       'max_abs_err': ek['k1']['max_abs_err'], 'ms': k1['ms'],
       'plain_ms': k1['plain_ms'], 'bound_ms': k1['bound_ms'],
       'library_ms': None, 'shape': k1['shape'],
       'mesh_engine_shapes': ek['k1']['shapes'],
       'launches_by_path': ek['k1']['launches_by_path']},
      {'name': 'gather_rows', **common,
       'source': 'graphlearn_tpu_torch/csrc/gather_rows.cu',
       'replaces': 'graphlearn_tpu/ops/pallas_gather.py:152',
       'launches': sum(ek['k2']['launches_by_path'].values()),
       'max_abs_err': ek['k2']['max_abs_err'], 'ms': k2['ms'],
       'plain_ms': k2['plain_ms'], 'bound_ms': k2['bound_ms'],
       'library_ms': k2['library_ms'], 'shape': k2['shape'],
       'mesh_engine_shapes': ek['k2']['shapes'],
       'launches_by_path': ek['k2']['launches_by_path']},
      {'name': 'csr_window_gather', **common,
       'source': 'graphlearn_tpu_torch/csrc/csr_window_gather.cu',
       'replaces': 'graphlearn_tpu/ops/pallas_window.py:82',
       'launches': sum(ek['k3']['launches_by_path'].values()),
       'max_abs_err': 0, 'ms': k3['ms'], 'plain_ms': k3['plain_ms'],
       'bound_ms': k3['bound_ms'], 'library_ms': k3['library_ms'],
       'shape': k3['shape'], 'mesh_shapes': ek['k3']['shapes'],
       'launches_by_path': ek['k3']['launches_by_path']},
  ]


#: BASELINE config 5 (`BASELINE.json` configs[4]): the distributed RGNN
#: example, `examples/igbh/dist_train_rgnn.py`, at P = 8 on the card.  The
#: IGBH schema (`examples/igbh/train_rgnn.py:24-32`), its synthetic
#: topology at IGBH-small's paper count with the generator's ratios, IGBH's
#: 19 classes and IGB's 1,024-wide embeddings
IGBH_ETYPES = (('paper', 'cites', 'paper'), ('paper', 'written_by', 'author'),
               ('author', 'rev_written_by', 'paper'),
               ('author', 'affiliated_to', 'institute'),
               ('institute', 'rev_affiliated_to', 'author'),
               ('paper', 'topic', 'fos'), ('fos', 'rev_topic', 'paper'))
IGBH_FULL = dict(npaper=1_000_000, nauthor=400_000, ninst=20_000,
                 nfos=16_000, classes=19, d=1024)
#: the example's own `synthetic()` defaults (the cross-check and the
#: accuracy gate)
IGBH_EXAMPLE = dict(npaper=4000, nauthor=1600, ninst=80, nfos=64, classes=8,
                    d=32)
IGBH_FANOUTS = (4, 4)
IGBH_BATCH = 64                     # paper seeds a partition
IGBH_HIDDEN = 64
IGBH_HEADS = 2
IGBH_LR = 1e-3
IGBH_SPLIT = 0.5                    # the tiered store's hot share
IGBH_WARM = 2
IGBH_STEPS = 5                      # timed DP steps a model and store (depth cut)
IGBH_IDLE_STEPS = 3
IGBH_EPOCHS = 3                     # the accuracy gate's epochs
IGBH_ACC_SEEDS = 8                  # the accuracy gate's seeds, 0 to 7
#: K1 and K2 launches a batch at [4, 4] from paper seeds: 3 edge types at
#: hop 0 and 6 at hop 1, 8 owners each; 4 feature tables and the paper
#: labels, 8 owners each
IGBH_K1, IGBH_K2 = 72, 40
#: the timer's repetitions at the path's 112 calls a store
IGBH_PATH_REPS = 5
#: JAX's paper training accuracy after 3 RGAT epochs of the example on the
#: CPU (the 8-device virtual mesh), the mean over seeds 0 to 15 (seed 0
#: alone: 0.586; one seed's figure spreads over 0.557-0.632, wider than
#: the gate, so the gate holds the mean of `IGBH_ACC_SEEDS` runs), and
#: the gate around it
IGBH_JAX_ACC = 0.5956
IGBH_ACC_TOL = 0.03


def igbh_synthetic(torch, npaper, nauthor, ninst, nfos, classes, d, seed=0,
                   device=None):
  """`examples/igbh/train_rgnn.py::synthetic`: the topology from numpy's
  ``default_rng(seed)`` exactly as the example draws it (papers cite
  mostly same-topic peers, fos links carry the class); the features
  from the same generator (``device=None``: the example's own arrays) or
  from a ``torch.Generator`` on ``device`` seeded with ``seed``.
  Returns ``(edges, feats, num_nodes, topic)``."""
  rng = np.random.default_rng(seed)
  topic = rng.integers(0, classes, npaper)
  fos_of_class = nfos // classes

  def paper_peers(src_topic):
    order = np.argsort(topic, kind='stable')
    ptr = np.searchsorted(topic[order], np.arange(classes + 1))
    out = np.empty(len(src_topic), np.int64)
    for c in range(classes):
      m = src_topic == c
      out[m] = order[rng.integers(ptr[c], ptr[c + 1], m.sum())]
    return out

  crow = np.repeat(np.arange(npaper), 3)
  ccol = np.where(rng.random(npaper * 3) < 0.7, paper_peers(topic[crow]),
                  rng.integers(0, npaper, npaper * 3))
  wrow = np.repeat(np.arange(npaper), 2)
  wcol = rng.integers(0, nauthor, npaper * 2)
  arow = np.arange(nauthor)
  acol = rng.integers(0, ninst, nauthor)
  frow = np.repeat(np.arange(npaper), 2)
  fcol = (topic[frow] * fos_of_class
          + rng.integers(0, fos_of_class, npaper * 2))
  pairs = ((crow, ccol), (wrow, wcol), (wcol, wrow), (arow, acol),
           (acol, arow), (frow, fcol), (fcol, frow))
  edges = dict(zip(IGBH_ETYPES, pairs))
  nnodes = {'paper': npaper, 'author': nauthor, 'institute': ninst,
            'fos': nfos}
  if device is None:
    feats = {nt: rng.standard_normal((n, d)).astype(np.float32)
             for nt, n in nnodes.items()}
  else:
    gen = torch.Generator(device=device).manual_seed(seed)
    feats = {nt: torch.randn(n, d, device=device, generator=gen)
             for nt, n in nnodes.items()}
  return edges, feats, nnodes, topic.astype(np.int32)


def igbh_store(torch, data, split, device=None):
  from graphlearn_tpu_torch.parallel import DistHeteroDataset
  edges, feats, nnodes, topic = data
  device = device or DEVICE
  return DistHeteroDataset.from_full_graph(
      MESH_PARTS, edges, node_feat_dict=feats,
      node_label_dict={'paper': topic}, num_nodes_dict=nnodes,
      split_ratio=split, device=device)


def rgnn_model(torch, ntypes, etypes, in_dims, classes, kind,
               hidden=IGBH_HIDDEN, heads=IGBH_HEADS, target='paper'):
  """The example's ``RGNN`` (`dist_train_rgnn.py:128-137`) on the port's
  modules: ``Dense_{i}`` (hidden) for the ``i``-th sorted node type, two
  ``HeteroConv(make_conv=...)`` layers (``conv0``, ``conv1``) with relu,
  GAT (``kind='rgat'``: ``GATConv(i, o // heads, heads)``) or SAGE
  (``'rsage'``) a relation, and ``Dense_{len(ntypes)}`` (classes) on the
  ``target`` type.  The names are Flax's, so `hetero_conv_from_flax`
  loads the example's parameters."""
  from graphlearn_tpu_torch.models import GATConv, HeteroConv, SAGEConv
  make_conv = ((lambda i, o: GATConv(i, o // heads, heads=heads))
               if kind == 'rgat' else SAGEConv)
  ntypes = sorted(ntypes)

  class RGNN(torch.nn.Module):
    def __init__(self):
      super().__init__()
      for i, nt in enumerate(ntypes):
        self.add_module(f'Dense_{i}', torch.nn.Linear(in_dims[nt], hidden))
      for li in range(2):
        self.add_module(f'conv{li}', HeteroConv(etypes, hidden, hidden,
                                                make_conv=make_conv))
      self.add_module(f'Dense_{len(ntypes)}',
                      torch.nn.Linear(hidden, classes))

    def forward(self, x_dict, edge_index_dict, edge_mask_dict):
      h = {nt: getattr(self, f'Dense_{i}')(x_dict[nt])
           for i, nt in enumerate(ntypes)}
      for li in range(2):
        h = getattr(self, f'conv{li}')(h, edge_index_dict, edge_mask_dict)
        h = {nt: torch.relu(v) for nt, v in h.items()}
      return getattr(self, f'Dense_{len(ntypes)}')(h[target])
  return RGNN()


def union_graph(torch, stacked):
  """A stacked ``[P, ...]`` `HeteroBatch` as one graph of ``P`` disjoint
  blocks: each type's rows concatenated (partition ``p``'s table at rows
  ``[p * cap, (p + 1) * cap)``), each edge type's local ids shifted by
  their partitions' offsets (-1 kept), the masks flattened.  A model's
  output on the union is each partition's output on its own piece.
  Returns ``(x_dict, edge_index_dict, edge_mask_dict)``."""
  x = {nt: v.reshape((-1,) + tuple(v.shape[2:]))
       for nt, v in stacked.x_dict.items()}
  cap = {nt: v.shape[1] for nt, v in stacked.node_dict.items()}
  ei, em = {}, {}
  for et, e in stacked.edge_index_dict.items():
    a, _, b = et
    base = torch.arange(e.shape[0], device=e.device)[:, None, None]
    off = torch.cat([base * cap[a], base * cap[b]], dim=1)
    ei[et] = torch.where(e >= 0, e + off, -1).to(e.dtype).transpose(
        0, 1).reshape(2, -1)
    em[et] = stacked.edge_mask_dict[et].reshape(-1)
  return x, ei, em


def rgnn_seed_logits(torch, model, stacked, bs):
  """Every partition's seeds' logits, ``[P, bs, classes]``: the model
  once on `union_graph`."""
  parts, cap = stacked.node_dict['paper'].shape
  logits = model(*union_graph(torch, stacked))
  return logits.reshape(parts, cap, -1)[:, :bs]


def rgnn_dp_step(torch, model, opt, bs):
  """The example's DP step (`dist_train_rgnn.py:143-160`) over a stacked
  `HeteroBatch`: each partition's masked cross-entropy of its seeds'
  logits, the mean over the partitions, its gradient (the mean of the
  partitions' gradients), one Adam step.  The partitions run as one
  union graph (`union_graph`): one forward and one backward for all of
  them.  Returns the loss (a device tensor)."""
  import torch.nn.functional as F

  def step(stacked):
    model.train()
    opt.zero_grad(set_to_none=True)
    logits = rgnn_seed_logits(torch, model, stacked, bs)
    parts = logits.shape[0]
    ce = F.cross_entropy(logits.reshape(parts * bs, -1),
                         stacked.y_dict['paper'][:, :bs].reshape(-1).long(),
                         reduction='none').reshape(parts, bs)
    valid = (stacked.batch_dict['paper'] >= 0).float()
    loss = ((ce * valid).sum(1) / valid.sum(1).clamp(min=1.0)).mean()
    loss.backward()
    opt.step()
    return loss.detach()
  return step


def rgnn_accuracy(torch, model, loader, bs) -> float:
  """The paper training accuracy: argmax of each partition's
  ``logits[:bs]`` against its seeds' labels, over one pass of
  ``loader``, valid seeds only."""
  model.eval()
  correct = total = 0
  with torch.no_grad():
    for batch in loader:
      pred = rgnn_seed_logits(torch, model, batch, bs).argmax(-1)
      valid = batch.batch_dict['paper'] >= 0
      correct += int(((pred == batch.y_dict['paper'][:, :bs].long())
                      & valid).sum())
      total += int(valid.sum())
  return correct / max(total, 1)


def igbh_plan(loader):
  """The sampler calls of one batch, ``(hop, edge type, frontier rows,
  k)`` in launch order, and the gathered tables, in order."""
  from graphlearn_tpu_torch.sampler.hetero_neighbor_sampler import (
      HeteroPlan, _plan_capacities)
  s = loader.sampler
  _, caps, fcaps, _ = _plan_capacities(
      s.etypes, s.fanouts, {'paper': loader.batch_size}, s.num_hops,
      s.ds.num_nodes_dict())
  plan = HeteroPlan(s.etypes, s.fanouts, s.num_hops, caps, fcaps)
  tables = [f'{nt} x' for nt in s._feat_nts] + [
      f'{nt} labels' for nt in s._label_nts]
  return hetero_hops(plan), tables, caps


def check_igbh_batch(torch, batch, ds, feats, topic_t) -> dict:
  """Every partition's valid nodes: ``x`` rows equal their type's source
  rows (through the store's relabel), paper labels their topics, padded
  rows zero; valid edges inside both types' node counts, masked ones -1.
  Returns the valid node counts by type."""
  counts = {}
  for nt, node in batch.node_dict.items():
    ok = node >= 0
    counts[nt] = int(ok.sum())
    n2o = torch.from_numpy(ds.new2old[nt]).to(node.device)
    src = n2o[node[ok].long()]
    if not torch.equal(batch.x_dict[nt][ok], feats[nt][src]):
      raise AssertionError(f'mesh_hetero: a {nt} x row differs from its '
                           'source row')
    if bool(batch.x_dict[nt][~ok].any()):
      raise AssertionError(f'mesh_hetero: a padded {nt} slot is not zero')
    if nt == 'paper' and not torch.equal(batch.y_dict[nt][ok],
                                         topic_t[src]):
      raise AssertionError('mesh_hetero: a paper label differs from its '
                           'topic')
  for et, ei in batch.edge_index_dict.items():
    em = batch.edge_mask_dict[et]
    a, _, b = et
    na = (batch.node_dict[a] >= 0).sum(1, keepdim=True)
    nb = (batch.node_dict[b] >= 0).sum(1, keepdim=True)
    src, dst = ei[:, 0], ei[:, 1]
    if not (bool(((src >= 0) & (src < na))[em].all())
            and bool(((dst >= 0) & (dst < nb))[em].all())
            and bool((src[~em] == -1).all()) and bool((dst[~em] == -1).all())):
      raise AssertionError(f'mesh_hetero: edge_index of {et} outside its '
                           'tables')
  return counts


def igbh_train(torch, ops, timer, ds, feats, topic_t, kind, store,
               record) -> dict:
  """The example's training at full width on one store: the shuffled
  `DistHeteroNeighborLoader([4, 4], batch 64 a partition)`, `rgnn_model`
  of ``kind`` (Flax's init, seed 0) and Adam(1e-3) through `rgnn_dp_step`:
  the first batch (recorded with ``record``: every K1 and K2 call held
  against its plain version and timed), `IGBH_WARM` more, `IGBH_STEPS`
  timed one by one (batch and step, synchronised) and the idle share of
  `IGBH_IDLE_STEPS` more.  Checks: the first batches' rows and labels
  against their sources, `IGBH_K1` K1 and `IGBH_K2` K2 launches a batch
  over the run, no plain call, no exchange drop (exact slack is not
  needed: 'auto' gives 2.0 for shuffled seeds), finite losses."""
  import graphlearn_tpu_torch.parallel.dist_sampler as dsm
  from graphlearn_tpu_torch.parallel import DistHeteroNeighborLoader
  t_start = time.perf_counter()
  npaper = ds.num_nodes_dict()['paper']
  loader = DistHeteroNeighborLoader(
      ds, list(IGBH_FANOUTS), ('paper', np.arange(npaper)),
      batch_size=IGBH_BATCH, shuffle=True, seed=0, device=DEVICE)
  hops, tables, caps = igbh_plan(loader)
  if (len(hops) * MESH_PARTS, len(tables) * MESH_PARTS) != (IGBH_K1,
                                                            IGBH_K2):
    raise AssertionError(f'mesh_hetero plan: {len(hops)} sampler calls and '
                         f'{len(tables)} tables a partition')
  s = loader.sampler
  etypes = tuple(reversed_types(hops))
  model = rgnn_model(torch, s._feat_nts, etypes,
                     {nt: ds.node_features[nt].feature_dim
                      for nt in s._feat_nts}, len(np.unique(topic_t.cpu())),
                     kind).to(DEVICE)
  lecun_normal_(torch, model, 0)
  opt = torch.optim.Adam(model.parameters(), lr=IGBH_LR, eps=1e-8)
  step = rgnn_dp_step(torch, model, opt, IGBH_BATCH)
  it = iter(loader)
  reset_counts(ops)
  s.overlay_secs = dict.fromkeys(s.overlay_secs, 0.0)
  path = None
  if record:
    with PathRecorder(torch, dsm, gns=False, parts=MESH_PARTS,
                      tables=len(tables), hops=len(hops)) as rec:
      batch = next(it)
  else:
    batch = next(it)
  losses = [float(step(batch))]
  counts = check_igbh_batch(torch, batch, ds, feats, topic_t)
  for _ in range(IGBH_WARM):
    batch = next(it)
    check_igbh_batch(torch, batch, ds, feats, topic_t)
    losses.append(float(step(batch)))
  del batch
  sync(torch)
  walls, loads, overlay0 = [], [], dict(s.overlay_secs)
  st0 = s.exchange_stats()
  for _ in range(IGBH_STEPS):
    t = time.perf_counter()
    batch = next(it)
    sync(torch)
    loads.append((time.perf_counter() - t) * 1e3)
    losses.append(float(step(batch)))
    walls.append((time.perf_counter() - t) * 1e3)
  del batch
  st1 = s.exchange_stats()
  overlay = {k: (s.overlay_secs[k] - overlay0[k]) * 1e3 / IGBH_STEPS
             for k in s.overlay_secs}
  idle = device_idle(torch, lambda: step(next(it)), IGBH_IDLE_STEPS)
  batches = s._step_cnt
  launches, plain = read_counts(ops)
  want = {'sample_one_hop': IGBH_K1 * batches, 'gather_rows':
          IGBH_K2 * batches, 'sample_one_hop_gns': 0, 'csr_window_gather': 0}
  if launches != want or plain:
    raise AssertionError(f'mesh_hetero {store} {kind}: launches {launches}, '
                         f'plain {plain}, want {want} over {batches} batches')
  dropped = st1['dist.frontier.dropped'] + st1['dist.feature.dropped']
  if dropped or not np.isfinite(losses).all():
    raise AssertionError(f'mesh_hetero {store} {kind}: {dropped} exchange '
                         f'drops, losses {losses[:5]}...')
  if record:
    names = [f'hop {h} {"__".join(et)}' for h, et, _, _ in hops]
    path = check_mesh_path(torch, ops, timer, rec, f'mesh_hetero {store}',
                           tables=tables, hop_names=names)
    for g, table in zip(path['gathers'], tables):
      g['table'] = table
    for h, (hop, et, rows, k) in zip(path['hops'], hops):
      h.update(hop=hop, etype='__'.join(et))
      if h['k'] != k:
        raise AssertionError(f'mesh_hetero: {et} hop {hop} sampled at k '
                             f'{h["k"]}, planned {k}')
    del rec
  cold = {k: st1[f'dist.feature.{k}'] - st0[f'dist.feature.{k}']
          for k in ('lookups', 'cold_lookups', 'cold_misses')}
  out = {'store': store, 'model': kind, 'steps': IGBH_STEPS,
         'step_ms_median': float(np.median(walls)),
         'step_ms_p10_p90': [float(np.percentile(walls, 10)),
                             float(np.percentile(walls, 90))],
         'step_ms_min_max': [float(min(walls)), float(max(walls))],
         'batch_ms_median': float(np.median(loads)),
         'model_ms_median': float(np.median(np.subtract(walls, loads))),
         'batches_per_s': 1e3 / float(np.mean(walls)),
         'train_seeds_per_s': IGBH_BATCH * MESH_PARTS * 1e3
                              / float(np.mean(walls)),
         'device_idle': idle, 'overlay_ms_per_step_by_part': overlay,
         'overlay_ms_per_step': sum(overlay.values()),
         'cold_per_step': {k: v / IGBH_STEPS for k, v in cold.items()},
         'first_batch_valid_nodes': counts, 'table_caps': caps,
         'loss_first_last': [losses[0], float(np.mean(losses[-10:]))],
         'batches': batches, 'launches': launches, 'plain_calls': plain,
         'exchange': {k: st1[k] for k in st1 if k.startswith('dist.')},
         'secs': time.perf_counter() - t_start}
  emit('mesh_hetero_train', **out)
  out['path'] = path
  loader.close()
  return out


def reversed_types(hops) -> list:
  """The emitted (reversed) edge types of a batch's sampler calls, in
  the sorted order the model's `HeteroConv` layers take."""
  from graphlearn_tpu_torch.typing import reverse_edge_type
  return sorted({reverse_edge_type(et) for _, et, _, _ in hops})


def igbh_batches(torch, ds, draws, n):
  """The first ``n`` shuffled [4, 4] batches of ``ds`` (seed 1) as CPU
  tensors by field and key."""
  from graphlearn_tpu_torch.parallel import DistHeteroNeighborLoader
  lo = DistHeteroNeighborLoader(
      ds, list(IGBH_FANOUTS), ('paper', np.arange(ds.num_nodes_dict()[
          'paper'])), batch_size=IGBH_BATCH, shuffle=True, seed=1,
      draws=draws, device=ds.device)
  out = []
  for b in itertools.islice(iter(lo), n):
    out.append({(f, k): v.cpu() for f in (
        'x_dict', 'y_dict', 'node_dict', 'node_mask_dict', 'edge_index_dict',
        'edge_mask_dict', 'batch_dict') for k, v in getattr(b, f).items()}
               | {'seed_local': b.metadata['seed_local'].cpu()})
  return out, lo.sampler.exchange_stats()


def mesh_hetero_cross_check(torch):
  """The example's own size (`synthetic()`'s defaults) at P = 8 on the
  card and on the CPU with the same CPU-made draws: the first 3
  batches of the untiered and the tiered (0.5) store byte-equal in
  every field (nodes, masks, edge indices, x, y, seeds), the exchange
  counters equal."""
  from graphlearn_tpu_torch.parallel import TorchDraws
  t0 = time.perf_counter()
  data = igbh_synthetic(torch, **IGBH_EXAMPLE)
  cpu = TorchDraws(5, 'cpu')
  res = {}
  for split in (1.0, IGBH_SPLIT):
    got = {}
    for dev in (DEVICE, 'cpu'):
      ds = igbh_store(torch, data, split, device=dev)
      got[dev] = igbh_batches(torch, ds, DevDraws(cpu, dev), 3)
    (a, sa), (c, sc) = got[DEVICE], got['cpu']
    for i, (x, y) in enumerate(zip(a, c)):
      if set(x) != set(y):
        raise AssertionError(f'mesh_hetero card and CPU batch {i} keys '
                             'differ')
      for key in x:
        if x[key].dtype != y[key].dtype or not torch.equal(x[key], y[key]):
          raise AssertionError(f'mesh_hetero card and CPU differ: split '
                               f'{split} batch {i} {key}')
    if sa != sc:
      raise AssertionError(f'mesh_hetero exchange counters differ: {sa} '
                           f'{sc}')
    res[str(split)] = {'batches': len(a), 'fields': len(a[0]),
                       'cold_lookups': sa['dist.feature.cold_lookups']}
  emit('mesh_hetero_cross_check', parts=MESH_PARTS, byte_equal=True,
       stores=res, secs=time.perf_counter() - t0)


def igbh_accuracy(torch, ds, seed=0, epochs=IGBH_EPOCHS) -> dict:
  """The example on ``ds``, its own size's store (`synthetic()`'s
  defaults, P = 8): RGAT, batch 64 a partition, shuffled, for ``epochs``
  epochs from Flax's init (seed ``seed``; the loader's seed too), then
  the paper training accuracy over one more pass (`rgnn_accuracy`)."""
  from graphlearn_tpu_torch.parallel import DistHeteroNeighborLoader
  nnodes = ds.num_nodes_dict()
  loader = DistHeteroNeighborLoader(
      ds, list(IGBH_FANOUTS), ('paper', np.arange(nnodes['paper'])),
      batch_size=IGBH_BATCH, shuffle=True, seed=seed, device=ds.device)
  hops, _, _ = igbh_plan(loader)
  feats = ds.node_features
  model = rgnn_model(torch, feats, reversed_types(hops),
                     {nt: f.feature_dim for nt, f in feats.items()},
                     IGBH_EXAMPLE['classes'], 'rgat').to(ds.device)
  lecun_normal_(torch, model, seed)
  opt = torch.optim.Adam(model.parameters(), lr=IGBH_LR, eps=1e-8)
  step = rgnn_dp_step(torch, model, opt, IGBH_BATCH)
  epoch_loss = []
  for _ in range(epochs):
    epoch_loss.append(float(torch.stack([step(b) for b in loader]).mean()))
  acc = rgnn_accuracy(torch, model, loader, IGBH_BATCH)
  return {'accuracy': acc, 'epoch_loss': epoch_loss, 'seed': seed,
          'steps_per_epoch': len(loader)}


def mesh_hetero_phases(torch, ops, timer) -> dict:
  """BASELINE config 5 on the card: the IGBH-schema graph at 1 M papers
  (``[N, 1024]`` f32 features made on the card), its untiered and its
  tiered (`IGBH_SPLIT`) 8-partition stores, RGAT and RSAGE trained on
  each (`igbh_train`; each store's first batch's K1 and K2 calls checked
  and timed), then the card-vs-CPU batches and the accuracy gate at the
  example's own size."""
  t0 = time.perf_counter()
  data = igbh_synthetic(torch, **IGBH_FULL, device=DEVICE)
  edges, feats, nnodes, topic = data
  topic_t = torch.from_numpy(topic).to(DEVICE)
  sync(torch)
  emit('igbh_graph', num_nodes=nnodes,
       edges={'__'.join(et): int(len(r)) for et, (r, _) in edges.items()},
       total_edges=int(sum(len(r) for r, _ in edges.values())),
       feature_dim=IGBH_FULL['d'], classes=IGBH_FULL['classes'],
       feature_gb=sum(f.numel() * 4 for f in feats.values()) / 1e9,
       secs=time.perf_counter() - t0)
  path_timer = Timer(torch, reps=IGBH_PATH_REPS)
  runs = {}
  for store, split in (('untiered', 1.0), ('tiered', IGBH_SPLIT)):
    t0 = time.perf_counter()
    ds = igbh_store(torch, data, split)
    sync(torch)
    emit('igbh_store', store=store, split=split, parts=MESH_PARTS,
         secs=time.perf_counter() - t0,
         card_gb=sum(f.shards.numel() * 4
                     for f in ds.node_features.values()) / 1e9,
         host_gb=sum(f.cold_host.numel() * 4 for f in
                     ds.node_features.values() if f.is_tiered) / 1e9,
         hot_counts={nt: [int(c) for c in f.hot_counts]
                     for nt, f in ds.node_features.items()})
    for i, kind in enumerate(('rgat', 'rsage')):
      runs[f'{store}.{kind}'] = igbh_train(torch, ops, path_timer, ds, feats,
                                           topic_t, kind, store,
                                           record=i == 0)
    del ds
    torch.cuda.empty_cache()
  del data, edges, feats, topic_t
  torch.cuda.empty_cache()
  mesh_hetero_cross_check(torch)
  t0 = time.perf_counter()
  ds = igbh_store(torch, igbh_synthetic(torch, **IGBH_EXAMPLE), 1.0)
  seeds = [igbh_accuracy(torch, ds, seed=s) for s in range(IGBH_ACC_SEEDS)]
  del ds
  mean = float(np.mean([r['accuracy'] for r in seeds]))
  acc = {'accuracy': mean, 'seeds': seeds, 'jax_cpu_accuracy': IGBH_JAX_ACC,
         'tol': IGBH_ACC_TOL, 'minus_jax': mean - IGBH_JAX_ACC,
         'secs': time.perf_counter() - t0}
  emit('mesh_hetero_accuracy', **acc)
  if not abs(acc['minus_jax']) <= IGBH_ACC_TOL:
    raise AssertionError(f'mesh_hetero: RGAT accuracy {mean} (mean of '
                         f'{IGBH_ACC_SEEDS} seeds) not within '
                         f'{IGBH_ACC_TOL} of JAX\'s {IGBH_JAX_ACC}')
  return {'runs': runs, 'accuracy': acc}


def mesh_hetero_kernels(mh: dict) -> list:
  """The ``kernels`` entries of the mesh_hetero path alone
  (``--mesh-hetero``): K1 and K2 at the untiered store's first batch,
  the tiered store's as a second shape; launches from the four runs."""
  paths = {k.split('.')[0]: r['path'] for k, r in mh['runs'].items()
           if r['path'] is not None}
  un = paths['untiered']
  by = {name: {k: r['launches'][name] for k, r in mh['runs'].items()}
        for name in ('sample_one_hop', 'gather_rows')}
  k1 = hetero_mesh_shapes(paths)
  k2 = hetero_mesh_gathers(paths)
  return [
      {'name': 'sample_one_hop', 'route': 'cuda',
       'source': 'graphlearn_tpu_torch/csrc/sample_one_hop.cu',
       'replaces': 'graphlearn_tpu/ops/pallas_sample.py:247',
       'launches': sum(by['sample_one_hop'].values()),
       'max_abs_err': max(h['max_abs_err'] for p in paths.values()
                          for h in p['hops']),
       'ms': k1['untiered']['ms'], 'plain_ms': k1['untiered']['plain_ms'],
       'bound_ms': k1['untiered']['bound_ms'], 'bound_by': 'bytes',
       'library_ms': None, 'byte_equal': True,
       'shape': k1['untiered']['shape'], 'mesh_hetero_shapes': k1,
       'launches_by_path': {'mesh_hetero': by['sample_one_hop']}},
      {'name': 'gather_rows', 'route': 'cuda',
       'source': 'graphlearn_tpu_torch/csrc/gather_rows.cu',
       'replaces': 'graphlearn_tpu/ops/pallas_gather.py:152',
       'launches': sum(by['gather_rows'].values()),
       'max_abs_err': max(g['max_abs_err'] for p in paths.values()
                          for g in p['gathers']),
       'ms': k2['untiered'][-2]['ms'],
       'plain_ms': k2['untiered'][-2]['plain_ms'],
       'bound_ms': k2['untiered'][-2]['bound_ms'], 'bound_by': 'bytes',
       'library_ms': k2['untiered'][-2]['library_ms'], 'byte_equal': True,
       'shape': k2['untiered'][-2]['shape'], 'mesh_hetero_shapes': k2,
       'launches_by_path': {'mesh_hetero': by['gather_rows']}},
  ]


def hetero_mesh_shapes(paths: dict) -> dict:
  """K1 over one mesh_hetero batch a store: the 9 (hop, edge type) calls
  of 8 owners each, their times and bounds summed."""
  out = {}
  for store, p in paths.items():
    hs = p['hops']
    out[store] = {
        'shape': f'mesh_hetero {store} batch of {MESH_PARTS} x {IGBH_BATCH} '
                 f'paper seeds, {len(hs)} (hop, edge type) calls of '
                 f'{MESH_PARTS} owners: ' + ', '.join(
                     f'hop {h["hop"]} {h["etype"]} {h["rows"]} rows k '
                     f'{h["k"]}' for h in hs),
        'ms': sum(h['kernel_ms'] for h in hs),
        'plain_ms': sum(h['plain_ms'] for h in hs),
        'bound_ms': sum(h['bound_us'] for h in hs) / 1e3,
        'ms_per_call': sum(h['kernel_ms'] for h in hs) / (
            len(hs) * MESH_PARTS),
        'max_abs_err': max(h['max_abs_err'] for h in hs), 'byte_equal': True,
        'hops': [{'hop': h['hop'], 'etype': h['etype'], 'rows': h['rows'],
                  'k': h['k'], 'ms': h['kernel_ms'],
                  'bound_ms': h['bound_us'] / 1e3, 'plain_ms': h['plain_ms']}
                 for h in hs]}
  return out


def hetero_mesh_gathers(paths: dict) -> dict:
  """K2 over one mesh_hetero batch a store: each gathered table's 8
  owner calls summed."""
  out = {}
  for store, p in paths.items():
    out[store] = [
        {'shape': f'mesh_hetero {store} {g["table"]}: {g["ids"]} ids x '
                  f'{g["row_bytes"]} B {g["dtype"]} over {MESH_PARTS} owners',
         'ms': g['kernel_ms'], 'plain_ms': g['plain_ms'],
         'bound_ms': g['bound_us'] / 1e3, 'library_ms': g['library_ms'],
         'valid': g['valid'], 'byte_equal': True} for g in p['gathers']]
  return out


def hops_shape(what, hops, eids=False) -> dict:
  """A mesh path's sampler hops (each summed over the owners) as one
  ``kernels``-line shape."""
  out = {'shape': f'{what}, {MESH_PARTS} owners a hop, hops of '
                  + '/'.join(str(h['rows']) for h in hops) + ' rows, k '
                  + '/'.join(str(h['k']) for h in hops)
                  + (', eids = edge_ids[pos]' if eids else ''),
         'ms': sum(h['kernel_ms'] for h in hops),
         'plain_ms': sum(h['plain_ms'] for h in hops),
         'bound_ms': sum(h['bound_us'] for h in hops) / 1e3,
         'max_abs_err': max(h['max_abs_err'] for h in hops),
         'byte_equal': True,
         'hops': [{'rows': h['rows'], 'k': h['k'], 'ms': h['kernel_ms'],
                   'bound_ms': h['bound_us'] / 1e3,
                   'plain_ms': h['plain_ms'],
                   **({'no_eids_ms': h['no_eids_ms'],
                       'no_eids_bound_ms': h['no_eids_bound_ms']}
                      if eids else {})} for h in hops]}
  if eids:
    out['no_eids_ms'] = sum(h['no_eids_ms'] for h in hops)
    out['no_eids_bound_ms'] = sum(h['no_eids_bound_ms'] for h in hops)
  return out


def mesh_gather_shape(what, g) -> dict:
  return {'shape': f'{what}: {g["ids"]} ids x {g["row_bytes"]} B '
                   f'{g["dtype"]} over {MESH_PARTS} owners',
          'ms': g['kernel_ms'], 'plain_ms': g['plain_ms'],
          'bound_ms': g['bound_us'] / 1e3, 'library_ms': g['library_ms'],
          'byte_equal': True}


def mesh_link_kernels(ml: dict) -> list:
  """The ``kernels`` entries of the mesh-link path alone (``--mesh-link``):
  K1 and K1-GNS with the edge-id arm at `mesh_edges`' hops, K2 at its
  edge-row gather; launches from the phases' runs."""
  e, lk = ml['edges'], ml['link']
  un = e['paths']['untiered']
  ti = e['paths']['tiered']
  k1 = hops_shape(f'mesh_edges untiered batch of {MESH_PARTS} x '
                  f'{MESH_BATCH} seeds', un['hops'], eids=True)
  gns = hops_shape(f'mesh_edges tiered GNS batch of {MESH_PARTS} x '
                   f'{MESH_BATCH} seeds', ti['hops'], eids=True)
  edge_rows = un['gathers'][0]

  un_path = ml['unsup']['paths']['untiered']

  def launches(name):
    return {f'mesh_edges.{k}': v[name] for k, v in e['launches'].items()} | {
        f'mesh_link.{k}': v[name] for k, v in lk['launches'].items()} | {
        'mesh_unsup': ml['unsup']['launches'][name]}
  link_k1 = lk['paths']['untiered']['hops'] + un_path['hops']
  link_gns = lk['paths']['tiered_gns_with_edge']['hops']
  link_gathers = [g for p in lk['paths'].values()
                  for g in p['gathers']] + un_path['gathers']
  return [
      {'name': 'sample_one_hop', 'route': 'cuda',
       'source': 'graphlearn_tpu_torch/csrc/sample_one_hop.cu',
       'replaces': 'graphlearn_tpu/ops/pallas_sample.py:247',
       'launches': sum(launches('sample_one_hop').values()),
       'max_abs_err': max(h['max_abs_err'] for h in un['hops'] + link_k1),
       'ms': k1['ms'], 'plain_ms': k1['plain_ms'], 'bound_ms': k1['bound_ms'],
       'bound_by': 'bytes', 'library_ms': None, 'byte_equal': True,
       'shape': k1['shape'], 'hops': k1['hops'],
       'no_eids_ms': k1['no_eids_ms'],
       'launches_by_path': launches('sample_one_hop')},
      {'name': 'sample_one_hop_gns', 'route': 'cuda',
       'source': 'graphlearn_tpu_torch/csrc/sample_one_hop_gns.cu',
       'replaces': 'graphlearn_tpu/ops/pallas_sample.py:247 (gns arm :178, '
                   'eids :416-421)',
       'launches': sum(launches('sample_one_hop_gns').values()),
       'max_abs_err': max(h['max_abs_err'] for h in ti['hops'] + link_gns),
       'ms': gns['ms'], 'plain_ms': gns['plain_ms'],
       'bound_ms': gns['bound_ms'], 'bound_by': 'bytes', 'library_ms': None,
       'byte_equal': True, 'edge_mode': 'edge_ids[pos] (kEdge 2)',
       'shape': gns['shape'], 'hops': gns['hops'],
       'no_eids_ms': gns['no_eids_ms'],
       'launches_by_path': launches('sample_one_hop_gns')},
      {'name': 'gather_rows', 'route': 'cuda',
       'source': 'graphlearn_tpu_torch/csrc/gather_rows.cu',
       'replaces': 'graphlearn_tpu/ops/pallas_gather.py:152',
       'launches': sum(launches('gather_rows').values()),
       'max_abs_err': max(g['max_abs_err'] for g in
                          un['gathers'] + ti['gathers'] + link_gathers),
       'ms': edge_rows['kernel_ms'], 'plain_ms': edge_rows['plain_ms'],
       'bound_ms': edge_rows['bound_us'] / 1e3, 'bound_by': 'bytes',
       'library_ms': edge_rows['library_ms'], 'byte_equal': True,
       'shape': mesh_gather_shape('mesh_edges untiered edge rows',
                                  edge_rows)['shape'],
       'mesh_link_shapes': [
           mesh_gather_shape(f'mesh_edges {k} {t}', g)
           for k, p in e['paths'].items()
           for t, g in zip(('edge rows', 'x', 'y'), p['gathers'])],
       'launches_by_path': launches('gather_rows')},
  ]


PORT_KERNELS = {'sample_one_hop': ('sample_one_hop_kernel',),
                'sample_one_hop_gns': ('sample_gns_kernel',),
                'gather_rows': ('gather_narrow', 'gather_wide'),
                'push_rows': ('push_rows_kernel',)}


def profile_train(torch, run_step, path, n=3) -> dict:
  """Device time by kernel over ``n`` training steps of ``path``
  (``run_step()`` runs one and returns its loss; no synchronise inside):
  the top kernels, the port's kernels, and the device idle share of
  the window.  Returns the port's kernels' launches the trace saw, by
  wrapper."""
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
  mine = {w: sum(r[0] for r in rows if any(f in r[1] for f in fns))
          for w, fns in PORT_KERNELS.items()}
  seen = {w: sum(r[2] for r in rows if any(f in r[1] for f in fns))
          for w, fns in PORT_KERNELS.items()}
  emit('profile_train', path=path, steps=n, wall_ms=wall_ms,
       device_busy_ms=busy, device_idle_share=1 - busy / wall_ms,
       port_kernels_ms=mine, port_kernel_launches=seen,
       top=[{'name': k[:90], 'device_ms': ms, 'count': c}
            for ms, k, c in rows[:15]])
  return seen


def check_traced(seen, what, steps, k1, k2) -> None:
  """The trace of ``steps`` replayed steps saw ``k1`` sampler and ``k2``
  row-gather kernels a step and no other port kernel: the card's own
  witness that every replay ran them (the default run's replay counts
  are inferred from the capture)."""
  want = {w: 0 for w in PORT_KERNELS}
  want.update(sample_one_hop=k1 * steps, gather_rows=k2 * steps)
  if seen != want:
    raise AssertionError(f'{what}: the trace saw {seen}, want {want}')


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


# -- snapshots and mid-epoch resume ---------------------------------------
#: `resume_fused`: the tree epoch's chunk (``max_steps_per_program``) and
#: the planned preemption (the 4th chunk's dispatch: 3 chunks saved)
RESUME_CHUNK = 25
RESUME_KILL = 'fused.dispatch:kill:4'
#: epochs a timed arm (no snapshot / a snapshot every chunk), min counts
RESUME_TIMED = 2                    # (depth cut, 3 -> 2)
#: `resume_mesh`: batches an epoch, batches consumed before the kill, and
#: the resumed loader's epochs with a snapshot at the bench row's cadence
#: (``GLT_SNAPSHOT_EVERY``, default 8 batches) after the resumed one; the
#: no-snapshot arm is the reference's epochs 1 and 2
RESUME_MESH_BATCHES = 16
RESUME_MESH_KILL_AFTER = 8
RESUME_MESH_PAIRS = 1               # snap/none pairs (depth cut, 2 -> 1)
#: timed calls of each resumed kernel call's check: the checks are for
#: byte-equality; the same shapes are timed at 30 calls by earlier phases
RESUME_CHECK_REPS = 5


def dir_bytes(path) -> int:
  """Bytes of the files under ``path``."""
  return sum(os.path.getsize(os.path.join(d, f))
             for d, _, files in os.walk(path) for f in files)


def timed_saves(torch, fused) -> list:
  """Wrap a fused driver's chunk-boundary snapshot: the returned list
  gets ``(seconds, bytes)`` for each save that happened, timed from the
  card's end of the chunk (the host copies of the losses and the train
  state included)."""
  real = fused._save_chunk_snapshot
  out = []

  def wrapped(*a, **kw):
    idx = fused._snap._save_idx
    sync(torch)
    t = time.perf_counter()
    real(*a, **kw)
    if fused._snap._save_idx != idx:
      step = fused._snap._ckpt._step_dir(fused._snap._save_idx)
      out.append((time.perf_counter() - t, dir_bytes(step)))
  fused._save_chunk_snapshot = wrapped
  return out


def killed_run(chaos, plan, fn) -> None:
  """Run ``fn`` under the fault ``plan``, which must kill it."""
  chaos.install(plan)
  try:
    fn()
  except chaos.ChaosKilledError:
    return
  finally:
    chaos.uninstall()
  raise AssertionError(f'the planned kill {plan!r} did not fire')


def train_state_copy(fused) -> dict:
  """Copies of a driver's parameters and optimizer state by name (a
  restored optimizer keeps a parameter's state under the same keys, in
  another order)."""
  out = {f'model.{k}': v.clone() for k, v in fused.model.state_dict().items()}
  params = [p for g in fused.optimizer.param_groups for p in g['params']]
  for i, p in enumerate(params):
    for k, v in fused.optimizer.state[p].items():
      if hasattr(v, 'clone'):
        out[f'optimizer.{i}.{k}'] = v.clone()
  return out


def same_tensors(what, got: dict, want: dict) -> None:
  bad = [k for k in want if k not in got or not got[k].equal(want[k])]
  if bad or got.keys() != want.keys():
    raise AssertionError(f'{what}: {bad or "the keys"} differ from the '
                         'uninterrupted run')


def resume_fused(torch, ops, timer, ds, feats, train_idx) -> dict:
  """Snapshots and mid-epoch resume of the captured tree epoch
  (`tree_train`'s setup with chunks of `RESUME_CHUNK` steps), under
  deterministic algorithms: an uninterrupted twin runs two epochs; a
  second driver snapshots every chunk and is killed at the 4th chunk's
  dispatch; a fresh driver with a model and optimizer from another init
  restores, finishes the epoch and runs the next.  Its losses, counts,
  parameters and Adam state must be bitwise the twin's in both epochs,
  the resumed steps 3 K1 and 4 K2 launches each, and their first step's
  K1 and K2 calls byte-equal to the plain versions.  Then a driver
  captured outside deterministic mode (as `tree_train`'s) runs a warm
  epoch, `RESUME_TIMED` epochs without snapshots and as many with one
  every chunk."""
  import shutil
  import tempfile
  import graphlearn_tpu_torch.loader.fused_tree as ftmod
  from graphlearn_tpu_torch.loader import FusedTreeEpoch
  from graphlearn_tpu_torch.models import TreeSAGE
  from graphlearn_tpu_torch.testing import chaos
  from graphlearn_tpu_torch.utils.checkpoint import SnapshotManager

  def make(init):
    model = TreeSAGE(FEAT_DIM, 256, GNS_CLASSES, num_layers=3).to(DEVICE)
    model.reset_parameters(torch.Generator().manual_seed(init))
    opt = torch.optim.Adam(model.parameters(), lr=TRAIN_LR, eps=1e-8,
                           capturable=True)
    return FusedTreeEpoch(ds, FANOUTS, train_idx, model, opt,
                          batch_size=TRAIN_BATCH, shuffle=True, seed=0,
                          max_steps_per_program=RESUME_CHUNK, device=DEVICE)

  def epoch(fused):
    st = fused.run()
    return (st.losses.clone(), int(st.correct), int(st.seeds),
            train_state_copy(fused))

  def same(what, got, want):
    if not (torch.equal(got[0], want[0]) and got[1:3] == want[1:3]):
      raise AssertionError(f'{what}: losses or counts differ from the '
                           'uninterrupted run')
    same_tensors(what, got[3], want[3])

  root = tempfile.mkdtemp(prefix='glt_resume_fused_')
  try:
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
      ref = make(0)
      ref_epochs = [epoch(ref), epoch(ref)]
      steps = len(ref)
      del ref
      killed = make(0)
      killed.attach_snapshots(SnapshotManager(f'{root}/kill', every=1))
      kill_saves = timed_saves(torch, killed)
      killed_run(chaos, RESUME_KILL, killed.run)
      del killed
      resumed = make(11)
      resumed.attach_snapshots(SnapshotManager(f'{root}/kill'))
      sync(torch)
      t0 = time.perf_counter()
      prog = resumed.restore_from_snapshot()
      sync(torch)
      restore_secs = time.perf_counter() - t0
      next_chunk = int(prog['next_chunk'])
      reset_counts(ops)
      with TrainRecorder(torch, ftmod, len(FANOUTS) + 1) as rec:
        got1 = epoch(resumed)
      resumed_steps = steps - next_chunk
      launches = check_replay_counts(ops, 'resumed tree epoch',
                                     resumed_steps, len(FANOUTS),
                                     len(FANOUTS) + 1)
      same('resumed epoch 1', got1, ref_epochs[0])
      same('epoch 2 after the resume', epoch(resumed), ref_epochs[1])
      del resumed
    finally:
      torch.use_deterministic_algorithms(False)
      chaos.uninstall()
    # deterministic mode fills every fresh allocation first, so the
    # kernels are checked and the epochs timed outside it
    hops, levels = [], []
    for t in range(len(FANOUTS)):
      r = check_sampler(torch, ops, timer, *rec.hops[t])[1]
      emit('kernel', kernel='sample_one_hop', shape=f'resume_fused hop {t}',
           **r)
      hops.append(r)
    for t, (table, ids) in enumerate(rec.gathers):
      r = check_gather(torch, ops, timer, table, ids)
      emit('kernel', kernel='gather_rows', shape=f'resume_fused level {t}',
           **r)
      levels.append(r)
    del rec
    timed = make(0)
    timed.run()                                  # captures the step
    arms = {'none': [], 'every_chunk': []}
    saves = []
    for arm in arms:
      if arm == 'every_chunk':
        timed.attach_snapshots(SnapshotManager(f'{root}/overhead', every=1))
        saves = timed_saves(torch, timed)
      for _ in range(RESUME_TIMED):
        sync(torch)
        t = time.perf_counter()
        timed.run()
        sync(torch)
        arms[arm].append(time.perf_counter() - t)
    del timed
  finally:
    shutil.rmtree(root, ignore_errors=True)
  none, snap = min(arms['none']), min(arms['every_chunk'])
  out = dict(
      model=f'TreeSAGE({FEAT_DIM}->256->{GNS_CLASSES}, 3 layers), '
            f'Adam({TRAIN_LR}, capturable), captured',
      batch=TRAIN_BATCH, steps_per_epoch=steps, chunk_steps=RESUME_CHUNK,
      kill=RESUME_KILL, saves_before_kill=len(kill_saves),
      chunks_skipped=next_chunk // RESUME_CHUNK, resumed_steps=resumed_steps,
      restore_secs=restore_secs,
      kill_save_ms=[s * 1e3 for s, _ in kill_saves],
      save_ms=[s * 1e3 for s, _ in saves],
      save_ms_median=float(np.median([s for s, _ in saves])) * 1e3,
      snapshot_bytes=kill_saves[-1][1],
      epoch_secs_nosnap_runs=arms['none'],
      epoch_secs_snap_runs=arms['every_chunk'], epoch_secs_nosnap=none,
      epoch_secs_snap=snap, snapshot_overhead_pct=100.0 * (snap - none) / none,
      snap_over_nosnap_ratio=none / snap,
      deterministic={'bitwise_part': True, 'kernel_checks_and_timed': False},
      bitwise_equal={'epoch_1': True, 'epoch_2': True},
      launches=launches, launches_per_step={
          'sample_one_hop': len(FANOUTS), 'gather_rows': len(FANOUTS) + 1},
      plain_calls=0)
  emit('resume_fused', **out)
  out.update(hops=hops, levels=levels)
  return out


def resume_mesh(torch, ops, timer, ds, feats, labels, train_idx) -> dict:
  """`bench_dist_loader.py --resume`'s kill -> durable restore -> finish
  loop on the mesh loader: the tiered GNS store at P = 8 (`mesh_train`'s
  loader, 512 seeds a partition, the equal-HBM victim cache, the
  dispatch-ahead overlay, ``prefetch=0``) over the first `RESUME_MESH_
  BATCHES` batches' worth of the train split.  A reference loader's
  epochs 1 and 2 give per-batch digests (node, edge_index, x, y, edge
  weights); a second loader consumes `RESUME_MESH_KILL_AFTER` batches,
  saves and is dropped; a fresh loader loads the snapshot and
  `resume_epoch` hands out the rest.  The resumed loader (its victim
  cache warm from a whole epoch) then runs `RESUME_MESH_PAIRS` pairs of
  epochs in ABBA order, snap / none / none / snap (one pair: snap /
  none), so that drift across epochs cancels: the snap arm saves every ``GLT_SNAPSHOT_EVERY``
  (default 8) batches, the none arm not at all; the first epoch is held
  to the reference's epoch 2.  The ratio is over the pairs' sums, on one
  loader, so cache warmth and epoch order weigh on both arms alike.
  Every digest must
  equal the reference's, every x row and label its source, the resumed
  dispatches 24 K1-GNS and 16 K2 launches each, and the first resumed
  dispatch's calls byte-equal to the plain versions.
  ``replayed_batches`` is 0 on this path: the batcher skips the consumed
  batches before any sampling."""
  import shutil
  import tempfile
  import graphlearn_tpu_torch.parallel.dist_sampler as dsm
  from graphlearn_tpu_torch.parallel import DistNeighborLoader
  from graphlearn_tpu_torch.utils.checkpoint import (SnapshotManager,
                                                     snapshot_every_from_env)
  n_seeds = MESH_BATCH * MESH_PARTS * RESUME_MESH_BATCHES
  seeds = train_idx[:n_seeds]
  cache_rows = int(ds.node_features.hot_counts.max())

  def make():
    return DistNeighborLoader(ds, FANOUTS, seeds, batch_size=MESH_BATCH,
                              shuffle=True, seed=0,
                              cold_cache_rows=cache_rows, gns=True,
                              device=DEVICE)

  def batch_digest(b):
    return digest(torch, [b.node, b.edge_index, b.x, b.y,
                          b.metadata['edge_weight']])

  def timed_epoch(loader, snap=None):
    """One epoch's digests and seconds (to its last batch's end on the
    card), with a snapshot whenever ``snap`` is due."""
    sync(torch)
    t = time.perf_counter()
    got, seen = [], 0
    for b in loader:
      got.append(batch_digest(b))
      seen += 1
      if snap is not None and snap.due():
        sync(torch)
        ts = time.perf_counter()
        snap.save(loader.state_dict(), {'epoch': 0, 'next_chunk': seen})
        save_secs.append(time.perf_counter() - ts)
    sync(torch)
    return torch.stack(got).cpu(), time.perf_counter() - t

  new2old = torch.from_numpy(ds.new2old).to(DEVICE)
  every = snapshot_every_from_env(default=8)
  root = tempfile.mkdtemp(prefix='glt_resume_mesh_')
  mgrs, save_secs, arms = [], [], {'none': [], 'snap': []}
  try:
    ref = make()
    ref_digests = [timed_epoch(ref)[0] for _ in range(2)]
    del ref
    if len(ref_digests[0]) != RESUME_MESH_BATCHES:
      raise AssertionError(f'{len(ref_digests[0])} batches an epoch')
    loader = make()
    it = iter(loader)
    pre = torch.stack([batch_digest(next(it))
                       for _ in range(RESUME_MESH_KILL_AFTER)]).cpu()
    kill = SnapshotManager(f'{root}/kill', every=1)
    mgrs.append(kill)
    sync(torch)
    t0 = time.perf_counter()
    if not kill.save(loader.state_dict(),
                     {'epoch': 1, 'next_chunk': loader._consumed}):
      raise AssertionError('the snapshot before the kill failed')
    kill_save_secs = time.perf_counter() - t0
    snapshot_bytes = dir_bytes(kill.directory)
    del loader, it                               # the preemption
    resumed = make()
    sync(torch)
    t0 = time.perf_counter()
    fresh = SnapshotManager(f'{root}/kill')
    mgrs.append(fresh)
    resumed.load_state_dict(fresh.restore_latest()['plane'])
    sync(torch)
    restore_secs = time.perf_counter() - t0
    reset_counts(ops)
    rest, valid = [], 0
    with PathRecorder(torch, dsm, gns=True, parts=MESH_PARTS,
                      first=True) as rec:
      for b in resumed.resume_epoch():
        valid += check_mesh_batch(torch, b, feats, labels, new2old)
        rest.append(batch_digest(b))
    launches, plain = read_counts(ops)
    resumed_batches = len(rest)
    want = {'sample_one_hop_gns': len(FANOUTS) * MESH_PARTS
            * resumed_batches, 'gather_rows': 2 * MESH_PARTS
            * resumed_batches}
    if (any(launches[k] != v for k, v in want.items())
        or launches['sample_one_hop'] or plain or resumed_batches == 0):
      raise AssertionError(f'resumed mesh epoch: launches {launches}, plain '
                           f'{plain}, want {want}')
    if not (torch.equal(torch.cat([pre, torch.stack(rest).cpu()]),
                        ref_digests[0])
            and RESUME_MESH_KILL_AFTER + resumed_batches
            == RESUME_MESH_BATCHES):
      raise AssertionError('the resumed mesh epoch differs from the '
                           'uninterrupted one')
    snap = SnapshotManager(f'{root}/overhead', every=every)
    mgrs.append(snap)
    order = (['snap', 'none', 'none', 'snap']
             * RESUME_MESH_PAIRS)[:2 * RESUME_MESH_PAIRS]
    for e, arm in enumerate(order):
      d, secs = timed_epoch(resumed, snap if arm == 'snap' else None)
      arms[arm].append(secs)
      if e == 0 and not torch.equal(d, ref_digests[1]):
        raise AssertionError('the epoch after the resume differs from the '
                             "uninterrupted run's next epoch")
    del resumed
    path = check_mesh_path(torch, ops, timer, rec, 'resume_mesh')
    del rec
  finally:
    for m in mgrs:
      m.close()
    shutil.rmtree(root, ignore_errors=True)
  rate = {arm: n_seeds * len(v) / sum(v) for arm, v in arms.items()}
  out = dict(
      parts=MESH_PARTS, batch=MESH_BATCH, fanouts=list(FANOUTS),
      store=f'tiered split {MESH_SPLIT}, GNS, victim cache {cache_rows} '
            'rows a partition, dispatch-ahead overlay, prefetch=0',
      batches_per_epoch=RESUME_MESH_BATCHES,
      restore_secs=restore_secs, replayed_batches=0,
      replayed_note='the batcher skips the consumed batches before any '
                    'sampling: nothing is re-produced',
      resumed_batches=resumed_batches,
      consumed_before_kill=RESUME_MESH_KILL_AFTER,
      seeds_per_sec_nosnap=rate['none'], seeds_per_sec_snap=rate['snap'],
      snapshot_overhead_pct=100.0 * (sum(arms['snap']) - sum(arms['none']))
      / sum(arms['none']),
      snap_over_nosnap_ratio=rate['snap'] / rate['none'],
      arm_order=order,
      pair_ratios=[n / s for n, s in zip(arms['none'], arms['snap'])],
      snapshot_every=every, snapshot_bytes=snapshot_bytes,
      kill_save_secs=kill_save_secs, save_secs=save_secs,
      epoch_secs=arms, valid_nodes=valid,
      digests_equal={'resumed_epoch': True, 'next_epoch': True},
      launches=launches, plain_calls=0, x_rows_byte_equal=True,
      y_byte_equal=True)
  emit('resume_mesh', **out)
  out.update(path=path)
  return out


def resume_fused_mesh(torch, ops, timer, ds) -> dict:
  """A fused mesh epoch at an epoch boundary: `fused_mesh`'s
  `FusedDistEpoch` setup (untiered P = 8 store, ``GraphSAGE(100, 64, 47,
  2)``, Adam(3e-3), 512 seeds a partition, [10, 5], 4 steps an epoch)
  under deterministic algorithms.  An uninterrupted run takes two
  epochs; a second driver, saving at each epoch's end, is killed at
  epoch 2's dispatch; a fresh driver (another init) restores: its first
  `run` returns epoch 1's saved stats without a launch, its second reruns
  epoch 2, whose losses, counts, parameters and Adam state must be
  bitwise the uninterrupted run's, with 16 K1 and 16 K2 launches a step
  and the first step's calls byte-equal to the plain versions."""
  import shutil
  import tempfile
  import graphlearn_tpu_torch.parallel.dist_sampler as dsm
  from graphlearn_tpu_torch.models import GraphSAGE
  from graphlearn_tpu_torch.parallel import FusedDistEpoch
  from graphlearn_tpu_torch.testing import chaos
  from graphlearn_tpu_torch.utils.checkpoint import SnapshotManager
  b, fan = MESH_BATCH, FUSED_MESH_FANOUTS
  per_step = len(fan) * MESH_PARTS
  seeds = np.random.default_rng(0).permutation(NUM_NODES)[
      :b * MESH_PARTS * FUSED_MESH_BATCHES]

  def make(init):
    m = GraphSAGE(FEAT_DIM, FUSED_MESH_HIDDEN, GNS_CLASSES,
                  num_layers=2).to(DEVICE)
    m.reset_parameters(torch.Generator().manual_seed(init))
    opt = torch.optim.Adam(m.parameters(), lr=TRAIN_LR, eps=1e-8)
    return FusedDistEpoch(ds, fan, seeds, m, opt, batch_size=b, shuffle=True,
                          seed=0, device=DEVICE)

  def epoch(fused):
    st = fused.run()
    return (st.losses.clone(), int(st.correct), int(st.seeds),
            train_state_copy(fused))

  root = tempfile.mkdtemp(prefix='glt_resume_fmesh_')
  torch.use_deterministic_algorithms(True, warn_only=True)
  try:
    ref = make(1)
    ref_epochs = [epoch(ref), epoch(ref)]
    del ref
    killed = make(1)
    killed.attach_snapshots(SnapshotManager(root, every=1))
    saves = timed_saves(torch, killed)
    killed.run()
    killed_run(chaos, 'fused.dispatch:kill:1:epoch=2', killed.run)
    del killed
    resumed = make(3)
    resumed.attach_snapshots(SnapshotManager(root))
    sync(torch)
    t0 = time.perf_counter()
    prog = resumed.restore_from_snapshot()
    sync(torch)
    restore_secs = time.perf_counter() - t0
    reset_counts(ops)
    again = epoch(resumed)
    skipped_launches, plain = read_counts(ops)
    if any(skipped_launches.values()) or plain or int(prog['epoch']) != 1:
      raise AssertionError(f'the finished epoch ran again: launches '
                           f'{skipped_launches}, plain {plain}')
    if not (torch.equal(again[0], ref_epochs[0][0])
            and again[1:3] == ref_epochs[0][1:3]):
      raise AssertionError('the restored epoch 1 stats differ')
    reset_counts(ops)
    with PathRecorder(torch, dsm, gns=False, parts=MESH_PARTS,
                      hops=len(fan), first=True) as rec:
      got2 = epoch(resumed)
    launches = check_replay_counts(ops, 'resumed fused mesh epoch',
                                   FUSED_MESH_BATCHES, per_step, per_step)
    if not (torch.equal(got2[0], ref_epochs[1][0])
            and got2[1:3] == ref_epochs[1][1:3]):
      raise AssertionError('the rerun epoch 2 differs from the '
                           'uninterrupted one')
    same_tensors('the rerun epoch 2', got2[3], ref_epochs[1][3])
    del resumed
  finally:
    torch.use_deterministic_algorithms(False)
    chaos.uninstall()
    shutil.rmtree(root, ignore_errors=True)
  path = check_mesh_path(torch, ops, timer, rec, 'resume_fused_mesh',
                         tables=('features', 'labels'))
  del rec
  out = dict(
      parts=MESH_PARTS, batch=b, fanouts=list(fan),
      steps_per_epoch=FUSED_MESH_BATCHES,
      kill='fused.dispatch:kill:1:epoch=2', saves=len(saves),
      save_ms=[s * 1e3 for s, _ in saves], snapshot_bytes=saves[-1][1],
      restore_secs=restore_secs, restored_epoch=int(prog['epoch']),
      finished_epoch_launches=skipped_launches, deterministic=True,
      bitwise_equal={'epoch_2': True}, launches=launches,
      launches_per_step={'sample_one_hop': per_step,
                         'gather_rows': per_step}, plain_calls=0)
  emit('resume_fused_mesh', **out)
  out.update(path=path)
  return out


def resume_phases(torch, ops, timer, indptr, indices, feats, ds) -> None:
  """``--resume``: the snapshot and resume phases alone (`resume_fused`
  on the products dataset, then `mesh_data`, `resume_fused_mesh` on the
  untiered store and `resume_mesh` on the tiered one)."""
  labels = make_labels(torch, feats)
  ds.init_node_labels(labels)
  train_idx = train_splits()[0]
  timer = Timer(torch, reps=RESUME_CHECK_REPS)
  resume_fused(torch, ops, timer, ds, feats, train_idx)
  torch.cuda.empty_cache()
  ds_u, ds_t = mesh_data(torch, indptr, indices, feats, labels)
  resume_fused_mesh(torch, ops, timer, ds_u)
  del ds_u
  torch.cuda.empty_cache()
  resume_mesh(torch, ops, timer, ds_t, feats, labels, train_idx)


def tiered_phases(torch, ops, timer, indptr, indices, feats, ds, labels,
                  train_idx, full=True, prof=False) -> tuple:
  """The single-card tiered store and K6: the link's rate, K6's forced
  sets, tiered serving, tiered training (with K6's diagnosis), then,
  when ``full``, the lookup sweep and the card-vs-CPU cross-check."""
  link = link_rate(torch, timer)
  k6_forced = forced_cold_sets(torch, ops, timer)
  emit('kernel', kernel='cold_gather', shape='forced sets', link=link,
       thp=thp_mode(), cases=k6_forced)
  feats_h = feats.cpu()
  tserve_launches, k6_serve = tiered_serve(torch, ops, timer, indptr,
                                           indices, feats_h, ds)
  ttrain_runs, k6_train, ds_t = tiered_train(
      torch, ops, timer, indptr, indices, feats_h, feats, labels, train_idx,
      prof=prof)
  if full:
    feature_lookup(torch, ds, ds_t, train_idx)
  ds_t.node_features.close()
  del ds_t, feats_h
  if full:
    tiered_cross_check(torch)
  torch.cuda.empty_cache()
  return link, k6_forced, tserve_launches, k6_serve, ttrain_runs, k6_train


def fused_phases(torch, ops, timer, indptr, indices, feats, ds,
                 prof=False) -> None:
  """``--fused``: the fused epochs' phases alone (`tree_train`,
  `fused_session`, `train_cross_check`, then `mesh_data`, `fused_mesh`
  and `fused_mesh_cross_check`)."""
  labels = make_labels(torch, feats)
  ds.init_node_labels(labels)
  train_idx, test_idx = train_splits()
  launches, _, _, tree_fused, tree_f32 = tree_train(
      torch, ops, timer, ds, feats, train_idx, test_idx)
  fused_session(torch, ops, timer, ds, feats, train_idx, test_idx,
                (tree_fused, tree_f32), prof=prof)
  del tree_fused
  train_cross_check(torch)
  torch.cuda.empty_cache()
  ds_u, ds_t = mesh_data(torch, indptr, indices, feats, labels)
  del ds_t
  fused_mesh(torch, ops, timer, ds_u)
  fused_mesh_cross_check(torch)


# -- the rest of serving: hot swap, the fleet, autoscaling, the build cache --
FLEET_REPLICAS = 3
FLEET_SPLIT = 0.5                   # bench_serving.py --fleet's tiered split
FLEET_MAX_WAIT_MS = 10.0            # bench_serving.py:409-410
FLEET_DEADLINE_MS = 2000.0
FLEET_LAP_S = 5.0                   # the closed-loop capacity lap
FLEET_LAP_CLIENTS = 12
FLEET_LOAD = 0.7                    # open-loop rate / the lap's rate
FLEET_DRIVE_S = 20.0
FLEET_STALL_S = 0.12                # bench_serving.py:440-448's plan
FLEET_CHECKED = 32
FLEET_SIZES = (1, 1, 1, 1, 2, 2, 4)  # bench_serving.make_schedule's mix
AUTO_PEAK, AUTO_TROUGH = 1.3, 0.15  # x one replica's rate (160 : 20)
AUTO_CYCLE_S = 12.0                 # the products arm's cycle (depth cut)
AUTO_LAP_S = 3.0
AUTO_LAP_CLIENTS = 8
AUTO_TROUGH_S = 3.0
AUTO_MAX = 3
AUTO_MAX_WAIT_MS = 8.0              # bench_autoscale.make_replica
AUTO_SLO_WINDOWS = (1.0, 3.0)       # bench_autoscale.BENCH_SLO_WINDOWS
AUTO_SLO_BUDGET = 0.1               # bench_autoscale.BENCH_SLO_BUDGET
AUTO_GRACE_S = 6.0
#: `bench_autoscale.py`'s own arm: its replica (`make_replica`:
#: `build_dataset(20000, 32, split_ratio=0.5)`, fanouts [5, 3], engine
#: seed 11), its diurnal plan (`make_diurnal_schedule(160, 20, 9 s,
#: Zipf 1.1, seed 5)`), its 50 ms injected dispatch cost and its knobs
AB_NODES, AB_DIM, AB_SPLIT = 20_000, 32, 0.5
AB_FANOUTS = (5, 3)
AB_PEAK, AB_TROUGH, AB_CYCLE_S, AB_SEED = 160.0, 20.0, 9.0, 5
AB_DELAY_S = 0.05                   # bench_autoscale.DISPATCH_DELAY_S
AB_ENV = (('GLT_SERVING_BUCKETS', '8'), ('GLT_SERVING_QUEUE_DEPTH', '64'),
          ('GLT_SERVING_SLO_P99_MS', '500'),
          ('GLT_SERVING_SLO_QPS', str(AB_PEAK / 2)))
AOT_CORRUPT = 'push_rows'


def fleet_schedule(rate, secs, seed, peak=None, trough=None, n=None):
  """`bench_serving.make_schedule`'s open-loop plan, ``[(offset,
  seeds)]``: Poisson arrivals at ``rate`` (or, with ``peak``/``trough``,
  `bench_autoscale.make_diurnal_schedule`'s one sinusoidal cycle by
  thinning), 1-4 Zipf(1.1) seeds through a fixed permutation of ``n``
  nodes (default `NUM_NODES`)."""
  n = NUM_NODES if n is None else n
  rng = np.random.default_rng(seed)
  top = rate if peak is None else peak
  arrivals, t = [], 0.0
  while True:
    t += rng.exponential(1.0 / top)
    if t >= secs:
      break
    if peak is not None:
      r = trough + (peak - trough) * 0.5 * (1 - np.cos(2 * np.pi * t / secs))
      if rng.random() >= r / peak:
        continue
    arrivals.append(t)
  perm = rng.permutation(n)
  return [(a, perm[(rng.zipf(ZIPF_A, int(rng.choice(FLEET_SIZES))) - 1)
                   % n].astype(np.int64)) for a in arrivals]


def pace(plan, submit, max_retries=8):
  """`bench_serving.pace_schedule`: submit each request at its offset,
  never waiting on earlier ones; a ``draining`` refusal is resubmitted
  after its ``retry_after_ms`` (up to ``max_retries`` times), other
  refusals are sheds.  Returns ``([(offset, future | 'shed' |
  'error')], t0, retries)``."""
  import heapq
  from graphlearn_tpu_torch.serving import AdmissionRejected
  out, retryq, t0 = [], [], time.monotonic()
  n_retry = [0]

  def attempt(offset, seeds, tries):
    try:
      out.append((offset, submit(seeds)))
    except AdmissionRejected as e:
      if (e.reason == 'draining' and e.retry_after_ms is not None
          and tries < max_retries):
        n_retry[0] += 1
        heapq.heappush(retryq, (time.monotonic() - t0
                                + e.retry_after_ms / 1e3, n_retry[0],
                                offset, seeds, tries + 1))
      else:
        out.append((offset, 'shed'))
    except Exception:               # noqa: BLE001 — a door failure
      out.append((offset, 'error'))

  for offset, seeds in plan:
    while retryq and retryq[0][0] <= time.monotonic() - t0:
      _, _, o, s, tries = heapq.heappop(retryq)
      attempt(o, s, tries)
    wait = offset - (time.monotonic() - t0)
    if wait > 0:
      time.sleep(wait)
    attempt(offset, seeds, 0)
  while retryq:
    due, _, o, s, tries = heapq.heappop(retryq)
    wait = due - (time.monotonic() - t0)
    if wait > 0:
      time.sleep(wait)
    attempt(o, s, tries)
  return out, t0, n_retry[0]


def collect(pending, t0) -> dict:
  """Resolve `pace`'s futures: ok latencies from the scheduled arrival
  (sorted), counts by outcome, the ok results by offset, the first
  error."""
  from graphlearn_tpu_torch.serving import AdmissionRejected
  lats, ok, outcomes, first = [], [], [], None
  for offset, fut in pending:
    if isinstance(fut, str):
      outcomes.append((offset, fut))
      continue
    try:
      res = fut.result(30.0)
    except AdmissionRejected:
      outcomes.append((offset, 'shed'))
      continue
    except Exception as e:          # noqa: BLE001 — counted, then fatal
      outcomes.append((offset, 'error'))
      first = first or f'{type(e).__name__}: {e}'
      continue
    lats.append((offset,
                 max(1e3 * (fut.done_monotonic - (t0 + offset)), 0.0)))
    ok.append((offset, res))
    outcomes.append((offset, 'ok'))
  count = {k: sum(1 for _, o in outcomes if o == k)
           for k in ('ok', 'shed', 'error')}
  return {'lats': sorted(lat for _, lat in lats), 'timed': lats,
          'results': ok, 'outcomes': outcomes, 'first_error': first,
          **count}


def nearest_rank(lats, p) -> float:
  """`bench_serving._percentile` (the report's nearest-rank quantile,
  ``p`` in [0, 1]); 0 when empty, as the bench rounds None."""
  if not lats:
    return 0.0
  s = sorted(lats)
  return float(s[min(int(p * (len(s) - 1) + 0.5), len(s) - 1)])


def closed_lap(submit, reqs, clients, secs) -> dict:
  """``clients`` threads each submit and wait, back to back, for
  ``secs``: the closed-loop requests/s and latencies."""
  stop = time.perf_counter() + secs
  lats, errors = [], []

  def client(c):
    i = c
    while time.perf_counter() < stop:
      t = time.perf_counter()
      try:
        submit(reqs[i % len(reqs)]).result(60.0)
        lats.append((time.perf_counter() - t) * 1e3)
      except Exception as e:        # noqa: BLE001 — counted, then fatal
        errors.append(f'{type(e).__name__}: {e}')
      i += clients

  t0 = time.perf_counter()
  threads = [threading.Thread(target=client, args=(c,))
             for c in range(clients)]
  for t in threads:
    t.start()
  for t in threads:
    t.join()
  wall = time.perf_counter() - t0
  if errors:
    raise AssertionError(f'closed lap failed: {errors[:3]}')
  return {'requests': len(lats), 'secs': wall,
          'requests_per_s': len(lats) / wall,
          'p50_ms': nearest_rank(lats, 0.50),
          'p99_ms': nearest_rank(lats, 0.99)}


class SmiSampler:
  """The card's idle share over a window, from ``nvidia-smi``'s
  ``utilization.gpu`` (the share of the last sample period in which a
  kernel ran), read every 100 ms by one child process that the window's
  end stops."""

  def __enter__(self):
    self.proc = subprocess.Popen(
        ['nvidia-smi', '--query-gpu=utilization.gpu',
         '--format=csv,noheader,nounits', '-lms', '100'],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    return self

  def __exit__(self, *exc):
    self.proc.terminate()
    out, _ = self.proc.communicate(timeout=10)
    vals = [float(v) for v in out.split() if v.replace('.', '').isdigit()]
    self.result = {'device_idle_share': (1 - float(np.mean(vals)) / 100
                                         if vals else None),
                   'samples': len(vals),
                   'source': 'nvidia-smi utilization.gpu every 100 ms'}


def fleet_state(torch) -> dict:
  """The served model's random params, from a seed."""
  from graphlearn_tpu_torch.models import TreeSAGE
  model = TreeSAGE(FEAT_DIM, 256, 47, 3)
  model.reset_parameters(torch.Generator().manual_seed(0))
  return model.state_dict()


def swap_phase(torch, indptr, indices, feats, state) -> dict:
  """Hot swap under live traffic on the untiered engine: 4 clients send
  the serve phase's 256 requests (1-16 seeds; a ``draining`` refusal is
  resubmitted after its hint), and a third of the way in `hot_swap`
  moves to params from ``Generator().manual_seed(1)``.  Checks: nothing
  fails or drops, the version is bumped by 1, every answer equals the
  engine's answer under the old or the new params (nodes byte-equal,
  logits within 1e-5; the request served alone, and 16 of them
  against `offline_reference`), every request submitted after the swap
  returned is the new params'.  Then a wrong-width state is refused
  with `SwapValidationError` before the door drains, and a candidate
  that fails the parity probe (``atol=0`` when the card's logits differ
  across buckets, else a NaN in one bias) gives `SwapParityError` with
  the version unchanged and an answer bitwise the one before."""
  from graphlearn_tpu_torch.data import Dataset
  from graphlearn_tpu_torch.models import TreeSAGE
  from graphlearn_tpu_torch.serving import (AdmissionRejected, ServingEngine,
                                            ServingFrontend,
                                            SwapParityError,
                                            SwapValidationError, hot_swap)
  from graphlearn_tpu_torch.telemetry import recorder
  ds = (Dataset().init_graph((indptr, indices), layout='CSR',
                             num_nodes=NUM_NODES, device=DEVICE)
        .init_node_features(feats, device=DEVICE))
  eng = ServingEngine(ds, FANOUTS, model=TreeSAGE(FEAT_DIM, 256, 47, 3),
                      params=state, seed=0, buckets=BUCKETS, device=DEVICE)
  fe = ServingFrontend(eng, max_wait_ms=2.0, default_deadline_ms=10_000.0)

  def params(seed, hidden=256):
    m = TreeSAGE(FEAT_DIM, hidden, 47, 3)
    m.reset_parameters(torch.Generator().manual_seed(seed))
    return {k: v.to(DEVICE) for k, v in m.state_dict().items()}

  old = {k: v.to(DEVICE) for k, v in state.items()}
  new = params(1)
  rng = np.random.default_rng(0)
  reqs = [rng.integers(0, NUM_NODES, int(rng.integers(1, 17)))
          for _ in range(N_REQUESTS)]
  results, sent = [None] * len(reqs), [0.0] * len(reqs)
  errors, retries, resolved = [], [0], [0]

  def client(lo):
    for i in range(lo, len(reqs), N_CLIENTS):
      while True:
        sent[i] = time.monotonic()
        try:
          results[i] = fe.submit(reqs[i]).result(60.0)
          resolved[0] += 1
          break
        except AdmissionRejected as e:
          if e.reason != 'draining':
            errors.append(f'request {i}: shed {e.reason}')
            break
          retries[0] += 1
          time.sleep(e.retry_after_ms / 1e3)
        except Exception as e:      # noqa: BLE001 — counted, then fatal
          errors.append(f'request {i}: {type(e).__name__}: {e}')
          break

  threads = [threading.Thread(target=client, args=(c,))
             for c in range(N_CLIENTS)]
  t0 = time.perf_counter()
  for t in threads:
    t.start()
  while resolved[0] < len(reqs) // 3 and any(t.is_alive() for t in threads):
    time.sleep(0.0005)
  swapped_after = resolved[0]
  out = hot_swap(fe, new)
  t_swapped = time.monotonic()
  for t in threads:
    t.join()
  wall = time.perf_counter() - t0
  if errors or any(r is None for r in results):
    raise AssertionError(f'swap under traffic dropped requests: {errors[:3]}')
  if out['version'] != 1 or eng.model_version != 1:
    raise AssertionError(f'swap version {out}, engine {eng.model_version}')
  served_by, worst = [0, 0], 0.0
  for i, res in enumerate(results):
    refs = [eng.infer(reqs[i], params=p) for p in (old, new)]
    close = []
    for ref in refs:
      if ref.nodes.tobytes() != res.nodes.tobytes():
        raise AssertionError(f'swap request {i}: nodes differ')
      close.append(bool(np.allclose(res.logits, ref.logits, rtol=1e-5,
                                    atol=1e-5)))
    if not any(close) or (sent[i] > t_swapped and not close[1]):
      raise AssertionError(f'swap request {i}: logits match neither '
                           f'version ({close}, after swap: '
                           f'{sent[i] > t_swapped})')
    v = int(close[1])
    served_by[v] += 1
    if i < 16:
      ref = eng.offline_reference(reqs[i], params=(old, new)[v])
      if ref.nodes.tobytes() != res.nodes.tobytes():
        raise AssertionError(f'swap request {i}: nodes != offline')
      np.testing.assert_allclose(res.logits, ref.logits, rtol=1e-5,
                                 atol=1e-5)
      worst = max(worst, float(np.abs(res.logits - ref.logits).max()))
  # a wrong-width state: refused before the door drains
  drained0 = fe.admission.stats()['shed']['draining']
  events0 = len(recorder.events('serving.swap'))
  try:
    hot_swap(fe, params(2, hidden=128))
    raise AssertionError('a wrong-width state was accepted')
  except SwapValidationError:
    pass
  if (fe.admission.draining() or eng.model_version != 1
      or fe.admission.stats()['shed']['draining'] != drained0
      or len(recorder.events('serving.swap')) != events0):
    raise AssertionError('the validation refusal drained the door')
  # a candidate that fails the probe
  probe = np.unique(np.linspace(0, NUM_NODES - 1, 4).astype(np.int64))
  bad = params(3)
  gap = float(np.abs(eng.infer(probe, params=bad).logits
                     - eng.offline_reference(probe, params=bad).logits).max())
  if gap > 0:
    forced_by, atol = f'atol=0 (cross-bucket logits differ by {gap:.3e})', 0.0
  else:
    forced_by, atol = 'a NaN in layer2_self.bias (cross-bucket bitwise)', 1e-4
    bad['layer2_self.bias'][0] = float('nan')
  before = fe.infer(reqs[0])
  try:
    hot_swap(fe, bad, atol=atol)
    raise AssertionError('a candidate that fails the probe was installed')
  except SwapParityError as e:
    parity_err = e.max_err
  after = fe.infer(reqs[0])
  if (eng.model_version != 1 or fe.admission.draining()
      or after.logits.tobytes() != before.logits.tobytes()
      or after.nodes.tobytes() != before.nodes.tobytes()):
    raise AssertionError('the failed swap changed what is served')
  swaps = recorder.events('serving.swap')
  fe.shutdown()
  emit('swap', requests=len(reqs), clients=N_CLIENTS, wall_secs=wall,
       swapped_after_requests=swapped_after, version=out['version'],
       drained_ms=out['drained_ms'], parity_max_err=out['parity_max_err'],
       drain_retries=retries[0],
       served_by={'old': served_by[0], 'new': served_by[1]},
       offline_checked=16, offline_logits_max_abs_diff=worst,
       validation='SwapValidationError, door never drained',
       parity_failure={'error': 'SwapParityError', 'forced_by': forced_by,
                       'max_err': parity_err, 'version_after': 1,
                       'answer_bitwise_unchanged': True},
       swap_events=[{k: e.get(k) for k in ('ok', 'rolled_back', 'version',
                                           'drained_ms')} for e in swaps])
  return {'drained_ms': out['drained_ms'], 'forced_by': forced_by}


def tiered_replica(torch, name, indptr, indices, feats_h, state, made,
                   max_wait_ms=FLEET_MAX_WAIT_MS):
  """One fleet replica: its own tiered `Feature` at `FLEET_SPLIT` over
  the shared graph, ``TreeSAGE(100, 256, 47, 3)`` with ``state``, a
  warmed `ServingFrontend`; appended to ``made``."""
  from graphlearn_tpu_torch.models import TreeSAGE
  from graphlearn_tpu_torch.serving import (LocalReplica, ServingEngine,
                                            ServingFrontend)
  ds = tiered_dataset(torch, indptr, indices, feats_h, FLEET_SPLIT)
  eng = ServingEngine(ds, FANOUTS, model=TreeSAGE(FEAT_DIM, 256, 47, 3),
                      params=state, seed=0, buckets=BUCKETS, device=DEVICE)
  fe = ServingFrontend(eng, max_wait_ms=max_wait_ms,
                       default_deadline_ms=FLEET_DEADLINE_MS)
  rep = LocalReplica(name, fe)
  made.append(rep)
  return rep


def close_replicas(made) -> None:
  """Close each replica and free its tiered store's card and pinned
  host memory."""
  for rep in made:
    rep.close()
    rep.frontend.engine.data.node_features.close()


def fleet_kernel_checks(torch, ops, timer, eng, seeds, cold_last) -> dict:
  """K1 at the three hops and K2 at the hot gather of one 16-seed
  dispatch of ``eng``, and K6 at the drive's last dispatch with misses,
  each against its plain version (byte-equal) and timed."""
  import graphlearn_tpu_torch.loader.fused_tree as ftmod
  with TrainRecorder(torch, ftmod, 1) as rec:
    eng.infer(seeds)
  hops = []
  for t in range(len(FANOUTS)):
    _, r = check_sampler(torch, ops, timer, *rec.hops[t])
    emit('kernel', kernel='sample_one_hop', shape=f'fleet dispatch hop {t}',
         **r)
    hops.append(r)
  gather = check_gather(torch, ops, timer, *rec.gathers[0])
  emit('kernel', kernel='gather_rows', shape='fleet dispatch hot rows',
       **gather)
  cold = check_cold(torch, ops, timer, *cold_last)
  emit('kernel', kernel='cold_gather', shape='fleet dispatch misses', **cold)
  return {'hops': hops, 'gather': gather, 'cold': cold}


def fleet_phase(torch, ops, timer, indptr, indices, feats_h, state) -> dict:
  """`bench_serving.py --fleet 3` on the card: three tiered replicas
  behind a `FleetRouter`, a 5 s closed-loop lap for the fleet's rate,
  then 20 s of open-loop Zipf traffic at 0.7x that rate with r0 stalled
  0.12 s a dispatch and killed at its ``kill_nth`` submit.  Checks:
  every request ok or shed typed (0 failed), r0 evicted, redrives >= 1
  and none twice, post-kill rate >= 0.6x pre-kill, 32 sampled answers
  equal a survivor's `offline_reference`, 3 K1 and 1 K2 launches a
  dispatch summed over replicas, K6 on every dispatch with misses, no
  plain call.  As the bench drives it, every request is traced
  (1-in-10 head-sampled, anything slower than the SLO p99 kept) and a
  `FleetScraper` from `make_scraper`, attached to an `OpsServer`, is
  strictly parsed over HTTP ``/fleet`` all through the drive: at least
  one scrape, none failing, at least 2 replicas federated (gate 2); at
  least one slow-tail trace of 5 or more spans, one of them loaded from
  ``/trace?format=chrome`` (gate 3); ``fleet_headroom_qps`` present
  (gate 4)."""
  from graphlearn_tpu_torch.serving import FleetRouter
  from graphlearn_tpu_torch.telemetry import OpsServer, live, recorder, tracer
  from graphlearn_tpu_torch.testing import chaos
  made = []
  t0 = time.perf_counter()
  reps = [tiered_replica(torch, f'r{i}', indptr, indices, feats_h, state,
                         made) for i in range(FLEET_REPLICAS)]
  setup_secs = time.perf_counter() - t0
  router = FleetRouter(reps, heartbeat_ms=50.0, dead_after=2)
  trace_slow_ms = float(os.environ.get('GLT_SERVING_SLO_P99_MS', '')
                        or SLO_P99_MS)
  tracer.configure(sample=10, slow_ms=trace_slow_ms, buffer=None)
  scraper = router.make_scraper(registry=live)
  srv = OpsServer(port=0)
  srv.attach_fleet(scraper)
  lap_reqs = [s for _, s in fleet_schedule(1000.0, 2.0, seed=9)]
  lap = closed_lap(router.submit, lap_reqs, FLEET_LAP_CLIENTS, FLEET_LAP_S)
  rate = FLEET_LOAD * lap['requests_per_s']
  plan = fleet_schedule(rate, FLEET_DRIVE_S, seed=3)
  kill_t = FLEET_DRIVE_S / 2
  pre = sum(1 for a, _ in plan if a < kill_t)
  kill_nth = max(pre // FLEET_REPLICAS, 2)
  chaos.install({'faults': [
      {'site': 'serving.request', 'action': 'delay', 'op': 'dispatch',
       'replica': 'r0', 'nth': 1, 'count': 10 ** 6, 'secs': FLEET_STALL_S},
      {'site': 'serving.replica', 'action': 'kill', 'op': 'submit',
       'replica': 'r0', 'nth': kill_nth}]})
  recorder.clear()
  tracer.clear()
  d0 = [r.frontend.stats()['dispatches'] for r in reps]
  reset_tiered_counts(ops)
  fed, fed_stop = {}, threading.Event()
  watcher = threading.Thread(target=federation_watch,
                             args=(scraper, srv, fed_stop, fed), daemon=True)
  watcher.start()
  try:
    with ColdRecorder() as cold, SmiSampler() as smi:
      t_run = time.perf_counter()
      pending, t_sched, retries = pace(plan, router.submit)
      res = collect(pending, t_sched)
      run_s = time.perf_counter() - t_run
  finally:
    chaos.uninstall()
    fed_stop.set()
    watcher.join(10.0)
  launches, plain = read_tiered_counts(ops)
  d = sum(r.frontend.stats()['dispatches'] - a for r, a in zip(reps, d0))
  st = router.stats()
  failover = recorder.events('serving.failover')
  traced = fleet_trace_gates(tracer, srv, reps, fed)
  TELEMETRY['fleet'] = {k: traced[k] for k in (
      'fleet_scrapes', 'fleet_replicas_federated', 'traced_tail_count',
      'traced_tail_max_spans', 'fleet_headroom_qps')}
  scraper.close()
  srv.close()
  tracer.configure()
  router.close()
  if res['error'] or len(res['outcomes']) != len(plan):
    raise AssertionError(f'fleet: {res["error"]} failed of {len(plan)}, '
                         f'first {res["first_error"]}')
  redrives = sum(1 for e in failover if e.get('event') == 'redrive')
  exhausted = sum(1 for e in failover if e.get('event') == 'exhausted')
  if not (st['replicas']['r0']['state'] == 'dead' and st['evictions'] >= 1
          and st['redriven'] >= 1 and redrives == st['redriven']
          and exhausted == 0 and st['resolved']['error'] == 0):
    raise AssertionError(f'fleet failover: {st}, redrive events {redrives}, '
                         f'exhausted {exhausted}')
  pre_ok = sum(1 for t, o in res['outcomes'] if o == 'ok' and t < kill_t)
  post_ok = sum(1 for t, o in res['outcomes'] if o == 'ok' and t >= kill_t)
  pre_qps = pre_ok / kill_t
  post_qps = post_ok / (FLEET_DRIVE_S - kill_t)
  recovery = post_qps / max(pre_qps, 1e-9)
  if recovery < 0.6:
    raise AssertionError(f'fleet recovery {recovery:.3f} < 0.6 '
                         f'({pre_qps:.1f} -> {post_qps:.1f} requests/s)')
  with_misses = sum(1 for m in cold.misses if m)
  plans = sum(k6_expected_plans(m) for m in cold.misses)
  if not (launches['sample_one_hop'] == len(FANOUTS) * d
          and launches['gather_rows'] == d > 0
          and launches['cold_gather'] == with_misses > 0
          and launches['cold_gather_plans'] == plans and plain == 0):
    raise AssertionError(f'fleet launches {launches}, plain {plain}, '
                         f'dispatches {d}, with misses {with_misses}')
  survivor = reps[1].frontend.engine
  seeds_at = dict(plan)
  worst = 0.0
  oks = res['results']
  for j in np.linspace(0, len(oks) - 1, FLEET_CHECKED).astype(int):
    offset, got = oks[j]
    ref = survivor.offline_reference(seeds_at[offset])
    if ref.nodes.tobytes() != got.nodes.tobytes():
      raise AssertionError(f'fleet answer at {offset:.3f} s: nodes differ '
                           'from the offline reference')
    np.testing.assert_allclose(got.logits, ref.logits, rtol=1e-5, atol=1e-5)
    worst = max(worst, float(np.abs(got.logits - ref.logits).max()))
  kernels = fleet_kernel_checks(
      torch, ops, timer, survivor,
      np.concatenate([s for _, s in plan])[:BUCKETS[-1]], cold.last)
  close_replicas(made)
  lats = res['lats']
  around = {k: [lat for t, lat in res['timed'] if (t < kill_t) == (k == 'pre')]
            for k in ('pre', 'post')}
  emit('fleet', replicas=FLEET_REPLICAS, split_ratio=FLEET_SPLIT,
       setup_secs=setup_secs, lap=lap, rate_rps=rate, drive_secs=run_s,
       requests=len(plan), completed=res['ok'], shed=res['shed'],
       failed=res['error'], drain_retries=retries,
       latency_ms={'p50': nearest_rank(lats, 0.50),
                   'p99': nearest_rank(lats, 0.99),
                   'max': lats[-1] if lats else 0.0,
                   **{f'{k}_kill': {'p50': nearest_rank(v, 0.50),
                                       'p99': nearest_rank(v, 0.99)}
                      for k, v in around.items()}},
       kill_at_s=kill_t, kill_nth_submit=kill_nth, pre_kill_qps=pre_qps,
       post_kill_qps=post_qps, recovery_ratio=recovery,
       redriven=st['redriven'], evictions=st['evictions'],
       resolved=st['resolved'], dispatches=d,
       dispatches_with_misses=with_misses, launches=launches,
       plain_calls=plain, offline_checked=FLEET_CHECKED,
       logits_max_abs_diff=worst, device_idle=smi.result, **traced)
  TELEMETRY['serving'] = dict(TELEMETRY.get('serving', {}),
                              fleet_qps=res['ok'] / run_s,
                              failover_failed_requests=res['error'],
                              fleet_headroom_qps=traced[
                                  'fleet_headroom_qps'])
  return {'launches': launches, 'dispatches': d, 'kernels': kernels}


def fleet_trace_gates(tracer, srv, reps, fed) -> dict:
  """The fleet drive's tracing and federation figures, as
  `bench_serving.py` counts them, and its gates 2-4."""
  index = tracer.traces()
  tail = [t for t in index if (t.get('latency_ms') or 0.0) >= tracer.slow_ms]
  out = {'fleet_scrapes': fed.get('scrapes', 0),
         'fleet_parse_failures': fed.get('parse_failures', 0),
         'fleet_replicas_federated': fed.get('max_replicas_federated', 0),
         'fleet_scrape_errors': fed.get('errors', [])[:5],
         'fleet_route_ms': ms_summary(fed.get('fleet_ms', [])),
         'fleet_sweep_ms': ms_summary(fed.get('sweep_ms', [])),
         'traced_tail_count': len(tail),
         'traced_tail_max_spans': max((t['spans'] for t in tail), default=0),
         'trace_stats': tracer.stats()}
  headrooms = []
  for rep in reps:
    h = rep.frontend.stats().get('headroom_qps')
    if isinstance(h, (int, float)):
      headrooms.append(float(h))
  out['fleet_headroom_qps'] = sum(headrooms) if headrooms else None
  if (out['fleet_parse_failures'] or out['fleet_scrapes'] == 0
      or out['fleet_replicas_federated'] < 2):
    raise AssertionError(f'/fleet federation failed mid-traffic: {out}')
  if out['traced_tail_count'] < 1 or out['traced_tail_max_spans'] < 5:
    raise AssertionError(f'no slow-tail trace with >= 5 spans: {out}')
  if out['fleet_headroom_qps'] is None:
    raise AssertionError('no replica exported fleet.headroom_qps')
  deepest = max(tail, key=lambda t: t['spans'])
  _, body, ms = http_get(f'{srv.url}/trace?trace_id={deepest["trace_id"]}'
                         '&format=chrome')
  chrome = json.loads(body)
  slices = [e['name'] for e in chrome['traceEvents'] if e.get('ph') == 'X']
  if len(slices) < 5 or 'serving.route' not in slices:
    raise AssertionError(f'the chrome trace of {deepest}: {slices}')
  TELEMETRY.setdefault('scrape_ms', []).extend(fed.get('fleet_ms', []))
  out['chrome_trace'] = {'trace_id': deepest['trace_id'], 'ms': ms,
                         'slices': sorted(slices)}
  return out


def shrink_slo(rep, target_ms=None):
  """`bench_autoscale._shrink_slo`: the bench's SLO windows and budget
  (and, when given, the p99 target) on a replica's tracker."""
  slo = rep.frontend.slo
  slo.windows, slo.budget = AUTO_SLO_WINDOWS, AUTO_SLO_BUDGET
  slo._tripped = {w: False for w in AUTO_SLO_WINDOWS}
  if target_ms is not None:
    slo.p99_target_ms = target_ms
  return rep


def static_drive(plan, rep, faults=()) -> dict:
  """Phase A: ``plan`` against one fixed replica behind a `FleetRouter`,
  under the chaos ``faults`` (a list of fault dicts)."""
  from graphlearn_tpu_torch.serving import FleetRouter
  from graphlearn_tpu_torch.testing import chaos
  router = FleetRouter([rep], heartbeat_ms=40.0, dead_after=3)
  chaos.install({'faults': list(faults)})
  try:
    t_run = time.perf_counter()
    pending, t_s, _ = pace(plan, router.submit)
    out = collect(pending, t_s)
    out['drive_secs'] = time.perf_counter() - t_run
  finally:
    chaos.uninstall()
    router.close()
  return out


def elastic_drive(ops, plan, first, spawn_rep, faults=()) -> dict:
  """Phase B: ``plan`` against an `ElasticController` over 1 to
  `AUTO_MAX` replicas (``first``, then ``spawn_rep(name)``; the bench's
  thresholds) whose first spawn fails under ``scale.spawn:fail:1``, with
  the chaos ``faults`` besides; then up to `AUTO_GRACE_S` for the
  scale-in.  A watcher samples the controller's burn and replicas every
  50 ms.  Returns the collected requests, the decisions and samples, the
  spawned replicas and the tiered launches counted from the controller's
  start (warmups included).  To explain a burn: each sample keeps, by
  replica, its router state and its SLO windows' (requests,
  violations); each spawn its
  (start, end, name); each dispatch of the drive its (replica, start,
  seconds, requests, the oldest request's wait in ms at its start)."""
  from graphlearn_tpu_torch.serving import ElasticController, FleetRouter
  from graphlearn_tpu_torch.serving.frontend import ServingFrontend
  from graphlearn_tpu_torch.testing import chaos
  spawned, spawns, dispatches = [], [], []

  def spawn():
    t = time.monotonic()
    rep = spawn_rep(f'e{len(spawned) + 1}')
    spawns.append((t, time.monotonic(), rep.name))
    spawned.append(rep)
    return rep

  real_execute = ServingFrontend._execute

  def logged_execute(fe, run):
    t, wait = time.monotonic(), max(r.waited_ms() for r in run)
    n = real_execute(fe, run)
    dispatches.append((fe.name, t, time.monotonic() - t, len(run), wait))
    return n

  router = FleetRouter([first], heartbeat_ms=40.0, dead_after=3)
  chaos.install({'faults': [*faults, {'site': 'scale.spawn',
                                      'action': 'fail', 'nth': 1}]})
  reset_tiered_counts(ops)
  ctl = ElasticController(router, spawn, min_replicas=1,
                          max_replicas=AUTO_MAX, eval_s=0.12,
                          cooldown_s=(0.5, 1.5), out_burn=0.5, in_burn=0.15,
                          queue_ratio=0.15, quiesce_timeout_s=8.0)
  samples, stop = [], threading.Event()

  def watch():
    while not stop.is_set():
      sig = ctl.signals()
      per = {}
      for name, ent in router.heartbeats().items():
        wins = ((ent.get('serving') or {}).get('slo') or {}).get('windows')
        per[name] = (ent['state'], [(w['count'], w['violations'])
                                    for w in wins or ()])
      samples.append((time.monotonic(),
                      max(sig['short_burn'], sig['long_burn']),
                      sig['replicas'], per))
      stop.wait(0.05)

  watcher = threading.Thread(target=watch)
  watcher.start()
  ServingFrontend._execute = logged_execute
  try:
    with ColdRecorder() as cold:
      t_run = time.perf_counter()
      pending, t_s, retries = pace(plan, router.submit)
      out = collect(pending, t_s)
      out['drive_secs'] = time.perf_counter() - t_run
      out['t0'] = t_s
      grace = time.monotonic() + AUTO_GRACE_S
      while time.monotonic() < grace and not any(
          x['dir'] == 'in' and x['outcome'] == 'ok'
          for x in ctl.decisions()):
        time.sleep(0.1)
  finally:
    ServingFrontend._execute = real_execute
    stop.set()
    watcher.join()
    ctl.close()
    chaos.uninstall()
  out['launches'], out['plain'] = read_tiered_counts(ops)
  out['with_misses'] = sum(1 for m in cold.misses if m)
  out.update(decisions=ctl.decisions(), samples=samples, spawned=spawned,
             spawns=spawns, dispatch_log=dispatches, drain_retries=retries,
             dispatches=sum(r.frontend.stats()['dispatches']
                            for r in [first, *spawned]),
             pins=[r.frontend.engine.compile_count() for r in spawned])
  router.close()
  return out


def check_elastic(el: dict, hops: int, warm_per_replica: int,
                  target_ms: float) -> dict:
  """The checks both arms hold: >= 1 scale-out and >= 1 scale-in, the
  failed spawn rolled back typed with capacity landing on a later
  evaluation, every spawned replica at ``compile_count() == 0``, ``hops``
  K1 and 1 K2 launches a dispatch (warmups included), K6 on every
  dispatch with misses, no plain call.  Returns the burn outside the
  incident windows (`bench_autoscale.incident_windows`), the decision
  counts and, to explain a burn, the worst sample's windows by replica,
  every request outside the incident windows that violated the
  ``target_ms`` p99 target or was shed (its plan offset, latency), the
  spawns' times, the replica count's and router states' changes, the
  dispatches' milliseconds and,
  for a burn, the burning replica's dispatches over the 1.5 s before
  it."""
  decisions = el['decisions']
  outs = [x for x in decisions if x['dir'] == 'out']
  ins_ok = sum(1 for x in decisions
               if x['dir'] == 'in' and x['outcome'] == 'ok')
  first_rb = next((i for i, x in enumerate(outs)
                   if x['outcome'] == 'rolled_back'), None)
  landed = first_rb is not None and any(
      x['outcome'] == 'ok' for x in outs[first_rb + 1:])
  if not (sum(1 for x in outs if x['outcome'] == 'ok') >= 1 and ins_ok >= 1
          and landed and 'InjectedFault' in (outs[first_rb]['error'] or '')):
    raise AssertionError(f'autoscale decisions: {decisions}')
  if any(el['pins']):
    raise AssertionError(f'a spawned replica compiled: {el["pins"]}')
  d, warm = el['dispatches'], warm_per_replica * len(el['spawned'])
  launches = el['launches']
  if not (launches['sample_one_hop'] == hops * (d + warm)
          and launches['gather_rows'] == d + warm
          and launches['cold_gather'] == el['with_misses']
          and el['plain'] == 0):
    raise AssertionError(f'autoscale launches {launches}, plain '
                         f'{el["plain"]}, dispatches {d} + warmups {warm}')
  w = AUTO_SLO_WINDOWS[0]
  spans = []
  for i, x in enumerate(outs):
    if x['outcome'] == 'rolled_back':
      end = next((y['at'] + w for y in outs[i + 1:] if y['outcome'] == 'ok'),
                 x['at'] + 3.0)
      spans.append((x['at'] - w, end + w))

  def incident(t):
    return any(a <= t <= z for a, z in spans)
  outside = [(b, t, per) for t, b, _, per in el['samples'] if not incident(t)]
  worst = max(outside, default=(0.0, el['t0'], {}), key=lambda x: x[0])
  # by time alone: a latency and an outcome kind at one offset do not
  # compare
  slow = sorted([(round(o, 3), round(lat, 1)) for o, lat in el['timed']
                 if lat > target_ms and not incident(el['t0'] + o)]
                + [(round(o, 3), kind) for o, kind in el['outcomes']
                   if kind != 'ok' and not incident(el['t0'] + o)],
                key=lambda v: v[0])
  outcomes = {}
  for x in decisions:
    key = f"{x['dir']}:{x['outcome']}"
    outcomes[key] = outcomes.get(key, 0) + 1
  t0 = el['t0']
  reps = [r for _, _, r, _ in el['samples']]
  changes = [(round(t - t0, 3), r) for i, (t, _, r, _) in
             enumerate(el['samples']) if i == 0 or r != reps[i - 1]]
  states, last = [], None
  for t, _, _, per in el['samples']:
    now = {name: st for name, (st, _) in per.items()}
    if now != last:
      states.append((round(t - t0, 3), now))
      last = now
  log = el['dispatch_log']
  durs = [1e3 * secs for _, _, secs, _, _ in log]
  burning = max(((name, max((v for _, v in wins), default=0))
                 for name, (_, wins) in worst[2].items()),
                key=lambda kv: kv[1], default=(None, 0))[0] \
      if worst[0] > 0 else None
  before = [(round(t - t0, 3), round(1e3 * secs, 1), n, round(wait, 1))
            for name, t, secs, n, wait in log
            if name == burning and worst[1] - 1.5 <= t <= worst[1]]
  return {'burn_max_outside_incident': worst[0],
          'burn_max_at_s': worst[1] - el['t0'],
          'burn_max_windows_by_replica': worst[2],
          'violations_outside_incident_at_s': slow,
          'spawns_at_s': [(round(a - t0, 3), round(z - t0, 3), name)
                          for a, z, name in el['spawns']],
          'replicas_at_s': changes, 'router_states_at_s': states,
          'dispatch_ms': {'count': len(durs),
                          'p50': nearest_rank(durs, 0.50),
                          'p99': nearest_rank(durs, 0.99),
                          'max': max(durs, default=0.0)},
          'burning_replica': burning,
          'burning_replica_dispatches_before': before,
          'incident_windows': len(spans), 'decision_outcomes': outcomes,
          'decisions_at_s': [(x['dir'], x['outcome'], x['at'] - el['t0'])
                             for x in decisions
                             if not x['outcome'].startswith('held')],
          'scale_outs': sum(1 for x in outs if x['outcome'] == 'ok'),
          'scale_ins': ins_ok,
          'rolled_back': sum(1 for x in decisions
                             if x['outcome'] == 'rolled_back'),
          'replicas_min': min(reps), 'replicas_max': max(reps),
          'spawned': len(el['spawned']),
          'spawned_compile_counts': el['pins'], 'dispatches': d,
          'warmup_dispatches': warm, 'launches': launches,
          'plain_calls': el['plain']}


def drive_summary(r: dict) -> dict:
  return {'ok': r['ok'], 'shed': r['shed'], 'error': r['error'],
          'drive_secs': r['drive_secs'],
          'p50_ms': nearest_rank(r['lats'], 0.50),
          'p99_ms': nearest_rank(r['lats'], 0.99)}


def autoscale_phase(torch, ops, indptr, indices, feats_h, state) -> dict:
  """`bench_autoscale.py`'s phases A and B on the card, in two arms.

  The bench's own arm (`autoscale_bench_arm`) holds every gate the bench
  exits 1 on.  The products arm below is measured only for its p99s and
  its burn: one tiered products replica's closed-loop rate and its p50
  at the trough rate set the diurnal schedule (trough 0.15x -> peak 1.3x
  -> trough over `AUTO_CYCLE_S`) and the p99 target (2x that p50; SLO
  windows 1 s and 3 s, budget 0.1), with no injected dispatch delay, so
  the card's own capacity sets the load.  A: one static replica.  B: an
  `ElasticController` (1-3 replicas, the bench's thresholds) whose first
  spawn fails under ``scale.spawn:fail:1``.  Checks: `check_elastic` and
  0 failed requests (drain sheds resubmitted after their hint)."""
  bench = autoscale_bench_arm(torch, ops)
  made = []

  def replica(name, target_ms):
    return shrink_slo(tiered_replica(torch, name, indptr, indices, feats_h,
                                     state, made,
                                     max_wait_ms=AUTO_MAX_WAIT_MS),
                      target_ms)

  cal = replica('cal', 0.0)
  lap = closed_lap(cal.frontend.submit,
                   [s for _, s in fleet_schedule(1000.0, 2.0, seed=11)],
                   AUTO_LAP_CLIENTS, AUTO_LAP_S)
  cap = lap['requests_per_s']
  pending, t_s, _ = pace(fleet_schedule(AUTO_TROUGH * cap, AUTO_TROUGH_S,
                                        seed=12), cal.frontend.submit)
  trough = collect(pending, t_s)
  target_ms = 2.0 * nearest_rank(trough['lats'], 0.50)
  close_replicas(made)
  made.clear()
  plan = fleet_schedule(None, AUTO_CYCLE_S, seed=13, peak=AUTO_PEAK * cap,
                        trough=AUTO_TROUGH * cap)
  static = static_drive(plan, replica('s0', target_ms))
  close_replicas(made)
  made.clear()
  elastic = elastic_drive(ops, plan, replica('e0', target_ms),
                          lambda name: replica(name, target_ms))
  close_replicas(made)
  if static['error'] or elastic['error']:
    raise AssertionError(f'autoscale failed requests: static '
                         f'{static["error"]}, elastic {elastic["error"]} '
                         f'({elastic["first_error"] or static["first_error"]})')
  checked = check_elastic(elastic, len(FANOUTS), len(BUCKETS), target_ms)
  emit('autoscale', arm='products, undelayed (measured)', capacity_lap=lap,
       trough_p50_ms=nearest_rank(trough['lats'], 0.50),
       p99_target_ms=target_ms,
       peak_rps=AUTO_PEAK * cap, trough_rps=AUTO_TROUGH * cap,
       cycle_secs=AUTO_CYCLE_S, requests=len(plan),
       static=drive_summary(static),
       elastic={**drive_summary(elastic),
                'drain_retries': elastic['drain_retries']},
       p99_held_ms={'static': nearest_rank(static['lats'], 0.99),
                    'elastic': nearest_rank(elastic['lats'], 0.99)},
       bench_gates_missed=bench_gate_misses(static, elastic, checked),
       **checked)
  return {'launches': checked['launches'], 'bench': bench}


#: the bench gate the port does not hold: the shared controller's scale-in
#: rule retires a replica at the peak in about a third of the runs on the
#: H100 (PERF.md §7, ROADMAP Queue 3); reported, not raised
BURN_MISS = 'burn >= 1.0 outside the incident window'


def bench_gate_misses(static: dict, elastic: dict, checked: dict) -> list:
  """`bench_autoscale.main`'s acceptance (`:424-444`) over a drive pair:
  the gates missed, by name (empty when every gate held)."""
  miss = []
  if elastic['ok'] == 0:
    miss.append('elastic drive served no requests')
  if static['error'] or elastic['error']:
    miss.append('failed requests')
  if checked['scale_outs'] < 1 or checked['scale_ins'] < 1:
    miss.append('fleet did not track the load')
  if checked['rolled_back'] < 1:
    miss.append('the chaos spawn fault never rolled back')
  if checked['burn_max_outside_incident'] >= 1.0:
    miss.append(BURN_MISS)
  p99_s = nearest_rank(static['lats'], 0.99)
  if p99_s > 0 and nearest_rank(elastic['lats'], 0.99) > p99_s * 1.05 + 5.0:
    miss.append('elastic p99 did not hold vs the static baseline')
  return miss


def bench_replica(torch, name, made):
  """`bench_autoscale.make_replica` on the card: its own
  `bench_serving.build_dataset(20000, 32, split_ratio=0.5)` (the same
  seed fleet-wide: degree 8, uniform columns, uniform f32 features), a
  model-less engine at fanouts [5, 3] (seed 11), an 8 ms coalescing
  window, 2,000 ms deadlines and the bench's SLO windows; appended to
  ``made``."""
  from graphlearn_tpu_torch.data import Dataset
  from graphlearn_tpu_torch.serving import (LocalReplica, ServingEngine,
                                            ServingFrontend)
  rng = np.random.default_rng(0)
  rows = np.repeat(np.arange(AB_NODES), 8)
  cols = rng.integers(0, AB_NODES, rows.shape[0])
  feats = rng.random((AB_NODES, AB_DIM), dtype=np.float32)
  ds = (Dataset().init_graph((rows, cols), layout='COO', num_nodes=AB_NODES,
                             device=DEVICE)
        .init_node_features(feats, split_ratio=AB_SPLIT, device=DEVICE))
  ds.node_features.lazy_init()
  eng = ServingEngine(ds, AB_FANOUTS, seed=11, device=DEVICE)
  fe = ServingFrontend(eng, max_wait_ms=AUTO_MAX_WAIT_MS,
                       default_deadline_ms=FLEET_DEADLINE_MS)
  rep = shrink_slo(LocalReplica(name, fe))
  made.append(rep)
  return rep


def autoscale_bench_arm(torch, ops) -> dict:
  """`bench_autoscale.py`'s phases A and B as that file defines them,
  on the card: its replica (`bench_replica`), its knobs (`AB_ENV`: an
  8-seed bucket ladder, a 64-request queue, a 500 ms p99 target, the
  QPS target at half the peak), its diurnal plan (peak 160 req/s, trough
  20, one 9 s cycle, seed 5) and its 50 ms ``serving.request`` delay on
  every dispatch of both drives, which caps one replica near 86 req/s so
  the peak needs two.  Holds every gate the bench exits 1 on
  (`bench_gate_misses`), besides `check_elastic`, but `BURN_MISS`, which
  the line reports.  Returns the launches and the gates missed."""
  saved = {k: os.environ.get(k) for k, _ in AB_ENV}
  os.environ.update(dict(AB_ENV))
  delay = {'site': 'serving.request', 'action': 'delay', 'op': 'dispatch',
           'nth': 1, 'count': 10**9, 'secs': AB_DELAY_S}
  made = []
  try:
    plan = fleet_schedule(None, AB_CYCLE_S, seed=AB_SEED, peak=AB_PEAK,
                          trough=AB_TROUGH, n=AB_NODES)
    static = static_drive(plan, bench_replica(torch, 's0', made), [delay])
    close_replicas(made)
    made.clear()
    elastic = elastic_drive(ops, plan, bench_replica(torch, 'e0', made),
                            lambda name: bench_replica(torch, name, made),
                            [delay])
  finally:
    close_replicas(made)
    for k, v in saved.items():
      if v is None:
        os.environ.pop(k, None)
      else:
        os.environ[k] = v
  checked = check_elastic(elastic, len(AB_FANOUTS), 1,
                          float(dict(AB_ENV)['GLT_SERVING_SLO_P99_MS']))
  misses = bench_gate_misses(static, elastic, checked)
  emit('autoscale', arm='bench_autoscale.py (50 ms dispatch delay)',
       knobs=dict(AB_ENV), peak_rps=AB_PEAK, trough_rps=AB_TROUGH,
       cycle_secs=AB_CYCLE_S, requests=len(plan),
       static=drive_summary(static),
       elastic={**drive_summary(elastic),
                'drain_retries': elastic['drain_retries']},
       p99_held_ms={'static': nearest_rank(static['lats'], 0.99),
                    'elastic': nearest_rank(elastic['lats'], 0.99)},
       bench_gates_missed=misses, reported_not_held=[BURN_MISS], **checked)
  held = [m for m in misses if m != BURN_MISS]
  if held:
    raise AssertionError(f'bench_autoscale gates missed: {held}')
  return {'launches': checked['launches'], 'misses': misses}


def autoscale_bench_repeats(torch, ops, n: int) -> None:
  """``--autoscale-bench N``: `autoscale_bench_arm` alone, ``N`` times
  (each raises on a gate it holds), and one line of the gates missed in
  each repeat: how often `BURN_MISS` comes up on this card and host."""
  runs = [autoscale_bench_arm(torch, ops)['misses'] for _ in range(n)]
  emit('autoscale_bench_repeats', runs=n,
       missed=sum(1 for r in runs if r), misses_by_run=runs)


def aot_digests(torch, ops) -> list:
  """K1 and K2 on one fixed input (`arm_graph` at k 10, draws and a
  table from seeds): the digests of their outputs."""
  from graphlearn_tpu_torch.ops import default_window
  k, w = 10, default_window(10)
  indptr, indices, seeds = arm_graph(torch, DEVICE, k, w)
  gen = torch.Generator(device=DEVICE).manual_seed(7)
  u = torch.rand(seeds.numel(), k, device=DEVICE, generator=gen)
  g = torch.rand(seeds.numel(), w, device=DEVICE, generator=gen)
  res = ops.sample_one_hop_fused(indptr, indices, seeds, k, u, g)
  table = torch.randn(4096, FEAT_DIM, device=DEVICE, generator=gen)
  ids = torch.randint(-1, 4096, (70_001,), device=DEVICE, generator=gen,
                      dtype=torch.int32)
  rows = ops.gather_rows(table, ids)
  return [int(v) for v in digest(torch, [res.nbrs, res.mask.to(torch.int32),
                                         rows]).tolist()]


def aot_child(build_dir: str) -> int:
  """``--aot-child DIR``: a fresh process that builds or restores every
  kernel into ``DIR`` (through ``GLT_AOT_CACHE_DIR``), runs
  `aot_digests` and prints one JSON line."""
  from pathlib import Path

  import torch
  from graphlearn_tpu_torch import _build, ops
  from graphlearn_tpu_torch.serving import aot_cache
  _build.BUILD_DIR = Path(build_dir)
  t0 = time.perf_counter()
  info = _build.build_all()
  secs = time.perf_counter() - t0
  print(json.dumps({'nvcc_runs': _build.NVCC_RUNS, 'build_secs': secs,
                    'sources': {k: v['source'] for k, v in info.items()},
                    'digests': aot_digests(torch, ops),
                    'entries': len(aot_cache.from_env().entries())}),
        flush=True)
  return 0


def aot_phase(torch, ops) -> dict:
  """The kernel-build cache across processes: a child with an empty
  build directory and an empty ``GLT_AOT_CACHE_DIR`` runs 7 ``nvcc`` and
  publishes 7 entries; a second child with another empty build directory
  and the same cache runs none and restores 7; both give K1 and K2
  digests equal to this process's.  Then one entry's payload is
  scrambled: a build of that kernel here into a third directory misses
  with reason ``corrupt``, runs ``nvcc`` once and loads."""
  import ctypes
  import tempfile
  from graphlearn_tpu_torch import _build
  from graphlearn_tpu_torch.serving import AotExecutableCache
  from graphlearn_tpu_torch.telemetry import recorder
  want = aot_digests(torch, ops)
  n = len(_build.SOURCES)
  with tempfile.TemporaryDirectory(prefix='glt-aot-') as tmp:
    cache_dir = os.path.join(tmp, 'cache')
    env = dict(os.environ, GLT_AOT_CACHE_DIR=cache_dir)
    kids = []
    for b in ('b1', 'b2'):
      t0 = time.perf_counter()
      run = subprocess.run([sys.executable, os.path.abspath(__file__),
                            '--aot-child', os.path.join(tmp, b)], env=env,
                           capture_output=True, text=True, timeout=300)
      if run.returncode != 0:
        raise AssertionError(f'aot child {b} exit {run.returncode}: '
                             f'{run.stderr[-2000:]}')
      kid = json.loads(run.stdout.strip().splitlines()[-1])
      kid['process_secs'] = time.perf_counter() - t0
      kids.append(kid)
    cold_kid, warm_kid = kids
    if not (cold_kid['nvcc_runs'] == n and cold_kid['entries'] == n
            and set(cold_kid['sources'].values()) == {'built'}
            and warm_kid['nvcc_runs'] == 0
            and set(warm_kid['sources'].values()) == {'restored'}
            and cold_kid['digests'] == warm_kid['digests'] == want):
      raise AssertionError(f'aot children {kids}, parent digests {want}')
    cache = AotExecutableCache(cache_dir)
    entry = cache.path(_build.fingerprint(AOT_CORRUPT))
    blob = bytearray(entry.read_bytes())
    blob[-64:] = bytes(b ^ 0xFF for b in blob[-64:])
    entry.write_bytes(bytes(blob))
    recorder.clear()
    runs0 = _build.NVCC_RUNS
    t0 = time.perf_counter()
    info = _build.build_all([AOT_CORRUPT], build_dir=os.path.join(tmp, 'b3'),
                            aot_cache=cache)[AOT_CORRUPT]
    rebuild_secs = time.perf_counter() - t0
    reasons = [e['reason'] for e in recorder.events('aot.cache_miss')]
    ctypes.CDLL(info['path'])
    if not (info['source'] == 'built' and _build.NVCC_RUNS - runs0 == 1
            and reasons == ['corrupt']
            and cache.load(_build.fingerprint(AOT_CORRUPT)) is not None):
      raise AssertionError(f'corrupt entry: {info}, misses {reasons}')
    entry_bytes = sum(os.path.getsize(os.path.join(cache_dir, f))
                      for f in cache.entries())
  emit('aot', kernels=n, build_secs=cold_kid['build_secs'],
       restore_secs=warm_kid['build_secs'],
       process_secs={'build': cold_kid['process_secs'],
                     'restore': warm_kid['process_secs']},
       nvcc_runs={'build': cold_kid['nvcc_runs'],
                  'restore': warm_kid['nvcc_runs']},
       entries=cold_kid['entries'], entry_bytes=entry_bytes,
       digests_equal=True, corrupt={'kernel': AOT_CORRUPT,
                                    'miss_reasons': reasons,
                                    'rebuild_secs': rebuild_secs})
  return {'build_secs': cold_kid['build_secs'],
          'restore_secs': warm_kid['build_secs']}


def fleet_group(torch, ops, timer, indptr, indices, feats) -> dict:
  """The rest of serving on the card: `swap_phase`, `fleet_phase`,
  `autoscale_phase`, `aot_phase`; one ``fleet_group`` line with the
  group's wall time."""
  from graphlearn_tpu_torch.telemetry import recorder
  t0 = time.perf_counter()
  recorder.enable()
  state = fleet_state(torch)
  out = {'swap': swap_phase(torch, indptr, indices, feats, state)}
  feats_h = feats.cpu()
  out['fleet'] = fleet_phase(torch, ops, timer, indptr, indices, feats_h,
                             state)
  out['autoscale'] = autoscale_phase(torch, ops, indptr, indices, feats_h,
                                     state)
  del feats_h
  out['aot'] = aot_phase(torch, ops)
  recorder.disable()
  recorder.clear()
  emit('fleet_group', wall_secs=time.perf_counter() - t0)
  return out


def fleet_kernels(fg: dict) -> list:
  """The ``kernels`` entries of ``--fleet`` alone: K1, K2 and K6 at the
  fleet dispatch's shapes, launches from the fleet drive."""
  k, lf = fg['fleet']['kernels'], fg['fleet']['launches']
  hops, g, c = k['hops'], k['gather'], k['cold']
  by_path = {'fleet': lf, 'autoscale': fg['autoscale']['launches'],
             'autoscale_bench': fg['autoscale']['bench']['launches']}
  return [
      {'name': 'sample_one_hop', 'route': 'cuda',
       'source': 'graphlearn_tpu_torch/csrc/sample_one_hop.cu',
       'replaces': 'graphlearn_tpu/ops/pallas_sample.py:247',
       'launches': lf['sample_one_hop'],
       'max_abs_err': max(h['max_abs_err'] for h in hops),
       'ms': sum(h['kernel_ms'] for h in hops),
       'plain_ms': sum(h['plain_ms'] for h in hops),
       'bound_ms': sum(h['bound_us'] for h in hops) / 1e3,
       'bound_by': 'bytes', 'library_ms': None, 'byte_equal': True,
       'shape': 'fleet dispatch, hops of '
                + '/'.join(str(h['rows']) for h in hops) + ' rows, k 15/10/5',
       'launches_by_path': {p: v['sample_one_hop']
                            for p, v in by_path.items()}},
      {'name': 'gather_rows', 'route': 'cuda',
       'source': 'graphlearn_tpu_torch/csrc/gather_rows.cu',
       'replaces': 'graphlearn_tpu/ops/pallas_gather.py:152',
       'launches': lf['gather_rows'], 'max_abs_err': g['max_abs_err'],
       'ms': g['kernel_ms'], 'plain_ms': g['plain_ms'],
       'bound_ms': g['bound_us'] / 1e3, 'bound_by': 'bytes',
       'library_ms': g['library_ms'], 'byte_equal': True,
       'shape': f'fleet dispatch hot rows: {g["ids"]} ids x '
                f'{g["row_bytes"]} B {g["dtype"]}',
       'launches_by_path': {p: v['gather_rows'] for p, v in by_path.items()}},
      {'name': 'cold_gather', 'route': 'cuda',
       'source': 'graphlearn_tpu_torch/csrc/cold_gather.cu',
       'replaces': 'graphlearn_tpu/data/cold_cache.py:507',
       'launches': lf['cold_gather'], 'max_abs_err': c['max_abs_err'],
       'ms': c['kernel_ms'], 'plain_ms': c['plain_ms'],
       'bound_ms': c['bound_ms'], 'bound_by': 'bytes',
       'library_ms': c['library_ms'], 'byte_equal': True,
       'shape': f'{c["rows"]} miss rows x {c["row_bytes"]} B of a fleet '
                'dispatch (pinned host -> card)',
       'launches_by_path': {p: v['cold_gather'] for p, v in by_path.items()}},
  ]


# -- partition failover and planned handoff (the mesh's PartitionBook) -------
FO_BATCHES = 10                     # bench_dist_loader.failover_smoke's epoch
FO_GNS_BATCHES = 8                  # the tiered GNS arm's epoch (depth cut)
FO_HANDOFF = (3, 5, 3)              # bench_autoscale phase C: range, to, after


def fresh_view(ds):
  """A new `DistDataset` over ``ds``'s shards (no copy): its own
  `PartitionBook`, parked payloads and degraded set, so each arm starts
  at the identity book on one store."""
  from graphlearn_tpu_torch.parallel import DistDataset
  return DistDataset(ds.graph, ds.node_features, ds.node_labels, ds.old2new,
                     device=ds.device, edge_features=ds.edge_features)


def durable_dir(ds) -> tuple:
  """A fresh directory for ``ds``'s durable copy and the bytes the copy
  needs (each partition's CSR, features, labels and host-tier rows);
  raises when the disk lacks room for it."""
  import shutil
  import tempfile
  g, nf = ds.graph, ds.node_features
  need = sum(t.numel() * t.element_size() for t in (
      g.indptr, g.indices, g.edge_ids, nf.shards, ds.node_labels))
  if nf.cold_host is not None:
    need += nf.cold_host.numel() * nf.cold_host.element_size()
  d = tempfile.mkdtemp(prefix='glt_failover_')
  free = shutil.disk_usage(d).free
  if free < 1.2 * need:
    shutil.rmtree(d, ignore_errors=True)
    raise AssertionError(f'the durable copy needs {need} bytes, the disk '
                         f'under {d} has {free} free')
  return d, need


class EnvKnobs:
  """Environment knobs set for a block (the named ones cleared first),
  all restored after."""

  def __init__(self, clear=(), **knobs):
    self.clear, self.knobs = tuple(clear) + tuple(knobs), knobs

  def __enter__(self):
    self.saved = {k: os.environ.pop(k, None) for k in self.clear}
    os.environ.update(self.knobs)
    return self

  def __exit__(self, *exc):
    for k, v in self.saved.items():
      os.environ.pop(k, None)
      if v is not None:
        os.environ[k] = v


def card_bytes(torch) -> int:
  return torch.cuda.memory_allocated() if DEVICE == 'cuda' else 0


def counted_epoch(torch, ops, it, per_batch: dict, digest_fn, record_at=None,
                  recorder_kw=None, between=None, parts=MESH_PARTS):
  """Iterate a mesh loader's epoch: each batch's digest, the launches
  over the whole epoch counted and checked against ``per_batch`` (kernel
  -> launches a batch) times the batches, no plain call, and, in the
  ``record_at``-th ``next`` call, the dispatch's kernel inputs kept
  (`PathRecorder` with ``recorder_kw``).  ``between`` (``(n, fn)``)
  calls ``fn()`` after the ``n``-th batch, inside the counted epoch.
  Returns ``(digests [B, k], seconds, recorder, card bytes allocated at
  the epoch's start, the launches counted)``."""
  import graphlearn_tpu_torch.parallel.dist_sampler as dsm
  out, rec = [], None
  reset_counts(ops)
  sync(torch)
  start_bytes = card_bytes(torch)
  t0 = time.perf_counter()
  while True:
    if between is not None and len(out) == between[0]:
      between[1]()
    try:
      if len(out) == record_at:
        with PathRecorder(torch, dsm, parts=parts, first=True,
                          **(recorder_kw or {})) as rec:
          b = next(it)
      else:
        b = next(it)
    except StopIteration:
      break
    out.append(digest_fn(b))
  sync(torch)
  secs = time.perf_counter() - t0
  launches, plain = read_counts(ops)
  want = {k: v * len(out) for k, v in per_batch.items()}
  if {k: launches[k] for k in want} != want or plain:
    raise AssertionError(f'{len(out)} batches: launches {launches}, plain '
                         f'{plain}, want {want}')
  return torch.stack(out).cpu(), secs, rec, start_bytes, {
      k: launches[k] for k in want}


def check_adopted_lane(rec, sampler, ds, victim, tables) -> dict:
  """The recorded dispatch's calls for range ``victim`` read the lane the
  adoption put on the card (its CSR, and the ``tables`` of its row
  gathers), not the dead owner's shard; returns the lane's bytes."""
  lanes = sampler._book_lanes
  if lanes is None:
    raise AssertionError('the recorded dispatch ran the identity book')
  calls, gathers = rec.sample_calls(), rec.gather_calls_in_order()
  for t in range(rec.hops):
    indptr = calls[t * MESH_PARTS + victim][0]
    if not (indptr.data_ptr() == lanes.get('indptr', victim).data_ptr()
            != ds.graph.indptr[victim].data_ptr()):
      raise AssertionError(f'hop {t}: range {victim} did not read its lane')
  for t, key in enumerate(tables):
    table = gathers[t * MESH_PARTS + victim][0]
    if table.data_ptr() != lanes.get(key, victim).data_ptr():
      raise AssertionError(f'{key}: range {victim} did not read its lane')
  lane = {k: v for k, v in lanes._adopted[victim].items()}
  return {'lane_bytes': sum(v.numel() * v.element_size()
                            for v in lane.values()),
          'lane_fields': sorted(lane)}


def mesh_digest(torch, gns=False):
  def fn(b):
    ts = [b.node, b.x, b.y, b.edge_index]
    if gns:
      ts.append(b.metadata['edge_weight'])
    return digest(torch, ts)
  return fn


def failover_arm(torch, ops, timer, ds) -> dict:
  """`bench.py`'s failover row (`bench_dist_loader.failover_smoke`) at
  products scale: the untiered store at P = 8, `DistNeighborLoader([15,
  10, 5], batch_size=512, shuffle=True, seed=0)` over 512 x 8 x 10 seeds
  of the seeded permutation.  A fault-free loader's epoch 1 gives the
  reference digests (node, x, y, edge_index) and its epoch 2 the
  fault-free seconds; then ``GLT_SHARD_DIR`` names a fresh directory (the
  next loader writes the durable copy) and ``partition.owner:kill:5:
  partition=4`` (the bench's ``max(2, n // 2)`` and ``P // 2``) kills an
  owner mid-epoch.  The bench's gates: ``completed_ratio`` 1.0, every
  batch digest-equal, exactly one executed adoption, book version 1,
  ``recovery_secs`` > 0; besides, 24 K1 and 16 K2 launches every batch
  and no plain call, and the adopted dispatch's calls (the adopted lane's
  included, which must read the lane put on the card) byte-equal to the
  plain versions."""
  import shutil
  from graphlearn_tpu_torch.parallel import DistNeighborLoader
  from graphlearn_tpu_torch.telemetry import recorder
  from graphlearn_tpu_torch.testing import chaos
  seeds = np.random.default_rng(0).permutation(NUM_NODES)[
      :MESH_BATCH * MESH_PARTS * FO_BATCHES]
  per_batch = {'sample_one_hop': len(FANOUTS) * MESH_PARTS,
               'gather_rows': 2 * MESH_PARTS, 'sample_one_hop_gns': 0}
  dig = mesh_digest(torch)

  def make(d):
    return DistNeighborLoader(d, FANOUTS, seeds, batch_size=MESH_BATCH,
                              shuffle=True, seed=0, device=DEVICE)

  ref_loader = make(fresh_view(ds))
  ref = counted_epoch(torch, ops, iter(ref_loader), per_batch, dig)[0]
  fault_free_secs = counted_epoch(torch, ops, iter(ref_loader), per_batch,
                                  dig)[1]
  del ref_loader
  n = len(ref)
  kill_step, victim = max(2, n // 2), MESH_PARTS // 2
  shard_dir, need = durable_dir(ds)
  try:
    with EnvKnobs(clear=('GLT_DEGRADED_OK',), GLT_SHARD_DIR=shard_dir):
      ds_f = fresh_view(ds)
      sync(torch)
      t0 = time.perf_counter()
      loader = make(ds_f)             # writes the load-time durable copy
      write_secs = time.perf_counter() - t0
      store_bytes = dir_bytes(shard_dir)
      disk = shutil.disk_usage(shard_dir)
      recorder.enable()
      recorder.clear()
      chaos.install(f'partition.owner:kill:{kill_step}:partition={victim}')
      try:
        got, failover_secs, rec, before, launches = counted_epoch(
            torch, ops, iter(loader), per_batch, dig,
            record_at=kill_step - 1, recorder_kw={'gns': False})
        adopts = recorder.events('partition.adopt')
        lost = recorder.events('peer.lost')
      finally:
        chaos.uninstall()
        recorder.disable()
        recorder.clear()
  finally:
    shutil.rmtree(shard_dir, ignore_errors=True)
  executed = [e for e in adopts if e.get('phase') is None]
  recovered = [e for e in adopts if e.get('phase') == 'recovered']
  recovery_secs = recovered[0]['secs'] if recovered else None
  book = ds_f.partition_book
  completed_ratio = len(got) / max(n, 1)
  same = [bool(torch.equal(a, b)) for a, b in zip(ref, got)]
  ok = (completed_ratio == 1.0 and all(same) and len(executed) == 1
        and book.version == 1 and recovery_secs is not None
        and recovery_secs > 0)
  if not ok:
    raise AssertionError(
        f'failover: completed {completed_ratio}, digest-equal {same}, '
        f'adoptions {executed}, book {book.version}, recovery '
        f'{recovery_secs}')
  lane = check_adopted_lane(rec, loader.sampler, ds_f, victim,
                            ('fshard', 'lshard'))
  path = check_mesh_path(torch, ops, timer, rec, 'failover adopted dispatch',
                         tables=('features', 'labels'))
  del rec
  mem = {'epoch_start': before, 'epoch_end': card_bytes(torch)}
  del loader, ds_f
  out = dict(
      parts=MESH_PARTS, batch=MESH_BATCH, fanouts=list(FANOUTS),
      expected_batches=n, received_batches=len(got),
      completed_ratio=completed_ratio, byte_identical=True,
      adoptions_total=len(executed), book_version=book.version,
      adoptions=book.adoptions(), killed_partition=victim,
      kill_step=kill_step, recovery_secs=recovery_secs,
      peer_lost=[{k: e.get(k) for k in ('peer', 'degraded', 'adopted',
                                        'survivor')} for e in lost],
      fault_free_epoch_secs=fault_free_secs,
      failover_epoch_secs=failover_secs,
      store_bytes=store_bytes, store_bytes_needed=need,
      write_secs=write_secs,
      disk={'total': disk.total, 'free': disk.free, 'dir': shard_dir},
      card_memory_bytes=mem, **lane,
      launches_per_batch=per_batch, launches=launches, plain_calls=0)
  emit('failover', **out)
  out.update(path=path, ref=ref)
  return out


def handoff_arm(torch, ops, ds, ref) -> dict:
  """`bench_autoscale.py` phase C at products scale, on the failover
  arm's store and loader: a fresh loader's epoch with `handoff(ds, 3, 5,
  store=ShardStore(tmp))` after its third batch.  Gates: 0 degraded
  batches (every batch digest-equal to the failover arm's fault-free
  epoch, none missing), ``book_bumps == 1`` and one transfer; 24 K1 and
  16 K2 launches every batch, counted over the whole epoch (the handoff
  runs inside it), no plain call.  The handoff's seconds by seam come
  from its ``handoff.transfer`` recorder events."""
  import shutil
  import tempfile
  from graphlearn_tpu_torch.parallel import DistNeighborLoader
  from graphlearn_tpu_torch.parallel.failover import ShardStore
  from graphlearn_tpu_torch.parallel.handoff import handoff
  from graphlearn_tpu_torch.telemetry import recorder
  rng_, to, after = FO_HANDOFF
  seeds = np.random.default_rng(0).permutation(NUM_NODES)[
      :MESH_BATCH * MESH_PARTS * FO_BATCHES]
  per_batch = {'sample_one_hop': len(FANOUTS) * MESH_PARTS,
               'gather_rows': 2 * MESH_PARTS, 'sample_one_hop_gns': 0}
  dig = mesh_digest(torch)
  ds_h = fresh_view(ds)
  it = iter(DistNeighborLoader(ds_h, FANOUTS, seeds, batch_size=MESH_BATCH,
                               shuffle=True, seed=0, device=DEVICE))
  done = {}

  def move():
    d = tempfile.mkdtemp(prefix='glt_handoff_')
    recorder.enable()
    recorder.clear()
    try:
      sync(torch)
      t0 = time.perf_counter()
      done['info'] = handoff(ds_h, rng_, to, store=ShardStore(d))
      done['secs'] = time.perf_counter() - t0
      done['events'] = recorder.events('handoff.transfer')
    finally:
      recorder.disable()
      recorder.clear()
      shutil.rmtree(d, ignore_errors=True)
  got, epoch_secs, _, _, launches = counted_epoch(
      torch, ops, it, per_batch, dig, between=(after, move))
  info, secs, events = done['info'], done['secs'], done['events']
  degraded = abs(len(ref) - len(got)) + sum(
      not torch.equal(a, b) for a, b in zip(ref, got))
  book = ds_h.partition_book
  if degraded or book.version != 1 or len(book.transfers()) != 1:
    raise AssertionError(f'handoff: degraded batches {degraded}, book '
                         f'{book.version}, transfers {book.transfers()}')
  by_seam, last = {}, 0.0
  for e in events:
    by_seam[e['phase']] = e['secs'] - last
    last = e['secs']
  out = dict(batches=len(got), degraded_batches=degraded,
             book_bumps=book.version, transfers=book.transfers(),
             frm=info['frm'], to=info['to'], after_batches=after,
             secs=secs, secs_by_seam=by_seam,
             phases=[e['phase'] for e in events],
             drain_fault=info['drain_fault'], epoch_secs=epoch_secs,
             launches_per_batch=per_batch, launches=launches, plain_calls=0)
  emit('handoff', **out)
  return out


def gns_failover_arm(torch, ops, timer, ds, train_idx) -> dict:
  """The tiered GNS arm: `mesh_train`'s loader (the split-0.3 store, GNS,
  the equal-HBM victim cache, the dispatch-ahead overlay) over
  `FO_GNS_BATCHES` batches of the train split, fault-free, then with
  ``GLT_SHARD_DIR`` set and ``partition.owner:kill`` of partition 4 at
  the middle batch.  Gates: the epoch completes, one adoption, every
  batch digest-equal (node, x, y, edge_index, edge weights) to the
  fault-free one — the JAX package's run of the same case on the CPU is
  byte-identical (`tests/test_torch_partition_failover.py`) — the GNS
  bitmask rebuilt at the fence (its version reset, then a rebuild in the
  same dispatch), 24 K1-GNS and 16 K2 launches every batch, no plain
  call, host-tier rows served by the overlay, and the adopted dispatch's
  calls byte-equal to the plain versions."""
  import shutil
  from graphlearn_tpu_torch.parallel import DistNeighborLoader
  from graphlearn_tpu_torch.telemetry import recorder
  from graphlearn_tpu_torch.testing import chaos
  seeds = train_idx[:MESH_BATCH * MESH_PARTS * FO_GNS_BATCHES]
  cache_rows = int(ds.node_features.hot_counts.max())
  per_batch = {'sample_one_hop_gns': len(FANOUTS) * MESH_PARTS,
               'gather_rows': 2 * MESH_PARTS, 'sample_one_hop': 0}
  dig = mesh_digest(torch, gns=True)

  def make(d):
    return DistNeighborLoader(d, FANOUTS, seeds, batch_size=MESH_BATCH,
                              shuffle=True, seed=0,
                              cold_cache_rows=cache_rows, gns=True,
                              device=DEVICE)

  ref, ref_secs = counted_epoch(torch, ops, iter(make(fresh_view(ds))),
                                per_batch, dig)[:2]
  kill_step, victim = FO_GNS_BATCHES // 2, MESH_PARTS // 2
  shard_dir, need = durable_dir(ds)
  try:
    with EnvKnobs(clear=('GLT_DEGRADED_OK',), GLT_SHARD_DIR=shard_dir):
      ds_f = fresh_view(ds)
      t0 = time.perf_counter()
      loader = make(ds_f)
      write_secs = time.perf_counter() - t0
      store_bytes = dir_bytes(shard_dir)
      s = loader.sampler
      builds, fenced = [], []
      real_fence, real_bits = s.maybe_refresh_book, s._gns_arrays

      def fence():
        ver = real_fence()
        fenced.append((s._step_cnt + 1, ver, s._gns_ver))
        return ver

      def bits():
        if s._gns_ver == -1:
          builds.append(s._step_cnt)
        return real_bits()
      s.maybe_refresh_book, s._gns_arrays = fence, bits
      st0 = s.exchange_stats()
      recorder.enable()
      recorder.clear()
      chaos.install(f'partition.owner:kill:{kill_step}:partition={victim}')
      try:
        # the loader dispatches one batch ahead: step s is dispatched in
        # the (s - 2)-th next() call
        got, secs, rec, before, launches = counted_epoch(
            torch, ops, iter(loader), per_batch, dig,
            record_at=kill_step - 2 if loader._cold_pipeline else
            kill_step - 1, recorder_kw={'gns': True})
        recovered = [e['secs'] for e in recorder.events('partition.adopt')
                     if e.get('phase') == 'recovered']
      finally:
        chaos.uninstall()
        recorder.disable()
        recorder.clear()
      st1 = s.exchange_stats()
  finally:
    shutil.rmtree(shard_dir, ignore_errors=True)
  book = ds_f.partition_book
  adopt_at = [st for st, ver, gv in fenced if ver == 1 and gv == -1]
  rebuilt = bool(adopt_at) and adopt_at[0] in builds
  same = [bool(torch.equal(a, b)) for a, b in zip(ref, got)]
  cold = st1['dist.feature.cold_misses'] - st0['dist.feature.cold_misses']
  if not (len(got) == len(ref) == FO_GNS_BATCHES and all(same)
          and len(book.adoptions()) == 1 and book.version == 1 and rebuilt
          and cold > 0):
    raise AssertionError(
        f'gns failover: {len(got)}/{len(ref)} batches, digest-equal {same}, '
        f'adoptions {book.adoptions()}, fences {fenced}, builds {builds}, '
        f'host-tier rows {cold}')
  lane = check_adopted_lane(rec, s, ds_f, victim, ('fshard', 'lshard'))
  path = check_mesh_path(torch, ops, timer, rec,
                         'gns failover adopted dispatch')
  del rec
  mem = {'epoch_start': before, 'epoch_end': card_bytes(torch)}
  del loader, ds_f
  out = dict(
      parts=MESH_PARTS, batch=MESH_BATCH, fanouts=list(FANOUTS),
      store=f'tiered split {MESH_SPLIT}, GNS, victim cache {cache_rows} '
            'rows a partition, dispatch-ahead overlay',
      batches=len(got), kill_step=kill_step, killed_partition=victim,
      digest_equal=True, adoptions=book.adoptions(),
      bitmask_rebuilt_at_dispatch=adopt_at[0],
      fault_free_epoch_secs=ref_secs, failover_epoch_secs=secs,
      store_bytes=store_bytes, store_bytes_needed=need,
      write_secs=write_secs, recovery_secs=recovered[0] if recovered
      else None, host_tier_rows=cold, card_memory_bytes=mem,
      **lane, launches_per_batch=per_batch, launches=launches,
      plain_calls=0,
      k6_note='the mesh overlay serves host-tier rows by a host gather '
              'and one copy (as JAX\'s overlay_cold_host does); K6 is the '
              'single-card tiered Feature\'s, not on this path')
  emit('gns_failover', **out)
  out.update(path=path)
  return out


def failover_phases(torch, ops, timer, indptr, indices, feats) -> dict:
  """``--failover``: `mesh_data`'s two stores, then `failover_arm` and
  `handoff_arm` on the untiered one and `gns_failover_arm` on the tiered
  one; one ``failover_group`` line with the group's wall time."""
  t0 = time.perf_counter()
  labels = make_labels(torch, feats)
  ds_u, ds_t = mesh_data(torch, indptr, indices, feats, labels)
  timer = Timer(torch, reps=RESUME_CHECK_REPS)
  fo = failover_arm(torch, ops, timer, ds_u)
  ho = handoff_arm(torch, ops, ds_u, fo.pop('ref'))
  del ds_u
  torch.cuda.empty_cache()
  gf = gns_failover_arm(torch, ops, timer, ds_t, train_splits()[0])
  del ds_t
  torch.cuda.empty_cache()
  emit('failover_group', wall_secs=time.perf_counter() - t0)
  return {'failover': fo, 'handoff': ho, 'gns': gf}


def failover_kernels(fg: dict) -> list:
  """The ``kernels`` entries of ``--failover`` alone: K1 and K2 at the
  adopted dispatch of the failover arm, K1-GNS (and K2) at the tiered GNS
  arm's; the launches each arm's killed or handed-off epoch counted."""
  fo, ho, gf = fg['failover'], fg['handoff'], fg['gns']

  def entry(name, src, replaces, hops, path_what, launches, extra=None):
    return {'name': name, 'route': 'cuda', 'source': src,
            'replaces': replaces, 'launches': sum(launches.values()),
            'max_abs_err': max(h['max_abs_err'] for h in hops),
            'ms': sum(h['kernel_ms'] for h in hops),
            'plain_ms': sum(h['plain_ms'] for h in hops),
            'bound_ms': sum(h['bound_us'] for h in hops) / 1e3,
            'bound_by': 'bytes',
            'library_ms': (sum(h['library_ms'] for h in hops)
                           if all('library_ms' in h for h in hops) else None),
            'byte_equal': True, 'shape': path_what,
            'launches_by_path': launches, **(extra or {})}
  return [
      entry('sample_one_hop', 'graphlearn_tpu_torch/csrc/sample_one_hop.cu',
            'graphlearn_tpu/ops/pallas_sample.py:247',
            fo['path']['hops'],
            'failover adopted dispatch (8 x 512 seeds), hops of '
            + '/'.join(str(h['rows']) for h in fo['path']['hops'])
            + ' rows over 8 ranges, k 15/10/5',
            {'failover': fo['launches']['sample_one_hop'],
             'handoff': ho['launches']['sample_one_hop']}),
      entry('gather_rows', 'graphlearn_tpu_torch/csrc/gather_rows.cu',
            'graphlearn_tpu/ops/pallas_gather.py:152',
            fo['path']['gathers'],
            'failover adopted dispatch: features and labels over 8 ranges',
            {arm: r['launches']['gather_rows']
             for arm, r in (('failover', fo), ('handoff', ho),
                            ('gns_failover', gf))}),
      entry('sample_one_hop_gns',
            'graphlearn_tpu_torch/csrc/sample_one_hop_gns.cu',
            'graphlearn_tpu/ops/pallas_sample.py:247 (gns arm :178)',
            gf['path']['hops'],
            'tiered GNS failover adopted dispatch, hops of '
            + '/'.join(str(h['rows']) for h in gf['path']['hops'])
            + ' rows over 8 ranges, k 15/10/5',
            {'gns_failover': gf['launches']['sample_one_hop_gns']}),
  ]


# -- the mesh at P = 16 and 64: layouts, attribution, locality, rebalance ----
ENV_NODES = 20_000                  # bench.py's envelope graph (phase 3c)
ENV_ROWS = ((16, 64), (64, 32))     # (partitions, batch a partition)
ENV_FANOUTS = (5, 5)
ENV_EPOCHS = 5
ENV_LAYOUT_SLACK = 1.25
LOC_PARTS = 16
LOC_EPOCHS = 4
LOC_RETIMED = 2
LOC_REPLICA = 0.35
LOC_SLACK = 1.25
REB_PARTS = 16
REB_BATCH = 64
REB_BATCHES = 8
REB_AFTER = 3                       # batches before the rebalance
REB_SLACK = 1.5
PATH_REPS = 3                       # timer reps of the per-owner checks


def coo_rows(torch, indptr):
  """The CSR's source ids, one an edge, on the card."""
  deg = indptr[1:] - indptr[:-1]
  return torch.repeat_interleave(
      torch.arange(deg.numel(), device=indptr.device), deg)


def envelope_graph(seed=0):
  """`benchmarks/common.py:build_graph`'s recipe (host numpy) at
  `ENV_NODES` nodes."""
  n, avg_deg = ENV_NODES, AVG_DEG
  rng = np.random.default_rng(seed)
  e = n * avg_deg
  rows = rng.integers(0, n, e, dtype=np.int64)
  hubs = rng.random(e) < 0.3
  cols = np.where(hubs, (rng.random(e) ** 2 * n).astype(np.int64),
                  rng.integers(0, n, e, dtype=np.int64))
  return rows, cols.astype(np.int64)


def frontier_epochs(torch, loader, epochs):
  """`bench_dist_loader._epoch_exchange_rows`: ``epochs`` epochs, each
  epoch's frontier ``(waste %, drop %)`` from the counter deltas, and the
  seconds (the card synchronised at the end)."""
  s = loader.sampler
  rows, n = [], 0
  t0 = time.perf_counter()
  for _ in range(epochs):
    prev = s.exchange_stats()
    for _ in loader:
      n += 1
    st = s.exchange_stats()
    off, drop, slots = (st[f'dist.frontier.{k}'] - prev[f'dist.frontier.{k}']
                        for k in ('offered', 'dropped', 'slots'))
    rows.append((100.0 * (1 - (off - drop) / max(slots, 1)),
                 100.0 * drop / max(off, 1)))
  sync(torch)
  return rows, n, time.perf_counter() - t0


def check_path_hops(torch, ops, rec, what, parts):
  """A recorded featureless dispatch's ``hops x parts`` sampler calls
  held against the plain version, timed (`PATH_REPS`)."""
  return check_mesh_path(torch, ops, Timer(torch, reps=PATH_REPS), rec, what,
                         tables=(), parts=parts)['hops']


def envelope_phase(torch, ops, indptr, indices, rows_t, parts,
                   batch) -> dict:
  """`bench.py` phase 3c's envelope row (`bench_dist_loader.
  envelope_worker`, homo) at products scale on ``parts`` partitions of
  the card: the range-partitioned featureless store; the headline
  `DistNeighborLoader([5, 5], shuffle=True, exchange_slack='adaptive')`
  under the default layout (compact at 16 and 64), its first batch
  (kernel inputs recorded), then 5 epochs of 2 batches, waste and drops
  by epoch and cumulative, the attribution; then one epoch a layout
  (dense, compact, hier) at slack 1.25, the hier loader's first
  dispatch recorded.  Checks: 2P K1 launches a batch and no plain call,
  every recorded call byte-equal to the plain version."""
  import graphlearn_tpu_torch.parallel.dist_sampler as dsm
  from graphlearn_tpu_torch.parallel import DistDataset, DistNeighborLoader
  from graphlearn_tpu_torch.parallel.exchange import resolve_layout
  torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  ds = DistDataset.from_full_graph(parts, rows_t, indices,
                                   num_nodes=NUM_NODES, device=DEVICE)
  sync(torch)
  build_secs = time.perf_counter() - t0
  rng = np.random.default_rng(1)
  per_batch = {'sample_one_hop': len(ENV_FANOUTS) * parts, 'gather_rows': 0}

  def make(layout=None, slack='adaptive'):
    seeds = rng.integers(0, NUM_NODES, batch * parts * 2)
    return DistNeighborLoader(ds, ENV_FANOUTS, seeds, batch_size=batch,
                              shuffle=True, collect_features=False, seed=0,
                              exchange_slack=slack, exchange_layout=layout,
                              device=DEVICE)

  def counted(fn):
    reset_counts(ops)
    out = fn()
    sync(torch)
    launches, plain = read_counts(ops)
    return out, launches, plain

  loader = make()
  sync(torch)
  t0 = time.perf_counter()
  with PathRecorder(torch, dsm, gns=False, parts=parts, tables=0,
                    hops=len(ENV_FANOUTS), first=True) as rec:
    (_, l0, p0) = counted(lambda: next(iter(loader)))
  first_secs = time.perf_counter() - t0
  (rows, n_batches, secs), l1, p1 = counted(
      lambda: frontier_epochs(torch, loader, ENV_EPOCHS))
  want = per_batch['sample_one_hop'] * (n_batches + 1)
  if (l0['sample_one_hop'] + l1['sample_one_hop'] != want or p0 or p1
      or l0['gather_rows'] + l1['gather_rows']):
    raise AssertionError(f'envelope P={parts}: launches {l0} {l1}, plain '
                         f'{p0 + p1}, want {want} K1')
  st = loader.sampler.exchange_stats()
  sent = st['dist.frontier.offered'] - st['dist.frontier.dropped']
  layout = resolve_layout(loader.sampler.exchange_layout, parts)
  hops_compact = check_path_hops(torch, ops, rec, f'envelope P={parts} '
                                 f'{layout} first batch', parts)
  del rec
  att = loader.sampler.attribution_stats(tick_metrics=False)
  out = dict(
      parts=parts, batch=batch, fanouts=list(ENV_FANOUTS),
      num_nodes=NUM_NODES, partitioner=ds.partitioner,
      build_secs=build_secs, first_batch_secs=first_secs,
      seeds_per_sec=n_batches * batch * parts / secs,
      padding_waste_pct=rows[-1][0], drop_rate_pct=rows[-1][1],
      padding_waste_pct_by_epoch=[r[0] for r in rows],
      drop_rate_pct_by_epoch=[r[1] for r in rows],
      padding_waste_pct_cum=100.0 * (1 - sent / max(
          st['dist.frontier.slots'], 1)),
      drop_rate_pct_cum=100.0 * st['dist.frontier.dropped'] / max(
          st['dist.frontier.offered'], 1),
      slack_final=loader.sampler.exchange_slack, exchange_layout=layout,
      launches_per_batch=per_batch, batches=n_batches + 1,
      launches={'sample_one_hop': want, 'gather_rows': 0}, plain_calls=0,
      attribution={k: att[k] for k in (
          'cross_partition_ids_frac', 'cross_partition_bytes_frac',
          'local_ids', 'cross_ids', 'hot_range_coverage', 'hot_ranges',
          'hotness_source')})
  del loader
  layouts, hops_hier = {}, None
  for name in ('dense', 'compact', 'hier'):
    ll = make(name, ENV_LAYOUT_SLACK)
    if name == 'hier':
      with PathRecorder(torch, dsm, gns=False, parts=parts, tables=0,
                        hops=len(ENV_FANOUTS), first=True) as rec:
        (lrows, nb, lsecs), ll_l, ll_p = counted(
            lambda: frontier_epochs(torch, ll, 1))
      hops_hier = check_path_hops(torch, ops, rec, f'envelope P={parts} '
                                  'hier layout epoch', parts)
      del rec
    else:
      (lrows, nb, lsecs), ll_l, ll_p = counted(
          lambda: frontier_epochs(torch, ll, 1))
    if ll_l['sample_one_hop'] != per_batch['sample_one_hop'] * nb or ll_p:
      raise AssertionError(f'{name} P={parts}: launches {ll_l}, plain {ll_p}')
    lst = ll.sampler.exchange_stats()
    layouts[name] = {
        'resolved': resolve_layout(name, parts),
        'padding_waste_pct': lrows[-1][0], 'drop_rate_pct': lrows[-1][1],
        'frontier_slots': lst['dist.frontier.slots'],
        'frontier_offered': lst['dist.frontier.offered'],
        'frontier_dropped': lst['dist.frontier.dropped'],
        'seeds_per_sec': nb * batch * parts / lsecs, 'batches': nb}
    del ll
  out.update(layouts=layouts,
             peak_card_bytes=torch.cuda.max_memory_allocated())
  emit(f'envelope_p{parts}', **out)
  del ds
  torch.cuda.empty_cache()
  out.update(path={layout: hops_compact, 'hier': hops_hier})
  return out


def timed_partition():
  """Wrap `locality.locality_partition` to keep its host seconds (the
  greedy and its adjacency build); returns ``(secs list, restore)``."""
  import graphlearn_tpu_torch.parallel.locality as loc
  real, secs = loc.locality_partition, []

  def wrapped(*a, **kw):
    t0 = time.perf_counter()
    out = real(*a, **kw)
    secs.append(time.perf_counter() - t0)
    return out
  loc.locality_partition = wrapped
  return secs, lambda: setattr(loc, 'locality_partition', real)


def edge_cut_on_card(torch, ds, rows_t, indices) -> float:
  """The fraction of the graph's edges whose endpoints ``ds`` places on
  different partitions (counted on the card)."""
  bounds = torch.from_numpy(ds.graph.bounds).to(DEVICE)
  o2n = torch.from_numpy(ds.old2new).to(DEVICE)
  part = torch.searchsorted(bounds, o2n, right=True)
  return float((part[rows_t] != part[indices.long()]).float().mean())


def locality_comparison(torch, ops, indptr, indices, feats, rows_t, parts,
                        batch) -> dict:
  """`bench_dist_loader._locality_comparison` at products scale on
  ``parts`` partitions, ``GLT_EXCHANGE_EWMA=1``: the range arm and the
  locality arm (the greedy, the replica cache of ``ceil(0.35 N)`` rows a
  partition, the EWMA retunes), each featured over ``batch * P * 8``
  seeds, 4 epochs then a re-timed window of 2 (the steady rate), the
  attribution, drops and retunes; each arm's first dispatch recorded and
  every K1 and K2 call held against its plain version.  Then the rename
  twin: the locality placement replayed as an explicit ``node_pb`` over
  the relabelled edges must relabel to the identity and give one epoch
  digest-equal in node, x, edge_index and batch (raises otherwise).
  Launches a batch: 2P K1; K2 P for the range arm's exchange, 3P for the
  locality arm's (the exchange, the replica overlay, the own rows)."""
  from graphlearn_tpu_torch.parallel import DistDataset, DistNeighborLoader
  from graphlearn_tpu_torch.telemetry import recorder
  seeds = np.random.default_rng(2).integers(0, NUM_NODES,
                                            batch * parts * 8)
  res, ds_loc = {}, None
  dig = lambda b: digest(torch, [b.node, b.x, b.edge_index,  # noqa: E731
                                 b.batch])
  t_group = time.perf_counter()
  with EnvKnobs(clear=('GLT_PARTITIONER', 'GLT_LOCALITY_REPLICA_FRAC'),
                GLT_EXCHANGE_EWMA='1'):
    for arm in ('range', 'locality'):
      torch.cuda.reset_peak_memory_stats()
      psecs, restore = timed_partition()
      t0 = time.perf_counter()
      try:
        ds = DistDataset.from_full_graph(
            parts, rows_t, indices, node_feat=feats, num_nodes=NUM_NODES,
            partitioner=arm,
            replica_frac=LOC_REPLICA if arm == 'locality' else None,
            device=DEVICE)
      finally:
        restore()
      sync(torch)
      build_secs = time.perf_counter() - t0
      loader = DistNeighborLoader(ds, ENV_FANOUTS, seeds, batch_size=batch,
                                  shuffle=True, seed=0,
                                  exchange_slack=LOC_SLACK, device=DEVICE)
      k2 = parts * (3 if loader.sampler.cache_local else 1)
      per_batch = {'sample_one_hop': len(ENV_FANOUTS) * parts,
                   'gather_rows': k2}
      recorder.enable()
      recorder.clear()
      rates, launches, rec = [], {}, None
      try:
        for ep in range(LOC_EPOCHS + LOC_RETIMED):
          got = counted_epoch(
              torch, ops, iter(loader), per_batch, dig, parts=parts,
              record_at=0 if ep == 0 else None,
              recorder_kw={'gns': False, 'hops': len(ENV_FANOUTS),
                           'tables': k2 // parts})
          if ep == 0:
            rec = got[2]
          for k, v in got[4].items():
            launches[k] = launches.get(k, 0) + v
          rates.append((len(got[0]), got[1]))
        retunes = len(recorder.events('exchange.retune'))
      finally:
        recorder.disable()
        recorder.clear()
      tables = ('features exchange',) + (
          ('replica overlay', 'own rows') if k2 > parts else ())
      path = check_mesh_path(torch, ops, Timer(torch, reps=PATH_REPS), rec,
                             f'locality P={parts} {arm} arm', tables=tables,
                             parts=parts)
      del rec
      att = loader.sampler.attribution_stats(tick_metrics=False)
      st = loader.sampler.exchange_stats()
      window = rates[LOC_EPOCHS:]
      res[arm] = {
          'partitioner': ds.partitioner,
          'partition_secs': psecs[0] if psecs else 0.0,
          'build_secs': build_secs,
          'edge_cut_frac': edge_cut_on_card(torch, ds, rows_t, indices),
          'cross_partition_bytes_frac': att['cross_partition_bytes_frac'],
          'cross_partition_ids_frac': att['cross_partition_ids_frac'],
          'locally_served_ids': att['locally_served_ids'],
          'seeds_per_sec': sum(n for n, _ in window) * batch * parts
                           / sum(t for _, t in window),
          'seeds_per_sec_by_epoch': [n * batch * parts / t
                                     for n, t in rates[:LOC_EPOCHS]],
          'drop_rate_pct': 100.0 * st['dist.frontier.dropped'] / max(
              st['dist.frontier.offered'], 1),
          'feature_drop_rate_pct': 100.0 * st['dist.feature.dropped'] / max(
              st['dist.feature.offered'], 1),
          'retunes': retunes, 'ewma_caps': loader.sampler._ewma_caps(),
          'replicated_rows': (int(ds.node_features.cache_ids.shape[1])
                              if ds.node_features.has_cache else 0),
          'launches_per_batch': per_batch, 'launches': launches,
          'plain_calls': 0,
          'peak_card_bytes': torch.cuda.max_memory_allocated()}
      res[arm]['path'] = path
      del loader
      if arm == 'locality':
        ds_loc = ds
      del ds
      torch.cuda.empty_cache()
  res['locality_over_range_speedup'] = (res['locality']['seeds_per_sec']
                                        / res['range']['seeds_per_sec'])
  # the rename twin
  t0 = time.perf_counter()
  o2n = torch.from_numpy(ds_loc.old2new).to(DEVICE)
  n2o = torch.from_numpy(ds_loc.new2old).to(DEVICE)
  pb_new = (np.searchsorted(ds_loc.graph.bounds, np.arange(NUM_NODES),
                            'right') - 1).astype(np.int32)
  cols_new = o2n[indices.long()]
  twin = DistDataset.from_full_graph(
      parts, o2n[rows_t], cols_new, node_feat=feats[n2o],
      num_nodes=NUM_NODES, node_pb=pb_new, replica_frac=LOC_REPLICA,
      hotness=torch.bincount(cols_new, minlength=NUM_NODES).cpu().numpy(),
      device=DEVICE)
  del cols_new
  equivalent = bool(np.array_equal(twin.old2new, np.arange(NUM_NODES)))
  digs = []
  for d, s_ in ((ds_loc, seeds), (twin, ds_loc.old2new[seeds])):
    lo = DistNeighborLoader(d, ENV_FANOUTS, s_, batch_size=batch,
                            shuffle=True, seed=0, exchange_slack=LOC_SLACK,
                            device=DEVICE)
    digs.append(torch.stack([dig(b) for b in lo]).cpu())
    del lo
  equivalent = equivalent and bool(torch.equal(digs[0], digs[1]))
  res['rename_equivalent'] = equivalent
  res['rename_secs'] = time.perf_counter() - t0
  del twin, ds_loc, o2n, n2o
  torch.cuda.empty_cache()
  if not equivalent:
    raise AssertionError(f'locality P={parts}: the rename twin differs')
  res['secs'] = time.perf_counter() - t_group
  emit(f'locality_p{parts}', **{k: ({kk: vv for kk, vv in v.items()
                                      if kk != 'path'}
                                     if isinstance(v, dict) else v)
                                  for k, v in res.items()})
  return res


def rebalance_phase(torch, ops, indptr, indices, feats, rows_t) -> dict:
  """`tests/test_locality.py::test_mid_epoch_rebalance_byte_identical` at
  products scale, P = 16: an explicit placement (``node % 16``) with the
  hubs — the lowest 1% of ids, the generator's hottest targets — on
  partition 3, featured; `DistNeighborLoader([5, 5], batch_size=64,
  shuffle=True, seed=0, exchange_slack=1.5, exchange_layout='dense')`
  over 8 batches (dense: the moved book's `_BookPlan` then takes the
  same receive shapes as the identity book's exchange).  An undisturbed
  epoch gives the reference digests; in a second epoch over its own
  book, after 3 batches, `attribution_stats` -> `rebalance_plan` ->
  `execute_rebalance` through a `ShardStore` in a fresh directory.
  Raises unless the plan moves range 3 first, every batch is
  digest-equal, the book version equals the moves, there is no adoption
  and the cross-partition byte fraction drops; 2P K1 and P K2 launches a
  batch and no plain call."""
  import shutil
  import tempfile
  from graphlearn_tpu_torch.parallel import (DistDataset, DistNeighborLoader,
                                             ShardStore)
  from graphlearn_tpu_torch.parallel.locality import (execute_rebalance,
                                                      rebalance_plan)
  from graphlearn_tpu_torch.telemetry import recorder
  parts = REB_PARTS
  pb = (np.arange(NUM_NODES) % parts).astype(np.int32)
  pb[:NUM_NODES // 100] = 3
  t0 = time.perf_counter()
  ds = DistDataset.from_full_graph(parts, rows_t, indices, node_feat=feats,
                                   num_nodes=NUM_NODES, node_pb=pb,
                                   device=DEVICE)
  sync(torch)
  build_secs = time.perf_counter() - t0
  seeds = np.random.default_rng(3).integers(0, NUM_NODES,
                                            REB_BATCH * parts * REB_BATCHES)
  per_batch = {'sample_one_hop': len(ENV_FANOUTS) * parts,
               'gather_rows': parts}
  dig = lambda b: digest(torch, [b.node, b.x, b.edge_index,  # noqa: E731
                                 b.batch])

  def make(d):
    return DistNeighborLoader(d, ENV_FANOUTS, seeds, batch_size=REB_BATCH,
                              shuffle=True, seed=0, exchange_slack=REB_SLACK,
                              exchange_layout='dense', device=DEVICE)
  ref, ref_secs = counted_epoch(torch, ops, iter(make(fresh_view(ds))),
                                per_batch, dig, parts=parts)[:2]
  ds2 = fresh_view(ds)
  loader = make(ds2)
  state, store_dir = {}, tempfile.mkdtemp(prefix='glt_rebalance_')

  def rebalance():
    t = time.perf_counter()
    att = loader.sampler.attribution_stats(tick_metrics=False)
    plan = rebalance_plan(att, book=ds2.partition_book)
    t_plan = time.perf_counter()
    infos = execute_rebalance(ds2, plan, store=ShardStore(store_dir))
    state.update(att=att, plan=plan, infos=infos,
                 plan_secs=t_plan - t, execute_secs=time.perf_counter() - t_plan)
  recorder.enable()
  recorder.clear()
  try:
    got, secs, _, _, launches = counted_epoch(
        torch, ops, iter(loader), per_batch, dig, parts=parts,
        between=(REB_AFTER, rebalance))
    seams = recorder.events('handoff.transfer')
  finally:
    recorder.disable()
    recorder.clear()
    shutil.rmtree(store_dir, ignore_errors=True)
  att2 = loader.sampler.attribution_stats(tick_metrics=False)
  book = ds2.partition_book
  plan = state['plan']
  same = [bool(torch.equal(a, b)) for a, b in zip(ref, got)]
  ok = (bool(plan) and plan[0]['range'] == 3 and len(got) == len(ref)
        and all(same) and book.version == len(plan)
        and book.adoptions() == []
        and att2['cross_partition_bytes_frac']
        < state['att']['cross_partition_bytes_frac'])
  if not ok:
    raise AssertionError(
        f'rebalance: plan {plan}, digest-equal {same}, book {book.version}, '
        f'adoptions {book.adoptions()}, cross '
        f'{state["att"]["cross_partition_bytes_frac"]} -> '
        f'{att2["cross_partition_bytes_frac"]}')
  by_seam = {}
  for mv in plan:
    evs = [e for e in seams if e['partition'] == mv['range']]
    prev = 0.0
    for e in evs:
      by_seam[e['phase']] = by_seam.get(e['phase'], 0.0) + e['secs'] - prev
      prev = e['secs']
  out = dict(parts=parts, batch=REB_BATCH, fanouts=list(ENV_FANOUTS),
             hubs=NUM_NODES // 100, build_secs=build_secs,
             plan=[{k: mv[k] for k in ('range', 'frm', 'to', 'demand')}
                   for mv in plan],
             moves=len(plan), book_version=book.version,
             adoptions=len(book.adoptions()), transfers=book.transfers(),
             digest_equal=True, batches=len(got),
             cross_partition_bytes_frac_before=state['att'][
                 'cross_partition_bytes_frac'],
             cross_partition_bytes_frac_after=att2[
                 'cross_partition_bytes_frac'],
             plan_secs=state['plan_secs'],
             execute_secs=state['execute_secs'], secs_by_seam=by_seam,
             undisturbed_epoch_secs=ref_secs, rebalanced_epoch_secs=secs,
             launches_per_batch=per_batch, launches=launches, plain_calls=0)
  emit('rebalance', **out)
  del loader, ds2, ds
  torch.cuda.empty_cache()
  return out


def locality_cross_check(torch) -> dict:
  """Card = CPU on the envelope's own 20,000-node graph at P = 16: the
  first batch of each layout (dense, compact, hier) with the same
  CPU-made draws digest-equal on both devices, and the locality
  partition's ``node_pb`` — the compiled greedy on the card's host, the
  numpy greedy on the CPU — equal, as are both datasets' relabels.  Host
  microseconds a node and sweep of both greedies."""
  from graphlearn_tpu_torch.parallel import (DistDataset, DistNeighborLoader,
                                             TorchDraws)
  from graphlearn_tpu_torch.parallel import locality as loc
  rows, cols = envelope_graph()
  n, parts, batch = ENV_NODES, 16, 64
  cpu_draws = TorchDraws(5, 'cpu')
  firsts = {}
  for dev in (DEVICE, 'cpu'):
    def draws(*a, dev=dev, **kw):
      return tuple(t.to(dev) for t in cpu_draws(*a, **kw))
    ds = DistDataset.from_full_graph(parts, rows, cols, num_nodes=n,
                                     device=dev)
    seeds = np.random.default_rng(4).integers(0, n, batch * parts * 2)
    for layout in ('dense', 'compact', 'hier'):
      lo = DistNeighborLoader(ds, ENV_FANOUTS, seeds, batch_size=batch,
                              shuffle=True, collect_features=False, seed=0,
                              exchange_slack=ENV_LAYOUT_SLACK,
                              exchange_layout=layout, draws=draws,
                              device=dev)
      b = next(iter(lo))
      firsts[(dev, layout)] = digest(torch, [b.node, b.edge_index]).cpu()
  same = {layout: bool(torch.equal(firsts[(DEVICE, layout)],
                                   firsts[('cpu', layout)]))
          for layout in ('dense', 'compact', 'hier')}
  hot = np.bincount(cols, minlength=n)
  t0 = time.perf_counter()
  pb_np, st_np = loc.locality_partition(rows, cols, n, parts, seed=0,
                                        hotness=hot)
  t_np = time.perf_counter() - t0
  t0 = time.perf_counter()
  pb_c, st_c = loc.locality_partition(rows, cols, n, parts, seed=0,
                                      hotness=hot, greedy=loc.compiled_greedy)
  t_c = time.perf_counter() - t0
  relabel = {}
  for dev in (DEVICE, 'cpu'):
    d = DistDataset.from_full_graph(parts, rows, cols, num_nodes=n,
                                    partitioner='locality', device=dev)
    relabel[dev] = (d.old2new, d.graph.bounds)
  pb_same = bool(np.array_equal(pb_np, pb_c)) and st_np == st_c
  relabel_same = all(np.array_equal(a, b) for a, b in zip(
      relabel[DEVICE], relabel['cpu']))
  if not (all(same.values()) and pb_same and relabel_same):
    raise AssertionError(f'locality card != CPU: first batches {same}, '
                         f'node_pb {pb_same}, relabel {relabel_same}')
  sweeps = 1 + st_np['passes']
  out = {'nodes': n, 'parts': parts, 'first_batch_equal': same,
         'node_pb_equal': True, 'relabel_equal': True,
         'edge_cut_frac': st_np['edge_cut_frac'],
         'numpy_greedy_secs': t_np, 'compiled_greedy_secs': t_c,
         'numpy_us_per_node_sweep': t_np / n / sweeps * 1e6,
         'compiled_us_per_node_sweep': t_c / n / sweeps * 1e6}
  emit('locality_cross_check', **out)
  return out


def locality_group(torch, ops, indptr, indices, feats, full=True) -> dict:
  """``--locality`` and the whole run: `envelope_phase` at P = 16 and 64,
  `locality_comparison` at P = 16 (and at P = 64 with ``full``: its two
  replica caches alone take about 44 GB, so the whole run leaves it
  out), `rebalance_phase`, `locality_cross_check`; one
  ``locality_group`` line with the group's seconds."""
  t0 = time.perf_counter()
  rows_t = coo_rows(torch, indptr)
  env = {p: envelope_phase(torch, ops, indptr, indices, rows_t, p, b)
         for p, b in ENV_ROWS}
  TELEMETRY['scale_envelope'] = [
      {'num_parts': p, 'padding_waste_pct': e['padding_waste_pct'],
       'seeds_per_sec': e['seeds_per_sec']} for p, e in env.items()]
  loc = {LOC_PARTS: locality_comparison(torch, ops, indptr, indices, feats,
                                        rows_t, LOC_PARTS, 64)}
  if full:
    loc[64] = locality_comparison(torch, ops, indptr, indices, feats, rows_t,
                                  64, 32)
  reb = rebalance_phase(torch, ops, indptr, indices, feats, rows_t)
  del rows_t
  torch.cuda.empty_cache()
  cc = locality_cross_check(torch)
  emit('locality_group', wall_secs=time.perf_counter() - t0,
       phases=sorted([f'envelope_p{p}' for p in env]
                     + [f'locality_p{p}' for p in loc]) + ['rebalance'])
  return {'envelope': env, 'locality': loc, 'rebalance': reb, 'cross': cc}


def locality_kernels(lg: dict) -> list:
  """The ``kernels`` entries of the locality group: K1 at the compact and
  hier receive shapes of the envelopes and the locality arms' dispatches,
  K2 at the locality arms' exchange, replica-overlay and own-row gathers;
  the launches each path counted."""
  env, loc = lg['envelope'], lg['locality']
  hops, shapes, gathers, gshapes = [], {}, [], {}
  for p, e in env.items():
    for layout, hs in e['path'].items():
      hops += hs
      shapes[f'envelope_p{p}_{layout}'] = {
          'shape': f'P={p} {layout} first dispatch, {p} owners a hop, '
                   'receive rows ' + '/'.join(
                       str(h['rows'] // p) for h in hs) + ' an owner, k 5/5',
          'ms': sum(h['kernel_ms'] for h in hs),
          'plain_ms': sum(h['plain_ms'] for h in hs),
          'bound_ms': sum(h['bound_us'] for h in hs) / 1e3}
  for p, r in loc.items():
    for arm in ('range', 'locality'):
      path = r[arm]['path']
      hops += path['hops']
      gathers += path['gathers']
      shapes[f'locality_p{p}_{arm}'] = {
          'shape': f'P={p} {arm} arm first dispatch, receive rows '
                   + '/'.join(str(h['rows'] // p) for h in path['hops'])
                   + ' an owner',
          'ms': sum(h['kernel_ms'] for h in path['hops']),
          'plain_ms': sum(h['plain_ms'] for h in path['hops']),
          'bound_ms': sum(h['bound_us'] for h in path['hops']) / 1e3}
      for name, g in zip(('exchange', 'replica_overlay', 'own_rows'),
                         path['gathers']):
        gshapes[f'locality_p{p}_{arm}_{name}'] = {
            'shape': f'P={p} {arm} arm {name}: {g["ids"]} ids x '
                     f'{g["row_bytes"]} B over {p} owners '
                     f'({g["valid"]} valid)',
            'ms': g['kernel_ms'], 'plain_ms': g['plain_ms'],
            'bound_ms': g['bound_us'] / 1e3, 'library_ms': g['library_ms']}
  k1_launch = {f'envelope_p{p}': e['launches']['sample_one_hop']
               for p, e in env.items()}
  k2_launch = {}
  for p, r in loc.items():
    for arm in ('range', 'locality'):
      k1_launch[f'locality_p{p}_{arm}'] = r[arm]['launches']['sample_one_hop']
      k2_launch[f'locality_p{p}_{arm}'] = r[arm]['launches']['gather_rows']
  reb = lg['rebalance']
  k1_launch['rebalance'] = reb['launches']['sample_one_hop']
  k2_launch['rebalance'] = reb['launches']['gather_rows']
  first = shapes[f'envelope_p{LOC_PARTS}_compact']
  g0 = gshapes[f'locality_p{LOC_PARTS}_locality_exchange']
  return [
      {'name': 'sample_one_hop', 'route': 'cuda',
       'source': 'graphlearn_tpu_torch/csrc/sample_one_hop.cu',
       'replaces': 'graphlearn_tpu/ops/pallas_sample.py:247',
       'launches': sum(k1_launch.values()),
       'max_abs_err': max(h['max_abs_err'] for h in hops),
       'ms': first['ms'], 'plain_ms': first['plain_ms'],
       'bound_ms': first['bound_ms'], 'bound_by': 'bytes',
       'library_ms': None, 'byte_equal': True, 'shape': first['shape'],
       'locality_shapes': shapes, 'launches_by_path': k1_launch},
      {'name': 'gather_rows', 'route': 'cuda',
       'source': 'graphlearn_tpu_torch/csrc/gather_rows.cu',
       'replaces': 'graphlearn_tpu/ops/pallas_gather.py:152',
       'launches': sum(k2_launch.values()),
       'max_abs_err': max(g['max_abs_err'] for g in gathers),
       'ms': g0['ms'], 'plain_ms': g0['plain_ms'],
       'bound_ms': g0['bound_ms'], 'bound_by': 'bytes',
       'library_ms': g0['library_ms'], 'byte_equal': True,
       'shape': g0['shape'], 'locality_shapes': gshapes,
       'launches_by_path': k2_launch},
  ]


#: the telemetry group's mesh batches (each run: recorder off, then on)
TELEMETRY_BATCHES = 4
#: the stages the report's table must hold once a batch
TELEMETRY_STAGES = ('batch', 'sample.exchange', 'feature.lookup', 'stitch')


def telemetry_mesh_runs(torch, ops, ds, flight: str) -> dict:
  """`mesh_loader`'s configuration on the tiered store (P = 8, 512 a
  partition, fanouts [15, 10, 5], shuffled, adaptive slack) for
  `TELEMETRY_BATCHES` batches twice from the same seed: the recorder
  off, then writing ``flight`` (JSON lines).  Every batch's digest and
  the launch counts must be equal, with no plain call."""
  from graphlearn_tpu_torch.parallel import DistNeighborLoader
  from graphlearn_tpu_torch.telemetry import recorder
  seeds = np.random.default_rng(0).permutation(NUM_NODES)[
      :MESH_BATCH * MESH_PARTS * TELEMETRY_BATCHES]
  runs = {}
  for on in (False, True):
    loader = DistNeighborLoader(ds, FANOUTS, seeds, batch_size=MESH_BATCH,
                                shuffle=True, seed=0,
                                exchange_slack='adaptive', device=DEVICE)
    if on:
      recorder.enable(flight)
      recorder.clear()
    reset_counts(ops)
    digests, batch_ms = [], []
    try:
      it = iter(loader)
      while True:
        sync(torch)
        t = time.perf_counter()
        try:
          b = next(it)
        except StopIteration:
          break
        digests.append(digest(torch, [b.node, b.x, b.y, b.edge_index,
                                      b.edge_mask]).cpu())
        batch_ms.append((time.perf_counter() - t) * 1e3)
    finally:
      if on:
        recorder.disable()
    launches, plain = read_counts(ops)
    runs['on' if on else 'off'] = {'digests': torch.stack(digests),
                                   'batch_ms': batch_ms,
                                   'launches': launches, 'plain': plain}
  off, on = runs['off'], runs['on']
  n = len(off['batch_ms'])
  if not (n == TELEMETRY_BATCHES == len(on['batch_ms'])
          and torch.equal(off['digests'], on['digests'])):
    raise AssertionError('mesh batches differ with the recorder on')
  if not (off['launches'] == on['launches'] and off['plain'] == 0
          and on['plain'] == 0 and on['launches']['sample_one_hop']
          == len(FANOUTS) * MESH_PARTS * n):
    raise AssertionError(f'launches off {off["launches"]} on '
                         f'{on["launches"]}, plain {off["plain"]} / '
                         f'{on["plain"]}')
  return runs


def telemetry_group(torch, ops, indptr, indices, feats) -> dict:
  """The telemetry tools on a mesh run of this card (`--telemetry`, and
  last in the whole run): the recorder's JSON lines from
  `telemetry_mesh_runs` through `report`'s stage table (one ``batch`` /
  ``sample.exchange`` / ``feature.lookup`` / ``stitch`` row a batch) and
  the Chrome export; a post-mortem bundle with the time-series rings
  under a temporary ``GLT_POSTMORTEM_DIR``, loaded and rendered; and
  the regression gate over an artifact `sink` writes under the JAX
  package's dotted keys from this run's figures (``dist.serving.*``,
  ``dist.seeds_per_sec``, ``dist.scale_envelope.*`` when the `locality`
  group ran): its first check creates the baseline (rc 0), the second
  passes (rc 0), a copy with ``dist.seeds_per_sec`` 30% lower fails (rc
  1) naming it.  Every file is in a temporary directory."""
  import shutil
  import tempfile
  from graphlearn_tpu_torch.parallel import DistDataset
  from graphlearn_tpu_torch.telemetry import (export, postmortem, regress,
                                              report, sink, timeseries)
  t_group = time.perf_counter()
  tmp = tempfile.mkdtemp(prefix='glt_telemetry_')
  try:
    labels = make_labels(torch, feats)
    rows = torch.repeat_interleave(torch.arange(NUM_NODES, device=DEVICE),
                                   indptr[1:] - indptr[:-1])
    t0 = time.perf_counter()
    ds = DistDataset.from_full_graph(
        MESH_PARTS, rows, indices, node_feat=feats, node_label=labels,
        num_nodes=NUM_NODES, split_ratio=MESH_SPLIT, device=DEVICE)
    del rows, labels
    store_secs = time.perf_counter() - t0
    flight = os.path.join(tmp, 'flight.jsonl')
    runs = telemetry_mesh_runs(torch, ops, ds, flight)
    del ds
    torch.cuda.empty_cache()

    # the stage table and the Chrome export of the flight file
    events = export.load_events(flight)
    hists = report.histograms_from_events(events)
    n = TELEMETRY_BATCHES
    counts = {k: int(hists[k].count) if k in hists else 0
              for k in TELEMETRY_STAGES + ('exchange.layout',)}
    if any(counts[k] != n for k in TELEMETRY_STAGES):
      raise AssertionError(f'stage rows {counts}, {n} batches')
    table = report.format_table(hists)
    chrome_path = os.path.join(tmp, 'trace.json')
    written = export.write_chrome_trace(flight, chrome_path)
    with open(chrome_path) as f:
      chrome = json.load(f)
    slices = sum(1 for e in chrome['traceEvents'] if e.get('ph') == 'X')
    if slices < len(TELEMETRY_STAGES) * n:
      raise AssertionError(f'the chrome trace holds {slices} slices')

    # a post-mortem bundle with the time-series rings
    old_dir = os.environ.get('GLT_POSTMORTEM_DIR')
    os.environ['GLT_POSTMORTEM_DIR'] = os.path.join(tmp, 'postmortem')
    postmortem.reset()
    store = timeseries.ensure_global()
    try:
      for _ in range(3):
        store.sample_once()
      bundle_path = postmortem.dump('telemetry.smoke',
                                    extra={'batches': n})
      bundle = postmortem.load_bundle(bundle_path)
      rendered = report.render_postmortem(bundle)
    finally:
      timeseries.stop_global()
      postmortem.reset()
      if old_dir is None:
        del os.environ['GLT_POSTMORTEM_DIR']
      else:
        os.environ['GLT_POSTMORTEM_DIR'] = old_dir
    series = bundle.get('timeseries', {}).get('series', {})
    if not series or 'telemetry.smoke' not in rendered:
      raise AssertionError('the post-mortem bundle lacks its rings')

    # the regression gate over this run's figures
    off_ms = runs['off']['batch_ms']
    seeds_per_sec = TELEMETRY.get(
        'seeds_per_sec', n * MESH_BATCH * MESH_PARTS / (sum(off_ms) / 1e3))
    dist = {'seeds_per_sec': seeds_per_sec}
    if TELEMETRY.get('serving'):
      dist['serving'] = dict(TELEMETRY['serving'])
    if TELEMETRY.get('scale_envelope'):
      dist['scale_envelope'] = TELEMETRY['scale_envelope']
    for row in ('chaos', 'resume'):         # the host group's rows
      if TELEMETRY.get(row):
        dist[row] = dict(TELEMETRY[row])
    art = {'metric': 'dist.seeds_per_sec', 'dist': dist}
    art_path = sink.write_artifact(art, os.path.join(tmp, 'artifact.json'))
    base = os.path.join(tmp, 'baseline.json')
    checks = []
    worse = json.loads(json.dumps(art))
    worse['dist']['seeds_per_sec'] = seeds_per_sec / 1.3
    for a in (art_path, art_path, worse):
      verdict, rc = regress.check(a, base)
      checks.append({'rc': rc, 'summary': regress.summary(verdict),
                     'regressed': verdict['regressed'],
                     'report': regress.format_report(verdict)})
    # the second check passes unless the serve phase reported the
    # tracing gate missed: then its pinned line, and only it, fails
    missed = 'tracing_overhead_ratio' in TELEMETRY.get('gates_missed', [])
    second = (['dist.serving.tracing_overhead_ratio'] if missed else [])
    if ([c['rc'] for c in checks] != [0, int(missed), 1]
        or checks[1]['regressed'] != second or not (
            checks[0]['summary'] == 'BASELINE_CREATED'
            and checks[2]['summary'].startswith('FAIL dist.seeds_per_sec'))):
      raise AssertionError(f'regression gate {checks}')
    guarded = [ln for ln in checks[1]['report'].splitlines()
               if ln.startswith('  [ ok ]')]
    stage_ms = {k: hists[k].secs / hists[k].count * 1e3
                for k in TELEMETRY_STAGES + ('exchange.layout',)
                if k in hists}
    out = {'store_secs': store_secs,
           'batch_ms': {'recorder_off': off_ms,
                        'recorder_on': runs['on']['batch_ms']},
           'launches': runs['on']['launches'],
           'launches_per_batch': {k: v / n for k, v in
                                  runs['on']['launches'].items()},
           'plain_calls': runs['on']['plain'],
           'digests_equal': True, 'flight_events': len(events),
           'stage_rows': counts, 'stage_ms': stage_ms,
           'stage_table': table.splitlines(),
           'chrome_events': written, 'chrome_slices': slices,
           'postmortem': {'bytes': os.path.getsize(bundle_path),
                          'events': len(bundle['events']),
                          'series': len(series),
                          'rendered_lines': len(rendered.splitlines())},
           'artifact_keys': [m[0] for m in regress.METRICS
                             if regress._get(art, m[0]) is not None],
           'summary_line': sink.summary_line(art, artifact='artifact.json'),
           'regress_rc': [c['rc'] for c in checks],
           'bench_gates_missed': TELEMETRY.get('gates_missed', []),
           'regress_summary': [c['summary'] for c in checks],
           'regress_guarded_ok': len(guarded),
           'figures': {
               'tracing_overhead_ratio': TELEMETRY.get('serving', {}).get(
                   'tracing_overhead_ratio'),
               'routed_tracing_ratio': TELEMETRY.get('routed_tracing_ratio'),
               'ms_per_ops_scrape': ms_summary(TELEMETRY.get('scrape_ms',
                                                             [])),
               'fleet': TELEMETRY.get('fleet')},
           'wall_secs': time.perf_counter() - t_group}
    emit('telemetry', **out)
    return out
  finally:
    shutil.rmtree(tmp, ignore_errors=True)


# -- the host runtime: mp producers, server-client RPC, the serve RPC ------
HOST_WORKERS = 4                    # the main path's sampling workers
HOST_BATCHES = 32                   # an epoch over a fixed train subset (depth cut)
HOST_SLOT_BYTES = 384 << 20         # one channel slot (a message is ~0.25 GB)
HOST_CAPACITY = 8                   # channel slots: two a worker
HOST_DIGEST_SEQS = (0, 13, 31)      # batches recomputed in the parent
CHAOS_NODES = 5000                  # bench_dist_loader.chaos_smoke's row
CHAOS_DIM = 32
CHAOS_BATCH = 64
CHAOS_FANOUTS = (10, 5)
CHAOS_EPOCHS = 3
RESUME_NODES = 2048                 # bench_dist_loader.resume_smoke's row
RESUME_BATCH = 64
RESUME_FANOUTS = (5, 5)
SERVE_RPC_REQUESTS = 48
SERVE_RPC_DROPPED = 4               # serve RPCs sent under a drop fault
SWAP_ATOL = 1e-4                    # hot_swap's parity tolerance (default)


def bench_graph(n, avg_deg=AVG_DEG, seed=0):
  """`benchmarks/common.py`'s ``build_graph`` recipe in numpy (uniform
  sources; targets uniform or, 30%, squared-uniform hubs)."""
  rng = np.random.default_rng(seed)
  e = n * avg_deg
  rows = rng.integers(0, n, e, dtype=np.int64)
  hubs = rng.random(e) < 0.3
  cols = np.where(hubs, (rng.random(e) ** 2 * n).astype(np.int64),
                  rng.integers(0, n, e, dtype=np.int64))
  return rows, cols.astype(np.int64)


def host_mp_train(torch, ops, indptr, indices, feats, tmp) -> dict:
  """The main path of the host runtime: the products graph as a
  `HostDataset` staged into POSIX shared memory, `DistNeighborLoader`
  with 4 ``forkserver`` sampling workers feeding a shm channel (batch
  1,024, fanouts [15, 10, 5]), collated onto the card, and the
  ``GraphSAGE(100, 256, 47, 3)`` step of the ``train`` phase.  One warm
  epoch, then one timed epoch, each of `HOST_BATCHES` batches over a
  fixed subset of the train split.  Gates: exactly the expected batches
  and no duplicate ``#SEQ`` each epoch, the loss falls, the batches of
  `HOST_DIGEST_SEQS` digest-equal to the same ``(epoch, seq)`` sampled
  again in this process (batch seed ``(epoch * 1000003 + seq) *
  131071``), every collate span linked to a worker's ``producer.sample``
  span, no message past its slot."""
  from graphlearn_tpu_torch.distributed import (DistNeighborLoader,
                                                HostDataset,
                                                HostNeighborSampler,
                                                MpDistSamplingWorkerOptions)
  from graphlearn_tpu_torch.models import GraphSAGE, make_supervised_step
  from graphlearn_tpu_torch.telemetry import recorder
  t0 = time.perf_counter()
  labels = make_labels(torch, feats)
  ds = HostDataset(indptr.cpu().numpy(), indices.cpu().numpy(),
                   node_features=feats.cpu().numpy(),
                   node_labels=labels.cpu().numpy())
  del labels
  host_secs = time.perf_counter() - t0
  seeds = train_splits()[0][:HOST_BATCHES * TRAIN_BATCH]
  opts = MpDistSamplingWorkerOptions(
      num_workers=HOST_WORKERS, channel_capacity=HOST_CAPACITY,
      channel_size=HOST_CAPACITY * HOST_SLOT_BYTES,
      mp_start_method='forkserver')
  flight = os.path.join(tmp, 'workers.jsonl')
  t0 = time.perf_counter()
  old = os.environ.get('GLT_TELEMETRY_JSONL')
  os.environ['GLT_TELEMETRY_JSONL'] = flight   # the workers' recorder
  try:
    loader = DistNeighborLoader(ds, FANOUTS, seeds, batch_size=TRAIN_BATCH,
                                shuffle=True, worker_options=opts,
                                device=DEVICE, seed=0)
  finally:
    if old is None:
      del os.environ['GLT_TELEMETRY_JSONL']
    else:
      os.environ['GLT_TELEMETRY_JSONL'] = old
  init_secs = time.perf_counter() - t0
  producer = loader._producer
  shm_dataset = sum(s.size for s in producer._shm_segs)
  try:
    model = GraphSAGE(FEAT_DIM, 256, GNS_CLASSES, num_layers=3).to(DEVICE)
    model.reset_parameters(torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(model.parameters(), lr=TRAIN_LR, eps=1e-8)
    step = make_supervised_step(model, opt, TRAIN_BATCH)
    sizes, occupancy = [], []
    collate_fn = loader._collate_fn

    def measured_collate(msg):
      sizes.append(sum(np.asarray(v).nbytes for v in msg.values()))
      occupancy.append(loader.channel.occupancy())
      return collate_fn(msg)
    loader._collate_fn = measured_collate

    def key(batch):
      s = batch.batch.cpu().numpy()
      return tuple(sorted(s[s >= 0].tolist()))

    def epoch(keep=()):
      phase0 = dict(loader.phase_secs)
      losses, events, digests = [], [], {}
      t0 = time.perf_counter()
      for batch in loader:
        k = key(batch) if keep else None
        if k in keep:
          digests[k] = digest(torch, [batch.node, batch.edge_index,
                                      batch.x, batch.y])
        if DEVICE == 'cuda':
          start = torch.cuda.Event(enable_timing=True)
          end = torch.cuda.Event(enable_timing=True)
          start.record()
          losses.append(step(batch)[0])
          end.record()
          events.append((start, end))
        else:                         # a CPU rehearsal: host time
          s = time.perf_counter()
          losses.append(step(batch)[0])
          events.append((s, time.perf_counter()))
      sync(torch)
      wall = time.perf_counter() - t0
      if len(losses) != HOST_BATCHES or \
          len(loader._seen_seqs) != HOST_BATCHES:
        raise AssertionError(f'{len(losses)} batches, '
                             f'{len(loader._seen_seqs)} unique #SEQ of '
                             f'{HOST_BATCHES}')
      step_ms = [s.elapsed_time(e) if DEVICE == 'cuda' else (e - s) * 1e3
                 for s, e in events]
      phase = {k: (loader.phase_secs[k] - phase0[k]) * 1e3 / HOST_BATCHES
               for k in phase0}
      return {'wall_secs': wall, 'losses': [float(v) for v in losses],
              'step_ms': step_ms, 'phase_ms': phase, 'digests': digests}

    recorder.enable()
    warm = epoch()
    rng = np.random.default_rng(0)          # the producer's shuffle
    rng.permutation(seeds)
    perm = rng.permutation(seeds)           # the timed epoch's
    want = {tuple(sorted(perm[s * TRAIN_BATCH:(s + 1) * TRAIN_BATCH]
                         .tolist())): s for s in HOST_DIGEST_SEQS}
    recorder.clear()
    timed = epoch(keep=want)
    collates = [e for e in recorder.events('span.begin')
                if e['name'] == 'collate']
    recorder.disable()
    recorder.clear()
    with open(flight) as f:
      produced = {json.loads(ln)['span_id'] for ln in f
                  if '"producer.sample"' in ln and '"span.begin"' in ln}
    linked = sum(1 for e in collates if e.get('producer_span') in produced
                 and e.get('producer_trace'))
    if len(collates) != HOST_BATCHES or linked != HOST_BATCHES:
      raise AssertionError(f'{linked} of {len(collates)} collate spans '
                           'link a producer span')
    # the digest gate: the timed epoch's batches sampled again here
    sampler = HostNeighborSampler(ds, FANOUTS)
    t0 = time.perf_counter()
    for k, s in want.items():
      msg = sampler.sample_from_nodes(
          perm[s * TRAIN_BATCH:(s + 1) * TRAIN_BATCH],
          batch_seed=(1 * 1000003 + s) * 131071)
      b = loader._to_device(collate_fn(msg))
      ref = digest(torch, [b.node, b.edge_index, b.x, b.y])
      if k not in timed['digests'] or not torch.equal(timed['digests'][k],
                                                      ref):
        raise AssertionError(f'batch seq {s} differs from its recompute')
    recompute_secs = time.perf_counter() - t0
    first = np.mean(warm['losses'][:8])
    last = np.mean(timed['losses'][-8:])
    if not last < first:
      raise AssertionError(f'loss did not fall: {first} -> {last}')
    if max(sizes) > loader.channel.slot_bytes:
      raise AssertionError('a message outgrew its slot')
    wall = timed['wall_secs']
    busy_ms = sum(timed['step_ms']) + timed['phase_ms']['copy'] * \
        HOST_BATCHES
    out = {
        'workers': HOST_WORKERS, 'start_method': 'forkserver',
        'batch': TRAIN_BATCH, 'fanouts': list(FANOUTS),
        'batches_an_epoch': HOST_BATCHES,
        'model': 'GraphSAGE(100, 256, 47, 3)',
        'host_copy_secs': host_secs, 'loader_init_secs': init_secs,
        'warm_epoch_secs': warm['wall_secs'],
        'timed_epoch_secs': wall,
        'seeds_per_sec': HOST_BATCHES * TRAIN_BATCH / wall,
        'ms_per_batch': {'recv': timed['phase_ms']['recv'],
                         'collate': timed['phase_ms']['collate'],
                         'copy': timed['phase_ms']['copy'],
                         'step': float(np.mean(timed['step_ms'])),
                         'wall': wall * 1e3 / HOST_BATCHES},
        'warm_ms_per_batch': {k: v for k, v in warm['phase_ms'].items()},
        'device_idle_share': 1.0 - busy_ms / (wall * 1e3),
        'message_bytes': {'mean': float(np.mean(sizes)),
                          'max': int(max(sizes)), 'min': int(min(sizes))},
        'slot_bytes': int(loader.channel.slot_bytes),
        'channel_capacity': int(loader.channel.capacity),
        'channel_occupancy': {'mean': float(np.mean(occupancy)),
                              'max': int(max(occupancy))},
        'shm_bytes': {'dataset': int(shm_dataset),
                      'channel': int(loader.channel.capacity
                                     * loader.channel.slot_bytes)},
        'loss_first8': float(first), 'loss_last8': float(last),
        'unique_seqs': HOST_BATCHES, 'digest_equal_seqs':
            list(HOST_DIGEST_SEQS), 'recompute_secs': recompute_secs,
        'collate_spans_linked': linked}
  finally:
    loader.shutdown()
  emit('host_mp_train', **out)
  return out


def chaos_server(port_q, n, dim, jsonl, worker_plan):
  """The chaos row's sampling server (a spawned process): the producer
  workers inherit ``worker_plan`` and the telemetry sink."""
  os.environ['GLT_FAULT_PLAN'] = worker_plan
  os.environ['GLT_TELEMETRY_JSONL'] = jsonl
  from graphlearn_tpu_torch.distributed import (HostDataset, init_server,
                                                wait_and_shutdown_server)
  from graphlearn_tpu_torch.telemetry import recorder
  recorder.enable(jsonl)
  rows, cols = bench_graph(n)
  feats = np.random.default_rng(0).standard_normal((n, dim)).astype(
      np.float32)
  ds = HostDataset.from_coo(rows, cols, n, node_features=feats)
  srv = init_server(num_servers=1, num_clients=1, rank=0, dataset=ds,
                    host='127.0.0.1', port=0)
  port_q.put(srv.port)
  wait_and_shutdown_server(timeout=600)


def spawn_server(target, *args) -> dict:
  """Start ``target(port_q, *args)`` in a spawned process (it puts its
  address on ``port_q`` once it serves)."""
  import multiprocessing as mp
  ctx = mp.get_context('spawn')
  port_q = ctx.Queue()
  proc = ctx.Process(target=target, args=(port_q, *args), daemon=False)
  proc.start()
  return {'proc': proc, 'port_q': port_q, 't0': time.perf_counter()}


def stop_server(srv, timeout=120) -> None:
  srv['proc'].join(timeout=timeout)
  if srv['proc'].is_alive():
    srv['proc'].terminate()
    srv['proc'].join(timeout=10)


def start_chaos_server(tmp) -> dict:
  jsonl = os.path.join(tmp, 'chaos_server.jsonl')
  worker_plan = (f'producer.worker:kill:2:worker=0:epoch={CHAOS_EPOCHS}:'
                 'generation=0')
  srv = spawn_server(chaos_server, CHAOS_NODES, CHAOS_DIM, jsonl,
                     worker_plan)
  srv['jsonl'] = jsonl
  return srv


def chaos_row(torch, srv) -> dict:
  """`bench_dist_loader.py --chaos` rebuilt: a spawned server (5,000
  nodes, dim 32), a remote loader (batch 64, [10, 5], 2 workers,
  prefetch 2) collating onto the card; epoch 0 warms, epochs 1-2 are
  timed with the retry layer on and no fault; then one chaos epoch:
  worker 0 killed server-side before its 2nd batch, the 2nd fetch's
  connection dropped after the send, the 4th delayed 0.5 s.  The row's
  ``ok``: received = expected = unique seqs, at least one retry,
  ``producer.restart`` and ``fault.injected`` in the server's log.
  ``srv`` is the server `start_chaos_server` started."""
  from graphlearn_tpu_torch.distributed import (
      DistNeighborLoader, RemoteDistSamplingWorkerOptions, init_client,
      shutdown_client)
  from graphlearn_tpu_torch.distributed.dist_loader import DistLoader
  from graphlearn_tpu_torch.telemetry import recorder
  from graphlearn_tpu_torch.testing import chaos
  n_seeds = CHAOS_BATCH * 32
  n_batches = n_seeds // CHAOS_BATCH
  jsonl, proc = srv['jsonl'], srv['proc']
  poll = DistLoader.RECV_POLL_SECS
  try:
    port = srv['port_q'].get(timeout=300)
    start_secs = time.perf_counter() - srv['t0']
    init_client([('127.0.0.1', port)], rank=0, num_clients=1)
    recorder.enable()
    DistLoader.RECV_POLL_SECS = 2.0
    loader = DistNeighborLoader(
        None, list(CHAOS_FANOUTS), np.arange(n_seeds) % CHAOS_NODES,
        batch_size=CHAOS_BATCH, shuffle=True,
        worker_options=RemoteDistSamplingWorkerOptions(
            server_rank=0, num_workers=2, prefetch_size=2),
        device=DEVICE, seed=0)
    for _ in loader:                 # epoch 0 warms the pipeline
      pass
    t0 = time.perf_counter()
    timed = 0
    for _ in range(CHAOS_EPOCHS - 1):
      for _ in loader:
        timed += 1
    dt = time.perf_counter() - t0
    base_retries = len(recorder.events('rpc.retry'))
    chaos.install('rpc.request:drop:2:op=fetch_one_sampled_message;'
                  'rpc.request:delay:4:op=fetch_one_sampled_message:'
                  'secs=0.5')
    got = sum(1 for _ in loader)
    seen = set(loader.channel._seen_seqs)
    dup = loader.channel.duplicates_discarded
    retries = len(recorder.events('rpc.retry')) - base_retries
    fired = chaos.active().exhausted()
    chaos.uninstall()
    loader.shutdown()
    shutdown_client()
  finally:
    chaos.uninstall()
    recorder.disable()
    recorder.clear()
    DistLoader.RECV_POLL_SECS = poll
    stop_server(srv)
  with open(jsonl) as f:
    events = f.read()
  row = {'metric': 'dist_chaos_smoke', 'batch': CHAOS_BATCH,
         'num_nodes': CHAOS_NODES, 'epochs_fault_free': CHAOS_EPOCHS,
         'server_ready_secs': start_secs,
         'fault_free_seeds_per_sec': timed * CHAOS_BATCH / dt,
         'chaos_epoch': {
             'expected_batches': n_batches, 'received_batches': got,
             'unique_seqs': len(seen), 'duplicates_discarded': int(dup),
             'rpc_retries': retries, 'client_faults_fired': fired,
             'producer_restart_logged':
                 '"kind": "producer.restart"' in events,
             'fault_injected_logged': '"kind": "fault.injected"' in events},
         'server_exitcode': proc.exitcode}
  row['ok'] = bool(got == n_batches and len(seen) == n_batches
                   and retries >= 1 and fired
                   and row['chaos_epoch']['producer_restart_logged']
                   and row['chaos_epoch']['fault_injected_logged'])
  emit('chaos_row', **row)
  if not row['ok'] or proc.exitcode != 0:
    raise AssertionError(f'chaos row failed: {row}')
  return row


def resume_ring(n):
  """`bench_dist_loader.resume_smoke`'s ring: v -> v+1, v+2; feature row
  = the id (16 wide); label = id % 4."""
  from graphlearn_tpu_torch.distributed import HostDataset
  rows = np.repeat(np.arange(n), 2)
  cols = np.stack([(np.arange(n) + 1) % n,
                   (np.arange(n) + 2) % n], 1).reshape(-1)
  feats = np.tile(np.arange(n, dtype=np.float32)[:, None], (1, 16))
  return HostDataset.from_coo(rows, cols, n, node_features=feats,
                              node_labels=np.arange(n) % 4)


def resume_row(torch, tmp) -> dict:
  """`bench_dist_loader.py --resume` rebuilt on the mp producer path
  (2,048 nodes, batch 64, [5, 5], 2 spawn workers, collated onto the
  card): three rounds of a no-snapshot epoch against an epoch saving a
  snapshot every `snapshot_every_from_env(8)` batches (the minimum of
  each), then the kill -> restore -> finish loop in a fresh loader.
  The row's ``ok``: consumed + resumed = the epoch's batches and
  replayed >= consumed."""
  from graphlearn_tpu_torch.distributed import (DistNeighborLoader,
                                                MpDistSamplingWorkerOptions)
  from graphlearn_tpu_torch.utils.checkpoint import (
      SnapshotManager, snapshot_every_from_env)
  n = RESUME_NODES
  ds = resume_ring(n)

  def make_loader():
    return DistNeighborLoader(
        ds, list(RESUME_FANOUTS), np.arange(n), batch_size=RESUME_BATCH,
        shuffle=True, worker_options=MpDistSamplingWorkerOptions(
            num_workers=2, mp_start_method='spawn'),
        device=DEVICE, seed=7)

  n_batches = (n + RESUME_BATCH - 1) // RESUME_BATCH
  root = os.path.join(tmp, 'resume')
  loader = make_loader()
  try:
    for _ in loader:                  # warm the producer pool
      pass
    every = snapshot_every_from_env(default=8)
    snap = SnapshotManager(root + '/overhead', every=every)
    nosnap_secs = snap_secs = float('inf')
    for _ in range(3):
      t0 = time.perf_counter()
      for _ in loader:
        pass
      nosnap_secs = min(nosnap_secs, time.perf_counter() - t0)
      t0 = time.perf_counter()
      seen = 0
      for _ in loader:
        seen += 1
        if snap.due():
          snap.save(loader.state_dict(), {'epoch': 2, 'next_chunk': seen})
      snap_secs = min(snap_secs, time.perf_counter() - t0)
    consumed = n_batches // 2
    it = iter(loader)
    for _ in range(consumed):
      next(it)
    SnapshotManager(root + '/resume', every=1).save(
        loader.state_dict(), {'epoch': 3, 'next_chunk': consumed})
  finally:
    loader.shutdown()                 # the preemption
  resumed = make_loader()
  try:
    t0 = time.perf_counter()
    payload = SnapshotManager(root + '/resume').restore_latest()
    resumed.load_state_dict(payload['plane'])
    restore_secs = time.perf_counter() - t0
    rest = sum(1 for _ in resumed.resume_epoch())
    replayed = int(getattr(resumed, 'replayed_discarded', 0))
  finally:
    resumed.shutdown()
  rate_nosnap = n / nosnap_secs
  rate_snap = n / snap_secs
  row = {'metric': 'dist_resume_smoke', 'batch': RESUME_BATCH,
         'num_nodes': n, 'snapshot_every': every,
         'restore_secs': restore_secs, 'replayed_batches': replayed,
         'resumed_batches': rest, 'consumed_before_kill': consumed,
         'seeds_per_sec_nosnap': rate_nosnap,
         'seeds_per_sec_snap': rate_snap,
         'snapshot_overhead_pct': 100.0 * (snap_secs - nosnap_secs)
         / nosnap_secs,
         'snap_over_nosnap_ratio': rate_snap / rate_nosnap,
         'ok': bool(consumed + rest == n_batches and replayed >= consumed)}
  emit('resume_row', **row)
  if not row['ok']:
    raise AssertionError(f'resume row failed: {row}')
  return row


class _ServeStubDataset:
  """The serving server builds no producer: a shape-only dataset."""
  num_nodes = NUM_NODES
  num_edges = NUM_NODES * AVG_DEG
  node_features = None
  node_labels = None


def serve_engine(torch, indptr, indices, feats):
  """The `serve` phase's engine over the products graph on the card:
  ``TreeSAGE(100, 256, 47, 3)`` with params from ``Generator()
  .manual_seed(0)``, buckets `BUCKETS`, seed 0, warmed."""
  from graphlearn_tpu_torch.data import Dataset
  from graphlearn_tpu_torch.models import TreeSAGE
  from graphlearn_tpu_torch.serving import ServingEngine
  ds = (Dataset().init_graph((indptr, indices), layout='CSR',
                             num_nodes=NUM_NODES, device=DEVICE)
        .init_node_features(feats, device=DEVICE))
  eng = ServingEngine(ds, FANOUTS, model=TreeSAGE(FEAT_DIM, 256, 47, 3),
                      seed=0, buckets=BUCKETS, device=DEVICE)
  eng.init_params(torch.Generator().manual_seed(0))
  eng.warmup()
  return eng


def serve_rpc_server(port_q, out_q, device, num_nodes):
  """The serve RPC's server (a spawned process): the products graph and
  its features made on this process's card from the main run's seeds, a
  `ServingFrontend` attached to a `DistServer`, an ops endpoint for the
  trace; on exit it returns its kernel launch counts since the warmup.
  ``device`` and ``num_nodes`` are the parent's settings."""
  global DEVICE, NUM_NODES
  DEVICE, NUM_NODES = device, num_nodes
  import torch
  from graphlearn_tpu_torch import _build, ops
  from graphlearn_tpu_torch.distributed import (init_server,
                                                wait_and_shutdown_server)
  from graphlearn_tpu_torch.serving import ServingFrontend
  from graphlearn_tpu_torch.telemetry import OpsServer
  if DEVICE == 'cuda':
    _build.build_all()
  indptr, indices = products_graph(torch, DEVICE)
  feats = torch.randn(NUM_NODES, FEAT_DIM, device=DEVICE,
                      generator=torch.Generator(device=DEVICE).manual_seed(1))
  eng = serve_engine(torch, indptr, indices, feats)
  fe = ServingFrontend(eng, max_wait_ms=2.0, default_deadline_ms=10_000.0)
  srv = init_server(num_servers=1, num_clients=1, rank=0,
                    dataset=_ServeStubDataset(), host='127.0.0.1', port=0)
  srv.dataset.num_nodes = NUM_NODES
  srv.attach_serving(fe)
  ops_srv = OpsServer(port=0, host='127.0.0.1')
  reset_counts(ops)
  port_q.put((srv.port, ops_srv.url, os.getpid()))
  wait_and_shutdown_server(timeout=600)
  launches, plain = read_counts(ops)
  stats = fe.stats()
  ops_srv.close()
  out_q.put({'launches': launches, 'plain': plain,
             'dispatches': stats['dispatches'],
             'served_requests': stats['served_requests']})


def start_serve_server() -> dict:
  import multiprocessing as mp
  out_q = mp.get_context('spawn').Queue()
  srv = spawn_server(serve_rpc_server, out_q, DEVICE, NUM_NODES)
  srv['out_q'] = out_q
  return srv


def serve_rpc(torch, ops, indptr, indices, feats, srv) -> dict:
  """`tests/test_serving_rpc.py`'s contract at products scale: a spawned
  server runs a `ServingFrontend` on the card; this process routes
  `SERVE_RPC_REQUESTS` requests (1-16 seeds) through a `FleetRouter`
  over one `RemoteReplica` and one `LocalReplica` (an identical engine
  here).  Gates: every answer equals this process's `offline_reference`
  (nodes byte-equal, logits within 1e-5); a traced request's
  ``serving.rpc`` span, fetched from the server's ops endpoint, sits
  under the router's root in another process; serve RPCs sent under
  ``rpc.request`` drops are admitted once each; a `swap_model` of
  numpy params over the wire passes its parity probe (``atol`` 1e-4,
  `hot_swap`'s default: the card's logits differ across bucket shapes,
  so 0 fails) and the answers follow; the server's K1 and K2 launch
  counts are non-zero with 0 plain calls.  ``srv`` is the server
  `start_serve_server` started."""
  from graphlearn_tpu_torch.distributed import init_client, shutdown_client
  from graphlearn_tpu_torch.models import TreeSAGE
  from graphlearn_tpu_torch.serving import (FleetRouter, LocalReplica,
                                            RemoteReplica, ServingFrontend)
  from graphlearn_tpu_torch.telemetry import recorder, tracer
  from graphlearn_tpu_torch.telemetry.federation import FleetScraper
  from graphlearn_tpu_torch.testing import chaos
  proc = srv['proc']
  eng = serve_engine(torch, indptr, indices, feats)
  local = ServingFrontend(eng, max_wait_ms=2.0, default_deadline_ms=10_000.0)
  routers = []
  try:
    port, ops_url, server_pid = srv['port_q'].get(timeout=300)
    start_secs = time.perf_counter() - srv['t0']
    client = init_client([('127.0.0.1', port)], rank=0, num_clients=1)
    remote = RemoteReplica('remote', client, 0, ops_url=ops_url)
    router = FleetRouter([remote, LocalReplica('local', local)],
                         auto_start=False)
    routers.append(router)
    rng = np.random.default_rng(5)
    reqs = [rng.integers(0, NUM_NODES, int(rng.integers(1, 17)))
            for _ in range(SERVE_RPC_REQUESTS)]

    def check(answers, seeds_list, what):
      worst = 0.0
      for i, (res, seeds) in enumerate(zip(answers, seeds_list)):
        ref = eng.offline_reference(seeds)
        nodes = np.asarray(res['nodes'] if isinstance(res, dict)
                           else res.nodes)
        logits = np.asarray(res['logits'] if isinstance(res, dict)
                            else res.logits)
        if nodes.tobytes() != ref.nodes.tobytes():
          raise AssertionError(f'{what} {i}: nodes differ from offline')
        np.testing.assert_allclose(logits, ref.logits, rtol=1e-5,
                                   atol=1e-5)
        worst = max(worst, float(np.abs(logits - ref.logits).max()))
      return worst

    t0 = time.perf_counter()
    futs = [router.submit(r) for r in reqs]
    answers = [f.result(60.0) for f in futs]
    routed_secs = time.perf_counter() - t0
    worst = check(answers, reqs, 'routed request')
    hb = client.heartbeat(0)
    remote_served = hb['serving']['served_requests']
    if remote_served == 0:
      raise AssertionError('the remote replica served no request')
    # a traced request through the remote replica alone
    tracer.configure(sample=1, slow_ms=0.0, buffer=64)
    tracer.clear()
    traced = FleetRouter([remote], auto_start=False)
    routers.append(traced)
    check([traced.infer(reqs[0], timeout=60)], [reqs[0]], 'traced request')
    tid = tracer.traces()[0]['trace_id']
    fs = FleetScraper()
    fs.add_url('remote', ops_url)
    spans = {s['name']: s for s in fs.fetch_trace(tid)}
    tracer.configure(sample=0)
    root, rpc_span = spans.get('serving.route'), spans.get('serving.rpc')
    wait = spans.get('serving.queue_wait')
    if (root is None or rpc_span is None or wait is None
        or root['span_id'] != tid or rpc_span['parent_id'] != tid
        or rpc_span['pid'] != server_pid or root['pid'] == server_pid
        or wait['parent_id'] != rpc_span['span_id']):
      raise AssertionError(f'the serving.rpc span: {spans}')
    # exactly once under dropped connections
    admitted0 = client.heartbeat(0)['serving']['admitted']
    recorder.enable()
    chaos.install(';'.join(f'rpc.request:drop:{i}:op=serve_infer'
                           for i in range(1, 2 * SERVE_RPC_DROPPED, 2)))
    dropped = [client.serve(r) for r in reqs[:SERVE_RPC_DROPPED]]
    fired = chaos.active().exhausted()
    chaos.uninstall()
    retries = len(recorder.events('rpc.retry'))
    recorder.disable()
    recorder.clear()
    admitted = client.heartbeat(0)['serving']['admitted'] - admitted0
    check(dropped, reqs[:SERVE_RPC_DROPPED], 'dropped request')
    if not fired or retries < SERVE_RPC_DROPPED or \
        admitted != SERVE_RPC_DROPPED:
      raise AssertionError(f'exactly-once: fired {fired}, {retries} '
                           f'retries, {admitted} admitted')
    # a hot swap over the wire: numpy params, loaded on the server's card
    m = TreeSAGE(FEAT_DIM, 256, 47, 3)
    m.reset_parameters(torch.Generator().manual_seed(1))
    cand = {k: v.numpy() for k, v in m.state_dict().items()}
    swap = client.swap_model(cand, version=2)
    if swap['version'] != 2 or not swap['parity_max_err'] <= SWAP_ATOL:
      raise AssertionError(f'swap over the wire: {swap}')
    eng.set_params(cand, version=2)
    after = [client.serve(r) for r in reqs[-8:]]
    check(after, reqs[-8:], 'swapped request')
  finally:
    chaos.uninstall()
    tracer.configure(sample=0)
    for r in routers:
      r.close()
    local.shutdown()
    shutdown_client()
  server = srv['out_q'].get(timeout=120)
  stop_server(srv)
  lk = server['launches']
  if lk['sample_one_hop'] == 0 or lk['gather_rows'] == 0 or server['plain']:
    raise AssertionError(f'the server\'s kernels: {server}')
  disp = max(int(server['dispatches'] or 0), 1)
  out = {'requests': SERVE_RPC_REQUESTS, 'server_ready_secs': start_secs,
         'routed_secs': routed_secs,
         'remote_served_requests': int(remote_served),
         'offline_logits_max_abs_diff': worst,
         'trace': {'spans': len(spans), 'rpc_pid': rpc_span['pid'],
                   'route_pid': root['pid']},
         'dropped_requests': SERVE_RPC_DROPPED, 'rpc_retries': retries,
         'admitted_under_drops': int(admitted),
         'swap': {'version': swap['version'],
                  'parity_max_err': swap['parity_max_err'],
                  'parity_atol': SWAP_ATOL},
         'server_launches': lk, 'server_plain_calls': server['plain'],
         'server_dispatches': server['dispatches'],
         'server_launches_per_dispatch': {
             'sample_one_hop': lk['sample_one_hop'] / disp,
             'gather_rows': lk['gather_rows'] / disp},
         'server_exitcode': proc.exitcode}
  emit('serve_rpc', **out)
  return out


def host_regress(dist: dict, tmp) -> dict:
  """The regression gate over the host rows' four keys (the JAX
  package's ``dist.chaos.*`` / ``dist.resume.*``): a first check
  creates the baseline (rc 0), a second passes with every key guarded
  (rc 0), a copy with ``dist.chaos.fault_free_seeds_per_sec`` 30% lower
  fails naming it (rc 1)."""
  from graphlearn_tpu_torch.telemetry import regress, sink
  art = {'metric': 'dist.chaos.fault_free_seeds_per_sec', 'dist': dist}
  path = sink.write_artifact(art, os.path.join(tmp, 'host_artifact.json'))
  base = os.path.join(tmp, 'host_baseline.json')
  worse = json.loads(json.dumps(art))
  worse['dist']['chaos']['fault_free_seeds_per_sec'] /= 1.3
  checks = []
  for a in (path, path, worse):
    verdict, rc = regress.check(a, base)
    checks.append({'rc': rc, 'summary': regress.summary(verdict),
                   'regressed': verdict['regressed'],
                   'report': regress.format_report(verdict)})
  keys = HOST_REGRESS_KEYS
  guarded = [k for k in keys if any(
      ln.startswith('  [ ok ]') and k in ln
      for ln in checks[1]['report'].splitlines())]
  if ([c['rc'] for c in checks] != [0, 0, 1] or guarded != list(keys)
      or checks[2]['regressed'] != [keys[0]]
      or checks[0]['summary'] != 'BASELINE_CREATED'):
    raise AssertionError(f'host regression gate {checks}')
  return {'regress_rc': [c['rc'] for c in checks],
          'regress_summary': [c['summary'] for c in checks],
          'guarded_keys': guarded}


HOST_REGRESS_KEYS = ('dist.chaos.fault_free_seeds_per_sec',
                     'dist.resume.restore_secs',
                     'dist.resume.replayed_batches',
                     'dist.resume.snap_over_nosnap_ratio')


def host_group(torch, ops, indptr, indices, feats) -> dict:
  """The host runtime on the card (`--host`, and in the whole run before
  `telemetry`): `host_mp_train`, `chaos_row`, `resume_row`, `serve_rpc`
  and the regression gate over the rows' keys; one ``host_group`` line
  with the shm limits this machine gives and the group's wall time."""
  import shutil
  import tempfile
  t0 = time.perf_counter()
  st = os.statvfs('/dev/shm')
  limits = {'dev_shm_bytes': st.f_bsize * st.f_blocks}
  for k in ('shmmax', 'shmall', 'shmmni'):
    try:
      with open(f'/proc/sys/kernel/{k}') as f:
        limits[k] = int(f.read().split()[0])
    except (OSError, ValueError):
      limits[k] = None
  tmp = tempfile.mkdtemp(prefix='glt_host_')
  # both servers start now: their imports, graph and warmup overlap the
  # main path's staging and warm epoch, not its timed epoch
  servers = [start_serve_server(), start_chaos_server(tmp)]
  try:
    out = {'mp_train': host_mp_train(torch, ops, indptr, indices, feats,
                                     tmp)}
    out['chaos'] = chaos_row(torch, servers[1])
    out['resume'] = resume_row(torch, tmp)
    out['serve_rpc'] = serve_rpc(torch, ops, indptr, indices, feats,
                                 servers[0])
    TELEMETRY['chaos'] = {'fault_free_seeds_per_sec':
                          out['chaos']['fault_free_seeds_per_sec']}
    TELEMETRY['resume'] = {k: out['resume'][k] for k in (
        'restore_secs', 'replayed_batches', 'snap_over_nosnap_ratio')}
    gate = host_regress({'chaos': dict(TELEMETRY['chaos']),
                         'resume': dict(TELEMETRY['resume'])}, tmp)
  finally:
    for srv in servers:             # a phase that failed left it serving
      if srv['proc'].is_alive():
        srv['proc'].terminate()
        srv['proc'].join(timeout=10)
    shutil.rmtree(tmp, ignore_errors=True)
  emit('host_group', shm_limits=limits, regress=gate,
       wall_secs=time.perf_counter() - t0)
  out['regress'] = gate
  return out


def main(argv) -> int:
  t_start = time.perf_counter()
  import torch
  if not torch.cuda.is_available():
    print('chip_smoke: CUDA is not available', file=sys.stderr)
    return 2
  root = os.path.dirname(os.path.abspath(__file__))
  sys.path.insert(0, root)
  # the phases that count recorder events (publishes, swaps, redrives,
  # adoptions) run beside serving traffic, whose requests and dispatches
  # emit their own events: a ring of `RECORDER_EVENTS` keeps them all
  os.environ.setdefault('GLT_TELEMETRY_EVENTS', str(RECORDER_EVENTS))
  try:
    import graphlearn_tpu_torch  # noqa: F401
  except ImportError as e:
    print(f'chip_smoke: the graphlearn_tpu_torch package is not beside '
          f'this script ({e})', file=sys.stderr)
    return 2
  if argv[:1] == ['--aot-child']:
    return aot_child(argv[1])

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
  if kernels is None:               # --k6 / --fused: some phases alone
    return 0
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

  timer = Timer(torch)
  if '--autoscale-bench' in argv:
    autoscale_bench_repeats(
        torch, ops, int(argv[argv.index('--autoscale-bench') + 1]))
    return None
  if '--hetero' in argv:
    hetero_phases(torch, ops, timer, prof='--profile' in argv)
    return None
  if '--mesh-hetero' in argv:
    return mesh_hetero_kernels(mesh_hetero_phases(torch, ops, timer))

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

  if '--fused' in argv:
    fused_phases(torch, ops, timer, indptr, indices, feats, ds,
                 prof='--profile' in argv)
    return None
  if '--resume' in argv:
    resume_phases(torch, ops, timer, indptr, indices, feats, ds)
    return None
  if '--link' in argv:
    del ds
    link_phases(torch, ops, timer, indptr, indices, feats,
                prof='--profile' in argv)
    return None
  if '--edges' in argv:
    del ds
    edges_phases(torch, ops, timer, indptr, indices, feats)
    return None
  ab_source = (argv[argv.index('--gns-ab') + 1] if '--gns-ab' in argv
               else None)
  if '--mesh-link' in argv:
    del ds
    labels = make_labels(torch, feats)
    table = mesh_edge_table(torch, int(indices.numel()))
    ds_u, ds_t = mesh_data(torch, indptr, indices, feats, labels, table)
    ml = mesh_link_phases(torch, ops, timer, ds_u, ds_t, table, indptr,
                          indices, feats, labels, ab_source=ab_source)
    return mesh_link_kernels(ml)
  if '--mesh-engines' in argv:
    del ds
    labels = make_labels(torch, feats)
    ds_u, _ = mesh_data(torch, indptr, indices, feats, labels, tiered=False)
    me = mesh_engines_phases(torch, ops, timer, ds_u, feats, labels, indptr,
                             indices)
    del ds_u
    torch.cuda.empty_cache()
    bi = bipartite_link(torch, ops, timer)
    emit('bipartite_reference', heldout_auc=bi['heldout_auc'],
         step_ms=bi['step_ms'])
    me['hetero_link'] = mesh_hetero_link(torch, ops, timer, bi['heldout_auc'])
    return mesh_engines_kernels(me)
  if '--fleet' in argv:
    del ds
    return fleet_kernels(fleet_group(torch, ops, timer, indptr, indices,
                                     feats))
  if '--failover' in argv:
    del ds
    return failover_kernels(failover_phases(torch, ops, timer, indptr,
                                            indices, feats))
  if '--locality' in argv:
    del ds
    return locality_kernels(locality_group(torch, ops, indptr, indices,
                                           feats, full=True))
  if '--telemetry' in argv:
    del ds
    telemetry_group(torch, ops, indptr, indices, feats)
    return None
  if '--host' in argv:
    del ds
    host_group(torch, ops, indptr, indices, feats)
    return None
  if '--k6' in argv:
    labels = make_labels(torch, feats)
    tiered_phases(torch, ops, timer, indptr, indices, feats, ds, labels,
                  train_splits()[0], full=False)
    return None

  # -- kernel vs plain --------------------------------------------------
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
  tree_launches, tree_hops, tree_levels, tree_fused, tree_f32 = tree_train(
      torch, ops, timer, ds, feats, train_idx, test_idx)
  session_launches, sub_hops, sub_gather = fused_session(
      torch, ops, timer, ds, feats, train_idx, test_idx,
      (tree_fused, tree_f32), prof='--profile' in argv)
  del tree_fused
  train_cross_check(torch)
  torch.cuda.empty_cache()
  # -- snapshots and mid-epoch resume of the captured tree epoch ---------
  rf = resume_fused(torch, ops, Timer(torch, reps=RESUME_CHECK_REPS), ds,
                    feats, train_idx)
  torch.cuda.empty_cache()

  # -- the single-card tiered store and its cold gather (K6) ------------
  link, k6_forced, tserve_launches, k6_serve, ttrain_runs, k6_train = (
      tiered_phases(torch, ops, timer, indptr, indices, feats, ds, labels,
                    train_idx, prof='--profile' in argv))

  # -- GNS-biased training over the tiered store ------------------------
  ds_g = gns_data(torch, indptr, indices, feats, labels)
  gns_launches, gns_hops, gathers_train, gns_forced = gns_train(
      torch, ops, timer, ds_g, feats, labels, prof='--profile' in argv)
  del ds_g
  gns_cross_check(torch)

  # -- the partitioned mesh engine at P = 8 on the card ------------------
  del ds
  torch.cuda.empty_cache()
  table = mesh_edge_table(torch, int(indices.numel()))
  ds_u, ds_t = mesh_data(torch, indptr, indices, feats, labels, table)
  loader_launches, node_table, loader_path = mesh_loader(
      torch, ops, timer, ds_u, feats, labels)
  k5 = k5_kernel(torch, timer, ds_u, node_table)
  del node_table
  fmesh_launches, fmesh_paths = fused_mesh(torch, ops, timer, ds_u)
  fused_mesh_cross_check(torch)
  rfm = resume_fused_mesh(torch, ops, Timer(torch, reps=RESUME_CHECK_REPS),
                          ds_u)
  # -- the mesh's sampled edges and its link engine ---------------------
  ml = mesh_link_phases(torch, ops, timer, ds_u, ds_t, table, indptr,
                        indices, feats, labels, ab_source=ab_source)
  # -- the mesh's subgraph, walk and fused link engines -----------------
  me = mesh_engines_phases(torch, ops, timer, ds_u, feats, labels, indptr,
                           indices)
  del ds_u, table
  ds_t.edge_features = None
  torch.cuda.empty_cache()
  rm = resume_mesh(torch, ops, Timer(torch, reps=RESUME_CHECK_REPS), ds_t,
                   feats, labels, train_idx)
  mesh_launches, mesh_path = mesh_train(torch, ops, timer, ds_t, feats,
                                        labels, train_idx, test_idx,
                                        prof='--profile' in argv)
  del ds_t
  torch.cuda.empty_cache()
  mesh_cross_check(torch)

  # -- heterogeneous graphs: the hetero session and the per-batch HGT ----
  ((het_launches, het_hops, het_gathers),
   (hl_launches, hl_hops, hl_gathers)) = hetero_phases(
       torch, ops, timer, prof='--profile' in argv)

  # -- link prediction and enclosing subgraphs (BASELINE configs 2, 3) --
  link_tr, link_lo, seal_out = link_phases(torch, ops, timer, indptr, indices,
                                           feats, prof='--profile' in argv)
  torch.cuda.empty_cache()

  # -- sampled edge ids, edge features, hetero link and random walks ---
  eo = edges_phases(torch, ops, timer, indptr, indices, feats)
  ed, el, hlk = eo['edges'], eo['edge_loaders'], eo['hetero_link']
  mag_we = hlk['timed']['mag_with_edge_batch']
  hl_what = {'bipartite_step': f'{BI_BATCH}-edge bipartite link step '
                               '(user clicks item, binary)',
             'mag_link_batch': f'{MAG_LINK_BATCH}-edge mag link batch '
                               '(author writes paper, binary)'}

  # -- the hetero mesh's link loader, against the single card's AUC ------
  me['hetero_link'] = mesh_hetero_link(torch, ops, timer,
                                       hlk['bipartite_auc'])
  ek = engines_kernels(me)

  # -- BASELINE config 5: the heterogeneous mesh engine (IGBH, P = 8) ---
  torch.cuda.empty_cache()
  mhk = mesh_hetero_kernels(mesh_hetero_phases(torch, ops, timer))

  # -- the rest of serving: swap, fleet, autoscale, the build cache ------
  torch.cuda.empty_cache()
  fk = fleet_kernels(fleet_group(torch, ops, timer, indptr, indices, feats))

  # -- partition failover and planned handoff on the mesh ----------------
  torch.cuda.empty_cache()
  fok = failover_kernels(failover_phases(torch, ops, timer, indptr, indices,
                                         feats))

  # -- the mesh at P = 16 and 64: layouts, locality, rebalance -----------
  torch.cuda.empty_cache()
  lok = locality_kernels(locality_group(torch, ops, indptr, indices, feats,
                                        full=False))

  # -- the host runtime: mp producers, chaos and resume rows, serve RPC --
  torch.cuda.empty_cache()
  hg = host_group(torch, ops, indptr, indices, feats)

  # -- telemetry: the recorder, report, post-mortem and regression gate -
  torch.cuda.empty_cache()
  telemetry_group(torch, ops, indptr, indices, feats)

  # -- summary ----------------------------------------------------------
  f32 = gathers[0]

  def per_hop(hops):
    return [{'rows': h['rows'], 'k': h['k'], 'ms': h['kernel_ms'],
             'bound_ms': h['bound_us'] / 1e3, 'plain_ms': h['plain_ms']}
            for h in hops]

  def mesh_shape(what, hops):
    return {'shape': f'{what}, {MESH_PARTS} owners a hop, hops of '
                     + '/'.join(str(h['rows']) for h in hops)
                     + ' rows, k ' + '/'.join(str(h['k']) for h in hops),
            'ms': sum(h['kernel_ms'] for h in hops),
            'plain_ms': sum(h['plain_ms'] for h in hops),
            'bound_ms': sum(h['bound_us'] for h in hops) / 1e3,
            'max_abs_err': max(h['max_abs_err'] for h in hops),
            'byte_equal': True, 'hops': per_hop(hops)}

  def hetero_shape(what, hops):
    return {'shape': f'{what}, ' + ', '.join(
                f'hop {h["hop"]} {h["etype"]} {h["rows"]} rows k {h["k"]}'
                for h in hops),
            'ms': sum(h['kernel_ms'] for h in hops),
            'plain_ms': sum(h['plain_ms'] for h in hops),
            'bound_ms': sum(h['bound_us'] for h in hops) / 1e3,
            'max_abs_err': max(h['max_abs_err'] for h in hops),
            'byte_equal': True,
            'hops': [dict(etype=h['etype'], hop=h['hop'], **p)
                     for h, p in zip(hops, per_hop(hops))]}

  def link_shape(what, hops):
    return {'shape': f'{what}, hops of '
                     + '/'.join(str(h['rows']) for h in hops) + ' rows, k '
                     + '/'.join(str(h['k']) for h in hops),
            'ms': sum(h['kernel_ms'] for h in hops),
            'plain_ms': sum(h['plain_ms'] for h in hops),
            'bound_ms': sum(h['bound_us'] for h in hops) / 1e3,
            'max_abs_err': max(h['max_abs_err'] for h in hops),
            'byte_equal': True, 'hops': per_hop(hops)}

  def eid_shape(what, hops):
    return {'shape': f'{what}, hops of '
                     + '/'.join(str(h['rows']) for h in hops) + ' rows, k '
                     + '/'.join(str(h['k']) for h in hops)
                     + ', eids = edge_ids[pos]',
            'ms': sum(h['kernel_ms'] for h in hops),
            'no_eids_ms': sum(h['no_eids_ms'] for h in hops),
            'positions_ms': sum(h['positions_ms'] for h in hops),
            'plain_ms': sum(h['plain_ms'] for h in hops),
            'bound_ms': sum(h['bound_us'] for h in hops) / 1e3,
            'no_eids_bound_ms': sum(h['no_eids_bound_ms'] for h in hops),
            'max_abs_err': max(h['max_abs_err'] for h in hops),
            'byte_equal': True,
            'hops': [{'rows': h['rows'], 'k': h['k'], 'ms': h['kernel_ms'],
                      'no_eids_ms': h['no_eids_ms'],
                      'positions_ms': h['positions_ms'],
                      'bound_ms': h['bound_us'] / 1e3,
                      'no_eids_bound_ms': h['no_eids_bound_ms'],
                      'plain_ms': h['plain_ms']} for h in hops]}

  def gather_shape(what, g):
    return {'shape': f'{what}: {g["ids"]} ids x {g["row_bytes"]} B '
                     f'{g["dtype"]}',
            'ms': g['kernel_ms'], 'plain_ms': g['plain_ms'],
            'bound_ms': g['bound_us'] / 1e3, 'library_ms': g['library_ms'],
            'byte_equal': True}

  mesh_gathers = loader_path['gathers'] + mesh_path['gathers']
  ml_paths = {f'{ph}.{k}': p for ph in ('edges', 'link', 'unsup')
              for k, p in ml[ph]['paths'].items()}
  ml_k1 = [h for k, p in ml_paths.items() for h in p['hops']
           if 'tiered' not in k or 'untiered' in k]
  ml_gns = [h for k, p in ml_paths.items() for h in p['hops']
            if 'tiered' in k and 'untiered' not in k]
  ml_gathers = [g for p in ml_paths.values() for g in p['gathers']]
  ml_kernels = mesh_link_kernels(ml)

  def ml_launches(name):
    return ml_kernels[[k['name'] for k in ml_kernels].index(name)][
        'launches_by_path']
  fmesh_what = {'per_batch': 'fused_mesh per-batch DP loop batch',
                'fused': 'FusedDistEpoch step',
                'tree': 'FusedDistTreeEpoch step (arrival-order frontiers)'}
  fmesh_hops = [h for v in fmesh_paths.values() for h in v['hops']]
  fmesh_gathers = [g for v in fmesh_paths.values() for g in v['gathers']]
  kernels = [
      {'name': 'sample_one_hop', 'route': 'cuda',
       'source': 'graphlearn_tpu_torch/csrc/sample_one_hop.cu',
       'replaces': 'graphlearn_tpu/ops/pallas_sample.py:247',
       'launches': launches['sample_one_hop'],
       'max_abs_err': max(h['max_abs_err']
                          for h in hops + loader_path['hops'] + sub_hops
                          + fmesh_hops + het_hops + hl_hops
                          + link_tr['hops'] + link_lo['hops']
                          + seal_out['hops'] + ed['hops'] + el['hops']
                          + hlk['hops'] + ml_k1 + rf['hops']
                          + rfm['path']['hops']
                          + [{'max_abs_err': mhk[0]['max_abs_err']},
                             {'max_abs_err': ek['k1']['max_abs_err']}]),
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
                            'fused_session': {
                                k: v['sample_one_hop']
                                for k, v in session_launches.items()},
                            'tiered_serve': tserve_launches['sample_one_hop'],
                            'tiered_train': {
                                k: r['launches']['sample_one_hop']
                                for k, r in ttrain_runs.items()},
                            'mesh_loader':
                                loader_launches['sample_one_hop'],
                            'fused_mesh': {
                                k: v['sample_one_hop']
                                for k, v in fmesh_launches.items()},
                            'hetero_train': het_launches['sample_one_hop'],
                            'hetero_loader': hl_launches['sample_one_hop'],
                            'link_train': {
                                k: v['sample_one_hop']
                                for k, v in link_tr['launches'].items()},
                            'link_loader': {
                                k: v['sample_one_hop']
                                for k, v in link_lo['launches'].items()},
                            'seal': {
                                k: v['sample_one_hop']
                                for k, v in seal_out['launches'].items()},
                            'edges': {
                                k: v['sample_one_hop']
                                for k, v in ed['launches'].items()},
                            'edge_loaders': {
                                k: v['sample_one_hop']
                                for k, v in el['launches'].items()},
                            'hetero_link': {
                                k: v['sample_one_hop']
                                for k, v in hlk['launches'].items()},
                            **ml_launches('sample_one_hop'),
                            **mhk[0]['launches_by_path'],
                            **ek['k1']['launches_by_path'],
                            'resume_fused': rf['launches']['sample_one_hop'],
                            'resume_fused_mesh':
                                rfm['launches']['sample_one_hop']},
       'mesh_hetero_shapes': mhk[0]['mesh_hetero_shapes'],
       'mesh_engine_shapes': ek['k1']['shapes'],
       'mesh_edge_shape': {
           k: ml_kernels[0][k] for k in ('shape', 'ms', 'no_eids_ms',
                                         'plain_ms', 'bound_ms', 'hops')},
       'edge_shapes': {
           'products': eid_shape(
               f'{TRAIN_BATCH}-seed with-edge per-batch step', ed['hops']),
           'products_link': eid_shape(
               '1,024-edge with-edge products link batch (binary)',
               el['hops']),
           'mag_link': {
               'shape': 'mag with-edge hetero link batch (author writes '
                        f'paper), first of {len(mag_we[0])} timed calls: '
                        f'{mag_we[0][0]["rows"]} rows, k '
                        f'{mag_we[0][0]["k"]}, eids = CSR positions',
               'ms': mag_we[0][0]['kernel_ms'],
               'plain_ms': mag_we[0][0]['plain_ms'],
               'bound_ms': mag_we[0][0]['bound_us'] / 1e3,
               'byte_equal': True},
           'forced_sets_with_eids': eo['forced_sets']},
       'hetero_link_shapes': [
           {'shape': f'{hl_what[k]} call {h["call"]}: {h["rows"]} rows, '
                     f'k {h["k"]}, eids {h["eids"]}',
            'ms': h['kernel_ms'], 'plain_ms': h['plain_ms'],
            'bound_ms': h['bound_us'] / 1e3, 'byte_equal': True}
           for k, (hs, _) in hlk['timed'].items() if k in hl_what
           for h in hs],
       'link_shapes': {
           'ppi_per_batch': link_shape(
               f'{LINK_BATCH}-edge PPI link batch (binary), per-batch',
               link_tr['shape_hops']['per_batch']),
           'ppi_fused': link_shape(
               f'{LINK_BATCH}-edge PPI FusedLinkEpoch step (binary)',
               link_tr['shape_hops']['fused']),
           'products': link_shape(
               f'{PRODUCTS_LINK_BATCH}-edge products link batch (binary)',
               link_lo['hops']),
           'seal_closure': link_shape('SEAL enclosing-subgraph closure '
                                      '(2 seeds)', seal_out['hops'])},
       'hetero_shapes': {
           'fused': hetero_shape(
               f'{HETERO_BATCH}-seed FusedHeteroEpoch RGCN step',
               het_hops),
           'loader': hetero_shape(
               f'{HGT_BATCH}-seed per-batch HGT step', hl_hops)},
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
       'subgraph_shape': {
           'shape': '1,024-seed fused subgraph step, sorted hops of '
                    + '/'.join(str(h['rows']) for h in sub_hops)
                    + ' rows, k 15/10/5',
           'ms': sum(h['kernel_ms'] for h in sub_hops),
           'plain_ms': sum(h['plain_ms'] for h in sub_hops),
           'bound_ms': sum(h['bound_us'] for h in sub_hops) / 1e3,
           'max_abs_err': max(h['max_abs_err'] for h in sub_hops),
           'byte_equal': True, 'hops': per_hop(sub_hops)},
       'mesh_shape': mesh_shape('mesh loader batch of 8 x 512 seeds',
                                loader_path['hops']),
       'fused_mesh_shapes': {
           k: mesh_shape(f'{fmesh_what[k]} of 8 x 512 seeds', v['hops'])
           for k, v in fmesh_paths.items()}},
      {'name': 'gather_rows', 'route': 'cuda',
       'source': 'graphlearn_tpu_torch/csrc/gather_rows.cu',
       'replaces': 'graphlearn_tpu/ops/pallas_gather.py:152',
       'launches': launches['gather_rows'],
       'max_abs_err': max(g['max_abs_err']
                          for g in gathers + gathers_train + [train_gather]
                          + tree_levels + mesh_gathers + [sub_gather]
                          + fmesh_gathers + het_gathers + hl_gathers
                          + link_tr['gathers'] + link_lo['gathers']
                          + ed['gathers'] + hlk['gathers'] + ml_gathers
                          + rf['levels'] + rm['path']['gathers']
                          + rfm['path']['gathers']
                          + [{'max_abs_err': mhk[1]['max_abs_err']},
                             {'max_abs_err': ek['k2']['max_abs_err']}]),
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
           for g in [train_gather] + tree_levels + gathers_train
           + [sub_gather]],
       'mesh_shapes': [
           {'shape': f'{g["ids"]} ids x {g["row_bytes"]} B {g["dtype"]} '
                     f'over {MESH_PARTS} owners',
            'ms': g['kernel_ms'], 'plain_ms': g['plain_ms'],
            'bound_ms': g['bound_us'] / 1e3, 'library_ms': g['library_ms'],
            'byte_equal': True}
           for g in mesh_gathers],
       'fused_mesh_shapes': [
           {'shape': f'{fmesh_what[k]}: {g["ids"]} ids x {g["row_bytes"]} '
                     f'B {g["dtype"]} over {MESH_PARTS} owners',
            'ms': g['kernel_ms'], 'plain_ms': g['plain_ms'],
            'bound_ms': g['bound_us'] / 1e3, 'library_ms': g['library_ms'],
            'byte_equal': True}
           for k, v in fmesh_paths.items() for g in v['gathers']],
       'launches_by_path': {'serve': launches['gather_rows'],
                            'train': train_launches['gather_rows'],
                            'tree_train': tree_launches['gather_rows'],
                            'fused_session': {
                                k: v['gather_rows']
                                for k, v in session_launches.items()},
                            'tiered_serve': tserve_launches['gather_rows'],
                            'tiered_train': {
                                k: r['launches']['gather_rows']
                                for k, r in ttrain_runs.items()},
                            'gns_train': gns_launches['gather_rows'],
                            'mesh_loader': loader_launches['gather_rows'],
                            'mesh_train': mesh_launches['gather_rows'],
                            'fused_mesh': {
                                k: v['gather_rows']
                                for k, v in fmesh_launches.items()},
                            'hetero_train': het_launches['gather_rows'],
                            'hetero_loader': hl_launches['gather_rows'],
                            'link_train': {
                                k: v['gather_rows']
                                for k, v in link_tr['launches'].items()},
                            'link_loader': {
                                k: v['gather_rows']
                                for k, v in link_lo['launches'].items()},
                            'seal': {
                                k: v['gather_rows']
                                for k, v in seal_out['launches'].items()},
                            'edges': {
                                k: v['gather_rows']
                                for k, v in ed['launches'].items()},
                            'edge_loaders': {
                                k: v['gather_rows']
                                for k, v in el['launches'].items()},
                            'hetero_link': {
                                k: v['gather_rows']
                                for k, v in hlk['launches'].items()},
                            **ml_launches('gather_rows'),
                            **mhk[1]['launches_by_path'],
                            **ek['k2']['launches_by_path'],
                            'resume_fused': rf['launches']['gather_rows'],
                            'resume_mesh': rm['launches']['gather_rows'],
                            'resume_fused_mesh':
                                rfm['launches']['gather_rows']},
       'mesh_hetero_shapes': mhk[1]['mesh_hetero_shapes'],
       'mesh_engine_shapes': ek['k2']['shapes'],
       'mesh_link_shapes': ml_kernels[2]['mesh_link_shapes'],
       'edge_shapes': [
           gather_shape('products with-edge batch x', ed['gathers'][0]),
           gather_shape('products with-edge batch edge rows',
                        ed['gathers'][1])] + [
           gather_shape('mag with-edge hetero link batch', g)
           for g in mag_we[1]],
       'hetero_link_shapes': [
           gather_shape(f'{hl_what[k]} gather {g["call"]}', g)
           for k, (_, gs) in hlk['timed'].items() if k in hl_what
           for g in gs],
       'link_shapes': [
           gather_shape('PPI link batch x, per-batch', link_tr['gathers'][0]),
           gather_shape('PPI FusedLinkEpoch step x', link_tr['gathers'][1]),
           gather_shape('products link batch x', link_lo['gathers'][0])],
       'hetero_shapes': [
           gather_shape(f'FusedHeteroEpoch RGCN step, {g["ntype"]} x', g)
           for g in het_gathers] + [
           gather_shape(f'per-batch HGT step, {g["ntype"]} x', g)
           for g in hl_gathers]},
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
                          for h in gns_hops + mesh_path['hops'] + ml_gns
                          + rm['path']['hops']),
       'ms': sum(h['kernel_ms'] for h in gns_hops),
       'plain_ms': sum(h['plain_ms'] for h in gns_hops),
       'bound_ms': sum(h['bound_us'] for h in gns_hops) / 1e3,
       'bound_by': 'bytes', 'library_ms': None, 'byte_equal': True,
       'shape': '1,024-seed training batch, hops of '
                + '/'.join(str(h['rows']) for h in gns_hops)
                + ' rows, k 15/10/5',
       'hops': per_hop(gns_hops), 'forced_sets': gns_forced['cases'],
       'edge_mode': 'without edges here; edge_ids[pos] (kEdge 2) on '
                    'mesh_edges / mesh_link (edge_shape)',
       'launches_by_path': {
           'gns_train': gns_launches['sample_one_hop_gns'],
           'mesh_train': mesh_launches['sample_one_hop_gns'],
           **ml_launches('sample_one_hop_gns'),
           'resume_mesh': rm['launches']['sample_one_hop_gns']},
       'edge_shape': {k: ml_kernels[1][k] for k in (
           'shape', 'ms', 'no_eids_ms', 'plain_ms', 'bound_ms', 'hops')},
       'gns_ab': ml['edges']['ab'],
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
       'forced_width_ms': win['forced_width_ms'],
       'launches_by_path': {'window': win['launches'],
                            **ek['k3']['launches_by_path']},
       'mesh_shapes': ek['k3']['shapes']},
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
                    f'{k6_train["row_bytes"]} B of a tiered train batch '
                    '(plan step + kernel)',
           'ms': k6_train['kernel_ms'], 'plain_ms': k6_train['plain_ms'],
           'bound_ms': k6_train['bound_ms'],
           'library_ms': k6_train['library_ms'],
           'achieved_gbps': k6_train['achieved_gbps'],
           'link_share': k6_train['link_share'],
           'copy_share': k6_train['copy_share'], 'plans': k6_train['plans'],
           'byte_equal': True},
       'diagnosis': k6_train['diagnosis'],
       'forced_sets': len(k6_forced),
       'forced_ms': {k: r['kernel_ms'] for k, r in k6_forced.items()
                     if 'kernel_ms' in r},
       'launches_by_path': {
           'tiered_serve': tserve_launches['cold_gather'],
           'tiered_train': {k: r['launches']['cold_gather']
                            for k, r in ttrain_runs.items()}},
       'plans_by_path': {
           'tiered_serve': tserve_launches['cold_gather_plans'],
           'tiered_train': {k: r['launches']['cold_gather_plans']
                            for k, r in ttrain_runs.items()}}},
  ]
  by_name = {k['name']: k for k in kernels}
  for group, entries in (('fleet', fk), ('failover', fok),
                         ('locality', lok)):
    for f in entries:               # the group's shapes and launches
      entry = by_name[f['name']]
      entry['max_abs_err'] = max(entry['max_abs_err'], f['max_abs_err'])
      entry['launches_by_path'].update(f['launches_by_path'])
      entry[f'{group}_shape'] = {k: f[k] for k in (
          'shape', 'ms', 'plain_ms', 'bound_ms', 'library_ms')}
      if 'locality_shapes' in f:
        entry['locality_shapes'] = f['locality_shapes']
  sr = hg['serve_rpc']              # launched by the serve RPC's server
  for name in ('sample_one_hop', 'gather_rows'):
    by_name[name]['launches_by_path']['serve_rpc'] = \
        sr['server_launches'][name]
  return kernels


if __name__ == '__main__':
  sys.exit(main(sys.argv[1:]))
