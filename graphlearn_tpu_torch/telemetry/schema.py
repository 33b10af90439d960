"""Registry of flight-recorder event kinds and span names.

Exporters (`telemetry.export`), the report CLI and external dashboards
key off event ``kind`` strings; an unregistered kind is a consumer that
silently sees nothing.  The port's copy of the JAX package's
`telemetry/schema.py`: :data:`EVENT_KINDS` and :data:`SPAN_NAMES` hold
the JAX package's entries with its text (the consumer contract is
shared), plus the kinds only the port emits.  Every
``recorder.emit('<kind>', ...)`` and ``span('<name>', ...)`` call site
in the port must be registered here, and every registered kind without
a call site in the port must either come from a JAX module the port has
not ported yet or stand in :data:`NOT_EMITTED` with its reason
(``tests/test_torch_event_schema.py`` reads both packages' sources).

The value documents the emitter and the fields consumers may rely on.
The live-metric vocabulary, `METRIC_NAMES`, sits in `telemetry.live`
beside the registry that enforces it.
"""
from __future__ import annotations

from typing import Dict

#: kind -> 'emitter: field summary' (the consumer contract)
EVENT_KINDS: Dict[str, str] = {
    'hop.padding':
        'DistNeighborLoader / fused epoch drivers: hop, nodes, '
        'capacity, fill (1 - fill = padding waste)',
    'channel.stall':
        'ChannelTelemetry._timed: op, secs, occupancy, channel',
    'slack.transition':
        'AdaptiveSlack: from_slack, to_slack, reason, drop_rate, '
        "pin_reason ('reversal' when this widen pins the ladder, "
        "else '')",
    'slack.pinned':
        'AdaptiveSlack: slack, drop_rate, pin_reason (why retuning '
        "stopped: 'reversal' = tighten->widen oscillation guard, "
        "'floor' = drop-free at the configured ladder floor)",
    'padding.truncate':
        'utils.padding.pad_1d: requested, size, dropped — a host-side '
        'pad silently cut non-fill entries (capacity bug surfacing; '
        'GLT_STRICT_PADDING=1 raises instead)',
    'dist.exchange':
        'ExchangeTelemetry drains: since-last-drain deltas of '
        'offered/dropped/slots per loss channel',
    'dist.cold_tier':
        'tiered DistFeature drains: lookups (all feature lookups), '
        'cold_lookups (past the hot tier — the cache denominator), '
        'misses (host-served), cache_hits, hit_rate',
    'cache.hit':
        'data.cold_cache consumers (scope=feature|dist|serving|'
        'hetero): count of cold lookups served from the HBM victim '
        'cache this overlay',
    'cache.miss':
        'data.cold_cache consumers: count of cold lookups that paid '
        'the host gather this overlay (admission candidates; '
        'scope=hetero has NO cache yet, so every cold lookup lands '
        'here — the live twin of cold_lookups == cold_misses)',
    'cache.admit':
        'data.cold_cache consumers: rows written into the HBM ring '
        'this overlay (frequency-ranked winners)',
    'cache.evict':
        'data.cold_cache consumers: residents displaced by this '
        "overlay's admissions (CLOCK second-chance victims)",
    'fused.compile':
        'loader.fused._uncached_jit: fn, secs, persistent_cache',
    'span.begin':
        'telemetry.spans: name, trace_id, span_id, parent_id, pid, '
        'tid (+caller fields)',
    'span.end':
        'telemetry.spans: same ids as span.begin plus dur '
        '(monotonic-clock seconds) and error',
    'fault.injected':
        'testing.chaos: site, action, nth, arrival (+op/worker/epoch '
        'filters, secs for delays) — one event per fired fault, so a '
        'chaos run reads out of the same stream as the retries and '
        'restarts it caused',
    'rpc.retry':
        'RpcClient.request: op, attempt, addr, error, backoff_secs — '
        'one transport fault absorbed by the resilience layer',
    'producer.restart':
        'MpSamplingProducer.supervise: worker, exitcode, replayed '
        '(unacked batches re-dispatched), restarts, budget',
    'peer.lost':
        'resilience layer (DistClient / DistLoader / supervise): '
        'peer, peer_kind (server|worker), degraded (True = epoch '
        'finished on survivors under GLT_DEGRADED_OK), lost_batches/'
        'outstanding, received, expected',
    'server.shutdown_timeout':
        'DistServer.wait_for_exit: rank, timeout_secs, '
        'clients_never_exited, clients_left, live_producers — a '
        'shutdown wait that expired instead of returning silently',
    'snapshot.save':
        'utils.checkpoint.SnapshotManager.save: index, ok, secs, dir, '
        'epoch, next_chunk (ok=False carries error — a failed '
        'snapshot write is absorbed, not fatal)',
    'snapshot.restore':
        'utils.checkpoint.SnapshotManager.restore_latest: index, '
        'secs, dir, epoch, next_chunk — one event per data-plane '
        'restore (resume and degraded rollback both land here)',
    'mesh.stall':
        'resilience.run_with_deadline: scope, deadline_secs, healthy '
        '(last-known-healthy process set) — a fused/mesh dispatch '
        'exceeded GLT_DISPATCH_DEADLINE and was converted into a '
        'typed MeshStallError instead of hanging the epoch',
    'serving.request':
        'serving.frontend executor, one per de-multiplexed request: '
        'seeds, bucket, coalesced (requests in the dispatch), ok, '
        'latency_ms (arrival -> resolve; the percentile-table and '
        'bench p50/p95/p99 source), error when ok=False',
    'serving.coalesce':
        'serving.frontend executor, one per coalesced dispatch: '
        'requests, seeds, bucket (chosen capacity), waited_ms since '
        "the run's first arrival (how much of GLT_SERVING_MAX_WAIT_MS "
        'actually bound)',
    'serving.admit':
        'serving.admission.AdmissionController.submit: seeds, '
        'queue_depth after admit, deadline_ms — one per admitted '
        'request',
    'gns.bias':
        'DistNeighborSampler.step_for_batch (GNS mode, build time): '
        'batch, boost, num_parts — one event per compiled GNS step, '
        'recording the cached-neighbor boost that step samples with',
    'gns.sketch_update':
        'DistNeighborSampler._gns_arrays: scope, residents, version, '
        'mask_bytes — one event per cached-set bitmask refresh (the '
        'sketch-selected cold-cache residents ∪ hot split became the '
        'new sampling-bias membership table)',
    'serving.shed':
        'serving.admission: reason (queue_full|deadline|too_large|'
        'draining|shutdown), seeds, queue_depth, limit / waited_ms / '
        'retry_after_ms — one per typed load-shed (the request '
        'future resolves with AdmissionRejected; nothing is silently '
        'dropped; draining sheds are intentional and burn no SLO '
        'budget)',
    'recorder.overflow':
        'telemetry.recorder, ONE-SHOT on the first in-memory ring '
        'drop: ring_capacity — from this point the flight recorder '
        'is a sliding window, not a full history (cumulative count: '
        'stats()["ring_dropped"] / the recorder.ring_dropped gauge)',
    'slo.burn':
        'telemetry.slo.SloTracker: window_secs, burn_rate, p99_ms, '
        'target_p99_ms, qps, count — a sliding window started '
        'consuming latency error budget faster than allotted '
        '(burn_rate crossed 1.0; re-arms when it recovers)',
    'postmortem.dump':
        'telemetry.postmortem.dump: reason, path, events, '
        'error — a post-mortem bundle (recorder ring + metrics '
        'snapshot + health) was written to GLT_POSTMORTEM_DIR',
    'serving.failover':
        'serving.router.FleetRouter: replica, event '
        '(evict|redrive|readmit|exhausted|quarantine|retire), '
        'redriven (in-flight '
        'requests moved to a survivor on evict), state — one event '
        'per fleet state transition / redrive wave, so a failover '
        'reads out of the same stream as the chaos faults that '
        'caused it',
    'serving.swap':
        'serving.swap.hot_swap: version, ok, rolled_back, '
        'parity_max_err, drained_ms — one event per hot model-swap '
        'attempt (ok=False carries error; a parity mismatch rolls '
        'back to the prior version with zero dropped requests; a '
        'never-quiesced executor aborts with rolled_back=False '
        'before any probe ran)',
    'aot.cache_hit':
        'serving.aot_cache.AotExecutableCache: program, bucket, key, '
        'secs — a warm executable deserialized from '
        'GLT_AOT_CACHE_DIR instead of recompiling',
    'aot.cache_miss':
        'serving.aot_cache.AotExecutableCache: program, bucket, key, '
        'reason (absent|stale|corrupt|unreadable|error) — this '
        'bucket paid a compile; corrupt/stale entries land here too '
        '(skip-to-recompile, never a crash or a wrong executable)',
    'ingest.wal_truncate':
        'streaming.wal.WriteAheadLog.open: path, offset, '
        'dropped_bytes, last_seqno — a torn tail (kill mid-append) '
        'was truncated back to the last whole record; replay lands '
        'exactly the whole-record prefix',
    'ingest.replay':
        'streaming.ingest.IngestPipeline.recover: restored (a '
        'compacted base was loaded), replayed_records/_events, '
        'skipped_records (<= the base watermark — the idempotence '
        'that makes a crash between snapshot and WAL reset safe), '
        'applied_seqno, secs — one event per recovery',
    'ingest.compact':
        'streaming.ingest.IngestPipeline.compact: ok, seqno '
        '(watermark baked into the snapshot), events, secs — ok='
        'False is an ABSORBED snapshot-write failure (the WAL keeps '
        'the full history; nothing lost)',
    'ingest.fault':
        'streaming.ingest.IngestPipeline: site (apply|compact|'
        'shard_refresh), '
        'error — an ingestion fault surfaced typed (and dumped a '
        'post-mortem bundle) instead of leaving a half-applied '
        'graph; the WAL replay makes the restart exactly-once',
    'partition.adopt':
        'failover.adopt_shard + the reader recovery seams: '
        'partition, survivor, version, secs (phase=recovered rows '
        'carry the classification→served-batch recovery clock)',
    'partition.book_version':
        'PartitionBook.adopt/.transfer: version, lost, survivor, '
        'num_lanes, planned (True = scheduled handoff cutover, not a '
        'crash adoption) — one per ownership transfer, the routing '
        'authority moving',
    'handoff.transfer':
        'parallel.handoff.handoff: partition, frm, to, phase '
        '(snapshot|transfer|fence|cutover|drain|rollback), version, '
        'secs, error (rollback cause / absorbed drain fault) — one '
        'event per seam of a planned ownership move, so a handoff '
        'reads out of the flight recorder end to end',
    'partition.relabel':
        'parallel.locality.locality_partition: partitioner, '
        'num_parts, num_nodes, seed, edge_cut_frac, max_part_frac, '
        'hotness_weighted — one event per locality relabel build '
        '(the placement decision a dataset was constructed under)',
    'partition.rebalance':
        'parallel.locality.execute_rebalance: partition, frm, to, '
        'demand, version, secs — one event per planned hot-range '
        'migration (each move is a fenced handoff.transfer ladder; '
        'this is the demand-driven WHY on top of it)',
    'exchange.retune':
        'parallel.dist_sampler.ExchangeTelemetry.capacity_retune: '
        'steps, frontier_dest_cap, frontier_traffic_cap, '
        'feature_dest_cap, feature_traffic_cap — the EWMA capacity '
        'model moved a quantized cap and the step cache was cleared '
        '(next dispatch compiles measured per-destination shares)',
    'scale.decision':
        'serving.autoscaler.ElasticController: dir (out|in), outcome '
        '(ok|rolled_back|held:cooldown|held:bounds|held:no_victim), '
        'replica, error, plus the signal snapshot that justified it '
        '(replicas, short_burn, long_burn, queue_frac, headroom_qps) '
        '— every considered scaling decision, acted or held',
    'pallas.dispatch':
        'r19 kernel gates (ops.pallas_sample.sample_one_hop_auto, '
        'data.cold_cache.make_pinned_cold_buffer, streaming.delta.'
        'StreamingGraph._merge_device): kernel (fused_sample|'
        'cold_gather|delta_merge) + per-kernel fields (mode/batch/k, '
        'rows/memory_kind, events/version) — one event per '
        'trace/build that took the Pallas path, so a perf run reads '
        'which arms actually ran the kernel out of the same stream '
        'as its step timings',
    'pallas.fallback':
        'r19 kernel gates (same three sites): kernel, reason '
        '(unsupported-shape strings or trace-error:<ExcType>) + the '
        'same per-kernel fields — the knob was ON but this call '
        'fell back to the XLA/host path at byte parity; contract '
        'errors (ValueError) re-raise instead of landing here',
    # -- emitted only by the port ----------------------------------------
    'stream.publish':
        'streaming.StreamingGraph publish: version, events, edges, '
        'capacity and the host wall ms of each phase (shift_ms, '
        'ranks_ms, scatter_ms, copy_ms, total_ms)',
}


#: registered kinds and span names the port never emits, with the
#: reason: their JAX emitters exist for a path the port replaced
#: rather than ported
NOT_EMITTED: Dict[str, str] = {
    'pallas.dispatch':
        'the knob-gated Pallas dispatch ladder; the port has no ladder '
        '(its kernels launch on every CUDA tensor or raise)',
    'pallas.fallback':
        'the same ladder\'s fallback arm; the port never falls back',
    'padding.truncate':
        'utils.padding.pad_1d is not ported: the port\'s seed batchers '
        'only pad a short tail batch, so no host pad can truncate',
    'fused.init_state':
        'FusedTreeEpoch.init_state initialises Flax params from a dummy '
        'batch; the port\'s models build their parameters in the torch '
        'module\'s constructor',
}


#: span NAME vocabulary (the `name` field of span.begin/span.end —
#: the per-stage rows of the report CLI and the Perfetto slices).
#: Same contract as EVENT_KINDS: every ``span('<name>', ...)`` call
#: site registers here, enforced by the same static test.
SPAN_NAMES: Dict[str, str] = {
    'batch':
        'per-batch root span (mesh + host-runtime loaders)',
    'sample.exchange':
        'mesh samplers: the fused sample+exchange SPMD dispatch',
    'feature.lookup':
        'mesh samplers, TIERED stores only: the cold-tier overlay '
        '(the per-batch host sync worth attributing)',
    'stitch':
        'mesh loaders: Batch pytree assembly',
    'recv':
        'host-runtime DistLoader: channel dequeue',
    'collate':
        'host-runtime DistLoader: message -> static-shape Batch '
        '(carries producer_trace/producer_span link fields)',
    'producer.sample':
        'sampling worker subprocess: one sample+send',
    'server.fetch':
        'DistServer: one blocking buffer pull for a client',
    'client.fetch':
        'DistClient: one RPC fetch round trip',
    'fused.epoch':
        'fused epoch drivers: one whole run() call',
    'fused.dispatch':
        'fused epoch drivers: one chunk/program dispatch (tiered '
        "epochs tag phase='collect'|'train')",
    'feature.cold_overlay':
        'tiered fused epochs: the between-dispatch host cold service '
        'for one chunk (cache serve + host overlay + admissions; '
        'steps = batches corrected)',
    'fused.init_state':
        'FusedTreeEpoch.init_state: param init from the dummy batch',
    'exchange.layout':
        'mesh samplers, build time: one span per compiled SPMD step '
        'with the resolved exchange layout (dense/compact/hier/'
        'ragged), num_parts and slack',
    'exchange.stage':
        'parallel.exchange.capacity_spec, build time: hierarchical '
        'stage capacities (rows, cols, stage1_cap, stage2_cap) for '
        'one planned exchange',
    'serving.infer':
        'serving.frontend executor: one warm bucketed dispatch '
        '(device program + tiered host fill) — bucket, requests, '
        'seeds; queue wait is OUTSIDE this span (serving.request '
        'latency_ms minus this span = admission/coalescing wait)',
    'serving.route':
        'FleetRouter (request-trace root): one routed serve request '
        'submit→resolve, spanning the replica RPC + coalesced '
        'dispatch — replica, outcome; span_id == trace_id '
        '(recorded via telemetry.tracing, tail-retained)',
    'serving.rpc':
        'DistServer.serve_infer: one serve RPC on the server process '
        '(submit→future resolve) — the cross-process edge under '
        'serving.route (telemetry.tracing)',
    'serving.queue_wait':
        'serving frontend, per request: admission enqueue → '
        'coalesce pickup (the wait the coalescing executor imposed; '
        'also a live histogram under the same name)',
    'serving.dispatch_slice':
        'serving frontend, per request: this request\'s share of one '
        'coalesced dispatch (pickup → demux resolve) — bucket, '
        'requests riding the same dispatch (telemetry.tracing)',
    'serving.sample_collect':
        'serving engine, per dispatch: the neighbor-sampling collect '
        'program inside a tiered dispatch, parented under the '
        'dispatch slice — with serving.cold_fill it splits sampling '
        'cost from feature-fill cost (telemetry.tracing)',
    'serving.cold_fill':
        'serving engine, per dispatch: the tiered host cold-path '
        'feature fill inside the dispatch (cache serve + host '
        'gather), parented under the dispatch slice '
        '(telemetry.tracing)',
}


#: closed label-key vocabulary of the live metric plane.  Every
#: ``labels={...}`` at a counter/gauge/histogram registration site
#: must draw its KEYS from this table and each entry documents
#: the closed/bounded VALUE set — the property that keeps scrape
#: cardinality enumerable (a label whose values are unbounded is a
#: time-series leak: every new value mints a family member forever).
METRIC_LABELS: Dict[str, str] = {
    'scope':
        'cold-cache scope: feature|dist|serving|hetero (the four '
        'cache flavors — see cache.*_total)',
    'bucket':
        'serving bucket capacity: one of the GLT_SERVING_BUCKETS '
        'ladder seeds (default 1,2,4,8,16 — bounded by the ladder '
        'length)',
    'state':
        'FleetRouter replica state: healthy|overloaded|draining|'
        'quarantined|dead (fixed five-state machine)',
    'dir':
        'ElasticController scale direction: out|in (the two-way '
        'vocabulary of scale.replicas)',
    'reason':
        'admission shed reason: queue_full|deadline|too_large|'
        'draining|shutdown (the typed rejection vocabulary)',
    'outcome':
        'hot-swap outcome: ok|rolled_back|aborted (fixed three-way '
        'verdict of serving.swaps_total)',
    'window':
        'SLO sliding window: one of SloTracker.windows rendered as '
        '"<seconds>s" (default 60s|300s — bounded by the '
        'configured window tuple)',
    'replica':
        'fleet replica name: bounded by the fleet size (the '
        'FleetScraper target set / FleetRouter replica table)',
    'partition':
        'partition/range index: 0..P-1, bounded by the mesh '
        'num_parts (PartitionBook range ids)',
    'tier':
        'memory accounting tier: hot|cold_cache|streaming|gns|aot|'
        'wal|pinned_host (the closed memaccount.TIERS vocabulary — '
        'seven fixed byte-gauge families, never per-object)',
}


def registered(kind: str) -> bool:
  return kind in EVENT_KINDS
