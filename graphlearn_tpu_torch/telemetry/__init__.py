"""The port's telemetry: the flight `recorder`, causal `span`s, the live
metrics registry (`live`, `LiveRegistry`: counters, gauges, log2
histograms with trace exemplars, Prometheus text), request tracing
(`tracer`, `Tracer`), the per-process ops endpoint (`OpsServer`,
`maybe_start_from_env`), time-series rings (`TimeSeriesStore`), fleet
federation (`FleetScraper`), per-tier memory gauges and the
serve-capacity model (`memaccount`), the serving SLO tracker
(`SloTracker`), post-mortem bundles (`postmortem`), the mesh exchange
summary (`aggregate.exchange_summary`), the Chrome-trace export and
report CLI (`export`, `report`), and the bench artifact sink and
regression gate (`sink`, `regress`).

It exports what the JAX package's `telemetry` does except
`gather_metrics` (the allgather across host processes: the partitioned
host plane, slice 25) and the profiler hooks `step_annotation`,
`start_trace`, `stop_trace` and `capture`; `trace` lives in
`utils.profiling` (a `torch.profiler` range and a registry timer).
"""
from .aggregate import exchange_summary, per_hop_padding
from .federation import FleetScraper
from .histogram import Histogram, from_snapshot
from .live import (LiveRegistry, Metrics, live, metrics,
                   parse_prometheus_text, split_exemplar)
from .memaccount import TIERS, CapacityModel, register_tier
from .opsserver import OpsServer, maybe_start_from_env
from .recorder import EventRecorder, recorder
from .sink import (artifact_path, append_record, summary_line,
                   write_artifact)
from .slo import SloTracker
from .spans import SpanContext, span
from .timeseries import TimeSeriesStore
from .tracing import Tracer, child_ctx, spans_to_events, tracer

__all__ = [
    'CapacityModel', 'EventRecorder', 'FleetScraper', 'Histogram',
    'LiveRegistry', 'Metrics', 'OpsServer', 'SloTracker',
    'SpanContext', 'TIERS', 'TimeSeriesStore', 'Tracer',
    'append_record', 'artifact_path', 'child_ctx', 'exchange_summary',
    'from_snapshot', 'live', 'maybe_start_from_env', 'metrics',
    'parse_prometheus_text', 'per_hop_padding', 'recorder', 'register_tier', 'span',
    'spans_to_events', 'split_exemplar', 'summary_line', 'tracer',
    'write_artifact',
]
