"""The parts of the JAX package's telemetry that the port calls: the
flight `recorder`, the `live` metrics registry, per-tier memory gauges
(`memaccount.register_tier`), post-mortem bundles (`postmortem.dump`)
and the mesh exchange summary (`aggregate.exchange_summary`).  The rest
of telemetry is ROADMAP item 13."""
from .live import LiveRegistry, live, metrics
from .memaccount import register_tier
from .recorder import EventRecorder, recorder

__all__ = ['EventRecorder', 'LiveRegistry', 'live', 'metrics', 'recorder',
           'register_tier']
