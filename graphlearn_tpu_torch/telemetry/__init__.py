"""The parts of the JAX package's telemetry that the port calls: the
flight `recorder`, the `live` metrics registry, per-tier memory gauges
(`memaccount.register_tier`), the serve-capacity model
(`memaccount.CapacityModel`), the serving SLO tracker (`slo.SloTracker`),
post-mortem bundles (`postmortem.dump`) and the mesh exchange summary
(`aggregate.exchange_summary`).  The rest of telemetry is ROADMAP item
13."""
from .live import LiveRegistry, live, metrics
from .memaccount import CapacityModel, register_tier
from .recorder import EventRecorder, recorder
from .slo import SloTracker

__all__ = ['CapacityModel', 'EventRecorder', 'LiveRegistry', 'SloTracker',
           'live', 'metrics', 'recorder', 'register_tier']
