"""Online inference serving: the bucketed engine (`engine`), admission
control with typed load-shedding (`admission`) and the coalescing
frontend (`frontend`).

Fleet resilience: `FleetRouter` spreads traffic over N replicas with
heartbeat-classified routing and exactly-once request redrive on replica
loss (`router`); `swap.hot_swap` swaps model versions drain-free behind
a parity check; `aot_cache` keeps the built kernel libraries under
``GLT_AOT_CACHE_DIR`` so a fresh process restores them instead of
running ``nvcc``.  Elasticity: `ElasticController` sizes the fleet from
the SLO-burn, queue and headroom signals (`autoscaler`).

Knobs: ``GLT_SERVING_BUCKETS``, ``GLT_SERVING_MAX_WAIT_MS``,
``GLT_SERVING_QUEUE_DEPTH``, ``GLT_SERVING_DEADLINE_MS``,
``GLT_SERVING_DRAIN_RETRY_MS``, ``GLT_AOT_CACHE_DIR``,
``GLT_FLEET_HEARTBEAT_MS``, ``GLT_FLEET_OVERLOAD_RATIO``,
``GLT_FLEET_FLAP_WINDOW_S``, ``GLT_SCALE_*``."""
from .admission import (AdmissionController, AdmissionRejected,
                        ServingFuture)
from .aot_cache import AotExecutableCache
from .autoscaler import ElasticController, ScaleAbortedError
from .engine import ServingEngine, ServingResult, resolve_buckets
from .frontend import ServingFrontend
from .router import FleetRouter, LocalReplica, RemoteReplica, RouterFuture
from .swap import (SwapAbortedError, SwapParityError, SwapValidationError,
                   hot_swap)

__all__ = [
    'AdmissionController', 'AdmissionRejected', 'ServingFuture',
    'AotExecutableCache',
    'ElasticController', 'ScaleAbortedError',
    'ServingEngine', 'ServingResult', 'resolve_buckets',
    'ServingFrontend',
    'FleetRouter', 'LocalReplica', 'RemoteReplica', 'RouterFuture',
    'SwapAbortedError', 'SwapParityError', 'SwapValidationError',
    'hot_swap',
]
