"""Online inference serving: the bucketed engine (`engine`), admission
control with typed load-shedding (`admission`) and the coalescing
frontend (`frontend`).  Knobs: ``GLT_SERVING_BUCKETS``,
``GLT_SERVING_MAX_WAIT_MS``, ``GLT_SERVING_QUEUE_DEPTH``,
``GLT_SERVING_DEADLINE_MS``."""
from .admission import (AdmissionController, AdmissionRejected,
                        ServingFuture)
from .engine import ServingEngine, ServingResult, resolve_buckets
from .frontend import ServingFrontend
