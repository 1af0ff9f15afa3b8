"""Serving tier of the port (ddt_tpu/serve/): ServeEngine over a
MicroBatcher at the f32, int8 and int4 tiers, the multi-model
FleetEngine, drift and shadow scoring (serve/drift.py), the fleet's
control plane (serve/control.py), `/metrics` (serve/metrics.py) and the
HTTP front end (serve/http.py, `python -m ddt_tpu_torch.cli serve`)."""

from ddt_tpu_torch.serve.batcher import (MicroBatcher, PendingRequest,
                                         ShuttingDown)
from ddt_tpu_torch.serve.engine import (ServableModel, ServeEngine,
                                        ServeStats, bucket_for,
                                        default_buckets, dispatch_batch)
from ddt_tpu_torch.serve.fleet import (FleetEngine, ModelUnavailableError,
                                       UnknownModelError)

__all__ = [
    "MicroBatcher", "PendingRequest", "ShuttingDown",
    "ServableModel", "ServeEngine", "ServeStats", "FleetEngine",
    "ModelUnavailableError", "UnknownModelError",
    "bucket_for", "default_buckets", "dispatch_batch",
]
