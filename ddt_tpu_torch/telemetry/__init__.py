"""Telemetry of the port's serving plane (port of the part of
ddt_tpu/telemetry that serving and the registry write).

- events     the run log: schema v5 tables, `validate_event`, `RunLog`,
             `derive_run_id`; a port log reads in the reference's
             `report` and `merge`.
- counters   process-wide monotonic counters (`snapshot` / `delta`).
- exposition the Prometheus text dialect of `/metrics`.

The training-side telemetry (phase timers, profiler windows, partition
recorders, report, trace, statusd) is not ported yet.
"""

from ddt_tpu_torch.telemetry import counters  # noqa: F401
from ddt_tpu_torch.telemetry.events import (  # noqa: F401
    EVENT_FIELDS, SCHEMA_VERSION, RunLog, derive_run_id, validate_event)
