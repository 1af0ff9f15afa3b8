"""Structured telemetry of the port (port of ddt_tpu/telemetry): the same
schema-v5 run log, so `report`, `report diff`, `merge` and `trace` read
the logs of either package.

- events      the run log (`RunLog`, `validate_event`, `derive_run_id`)
              and the trainers' emit homes (`RoundRecorder`,
              `finish_run_log`, heartbeats, early stops).
- counters    process-wide monotonic counters (`snapshot` / `delta`);
              `jit_compiles` counts nvcc builds and CUDA-graph captures.
- annotations `ddt:<phase>` profiler and NVTX ranges; the ops' scopes.
- costmodel   analytic bytes and operations of each kernel's dispatcher
              (`costed`), per call signature, counted per replay; the
              roofline join.
- profiler    torch.profiler capture windows around a round range.
- statusd     the live status daemon (`cli train --status-port`),
              imported only when asked for.
- exposition  the Prometheus text dialect of `/metrics`.
- report, diffing, merge, perfetto: the log's readers, copied from the
              reference.

Without a run log, profile, capture window or status, the trainers pay
no sync, no file write and no import of the daemon: the hooks are
`is not None` tests and two module-global reads a costed call.

Not ported yet: the partition recorder (`PartitionRecorder`, per-rank
phase lanes of a mesh run), which comes with straggler repartition.
"""

from ddt_tpu_torch.telemetry.events import (  # noqa: F401
    EVENT_FIELDS, SCHEMA_VERSION, RoundRecorder, RunLog, derive_run_id,
    partition_skew_summary, validate_event)
from ddt_tpu_torch.telemetry import counters  # noqa: F401
from ddt_tpu_torch.telemetry.annotations import phase_span  # noqa: F401
