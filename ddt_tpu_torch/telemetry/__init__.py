"""Structured telemetry of the port (port of ddt_tpu/telemetry): the same
schema-v5 run log, so `report`, `report diff`, `merge` and `trace` read
the logs of either package.

- events      the run log (`RunLog`, `validate_event`, `derive_run_id`)
              and the trainers' emit homes (`RoundRecorder`,
              `finish_run_log`, heartbeats, early stops), and the
              partition recorder (`PartitionRecorder`: per-rank phase
              lanes of a mesh run, the straggler watchdog's feed).
- counters    process-wide monotonic counters (`snapshot` / `delta`);
              `jit_compiles` counts nvcc builds and CUDA-graph captures.
- annotations the `ddt:<name>` spans at the layer boundaries and the
              ops' stages: profiler ranges, live while a torch profiler
              records or a profiled trainer times its sub-phases, kept
              in memory (`span_totals`, `span_records`, `reset_spans`).
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
`is not None` tests and two module-global reads a costed call; a span
site reads a module global and the profiler's flag.
"""

from ddt_tpu_torch.telemetry.events import (  # noqa: F401
    EVENT_FIELDS, SCHEMA_VERSION, PartitionRecorder, RoundRecorder, RunLog,
    derive_run_id, partition_skew_summary, validate_event)
from ddt_tpu_torch.telemetry import counters  # noqa: F401
