"""train.capture_ms_per_job: host milliseconds a job of the fused loop's
round capture (`ddt:capture`: `_RoundGraph`'s warm round and CUDA-graph
capture, the OOM ladder's retries included) over the count of the
program's `ddt:train` spans (ddt_tpu_torch/telemetry/annotations); 0.0
when jobs ran and replayed a kept graph. The spans accumulate only while
the traced window's profiler records. None where the program keeps no
spans."""


def read(x):
    from ddt_tpu_torch.telemetry import annotations
    totals = getattr(annotations, "span_totals", None)
    if totals is None:
        return None
    t = totals()
    jobs = t.get("ddt:train", {}).get("count", 0)
    if not jobs:
        return None
    return 1e3 * t.get("ddt:capture", {}).get("total_s", 0.0) / jobs
