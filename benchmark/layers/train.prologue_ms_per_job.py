"""train.prologue_ms_per_job: host milliseconds a job of `api.train`'s
work before its boosting loop, from the program's own spans
(ddt_tpu_torch/telemetry/annotations): `ddt:train.rows` (the ranks'
agreement, the rows' upload and binning, the reference bin counts, the
eval rows' binning) plus `ddt:train.setup` (labels, base score, uploads,
the initial prediction, the ensemble, the eval state), over the count of
`ddt:train`. The spans accumulate only while the traced window's
profiler records. None where the program keeps no spans."""


def read(x):
    from ddt_tpu_torch.telemetry import annotations
    totals = getattr(annotations, "span_totals", None)
    if totals is None:
        return None
    t = totals()
    jobs = t.get("ddt:train", {}).get("count", 0)
    if not jobs:
        return None
    s = sum(t[n]["total_s"] for n in ("ddt:train.rows", "ddt:train.setup")
            if n in t)
    return 1e3 * s / jobs
