"""score.host_ms_per_batch: host milliseconds a batch of `api.predict`'s
work beside the card's, from the program's own spans
(ddt_tpu_torch/telemetry/annotations): `ddt:score.prepare` (the mapper's
validation, the model's digest and the scoring-operand cache) plus
`ddt:score.proba` (margins to probabilities on the host), over the count
of `ddt:score`. The spans accumulate only while the traced window's
profiler records. None where the program keeps no spans."""


def read(x):
    from ddt_tpu_torch.telemetry import annotations
    totals = getattr(annotations, "span_totals", None)
    if totals is None:
        return None
    t = totals()
    batches = t.get("ddt:score", {}).get("count", 0)
    if not batches:
        return None
    s = sum(t[n]["total_s"] for n in ("ddt:score.prepare", "ddt:score.proba")
            if n in t)
    return 1e3 * s / batches
