"""train.loop_ms_per_round: the fused boosting loop's milliseconds a
round, the mean of the jobs' `history` records (`ms_per_round`, host
clock around each fused block ending in its fetch)."""


def read(x):
    ms = [r["ms_per_round"] for h in x.get("histories", ()) for r in h]
    return sum(ms) / len(ms) if ms else None
