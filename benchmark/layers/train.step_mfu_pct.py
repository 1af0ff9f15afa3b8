"""train.step_mfu_pct: the least time of a round's work on rank 0's rows
(K1's histogram work plus the routing, labels, margins, g and h;
benchmark/core/work) over the traced run's own train_round_ms, in %."""

from benchmark.core import work


def read(x):
    w, peaks = x.get("work"), x["peaks"]
    ms = x["end_to_end"].get("train_round_ms")
    if w is None or peaks is None or not ms or not x.get("rounds"):
        return None
    least = work.least_s(w["hist"], peaks) + work.least_s(w["rest"], peaks)
    return 100.0 * least / x["rounds"] / (ms * 1e-3)
