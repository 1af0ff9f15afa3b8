"""score.step_mfu_pct: the least time of a batch's work on the card
(binning f32 rows into bins, then K3's traversal) over the batch's
measured time (the traced window over its batches), in %. The copies
over PCIe are no peak of the chip, so this stays low while they rule."""

from benchmark.core import work


def read(x):
    w, peaks = x.get("work"), x["peaks"]
    if w is None or peaks is None or not x.get("batches"):
        return None
    least = work.least_s(w["binning"], peaks) \
        + work.least_s(w["traverse"], peaks)
    return 100.0 * least / x["window_s"]
