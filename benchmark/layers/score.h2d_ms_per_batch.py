"""score.h2d_ms_per_batch: device milliseconds of host-to-device copies a
batch (the float rows' upload for binning on the card)."""


def read(x):
    s = x["summary"]
    if s is None or not x.get("batches") or not s.copies:
        return None
    h2d = sum(t for n, t in s.copies.items() if "HtoD" in n)
    return 1e3 * h2d / x["batches"]
