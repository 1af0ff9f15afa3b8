"""train.comms_device_pct: NCCL kernels' share of rank 0's kernel time
in the traced window, in % (row-partitioned cells)."""


def read(x):
    s = x["summary"]
    if s is None or x.get("world", 1) < 2:
        return None
    total = sum(s.kernels.values())
    nccl = sum(t for n, t in s.kernels.items() if "nccl" in n.lower())
    return 100.0 * nccl / total if total > 0 else None
