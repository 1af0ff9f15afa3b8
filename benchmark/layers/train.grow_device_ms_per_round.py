"""train.grow_device_ms_per_round: device milliseconds a round of every
kernel in the trace except K1 (`hist_kernel`) and NCCL's: the level
loop's routing, split search and leaves, gradients, binning."""


def read(x):
    s = x["summary"]
    if s is None or not x.get("rounds"):
        return None
    rest = sum(t for n, t in s.kernels.items()
               if "hist_kernel<" not in n and "nccl" not in n.lower())
    return 1e3 * rest / x["rounds"] if s.kernels else None
