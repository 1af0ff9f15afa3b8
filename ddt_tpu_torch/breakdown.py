"""Where the port's main-path time goes on the card.

    python -m ddt_tpu_torch.breakdown

Needs a CUDA card (exits 2 without one). Runs chip_smoke.py's main path
at its shape (the Higgs shape: 1M rows x 28 features, 255 bins, depth 6,
100 trees; fixed, because these numbers are read beside chip_smoke's) in
separately timed pieces, host clock around work that ends in a
synchronize: bin-edge fitting and binning on the host, the boosting loop
on binned data with f32 gradients and with grad_dtype="int8" (quantized),
and scoring (first call: pushdown, upload and packing of the model;
second call: cache hit). Then torch.profiler over PROFILE_TREES boosting
rounds of each gradient type and one warm scoring call gives device time
and launch count by kernel and the device's busy share (sum of device
time over wall time). Prints one JSON object per line; the card's name
and power limit (nvidia-smi) come first.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from ddt_tpu_torch import api
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.data.datasets import synthetic_binary
from ddt_tpu_torch.data.quantizer import fit_bin_mapper

ROWS = 1_000_000
N_TREES = 100
PROFILE_TREES = 5
TOP = 12            # kernels listed per profile
BOOST_GRAD_DTYPES = ("f32", "int8")   # boosting loops timed side by side


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _device_time_us(evt) -> float:
    t = getattr(evt, "self_device_time_total", None)
    return float(t if t is not None else evt.self_cuda_time_total)


def _profiled(fn) -> dict:
    """Wall time, device busy time and the top kernels of fn() under
    torch.profiler (CPU + CUDA activities)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Device-side events only (kernels, memcpy, memset): the op-level
    # rows repeat their kernels' time. CUPTI's own buffer requests are
    # profiler overhead, not work.
    rows = [(e.key, _device_time_us(e), e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("Activity Buffer")]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) * 1e-6
    return {"wall_s": wall, "device_busy_s": busy,
            "busy_share": busy / wall if wall > 0 else None,
            "device_launches": sum(r[2] for r in rows),
            "top": [{"name": k[:80], "device_ms": t * 1e-3, "count": c}
                    for k, t, c in rows[:TOP]]}


def main() -> int:
    if not torch.cuda.is_available():
        print("breakdown: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False

    X, y = synthetic_binary(ROWS, seed=0)
    t0 = time.perf_counter()
    mapper = fit_bin_mapper(X, n_bins=255, seed=0)
    t1 = time.perf_counter()
    Xb = mapper.transform(X)
    t2 = time.perf_counter()
    _emit({"phase": "host_binning", "rows": ROWS,
           "fit_bin_mapper_s": t1 - t0, "transform_s": t2 - t1})

    cfg = TrainConfig(n_trees=N_TREES, max_depth=6, n_bins=255,
                      device="cuda")
    for dt in BOOST_GRAD_DTYPES:
        # Warm-up: kernel build/load and the CUDA context, outside the
        # timing.
        api.train(Xb[:4096], y[:4096], cfg, binned=True, n_trees=1,
                  grad_dtype=dt)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        res_dt = api.train(Xb, y, cfg, binned=True, grad_dtype=dt)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        _emit({"phase": "boost", "grad_dtype": dt, "trees": N_TREES,
               "boost_s": t4 - t3, "ms_per_tree": 1e3 * (t4 - t3) / N_TREES})
        if dt == "f32":
            res = res_dt

    t5 = time.perf_counter()
    api.predict(res.ensemble, Xb, binned=True)
    t6 = time.perf_counter()
    api.predict(res.ensemble, Xb, binned=True)
    t7 = time.perf_counter()
    _emit({"phase": "predict", "rows": ROWS,
           "first_call_s": t6 - t5, "cached_call_s": t7 - t6})

    k = PROFILE_TREES
    for dt in BOOST_GRAD_DTYPES:
        prof = _profiled(lambda: api.train(Xb, y, cfg, binned=True,
                                           n_trees=k, grad_dtype=dt))
        _emit({"phase": "profile_boost", "grad_dtype": dt, "trees": k,
               "ms_per_tree": 1e3 * prof["wall_s"] / k,
               "device_launches_per_tree": prof["device_launches"] / k,
               **prof})
    prof = _profiled(lambda: api.predict(res.ensemble, Xb, binned=True))
    _emit({"phase": "profile_predict_cached", **prof})
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
