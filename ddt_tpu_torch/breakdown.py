"""Where the port's main-path time goes on the card.

    python -m ddt_tpu_torch.breakdown

Needs a CUDA card (exits 2 without one). Runs chip_smoke.py's main path
at its shape (the Higgs shape: 1M rows x 28 features, 255 bins, depth 6,
100 trees; fixed, because these numbers are read beside chip_smoke's) in
separately timed pieces, host clock around work that ends in a
synchronize:

- binning: bin-edge fitting on the host, the f32 upload, binning on the
  card (ops/quantize), and the host transform it replaced;
- the boosting loop on the card-binned rows, f32 and grad_dtype="int8",
  fused (Driver._fit_fused: replays of one captured round) beside the
  granular loop (Driver._fit_granular), with the capture's one-off cost
  (its warm-up round and the capture) apart;
- the fused loop at BASELINE config 3's layout (synthetic_ctr, 1M rows:
  13 numeric + 26 frequency-binned one-vs-rest columns, 255 bins, depth
  6, 100 trees), f32 and int8, the second of two runs (the first holds
  the capture): the one-card figure chip_smoke's `multi` phase scales;
- the fused loop at BASELINE config 5's width (stress_binned_chunk:
  1M binned rows x 1024 features, 255 bins, depth 6, 20 trees), f32 and
  int8, the second of two runs, and K1's share of a profiled window:
  the one-card figure chip_smoke's `mesh2d` phase splits over a mesh;
- scoring: api.predict on the float rows (upload, binning, first call:
  pushdown, upload and packing of the model; then a cache hit), and a
  cached call on binned rows.

Then torch.profiler over PROFILE_TREES rounds of each loop and gradient
type, after a call that captured the round, and one warm scoring call:
device time and count by kernel, the device's busy share (sum of device
time over wall time), host launches a tree (the runtime's kernel-launch,
graph-launch, copy and fill calls the host made), graph replays a tree
and the histogram kernel's device ms per tree (L2 warm, as in the loop).
Prints one JSON object per line; the card's name and power limit
(nvidia-smi) come first and last.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from ddt_tpu_torch import api
from ddt_tpu_torch.backends import cuda as cuda_backend
from ddt_tpu_torch.backends import get_backend
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.data.categorical import fit_categorical_encoder
from ddt_tpu_torch.data.datasets import (stress_binned_chunk,
                                         synthetic_binary, synthetic_ctr)
from ddt_tpu_torch.data.quantizer import fit_bin_mapper
from ddt_tpu_torch.driver import Driver
from ddt_tpu_torch.models.tree import empty_ensemble
from ddt_tpu_torch.ops.grad import base_score_np
from ddt_tpu_torch.telemetry.profiler import device_rows, is_range

ROWS = 1_000_000
N_TREES = 100
STRESS_FEATURES = 1024      # BASELINE config 5's width
STRESS_TREES = 20
PROFILE_TREES = 5
TOP = 12            # kernels listed per profile
BOOST_GRAD_DTYPES = ("f32", "int8")   # boosting loops timed side by side
#: Host-side runtime calls that put work on the device (CUPTI's names).
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
                     "cudaMemcpyAsync", "cudaMemsetAsync")


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _synced(fn):
    """(fn(), host seconds of fn ending in a synchronize)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def profiled(fn, pad_s: float = 0.0) -> dict:
    """Wall time, device busy time, host launch calls and the top kernels
    of fn() under torch.profiler (CPU + CUDA activities).

    `pad_s` keeps the profile open and idle that long before and after
    fn (outside its wall time), so that device events the tracer misses
    at the start or end of a window (its first ~120 ms went unrecorded
    in a profile opened late in a long process) still fall inside the
    profile. `device_lead_ms` is how long before the first host launch
    call the first device event starts: a device event cannot start
    before it is launched, so a lead > 0 is the tracer's device clock
    reading early by at least that much."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(pad_s)
    starts = {torch.autograd.DeviceType.CPU: [],
              torch.autograd.DeviceType.CUDA: []}
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not e.name.startswith("Activity Buffer")
                and not is_range(e)) or (
                e.device_type == torch.autograd.DeviceType.CPU
                and e.name.startswith(HOST_LAUNCH_CALLS)):
            starts[e.device_type].append(e.time_range.start)
    launched, ran = starts.values()
    lead = (1e-3 * (min(launched) - min(ran)) if launched and ran
            else None)
    events = prof.key_averages()
    rows = sorted((r for r in device_rows(events) if r[1] > 0),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows) * 1e-6
    hist = sum(r[1] for r in rows if "hist_kernel" in r[0]) * 1e-3
    host = {e.key: e.count for e in events
            if e.device_type == torch.autograd.DeviceType.CPU
            and e.key.startswith(HOST_LAUNCH_CALLS)}
    return {"wall_s": wall, "device_busy_s": busy, "hist_kernel_ms": hist,
            "busy_share": busy / wall if wall > 0 else None,
            "device_launches": sum(r[2] for r in rows),
            "device_lead_ms": lead,
            "host_launch_calls": sum(host.values()), "host_calls": host,
            "top": [{"name": k[:80], "device_ms": t * 1e-3, "count": c}
                    for k, t, c in rows[:TOP]]}


class _Loops:
    """The fused and granular loops of one config on data already on the
    card, from the base score, as Driver.fit runs them."""

    def __init__(self, cfg: TrainConfig, Xb: torch.Tensor, y):
        self.cfg = cfg
        self.be = get_backend(cfg)
        self.data = self.be.upload(Xb)
        self.y = self.be.upload_labels(y)
        self.bs = base_score_np(y, cfg.loss)
        self.F = Xb.shape[1]

    def run(self, fused: bool, n_trees: int):
        cfg = self.cfg.replace(n_trees=n_trees)
        ens = empty_ensemble(n_trees, cfg.max_depth, self.F,
                             cfg.learning_rate, self.bs, cfg.loss,
                             n_bins=cfg.n_bins)
        drv = Driver(self.be, cfg)
        pred = self.be.init_pred(self.y, self.bs)
        loop = drv._fit_fused if fused else drv._fit_granular
        return loop(self.data, self.y, pred, ens)


def config3_fused(cfg: TrainConfig) -> None:
    """The fused loop's ms a tree at config 3's layout, f32 and int8."""
    Xn, Xc, y = synthetic_ctr(ROWS, seed=0)
    enc = fit_categorical_encoder(Xc, n_bins=255)
    X = np.concatenate([Xn, enc.transform(Xc).astype(np.float32)], axis=1)
    cat = tuple(range(Xn.shape[1], X.shape[1]))
    mapper = fit_bin_mapper(X, n_bins=255, cat_features=cat, seed=0)
    Xb = mapper.transform_device(X, torch.device("cuda"))
    for dt in BOOST_GRAD_DTYPES:
        lp = _Loops(cfg.replace(grad_dtype=dt, cat_features=cat), Xb, y)
        lp.run(True, N_TREES)
        _, fused_s = _synced(lambda: lp.run(True, N_TREES))
        _emit({"phase": "boost_config3", "grad_dtype": dt,
               "trees": N_TREES, "rows": ROWS, "features": X.shape[1],
               "categorical": len(cat),
               "fused_ms_per_tree": 1e3 * fused_s / N_TREES})


def stress_fused(cfg: TrainConfig) -> None:
    """The fused loop's ms a tree at config 5's width on one card, f32
    and int8, and K1's share of a profiled window of PROFILE_TREES."""
    Xb, y = stress_binned_chunk(0, ROWS, n_features=STRESS_FEATURES,
                                n_bins=255, seed=0)
    Xd = torch.from_numpy(Xb).to("cuda")
    del Xb
    for dt in BOOST_GRAD_DTYPES:
        lp = _Loops(cfg.replace(grad_dtype=dt), Xd, y)
        lp.run(True, STRESS_TREES)
        _, fused_s = _synced(lambda: lp.run(True, STRESS_TREES))
        prof = profiled(lambda: lp.run(True, PROFILE_TREES))
        k1 = prof["hist_kernel_ms"] / PROFILE_TREES
        _emit({"phase": "boost_stress", "grad_dtype": dt,
               "trees": STRESS_TREES, "rows": ROWS,
               "features": STRESS_FEATURES,
               "fused_ms_per_tree": 1e3 * fused_s / STRESS_TREES,
               "profile_ms_per_tree": 1e3 * prof["wall_s"] / PROFILE_TREES,
               "k1_ms_per_tree": k1,
               "k1_share_of_device": k1 * 1e-3 * PROFILE_TREES
               / prof["device_busy_s"],
               "busy_share": prof["busy_share"], "top": prof["top"]})


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
    dev = torch.device("cuda")

    X, y = synthetic_binary(ROWS, seed=0)
    # Warm-up: the CUDA context and every kernel library, outside the
    # timings.
    small = api.train(X[:4096], y[:4096], n_trees=1)
    api.predict(small.ensemble, X[:4096], mapper=small.mapper)
    mapper, fit_s = _synced(lambda: fit_bin_mapper(X, n_bins=255, seed=0))
    # Each step twice: the first call at this size also grows the
    # allocator's pool.
    up = [_synced(lambda: torch.from_numpy(X).to(dev)) for _ in range(2)]
    Xd = up[-1][0]
    bins = [_synced(lambda: mapper.transform_device(Xd, dev))
            for _ in range(2)]
    Xb = bins[-1][0]
    _, host_s = _synced(lambda: mapper.transform(X))
    _emit({"phase": "binning", "rows": ROWS, "fit_bin_mapper_s": fit_s,
           "upload_f32_s": [t for _, t in up],
           "device_transform_s": [t for _, t in bins],
           "host_transform_s": host_s})

    cfg = TrainConfig(n_trees=N_TREES, max_depth=6, n_bins=255,
                      device="cuda")
    loops = {}
    for dt in BOOST_GRAD_DTYPES:
        lp = loops[dt] = _Loops(cfg.replace(grad_dtype=dt), Xb, y)
        r0 = cuda_backend.graph_replays
        first, first_s = _synced(lambda: lp.run(True, N_TREES))
        capture_s = lp.be.last_capture_s
        _, fused_s = _synced(lambda: lp.run(True, N_TREES))
        _, gran_s = _synced(lambda: lp.run(False, N_TREES))
        _emit({"phase": "boost", "grad_dtype": dt, "trees": N_TREES,
               "fused_ms_per_tree": 1e3 * fused_s / N_TREES,
               "granular_ms_per_tree": 1e3 * gran_s / N_TREES,
               "fused_first_call_s": first_s, "capture_s": capture_s,
               "graph_replays": cuda_backend.graph_replays - r0})
        if dt == "f32":
            res = first
    config3_fused(cfg)
    stress_fused(cfg)

    _, first_s = _synced(lambda: api.predict(res, X, mapper=mapper))
    _, cached_s = _synced(lambda: api.predict(res, X, mapper=mapper))
    _, binned_s = _synced(lambda: api.predict(res, Xb, binned=True))
    _emit({"phase": "predict", "rows": ROWS,
           "float_rows_first_call_s": first_s,
           "float_rows_cached_call_s": cached_s,
           "binned_cached_call_s": binned_s})

    k = PROFILE_TREES
    for dt in BOOST_GRAD_DTYPES:
        lp = loops[dt]
        for fused in (True, False):
            r0 = cuda_backend.graph_replays
            prof = profiled(lambda: lp.run(fused, k))
            _emit({"phase": "profile_boost", "grad_dtype": dt,
                   "loop": "fused" if fused else "granular", "trees": k,
                   "ms_per_tree": 1e3 * prof["wall_s"] / k,
                   "device_launches_per_tree": prof["device_launches"] / k,
                   "host_launches_per_tree":
                       prof["host_launch_calls"] / k,
                   "graph_replays_per_tree":
                       (cuda_backend.graph_replays - r0) / k,
                   "hist_kernel_ms_per_tree": prof["hist_kernel_ms"] / k,
                   **prof})
    prof = profiled(lambda: api.predict(res, Xb, binned=True))
    _emit({"phase": "profile_predict_cached", **prof})
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
