"""Benchmark library of the port (port of ddt_tpu/bench.py): the
measurements behind `python -m ddt_tpu_torch.cli bench --kernel=K`.

Every function returns a plain dict with the reference's function name,
record keys and defaults, so the two packages' records read side by side,
with these differences:

- `device`: the card's name and power limit as nvidia-smi gives them
  ({"name": ..., "power_limit_w": ...}, utils/card.stamp) on a record
  taken on a card, "cpu" on one taken on the CPU.
- The reference's `jit_compiles` (a JAX compile-listener count) becomes
  `graph_captures`, the CUDA graphs captured in the timed window
  (telemetry/counters.graph_captures), and `launches`, the kernel
  launches counted there, by kernel (hist, hist_f32, hist_int, traverse,
  lut, lut4; a kernel that did not launch is left out). A timed loop that
  launches more than its builds imply, or captures again, shows churn the
  way `jit_compiles` did. On the CPU the plain versions run, so nothing
  launches.
- `*_roofline_flops_util` / `*_roofline_hbm_util`: the costed ops'
  analytic operations and bytes (telemetry/costmodel.costed) at the
  measured time, against telemetry/costmodel.peaks_for's row of the
  platform.

Times are host clocks around the calls, ending in a synchronize of the
card (a scalar fetch where the reference fetched one), with the
statistic each reference function uses: min of reps, the median of
paired ratios (`_paired_ab_reps`: order alternating every rep), and both
the median and the min where the reference reports both.

Entry points run on the card unless the caller passes device="cpu" (the
kernels' plain versions) or backend="cpu" (the NumPy / native C++
oracle). The multi-rank arms (`bench_hist_comms_ab`, `bench_hist_2d`,
and `partitions` > 1) run their ranks through parallel/spawn.Pool: NCCL,
one card a rank, on "cuda", gloo on "cpu". More ranks than visible cards
raise; nothing falls back to gloo or to the CPU.

Arms and what they run: histogram (K1's exact mode, the f32 training
mode, through CUDADevice.build_histograms), histogram_ab (K1 at 255 bins
against K2's 64-bin regime), histogram_one_dispatch (`iters` K1 launches
in one CUDA-graph replay), train (api.train), hist_fused_ab /
hist_quant_ab / hist_comms_ab / hist_2d (the fused loop,
CUDADevice.grow_rounds: replays of a captured round), predict /
predict_both / predict_cuda_ab (K3), predict_lut_ab (K4 against K3),
predict_lut4_ab (K5 against K4, and the serving engine's express lane),
serve_latency (serve/engine.ServeEngine) and registry_cold_load
(registry/loader.load_servable).
"""

from __future__ import annotations

import shutil
import tempfile
import threading
import time

import numpy as np
import torch

from ddt_tpu_torch import _build, api
from ddt_tpu_torch.backends import get_backend, row_sharded_backend
from ddt_tpu_torch.backends.cuda import CUDADevice
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.data import datasets
from ddt_tpu_torch.data.quantizer import quantize
from ddt_tpu_torch.models.tree import empty_ensemble
from ddt_tpu_torch.ops import grad as grad_ops
from ddt_tpu_torch.ops import histogram as hist_ops
from ddt_tpu_torch.ops import (hist_cuda, predict_cuda, predict_lut,
                               predict_lut_cuda)
from ddt_tpu_torch.ops import predict as predict_ops
from ddt_tpu_torch.parallel import mesh, spawn
from ddt_tpu_torch.registry.loader import load_servable, push_servable
from ddt_tpu_torch.serve.engine import (ServableModel, ServeEngine,
                                        default_buckets)
from ddt_tpu_torch.telemetry import costmodel
from ddt_tpu_torch.telemetry import counters as tele_counters
from ddt_tpu_torch.utils import card, launches

#: (record name, module, counter) of every kernel launch counter.
KERNEL_COUNTERS = (
    ("hist", hist_cuda, "launches_exact"),
    ("hist_f32", hist_cuda, "launches"),
    ("hist_int", hist_cuda, "launches_int"),
    ("traverse", predict_cuda, "launches"),
    ("lut", predict_lut_cuda, "launches_lut"),
    ("lut4", predict_lut_cuda, "launches_lut4"),
)


# --------------------------------------------------------------------- #
# shared pieces
# --------------------------------------------------------------------- #

def _hist_inputs(rows, features, bins, n_nodes, seed):
    rng = np.random.default_rng(seed)
    Xb = rng.integers(0, bins, size=(rows, features), dtype=np.uint8)
    g = rng.standard_normal(rows).astype(np.float32)
    h = rng.random(rows).astype(np.float32) + 0.5
    node_index = rng.integers(0, n_nodes, size=rows).astype(np.int32)
    return Xb, g, h, node_index


def _paired_ab_reps(bout, key_a, key_b, reps: int):
    """Order-alternating paired reps: `bout(key)` runs and times one bout
    of that arm. Returns ({key: [dt, ...]}, [dt_a / dt_b per rep]);
    callers reduce the per-arm dts (min or median) and take the median of
    the ratios as the A/B evidence."""
    dts = {key_a: [], key_b: []}
    ratios = []
    for rep in range(reps):
        order = (key_a, key_b) if rep % 2 == 0 else (key_b, key_a)
        pair = {}
        for k in order:
            pair[k] = bout(k)
            dts[k].append(pair[k])
        ratios.append(pair[key_a] / pair[key_b])
    return dts, ratios


def _need(device: str) -> None:
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but torch.cuda.is_available() is False; pass "
            "device='cpu' to run the plain versions on the CPU")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _launch_counts() -> dict:
    return {name: getattr(mod, attr) for name, mod, attr in KERNEL_COUNTERS}


class _Window:
    """The counters over one timed window: kernel launches by kernel (the
    ones that moved) and CUDA graphs captured."""

    def __init__(self):
        self.l0 = _launch_counts()
        self.c0 = tele_counters.graph_captures()

    def read(self) -> dict:
        now = _launch_counts()
        moved = {k: now[k] - self.l0[k] for k in now if now[k] != self.l0[k]}
        return {"graph_captures": tele_counters.graph_captures() - self.c0,
                "launches": moved}


def _roofline_util(prefix: str, fn, sec_per_call: float) -> dict:
    """{<prefix>_roofline_flops_util, <prefix>_roofline_hbm_util}: the
    costed ops one fn() call runs (telemetry/costmodel's analytic
    operations and bytes, a replayed capture's included) at the measured
    seconds a call, against the platform's peak row. {} when fn runs no
    costed op."""
    col = costmodel.activate()
    try:
        fn()
    finally:
        costmodel.deactivate(col)
    recs = col.events()
    if not recs or sec_per_call <= 0:
        return {}
    flops = sum(r["flops"] * r["calls"] for r in recs)
    nbytes = sum(r["bytes_accessed"] * r["calls"] for r in recs)
    peaks = costmodel.peaks_for(recs[0]["platform"])
    return {
        f"{prefix}_roofline_flops_util":
            flops / sec_per_call / 1e9 / peaks["gflops"],
        f"{prefix}_roofline_hbm_util":
            nbytes / sec_per_call / 1e9 / peaks["gbs"],
    }


def _on_ranks(world: int, device: str, fn, *args) -> list:
    """fn(device, *args) on `world` fresh ranks of one process group
    (parallel/spawn): NCCL, one card a rank, on "cuda", gloo on
    "cpu". Raises when more ranks than visible cards are asked."""
    if device == "cuda":
        _need(device)
        n = torch.cuda.device_count()
        if world > n:
            raise ValueError(
                f"{world} ranks asked on device='cuda' but {n} card(s) are "
                "visible: one card a rank (device='cpu' runs gloo ranks)")
    return spawn.spawn(fn, world, "nccl" if device == "cuda" else "gloo",
                       device, *args)


# --------------------------------------------------------------------- #
# histogram
# --------------------------------------------------------------------- #

def bench_histogram(
    backend: str = "cuda",
    rows: int = 1_000_000,
    features: int = 28,
    bins: int = 255,
    n_nodes: int = 32,
    iters: int = 10,
    partitions: int = 1,
    seed: int = 0,
    reps: int = 3,
    device: str = "cuda",
) -> dict:
    """Time the histogram build alone. n_nodes=32 is the deepest level of
    the depth-6 Higgs config. backend="cuda": CUDADevice.build_histograms,
    K1's exact mode as f32 training runs it (the wrapper's scale passes
    included); backend="cpu": the oracle's native C++ (or NumPy)
    histogram. Min of `reps` on both. `partitions` > 1 builds on that many
    ranks (each its row block, the table all-reduced) and divides the rate
    per card."""
    if partitions > 1 and not mesh.is_initialized():
        return _on_ranks(partitions, device, _histogram_rank, dict(
            backend=backend, rows=rows, features=features, bins=bins,
            n_nodes=n_nodes, iters=iters, partitions=partitions,
            seed=seed, reps=reps))[0]
    if backend == "cuda":
        _need(device)
    cfg = TrainConfig(n_bins=bins, backend=backend, n_partitions=partitions,
                      device=device)
    be = get_backend(cfg)
    Xb, g, h, node_index = _hist_inputs(rows, features, bins, n_nodes, seed)
    data = be.upload(Xb)
    if backend == "cuda":
        g, h, node_index = (be._block(a, be._put)
                            for a in (g, h, node_index))
    dev = be.device
    be.build_histograms(data, g, h, node_index, n_nodes)     # warm-up
    _sync(dev)
    dt = float("inf")
    win = _Window()
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            be.build_histograms(data, g, h, node_index, n_nodes)
        _sync(dev)
        dt = min(dt, (time.perf_counter() - t0) / iters)
    window = win.read()
    if backend == "cuda":
        impl = "k1-exact" if dev.type == "cuda" else "plain-exact"
    else:
        impl = "native-c++" if be.hist_impl == "native" else "numpy"
    n_chips = max(1, partitions)
    rec = {
        "kernel": "histogram",
        "backend": backend,
        "impl": impl,
        "rows": rows, "features": features, "bins": bins, "n_nodes": n_nodes,
        "iters": iters, "partitions": partitions,
        "sec_per_build": dt,
        "mrows_per_sec_per_chip": rows / dt / 1e6 / n_chips,
        **window,
        "device": card.stamp(dev),
    }
    if backend == "cuda" and partitions == 1:
        rec.update(_roofline_util(
            "hist", lambda: be.build_histograms(data, g, h, node_index,
                                                n_nodes), dt))
    return rec


def _histogram_rank(device: str, kw: dict) -> dict:
    return bench_histogram(device=device, **kw)


def bench_histogram_ab(
    bins_a: int = 255,
    bins_b: int = 64,
    rows: int = 1_000_000,
    features: int = 28,
    n_nodes: int = 32,
    iters: int = 10,
    reps: int = 8,
    seed: int = 0,
    device: str = "cuda",
) -> dict:
    """Paired two-arm histogram timing: K1 at `bins_a` against K2's
    <= 128-bin regime at `bins_b`, each through CUDADevice.build_histograms
    (exact mode). Per-arm throughputs are min of reps; the ratio field is
    the median of the paired ratios (dt_a / dt_b)."""
    _need(device)
    arms = {}
    for bins in (bins_a, bins_b):
        be = CUDADevice(TrainConfig(n_bins=bins, device=device))
        Xb, g, h, ni = _hist_inputs(rows, features, bins, n_nodes, seed)
        args = (be.upload(Xb), be._put(g), be._put(h), be._put(ni))
        be.build_histograms(*args, n_nodes)          # warm-up
        arms[bins] = (be, args)
    _sync(device)

    def bout(bins):
        be, args = arms[bins]
        t0 = time.perf_counter()
        for _ in range(iters):
            be.build_histograms(*args, n_nodes)
        _sync(device)
        return (time.perf_counter() - t0) / iters

    win = _Window()
    dts, ratios = _paired_ab_reps(bout, bins_a, bins_b, reps)
    window = win.read()
    dt_a, dt_b = min(dts[bins_a]), min(dts[bins_b])
    out = {
        "kernel": "histogram_ab",
        "rows": rows, "features": features, "n_nodes": n_nodes,
        "bins_a": bins_a, "bins_b": bins_b,
        "mrows_a": rows / dt_a / 1e6, "mrows_b": rows / dt_b / 1e6,
        "ratio_b_over_a": float(np.median(ratios)),
        "iters": iters, "reps": reps,
        **window,
        "device": card.stamp(device),
    }
    be_a, args_a = arms[bins_a]
    out.update(_roofline_util(
        "hist", lambda: be_a.build_histograms(*args_a, n_nodes), dt_a))
    return out


def bench_histogram_one_dispatch(
    rows: int = 1_000_000,
    features: int = 28,
    bins: int = 255,
    n_nodes: int = 32,
    iters: int = 10,
    reps: int = 8,
    seed: int = 0,
    device: str = "cuda",
) -> dict:
    """`iters` K1 launches (exact mode) in ONE CUDA-graph replay, the
    counterpart of the reference's one jitted fori_loop: one host round
    trip a rep instead of one a build. A tiny data dependence (g advanced
    by 1e-30 x a cell of the previous table) chains the builds. The
    median of reps is the headline `mrows_per_sec_per_chip`, the min is
    kept as the `_min` fields. On the CPU the same loop runs eagerly."""
    _need(device)
    dev = torch.device(device)
    Xb_h, g_h, h_h, ni_h = _hist_inputs(rows, features, bins, n_nodes, seed)
    Xb, g0, h, ni = (torch.from_numpy(a).to(dev)
                     for a in (Xb_h, g_h, h_h, ni_h))
    scales = grad_ops.fixed_scales(grad_ops.abs_max2(g0, h), rows)
    g2 = g0.clone()
    acc = torch.zeros((), dtype=torch.float32, device=dev)

    def k_in_one():
        for _ in range(iters):
            out = hist_ops.build_histograms_exact(Xb, g2, h, ni, n_nodes,
                                                  bins, scales)
            s = out[0, 0, 0, 0].to(torch.float32) * 1e-30
            g2.add_(s)
            acc.add_(s)

    k_in_one()                              # loads the kernel, plans it
    _sync(dev)
    if dev.type == "cuda":
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with launches.recording() as rec, torch.cuda.graph(
                graph, capture_error_mode="thread_local"):
            k_in_one()
        torch.cuda.synchronize()
        tele_counters.graph_captured(time.perf_counter() - t0)

        def run():
            graph.replay()
            rec.replayed()
            return float(acc)               # scalar fetch = the barrier
    else:
        def run():
            k_in_one()
            return float(acc)

    run()                                   # first replay
    win = _Window()
    dts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        dts.append((time.perf_counter() - t0) / iters)
    window = win.read()
    dt_med = float(np.median(dts))
    dt_min = float(np.min(dts))
    return {
        "kernel": "histogram_one_dispatch",
        "rows": rows, "features": features, "bins": bins,
        "n_nodes": n_nodes, "iters": iters, "reps": reps,
        "sec_per_build": dt_med,
        "sec_per_build_min": dt_min,
        "mrows_per_sec_per_chip": rows / dt_med / 1e6,
        "mrows_per_sec_per_chip_min": rows / dt_min / 1e6,
        **window,
        "device": card.stamp(dev),
    }


# --------------------------------------------------------------------- #
# the fused loop (whole trees)
# --------------------------------------------------------------------- #

def _fused_inputs(rows, features, bins, seed):
    """Binned rows and binary labels from the seed (the reference's
    Xb draw first, then labels)."""
    rng = np.random.default_rng(seed)
    Xb = rng.integers(0, bins, size=(rows, features), dtype=np.uint8)
    y = (rng.random(rows) < 0.5).astype(np.float32)
    return Xb, y


def _fused_ab(device: str, arms: list, data_kw: dict, iters: int,
              reps: int, roofline: "tuple | None" = None) -> dict:
    """Paired whole-tree timing of two arms [(key, TrainConfig kwargs)] of
    the fused loop (CUDADevice.grow_rounds: on the card, replays of one
    captured round) on the same rows: the per-arm seconds a tree, the
    paired ratios (dt_arm0 / dt_arm1), each arm's launches a tree, the
    timed window's counters and the arms' layouts, and with `roofline`
    (prefix, arm) that arm's roofline shares. On a rank, this rank's
    block (every rank runs the same sequence; the collectives pace
    them)."""
    Xb, y = _fused_inputs(**data_kw)
    state = {}
    for key, kw in arms:
        cfg = TrainConfig(n_bins=data_kw["bins"], device=device, **kw)
        be = CUDADevice(cfg)
        data = be.upload(Xb)
        yh = be.upload_labels(y)
        pred = be.init_pred(yh, 0.0)
        be.grow_rounds(data, pred, yh, iters)        # warm-up (captures)
        _sync(be.device)
        probe = _Window()
        be.grow_rounds(data, pred, yh, 1)
        _sync(be.device)
        state[key] = (be, data, yh, pred, probe.read()["launches"])

    def bout(key):
        be, data, yh, pred, _ = state[key]
        t0 = time.perf_counter()
        be.grow_rounds(data, pred, yh, iters)
        _sync(be.device)
        return (time.perf_counter() - t0) / iters

    win = _Window()
    dts, ratios = _paired_ab_reps(bout, arms[0][0], arms[1][0], reps)
    window = win.read()
    expected: dict = {}
    for key, *_ in arms:
        for k, n in state[key][4].items():
            expected[k] = expected.get(k, 0) + n * iters * reps
    out = {
        "dts": dts, "ratios": ratios,
        "per_tree_launches": {k: s[4] for k, s in state.items()},
        "launches_expected": expected, **window,
        "layout": {k: {"row_shards": s[0].world,
                       "feature_shards": (1 if s[0].mesh is None
                                          else s[0].mesh.n_feature_shards),
                       "split_comms": s[0].split_comms,
                       "hist_subtraction": s[0].hist_subtraction}
                   for k, s in state.items()},
        "device": card.stamp(state[arms[0][0]][0].device),
    }
    if roofline is not None:
        prefix, arm = roofline
        be, data, yh, pred, _ = state[arm]
        out.update(_roofline_util(
            prefix, lambda: be.grow_rounds(data, pred, yh, 1),
            min(dts[arm])))
    return out


def _window_fields(res: dict) -> dict:
    """What a fused A/B record carries of _fused_ab's result beside its
    own numbers: the window's counters, the device, the roofline."""
    return {k: v for k, v in res.items()
            if k in ("graph_captures", "launches", "launches_expected",
                     "per_tree_launches", "device")
            or "_roofline_" in k}


def bench_hist_fused_ab(
    rows: int = 1_000_000,
    features: int = 28,
    bins: int = 255,
    depth: int = 6,
    iters: int = 4,
    reps: int = 8,
    seed: int = 0,
    device: str = "cuda",
) -> dict:
    """Paired whole-tree A/B of the fused loop with sibling subtraction
    on against off, at the Higgs-1M depth-6 shape: min of reps per arm,
    the median paired ratio (dt_off / dt_on: > 1 means subtraction wins).
    Throughputs are nominal hist-row-equivalents (rows x depth / s)."""
    _need(device)
    res = _fused_ab(device, [("off", {"max_depth": depth, "seed": seed,
                                      "hist_subtraction": "off"}),
                             ("on", {"max_depth": depth, "seed": seed,
                                     "hist_subtraction": "on"})],
                    dict(rows=rows, features=features, bins=bins,
                         seed=seed), iters, reps,
                    roofline=("hist_fused", "on"))
    dt_on, dt_off = min(res["dts"]["on"]), min(res["dts"]["off"])
    return {
        "kernel": "hist_fused_ab",
        "rows": rows, "features": features, "bins": bins, "depth": depth,
        "iters": iters, "reps": reps,
        "mrows_on": rows * depth / dt_on / 1e6,
        "mrows_off": rows * depth / dt_off / 1e6,
        "ratio_on_over_off": float(np.median(res["ratios"])),
        **_window_fields(res),
    }


def bench_hist_quant_ab(
    rows: int = 1_000_000,
    features: int = 28,
    bins: int = 255,
    depth: int = 6,
    iters: int = 4,
    reps: int = 8,
    seed: int = 0,
    grad_dtype: str = "int8",
    device: str = "cuda",
) -> dict:
    """Paired whole-tree A/B of the fused loop with grad_dtype "f32"
    against "int8" (or "int16"), each arm at its own sibling-subtraction
    default: min of reps per arm, the median paired ratio
    (dt_f32 / dt_quant: > 1 means the integer path wins), and the
    deterministic g/h stream byte model's payload_ratio (4 int8, 2
    int16)."""
    _need(device)
    res = _fused_ab(device, [(dt, {"max_depth": depth, "seed": seed,
                                   "grad_dtype": dt})
                             for dt in ("f32", grad_dtype)],
                    dict(rows=rows, features=features, bins=bins,
                         seed=seed), iters, reps,
                    roofline=("hist_quant", grad_dtype))
    dt_q, dt_f = min(res["dts"][grad_dtype]), min(res["dts"]["f32"])
    bytes_f = tele_counters.grad_stream_bytes(rows, depth, "f32")
    bytes_q = tele_counters.grad_stream_bytes(rows, depth, grad_dtype)
    return {
        "kernel": "hist_quant_ab",
        "rows": rows, "features": features, "bins": bins, "depth": depth,
        "iters": iters, "reps": reps, "grad_dtype": grad_dtype,
        "mrows_quant": rows * depth / dt_q / 1e6,
        "mrows_f32": rows * depth / dt_f / 1e6,
        "ratio_f32_over_quant": float(np.median(res["ratios"])),
        "grad_stream_bytes_f32": bytes_f,
        "grad_stream_bytes_quant": bytes_q,
        "payload_ratio": round(bytes_f / bytes_q, 3),
        **_window_fields(res),
    }


def _default_ranks(device: str) -> int:
    """Ranks a multi-rank arm takes unless told: every visible card, up to
    4, on "cuda"; 4 gloo ranks on "cpu"."""
    if device == "cuda":
        _need(device)
        return min(4, torch.cuda.device_count())
    return 4


def bench_hist_comms_ab(
    rows: int = 1_000_000,
    features: int = 28,
    bins: int = 255,
    depth: int = 6,
    iters: int = 4,
    reps: int = 8,
    seed: int = 0,
    host_partitions: int | None = None,
    n_partitions: int | None = None,
    device: str = "cuda",
) -> dict:
    """Paired split-comms A/B: the fused loop with split_comms="allreduce"
    against "reduce_scatter", same rows, same ranks. Default layout: hosts
    x rows over every rank (2 x P/2 from 4 ranks, so the collective
    crosses the hosts axis; 1 x P below). Min of reps per arm, the median
    paired ratio (dt_allreduce / dt_rs: > 1 means reduce-scatter wins),
    and the deterministic per-tree payload model of both modes."""
    if host_partitions is None or n_partitions is None:
        n_dev = _default_ranks(device)
        if n_dev >= 4:
            host_partitions, n_partitions = 2, n_dev // 2
        else:
            host_partitions, n_partitions = 1, max(1, n_dev)
    world = host_partitions * n_partitions
    arms = [(mode, {"max_depth": depth, "seed": seed,
                    "host_partitions": host_partitions,
                    "n_partitions": n_partitions, "split_comms": mode})
            for mode in ("allreduce", "reduce_scatter")]
    data_kw = dict(rows=rows, features=features, bins=bins, seed=seed)
    if world > 1:
        res = _on_ranks(world, device, _fused_ab, arms, data_kw, iters,
                        reps)[0]
    else:
        _need(device)
        res = _fused_ab(device, arms, data_kw, iters, reps)
    dt_rs = min(res["dts"]["reduce_scatter"])
    dt_ar = min(res["dts"]["allreduce"])
    P = res["layout"]["allreduce"]["row_shards"]
    bytes_ar = tele_counters.hist_allreduce_bytes(depth, features, bins,
                                                  partitions=P)
    bytes_rs = tele_counters.hist_allreduce_bytes(
        depth, features, bins, partitions=P, mode="reduce_scatter")
    return {
        "kernel": "hist_comms_ab",
        "rows": rows, "features": features, "bins": bins, "depth": depth,
        "iters": iters, "reps": reps,
        "host_partitions": host_partitions, "n_partitions": n_partitions,
        "mrows_rs": rows * depth / dt_rs / 1e6,
        "mrows_allreduce": rows * depth / dt_ar / 1e6,
        "ratio_allreduce_over_rs": float(np.median(res["ratios"])),
        "payload_bytes_allreduce": bytes_ar,
        "payload_bytes_rs": bytes_rs,
        "payload_ratio": round(bytes_ar / bytes_rs, 3),
        "ranks": world,
        **_window_fields(res),
    }


def bench_hist_2d(
    rows: int = 200_000,
    features: int = 1024,
    bins: int = 64,
    depth: int = 6,
    iters: int = 4,
    reps: int = 8,
    seed: int = 0,
    n_partitions: int | None = None,
    feature_partitions: int | None = None,
    device: str = "cuda",
) -> dict:
    """Paired 1D-row-mesh against (rows x features)-mesh whole-tree A/B
    at a wide shape, on the same ranks: the 1D arm puts every rank on
    rows, the 2D arm splits them (Pr, Pf); both at the resolved
    split_comms. Min of reps per arm, the median paired ratio
    (dt_1d / dt_2d: > 1 means the 2D mesh wins), and the deterministic
    per-tree payload model against the replicated-feature allreduce
    baseline (payload_ratio)."""
    if n_partitions is None or feature_partitions is None:
        n_dev = _default_ranks(device)
        if n_dev >= 4:
            n_partitions, feature_partitions = n_dev // 2, 2
        elif n_dev >= 2:
            n_partitions, feature_partitions = 1, 2
        else:
            raise ValueError("bench_hist_2d needs >= 2 ranks")
    n_used = n_partitions * feature_partitions
    meshes = {"1d": (n_used, 1), "2d": (n_partitions, feature_partitions)}
    arms = [(key, {"max_depth": depth, "seed": seed, "mesh_shape": ms})
            for key, ms in meshes.items()]
    data_kw = dict(rows=rows, features=features, bins=bins, seed=seed)
    res = _on_ranks(n_used, device, _fused_ab, arms, data_kw, iters,
                    reps)[0]
    dt_2d, dt_1d = min(res["dts"]["2d"]), min(res["dts"]["1d"])
    l1, l2 = res["layout"]["1d"], res["layout"]["2d"]
    bytes_1d = tele_counters.hist_allreduce_bytes(
        depth, features, bins, partitions=l1["row_shards"],
        mode=l1["split_comms"])
    bytes_2d = tele_counters.hist_allreduce_bytes(
        depth, features, bins, partitions=l2["row_shards"],
        feature_partitions=l2["feature_shards"], mode=l2["split_comms"])
    bytes_replicated = tele_counters.hist_allreduce_bytes(
        depth, features, bins, partitions=l1["row_shards"],
        mode="allreduce")
    return {
        "kernel": "hist_2d_ab",
        "rows": rows, "features": features, "bins": bins, "depth": depth,
        "iters": iters, "reps": reps,
        "mesh_1d": list(meshes["1d"]), "mesh_2d": list(meshes["2d"]),
        "mrows_2d": rows * depth / dt_2d / 1e6,
        "mrows_1d": rows * depth / dt_1d / 1e6,
        "ratio_1d_over_2d": float(np.median(res["ratios"])),
        "payload_bytes_replicated": bytes_replicated,
        "payload_bytes_1d": bytes_1d,
        "payload_bytes_2d": bytes_2d,
        "payload_ratio": round(bytes_replicated / bytes_2d, 3),
        **_window_fields(res),
    }


# --------------------------------------------------------------------- #
# training
# --------------------------------------------------------------------- #

def bench_train(
    backend: str = "cuda",
    rows: int = 1_000_000,
    features: int = 28,
    bins: int = 255,
    trees: int = 100,
    depth: int = 6,
    partitions: int = 1,
    seed: int = 0,
    run_log=None,
    device: str = "cuda",
) -> dict:
    """End-to-end boosted-build wall time of api.train (the Higgs-1M /
    depth-6 / 100-tree config with the defaults) on rows binned by the
    port's quantize, after a 2-tree warm-up run. `run_log` (a path or a
    telemetry RunLog) attaches the run log to the timed run. The timed
    window's counters: a fit uploads its labels anew, so the fused loop
    captures its round once (graph_captures 1) and replays it a round;
    K1 launches depth x (trees + 1) (the round before the capture runs
    eagerly)."""
    if partitions > 1 and not mesh.is_initialized():
        return _on_ranks(partitions, device, _train_rank, dict(
            backend=backend, rows=rows, features=features, bins=bins,
            trees=trees, depth=depth, partitions=partitions, seed=seed,
            run_log=run_log))[0]
    if backend == "cuda":
        _need(device)
    X, y = datasets.synthetic_binary(rows, n_features=features, seed=seed)
    Xb, _ = quantize(X, n_bins=bins, seed=seed)
    cfg = TrainConfig(
        n_trees=trees, max_depth=depth, n_bins=bins, backend=backend,
        n_partitions=partitions, seed=seed, device=device,
    )
    api.train(Xb, y, cfg.replace(n_trees=2), binned=True, log_every=10**9)
    dev = torch.device(device if backend == "cuda" else "cpu")
    _sync(dev)
    win = _Window()
    t0 = time.perf_counter()
    res = api.train(Xb, y, cfg, binned=True, log_every=10**9,
                    run_log=run_log)
    _sync(dev)
    dt = time.perf_counter() - t0
    return {
        "kernel": "train",
        "backend": backend, "rows": rows, "trees": trees, "depth": depth,
        "partitions": partitions,
        "wallclock_s": dt,
        "trees_per_sec": trees / dt,
        "final_train_loss": res.history[-1]["train_loss"]
        if res.history else None,
        **win.read(),
        "device": card.stamp(dev),
    }


def _train_rank(device: str, kw: dict) -> dict:
    return bench_train(device=device, **kw)


# --------------------------------------------------------------------- #
# scoring
# --------------------------------------------------------------------- #

def _random_ensemble(rows, features, bins, trees, depth, seed):
    """(Xb, ensemble): random full trees (every internal node split; the
    plausible worst case), the reference's draws in its order."""
    rng = np.random.default_rng(seed)
    Xb = rng.integers(0, bins, size=(rows, features), dtype=np.uint8)
    n_nodes = 2 ** (depth + 1) - 1
    ens = empty_ensemble(trees, depth, features, 0.1, 0.0, "logloss")
    ens.feature[:] = rng.integers(0, features, size=(trees, n_nodes))
    ens.threshold_bin[:] = rng.integers(0, bins - 1, size=(trees, n_nodes))
    ens.is_leaf[:, (n_nodes // 2):] = True
    ens.leaf_value[:] = rng.standard_normal(
        (trees, n_nodes)).astype(np.float32)
    return Xb, ens


def _predict_setup(rows, features, bins, trees, depth, seed,
                   backend="cuda", partitions=1, device="cuda"):
    """(backend, Xb, ensemble) for the scoring benches: random full
    trees, shared by bench_predict and bench_predict_both so the two
    cannot drift. partitions > 1 scores through the row-sharded scorer
    (one card a partition)."""
    Xb, ens = _random_ensemble(rows, features, bins, trees, depth, seed)
    if backend == "cuda":
        _need(device)
    if partitions > 1:
        if backend != "cuda":
            raise ValueError("partitions > 1 scores on the cuda backend")
        return row_sharded_backend(partitions, device), Xb, ens
    cfg = TrainConfig(backend=backend, n_bins=bins, device=device)
    return get_backend(cfg), Xb, ens


def bench_predict(
    backend: str = "cuda",
    rows: int = 1_000_000,
    features: int = 28,
    bins: int = 255,
    trees: int = 1000,
    depth: int = 6,
    partitions: int = 1,
    seed: int = 0,
    device: str = "cuda",
) -> dict:
    """Batch scoring throughput (the 1000-tree, large-batch config): one
    predict_raw of host rows (the H2D copy, K3 and the margins' D2H
    included) after one full untimed pass."""
    be, Xb, ens = _predict_setup(rows, features, bins, trees, depth, seed,
                                 backend, partitions, device)
    dev = torch.device(device if backend == "cuda" else "cpu")
    be.predict_raw(ens, Xb)
    win = _Window()
    t0 = time.perf_counter()
    out = be.predict_raw(ens, Xb)
    dt = time.perf_counter() - t0
    assert out.shape[0] == rows
    return {
        "kernel": "predict",
        "backend": backend, "rows": rows, "trees": trees, "depth": depth,
        "wallclock_s": dt,
        "mrows_per_sec": rows / dt / 1e6,
        **win.read(),
        "device": card.stamp(dev),
    }


def bench_predict_both(
    rows: int = 10_000_000,
    features: int = 28,
    bins: int = 255,
    trees: int = 1000,
    depth: int = 6,
    seed: int = 0,
    reps: int = 2,
    device: str = "cuda",
) -> tuple[dict, dict, dict]:
    """(resident, total, compute) scoring records sharing one dataset,
    ensemble and warm-up pass (BASELINE config 4 with the defaults).
    Resident: the rows uploaded once outside the timing, K3 and the
    margins' D2H. Total: from host rows, the pageable H2D copy included.
    Compute: K3 alone, its margins left on the device. Min of reps (one
    rep for total)."""
    be, Xb, ens = _predict_setup(rows, features, bins, trees, depth, seed,
                                 device=device)
    dev = be.device
    be.predict_raw(ens, Xb)                        # warm-up
    data = be.device_rows(Xb)
    _sync(dev)
    base = {"kernel": "predict", "backend": "cuda", "rows": rows,
            "trees": trees, "depth": depth,
            "impl": "k3" if dev.type == "cuda" else "plain"}
    stamp = card.stamp(dev)
    out = []
    for resident, arg, n in ((True, data, reps), (False, Xb, 1)):
        dt = float("inf")
        win = _Window()
        for _ in range(n):
            t0 = time.perf_counter()
            got = be.predict_raw(ens, arg)
            dt = min(dt, time.perf_counter() - t0)
        assert got.shape[0] == rows
        out.append({**base, "resident": resident, "wallclock_s": dt,
                    "mrows_per_sec": rows / dt / 1e6, "reps": n,
                    **win.read(), "device": stamp})
    dt = float("inf")
    win = _Window()
    for _ in range(reps):
        t0 = time.perf_counter()
        be.score_device(ens, data)
        _sync(dev)
        dt = min(dt, time.perf_counter() - t0)
    rec = {**base, "resident": "compute_only", "wallclock_s": dt,
           "mrows_per_sec": rows / dt / 1e6, "reps": reps, **win.read(),
           "device": stamp}
    rec.update(_roofline_util("predict",
                              lambda: be.score_device(ens, data), dt))
    out.append(rec)
    return out[0], out[1], out[2]


def _f32_scorer(ce, dev):
    """(kernel run, plain run) of one CompiledEnsemble on `dev`: K3
    through ops/predict.predict_prepared (the plain version on the CPU),
    and predict_effective_plain on the same device arrays."""
    arrs = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in ce.arrays()[:4]]
    ops = predict_ops.prepare(*arrs, max_depth=ce.max_depth)
    kw = dict(learning_rate=ce.learning_rate, base=ce.base_score,
              tree_chunk=ce.tree_chunk,
              missing_bin_value=ce.missing_bin_value)

    def kernel(X):
        return predict_ops.predict_prepared(ops, X, **kw)

    def plain(X):
        out = predict_ops.predict_effective_plain(
            *arrs, X, max_depth=ce.max_depth, **kw)
        return out[:, 0] if out.shape[1] == 1 else out

    return kernel, plain


def bench_predict_cuda_ab(
    rows: int = 4_000_000,
    features: int = 28,
    bins: int = 255,
    trees: int = 1000,
    depth: int = 6,
    seed: int = 0,
    reps: int = 8,
    plain_rows: int = 250_000,
    device: str = "cuda",
) -> dict:
    """Paired K3-against-its-plain-version timing (the reference's
    bench_predict_pallas_ab) on the same card-resident CompiledEnsemble
    arrays: outputs asserted bitwise equal first (both sum tree by tree in
    one order). The plain arm scores the first `plain_rows` rows so that
    it ends in seconds; throughputs are Mrows/s (median of reps) and the
    ratio the median of paired per-row time ratios (plain / kernel: > 1
    means the kernel is faster)."""
    _need(device)
    dev = torch.device(device)
    Xb, ens = _random_ensemble(rows, features, bins, trees, depth, seed)
    ce = ens.compile(tree_chunk=64)
    kernel, plain = _f32_scorer(ce, dev)
    Xd = torch.from_numpy(Xb).to(dev)
    plain_rows = min(plain_rows, rows)
    Xp = Xd[:plain_rows]
    a0, b0 = kernel(Xd), plain(Xp)
    _sync(dev)
    if not torch.equal(a0[:plain_rows], b0):
        raise AssertionError("the traversal kernel diverged from its plain "
                             "version")

    def bout(arm):
        t0 = time.perf_counter()
        if arm == "cuda":
            kernel(Xd)
        else:
            plain(Xp)
        _sync(dev)
        return (time.perf_counter() - t0) / (rows if arm == "cuda"
                                             else plain_rows)

    win = _Window()
    dts, ratios = _paired_ab_reps(bout, "plain", "cuda", reps)
    window = win.read()
    med = {arm: float(np.median(v)) for arm, v in dts.items()}
    return {
        "kernel": "predict_cuda_ab",
        "rows": rows, "plain_rows": plain_rows, "features": features,
        "bins": bins, "trees": trees, "depth": depth, "reps": reps,
        "cuda_mrows_per_sec": 1 / med["cuda"] / 1e6,
        "plain_mrows_per_sec": 1 / med["plain"] / 1e6,
        "ratio_cuda_over_plain": float(np.median(ratios)),
        "exact_match": True,            # asserted above
        **window,
        "device": card.stamp(dev),
    }


def _lut8_scorer(tables, dev):
    ops = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in predict_lut.lut_device_operands(tables))
    static = predict_lut.lut_static_kwargs(tables)
    return lambda X: predict_lut.predict_effective_lut_ops(ops, X, **static)


def _lut4_scorer(packed, dev):
    ops = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in packed.ops)
    static = packed.static_kwargs()
    return lambda X: predict_lut.predict_effective_lut4_ops(ops, X,
                                                            **static)


def _paired_scoring(arms: dict, key_a: str, key_b: str, Xd, reps: int):
    """Paired reps of two scoring callables on the same rows: ({arm:
    median s}, median of dt_a / dt_b, the window's counters)."""
    def bout(arm):
        t0 = time.perf_counter()
        arms[arm](Xd)
        _sync(Xd.device)
        return time.perf_counter() - t0

    win = _Window()
    dts, ratios = _paired_ab_reps(bout, key_a, key_b, reps)
    window = win.read()
    return ({arm: float(np.median(v)) for arm, v in dts.items()},
            float(np.median(ratios)), window)


def bench_predict_lut_ab(
    rows: int = 4_000_000,
    features: int = 28,
    bins: int = 255,
    trees: int = 1000,
    depth: int = 6,
    seed: int = 0,
    reps: int = 8,
    device: str = "cuda",
) -> dict:
    """Paired K4 (the int8 tier, fp16 leaves) against K3 (f32) timing on
    the same card-resident rows: the median paired ratio (dt_f32 /
    dt_lut: > 1 means the quantized tier wins) and the error contract
    witnessed per run: max |lut - f32| within the tables' bound."""
    _need(device)
    dev = torch.device(device)
    Xb, ens = _random_ensemble(rows, features, bins, trees, depth, seed)
    ce = ens.compile(tree_chunk=64)
    tables = ce.quantize()
    arms = {"lut": _lut8_scorer(tables, dev),
            "f32": _f32_scorer(ce, dev)[0]}
    Xd = torch.from_numpy(Xb).to(dev)
    a0 = arms["lut"](Xd).cpu().numpy()
    b0 = arms["f32"](Xd).cpu().numpy()
    err = float(np.abs(a0 - b0).max())
    if not err <= tables.max_abs_err * (1 + 1e-5) + 1e-6:
        raise AssertionError(f"LUT error {err} above its bound "
                             f"{tables.max_abs_err}")
    med, ratio, window = _paired_scoring(arms, "f32", "lut", Xd, reps)
    return {
        "kernel": "predict_lut_ab",
        "rows": rows, "features": features, "bins": bins,
        "trees": trees, "depth": depth, "reps": reps,
        "lut_mrows_per_sec": rows / med["lut"] / 1e6,
        "f32_mrows_per_sec": rows / med["f32"] / 1e6,
        "ratio_lut_over_f32": ratio,
        "lut_max_abs_err": err,
        "lut_err_bound": tables.max_abs_err,
        **window,
        "device": card.stamp(dev),
    }


def bench_predict_lut4_ab(
    rows: int = 4_000_000,
    features: int = 28,
    bins: int = 15,
    trees: int = 1000,
    depth: int = 6,
    seed: int = 0,
    reps: int = 8,
    ab: "bool | None" = None,
    express_trees: int = 50,
    express_depth: int = 4,
    express_features: int = 16,
    express_bins: int = 15,
    n_single: int = 120,
    n_storm: int = 300,
    max_wait_ms: float = 20.0,
    device: str = "cuda",
) -> dict:
    """The int4 tier and the express lane in one record.

    Part 1 (`ab`, default: on a card): paired K5 (int4) against K4 (int8)
    at `bins=15`, so the int4 thresholds ride the nibble pack; the int4
    error contract witnessed against K3's f32 answer.

    Part 2 (every device): a small int4-served engine
    (serve/engine.ServeEngine) in two regimes, express lane on and off.
    Empty queue: sequential single rows (with the lane off every lone
    request waits out the `max_wait_ms` admission window). Saturated: 16
    concurrent submitters, where the lane closes and both coalesce."""
    _need(device)
    dev = torch.device(device)
    out = {
        "kernel": "predict_lut4_ab",
        "rows": rows, "features": features, "bins": bins,
        "trees": trees, "depth": depth, "reps": reps,
        "express_max_wait_ms": max_wait_ms,
    }
    if ab is None:
        ab = dev.type == "cuda"
    window = {"graph_captures": 0, "launches": {}}
    if ab:
        Xb, ens = _random_ensemble(rows, features, bins, trees, depth, seed)
        ce = ens.compile(tree_chunk=64)
        t8 = ce.quantize()
        t4 = ce.quantize(leaf_dtype="int4")
        pk = t4.pack_int4()
        arms = {"int8": _lut8_scorer(t8, dev), "int4": _lut4_scorer(pk, dev)}
        Xd = torch.from_numpy(Xb).to(dev)
        a4 = arms["int4"](Xd).cpu().numpy()
        arms["int8"](Xd)
        f32 = _f32_scorer(ce, dev)[0](Xd).cpu().numpy()
        err = float(np.abs(a4 - f32).max())
        if not err <= t4.max_abs_err * (1 + 1e-5) + 1e-6:
            raise AssertionError(f"int4 error {err} above its bound "
                                 f"{t4.max_abs_err}")
        med, ratio, window = _paired_scoring(arms, "int8", "int4", Xd, reps)
        out.update({
            "lut4_mrows_per_sec": rows / med["int4"] / 1e6,
            "lut8_mrows_per_sec": rows / med["int8"] / 1e6,
            "ratio_int4_over_int8": ratio,
            "lut4_max_abs_err": err,
            "lut4_err_bound": t4.max_abs_err,
            "lut4_thr_packed": pk.thr_packed,
        })

    Xe, ens_e = _random_ensemble(4096, express_features, express_bins,
                                 express_trees, express_depth, seed)
    bundle = api.ModelBundle(ensemble=ens_e, mapper=None)
    cfg = TrainConfig(n_bins=express_bins, predict_impl="lut4",
                      device=device)
    rng = np.random.default_rng(seed)

    def one_engine(express: bool) -> dict:
        eng = ServeEngine(bundle, cfg, max_wait_ms=max_wait_ms,
                          max_batch=64, quantize="int4",
                          express_lane=express)
        try:
            eng.stats.window_summary(reset=True)
            for _ in range(n_single):
                r = int(rng.integers(0, len(Xe)))
                eng.predict(Xe[r:r + 1], timeout=60.0)
            empty = eng.stats.window_summary(reset=True)
            n_threads = 16
            per = max(1, n_storm // n_threads)
            barrier = threading.Barrier(n_threads)
            errs: list = []

            def worker(tid):
                rngl = np.random.default_rng(seed + 1 + tid)
                barrier.wait()
                for _ in range(per):
                    r = int(rngl.integers(0, len(Xe)))
                    try:
                        eng.predict(Xe[r:r + 1], timeout=120.0)
                    # Collected and raised after the join: a failed storm
                    # request is the bench's own verdict.
                    except Exception as e:
                        errs.append(repr(e))

            threads = [threading.Thread(target=worker, args=(t,))
                       for t in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(180)
            if errs:
                raise AssertionError(
                    f"saturated-arm requests failed: {errs[:3]}")
            sat = eng.stats.window_summary(reset=True)
            return {"empty": empty, "sat": sat}
        finally:
            eng.close()

    on = one_engine(express=True)
    off = one_engine(express=False)
    out.update({
        "express_empty_p50_ms": on["empty"]["p50_ms"],
        "express_empty_p99_ms": on["empty"]["p99_ms"],
        "coalesced_empty_p50_ms": off["empty"]["p50_ms"],
        "coalesced_empty_p99_ms": off["empty"]["p99_ms"],
        "express_hits_empty": on["empty"]["express"],
        "express_saturated_p99_ms": on["sat"]["p99_ms"],
        "coalesced_saturated_p99_ms": off["sat"]["p99_ms"],
        "express_hits_saturated": on["sat"]["express"],
        "express_gain": (round(off["empty"]["p99_ms"]
                               / on["empty"]["p99_ms"], 2)
                         if on["empty"]["p99_ms"] > 0 else None),
        **window,
        "device": card.stamp(dev),
    })
    return out


# --------------------------------------------------------------------- #
# serving and the registry
# --------------------------------------------------------------------- #

def bench_serve_latency(
    backend: str = "cuda",
    rows: int = 20_000,
    features: int = 16,
    bins: int = 63,
    trees: int = 50,
    depth: int = 4,
    qps_points: tuple = (50, 200, 8000),
    n_requests: int = 200,
    max_wait_ms: float = 1.0,
    max_batch: int = 64,
    quantize: bool = False,
    seed: int = 0,
    device: str = "cuda",
) -> dict:
    """Latency under load of the serving engine (serve/engine.ServeEngine).

    Cold comparator: one api.predict single-row call against a fresh
    CUDADevice with nothing cached (the model compiled, its scoring
    operands built and uploaded, then scored, all in the call), after an
    untimed call with another model has brought up what a serving
    process holds once (the CUDA context, the kernel library). Then,
    per open-loop arrival rate in `qps_points`, `n_requests` single-row
    requests submitted on schedule (arrival i at t0 + i / qps, whatever
    the completions), p50 / p99 and the coalesce width from the engine's
    own window. The headline is the middle rate. (The express lane scores
    a row that finds the queue empty at once: where a dispatch is faster
    than the arrivals, as on the card, even the top rate coalesces
    nothing.)"""
    if backend != "cuda":
        raise ValueError("the serving engine scores on the cuda backend "
                         f"(device='cpu' for the plain versions), got "
                         f"backend={backend!r}")
    _need(device)
    rng = np.random.default_rng(seed)
    Xb, ens = _random_ensemble(rows, features, bins, trees, depth, seed)
    bundle = api.ModelBundle(ensemble=ens, mapper=None)

    cold_cfg = TrainConfig(n_bins=bins, device=device)
    _, other = _random_ensemble(1, features, bins, 1, depth, seed + 1)
    api.predict(other, Xb[:1], binned=True, backend=CUDADevice(cold_cfg))
    t0 = time.perf_counter()
    api.predict(ens, Xb[:1], binned=True, backend=CUDADevice(cold_cfg))
    cold_ms = (time.perf_counter() - t0) * 1e3

    cfg = TrainConfig(n_bins=bins, device=device,
                      predict_impl="lut" if quantize else "auto")
    engine = ServeEngine(bundle, cfg, max_wait_ms=max_wait_ms,
                         max_batch=max_batch, quantize=quantize or None)
    arms = []
    win = _Window()
    try:
        for qps in qps_points:
            engine.stats.window_summary(reset=True)
            pendings = []
            t_start = time.perf_counter()
            for i in range(n_requests):
                target = t_start + i / qps
                now = time.perf_counter()
                if target > now:
                    time.sleep(target - now)         # open-loop arrival
                r = int(rng.integers(0, rows))
                pendings.append(engine.predict_async(Xb[r:r + 1]))
            for p in pendings:
                p.result(timeout=60.0)
            w = engine.stats.window_summary(reset=True)
            arms.append({"qps": qps, **{k: w[k] for k in (
                "requests", "batches", "p50_ms", "p99_ms", "p999_ms",
                "coalesce_mean", "coalesce_max", "queue_depth_max")}})
    finally:
        engine.close()
    window = win.read()
    head = arms[len(arms) // 2]
    return {
        "kernel": "serve_latency",
        "backend": backend, "rows_model": rows, "trees": trees,
        "depth": depth, "features": features,
        "max_wait_ms": max_wait_ms, "max_batch": max_batch,
        "quantized": bool(quantize),
        "cold_predict_ms": round(cold_ms, 3),
        "arms": arms,
        "serve_qps": head["qps"],
        "serve_p50_ms": head["p50_ms"],
        "serve_p99_ms": head["p99_ms"],
        "serve_p999_ms": head["p999_ms"],
        "serve_coalesce_mean": head["coalesce_mean"],
        "serve_coalesce_max": max(a["coalesce_max"] for a in arms),
        "serve_cold_over_p99": (round(cold_ms / head["p99_ms"], 2)
                                if head["p99_ms"] > 0 else None),
        **window,
        "device": card.stamp(device),
    }


def bench_registry_cold_load(
    backend: str = "cuda",
    features: int = 16,
    bins: int = 63,
    trees: int = 100,
    depth: int = 5,
    max_batch: int = 64,
    quantize: bool = False,
    seed: int = 0,
    device: str = "cuda",
) -> dict:
    """Cold start to serving: restore from the registry
    (registry/loader.load_servable: verify, rebuild the CompiledEnsemble,
    seed the carried tables, warm every bucket) against the in-process
    ServableModel build, each on a fresh CUDADevice, after another
    model's untimed warm-up has brought up the CUDA context and the
    kernel library. The restored model's scores must equal the
    in-process build's bitwise. The kernels are built before either
    timed arm: `nvcc_builds_timed` (nvcc runs inside
    the timed arms) is 0. The reference's AOT keys name the restore arm
    (the port has no serialized programs: export/aot.py)."""
    if backend != "cuda":
        raise ValueError("the registry restores onto the cuda backend "
                         f"(device='cpu' for the plain versions), got "
                         f"backend={backend!r}")
    _need(device)
    if torch.device(device).type == "cuda":
        _build.build_all()
    Xb, ens = _random_ensemble(4 * max_batch, features, bins, trees, depth,
                               seed)
    bundle = api.ModelBundle(ensemble=ens, mapper=None)
    tier = "int8" if quantize else None
    cold_cfg = TrainConfig(n_bins=bins, device=device,
                           predict_impl="lut" if quantize else "auto")
    root = tempfile.mkdtemp(prefix="ddt_reg_bench_")
    try:
        push_servable(root, bundle, name="bench", max_batch=max_batch,
                      quantize=tier or False)
        # What a process holds once (the CUDA context, the kernel
        # library) comes up before either arm, through another model.
        _, other = _random_ensemble(1, features, bins, 1, depth, seed + 1)
        ServableModel(api.ModelBundle(ensemble=other, mapper=None),
                      CUDADevice(cold_cfg), quantize=tier,
                      buckets=default_buckets(max_batch)).warmup()
        builds0 = _build.builds
        win = _Window()
        t0 = time.perf_counter()
        rebuild = ServableModel(bundle, CUDADevice(cold_cfg),
                                quantize=tier,
                                buckets=default_buckets(max_batch))
        rebuild.warmup()
        rebuild_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        report = load_servable(root, "bench", quantize=tier,
                               backend=CUDADevice(cold_cfg))
        report.model.warmup()
        restore_ms = (time.perf_counter() - t0) * 1e3
        window = win.read()
        builds = _build.builds - builds0
        want = rebuild.score_binned(Xb[:max_batch])
        got = report.model.score_binned(Xb[:max_batch])
        if not np.array_equal(want, got):
            raise AssertionError(
                "registry-restored scores diverge from the in-process "
                "build: the bit-exactness contract broke")
        return {
            "kernel": "registry_cold_load", "backend": backend,
            "trees": trees, "depth": depth, "features": features,
            "max_batch": max_batch, "quantized": bool(quantize),
            "mode": report.mode,
            "registry_rebuild_cold_ms": round(rebuild_ms, 3),
            "registry_aot_cold_ms": round(restore_ms, 3),
            "registry_aot_speedup": round(rebuild_ms / restore_ms, 3)
            if restore_ms > 0 else None,
            "bitwise": True,            # asserted above
            "nvcc_builds_timed": builds,
            **window,
            "device": card.stamp(device),
        }
    finally:
        shutil.rmtree(root, ignore_errors=True)


# --------------------------------------------------------------------- #
# the dispatcher
# --------------------------------------------------------------------- #

#: --kernel -> (function, the keyword arguments it takes from run_bench).
ARMS = {
    "histogram": (bench_histogram, (
        "backend", "rows", "features", "bins", "iters", "partitions",
        "seed", "reps", "device")),
    "train": (bench_train, (
        "backend", "rows", "features", "bins", "trees", "depth",
        "partitions", "seed", "device")),
    "predict": (bench_predict, (
        "backend", "rows", "features", "bins", "trees", "depth",
        "partitions", "seed", "device")),
    "serve": (bench_serve_latency, (
        "backend", "rows", "features", "bins", "trees", "depth", "seed",
        "device")),
    "registry": (bench_registry_cold_load, (
        "backend", "features", "bins", "trees", "depth", "seed", "device")),
    "hist_comms": (bench_hist_comms_ab, (
        "rows", "features", "bins", "depth", "iters", "seed", "device")),
    "hist_2d": (bench_hist_2d, (
        "rows", "features", "bins", "depth", "iters", "seed", "device")),
    "hist_quant": (bench_hist_quant_ab, (
        "rows", "features", "bins", "depth", "iters", "seed", "grad_dtype",
        "device")),
    "lut4": (bench_predict_lut4_ab, (
        "rows", "features", "bins", "trees", "depth", "seed", "device")),
}


def run_bench(kernel: str = "histogram", **kw) -> dict:
    """The `cli bench --kernel=K` dispatcher: the arm's function with the
    keyword arguments it takes. None-valued keywords fall back to the
    function's own default (the CLI passes --features=None unless set,
    so hist_2d keeps its 1024 features); a keyword no arm takes raises
    TypeError (the reference's `hist_impl` is not ported)."""
    if kernel not in ARMS:
        raise ValueError(f"unknown bench kernel {kernel!r}")
    known = {k for _, keys in ARMS.values() for k in keys}
    unknown = sorted(set(kw) - known)
    if unknown:
        raise TypeError(f"run_bench: no arm takes {unknown}")
    fn, keys = ARMS[kernel]
    return fn(**{k: v for k, v in kw.items()
                 if v is not None and k in keys})
