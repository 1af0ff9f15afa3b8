#!/usr/bin/env python3
"""chip_smoke.py: drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (CUDA_HOME or /usr/local/cuda) and the repo's
ddt_tpu_torch package beside this file; imports nothing of JAX or ddt_tpu.
Prints one JSON object per line; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}},
printed only when every phase passed. Any failure raises (exit != 0).

Phases:
  1 device   card name, nvidia-smi's name and power limit, datasheet peaks
  2 build    nvcc of every csrc/*.cu (all at once), seconds
  3 hist     the histogram kernel against its plain version at the Higgs
             shape (1M x 28, 255 bins, nodes 1..32, 10% frozen rows), and
             at 128 and 64 bins; |diff| <= 1e-5 * sum|g| (|h|) over the
             cell's own rows + 1e-6 (float atomics: run-to-run order); times
             of the kernel, the plain version, two torch.bincount calls
             (the library yardstick) and the bound
  4 traverse the traversal kernel against its plain version: bitwise on
             an exact-grid ensemble (leaves multiples of 1/8) with missing
             and categorical routing and 7 classes
  5 main     api.train on 1M x 28 at 255 bins, depth 6, on the card, then
             api.predict on the 1M rows; both launch counters must move
             (they are zeroed just before, read just after); train AUC
             >= 0.80; scores equal the host oracle's on 50k rows
  6 trained  the traversal kernel against its plain version on the trained
             ensemble, |diff| <= 1e-5 * (|p| + 1), and its times
  7 parity   the same 200k-row, 10-tree, depth-6 model trained on the card
             and on the CPU (plain versions): trees identical except at
             bf16-boundary ties, AUC within 0.005
  8 lut_exact   K4 (csrc/lut.cu ddt_lut_int8, fp16 and int8 leaves) and K5
             (ddt_lut_int4 at 13 bins, nibble thresholds, and at 255 bins)
             on the 1M rows over exact-grid ensembles (70 trees, 7
             classes, missing and categorical, lossless grids): bitwise
             against their plain versions and against the traversal kernel
             on the same f32 ensemble
  9 lut_trained K4 (fp16) and K5 on phase 5's model: |diff| <= 1e-5 *
             (|p| + 1) against their plain versions, and within the tables'
             max_abs_err (+ the same slack) of the traversal kernel; times,
             bounds and table bytes per tier
 10 lut4_packed the same Higgs shape trained at 15 bins on the card; its
             int4 tables nibble-pack the thresholds; K5 against its plain
             version, with times
 11 serve    ServeEngine over phase 5's bundle at quantize None, "int8"
             and "int4" (max_batch 256, max_wait_ms 1.0): 32 submitter
             threads send ~2,000 requests of 1-64 raw float rows, with a
             hot swap to the 15-bin bundle halfway, then single rows at an
             idle queue (the express lane). Every response equals offline
             api.predict at that tier for the token that scored it,
             bitwise; each model resolves to the requested tier; the
             counters are zeroed just before and the LUT kernels' must move
 12 quantize ops/grad.quantize_gradients on the card at 1M rows, int8 and
             int16, from logloss gradients: q's and scales bitwise equal to
             the numpy twin, and which term (max|g|/qmax or the snapped sum
             cap) set each scale; the device uniform twin bitwise equal to
             uniform_np, at row base 0 and above 2^32
 13 hist_int the histogram kernel's integer mode against its plain version,
             bitwise (max |diff| = 0), int8 and int16 q's at 1M x 28, 255
             bins at N = 1..32 and 128 / 64 bins at N = 16, 32, 10% frozen
             rows; times of the kernel, the plain version, two int32
             index_add_ calls (the library yardstick, itself bitwise) and
             the bound; the per-tree sum over N = 1, 1, 2, 4, 8, 16
 14 quant_exact one tree from exact-grid gradients, int8 against f32,
             structure and leaves bitwise: mse on y in {-1, +1} (g = -/+1,
             h = 1) at 131,072 rows, so every integer sum stays below 2^24
             and the one dequantize is exact; and the reference's pinned
             grid (scale exactly 1) at 1M rows through the backend
 15 train_quant api.train at 1M x 28, 255 bins, depth 6, 100 trees with
             grad_dtype="int8" on the card: the integer kernel's counter
             moves and the f32 one does not; train AUC >= 0.80 and within
             0.005 of phase 5's; per-round split agreement with f32 >= 0.985
             over 10 rounds grown from the same f32 boosting state
 16 parity_quant 200k rows, 10 trees, depth 6, 63 bins (K2's regime),
             int16, subsample 0.8, colsample_bytree 0.8, on the card and on
             the CPU: trees identical except at bf16-boundary ties, AUC
             within 0.005
  then the {"kernels": [...]} line, nvidia-smi's line, and the ok line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from ddt_tpu_torch import _build, api
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.data.datasets import synthetic_binary
from ddt_tpu_torch.data.quantizer import fit_bin_mapper
from ddt_tpu_torch.models.tree import empty_ensemble
from ddt_tpu_torch.backends import get_backend
from ddt_tpu_torch.ops import (grad, hist_cuda, histogram, predict,
                               predict_cuda, predict_lut, predict_lut_cuda,
                               sampling)
from ddt_tpu_torch.serve import ServeEngine

ROWS = 1_000_000
FEATURES = 28
DEPTH = 6
N_TREES = 100
PARITY_ROWS = 200_000
PARITY_TREES = 10
SERVE_POOL = 65_536         # raw rows the serve phase's requests slice
SERVE_REQUESTS = 2_000
SERVE_THREADS = 32
EXPRESS_REQUESTS = 200
QUANT_EXACT_ROWS = 131_072  # 127 * rows < 2^24: every int32 sum exact in f32
AGREE_ROUNDS = 10
PARITY_Q_BINS = 63
HIST_SHAPES = ((255, (1, 2, 4, 8, 16, 32)), (128, (16, 32)), (64, (16, 32)))
#: Histogram builds of one main-path tree with sibling subtraction (on for
#: the card, and everywhere for integer histograms): nodes per level.
TREE_SEQ = (1, 1, 2, 4, 8, 16)
TIER_IMPL = {None: "auto", "int8": "lut", "int4": "lut4"}
TIER_RESOLVED = {None: "f32", "int8": "lut", "int4": "lut4"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_peaks(name: str) -> tuple[float, float, str]:
    """(memory bytes/s, f32 FLOP/s outside the tensor cores, source) from
    NVIDIA's data sheets for the card nvidia-smi names. The FLOP rate
    counts an FMA as two operations on 128 FP32 lanes per SM: a plain f32
    add runs at half of it, an INT32 compare (64 lanes per SM) at a
    quarter."""
    n = name.upper()
    if "H200" in n:
        return 4.8e12, 67e12, "H200 SXM data sheet"
    if "H100" in n and "PCIE" in n:
        return 2.0e12, 51e12, "H100 PCIe data sheet"
    if "H100" in n and "NVL" in n:
        return 3.9e12, 60e12, "H100 NVL data sheet"
    return 3.35e12, 67e12, "H100 SXM data sheet"


def time_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """Median device time of fn() in ms, CUDA events around each call,
    with L2 flushed before each (the buffer is larger than the 50 MB L2)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def auc(y: np.ndarray, score: np.ndarray) -> float:
    """Binary ROC-AUC, rank formulation with average ranks on ties."""
    y = np.asarray(y).astype(bool)
    s = np.asarray(score, np.float64)
    n_pos = int(y.sum())
    n_neg = y.size - n_pos
    order = np.argsort(s, kind="mergesort")
    s_sorted = s[order]
    start = np.empty(y.size, bool)
    start[0] = True
    np.not_equal(s_sorted[1:], s_sorted[:-1], out=start[1:])
    starts = np.flatnonzero(start)
    ends = np.concatenate([starts[1:], [y.size]])
    ranks = np.empty(y.size, np.float64)
    ranks[order] = (0.5 * (starts + ends + 1))[np.cumsum(start) - 1]
    return float((ranks[y].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def trees_match_mod_ties(full, other, min_split_gain, leaf_rtol=1e-3,
                         leaf_atol=2e-5, leaf_contrib_atol=1e-3,
                         cascade_gain_atol=2e-3, cascade_leaf_scale=5.0):
    """Tree equality except provable bf16-boundary ties (an adaptation of
    the repo's tests/tree_compare.assert_trees_match_mod_ties): walking
    each tree from the root, a node with matching ancestors either matches
    (feature, bin, leaf-ness; leaf values to tolerance; gains within 2
    bf16 ULPs) or is a root cause whose competing gains sit within 2 bf16
    ULPs (or at the min_split_gain floor); its subtree is then excluded.
    Rounds after the first root cause get the cascade allowances. Returns
    the number of root causes; raises on a real divergence or when root
    causes exceed one per 500 nodes."""
    tie = 2 ** -6
    T, N = full.feature.shape
    n_rc = 0
    first_rc = None
    for t in range(T):
        cascade = first_rc is not None and t > first_rc

        def gain_ok(ga, gb):
            d = abs(ga - gb)
            return (d <= tie * max(abs(ga), abs(gb), 1e-12)
                    or (cascade and d <= cascade_gain_atol))

        queue = [0]
        while queue:
            s = queue.pop()
            fa, fb = int(full.feature[t, s]), int(other.feature[t, s])
            ba, bb = int(full.threshold_bin[t, s]), \
                int(other.threshold_bin[t, s])
            la, lb = bool(full.is_leaf[t, s]), bool(other.is_leaf[t, s])
            ga, gb = float(full.split_gain[t, s]), \
                float(other.split_gain[t, s])
            if (fa, ba, la) == (fb, bb, lb):
                va = float(full.leaf_value[t, s])
                vb = float(other.leaf_value[t, s])
                dv = abs(va - vb)
                ls = cascade_leaf_scale if cascade else 1.0
                check(dv <= ls * (leaf_atol + leaf_rtol * abs(vb))
                      or dv * full.learning_rate <= ls * leaf_contrib_atol,
                      f"leaf value tree {t} node {s}: {va} vs {vb}")
                check(gain_ok(ga, gb), f"gain tree {t} node {s}: {ga} {gb}")
                if not la and 2 * s + 2 < N:
                    queue += [2 * s + 1, 2 * s + 2]
                continue
            n_rc += 1
            if first_rc is None:
                first_rc = t
            if la != lb:
                g_split = gb if la else ga
                check(abs(g_split - min_split_gain)
                      <= tie * max(g_split, min_split_gain)
                      or (cascade and abs(g_split - min_split_gain)
                          <= cascade_gain_atol),
                      f"split/leaf flip tree {t} node {s}: gain {g_split}")
            else:
                check(gain_ok(ga, gb),
                      f"split flip tree {t} node {s}: gains {ga} vs {gb}")
    check(n_rc <= max(1, T * N // 500), f"{n_rc} root causes")
    return n_rc


# --------------------------------------------------------------------- #
# phases
# --------------------------------------------------------------------- #

def phase_device() -> dict:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    bw, f32, src = card_peaks(name)
    print(smi, flush=True)
    emit({"phase": "device", "name": name, "count":
          torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "peak_bytes_per_s": bw, "peak_f32_flops": f32,
          "peak_f32_adds_per_s": f32 / 2, "peak_int32_ops_per_s": f32 / 4,
          "peaks_from": src})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"name": name, "smi": smi, "bw": bw, "f32_add": f32 / 2,
            "int32": f32 / 4}


def phase_build() -> None:
    t0 = time.perf_counter()
    took = _build.build_all()
    for name in _build.sources():
        check(_build.lib_path(name).exists(), f"{name} library built")
    emit({"phase": "build", "sources": _build.sources(),
          "nvcc_s": {k: round(v, 3) for k, v in took.items()},
          "wall_s": round(time.perf_counter() - t0, 3)})


def hist_bound_ms(ni: np.ndarray, F: int, N: int, B: int,
                  card: dict) -> tuple[float, float]:
    """(bytes time, operations time) in ms; the bound is the larger. Each
    input byte the data needs read once (node index of every row; Xb, g, h
    of the active rows), the table written once; 2 f32 adds per active
    (row, feature), at the f32 add rate."""
    act = int((ni >= 0).sum())
    nbytes = ni.size * 4 + act * (F + 8) + N * F * B * 8
    ops = 2 * act * F
    return 1e3 * nbytes / card["bw"], 1e3 * ops / card["f32_add"]


def phase_hist(binned: dict, card: dict, flush: torch.Tensor) -> dict:
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    R = binned[255].shape[0]
    g = rng.standard_normal(R).astype(np.float32)
    h = (0.25 * rng.random(R)).astype(np.float32)
    gd, hd = torch.from_numpy(g).to(dev), torch.from_numpy(h).to(dev)
    per_n = {}
    max_err = 0.0
    for B, nodes in HIST_SHAPES:
        Xd = torch.from_numpy(binned[B]).to(dev)
        for N in nodes:
            ni = rng.integers(0, N, size=R).astype(np.int32)
            ni[rng.random(R) < 0.1] = -1
            nid = torch.from_numpy(ni).to(dev)
            args = (Xd, gd, hd, nid, N, B)
            got = hist_cuda.build_histograms_cuda(*args)
            want = histogram.build_histograms_segment(*args)
            # Per cell: 1e-5 * (sum of |g| or |h| over the cell's rows).
            tol = 1e-5 * histogram.build_histograms_segment(
                Xd, gd.abs(), hd.abs(), nid, N, B) + 1e-6
            err = (got - want).abs()
            check(bool((err <= tol).all()),
                  f"hist B={B} N={N}: max err {float(err.max())}")
            err = float(err.max())
            max_err = max(max_err, err)
            # Library yardstick: two weighted bincounts over the combined
            # (f*N + node)*B + bin key (keys and weights made beforehand).
            key = ((torch.arange(FEATURES, device=dev)[None, :] * N
                    + nid.clamp(min=0).long()[:, None]) * B
                   + Xd.long()).reshape(-1)
            wg = torch.where(nid >= 0, gd, 0.0)[:, None] \
                .expand(R, FEATURES).reshape(-1).contiguous()
            wh = torch.where(nid >= 0, hd, 0.0)[:, None] \
                .expand(R, FEATURES).reshape(-1).contiguous()
            m = FEATURES * N * B
            lib = torch.stack([torch.bincount(key, wg, minlength=m),
                               torch.bincount(key, wh, minlength=m)], -1)
            lib = lib.reshape(FEATURES, N, B, 2).permute(1, 0, 2, 3)
            check(bool(((lib.float() - want).abs() <= tol).all()),
                  f"bincount yardstick B={B} N={N}")
            t_bytes, t_ops = hist_bound_ms(ni, FEATURES, N, B, card)
            row = {
                "kernel_ms": time_ms(lambda: hist_cuda.build_histograms_cuda(
                    *args), 20, flush),
                "plain_ms": time_ms(
                    lambda: histogram.build_histograms_segment(*args), 5,
                    flush),
                "library_ms": time_ms(lambda: (
                    torch.bincount(key, wg, minlength=m),
                    torch.bincount(key, wh, minlength=m)), 10, flush),
                "bound_ms": max(t_bytes, t_ops),
                "bound_bytes_ms": t_bytes, "bound_ops_ms": t_ops,
                "max_abs_err": err,
            }
            del key, wg, wh, lib, tol
            per_n[(B, N)] = row
            emit({"phase": "hist", "rows": R, "features": FEATURES,
                  "bins": B, "nodes": N, "frozen_frac": 0.1,
                  "plan": hist_cuda.plan_tiles(
                      N, FEATURES, B, _build.smem_limit(dev)).__dict__,
                  **row})
    # One tree of the main path with sibling subtraction (on for the
    # card) builds 1, 1, 2, 4, 8, 16 nodes at 255 bins.
    seq = TREE_SEQ
    tree = {k: sum(per_n[(255, n)][k] for n in seq)
            for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms",
                      "bound_bytes_ms", "bound_ops_ms")}
    tree["bound_by"] = ("bytes" if tree["bound_bytes_ms"]
                        >= tree["bound_ops_ms"] else "operations")
    emit({"phase": "hist", "per_tree_main_path": list(seq), **tree})
    return {"max_abs_err": max_err, **tree}


def exact_grid_ensemble(T, depth, F, B, C, cat, seed=0):
    """Random pushed-down-able trees with leaf values on the 1/8 grid,
    learned default directions and categorical features."""
    rng = np.random.default_rng(seed)
    N = 2 ** (depth + 1) - 1
    ens = empty_ensemble(T, depth, F, 0.125, 0.25, "softmax", n_classes=C,
                         missing_bin=True, n_bins=B, cat_features=cat)
    ens.feature[:] = rng.integers(0, F, size=(T, N))
    ens.threshold_bin[:] = rng.integers(0, B - 2, size=(T, N))
    ens.is_leaf[:] = rng.random((T, N)) < 0.2
    ens.leaf_value[:] = rng.integers(-7, 8, size=(T, N)) / 8.0
    ens.default_left[:] = rng.random((T, N)) < 0.5
    return ens


def device_operands(ce, dev):
    ops = [torch.from_numpy(a).to(dev) for a in ce.arrays()]
    ef, et, bv, coh, *rest = ops
    dl = rest.pop(0) if ce.eff_dl is not None else None
    cat = rest.pop(0) if ce.eff_cat is not None else None
    tables = predict_cuda.pack_tables(ef, et, bv, coh, ce.max_depth,
                                      eff_dl=dl, eff_cat=cat)
    kw = dict(learning_rate=ce.learning_rate, base=ce.base_score,
              tree_chunk=ce.tree_chunk,
              missing_bin_value=ce.missing_bin_value)

    def kernel(X):
        return predict_cuda.traverse_cuda(tables, X, **kw)

    def plain(X):
        return predict.predict_effective_plain(
            ef, et, bv, coh, X, max_depth=ce.max_depth, eff_dl=dl,
            eff_cat=cat, **kw)

    return tables, kernel, plain


def phase_traverse_exact(Xb: np.ndarray) -> None:
    dev = torch.device("cuda")
    ens = exact_grid_ensemble(70, DEPTH, FEATURES, 255, 7, (3, 10))
    ce = ens.compile(tree_chunk=64)
    _, kernel, plain = device_operands(ce, dev)
    Xd = torch.from_numpy(Xb).to(dev)
    got = kernel(Xd).cpu().numpy()
    want = plain(Xd).cpu().numpy()
    check(np.array_equal(got, want), "traverse exact-grid kernel == plain")
    sub = 50_000
    oracle = ens.predict_raw(Xb[:sub], binned=True)
    check(np.array_equal(got[:sub], oracle),
          "traverse exact-grid kernel == host oracle")
    emit({"phase": "traverse_exact", "rows": len(Xb), "trees": 70,
          "depth": DEPTH, "classes": 7, "missing": True, "cat": [3, 10],
          "bitwise_equal": True, "oracle_rows": sub})


def phase_main(X: np.ndarray, y: np.ndarray) -> dict:
    cfg = TrainConfig(n_trees=N_TREES, max_depth=DEPTH, n_bins=255,
                      device="cuda")
    hist_cuda.launches = 0
    hist_cuda.launches_int = 0
    predict_cuda.launches = 0
    t0 = time.perf_counter()
    res = api.train(X, y, cfg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    p = api.predict(res.ensemble, X, mapper=res.mapper)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {"hist": hist_cuda.launches,
                "traverse": predict_cuda.launches}
    check(launches["hist"] > 0, "histogram kernel launched on main path")
    check(hist_cuda.launches_int == 0,
          "integer histogram mode not launched on the f32 path")
    check(launches["traverse"] > 0, "traversal kernel launched on main path")
    check(p.shape == (len(X),) and np.all(np.isfinite(p)),
          "predictions finite, one per row")
    train_auc = auc(y, p)
    check(train_auc >= 0.80, f"train AUC {train_auc} >= 0.80")
    # Scores equal the host oracle's (numpy traversal) to f32 order.
    sub = 50_000
    Xb_sub = res.mapper.transform(X[:sub])
    raw = api.predict(res.ensemble, Xb_sub, binned=True, raw=True)
    oracle = res.ensemble.predict_raw(Xb_sub, binned=True)
    check(np.all(np.abs(raw - oracle) <= 1e-5 * (np.abs(oracle) + 1)),
          "main-path scores == host oracle")
    emit({"phase": "main", "rows": len(X), "features": FEATURES,
          "bins": 255, "depth": DEPTH, "trees": N_TREES,
          "train_s": t1 - t0, "predict_s": t2 - t1,
          "train_auc": train_auc, "launches": launches,
          "hist_launches_per_tree": launches["hist"] / N_TREES})
    return {"res": res, "launches": launches, "auc": train_auc,
            "train_s": t1 - t0}


def phase_traverse_trained(res, X: np.ndarray, card: dict,
                           flush: torch.Tensor) -> dict:
    dev = torch.device("cuda")
    ce = res.ensemble.compile(tree_chunk=64)
    tables, kernel, plain = device_operands(ce, dev)
    Xd = torch.from_numpy(res.mapper.transform(X)).to(dev)
    got = kernel(Xd).cpu().numpy()
    want = plain(Xd).cpu().numpy()
    err = np.abs(got - want)
    check(np.all(err <= 1e-5 * (np.abs(want) + 1)),
          f"traverse trained: max err {float(err.max())}")
    R, F = Xd.shape
    table_bytes = sum(t.numel() * t.element_size() for t in tables[:4])
    nbytes = R * F + R * ce.n_classes_out * 4 + table_bytes
    compares = traverse_compares(ce, Xd)
    adds = R * res.ensemble.n_trees
    t_bytes = 1e3 * nbytes / card["bw"]
    t_ops = 1e3 * (compares / card["int32"] + adds / card["f32_add"])
    row = {
        "kernel_ms": time_ms(lambda: kernel(Xd), 20, flush),
        "plain_ms": time_ms(lambda: plain(Xd), 3, flush),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "int32_compares": compares, "f32_adds": adds,
        "max_abs_err": float(err.max()),
    }
    emit({"phase": "traverse_trained", "rows": R, "trees": N_TREES,
          "trees_padded": ce.n_trees_padded, "depth": DEPTH, **row})
    return row


def traverse_compares(ce, Xd: torch.Tensor) -> int:
    """Integer compares this data needs: one per real (not pushed-down)
    split node on each row's path (the bound adds one f32 add per row and
    real tree). Counted from the plain descent's bottom-level index k: the
    path node at level d is (2^d - 1) + (k >> (D - d))."""
    dev = Xd.device
    D = ce.max_depth
    ef = torch.from_numpy(ce.eff_feat).to(dev)
    et = torch.from_numpy(ce.eff_thr).to(dev)
    compares = 0
    for t0 in range(0, ef.shape[0], ce.tree_chunk):
        ts = slice(t0, t0 + ce.tree_chunk)
        tidx = torch.arange(ef[ts].shape[0], device=dev)[None, :]
        for r0 in range(0, Xd.shape[0], 65_536):
            k = predict.descend_plain(ef[ts], et[ts], Xd[r0:r0 + 65_536], D)
            for d in range(D):
                node = ((1 << d) - 1) + (k >> (D - d))
                compares += int((ef[ts][tidx, node] >= 0).sum())
    return compares


def lut_grid_ensemble(T, depth, F, B, C, cat, qmax, seed=0):
    """exact_grid_ensemble with leaves on the 1/(qmax+1) grid and each
    tree's largest |leaf| pinned to qmax/(qmax+1) (the left spine stays
    internal): the per-tree scale max/qmax is exactly 1/(qmax+1), so int8
    (qmax 127) or int4 (qmax 7) quantization is lossless."""
    ens = exact_grid_ensemble(T, depth, F, B, C, cat, seed=seed)
    rng = np.random.default_rng(seed + 1)
    ens.leaf_value[:] = rng.integers(
        -qmax, qmax + 1, size=ens.leaf_value.shape) / (qmax + 1)
    ens.is_leaf[:, [(1 << d) - 1 for d in range(depth)]] = False
    ens.leaf_value[:, (1 << depth) - 1] = qmax / (qmax + 1)
    return ens


def lut_callables(tables, dev):
    """(operand tensors on the card, kernel(X), plain(X)) of the tier
    `tables` serves: K4 for fp16/int8 leaves, K5 for int4."""
    if tables.leaf_dtype == "int4":
        p = tables.pack_int4()
        host, static = p.ops, p.static_kwargs()
        kern = predict_lut_cuda.lut_int4_cuda
        plain = predict_lut.predict_effective_lut4_plain
    else:
        host = predict_lut.lut_device_operands(tables)
        static = predict_lut.lut_static_kwargs(tables)
        kern = predict_lut_cuda.lut_int8_cuda
        plain = predict_lut.predict_effective_lut_plain
    ops = tuple(torch.from_numpy(a).to(dev) for a in host)
    n_int = (1 << tables.max_depth) - 1
    extras = dict(
        cls=torch.from_numpy(tables.cls_oh.argmax(axis=1).astype(np.int32))
        .to(dev), max_feature=int(tables.eff_feat[:, :n_int].max()))
    return (ops, lambda X: kern(ops, X, **static, **extras),
            lambda X: plain(ops, X, **static))


def phase_lut_exact(X: np.ndarray, Xb: np.ndarray) -> None:
    dev = torch.device("cuda")
    Xb13 = fit_bin_mapper(X, n_bins=13).transform(X)
    cases = (("K4 fp16", "float16", 255, 7, Xb),
             ("K4 int8", "int8", 255, 127, Xb),
             ("K5 13 bins", "int4", 13, 7, Xb13),
             ("K5 255 bins", "int4", 255, 7, Xb))
    for what, leaf_dtype, B, qmax, rows in cases:
        ens = lut_grid_ensemble(70, DEPTH, FEATURES, B, 7, (3, 10), qmax)
        ce = ens.compile(tree_chunk=64)
        tables = ce.quantize(leaf_dtype)
        check(tables.max_abs_err == 0.0, f"{what}: lossless grid")
        packed = (tables.pack_int4().thr_packed
                  if leaf_dtype == "int4" else None)
        if leaf_dtype == "int4":
            check(packed == (B <= 15), f"{what}: thr_packed {packed}")
        _, kernel, plain = lut_callables(tables, dev)
        Xd = torch.from_numpy(rows).to(dev)
        got = kernel(Xd).cpu().numpy()
        check(np.array_equal(got, plain(Xd).cpu().numpy()),
              f"{what}: kernel == plain, bitwise")
        _, k3, _ = device_operands(ce, dev)
        check(np.array_equal(got, k3(Xd).cpu().numpy()),
              f"{what}: kernel == traversal kernel on the f32 ensemble")
        emit({"phase": "lut_exact", "case": what, "leaf_dtype": leaf_dtype,
              "bins": B, "thr_packed": packed, "rows": len(rows),
              "trees": 70, "depth": DEPTH, "classes": 7, "missing": True,
              "cat": [3, 10], "bitwise_equal_plain": True,
              "bitwise_equal_traverse": True, "max_abs_err": 0.0})


def lut_bound_ms(ce, ops, Xd, card: dict, muls: bool,
                 n_trees: int) -> dict:
    """The traversal's bound (traverse_compares) over the quantized
    tables: bytes = rows in, scores out, every operand and the per-tree
    class once; operations = INT32 compares plus one f32 add per row and
    real tree, and one f32 multiply more where leaves are dequantized by
    scale (priced at the add rate)."""
    R, F = Xd.shape
    table_bytes = sum(t.numel() * t.element_size() for t in ops) \
        + 4 * ce.n_trees_padded
    nbytes = R * F + R * ce.n_classes_out * 4 + table_bytes
    compares = traverse_compares(ce, Xd)
    flops = R * n_trees * (2 if muls else 1)
    t_bytes = 1e3 * nbytes / card["bw"]
    t_ops = 1e3 * (compares / card["int32"] + flops / card["f32_add"])
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "table_bytes": table_bytes,
            "int32_compares": compares, "f32_ops": flops}


def lut_measure(what, tables, ce, n_trees, Xd, card, flush,
                k3_out=None) -> dict:
    dev = Xd.device
    ops, kernel, plain = lut_callables(tables, dev)
    got = kernel(Xd)
    want = plain(Xd)
    err = (got - want).abs()
    check(bool((err <= 1e-5 * (want.abs() + 1)).all()),
          f"{what}: kernel vs plain max err {float(err.max())}")
    row = {"max_abs_err": float(err.max())}
    if k3_out is not None:
        d = (got - k3_out).abs()
        lim = tables.max_abs_err * (1 + 1e-5) + 1e-5 * (k3_out.abs() + 1)
        check(bool((d <= lim).all()),
              f"{what}: vs traversal kernel {float(d.max())} > "
              f"max_abs_err {tables.max_abs_err}")
        row["max_abs_diff_vs_traverse"] = float(d.max())
    row.update(lut_bound_ms(ce, ops, Xd, card,
                            muls=tables.leaf_dtype != "float16",
                            n_trees=n_trees))
    row["kernel_ms"] = time_ms(lambda: kernel(Xd), 20, flush)
    row["plain_ms"] = time_ms(lambda: plain(Xd), 3, flush)
    row["library_ms"] = None       # no single PyTorch call computes it
    row["tables_max_abs_err"] = tables.max_abs_err
    return row


def phase_lut_trained(res, X: np.ndarray, card: dict,
                      flush: torch.Tensor) -> dict:
    dev = torch.device("cuda")
    ce = res.ensemble.compile(tree_chunk=64)
    k3_tables, k3, _ = device_operands(ce, dev)
    Xd = torch.from_numpy(res.mapper.transform(X)).to(dev)
    k3_out = k3(Xd)
    rows = {}
    for name, leaf_dtype in (("lut", "float16"), ("lut4", "int4")):
        tables = ce.quantize(leaf_dtype)
        rows[name] = lut_measure(name, tables, ce, res.ensemble.n_trees,
                                 Xd, card, flush, k3_out)
        rows[name]["thr_packed"] = (tables.pack_int4().thr_packed
                                    if leaf_dtype == "int4" else None)
        emit({"phase": "lut_trained", "kernel": name,
              "leaf_dtype": leaf_dtype, "rows": Xd.shape[0],
              "trees": N_TREES, "depth": DEPTH, **rows[name]})
    emit({"phase": "lut_trained", "table_bytes": {
        "f32 (traverse)": sum(t.numel() * t.element_size()
                              for t in k3_tables[:4]),
        "int8 tier (lut)": rows["lut"]["table_bytes"],
        "int4 tier (lut4)": rows["lut4"]["table_bytes"]}})
    return rows


def phase_lut4_packed(X: np.ndarray, y: np.ndarray, card: dict,
                      flush: torch.Tensor):
    cfg = TrainConfig(n_trees=N_TREES, max_depth=DEPTH, n_bins=15)
    t0 = time.perf_counter()
    res = api.train(X, y, cfg)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    ce = res.ensemble.compile(tree_chunk=64)
    tables = ce.quantize("int4")
    check(tables.pack_int4().thr_packed, "15-bin model: thr_packed")
    Xd = torch.from_numpy(res.mapper.transform(X)).to(torch.device("cuda"))
    _, k3, _ = device_operands(ce, Xd.device)
    row = lut_measure("lut4 packed", tables, ce, res.ensemble.n_trees, Xd,
                      card, flush, k3(Xd))
    emit({"phase": "lut4_packed", "rows": len(X), "bins": 15,
          "trees": N_TREES, "depth": DEPTH, "train_s": train_s,
          "thr_packed": True, **row})
    return res, row


def serve_tier(tier, b255, b15, pool, refs) -> dict:
    """One engine at `tier` under load with a hot swap, then the express
    lane at idle; every response checked against offline api.predict."""
    eng = ServeEngine(b255, TrainConfig(), quantize=tier, max_batch=256,
                      max_wait_ms=1.0)
    try:
        results, errors = [], []
        lock = threading.Lock()
        per_thread = SERVE_REQUESTS // SERVE_THREADS

        def submitter(tid):
            rng = np.random.default_rng(tid)
            for _ in range(per_thread):
                s = int(rng.integers(0, SERVE_POOL - 64))
                c = int(rng.integers(1, 65))
                try:
                    req = eng.predict_async(pool[s:s + c])
                    out = req.result(timeout=60.0)
                except Exception as e:  # collected, checked empty below
                    with lock:
                        errors.append(repr(e))
                    continue
                with lock:
                    results.append((s, c, req.model_token, out))

        threads = [threading.Thread(target=submitter, args=(t,))
                   for t in range(SERVE_THREADS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        while True:
            with lock:
                n_done = len(results) + len(errors)
            if n_done >= SERVE_REQUESTS // 2 or \
                    not any(t.is_alive() for t in threads):
                break
            time.sleep(0.001)
        swap = eng.swap(b15)
        for t in threads:
            t.join(120)
        load_s = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads), "submitters done")
        check(not errors, f"serve {tier}: errors {errors[:3]}")
        load = eng.stats.window_summary(reset=True)
        # Median request-trace segments of the last loaded requests.
        ring = eng.stats.traces_snapshot()
        segments = {k: float(np.median([t[k] for t in ring]))
                    for k in ("handler_ms", "queue_ms", "gate_ms",
                              "device_ms", "wake_ms", "total_ms")}
        # Express lane: single rows at an idle queue, one at a time.
        rng = np.random.default_rng(99)
        for _ in range(EXPRESS_REQUESTS):
            s = int(rng.integers(0, SERVE_POOL))
            req = eng.predict_async(pool[s:s + 1])
            results.append((s, 1, req.model_token, req.result(timeout=60.0)))
        express = eng.stats.window_summary(reset=True)
        tokens = {swap["old"], swap["new"]}
        for s, c, token, out in results:
            check(token in tokens, f"serve {tier}: unknown token")
            check(np.array_equal(out, refs[token, tier][s:s + c]),
                  f"serve {tier}: rows [{s}:{s + c}] differ from offline "
                  "api.predict")
        by_token = {tok: sum(1 for r in results if r[2] == tok)
                    for tok in tokens}
        check(all(by_token.values()), f"serve {tier}: both models served")
        for tok in tokens:
            got = eng.backend.resolved_predict_impl(tok)
            check(got == TIER_RESOLVED[tier],
                  f"serve {tier}: token {tok[:12]} resolved to {got}")
        check(eng.health()["predict_impl"] == TIER_RESOLVED[tier],
              f"serve {tier}: health tier")
        check(express["express"] >= 1, f"serve {tier}: express lane used")
    finally:
        eng.close()
    return {"tier": tier or "f32", "requests": load["requests"],
            "load_s": load_s, "batches": load["batches"],
            "coalesce_max": load["coalesce_max"],
            "coalesce_mean": load["coalesce_mean"],
            "p50_ms": load["p50_ms"], "p99_ms": load["p99_ms"],
            "p999_ms": load["p999_ms"], "responses_by_model": list(
                by_token.values()), "trace_median_ms": segments,
            "express_requests": express["requests"],
            "express_lane": express["express"],
            "express_p50_ms": express["p50_ms"],
            "express_p99_ms": express["p99_ms"]}


def phase_serve(res255, res15, X: np.ndarray) -> dict:
    b255 = api.ModelBundle(res255.ensemble, res255.mapper)
    b15 = api.ModelBundle(res15.ensemble, res15.mapper)
    pool = np.ascontiguousarray(X[:SERVE_POOL], np.float32)
    # Offline answers first: their launches are the yardstick's, not the
    # serving path's.
    refs = {}
    for tier, impl in TIER_IMPL.items():
        for b in (b255, b15):
            token = b.ensemble.compile(tree_chunk=64).token
            refs[token, tier] = api.predict(
                b, pool, cfg=TrainConfig(predict_impl=impl))
    torch.cuda.synchronize()
    predict_cuda.launches = 0
    predict_lut_cuda.launches_lut = 0
    predict_lut_cuda.launches_lut4 = 0
    t0 = time.perf_counter()
    tiers = [serve_tier(t, b255, b15, pool, refs) for t in TIER_IMPL]
    torch.cuda.synchronize()
    launches = {"traverse": predict_cuda.launches,
                "lut": predict_lut_cuda.launches_lut,
                "lut4": predict_lut_cuda.launches_lut4}
    for name in ("traverse", "lut", "lut4"):
        check(launches[name] > 0, f"{name} kernel launched while serving")
    for row in tiers:
        emit({"phase": "serve", **row})
    emit({"phase": "serve", "wall_s": time.perf_counter() - t0,
          "launches": launches, "max_batch": 256, "max_wait_ms": 1.0,
          "threads": SERVE_THREADS})
    return launches


def phase_parity(X: np.ndarray, y: np.ndarray) -> None:
    Xs, ys = X[:PARITY_ROWS], y[:PARITY_ROWS]
    cfg = TrainConfig(n_trees=PARITY_TREES, max_depth=DEPTH, n_bins=255,
                      min_split_gain=1e-3)
    t0 = time.perf_counter()
    on_card = api.train(Xs, ys, cfg, device="cuda")
    t1 = time.perf_counter()
    on_cpu = api.train(Xs, ys, cfg, device="cpu")
    t2 = time.perf_counter()
    n_rc = trees_match_mod_ties(on_cpu.ensemble, on_card.ensemble, 1e-3)
    a_card = auc(ys, api.predict(on_card.ensemble, Xs,
                                 mapper=on_card.mapper))
    a_cpu = auc(ys, api.predict(on_cpu.ensemble, Xs, mapper=on_cpu.mapper,
                                device="cpu"))
    check(abs(a_card - a_cpu) <= 0.005, f"AUC {a_card} vs {a_cpu}")
    same = int(np.sum(np.all(
        (on_card.ensemble.feature == on_cpu.ensemble.feature)
        & (on_card.ensemble.threshold_bin == on_cpu.ensemble.threshold_bin),
        axis=1)))
    emit({"phase": "parity", "rows": PARITY_ROWS, "trees": PARITY_TREES,
          "identical_trees": same, "tie_root_causes": n_rc,
          "auc_card": a_card, "auc_cpu": a_cpu,
          "train_card_s": t1 - t0, "train_cpu_s": t2 - t1})

# --------------------------------------------------------------------- #
# quantized-gradient training (grad_dtype int8 / int16)
# --------------------------------------------------------------------- #

def logloss_gh(R: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """f32 logloss (g, h) at random raw scores and labels."""
    rng = np.random.default_rng(seed)
    raw = (0.5 * rng.standard_normal(R)).astype(np.float32)
    y = (rng.random(R) < 0.5).astype(np.float32)
    p = (np.float32(1) / (np.float32(1) + np.exp(-raw))).astype(np.float32)
    return (p - y).astype(np.float32), (p * (1 - p)).astype(np.float32)


def scale_term(a: np.ndarray, grad_dtype: str) -> dict:
    """Which term of quant_scale set the scale of values `a`, from host
    stats: 'max' (max|a| / qmax, exact) or 'sum_cap' (the power-of-two
    snap of sum|a| / 2^30)."""
    mx, sm = np.max(np.abs(a)), np.sum(np.abs(a))
    base = np.float32(mx) / np.float32(grad.GRAD_QMAX[grad_dtype])
    scale = grad.quant_scale_np(mx, sm, grad_dtype)
    return {"term": "max" if scale == base else "sum_cap",
            "max_term": float(base),
            "cap_term": float(grad.quant_scale_np(0.0, sm, grad_dtype)),
            "sum_abs_numpy": float(sm)}


def phase_quantize(flush: torch.Tensor) -> dict:
    dev = torch.device("cuda")
    g, h = logloss_gh(ROWS, 11)
    gd, hd = torch.from_numpy(g).to(dev), torch.from_numpy(h).to(dev)
    out = {}
    for dt in ("int8", "int16"):
        qg, qh, gs, hs = grad.quantize_gradients(gd, hd, grad_dtype=dt,
                                                 tree_id=3, seed=11)
        ng, nh, ngs, nhs = grad.quantize_gradients_np(
            g, h, grad_dtype=dt, tree_id=3, seed=11)
        check(np.array_equal(qg.cpu().numpy(), ng), f"quantize {dt}: q(g)")
        check(np.array_equal(qh.cpu().numpy(), nh), f"quantize {dt}: q(h)")
        check(float(gs) == float(ngs) and float(hs) == float(nhs),
              f"quantize {dt}: scales {float(gs)} {float(ngs)} "
              f"{float(hs)} {float(nhs)}")
        _, sg, _, sh = grad.grad_abs_stats(gd, hd)
        row = {"gscale": float(gs), "hscale": float(hs),
               "g": {**scale_term(g, dt), "sum_abs_card": float(sg)},
               "h": {**scale_term(h, dt), "sum_abs_card": float(sh)},
               "q_bitwise_equal": True, "scales_equal": True,
               "ms": time_ms(lambda: grad.quantize_gradients(
                   gd, hd, grad_dtype=dt, tree_id=3, seed=11), 20, flush)}
        out[dt] = row
        emit({"phase": "quantize", "rows": ROWS, "grad_dtype": dt, **row})
    for base in (0, (1 << 33) + 0xFFFFFF00):
        u = sampling.uniform(11, 3, base, ROWS, dev).cpu().numpy()
        check(np.array_equal(u.view(np.uint32),
                             sampling.uniform_np(11, 3, base, ROWS)
                             .view(np.uint32)),
              f"uniform twin at row base {base}")
        emit({"phase": "quantize", "uniform_row_base": base, "rows": ROWS,
              "bitwise_equal_uniform_np": True})
    return out


def hist_int_bound_ms(ni: np.ndarray, F: int, N: int, B: int,
                      itemsize: int, card: dict) -> tuple[float, float]:
    """(bytes time, operations time) in ms of the integer mode: the node
    index of every row, Xb and the two q's of each active row read once,
    the int32 table written once; 2 INT32 adds per active (row, feature)
    at the INT32 rate."""
    act = int((ni >= 0).sum())
    nbytes = ni.size * 4 + act * (F + 2 * itemsize) + N * F * B * 8
    return 1e3 * nbytes / card["bw"], 1e3 * 2 * act * F / card["int32"]


def phase_hist_int(binned: dict, card: dict, flush: torch.Tensor) -> dict:
    dev = torch.device("cuda")
    R = binned[255].shape[0]
    rng = np.random.default_rng(7)
    g = rng.standard_normal(R).astype(np.float32)
    h = (0.25 * rng.random(R)).astype(np.float32)
    rows = {}
    for dt, itemsize in (("int8", 1), ("int16", 2)):
        qg, qh, _, _ = grad.quantize_gradients_np(g, h, grad_dtype=dt,
                                                  tree_id=0, seed=7)
        gd, hd = torch.from_numpy(qg).to(dev), torch.from_numpy(qh).to(dev)
        rng_n = np.random.default_rng(8)
        for B, nodes in HIST_SHAPES:
            Xd = torch.from_numpy(binned[B]).to(dev)
            for N in nodes:
                ni = rng_n.integers(0, N, size=R).astype(np.int32)
                ni[rng_n.random(R) < 0.1] = -1
                nid = torch.from_numpy(ni).to(dev)
                args = (Xd, gd, hd, nid, N, B)
                got = hist_cuda.build_histograms_cuda(*args)
                want = histogram.build_histograms_segment(*args)
                check(got.dtype == torch.int32 and torch.equal(got, want),
                      f"hist_int {dt} B={B} N={N}: kernel != plain")
                err = int((got.long() - want.long()).abs().max())
                # Library yardstick: two int32 index_add_ calls over the
                # combined (f*N + node)*B + bin key.
                key = ((torch.arange(FEATURES, device=dev)[None, :] * N
                        + nid.clamp(min=0).long()[:, None]) * B
                       + Xd.long()).reshape(-1)
                act = nid >= 0
                wg = torch.where(act, gd.int(), 0)[:, None] \
                    .expand(R, FEATURES).reshape(-1).contiguous()
                wh = torch.where(act, hd.int(), 0)[:, None] \
                    .expand(R, FEATURES).reshape(-1).contiguous()
                m = FEATURES * N * B

                def library():
                    return (torch.zeros(m, dtype=torch.int32, device=dev)
                            .index_add_(0, key, wg),
                            torch.zeros(m, dtype=torch.int32, device=dev)
                            .index_add_(0, key, wh))

                lib = torch.stack(library(), -1).reshape(
                    FEATURES, N, B, 2).permute(1, 0, 2, 3)
                check(torch.equal(lib, want),
                      f"index_add_ yardstick {dt} B={B} N={N}")
                t_bytes, t_ops = hist_int_bound_ms(ni, FEATURES, N, B,
                                                   itemsize, card)
                row = {
                    "kernel_ms": time_ms(
                        lambda: hist_cuda.build_histograms_cuda(*args), 20,
                        flush),
                    "plain_ms": time_ms(
                        lambda: histogram.build_histograms_segment(*args), 5,
                        flush),
                    "library_ms": time_ms(library, 10, flush),
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_bytes_ms": t_bytes, "bound_ops_ms": t_ops,
                    "max_abs_err": err,
                }
                row["bound_by"] = ("bytes" if t_bytes >= t_ops
                                   else "operations")
                del key, wg, wh, lib
                rows[(dt, B, N)] = row
                emit({"phase": "hist_int", "grad_dtype": dt, "rows": R,
                      "features": FEATURES, "bins": B, "nodes": N,
                      "frozen_frac": 0.1, "bitwise_equal": True, **row})
    out = {"rows": rows}
    for dt in ("int8", "int16"):
        tree = {k: sum(rows[(dt, 255, n)][k] for n in TREE_SEQ)
                for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms",
                          "bound_bytes_ms", "bound_ops_ms")}
        tree["bound_by"] = ("bytes" if tree["bound_bytes_ms"]
                            >= tree["bound_ops_ms"] else "operations")
        out[dt] = tree
        emit({"phase": "hist_int", "grad_dtype": dt,
              "per_tree_main_path": list(TREE_SEQ), **tree})
    out["max_abs_err"] = max(r["max_abs_err"] for r in rows.values())
    return out


TREE_FIELDS = ("feature", "threshold_bin", "is_leaf", "leaf_value",
               "split_gain", "default_left")


def phase_quant_exact(binned: dict, y: np.ndarray) -> None:
    # (a) mse on y in {-1, +1} with mean exactly 0: g = -/+1 and h = 1, so
    # q = -/+127 and 127, and with 127 * rows < 2^24 every integer sum
    # converts to f32 exactly and dequantizes to the f32 path's sum.
    R = QUANT_EXACT_ROWS
    Xb = binned[255][:R]
    ypm = np.where(y[:R] > 0.5, 1.0, -1.0).astype(np.float32)
    flip = np.flatnonzero(ypm > 0 if ypm.sum() > 0 else ypm < 0)
    ypm[flip[:int(abs(ypm.sum())) // 2]] *= -1
    check(ypm.sum() == 0, "balanced +-1 labels")
    cfg = TrainConfig(n_trees=1, max_depth=DEPTH, n_bins=255, loss="mse")
    hist_cuda.launches_int = 0
    ens = {dt: api.train(Xb, ypm, cfg.replace(grad_dtype=dt),
                         binned=True).ensemble for dt in ("f32", "int8")}
    check(hist_cuda.launches_int > 0, "quant_exact ran the integer mode")
    for k in TREE_FIELDS:
        check(np.array_equal(getattr(ens["f32"], k), getattr(ens["int8"], k)),
              f"quant_exact mse: {k} int8 == f32")
    emit({"phase": "quant_exact", "case": "mse y in {-1,+1}", "rows": R,
          "depth": DEPTH, "bins": 255, "bitwise_equal": list(TREE_FIELDS),
          "split_nodes": int((ens["f32"].feature >= 0).sum())})
    # (b) the reference's pinned grid at full width: integer g in {-1, 0,
    # 1} and h = 1, each channel's max pinned to 127, so the scale is
    # exactly 1.0 and every sum stays below 2^24.
    R = ROWS
    rng = np.random.default_rng(5)
    g = rng.integers(-1, 2, size=R).astype(np.float32)
    h = np.ones(R, np.float32)
    g[0] = h[0] = 127.0
    trees = {}
    for dt in ("f32", "int8"):
        be = get_backend(TrainConfig(n_trees=1, max_depth=DEPTH, n_bins=255,
                                     grad_dtype=dt))
        data = be.upload(binned[255])
        handle, _ = be.grow_tree(data, torch.from_numpy(g).to(be.device),
                                 torch.from_numpy(h).to(be.device),
                                 tree_id=0)
        trees[dt] = be.fetch_tree(handle)
    for k in TREE_FIELDS:
        check(np.array_equal(trees["f32"][k], trees["int8"][k]),
              f"quant_exact pinned grid: {k} int8 == f32")
    emit({"phase": "quant_exact", "case": "pinned grid, scale 1.0",
          "rows": R, "depth": DEPTH, "bins": 255,
          "bitwise_equal": list(TREE_FIELDS),
          "split_nodes": int((trees["f32"]["feature"] >= 0).sum())})


def boost_ms_per_tree(Xb: np.ndarray, y: np.ndarray, grad_dtype: str) -> float:
    """ms per tree of the Driver's boosting loop on binned rows (upload
    included, binning not), host clock ending in a synchronize."""
    cfg = TrainConfig(n_trees=N_TREES, max_depth=DEPTH, n_bins=255,
                      grad_dtype=grad_dtype)
    t0 = time.perf_counter()
    api.train(Xb, y, cfg, binned=True)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / N_TREES


def phase_train_quant(X: np.ndarray, y: np.ndarray, binned: dict,
                      main_run: dict) -> dict:
    cfg = TrainConfig(n_trees=N_TREES, max_depth=DEPTH, n_bins=255,
                      grad_dtype="int8")
    hist_cuda.launches = 0
    hist_cuda.launches_int = 0
    predict_cuda.launches = 0
    t0 = time.perf_counter()
    res = api.train(X, y, cfg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    p = api.predict(res.ensemble, X, mapper=res.mapper)
    launches = {"hist_int": hist_cuda.launches_int,
                "hist_f32": hist_cuda.launches,
                "traverse": predict_cuda.launches}
    check(launches["hist_int"] > 0, "integer histogram mode launched")
    check(launches["hist_f32"] == 0, "f32 histogram mode not launched")
    check(launches["traverse"] > 0, "traversal kernel launched")
    check(p.shape == (len(X),) and np.all(np.isfinite(p)), "finite scores")
    a = auc(y, p)
    check(a >= 0.80, f"int8 train AUC {a} >= 0.80")
    check(abs(a - main_run["auc"]) <= 0.005,
          f"int8 AUC {a} vs f32 {main_run['auc']}")
    # Per-round split agreement: both trees of a round grown from the same
    # f32 boosting state (the reference's acceptance protocol).
    be_f = get_backend(TrainConfig(max_depth=DEPTH, n_bins=255))
    be_q = get_backend(TrainConfig(max_depth=DEPTH, n_bins=255,
                                   grad_dtype="int8"))
    data = be_f.upload(binned[255])
    yh = be_f.upload_labels(y)
    pred = be_f.init_pred(yh, float(np.log(y.mean() / (1 - y.mean()))))
    same = tot = 0
    for rnd in range(AGREE_ROUNDS):
        g, h = be_f.grad_hess(pred, yh)
        hf, delta = be_f.grow_tree(data, g, h, tree_id=rnd)
        hq, _ = be_q.grow_tree(data, g, h, tree_id=rnd)
        tf, tq = be_f.fetch_tree(hf), be_q.fetch_tree(hq)
        same += int((tf["feature"] == tq["feature"]).sum())
        tot += tf["feature"].size
        pred = be_f.apply_delta(pred, delta, 0)
    agree = same / tot
    check(agree >= 0.985, f"int8 split agreement {agree} >= 0.985")
    # Boosting loop alone, f32 and int8 in turns (binning excluded).
    order = ("f32", "int8", "int8", "f32")
    loop = {dt: [] for dt in ("f32", "int8")}
    for dt in order:
        loop[dt].append(boost_ms_per_tree(binned[255], y, dt))
    row = {"rows": len(X), "bins": 255, "depth": DEPTH, "trees": N_TREES,
           "grad_dtype": "int8", "train_s": t1 - t0,
           "train_s_f32_main": main_run["train_s"], "train_auc": a,
           "train_auc_f32": main_run["auc"], "launches": launches,
           "hist_int_launches_per_tree": launches["hist_int"] / N_TREES,
           "split_agreement": agree, "agreement_rounds": AGREE_ROUNDS,
           "boost_ms_per_tree": loop, "boost_order": list(order)}
    emit({"phase": "train_quant", **row})
    return row


def phase_parity_quant(X: np.ndarray, y: np.ndarray) -> dict:
    Xs, ys = X[:PARITY_ROWS], y[:PARITY_ROWS]
    cfg = TrainConfig(n_trees=PARITY_TREES, max_depth=DEPTH,
                      n_bins=PARITY_Q_BINS, min_split_gain=1e-3,
                      grad_dtype="int16", subsample=0.8,
                      colsample_bytree=0.8)
    hist_cuda.launches = 0
    hist_cuda.launches_int = 0
    t0 = time.perf_counter()
    on_card = api.train(Xs, ys, cfg, device="cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = {"hist_int": hist_cuda.launches_int,
                "hist_f32": hist_cuda.launches}
    check(launches["hist_int"] > 0 and launches["hist_f32"] == 0,
          f"parity_quant launches {launches}")
    on_cpu = api.train(Xs, ys, cfg, device="cpu")
    t2 = time.perf_counter()
    n_rc = trees_match_mod_ties(on_cpu.ensemble, on_card.ensemble, 1e-3)
    a_card = auc(ys, api.predict(on_card.ensemble, Xs,
                                 mapper=on_card.mapper))
    a_cpu = auc(ys, api.predict(on_cpu.ensemble, Xs, mapper=on_cpu.mapper,
                                device="cpu"))
    check(abs(a_card - a_cpu) <= 0.005, f"AUC {a_card} vs {a_cpu}")
    same = int(np.sum(np.all(
        (on_card.ensemble.feature == on_cpu.ensemble.feature)
        & (on_card.ensemble.threshold_bin == on_cpu.ensemble.threshold_bin),
        axis=1)))
    row = {"rows": PARITY_ROWS, "trees": PARITY_TREES,
           "bins": PARITY_Q_BINS, "grad_dtype": "int16", "subsample": 0.8,
           "colsample_bytree": 0.8, "identical_trees": same,
           "tie_root_causes": n_rc, "auc_card": a_card, "auc_cpu": a_cpu,
           "launches": launches, "train_card_s": t1 - t0,
           "train_cpu_s": t2 - t1}
    emit({"phase": "parity_quant", **row})
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = phase_device()
    phase_build()
    X, y = synthetic_binary(ROWS, n_features=FEATURES, seed=0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    binned = {B: fit_bin_mapper(X, n_bins=B).transform(X)
              for B, _ in HIST_SHAPES}
    hist = phase_hist(binned, card, flush)
    Xb = binned[255]
    phase_traverse_exact(Xb)
    main_run = phase_main(X, y)
    trav = phase_traverse_trained(main_run["res"], X, card, flush)
    phase_parity(X, y)
    phase_lut_exact(X, Xb)
    lut = phase_lut_trained(main_run["res"], X, card, flush)
    res15, _ = phase_lut4_packed(X, y, card, flush)
    served = phase_serve(main_run["res"], res15, X)
    phase_quantize(flush)
    hist_int = phase_hist_int(binned, card, flush)
    phase_quant_exact(binned, y)
    train_q = phase_train_quant(X, y, binned, main_run)
    parity_q = phase_parity_quant(X, y)
    launches = main_run["launches"]
    k2 = hist_int["rows"][("int16", 64, 32)]

    def lut_entry(name, line):
        r = lut[name]
        return {"name": name, "route": "cuda",
                "source": "ddt_tpu_torch/csrc/lut.cu",
                "replaces": f"ddt_tpu/ops/predict_lut.py:{line}",
                "launches": served[name], "max_abs_err": r["max_abs_err"],
                "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": None}

    emit({"kernels": [
        {"name": "hist", "route": "cuda",
         "source": "ddt_tpu_torch/csrc/hist.cu",
         "replaces": "ddt_tpu/ops/hist_pallas.py:175",
         "launches": launches["hist"], "max_abs_err": hist["max_abs_err"],
         "ms": hist["kernel_ms"], "plain_ms": hist["plain_ms"],
         "bound_ms": hist["bound_ms"], "bound_by": hist["bound_by"],
         "library_ms": hist["library_ms"]},
        {"name": "traverse", "route": "cuda",
         "source": "ddt_tpu_torch/csrc/traverse.cu",
         "replaces": "ddt_tpu/ops/predict_pallas.py:105",
         "launches": launches["traverse"],
         "max_abs_err": trav["max_abs_err"], "ms": trav["kernel_ms"],
         "plain_ms": trav["plain_ms"], "bound_ms": trav["bound_ms"],
         "bound_by": trav["bound_by"], "library_ms": None},
        lut_entry("lut", 376),
        lut_entry("lut4", 674),
        {"name": "hist_int", "route": "cuda",
         "source": "ddt_tpu_torch/csrc/hist.cu",
         "replaces": "ddt_tpu/ops/hist_pallas.py:175",
         "launches": train_q["launches"]["hist_int"],
         "max_abs_err": hist_int["max_abs_err"],
         "ms": hist_int["int8"]["kernel_ms"],
         "plain_ms": hist_int["int8"]["plain_ms"],
         "bound_ms": hist_int["int8"]["bound_ms"],
         "bound_by": hist_int["int8"]["bound_by"],
         "library_ms": hist_int["int8"]["library_ms"]},
        {"name": "hist_int_t", "route": "cuda",
         "source": "ddt_tpu_torch/csrc/hist.cu",
         "replaces": "ddt_tpu/ops/hist_pallas.py:214",
         "launches": parity_q["launches"]["hist_int"],
         "max_abs_err": hist_int["max_abs_err"], "ms": k2["kernel_ms"],
         "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": k2["library_ms"]},
    ]})
    emit({"phase": "done", "wall_s": time.perf_counter() - t_start})
    print(card["smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card["name"],
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
