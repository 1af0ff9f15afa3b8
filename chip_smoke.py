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
  then the {"kernels": [...]} line, nvidia-smi's line, and the ok line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from ddt_tpu_torch import _build, api
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.data.datasets import synthetic_binary
from ddt_tpu_torch.data.quantizer import fit_bin_mapper
from ddt_tpu_torch.models.tree import empty_ensemble
from ddt_tpu_torch.ops import hist_cuda, histogram, predict, predict_cuda

ROWS = 1_000_000
FEATURES = 28
DEPTH = 6
N_TREES = 100
PARITY_ROWS = 200_000
PARITY_TREES = 10


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


def phase_hist(X: np.ndarray, card: dict, flush: torch.Tensor) -> dict:
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    R = X.shape[0]
    g = rng.standard_normal(R).astype(np.float32)
    h = (0.25 * rng.random(R)).astype(np.float32)
    gd, hd = torch.from_numpy(g).to(dev), torch.from_numpy(h).to(dev)
    per_n = {}
    max_err = 0.0
    for B, nodes in ((255, (1, 2, 4, 8, 16, 32)), (128, (16, 32)),
                     (64, (16, 32))):
        Xb = fit_bin_mapper(X, n_bins=B).transform(X)
        Xd = torch.from_numpy(Xb).to(dev)
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
    seq = (1, 1, 2, 4, 8, 16)
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
    return {"res": res, "launches": launches}


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
    hist = phase_hist(X, card, flush)
    Xb = fit_bin_mapper(X, n_bins=255).transform(X)
    phase_traverse_exact(Xb)
    main_run = phase_main(X, y)
    trav = phase_traverse_trained(main_run["res"], X, card, flush)
    phase_parity(X, y)
    launches = main_run["launches"]
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
    ]})
    emit({"phase": "done", "wall_s": time.perf_counter() - t_start})
    print(card["smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card["name"],
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
