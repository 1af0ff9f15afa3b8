"""M0: pure-NumPy reference GBDT trainer — the correctness oracle (port of
ddt_tpu/reference/numpy_trainer.py, copied; its bf16 rounding is done in
NumPy here, `_bf16`, where the reference uses ml_dtypes, which ships with
JAX: the trees are the reference's bit for bit).

SURVEY.md §7 step 1: an exact histogram-algorithm GBDT on one host. Every other
backend (TPU XLA, Pallas, C++ CPU kernels) must reproduce this trainer's split
decisions on small data; SURVEY.md §4 names this "the real correctness anchor".
It doubles as the CPU-reference implementation whose histogram throughput
instantiates the >=5x BASELINE target (BASELINE.md).

Algorithm (classic histogram GBDT, level-wise, complete heap trees):
  for each boosting round:
    g, h = loss.grad_hess(pred, y)
    for depth d in 0..max_depth-1:
      hist[node, feature, bin] = sum of (g, h) via np.add.at   <- HOT LOOP
      cumsum over bins -> left/right aggregates -> gain; argmax (feature, bin)
      split or freeze each level node; reroute rows (node-id vector update)
    leaf values = -G/(H+lambda); pred += lr * leaf_value[leaf of row]

All accumulations are float32 to match device numerics (accumulation order may
still differ; tests use small data where argmax ties are improbable).
"""

from __future__ import annotations

import numpy as np

from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.data.quantizer import BinMapper
from ddt_tpu_torch.models.tree import TreeEnsemble, empty_ensemble


def _bf16(x: np.ndarray) -> np.ndarray:
    """f32 values rounded to bfloat16 (nearest, ties to even), as f32:
    the deterministic tie-break's rounding (ml_dtypes' astype(bfloat16),
    NaN kept)."""
    x = np.ascontiguousarray(x, np.float32)
    u = x.view(np.uint32).astype(np.uint64)
    r = ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)
    return np.where(np.isnan(x), x, r.view(np.float32))


# --------------------------------------------------------------------------- #
# Losses (NumPy twins of ops/grad.py — keep formulas in sync)
# --------------------------------------------------------------------------- #

def base_score(y: np.ndarray, loss: str, n_classes: int = 2,
               sample_weight: np.ndarray | None = None) -> float:
    """Raw-score init; the weighted mean when sample_weight is given
    (weights scale each row's contribution to the loss, so the optimal
    constant shifts with them)."""
    mean = (
        float(np.mean(y)) if sample_weight is None
        else float(np.average(y, weights=sample_weight))
    )
    if loss == "logloss":
        p = float(np.clip(mean, 1e-6, 1 - 1e-6))
        return float(np.log(p / (1 - p)))
    if loss == "mse":
        return mean
    return 0.0  # softmax: symmetric zero init per class


def grad_hess(
    pred_raw: np.ndarray, y: np.ndarray, loss: str
) -> tuple[np.ndarray, np.ndarray]:
    """Gradient/hessian of the loss wrt raw scores. float32 [R] or [R, C]."""
    if loss == "logloss":
        p = 1.0 / (1.0 + np.exp(-pred_raw.astype(np.float64)))
        g = (p - y).astype(np.float32)
        h = (p * (1.0 - p)).astype(np.float32)
        return g, h
    if loss == "mse":
        return (pred_raw - y).astype(np.float32), np.ones_like(y, np.float32)
    if loss == "softmax":
        z = pred_raw - pred_raw.max(axis=1, keepdims=True)
        e = np.exp(z.astype(np.float64))
        p = e / e.sum(axis=1, keepdims=True)
        onehot = np.zeros_like(p)
        onehot[np.arange(y.shape[0]), y.astype(np.int64)] = 1.0
        g = (p - onehot).astype(np.float32)
        h = (p * (1.0 - p)).astype(np.float32)
        return g, h
    raise ValueError(loss)


# --------------------------------------------------------------------------- #
# Kernels (NumPy reference of L3 in SURVEY.md §1)
# --------------------------------------------------------------------------- #

def build_histograms(
    Xb: np.ndarray,        # uint8 [R, F]
    g: np.ndarray,         # float32 [R]
    h: np.ndarray,         # float32 [R]
    node_index: np.ndarray,  # int32 [R]; level-local node in [0, n_nodes) or -1
    n_nodes: int,
    n_bins: int,
) -> np.ndarray:
    """Reference HistogramBuilder: float32 [n_nodes, F, n_bins, 2] (g, h sums).

    Rows with node_index < 0 (frozen at an earlier-level leaf) contribute
    nothing. This signature is the L4 kernel contract every backend implements.
    """
    R, F = Xb.shape
    hist = np.zeros((n_nodes, F, n_bins, 2), dtype=np.float32)
    active = node_index >= 0
    idx_n = node_index[active]
    ga = g[active]
    ha = h[active]
    Xa = Xb[active]
    for f in range(F):
        bins_f = Xa[:, f].astype(np.int64)
        np.add.at(hist, (idx_n, f, bins_f, 0), ga)
        np.add.at(hist, (idx_n, f, bins_f, 1), ha)
    return hist


def best_splits(
    hist: np.ndarray,          # [n_nodes, F, B, 2]
    reg_lambda: float,
    min_child_weight: float,
    feature_mask: np.ndarray | None = None,   # bool [F]; False = excluded
    missing_bin: bool = False,
    cat_mask: np.ndarray | None = None,       # bool [F]; True = categorical
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Reference SplitGain: per-node best
    (gain, feature, threshold_bin, default_left).

    gain = 0.5*(GL^2/(HL+l) + GR^2/(HR+l) - G^2/(H+l)), maximised over the
    flattened (direction, feature, bin) axis; first-occurrence argmax
    (matches jnp.argmax) so all backends agree on tie-breaks. Splitting at
    bin b sends bins <= b left; the last bin is excluded (empty right
    child).

    With missing_bin=True the top bin B-1 holds NaN rows and both default
    directions are scored per (feature, bin): RIGHT keeps the missing mass
    with the right child (the plain cumsum), LEFT moves it left. Candidate
    bins are the VALUE bins 0..B-2 (t = B-2 under direction RIGHT is the
    "missing vs everything" split). Direction RIGHT occupies the first
    flattened block, so nodes with zero missing mass — where both
    directions tie exactly — deterministically report default_left=False,
    matching the missing_bin=False semantics.

    `cat_mask` marks CATEGORICAL features: their candidates are
    one-vs-rest splits ("bin == k goes LEFT", every bin a candidate,
    one-hot gain Gk^2/(Hk+l) + (G-Gk)^2/(H-Hk+l) - parent) replacing the
    ordinal cumsum gains in the same (feature, bin) argmax grid — the
    chosen bin is the matched category k. Under missing_bin they compete
    only in the direction-RIGHT block (categorical columns are
    integer-coded and never NaN).
    """
    n_nodes, F, B, _ = hist.shape
    GL = np.cumsum(hist[..., 0], axis=2)       # [n, F, B]
    HL = np.cumsum(hist[..., 1], axis=2)
    # PER-FEATURE totals (every feature sums the same rows, so these agree
    # up to f32 add order). Using feature f's own total makes the
    # complement side EXACTLY zero for degenerate candidates (e.g. all of a
    # node's rows missing on f: the all-left variant gets HR = 0, not
    # cross-feature float noise that can straddle min_child_weight
    # differently per partition count). Twins: ops/split.py, C++
    # split_gain.cpp — keep the same totals convention in all three.
    G = GL[:, :, -1][:, :, None]               # [n, F, 1]
    H = HL[:, :, -1][:, :, None]

    def gain_of(GLd, HLd):
        GR = G - GLd
        HR = H - HLd
        with np.errstate(divide="ignore", invalid="ignore"):
            parent = np.square(G) / (H + reg_lambda)
            gain = 0.5 * (
                np.square(GLd) / (HLd + reg_lambda)
                + np.square(GR) / (HR + reg_lambda)
                - parent
            )
        valid = (HLd >= min_child_weight) & (HR >= min_child_weight)
        valid &= ~np.isnan(gain)   # 0/0 when reg_lambda == 0
        if feature_mask is not None:
            valid = valid & feature_mask[None, :, None]
        return gain, valid

    def overlay_cat(gain, valid):
        """Replace cat features' ordinal gains with one-vs-rest gains
        (left child = exactly bin k, so GL_k is the per-bin sum itself;
        every bin including the last is a candidate)."""
        if cat_mask is None or not cat_mask.any():
            return gain, valid
        gc, vc = gain_of(hist[..., 0], hist[..., 1])
        m = cat_mask[None, :, None]
        return np.where(m, gc, gain), np.where(m, vc, valid)

    if not missing_bin:
        gain, valid = gain_of(GL, HL)
        valid[:, :, B - 1] = False             # cannot split on last bin
        gain, valid = overlay_cat(gain, valid)
        # Deterministic selection (see ops/split.py): bf16-rounded gains
        # turn float-noise near-ties into exact ties with a shared
        # first-index tie-break, so CPU/TPU/any-partition-count all pick
        # identical splits.
        g16 = _bf16(np.where(valid, gain, -np.inf))
        flat = g16.reshape(n_nodes, F * B)
        best = np.argmax(flat, axis=1)
        best_gain = flat[np.arange(n_nodes), best].astype(np.float32)
        return (best_gain, (best // B).astype(np.int32),
                (best % B).astype(np.int32), np.zeros(n_nodes, bool))

    miss_g = hist[:, :, B - 1, 0][..., None]   # [n, F, 1]
    miss_h = hist[:, :, B - 1, 1][..., None]
    gain_r, valid_r = gain_of(GL, HL)               # missing stays RIGHT
    gain_l, valid_l = gain_of(GL + miss_g, HL + miss_h)   # missing LEFT
    valid_r[:, :, B - 1] = False               # the NaN bin itself: no split
    valid_l[:, :, B - 1] = False
    # t = B-2 under LEFT puts every row left -> empty right child; the
    # HR >= min_child_weight guard already rejects it for mcw > 0, but the
    # rule must not depend on the knob:
    valid_l[:, :, B - 2] = False
    gain_r, valid_r = overlay_cat(gain_r, valid_r)
    if cat_mask is not None:
        valid_l &= ~cat_mask[None, :, None]    # cat: RIGHT block only
    g16 = _bf16(np.concatenate(
        [np.where(valid_r, gain_r, -np.inf),
         np.where(valid_l, gain_l, -np.inf)], axis=1,
    ))                                         # [n, 2F, B]: RIGHT block first
    flat = g16.reshape(n_nodes, 2 * F * B)
    best = np.argmax(flat, axis=1)
    best_gain = flat[np.arange(n_nodes), best].astype(np.float32)
    default_left = best >= F * B
    fb = best % (F * B)
    return (best_gain, (fb // B).astype(np.int32),
            (fb % B).astype(np.int32), default_left)


def node_totals(hist: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(G, H) per node from a histogram (sums over bins of feature 0)."""
    return hist[:, 0, :, 0].sum(axis=1), hist[:, 0, :, 1].sum(axis=1)


# --------------------------------------------------------------------------- #
# Tree growth + boosting (L5 Driver loop, reference edition)
# --------------------------------------------------------------------------- #

def grow_tree(
    Xb: np.ndarray,
    g: np.ndarray,
    h: np.ndarray,
    cfg: TrainConfig,
    hist_fn=None,
    feature_mask: np.ndarray | None = None,
    split_full_fn=None,
) -> dict:
    """Grow one complete-heap tree. Returns dict of node arrays [n_nodes_total].

    hist_fn/split_full_fn inject alternate L3 kernels with the same
    contract (CPUDevice passes the native C++ ones — bit-parity
    guaranteed); defaults are the NumPy oracle kernels in this module.
    split_full_fn carries the full best_splits contract:
    (hist, feature_mask, missing_bin, cat_mask) -> 4-tuple.
    """
    R, F = Xb.shape
    N = cfg.n_nodes_total
    missing = cfg.missing_policy == "learn"
    cat_mask = None
    if cfg.cat_features:
        cat_mask = np.zeros(F, bool)
        cat_mask[list(cfg.cat_features)] = True
    feature = np.full(N, -1, np.int32)
    threshold_bin = np.zeros(N, np.int32)
    is_leaf = np.zeros(N, bool)
    leaf_value = np.zeros(N, np.float32)
    split_gain = np.zeros(N, np.float32)
    default_left = np.zeros(N, bool)

    node_id = np.zeros(R, np.int64)    # heap index per row
    frozen = np.zeros(R, bool)         # row reached an early leaf

    for depth in range(cfg.max_depth):
        offset = (1 << depth) - 1
        n_level = 1 << depth
        node_index = np.where(frozen, -1, node_id - offset).astype(np.int32)
        if hist_fn is not None:
            hist = hist_fn(Xb, g, h, node_index, n_level)
        else:
            hist = build_histograms(Xb, g, h, node_index, n_level, cfg.n_bins)
        G, H = node_totals(hist)
        if split_full_fn is not None:
            gains, feats, bins, dls = split_full_fn(
                hist, feature_mask, missing, cat_mask)
        else:
            gains, feats, bins, dls = best_splits(
                hist, cfg.reg_lambda, cfg.min_child_weight, feature_mask,
                missing_bin=missing, cat_mask=cat_mask,
            )
        # Guarded like the final level and the streamed twin: an EMPTY
        # node at reg_lambda=0 would otherwise store -0/0 = NaN as its
        # leaf value, which a predict-time row (different data) can reach.
        with np.errstate(divide="ignore", invalid="ignore"):
            value = np.where(H > 0, -G / (H + cfg.reg_lambda), 0.0)

        do_split = (gains > cfg.min_split_gain) & np.isfinite(gains) & (H > 0)
        for i in range(n_level):
            node = offset + i
            if do_split[i]:
                feature[node] = feats[i]
                threshold_bin[node] = bins[i]
                split_gain[node] = gains[i]
                default_left[node] = dls[i]
            else:
                is_leaf[node] = True
                leaf_value[node] = value[i]

        # Reroute active rows through new splits; freeze rows at new leaves.
        active = ~frozen
        idx = (node_id - offset)[active]
        split_here = do_split[idx]
        feat_r = feats[idx]
        bin_r = bins[idx]
        fv = Xb[active, feat_r].astype(np.int32)
        go_right = fv > bin_r
        if cat_mask is not None:
            # Categorical one-vs-rest: the matched category goes LEFT.
            go_right = np.where(cat_mask[feat_r], fv != bin_r, go_right)
        if missing:
            # NaN rows (top bin) follow the learned default direction.
            is_miss = fv == cfg.n_bins - 1
            go_right = np.where(is_miss, ~dls[idx], go_right)
        new_ids = np.where(
            split_here,
            2 * node_id[active] + 1 + go_right,
            node_id[active],
        )
        node_id[active] = new_ids
        newly_frozen = np.zeros(R, bool)
        newly_frozen[active] = ~split_here
        frozen |= newly_frozen

    # Final-level leaves: value from G/H aggregated per terminal node. All
    # last-level slots are marked leaves even when unreachable (no active
    # rows) — unreachable slots become inert zero-value leaves, identical to
    # ops/grow.py's device semantics (backend-parity contract).
    active = ~frozen
    offset = (1 << cfg.max_depth) - 1
    idx = node_id[active] - offset
    n_last = 1 << cfg.max_depth
    Gl = np.zeros(n_last, np.float32)
    Hl = np.zeros(n_last, np.float32)
    np.add.at(Gl, idx, g[active])
    np.add.at(Hl, idx, h[active])
    with np.errstate(divide="ignore", invalid="ignore"):
        vals = -Gl / (Hl + cfg.reg_lambda)
    leaf_ids = offset + np.arange(n_last)
    is_leaf[leaf_ids] = True
    leaf_value[leaf_ids] = np.where(Hl > 0, vals, 0.0)

    return {
        "feature": feature,
        "threshold_bin": threshold_bin,
        "is_leaf": is_leaf,
        "leaf_value": leaf_value,
        "split_gain": split_gain,
        "default_left": default_left,
        "leaf_of_row": node_id.astype(np.int64),
    }


def fit(
    Xb: np.ndarray,
    y: np.ndarray,
    cfg: TrainConfig,
    mapper: BinMapper | None = None,
) -> TreeEnsemble:
    """Train a GBDT on binned data. The oracle for all backends."""
    R, F = Xb.shape
    if Xb.dtype != np.uint8:
        raise TypeError(f"Xb must be uint8 binned data, got {Xb.dtype}")
    if R and int(Xb.max()) >= cfg.n_bins:
        raise ValueError(
            f"Xb contains bin {int(Xb.max())} but cfg.n_bins={cfg.n_bins}; "
            "quantize with the same n_bins as the TrainConfig."
        )
    y = np.asarray(y)
    if cfg.cat_features and cfg.cat_features[-1] >= F:
        raise ValueError(
            f"cat_features index {cfg.cat_features[-1]} out of range "
            f"for {F} features"
        )
    C = cfg.n_classes if cfg.loss == "softmax" else 1
    bs = base_score(y, cfg.loss, cfg.n_classes)
    n_trees_total = cfg.n_trees * C
    ens = empty_ensemble(
        n_trees_total, cfg.max_depth, F, cfg.learning_rate, bs,
        cfg.loss, cfg.n_classes,
        missing_bin=cfg.missing_policy == "learn", n_bins=cfg.n_bins,
        cat_features=cfg.cat_features,
    )

    if cfg.loss == "softmax":
        pred = np.zeros((R, C), np.float32)
    else:
        pred = np.full(R, bs, np.float32)

    t_out = 0
    for _round in range(cfg.n_trees):
        g, h = grad_hess(pred, y, cfg.loss)
        for c in range(C):
            gc = g[:, c] if C > 1 else g
            hc = h[:, c] if C > 1 else h
            tree = grow_tree(Xb, gc, hc, cfg)
            ens.feature[t_out] = tree["feature"]
            ens.threshold_bin[t_out] = tree["threshold_bin"]
            ens.is_leaf[t_out] = tree["is_leaf"]
            ens.leaf_value[t_out] = tree["leaf_value"]
            ens.split_gain[t_out] = tree["split_gain"]
            ens.default_left[t_out] = tree["default_left"]
            delta = cfg.learning_rate * tree["leaf_value"][tree["leaf_of_row"]]
            if C > 1:
                pred[:, c] += delta
            else:
                pred += delta
            t_out += 1

    if mapper is not None:
        _fill_raw_thresholds(ens, mapper)
    return ens


def _fill_raw_thresholds(ens: TreeEnsemble, mapper: BinMapper) -> None:
    T, N = ens.feature.shape
    for t in range(T):
        for n in range(N):
            f = ens.feature[t, n]
            if f >= 0:
                ens.threshold_raw[t, n] = mapper.threshold_value(
                    int(f), int(ens.threshold_bin[t, n])
                )
    ens.has_raw_thresholds = True
