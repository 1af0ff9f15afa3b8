"""Plain PyTorch reference of the gradient-boosted trees that the benchmark
judges: bin edges, binning, gradients, level histograms, the split rule,
leaf values, routing and scoring.

It imports nothing of the program under test and takes nothing the
program made: it fits the edges and bins the rows again from the raw
floats, works out the base score, gradients and histograms itself, and
reads the program's trees only to judge them. Margins and gradients are
float32, the precision the configurations state, made by the
elementwise formulas below (so a sound program's are the same numbers);
every sum of them, and the gains and leaf values from the sums, is
float64. Runs on any torch device (the card after a run's window, the
CPU in the tests).

Semantics (the port's documented ones, restated here):
  * edges: per feature, the interior quantiles (np.quantile, linear) of a
    sample of at most `max_sample` rows drawn without replacement by
    np.random.default_rng(seed), cast to float32, made non-decreasing;
    categorical columns get identity edges 0..n_bins-2;
  * bin = searchsorted(edges, v, side='left') clipped to n_bins-1, NaN
    to bin 0; an ordinal split (f, t) sends bin <= t left, a categorical
    one sends bin == t left;
  * gain = 0.5 * (GL^2/(HL+l) + GR^2/(HR+l) - G^2/(H+l)) with each
    feature's own totals, both children's hessian >= min_child_weight,
    the last bin no ordinal candidate; the winner is the first maximal
    candidate of the gains rounded to bfloat16, flattened (feature, bin);
    a node splits when that gain exceeds min_split_gain and it holds
    hessian mass; a leaf's value is -G / (H + l), 0 where H = 0;
  * logloss starts from the log-odds of the mean label (clipped to
    [1e-6, 1 - 1e-6]), softmax from 0, and a round of C trees reads the
    gradients of the margins before it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

F64 = torch.float64
#: Elements of one scatter in the histogram build (bounds its temporaries).
_BLOCK = 1 << 26


def fit_edges(X: np.ndarray, n_bins: int, seed: int,
              cat_features=(), max_sample: int = 200_000) -> np.ndarray:
    """float32 [F, n_bins - 1] bin edges of host float rows X."""
    X = np.asarray(X, dtype=np.float32)
    rows, n_features = X.shape
    if rows > max_sample:
        idx = np.random.default_rng(seed).choice(rows, size=max_sample,
                                                 replace=False)
        Xs = X[idx]
    else:
        Xs = X
    qs = np.linspace(0.0, 1.0, n_bins + 1)[1:-1]
    edges = np.empty((n_features, n_bins - 1), np.float32)
    cat = set(int(f) for f in cat_features)
    for f in range(n_features):
        col = Xs[:, f]
        col = col[np.isfinite(col)]
        if f in cat or col.size == 0:
            edges[f] = np.arange(n_bins - 1, dtype=np.float32)
            continue
        edges[f] = np.maximum.accumulate(
            np.quantile(col, qs).astype(np.float32))
    return edges


def bin_rows(X, edges: np.ndarray, device, block: int = 1 << 20
             ) -> torch.Tensor:
    """uint8 [R, F] bins of float rows X (host numpy or a tensor) on
    `device`, block by block of rows."""
    F = edges.shape[0]
    n_bins = edges.shape[1] + 1
    e = torch.from_numpy(np.ascontiguousarray(edges)).to(device)
    R = X.shape[0]
    out = torch.empty((R, F), dtype=torch.uint8, device=device)
    for lo in range(0, R, block):
        hi = min(R, lo + block)
        xb = torch.as_tensor(X[lo:hi]).to(device=device, dtype=torch.float32)
        xt = xb.t().contiguous()
        b = torch.searchsorted(e, xt, right=False).clamp_(max=n_bins - 1)
        b = torch.where(torch.isnan(xt), torch.zeros_like(b), b)
        out[lo:hi] = b.t().to(torch.uint8)
    return out


def base_score(y: np.ndarray, loss: str) -> float:
    if loss == "softmax":
        return 0.0
    p = float(np.clip(float(np.mean(y)), 1e-6, 1 - 1e-6))
    return float(np.log(p / (1 - p)))


def grad_hess(margin: torch.Tensor, y: torch.Tensor, loss: str):
    """(g, h) in the margins' precision, [R] for logloss (p - y, p(1 - p)
    of p = sigmoid), [R, C] for softmax (p - onehot(y), p(1 - p))."""
    if loss == "logloss":
        p = torch.sigmoid(margin)
        return p - y.to(margin.dtype), p * (1.0 - p)
    p = torch.softmax(margin, dim=1)
    onehot = torch.zeros_like(p)
    onehot[torch.arange(y.shape[0], device=y.device), y.long()] = 1.0
    return p - onehot, p * (1.0 - p)


def mean_loss(margin: torch.Tensor, y: torch.Tensor, loss: str) -> float:
    """The mean of each row's loss (computed in the margins' precision),
    summed in float64."""
    if loss == "logloss":
        per = torch.logaddexp(torch.zeros_like(margin), margin) \
            - margin * y.to(margin.dtype)
    else:
        per = -torch.log_softmax(margin, dim=1).gather(
            1, y.long()[:, None])[:, 0]
    return float(per.to(F64).mean())


@dataclasses.dataclass
class Tree:
    """One tree of the judged model, complete heap layout, host arrays."""
    feature: np.ndarray       # int32 [N], -1 on leaves
    threshold_bin: np.ndarray  # int32 [N]
    is_leaf: np.ndarray       # bool [N]
    leaf_value: np.ndarray    # float32 [N]


def level_hist(Xb: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
               local: torch.Tensor, n_nodes: int, n_bins: int):
    """float64 (G, H) sums [n_nodes, F, n_bins] of the rows whose level
    node `local` is >= 0."""
    R, F = Xb.shape
    act = local >= 0
    rows = act.nonzero()[:, 0]
    loc, ga, ha = local[rows], g[rows], h[rows]
    hg = torch.zeros(n_nodes * F * n_bins, dtype=F64, device=Xb.device)
    hh = torch.zeros_like(hg)
    fb = max(1, min(F, _BLOCK // max(1, rows.numel())))
    for f0 in range(0, F, fb):
        f1 = min(F, f0 + fb)
        feats = torch.arange(f0, f1, device=Xb.device)
        flat = ((loc[:, None] * F + feats[None, :]) * n_bins
                + Xb[rows, f0:f1].long()).reshape(-1)
        w = f1 - f0
        hg.index_add_(0, flat, ga[:, None].expand(-1, w).reshape(-1))
        hh.index_add_(0, flat, ha[:, None].expand(-1, w).reshape(-1))
    shape = (n_nodes, F, n_bins)
    return hg.view(shape), hh.view(shape)


def best_splits(hg, hh, reg_lambda: float, min_child_weight: float,
                cat_mask: torch.Tensor | None):
    """Per node: (gain as bfloat16, feature, bin) of the winning
    candidate, by the rule above."""
    n, F, B = hg.shape
    GL, HL = hg.cumsum(2), hh.cumsum(2)
    G, H = GL[:, :, -1:], HL[:, :, -1:]

    def gain_of(gl, hl):
        gr, hr = G - gl, H - hl
        gain = 0.5 * (gl * gl / (hl + reg_lambda) + gr * gr / (hr + reg_lambda)
                      - G * G / (H + reg_lambda))
        valid = (hl >= min_child_weight) & (hr >= min_child_weight) \
            & ~torch.isnan(gain)
        return gain, valid

    gain, valid = gain_of(GL, HL)
    valid[:, :, B - 1] = False
    if cat_mask is not None and bool(cat_mask.any()):
        gc, vc = gain_of(hg, hh)
        m = cat_mask[None, :, None]
        gain, valid = torch.where(m, gc, gain), torch.where(m, vc, valid)
    g16 = torch.where(valid, gain, torch.full_like(gain, -torch.inf)) \
        .to(torch.float32).to(torch.bfloat16).to(torch.float32) \
        .reshape(n, F * B)
    best = torch.argmax(g16, dim=1)
    return g16.gather(1, best[:, None])[:, 0], best // B, best % B


def go_right(fv: torch.Tensor, thr: torch.Tensor, feat: torch.Tensor,
             cat_mask: torch.Tensor | None) -> torch.Tensor:
    right = fv > thr
    if cat_mask is not None:
        right = torch.where(cat_mask[feat], fv != thr, right)
    return right


@dataclasses.dataclass
class TreeCheck:
    """What the reference found in one tree: split nodes compared and
    how many of them the program decided otherwise; (program, reference)
    value of every leaf that rows reach; each row's leaf; per level, the
    rows of every node (the harness's work counts read them)."""
    nodes: int
    mismatches: int
    leaves: list
    leaf_of_row: torch.Tensor
    level_rows: list


def check_tree(Xb: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
               tree: Tree, *, max_depth: int, n_bins: int,
               reg_lambda: float, min_child_weight: float,
               min_split_gain: float,
               cat_mask: torch.Tensor | None) -> TreeCheck:
    """Grow the reference's view of one program tree from the same rows
    and gradients, level by level, routing the rows as the program's
    splits do (so that one differing split does not hide the rest)."""
    dev = Xb.device
    R = Xb.shape[0]
    g, h = g.to(F64), h.to(F64)
    feat_t = torch.from_numpy(tree.feature.astype(np.int64)).to(dev)
    thr_t = torch.from_numpy(tree.threshold_bin.astype(np.int64)).to(dev)
    node = torch.zeros(R, dtype=torch.int64, device=dev)
    frozen = torch.zeros(R, dtype=torch.bool, device=dev)
    nodes = mismatches = 0
    leaves, level_rows = [], []
    for depth in range(max_depth + 1):
        off, n_level = (1 << depth) - 1, 1 << depth
        local = torch.where(frozen, -1, node - off)
        counts = torch.bincount(local[local >= 0], minlength=n_level)
        level_rows.append(counts.cpu().numpy())
        if depth == max_depth:
            idx = local.clamp(min=0)
            G = torch.zeros(n_level, dtype=F64, device=dev).index_add_(
                0, idx[~frozen], g[~frozen])
            H = torch.zeros_like(G).index_add_(0, idx[~frozen], h[~frozen])
            _leaves(leaves, tree, off, counts, G, H, reg_lambda)
            break
        hg, hh = level_hist(Xb, g, h, local, n_level, n_bins)
        G, H = hg[:, 0].sum(1), hh[:, 0].sum(1)
        gains, feats, bins = best_splits(hg, hh, reg_lambda,
                                         min_child_weight, cat_mask)
        ref_split = (gains > min_split_gain) & torch.isfinite(gains) & (H > 0)
        sl = slice(off, off + n_level)
        prog_split = torch.from_numpy(~tree.is_leaf[sl]).to(dev)
        reached = counts > 0
        differ = (ref_split != prog_split) | (
            ref_split & prog_split & ((feats != feat_t[sl])
                                      | (bins != thr_t[sl])))
        nodes += int(reached.sum())
        mismatches += int((differ & reached).sum())
        leaf_here = ~prog_split & reached
        _leaves(leaves, tree, off, counts, G, H, reg_lambda, leaf_here)
        act = ~frozen
        n_act = node[act]
        f = feat_t[n_act].clamp(min=0)
        fv = Xb[act.nonzero()[:, 0], f].long()
        right = go_right(fv, thr_t[n_act], f, cat_mask)
        split_row = ~torch.from_numpy(tree.is_leaf).to(dev)[n_act]
        node[act] = torch.where(split_row, 2 * n_act + 1 + right, n_act)
        fz = frozen.clone()
        fz[act] = ~split_row
        frozen = fz
    return TreeCheck(nodes, mismatches, leaves, node, level_rows)


def _leaves(out: list, tree: Tree, off: int, counts, G, H, reg_lambda,
            mask=None) -> None:
    ref = torch.where(H > 0, -G / (H + reg_lambda), torch.zeros_like(G))
    keep = counts > 0 if mask is None else mask
    idx = keep.nonzero()[:, 0].cpu().numpy()
    out.extend(zip(tree.leaf_value[off + idx].astype(np.float64).tolist(),
                   ref[keep].cpu().numpy().tolist()))


def leaf_values(tree: Tree, leaf_of_row: torch.Tensor, g: torch.Tensor,
                h: torch.Tensor, reg_lambda: float) -> list:
    """(program, reference) value of every leaf that rows reach, the
    reference's from the sums of its rows' gradients."""
    n = tree.leaf_value.shape[0]
    G = torch.zeros(n, dtype=F64, device=g.device).index_add_(
        0, leaf_of_row, g.to(F64))
    H = torch.zeros_like(G).index_add_(0, leaf_of_row, h.to(F64))
    counts = torch.bincount(leaf_of_row, minlength=n)
    out = []
    _leaves(out, tree, 0, counts, G, H, reg_lambda)
    return out


def leaf_gap(leaves: list) -> float:
    """Worst |program - reference| of (program, reference) leaf values,
    each against the larger of |its reference value| and the median
    |reference value| of all of them."""
    if not leaves:
        return 0.0
    p = np.array([a for a, _ in leaves])
    r = np.array([b for _, b in leaves])
    med = float(np.median(np.abs(r)))
    return float(np.max(np.abs(p - r) / np.maximum(np.abs(r), max(med,
                                                                 1e-300))))


def leaf_index(Xb: torch.Tensor, tree: Tree, max_depth: int,
               cat_mask: torch.Tensor | None) -> torch.Tensor:
    """Each row's leaf (heap index) in one tree, by its bins."""
    dev = Xb.device
    feat = torch.from_numpy(tree.feature.astype(np.int64)).to(dev)
    thr = torch.from_numpy(tree.threshold_bin.astype(np.int64)).to(dev)
    leaf = torch.from_numpy(tree.is_leaf).to(dev)
    rows = torch.arange(Xb.shape[0], device=dev)
    node = torch.zeros(Xb.shape[0], dtype=torch.int64, device=dev)
    for _ in range(max_depth):
        f = feat[node].clamp(min=0)
        right = go_right(Xb[rows, f].long(), thr[node], f, cat_mask)
        node = torch.where(leaf[node], node, 2 * node + 1 + right)
    return node


def level_counts(Xb: torch.Tensor, tree: Tree, max_depth: int,
                 cat_mask: torch.Tensor | None) -> list:
    """Per level 0..max_depth, the rows that reach each of its nodes. The
    levels are counted on the device and read back together, one sync a
    tree."""
    dev = Xb.device
    feat = torch.from_numpy(tree.feature.astype(np.int64)).to(dev)
    thr = torch.from_numpy(tree.threshold_bin.astype(np.int64)).to(dev)
    leaf = torch.from_numpy(tree.is_leaf).to(dev)
    rows = torch.arange(Xb.shape[0], device=dev)
    node = torch.zeros(Xb.shape[0], dtype=torch.int64, device=dev)
    live = torch.ones_like(node, dtype=torch.bool)
    out = []
    for depth in range(max_depth + 1):
        off, n_level = (1 << depth) - 1, 1 << depth
        # Rows stopped above this level land in a last slot, dropped.
        at = torch.where(live, node - off, n_level)
        out.append(torch.bincount(at, minlength=n_level + 1)[:n_level])
        if depth == max_depth:
            break
        f = feat[node].clamp(min=0)
        right = go_right(Xb[rows, f].long(), thr[node], f, cat_mask)
        live = live & ~leaf[node]
        node = torch.where(leaf[node], node, 2 * node + 1 + right)
    flat = torch.cat(out).cpu().numpy()
    return np.split(flat, np.cumsum([c.numel() for c in out])[:-1])


def score_raw(X: torch.Tensor, feature: np.ndarray, threshold_raw: np.ndarray,
              is_leaf: np.ndarray, leaf_value: np.ndarray, *, max_depth: int,
              learning_rate: float, base: float,
              tree_block: int = 64) -> torch.Tensor:
    """float64 margins [S] of float rows X through an ensemble by its raw
    thresholds (value <= threshold goes left), all trees at once in
    blocks of trees."""
    dev = X.device
    S = X.shape[0]
    out = torch.full((S,), base, dtype=F64, device=dev)
    rows = torch.arange(S, device=dev)[None, :]
    for t0 in range(0, feature.shape[0], tree_block):
        sl = slice(t0, t0 + tree_block)
        feat = torch.from_numpy(feature[sl].astype(np.int64)).to(dev)
        thr = torch.from_numpy(threshold_raw[sl].astype(np.float32)).to(dev)
        leaf = torch.from_numpy(is_leaf[sl]).to(dev)
        val = torch.from_numpy(leaf_value[sl].astype(np.float64)).to(dev)
        node = torch.zeros((feat.shape[0], S), dtype=torch.int64, device=dev)
        for _ in range(max_depth):
            f = feat.gather(1, node).clamp(min=0)
            v = X[rows.expand_as(f), f]
            right = v > thr.gather(1, node)
            node = torch.where(leaf.gather(1, node), node,
                               2 * node + 1 + right)
        out += learning_rate * val.gather(1, node).sum(0)
    return out


def leaf_depths(X: torch.Tensor, feature: np.ndarray,
                threshold_raw: np.ndarray, is_leaf: np.ndarray,
                max_depth: int) -> torch.Tensor:
    """int64 [S]: the compares each row makes over all trees (the depth
    of every leaf it reaches, summed)."""
    dev = X.device
    feat = torch.from_numpy(feature.astype(np.int64)).to(dev)
    thr = torch.from_numpy(threshold_raw.astype(np.float32)).to(dev)
    leaf = torch.from_numpy(is_leaf).to(dev)
    S = X.shape[0]
    rows = torch.arange(S, device=dev)[None, :]
    node = torch.zeros((feat.shape[0], S), dtype=torch.int64, device=dev)
    depth = torch.zeros_like(node)
    for _ in range(max_depth):
        at_leaf = leaf.gather(1, node)
        f = feat.gather(1, node).clamp(min=0)
        right = X[rows.expand_as(f), f] > thr.gather(1, node)
        depth += (~at_leaf).long()
        node = torch.where(at_leaf, node, 2 * node + 1 + right)
    return depth.sum(0)
