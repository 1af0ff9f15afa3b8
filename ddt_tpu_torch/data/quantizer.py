"""Quantile binning: float features -> uint8 bin indices (<= 256 bins).

Port of ddt_tpu/data/quantizer.py (numpy, copied so the port depends on
nothing of the JAX package). Output is bit-identical to the reference's
for the same inputs and seed; BinMapper.save()/load() dicts cross-load
with the reference's.

Bin semantics (shared by every kernel of both packages):
  bin b covers values v with  edges[b-1] < v <= edges[b]   (edges ascending)
  i.e. bin = searchsorted(edges, v, side='left') clipped to [0, n_bins-1].
A split "(feature f, threshold bin t)" routes rows with bin <= t LEFT.
The raw-value threshold equivalent is edges[t] (go left iff v <= edges[t]).

NaN policy: "zero" maps NaN to bin 0; "learn" reserves the TOP bin
(n_bins-1) for NaN (the reference trains a default direction for it; the
port's trainer does not yet, but its mappers and scoring honour the bin).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class BinMapper:
    """Per-feature bin edges + the binned-matrix transform."""

    edges: np.ndarray       # [n_features, n_bins-1] float32, ascending per row
    n_bins: int
    missing_bin: bool = False
    # Columns fitted with identity edges (values are category ids).
    cat_features: tuple = ()
    # Per-feature reference bin histogram of the training matrix: int64
    # [n_features, n_bins] raw counts, attached by api.train after binning
    # (None when never captured).
    ref_counts: "np.ndarray | None" = None

    @property
    def n_features(self) -> int:
        return self.edges.shape[0]

    @property
    def n_value_bins(self) -> int:
        """Bins available to real values (excludes the reserved NaN bin)."""
        return self.n_bins - 1 if self.missing_bin else self.n_bins

    def transform(self, X: np.ndarray) -> np.ndarray:
        """Bin a float matrix [rows, n_features] -> uint8 [rows, n_features]."""
        X = np.asarray(X, dtype=np.float32)
        if X.ndim != 2 or X.shape[1] != self.n_features:
            raise ValueError(
                f"X must be [rows, {self.n_features}], got {X.shape}"
            )
        out = np.empty(X.shape, dtype=np.uint8)
        nv = self.n_value_bins
        for f in range(self.n_features):
            col = X[:, f]
            binned = np.searchsorted(self.edges[f, : nv - 1], col,
                                     side="left")
            np.clip(binned, 0, nv - 1, out=binned)
            # NaN: the reserved top bin under missing_bin, else bin 0.
            # +/-inf fall into the top/bottom value bin via searchsorted.
            binned[np.isnan(col)] = self.n_bins - 1 if self.missing_bin else 0
            out[:, f] = binned.astype(np.uint8)
        return out

    def threshold_value(self, feature: int, threshold_bin: int) -> float:
        """Raw-value threshold for a (feature, bin) split: go left iff v <= it."""
        t = int(threshold_bin)
        if t >= self.n_value_bins - 1:
            return float("inf")  # rightmost value bin: every value goes left
        return float(self.edges[feature, t])

    def save(self) -> dict:
        d = {"edges": self.edges, "n_bins": np.int64(self.n_bins),
             "missing_bin": np.bool_(self.missing_bin),
             "cat_features": np.asarray(self.cat_features, np.int32)}
        if self.ref_counts is not None:
            d["ref_counts"] = np.asarray(self.ref_counts, np.int64)
        return d

    @staticmethod
    def load(d: dict) -> "BinMapper":
        ref = d.get("ref_counts")
        return BinMapper(edges=np.asarray(d["edges"], np.float32),
                         n_bins=int(d["n_bins"]),
                         missing_bin=bool(d.get("missing_bin", False)),
                         cat_features=tuple(
                             int(f) for f in d.get("cat_features", ())),
                         ref_counts=(None if ref is None
                                     else np.asarray(ref, np.int64)))


def feature_bincounts(Xb: np.ndarray, n_bins: int) -> np.ndarray:
    """Per-feature bin histogram of a binned uint8 matrix: [rows, F] ->
    int64 [F, n_bins] counts (one flat bincount over feature-offset codes)."""
    Xb = np.asarray(Xb)
    if Xb.ndim != 2:
        raise ValueError(f"Xb must be [rows, features], got {Xb.shape}")
    n_f = Xb.shape[1]
    flat = (np.arange(n_f, dtype=np.intp)[None, :] * n_bins
            + Xb.astype(np.intp, copy=False)).ravel()
    return np.bincount(flat, minlength=n_f * n_bins).reshape(n_f, n_bins)


def fit_bin_mapper(
    X: np.ndarray,
    n_bins: int = 255,
    max_sample: int = 200_000,
    seed: int = 0,
    missing_policy: str = "zero",
    cat_features: tuple = (),
) -> BinMapper:
    """Fit per-feature quantile bin edges on (a sample of) X.

    Edges are non-decreasing per feature (np.maximum.accumulate). Duplicate
    edge values form runs that searchsorted(side='left') always resolves to
    the first edge of the run, so the corresponding higher bins are never
    assigned. Backends must not assume strictly increasing edges.
    """
    X = np.asarray(X, dtype=np.float32)
    rows, n_features = X.shape
    if rows > max_sample:
        rng = np.random.default_rng(seed)
        idx = rng.choice(rows, size=max_sample, replace=False)
        Xs = X[idx]
    else:
        Xs = X

    missing = missing_policy == "learn"
    if missing and n_bins < 3:
        raise ValueError("missing_policy='learn' needs n_bins >= 3")
    # Under the reserved-NaN-bin policy real values get n_bins-1 bins; the
    # edges array keeps its [n_features, n_bins-1] width (trailing column
    # unused = +inf) so the serialized layout is policy-independent.
    n_val = n_bins - 1 if missing else n_bins
    qs = np.linspace(0.0, 1.0, n_val + 1)[1:-1]   # n_val-1 interior quantiles
    edges = np.full((n_features, n_bins - 1), np.float32(np.inf))
    cat = set(int(f) for f in cat_features)
    for f in range(n_features):
        if f in cat:
            # Categorical column: identity edges map integer v to bin v.
            edges[f, : n_val - 1] = np.arange(n_val - 1, dtype=np.float32)
            continue
        col = Xs[:, f]
        col = col[np.isfinite(col)]
        if col.size == 0:
            edges[f, : n_val - 1] = np.arange(n_val - 1, dtype=np.float32)
            continue
        e = np.quantile(col, qs).astype(np.float32)
        e = np.maximum.accumulate(e)
        edges[f, : n_val - 1] = e
    return BinMapper(edges=edges, n_bins=n_bins, missing_bin=missing,
                     cat_features=tuple(sorted(cat)))


def quantize(
    X: np.ndarray, n_bins: int = 255, max_sample: int = 200_000,
    seed: int = 0, missing_policy: str = "zero",
) -> tuple[np.ndarray, BinMapper]:
    """fit + transform convenience: returns (binned uint8 matrix, mapper)."""
    mapper = fit_bin_mapper(X, n_bins=n_bins, max_sample=max_sample,
                            seed=seed, missing_policy=missing_policy)
    return mapper.transform(X), mapper
