"""Deterministic synthetic datasets (port of ddt_tpu/data/datasets.py's
`_rng`, `synthetic_binary`, `synthetic_multiclass`, `synthetic_ctr` and
`stress_binned_chunk`; numpy, identical output for a seed), and
`synthetic_missing`, the Higgs
shape with NaN injected where missingness carries label signal (the
recipe of the reference's tests/test_missing.py::_nan_data)."""

from __future__ import annotations

import numpy as np


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, *stream]))


def synthetic_binary(
    n_rows: int, n_features: int = 28, seed: int = 0, noise: float = 1.0
) -> tuple[np.ndarray, np.ndarray]:
    """Higgs-like binary task: 28 continuous features, nonlinear signal.

    The label depends on a few nonlinear feature interactions, so trees of
    depth >= 3 have real signal to find; a good GBDT's AUC lands ~0.8-0.9.
    """
    rng = _rng(seed, 1)
    X = rng.standard_normal((n_rows, n_features), dtype=np.float32)
    score = (
        np.sin(X[:, 0] * 2.0)
        + X[:, 1] * X[:, 2]
        + 0.5 * np.square(X[:, 3])
        - 1.0 * (X[:, 4] > 0.5)
        + noise * rng.standard_normal(n_rows, dtype=np.float32) * 0.5
    )
    y = (score > np.median(score)).astype(np.int32)
    return X, y


def synthetic_multiclass(
    n_rows: int,
    n_features: int = 54,
    n_classes: int = 7,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Covertype-like 7-class task: class-dependent cluster centers + noise."""
    rng = _rng(seed, 2)
    centers = rng.standard_normal((n_classes, n_features),
                                  dtype=np.float32) * 2.0
    y = rng.integers(0, n_classes, size=n_rows).astype(np.int32)
    X = centers[y] + rng.standard_normal((n_rows, n_features),
                                         dtype=np.float32)
    return X, y


def synthetic_ctr(
    n_rows: int,
    n_numeric: int = 13,
    n_categorical: int = 26,
    cardinality: int = 100_000,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Criteo-like CTR task: 13 numeric + 26 high-cardinality categorical
    columns. Returns (X_num float32 [R, 13], X_cat int64 [R, 26], y int32
    [R]). Category ids are Zipf-like (few heavy hitters), and a subset of
    categories carries label signal (~25% positives)."""
    rng = _rng(seed, 3)
    X_num = rng.standard_normal((n_rows, n_numeric), dtype=np.float32)
    u = rng.random((n_rows, n_categorical))
    X_cat = np.floor(cardinality * np.power(u, 3.0)).astype(np.int64)
    signal = (
        0.8 * np.sin((X_cat[:, 0] % 17).astype(np.float32))
        + 0.6 * ((X_cat[:, 1] % 5) == 0)
        + 0.5 * X_num[:, 0]
        + rng.standard_normal(n_rows, dtype=np.float32) * 0.7
    )
    y = (signal > np.quantile(signal, 0.75)).astype(np.int32)
    return X_num, X_cat, y


def synthetic_missing(
    n_rows: int, n_features: int = 8, seed: int = 3, frac: float = 0.25,
    informative: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """synthetic_binary with a `frac` share of the values set to NaN. With
    `informative`, missingness on the first 3 features goes with the
    positive class, so a learned NaN direction beats sending NaN to bin 0
    (there it sits beside the lowest values, mostly negatives)."""
    rng = np.random.default_rng(seed)
    X, y = synthetic_binary(n_rows, n_features=n_features, seed=seed)
    miss = rng.random((n_rows, n_features)) < frac
    if informative:
        for c in range(3):
            miss[:, c] = (rng.random(n_rows) < 0.3 * frac) | (
                (y == 1) & (rng.random(n_rows) < 3 * frac))
    X = X.copy()
    X[miss] = np.nan
    return X, y


def stress_binned_chunk(chunk_start: int, chunk_rows: int,
                        n_features: int = 1024, n_bins: int = 255,
                        seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """BASELINE config 5's generator (10B rows x 1024 features): binned
    uint8 rows [chunk_rows, n_features] uniform over the bins and binary
    labels (bin 0 + bin 1 > n_bins). A pure function of (seed,
    chunk_start), so any chunk can be made anew anywhere."""
    rng = _rng(seed, 5, chunk_start)
    Xb = rng.integers(0, n_bins, size=(chunk_rows, n_features),
                      dtype=np.uint8)
    y = ((Xb[:, 0].astype(np.int32) + Xb[:, 1].astype(np.int32))
         > n_bins).astype(np.int32)
    return Xb, y
