"""Deterministic synthetic datasets (port of ddt_tpu/data/datasets.py's
`_rng` and `synthetic_binary`; numpy, identical output for a seed)."""

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
