"""Deterministic synthetic datasets (port of ddt_tpu/data/datasets.py's
`_rng`, `synthetic_binary`, `synthetic_multiclass`, `synthetic_ctr` and
`stress_binned_chunk`; numpy, identical output for a seed),
`synthetic_missing`, the Higgs
shape with NaN injected where missingness carries label signal (the
recipe of the reference's tests/test_missing.py::_nan_data), and
`load_file` (.npz, numeric .csv[.gz] and libsvm files; data/chunks.
shard_file reads through it)."""

from __future__ import annotations

import gzip
import os

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


def synthetic_regression(
    n_rows: int, n_features: int = 16, seed: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Regression task: a linear term, a square and an interaction."""
    rng = _rng(seed, 4)
    X = rng.standard_normal((n_rows, n_features), dtype=np.float32)
    y = (
        2.0 * X[:, 0]
        + np.square(X[:, 1])
        + X[:, 2] * (X[:, 3] > 0)
        + 0.1 * rng.standard_normal(n_rows, dtype=np.float32)
    ).astype(np.float32)
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


def _open_maybe_gzip(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def _looks_integer_labels(col: np.ndarray) -> bool:
    """Small-cardinality integer-valued column => plausible label column."""
    if not np.all(np.isfinite(col)):
        return False
    r = np.round(col)
    return bool(np.all(np.abs(col - r) < 1e-6) and np.unique(r).size <= 64)

def _split_label(M: np.ndarray, label_col: str) -> tuple[np.ndarray, np.ndarray]:
    if M.ndim != 2 or M.shape[1] < 2:
        raise ValueError(f"tabular file must be 2-D with >=2 columns, "
                         f"got shape {M.shape}")
    if label_col == "first":
        y, X = M[:, 0], M[:, 1:]
    elif label_col == "last":
        y, X = M[:, -1], M[:, :-1]
    elif label_col == "auto":
        # Pick the side that looks like a small-cardinality integer label;
        # ties go to FIRST (the UCI Higgs convention this repo's primary
        # config uses). When NEITHER side qualifies (e.g. a float
        # regression target), auto refuses rather than silently training
        # on a feature column — the caller must say first/last.
        first_ok = _looks_integer_labels(M[:, 0])
        last_ok = _looks_integer_labels(M[:, -1])
        if not first_ok and not last_ok:
            raise ValueError(
                "label_col='auto' could not identify a label column "
                "(neither the first nor the last column is a small-"
                "cardinality integer column — float regression targets "
                "are indistinguishable from features); pass "
                "label_col='first' or 'last' (--label-col in the CLI)"
            )
        if first_ok:
            y, X = M[:, 0], M[:, 1:]
        else:
            y, X = M[:, -1], M[:, :-1]
    else:
        raise ValueError(f"label_col must be first|last|auto, got {label_col!r}")
    return X, y


def _finalize_xy(
    X: np.ndarray, y: np.ndarray, normalize_labels: bool
) -> tuple[np.ndarray, np.ndarray]:
    X = np.ascontiguousarray(X, dtype=np.float32)
    y = np.asarray(y)
    if y.ndim != 1 or len(y) != len(X):
        raise ValueError(f"y must be 1-D with len(X)={len(X)}, got {y.shape}")
    if not np.all(np.isfinite(y.astype(np.float64))):
        raise ValueError("labels contain NaN/inf")
    r = np.round(y.astype(np.float64))
    if np.all(np.abs(y.astype(np.float64) - r) < 1e-9):
        yi = r.astype(np.int64)
        if normalize_labels:
            u = np.unique(yi)
            # External classification conventions -> 0-based class ids:
            # libsvm's binary -1/+1, and EXACTLY-1..k sets (Covertype's
            # 1..7). The contiguity + size>=2 requirement keeps a slice
            # that merely lacks some class (e.g. all-positive {1}) from
            # being silently relabeled. Inherently ambiguous cases (a
            # 0-based file where class 0 never occurs looks like 1..k)
            # have the normalize_labels=False escape hatch.
            if u.size == 2 and u[0] == -1 and u[1] == 1:
                yi = (yi > 0).astype(np.int64)
            elif (2 <= u.size <= 64 and u[0] == 1
                  and u[-1] == u.size
                  and np.array_equal(u, np.arange(1, u.size + 1))):
                yi = yi - 1
        if np.abs(yi).max() < 2 ** 31:
            return X, yi.astype(np.int32)
        return X, y.astype(np.float32)
    return X, y.astype(np.float32)


# Densified-libsvm guardrail: refuse rows x max_index allocations past this
# many float32s (~1 GiB) — hash-indexed CTR files (max index ~2^20+) must go
# through a sparse/streaming pipeline, not this dense loader.
_LIBSVM_DENSE_MAX_ELEMS = 1 << 28


def _is_libsvm_data_line(data: str) -> bool:
    """Structurally a libsvm data line: float label + idx:val tokens. A CSV
    header merely CONTAINING ':' (e.g. 'ts:utc,label,f1') fails this."""
    parts = data.split()
    if len(parts) < 2:
        return False
    try:
        float(parts[0])
        for tok in parts[1:]:
            i, v = tok.split(":", 1)
            int(i)
            float(v)
        return True
    except ValueError:
        return False


def _load_libsvm(
    path: str, n_features: int | None = None, max_rows: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    labels: list[float] = []
    rows: list[list[tuple[int, float]]] = []
    max_idx = 0
    with _open_maybe_gzip(path) as f:
        for ln, line in enumerate(f, 1):
            if max_rows is not None and len(rows) >= max_rows:
                break
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            try:
                labels.append(float(parts[0]))
                feats = []
                for tok in parts[1:]:
                    i, v = tok.split(":", 1)
                    i = int(i)
                    if i < 1:
                        raise ValueError("libsvm indices are 1-based")
                    feats.append((i, float(v)))
                    max_idx = max(max_idx, i)
                rows.append(feats)
            except (ValueError, IndexError) as e:
                raise ValueError(f"{path}:{ln}: bad libsvm line: {e}") from e
    if n_features is not None:
        if max_idx > n_features:
            raise ValueError(
                f"{path}: feature index {max_idx} exceeds n_features="
                f"{n_features}"
            )
        max_idx = n_features   # pin width: sparse tails must not shrink X
    if len(rows) * max_idx > _LIBSVM_DENSE_MAX_ELEMS:
        raise ValueError(
            f"{path}: densifying {len(rows)} x {max_idx} would allocate "
            f">{_LIBSVM_DENSE_MAX_ELEMS * 4 >> 30} GiB; this loader is "
            "dense-only — pass max_rows to trim, or preprocess hash-indexed "
            "sparse data (e.g. via data.categorical.hash_bin_categoricals) "
            "instead of widening it"
        )
    X = np.zeros((len(rows), max_idx), dtype=np.float32)
    for r, feats in enumerate(rows):
        for i, v in feats:
            X[r, i - 1] = v
    return X, np.asarray(labels)


def load_file(
    path: str,
    label_col: str = "auto",
    max_rows: int | None = None,
    normalize_labels: bool | None = None,
    n_features: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Load (X float32 [R,F], y [R]) from an on-disk dataset file.

    Supported: .npz with arrays X and y; .csv[.gz] numeric tables (label
    column picked by `label_col`: first|last|auto — pass label_col="last"
    for regression CSVs whose float target auto cannot detect); libsvm
    sparse text (sniffed by ':' tokens regardless of extension).

    `normalize_labels` maps external CLASSIFICATION label conventions to
    0-based class ids ({-1,+1} -> {0,1}; 1-based sets like Covertype's 1..7
    shifted down). Default: True for text formats (which carry those
    conventions), False for .npz (our own format — y is taken verbatim).
    Pass False explicitly when loading integer regression targets from
    text.

    `n_features` pins the expected column count (pass the model's
    n_features when loading a scoring set): libsvm files are padded to it
    (a sparse scoring file whose rows never touch the last features must
    not shrink X), and any wider/mismatched file raises. Raises ValueError
    on schema problems instead of training on garbage.
    """
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    base = path[:-3] if path.endswith(".gz") else path
    ext = os.path.splitext(base)[1].lower()
    if ext == ".npz":
        with np.load(path) as d:
            if "X" not in d or "y" not in d:
                raise ValueError(
                    f"{path}: .npz must contain arrays 'X' and 'y' "
                    f"(has {sorted(d.files)})"
                )
            X, y = d["X"], d["y"]
        if max_rows:
            X, y = X[:max_rows], y[:max_rows]
        if n_features is not None and X.shape[1] != n_features:
            raise ValueError(
                f"{path}: expected {n_features} feature columns, "
                f"got {X.shape[1]}"
            )
        return _finalize_xy(X, y, normalize_labels or False)
    if normalize_labels is None:
        normalize_labels = True
    # Text: find the first line that is DATA (a non-parsing first line is a
    # CSV header — skipped, and never used for format sniffing, so header
    # names containing ':' can't misroute a CSV to the libsvm parser).
    # `skip` counts PHYSICAL lines consumed before the first data line —
    # np.loadtxt's skiprows is physical, so blank/comment-only lines ahead
    # of a header must be counted too, not just the header itself.
    with _open_maybe_gzip(path) as f:
        first = ""
        skip = 0
        n_headers = 0
        for line in f:
            data = line.split("#", 1)[0]
            if not data.strip():
                skip += 1              # blank or comment-only line
                continue
            try:
                [float(t) for t in data.replace(",", " ").split()]
                first = data
                break
            except ValueError:
                if _is_libsvm_data_line(data):
                    first = data
                    break
                skip += 1              # header line
                n_headers += 1
                if n_headers > 1:
                    raise ValueError(
                        f"{path}: not a numeric CSV (two non-parsing "
                        "leading lines) and not libsvm format"
                    ) from None
    if _is_libsvm_data_line(first) or ext in (".libsvm", ".svm"):
        return _finalize_xy(
            *_load_libsvm(path, n_features=n_features, max_rows=max_rows),
            normalize_labels,
        )
    # CSV: `skip` header rows were detected above. The native C++ parser
    # (native/csv_loader.cpp, OpenMP-parallel over rows) parses the same
    # np.loadtxt subset (bitwise, tests/test_torch_native.py); np.loadtxt
    # is the path where the library does not build.
    M = None
    from ddt_tpu_torch import native

    if native.available():
        # File I/O errors (missing file, permissions, bad gzip) surface
        # here, not after a loadtxt re-read.
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rb") as f:
            M = native.csv_parse_native(f.read(), skip_rows=skip,
                                        max_rows=max_rows)
    if M is None:
        with _open_maybe_gzip(path) as f:
            M = np.loadtxt(f, delimiter=",", skiprows=skip,
                           max_rows=max_rows, dtype=np.float64)
    if M.ndim == 1:
        M = M[None, :]
    X, y = _split_label(M, label_col)
    if n_features is not None and X.shape[1] != n_features:
        raise ValueError(
            f"{path}: expected {n_features} feature columns, got {X.shape[1]}"
        )
    return _finalize_xy(X, y, normalize_labels)
