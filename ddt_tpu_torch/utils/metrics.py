"""Evaluation metrics for eval sets and early stopping.

Port of ddt_tpu/utils/metrics.py. Each metric takes (y_true, score) with
`score` the model's raw margins: [R] for binary / regression, [R, C] for
softmax. The host metrics are numpy in float64, copied from the
reference; `GREATER_IS_BETTER` gives early stopping its direction.

`device_metric(name, n_classes)` returns the tensor twin the backend
evaluates on the device every round, (y, raw, valid=None) -> f32 0-dim
tensor, where `valid` weights the rows (None: all ones). The twins read
nothing back to the host and branch on no tensor value, so a captured
boosting round can hold them. Binary auc has a twin in the reference's
binned-rank form: scores min/max-normalised into DEVICE_AUC_BINS bins,
class histograms by index_add_, and the Mann-Whitney U statistic from
the bin counts with average-rank ties (within-bin pairs count 1/2); no
sort. The reference sums U in f32 with Kahan compensation over 256 block
partials; here the sum runs in float64, which is at least as close. There
is no auc for softmax (the host auc is binary), and the Driver refuses it.
"""

from __future__ import annotations

import numpy as np
import torch


def _sigmoid(z: np.ndarray) -> np.ndarray:
    # exp(-z) overflows to inf for strongly negative margins; 1/inf = 0.0
    # is exactly right, so the warning is silenced rather than the formula
    # changed (it must stay TreeEnsemble.predict's).
    with np.errstate(over="ignore"):
        return 1.0 / (1.0 + np.exp(-z))


def _softmax(z: np.ndarray) -> np.ndarray:
    z = z - z.max(axis=1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=1, keepdims=True)


def auc(y_true: np.ndarray, score: np.ndarray) -> float:
    """Binary ROC-AUC via the rank (Mann-Whitney U) formulation, with
    average ranks on ties (sklearn.metrics.roc_auc_score's value)."""
    y = np.asarray(y_true).astype(bool).ravel()
    s = np.asarray(score, np.float64).ravel()
    n_pos = int(y.sum())
    n_neg = y.size - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("AUC needs both classes present")
    order = np.argsort(s, kind="mergesort")
    s_sorted = s[order]
    is_start = np.empty(y.size, bool)
    is_start[0] = True
    np.not_equal(s_sorted[1:], s_sorted[:-1], out=is_start[1:])
    starts = np.flatnonzero(is_start)
    ends = np.concatenate([starts[1:], [y.size]])
    avg_rank = 0.5 * (starts + ends + 1)            # group average rank
    group_id = np.cumsum(is_start) - 1
    ranks = np.empty(y.size, np.float64)
    ranks[order] = avg_rank[group_id]
    u = ranks[y].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def accuracy(y_true: np.ndarray, score: np.ndarray) -> float:
    y = np.asarray(y_true).ravel()
    s = np.asarray(score)
    pred = s.argmax(axis=1) if s.ndim == 2 else (s > 0).astype(y.dtype)
    return float(np.mean(pred == y))


def rmse(y_true: np.ndarray, score: np.ndarray) -> float:
    y = np.asarray(y_true, np.float64).ravel()
    return float(np.sqrt(np.mean((np.asarray(score, np.float64) - y) ** 2)))


def logloss(y_true: np.ndarray, score: np.ndarray) -> float:
    """Binary or multiclass cross-entropy from raw margins."""
    y = np.asarray(y_true).ravel()
    s = np.asarray(score, np.float64)
    eps = 1e-12
    if s.ndim == 2:
        p = np.clip(_softmax(s), eps, 1.0)
        return float(-np.mean(np.log(p[np.arange(y.size), y.astype(int)])))
    p = np.clip(_sigmoid(s), eps, 1 - eps)
    return float(-np.mean(np.where(y > 0.5, np.log(p), np.log1p(-p))))


METRICS = {
    "auc": auc,
    "accuracy": accuracy,
    "rmse": rmse,
    "logloss": logloss,
}

GREATER_IS_BETTER = {
    "auc": True,
    "accuracy": True,
    "rmse": False,
    "logloss": False,
}


def default_metric(loss: str) -> str:
    """The eval-set metric when the caller names none."""
    defaults = {"logloss": "logloss", "softmax": "logloss", "mse": "rmse"}
    try:
        return defaults[loss]
    except KeyError:
        raise ValueError(f"no default metric for loss {loss!r}; have "
                         f"{sorted(defaults)}") from None


def evaluate(name: str, y_true: np.ndarray, raw_score: np.ndarray) -> float:
    try:
        fn = METRICS[name]
    except KeyError:
        raise ValueError(
            f"unknown metric {name!r}; have {sorted(METRICS)}") from None
    return fn(y_true, raw_score)


#: Score bins of the device auc twin. Its only approximation is the
#: within-bin pair mass, ~1/B of the AUC for balanced classes (<= ~2e-5);
#: bin counts stay exact in f32 below 2^24 rows a bin.
DEVICE_AUC_BINS = 1 << 16


def _weights(raw: torch.Tensor, valid: torch.Tensor | None) -> torch.Tensor:
    if valid is None:
        return torch.ones(raw.shape[0], dtype=torch.float32,
                          device=raw.device)
    return valid.to(torch.float32)


def _device_auc(y: torch.Tensor, raw: torch.Tensor,
                valid: torch.Tensor | None = None) -> torch.Tensor:
    """Binned-rank AUC (see the module docstring). Single-class or empty
    data gives NaN (a twin cannot raise on data; the Driver's NaN-eval
    check names the cause), all-equal scores exactly 0.5."""
    if raw.dim() != 1:
        raise ValueError("the device auc twin is binary-only (softmax "
                         "eval sets take logloss or accuracy)")
    B = DEVICE_AUC_BINS
    mf = _weights(raw, valid)
    m = mf > 0
    # A fill on the device, not a host copy (a capture forbids those).
    inf = torch.full((), float("inf"), device=raw.device)
    lo = torch.where(m, raw, inf).min()
    hi = torch.where(m, raw, -inf).max()
    span = hi - lo
    scale = torch.where(span > 0, (B - 1) / span, torch.zeros_like(span))
    idx = torch.round((raw - lo) * scale).to(torch.int64).clamp(0, B - 1)
    yp = (y > 0.5).to(torch.float32)
    pos = torch.zeros(B, dtype=torch.float32, device=raw.device) \
        .index_add_(0, idx, mf * yp)
    neg = torch.zeros(B, dtype=torch.float32, device=raw.device) \
        .index_add_(0, idx, mf * (1.0 - yp))
    cum_neg = torch.cumsum(neg, 0) - neg         # negatives strictly below
    u = (pos.double() * (cum_neg.double() + 0.5 * neg.double())).sum()
    denom = pos.double().sum() * neg.double().sum()
    return torch.where(denom > 0, u / denom,
                       torch.full_like(u, float("nan"))).to(torch.float32)


def device_metric(name: str, n_classes: int = 1):
    """The tensor twin of host metric `name` for on-device eval scoring,
    (y, raw, valid=None) -> f32 0-dim tensor on raw's device; None where
    no twin exists (auc with n_classes > 1)."""
    if name not in METRICS:
        raise ValueError(f"unknown metric {name!r}; have {sorted(METRICS)}")
    if name == "auc":
        return None if n_classes > 1 else _device_auc

    def fn(y, raw, valid=None):
        v = _weights(raw, valid)
        n = v.sum()
        if name == "accuracy":
            if raw.dim() == 2:
                ok = raw.argmax(dim=1) == y.to(torch.int64)
            else:
                ok = (raw > 0) == (y > 0.5)
            return (ok.to(torch.float32) * v).sum() / n
        yf = y.to(torch.float32)
        if name == "rmse":
            d = raw - yf
            return torch.sqrt((d * d * v).sum() / n)
        # logloss, binary sigmoid or multiclass softmax, the host formulas
        # in f32.
        if raw.dim() == 2:
            p = torch.softmax(raw, dim=1)
            py = p.gather(1, y.to(torch.int64)[:, None])[:, 0]
            t = -torch.log(py.clamp(1e-12, 1.0))
        else:
            p = torch.sigmoid(raw).clamp(1e-12, 1.0 - 1e-12)
            t = -torch.where(yf > 0.5, torch.log(p), torch.log1p(-p))
        return (t * v).sum() / n

    return fn
