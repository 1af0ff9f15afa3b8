"""Public API of the port: train / predict (port of ddt_tpu/api.py's
`train` and `predict`).

Float features are quantized here (data/quantizer) unless `binned=True`;
training runs the Driver against the backend of `cfg.device`; scoring goes
through the backend's device traversal. Both run on the card unless the
caller asks for the CPU (device="cpu").
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ddt_tpu_torch.backends import get_backend
from ddt_tpu_torch.backends.base import DeviceBackend
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.data.quantizer import (BinMapper, feature_bincounts,
                                          fit_bin_mapper)
from ddt_tpu_torch.driver import Driver
from ddt_tpu_torch.models.tree import TreeEnsemble


@dataclasses.dataclass
class TrainResult:
    ensemble: TreeEnsemble
    mapper: BinMapper | None      # None when the caller passed binned data
    cfg: TrainConfig


def fill_raw_thresholds(ens: TreeEnsemble, mapper: BinMapper) -> None:
    """Raw-value thresholds of every split node from the mapper's edges."""
    T, N = ens.feature.shape
    for t in range(T):
        for n in range(N):
            f = ens.feature[t, n]
            if f >= 0:
                ens.threshold_raw[t, n] = mapper.threshold_value(
                    int(f), int(ens.threshold_bin[t, n]))
    ens.has_raw_thresholds = True


def train(
    X: np.ndarray,
    y: np.ndarray,
    cfg: TrainConfig | None = None,
    *,
    binned: bool = False,
    mapper: BinMapper | None = None,
    backend: DeviceBackend | None = None,
    **cfg_overrides,
) -> TrainResult:
    """Train a GBDT. `X` is float features (quantized here) unless
    `binned=True` (uint8 bin indices). `cfg_overrides` are TrainConfig
    fields, e.g. train(X, y, n_trees=50, device="cpu")."""
    if cfg is None:
        cfg = TrainConfig(**cfg_overrides)
    elif cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    if binned:
        Xb = np.asarray(X)
        if Xb.dtype != np.uint8:
            raise TypeError("binned=True requires uint8 bin indices")
    else:
        if mapper is None:
            mapper = fit_bin_mapper(np.asarray(X), n_bins=cfg.n_bins,
                                    seed=cfg.seed)
        elif mapper.missing_bin:
            raise ValueError(
                "a BinMapper with a reserved missing bin needs "
                "missing_policy='learn' training, which is not ported yet")
        Xb = mapper.transform(np.asarray(X))
        mapper.ref_counts = feature_bincounts(Xb, mapper.n_bins)
    be = backend if backend is not None else get_backend(cfg)
    ens = Driver(be, cfg).fit(Xb, np.asarray(y))
    if mapper is not None:
        fill_raw_thresholds(ens, mapper)
    return TrainResult(ensemble=ens, mapper=mapper, cfg=cfg)


def predict_proba_np(raw: np.ndarray, loss: str) -> np.ndarray:
    """Raw margins -> probabilities on host (TreeEnsemble.predict's
    formulas)."""
    if loss == "logloss":
        return 1.0 / (1.0 + np.exp(-raw))
    if loss == "softmax":
        z = raw - raw.max(axis=1, keepdims=True)
        e = np.exp(z)
        return e / e.sum(axis=1, keepdims=True)
    return raw


def predict(
    ens: TreeEnsemble,
    X: np.ndarray,
    *,
    binned: bool = False,
    mapper: BinMapper | None = None,
    raw: bool = False,
    backend: DeviceBackend | None = None,
    device: str = "cuda",
) -> np.ndarray:
    """Score a batch on the device: float X is binned with `mapper` first
    (uint8 bins with binned=True). Returns probabilities (raw margins with
    raw=True); the backend of `device` scores unless `backend` is given."""
    X = np.asarray(X)
    if not binned:
        if mapper is None:
            raise ValueError(
                "predict on raw features needs the training mapper; or "
                "pass binned=True with uint8 bins")
        if mapper.missing_bin != ens.missing_bin:
            raise ValueError(
                f"mapper.missing_bin={mapper.missing_bin} but the ensemble "
                f"was trained with missing_bin={ens.missing_bin}")
        X = mapper.transform(X)
    if X.dtype != np.uint8:
        raise TypeError(f"binned data must be uint8, got {X.dtype}")
    if backend is None:
        backend = get_backend(TrainConfig(device=device))
    out = backend.predict_raw(ens, X)
    return out if raw else predict_proba_np(out, ens.loss)
