"""scikit-learn-style estimators over the port's train/predict API.

Port of ddt_tpu/sklearn.py. `DDTClassifier` / `DDTRegressor` wrap binning,
training and scoring in the fit/predict idiom. No sklearn dependency, but
its conventions: the constructor stores hyperparameters verbatim (and
get_params reports them), fit() learns state on `self`, fitted attributes
end in "_". Training and scoring run on the card unless the estimator is
built with device="cpu" (the plain versions). The reference's `backend`
parameter is `device` here. `fit(..., run_log=)` takes a path or a
telemetry RunLog and hands it to api.train, as the reference does: the
run's events, which `cli report` reads.
"""

from __future__ import annotations

import inspect

import numpy as np

from ddt_tpu_torch import api
from ddt_tpu_torch.config import TrainConfig


class _DDTBase:
    _LOSS: str = ""

    def __init__(
        self,
        n_trees: int = 100,
        max_depth: int = 6,
        n_bins: int = 255,
        learning_rate: float = 0.1,
        reg_lambda: float = 1.0,
        min_child_weight: float = 1e-3,
        min_split_gain: float = 0.0,
        subsample: float = 1.0,
        colsample_bytree: float = 1.0,
        device: str = "cuda",
        n_partitions: int = 1,
        seed: int = 0,
        missing_policy: str = "zero",
        cat_features: tuple = (),
    ):
        self.n_trees = n_trees
        self.max_depth = max_depth
        self.n_bins = n_bins
        self.learning_rate = learning_rate
        self.reg_lambda = reg_lambda
        self.min_child_weight = min_child_weight
        self.min_split_gain = min_split_gain
        self.subsample = subsample
        self.colsample_bytree = colsample_bytree
        self.device = device
        self.n_partitions = n_partitions
        self.seed = seed
        self.missing_policy = missing_policy
        self.cat_features = cat_features

    @classmethod
    def _param_names(cls) -> tuple:
        """Constructor argument names, from the signature (sklearn's own
        way), so the list cannot drift from __init__."""
        return tuple(inspect.signature(cls.__init__).parameters)[1:]

    def get_params(self, deep: bool = True) -> dict:
        """Constructor parameters (sklearn's clone / GridSearchCV
        protocol)."""
        return {k: getattr(self, k) for k in self._param_names()}

    def set_params(self, **params):
        names = self._param_names()
        for k, v in params.items():
            if k not in names:
                raise ValueError(
                    f"unknown parameter {k!r}; valid: {names}")
            setattr(self, k, v)
        return self

    def _cfg(self, **extra) -> TrainConfig:
        extra.setdefault("loss", self._LOSS)
        return TrainConfig(
            n_trees=self.n_trees,
            max_depth=self.max_depth,
            n_bins=self.n_bins,
            learning_rate=self.learning_rate,
            reg_lambda=self.reg_lambda,
            min_child_weight=self.min_child_weight,
            min_split_gain=self.min_split_gain,
            subsample=self.subsample,
            colsample_bytree=self.colsample_bytree,
            device=self.device,
            n_partitions=self.n_partitions,
            seed=self.seed,
            missing_policy=self.missing_policy,
            cat_features=tuple(self.cat_features),
            **extra,
        )

    def fit(self, X, y, sample_weight=None, *, eval_set=None,
            eval_metric=None, early_stopping_rounds=None, run_log=None):
        X = np.asarray(X, np.float32)
        y = np.asarray(y)
        cfg = self._cfg(**self._fit_cfg_extra(y))
        if eval_set is not None:
            eval_set = (np.asarray(eval_set[0], np.float32),
                        np.asarray(eval_set[1]))
        # early_stopping_rounds passes through even without an eval_set,
        # so the Driver's "requires an eval_set" error reaches the user.
        res = api.train(X, y, cfg, eval_set=eval_set,
                        eval_metric=eval_metric,
                        early_stopping_rounds=early_stopping_rounds,
                        sample_weight=sample_weight, run_log=run_log)
        self.ensemble_ = res.ensemble
        self.mapper_ = res.mapper
        self.n_features_in_ = X.shape[1]
        self.feature_importances_ = self.ensemble_.feature_importances()
        # sklearn/LightGBM eval attributes (None / {} without an eval_set).
        self.best_iteration_ = res.best_round
        self.best_score_ = res.best_score
        self.evals_result_ = {}
        for rec in res.history:
            for k, v in rec.items():
                if k.startswith("valid_"):
                    self.evals_result_.setdefault(
                        k[len("valid_"):], []).append(v)
        return self

    def _fit_cfg_extra(self, y) -> dict:
        return {}

    def _predict(self, X, raw: bool) -> np.ndarray:
        """Scores on the estimator's device, through the backend the
        device's repeated calls share (its scoring tables cached)."""
        return api.predict(self.ensemble_, np.asarray(X, np.float32),
                           mapper=self.mapper_, raw=raw,
                           device=self.device)


class DDTClassifier(_DDTBase):
    """Gradient-boosted decision-tree classifier (binary or multiclass)."""

    _LOSS = "logloss"

    def _fit_cfg_extra(self, y) -> dict:
        n = len(np.unique(y))
        if n > 2:
            return {"loss": "softmax", "n_classes": n}
        return {}

    def fit(self, X, y, sample_weight=None, *, eval_set=None,
            eval_metric=None, early_stopping_rounds=None, run_log=None):
        y = np.asarray(y)
        classes = np.unique(y)
        if len(classes) < 2:
            # As sklearn: fail at fit, not at predict.
            found = (f"only one class: {classes[0]!r}" if len(classes)
                     else "no samples")
            raise ValueError(
                "This solver needs samples of at least 2 classes in the "
                f"data, but the data contains {found}")
        # Labels -> 0..C-1 for training; predictions map back.
        y_enc = np.searchsorted(classes, y)
        if eval_set is not None:
            yv = np.asarray(eval_set[1])
            unseen = ~np.isin(yv, classes)
            if unseen.any():
                raise ValueError(
                    f"eval_set contains labels not present in y: "
                    f"{np.unique(yv[unseen])!r}")
            eval_set = (eval_set[0], np.searchsorted(classes, yv))
        super().fit(X, y_enc, eval_set=eval_set, eval_metric=eval_metric,
                    early_stopping_rounds=early_stopping_rounds,
                    sample_weight=sample_weight, run_log=run_log)
        self.classes_ = classes
        return self

    def predict_proba(self, X) -> np.ndarray:
        p = self._predict(X, raw=False)
        if p.ndim == 2:            # softmax: already a distribution
            return p
        return np.stack([1.0 - p, p], axis=1)

    def predict(self, X) -> np.ndarray:
        return self.classes_[self.predict_proba(X).argmax(axis=1)]

    def score(self, X, y) -> float:
        """Mean accuracy."""
        return float((self.predict(X) == np.asarray(y)).mean())


class DDTRegressor(_DDTBase):
    """Gradient-boosted decision-tree regressor (squared error)."""

    _LOSS = "mse"

    def predict(self, X) -> np.ndarray:
        return self._predict(X, raw=True)

    def score(self, X, y) -> float:
        """R^2, the coefficient of determination."""
        y = np.asarray(y, np.float64)
        pred = self.predict(X).astype(np.float64)
        ss_res = float(np.square(y - pred).sum())
        ss_tot = float(np.square(y - y.mean()).sum())
        return 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0
