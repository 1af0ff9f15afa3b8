"""Public API of the port: train / predict / save_model / load_model /
ModelBundle (port of ddt_tpu/api.py's `train`, `predict`, `save_model`,
`load_model`, `ModelBundle` and `validate_mapper_model`).

A saved model is one npz in the reference's layout, byte for byte what
the reference writes for the same model, with its embedded manifest
(registry/manifest.py): either package loads and verifies the other's.
`predict(n_partitions=k)` scores one batch over k cards of this process
(backends.RowShardedScorer).

Float features are binned here unless `binned=True`: the edges are fitted
on the host (data/quantizer.fit_bin_mapper, with the config's missing
policy and categorical columns), then the f32 rows are uploaded once and
binned on the backend's device (ops/quantize), where the binned matrix
stays: training hands it to the Driver (an eval set is binned there with
the training mapper too) and counts the mapper's reference bin histogram
there; scoring hands it to the backend's device traversal, at the tier
cfg.predict_impl names. Both run on the card unless the caller asks for
the CPU (device="cpu").

api.train takes what ddt_tpu.api.train takes for one device: softmax
(loss="softmax", n_classes), missing_policy="learn", cat_features,
sample_weight, eval_set / eval_metric / early_stopping_rounds and
checkpoint_dir / checkpoint_every.

The mesh (cfg.world_size = host_partitions x n_partitions x
feature_partitions > 1): every rank of an initialised torch.distributed
group of that many ranks calls train with the same full X and y, as the
reference's one controller sees all of X. The edges are fitted on the
host from all rows, the same on every rank (a digest of them is
all-gathered over the world and the ranks must agree); each rank then
bins only its block of the padded rows on its device (parallel/mesh.
row_block), at full width, and the backend's upload keeps its column
slab of it; the reference bin counts are summed over the row group (the
ranks of a feature group hold the same rows). Every rank returns the
same ensemble.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from ddt_tpu_torch.backends import get_backend, row_sharded_backend
from ddt_tpu_torch.backends.base import DeviceBackend
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.data.categorical import CategoricalEncoder
from ddt_tpu_torch.data.quantizer import (BinMapper, feature_bincounts,
                                          fit_bin_mapper)
from ddt_tpu_torch.driver import Driver
from ddt_tpu_torch.models.tree import TreeEnsemble
from ddt_tpu_torch.parallel import comms, mesh
from ddt_tpu_torch.telemetry import annotations
from ddt_tpu_torch.utils.atomic import atomic_savez


@dataclasses.dataclass
class TrainResult:
    ensemble: TreeEnsemble
    mapper: BinMapper | None      # None when the caller passed binned data
    cfg: TrainConfig
    # {round, train_loss, ms_per_round[, valid_<metric>]}: the log_every
    # cadence, the last round and every round with an eval score.
    history: list = dataclasses.field(default_factory=list)
    best_round: int | None = None   # 0-based; set with an eval_set
    best_score: float | None = None
    # train never fits a categorical encoder (it sees the encoded matrix);
    # a caller who encoded categorical columns sets it, so save() writes a
    # complete artifact.
    encoder: "object | None" = None
    # The telemetry run id (a run with a run log, capture window or
    # status), stamped into saved models' manifests.
    run_id: str | None = None

    def save(self, path: str) -> None:
        """save_model of the ensemble, mapper and encoder, the run id and
        the config fingerprint in the manifest."""
        save_model(path, self.ensemble, mapper=self.mapper,
                   encoder=self.encoder, run_id=self.run_id, cfg=self.cfg)


@dataclasses.dataclass
class ModelBundle:
    """A loaded model artifact: the ensemble and the preprocessing state it
    was trained with (bin mapper, categorical encoder). Scoring new data
    must reuse this state: a mapper refitted on the scoring set silently
    gives other bins."""

    ensemble: TreeEnsemble
    mapper: BinMapper | None = None
    encoder: "object | None" = None   # data.categorical.CategoricalEncoder
    # The embedded manifest (registry/manifest.py), digest-verified by
    # load_model; None for files written without one.
    manifest: dict | None = None


def save_model(path, ens: TreeEnsemble, mapper: BinMapper | None = None,
               encoder=None, *, run_id: str | None = None,
               cfg: TrainConfig | None = None) -> None:
    """One .npz with the ensemble and, when given, the BinMapper and the
    CategoricalEncoder (keys prefixed "mapper_" and "cat_"), in the
    reference's layout, so either package loads it (TreeEnsemble.load
    reads the ensemble and ignores the rest). The embedded manifest
    (kind "model_bundle": content digest, run_id, config fingerprint, git
    rev) rides under "manifest_json". Written tmp-then-replace with
    fixed zip times: the same model gives the same bytes, which the
    registry's content addressing needs."""
    from ddt_tpu_torch.registry import manifest as manifest_mod

    d = ens.to_dict()
    if mapper is not None:
        d.update({f"mapper_{k}": v for k, v in mapper.save().items()})
    if encoder is not None:
        d.update({f"cat_{k}": v for k, v in encoder.save().items()})
    manifest_mod.embed_npz_manifest(
        d, kind="model_bundle", run_id=run_id,
        config_fingerprint=(manifest_mod.config_fingerprint_digest(cfg)
                            if cfg is not None else None))
    atomic_savez(path, compressed=True, deterministic=True, **d)


def load_model(path, *, verify: bool = True) -> ModelBundle:
    """Load a file written by save_model (or TreeEnsemble.save, of either
    package: mapper and encoder then come back None). An embedded
    manifest's digest is verified and a mismatch raises
    registry.IntegrityError (a ValueError); files without a manifest load
    with manifest=None. `verify=False` skips the digest pass, for callers
    that proved the file's bytes already (the registry loader)."""
    from ddt_tpu_torch.registry import manifest as manifest_mod

    with np.load(path) as z:
        d = dict(z)
    manifest = manifest_mod.read_npz_manifest(d, verify=verify,
                                              source=str(path))
    mapper = None
    if "mapper_edges" in d:
        mapper = BinMapper.load({k[len("mapper_"):]: v for k, v in d.items()
                                 if k.startswith("mapper_")})
    encoder = None
    if "cat_n_cols" in d:
        encoder = CategoricalEncoder.load(
            {k[len("cat_"):]: v for k, v in d.items()
             if k.startswith("cat_")})
    return ModelBundle(ensemble=TreeEnsemble.from_dict(d), mapper=mapper,
                       encoder=encoder, manifest=manifest)


def fill_raw_thresholds(ens: TreeEnsemble, mapper: BinMapper) -> None:
    """Raw-value thresholds of every split node from the mapper's edges:
    mapper.threshold_value at every node, in one array pass (the value
    bins' last threshold sends every value left: +inf; categorical
    nodes' identity edges give the category id itself)."""
    split = ens.feature >= 0
    f = np.where(split, ens.feature, 0)
    t = np.clip(ens.threshold_bin, 0, mapper.edges.shape[1] - 1)
    raw = np.where(ens.threshold_bin >= mapper.n_value_bins - 1,
                   np.float32(np.inf), mapper.edges[f, t])
    ens.threshold_raw = np.where(split, raw, ens.threshold_raw).astype(
        np.float32)
    ens.has_raw_thresholds = True


def fill_bin_thresholds(ens: TreeEnsemble, mapper: BinMapper) -> None:
    """Bin thresholds of every ordinal split node from its raw threshold,
    the inverse of fill_raw_thresholds: the index of the first value-bin
    edge >= the raw threshold (+inf: the last value bin), so "bin <= t"
    routes every row as "value <= threshold" does. Categorical nodes keep
    theirs (the category id). A model parsed from LightGBM text carries
    raw thresholds only; this lets the device score it on bins. Raises
    when a raw threshold is neither one of the mapper's edges nor +inf:
    no bin threshold would route such a split exactly."""
    split = ens.feature >= 0
    if ens.has_cat_splits:
        split &= ~np.isin(ens.feature, ens.cat_features)
    edges = mapper.edges[:, :mapper.n_value_bins - 1]
    tb = np.array(ens.threshold_bin, np.int32)
    for f in np.unique(ens.feature[split]):
        at = split & (ens.feature == f)
        raw = ens.threshold_raw[at]
        t = np.searchsorted(edges[f], raw, side="left")
        exact = np.isposinf(raw) | (
            edges[f][np.minimum(t, edges.shape[1] - 1)] == raw)
        if not exact.all():
            raise ValueError(
                f"feature {int(f)}: raw threshold "
                f"{float(raw[~exact][0])!r} is not one of the mapper's "
                "edges; bins cannot route it exactly")
        tb[at] = t
    ens.threshold_bin = tb


def _check_ranks_agree(be: DeviceBackend, X, mapper: BinMapper | None
                       ) -> None:
    """All-gather a digest of the rows' shape and the fitted edges over
    the world and raise on every rank if any rank's differs."""
    h = hashlib.blake2b(repr(tuple(X.shape)).encode(), digest_size=8)
    if mapper is not None:
        for k, v in sorted(mapper.save().items()):
            h.update(k.encode())
            h.update(np.ascontiguousarray(v).tobytes())
    mine = torch.tensor([int.from_bytes(h.digest(), "little", signed=True)],
                        dtype=torch.int64, device=be.device)
    # The rank's wait for the slowest rank at a job's start.
    with annotations.traced_scope("agree"):
        every = comms.all_gather(mine, be.mesh.world_group)
        agree = bool((every == mine).all())
    if not agree:
        raise ValueError(
            "the ranks disagree on the training rows' shape or the fitted "
            "bin edges: every rank must call train with the same X, y and "
            "config")


def _bin_rows(be: DeviceBackend, X, mapper: BinMapper):
    """X binned on the backend's device, and the mapper's reference bin
    counts: all rows on one device; on a mesh this rank's padded row
    block at full width (a RowBlock: upload cuts the column slab), the
    counts summed over the row group."""
    if be.mesh is None:
        Xb = mapper.transform_device(X, be.device)
        mapper.ref_counts = feature_bincounts(
            Xb, mapper.n_bins).cpu().numpy()
        return Xb
    start, stop, local = mesh.row_block(X.shape[0], be.world, be.rank)
    Xloc = mapper.transform_device(X[start:stop], be.device)
    mapper.ref_counts = comms.psum(feature_bincounts(
        Xloc, mapper.n_bins), be.group).cpu().numpy()
    return mesh.RowBlock(mesh.pad_rows(Xloc, local), X.shape[0])


@annotations.op_scope("train")
def train(
    X: np.ndarray,
    y: np.ndarray,
    cfg: TrainConfig | None = None,
    *,
    binned: bool = False,
    mapper: BinMapper | None = None,
    backend: "DeviceBackend | str | None" = None,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 25,
    log_every: int = 10,
    eval_set: tuple | None = None,
    eval_metric: str | None = None,
    early_stopping_rounds: int | None = None,
    sample_weight: np.ndarray | None = None,
    profile: bool = False,
    run_log=None,
    profiler_window=None,
    status=None,
    **cfg_overrides,
) -> TrainResult:
    """Train a GBDT. `X` is float features (binned here, on the device)
    unless `binned=True` (uint8 bin indices, host or tensor); the eval
    set's rows follow the same flag. `cfg_overrides` are TrainConfig
    fields, e.g. train(X, y, n_trees=50, device="cpu"). `backend` is a
    DeviceBackend to train on, or a string, which is the config's
    `backend` field (the reference's spelling: backend="cpu").

    Observability (the Driver's docstring): `log_every` is the history's
    and the log line's round cadence; `run_log` (a JSONL path or a
    telemetry.RunLog) writes the schema-v5 run log that `cli report`
    renders; `profile=True` times the phases on the granular loop;
    `profiler_window` (telemetry.profiler.CaptureWindow) captures a
    torch.profiler trace of a round range; `status`
    (telemetry.statusd.TrainStatus) is the live status `cli train
    --status-port` serves. None of them: no telemetry work at all."""
    if isinstance(backend, str):
        # The reference's spelling: backend="cpu" is the config field.
        cfg_overrides["backend"], backend = backend, None
    if cfg is None:
        cfg = TrainConfig(**cfg_overrides)
    elif cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    mesh.check_partitions(cfg)
    be = backend if backend is not None else get_backend(cfg)
    if binned:
        Xb = X if isinstance(X, torch.Tensor) else np.asarray(X)
        if Xb.dtype not in (np.uint8, torch.uint8):
            raise TypeError("binned=True requires uint8 bin indices")
    else:
        if mapper is None:
            mapper = fit_bin_mapper(np.asarray(X), n_bins=cfg.n_bins,
                                    seed=cfg.seed,
                                    missing_policy=cfg.missing_policy,
                                    cat_features=cfg.cat_features)
        elif cfg.missing_policy == "learn" and not mapper.missing_bin:
            raise ValueError(
                "missing_policy='learn' requires a BinMapper fitted with "
                "the same policy (its top bin must be the NaN bin)")
        if cfg.cat_features:
            # Quantile edges would merge or permute category ids before
            # the one-vs-rest splits see them.
            not_identity = mapper.non_identity_columns(cfg.cat_features)
            if not_identity:
                raise ValueError(
                    f"cat_features {not_identity} were not identity-binned "
                    "by this BinMapper; refit it with "
                    f"cat_features={tuple(sorted(cfg.cat_features))} so "
                    "category ids survive binning")
    with annotations.traced_scope("train.rows"):
        if be.mesh is not None:
            _check_ranks_agree(be, X, mapper)
        if not binned:
            Xb = _bin_rows(be, X, mapper)
        if eval_set is not None:
            Xv, yv = eval_set
            if not isinstance(Xv, torch.Tensor):
                Xv = np.asarray(Xv)
            if binned:
                if Xv.dtype not in (np.uint8, torch.uint8):
                    raise TypeError(
                        "training data is pre-binned; eval_set must be "
                        f"uint8 bin indices too, got {Xv.dtype}")
            else:
                Xv = mapper.transform_device(Xv, be.device)
            eval_set = (Xv, np.asarray(yv))
    driver = Driver(be, cfg, log_every=log_every,
                    checkpoint_dir=checkpoint_dir,
                    checkpoint_every=checkpoint_every, profile=profile,
                    run_log=run_log, profiler_window=profiler_window,
                    status=status)
    ens = driver.fit(Xb, np.asarray(y), eval_set=eval_set,
                     eval_metric=eval_metric,
                     early_stopping_rounds=early_stopping_rounds,
                     sample_weight=sample_weight)
    if mapper is not None:
        fill_raw_thresholds(ens, mapper)
    return TrainResult(ensemble=ens, mapper=mapper, cfg=cfg,
                       history=driver.history,
                       best_round=driver.best_round,
                       best_score=driver.best_score, run_id=driver.run_id)


@annotations.op_scope("score.proba")
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


def validate_mapper_model(mapper: BinMapper, ens: TreeEnsemble) -> None:
    """The mapper-vs-model scoring contract (api.predict per call,
    ServableModel once per model version): the NaN policy must match and
    the model's categorical columns must have been identity-binned by this
    mapper; either failure would silently misroute rows."""
    if mapper.missing_bin != ens.missing_bin:
        raise ValueError(
            f"mapper.missing_bin={mapper.missing_bin} but the ensemble "
            f"was trained with missing_bin={ens.missing_bin}; use the "
            "training-time mapper")
    if ens.has_cat_splits:
        not_identity = mapper.non_identity_columns(ens.cat_features)
        if not_identity:
            raise ValueError(
                f"the ensemble splits features {not_identity} "
                "categorically but this BinMapper did not identity-bin "
                "them; use the training-time mapper")


@annotations.op_scope("score")
def predict(
    ens: "TreeEnsemble | ModelBundle",
    X: np.ndarray,
    *,
    binned: bool = False,
    mapper: BinMapper | None = None,
    raw: bool = False,
    backend: DeviceBackend | None = None,
    cfg: TrainConfig | None = None,
    device: str = "cuda",
    n_partitions: int | None = None,
) -> np.ndarray:
    """Score a batch on the device: float X is binned there with `mapper`
    first (uint8 bins, host or tensor, with binned=True); a ModelBundle
    brings its training mapper (its encoder is not applied: X carries
    categorical columns encoded already, as at training). Returns
    probabilities (raw margins with raw=True). The scoring backend is
    `backend` if given, else the one of `cfg` (whose predict_impl picks
    the f32, int8 or int4 tier, and whose device wins), else the f32
    backend of `device`.

    `n_partitions` k > 1, with neither `backend` nor `cfg`, scores on k
    devices of `device` in this process (backends.row_sharded_backend):
    the rows are split into k blocks, each binned and scored at the f32
    tier on its own card, trees replicated, no collective; the result is
    bitwise the one-device result. More partitions than visible cards
    raise."""
    if isinstance(ens, ModelBundle):
        if mapper is None:
            mapper = ens.mapper
        ens = ens.ensemble
    if not isinstance(X, torch.Tensor):
        X = np.asarray(X)
    if not binned:
        if mapper is None:
            raise ValueError(
                "predict on raw features needs the training mapper; or "
                "pass binned=True with uint8 bins")
        with annotations.traced_scope("score.prepare"):
            validate_mapper_model(mapper, ens)
    elif X.dtype not in (np.uint8, torch.uint8):
        raise TypeError(f"binned data must be uint8, got {X.dtype}")
    if n_partitions is not None and n_partitions > 1 \
            and backend is None and cfg is None:
        out = row_sharded_backend(n_partitions, device).predict_raw(
            ens, X, mapper=None if binned else mapper)
    else:
        if backend is None:
            backend = get_backend(cfg if cfg is not None
                                  else TrainConfig(device=device))
        if not binned:
            X = mapper.transform_device(X, backend.device)
        out = backend.predict_raw(ens, X)
    return out if raw else predict_proba_np(out, ens.loss)
