"""Training configuration of the PyTorch/CUDA port.

Port of ddt_tpu/config.py: a frozen TrainConfig with only the fields the
port's path reads, validated as the reference validates them
(ddt_tpu/config.py:214-270, 298-330). Fields of the reference that are
not ported yet (straggler repartition, streaming, hist_impl,
fault plans, ...) are absent, not silently ignored: passing one raises
TypeError.
"""

from __future__ import annotations

import dataclasses

LOSSES = ("logloss", "mse", "softmax")
DEVICES = ("cuda", "cpu")
#: cfg.grad_dtype values ("f32" = quantization off; ops/grad.py).
GRAD_DTYPES = ("f32", "int16", "int8")
#: cfg.split_comms values (parallel/comms.resolve_split_comms resolves
#: "auto") and cfg.hist_comms_dtype values (the histogram collective's
#: wire dtype, parallel/comms.hist_reduce).
SPLIT_COMMS = ("auto", "allreduce", "reduce_scatter")
COMMS_DTYPES = ("f32", "bf16", "int32_fixed")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Hyper-parameters for GBDT training. Frozen: backends are cached on
    it (backends/__init__.py). Use .replace() to derive variants."""

    # --- model ---
    n_trees: int = 100          # boosting rounds
    max_depth: int = 6          # levels of splits; complete heap layout
    n_bins: int = 255
    learning_rate: float = 0.1
    loss: str = "logloss"       # logloss | mse | softmax
    n_classes: int = 2          # used when loss == "softmax"

    # --- regularisation (XGBoost-style gain formula) ---
    reg_lambda: float = 1.0     # L2 on leaf weights
    min_child_weight: float = 1e-3   # min hessian sum per child
    min_split_gain: float = 0.0      # split only if gain > this

    # --- sampling (ops/sampling: stateless counter hashes of cfg.seed) ---
    subsample: float = 1.0           # row fraction per boosting round
    colsample_bytree: float = 1.0    # feature fraction per tree

    # --- missing values ---
    # "zero": NaN maps to bin 0. "learn": the top bin (n_bins-1) is
    # reserved for NaN and every split learns a default direction for the
    # rows in it (ops/split.best_splits_impl scores both).
    missing_policy: str = "zero"   # zero | learn

    # --- categorical features ---
    # Feature indices split one-vs-rest ("bin == k goes left") instead of
    # ordinally; their columns must be identity-binned category ids
    # (data/quantizer.fit_bin_mapper(cat_features=...) or
    # data/categorical's encoders). Normalised to a sorted tuple.
    cat_features: tuple = ()

    # Sibling subtraction (ops/grow.level_histograms): levels >= 1 build
    # only left-child histograms and recover right children as
    # parent - left. "auto" is on for device="cuda" and off on the CPU
    # (ops/grow.resolve_hist_subtraction).
    hist_subtraction: str = "auto"  # auto | on | off
    # Keys the bin-edge sample (api.train), the bagging and colsample
    # draws, and the quantized-gradient stochastic rounding.
    seed: int = 0

    # Quantized gradients (ops/grad.py): "int8" / "int16" round g/h once
    # per tree onto a shared grid (seeded stochastic rounding); histograms,
    # node totals and leaf sums then add exact int32 sums (the histogram
    # kernel's integer mode) and dequantize once per level. Sibling
    # subtraction is exact there, so "auto" turns it on on every device.
    grad_dtype: str = "f32"     # f32 | int16 | int8

    # Batch-scoring tier (backends/cuda.py): "auto" is the f32 traversal;
    # "lut" the int8 TreeLUT tier (int8 thresholds, fp16 leaves; kernel
    # csrc/lut.cu ddt_lut_int8); "lut4" the int4 tier (nibble-packed
    # leaves with per-tree scales, nibble thresholds on <= 15-bin models;
    # ddt_lut_int4). A quantized tier whose shape the kernel's fits guard
    # refuses steps down int4 -> int8 -> f32 with a warning. The
    # reference's "pallas" / "onehot" pick between its two f32 paths on a
    # TPU; the port has one f32 path, so they are refused.
    predict_impl: str = "auto"  # auto | lut | lut4

    # --- system ---
    # The mesh: host_partitions x n_partitions x feature_partitions ranks,
    # one process a rank, joined by torch.distributed (NCCL on the cards,
    # gloo on the CPU); the product must equal the process group's world
    # size (parallel/mesh.make_mesh_2d lays the ranks out hosts
    # outermost, features innermost). Every rank passes the same full
    # rows; each keeps its contiguous block of the rows padded to a
    # multiple of the row shards (host_partitions x n_partitions,
    # parallel/mesh.row_block) and, with feature_partitions > 1, its
    # contiguous column slab of F padded with zero columns to a multiple
    # of feature_partitions (parallel/mesh.column_slab). Every rank grows
    # the same trees.
    n_partitions: int = 1       # row partitions (data parallel)
    feature_partitions: int = 1  # column partitions
    # The declarative spelling of (n_partitions, feature_partitions):
    # normalised into them at construction and then set back to None, so
    # both spellings give equal configs; a conflict with either raises.
    mesh_shape: tuple | None = None
    # The hosts axis: row shards span hosts x rows, hosts outermost (on
    # one node the hosts are emulated; nothing differs but the names).
    host_partitions: int = 1
    # The histogram collective of split finding (parallel/comms.py):
    # "allreduce" sums the [n, F, B, 2] level histogram on every rank;
    # "reduce_scatter" hands each rank one merged F/P feature slab, finds
    # the slab's best splits there and all-gathers the per-rank winners
    # (comms.combine_shard_winners: the single-device argmax's pick).
    # "auto" is reduce_scatter whenever rows are partitioned.
    split_comms: str = "auto"   # auto | allreduce | reduce_scatter
    # Wire dtype of the histogram collective (never on by default):
    # "bf16" rounds each partial to bf16 and sums in f32; "int32_fixed"
    # sums on a shared fixed-point grid in int32, independent of the
    # reduction order. comms.comms_error_bound bounds both.
    hist_comms_dtype: str = "f32"   # f32 | bf16 | int32_fixed
    # Slab-pipelined histogram collectives (ops/grow.level_histograms):
    # each level's build + collective splits into this many feature slabs,
    # slab k's collective issued asynchronously before slab k+1's kernel.
    # 0 = auto (parallel/comms.resolve_comms_slabs: 1 on every device
    # until a card measurement says otherwise), 1 = off, N = N slabs.
    # f32 sums may round differently with N (the wire's reduction order
    # depends on where an element falls); integer histograms are bitwise
    # at any N; int32_fixed quantizes each slab on its own grid.
    hist_comms_slabs: int = 0
    # Rounds a block of the fused boosting loop (Driver._fit_fused): each
    # block replays one captured round that many times (on the card, a
    # CUDA graph) and fetches its trees to the host once.
    fused_block_rounds: int = 100
    # Where training and scoring run. "cuda" raises when no card is
    # visible: the entry points never continue on the CPU by themselves.
    device: str = "cuda"        # cuda | cpu

    def __post_init__(self) -> None:
        if self.loss not in LOSSES:
            raise ValueError(f"loss must be one of {LOSSES}, got {self.loss!r}")
        if self.loss == "softmax" and self.n_classes < 2:
            raise ValueError("softmax needs n_classes >= 2")
        if self.device not in DEVICES:
            raise ValueError(
                f"device must be one of {DEVICES}, got {self.device!r}")
        if not (1 <= self.n_bins <= 256):
            raise ValueError("n_bins must be in [1, 256] (uint8 binned data)")
        if self.max_depth < 1:
            raise ValueError("max_depth must be >= 1")
        if not (0.0 < self.subsample <= 1.0):
            raise ValueError("subsample must be in (0, 1]")
        if not (0.0 < self.colsample_bytree <= 1.0):
            raise ValueError("colsample_bytree must be in (0, 1]")
        if self.grad_dtype not in GRAD_DTYPES:
            raise ValueError(
                f"grad_dtype must be f32|int16|int8, got "
                f"{self.grad_dtype!r}")
        if self.mesh_shape is not None:
            ms = tuple(int(v) for v in self.mesh_shape)
            if len(ms) != 2 or any(v < 1 for v in ms):
                raise ValueError(
                    f"mesh_shape must be a (Pr >= 1, Pf >= 1) pair, got "
                    f"{self.mesh_shape!r}")
            pr, pf = ms
            if self.n_partitions not in (1, pr):
                raise ValueError(
                    f"mesh_shape={ms} conflicts with n_partitions="
                    f"{self.n_partitions}; set one, not both")
            if self.feature_partitions not in (1, pf):
                raise ValueError(
                    f"mesh_shape={ms} conflicts with feature_partitions="
                    f"{self.feature_partitions}; set one, not both")
            object.__setattr__(self, "n_partitions", pr)
            object.__setattr__(self, "feature_partitions", pf)
            object.__setattr__(self, "mesh_shape", None)
        for name in ("n_partitions", "feature_partitions",
                     "host_partitions"):
            if getattr(self, name) < 1:
                raise ValueError(
                    f"{name} must be >= 1, got {getattr(self, name)}")
        if self.hist_comms_slabs < 0:
            raise ValueError(
                f"hist_comms_slabs must be >= 0 (0 = auto), got "
                f"{self.hist_comms_slabs}")
        if self.split_comms not in SPLIT_COMMS:
            raise ValueError(
                f"split_comms must be auto|allreduce|reduce_scatter, got "
                f"{self.split_comms!r}")
        if self.hist_comms_dtype not in COMMS_DTYPES:
            raise ValueError(
                f"hist_comms_dtype must be f32|bf16|int32_fixed, got "
                f"{self.hist_comms_dtype!r}")
        if self.grad_dtype != "f32" and self.hist_comms_dtype != "f32":
            # Quantized-gradient histograms are already integer partials
            # on one shared grid and merge exactly: compressing them again
            # would quantize twice.
            raise ValueError(
                f"grad_dtype={self.grad_dtype!r} with hist_comms_dtype="
                f"{self.hist_comms_dtype!r} would double-quantize the "
                "histogram collective: quantized-gradient partials are "
                "integer values on one shared grid and merge exactly as "
                "they are; keep hist_comms_dtype='f32'")
        if self.hist_subtraction not in ("auto", "on", "off"):
            raise ValueError(
                f"hist_subtraction must be auto|on|off, got "
                f"{self.hist_subtraction!r}")
        if self.fused_block_rounds < 1:
            raise ValueError(
                f"fused_block_rounds must be >= 1, got "
                f"{self.fused_block_rounds}")
        if self.predict_impl not in ("auto", "lut", "lut4"):
            raise ValueError(
                f"predict_impl must be auto|lut|lut4, got "
                f"{self.predict_impl!r} (the port has one f32 scoring "
                "path: 'auto'; the reference's 'pallas'/'onehot' choose "
                "between its two TPU paths)")
        if self.missing_policy not in ("zero", "learn"):
            raise ValueError(
                f"missing_policy must be zero|learn, got "
                f"{self.missing_policy!r}")
        if self.missing_policy == "learn" and self.n_bins < 3:
            raise ValueError(
                "missing_policy='learn' reserves the top bin; n_bins >= 3")
        # A list (even an empty one) must become a tuple, or the backend
        # cache key is unhashable.
        object.__setattr__(
            self, "cat_features",
            tuple(sorted(int(f) for f in self.cat_features)))
        if self.cat_features:
            if self.cat_features[0] < 0:
                raise ValueError("cat_features indices must be >= 0")
            if self.missing_policy == "learn":
                raise ValueError(
                    "cat_features with missing_policy='learn' is not "
                    "supported: the reserved NaN bin would silently merge "
                    "the encoder's top category id into its neighbor "
                    "(categorical columns are integer-coded and never "
                    "NaN, so use missing_policy='zero')")

    @property
    def row_shards(self) -> int:
        """Row blocks of the mesh: host_partitions x n_partitions."""
        return self.host_partitions * self.n_partitions

    @property
    def world_size(self) -> int:
        """Ranks of the mesh: host_partitions x n_partitions x
        feature_partitions."""
        return self.row_shards * self.feature_partitions

    @property
    def n_outputs(self) -> int:
        """Output columns, and trees a boosting round: n_classes for
        softmax, else 1."""
        return self.n_classes if self.loss == "softmax" else 1

    @property
    def missing_bin_value(self) -> int:
        """Bin reserved for NaN rows under missing_policy='learn', -1
        otherwise."""
        return self.n_bins - 1 if self.missing_policy == "learn" else -1

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_file(cls, path: str, **overrides) -> "TrainConfig":
        """A config from a .yaml/.yml/.json file of TrainConfig fields
        (load_config_file), `overrides` on top."""
        return cls(**{**load_config_file(path), **overrides})


def load_config_file(path: str) -> dict:
    """TrainConfig fields from a .yaml/.yml/.json file, key-validated
    (the reference's load_config_file; `cli train --config` lays them
    over the flags). A field the port has not ported is an unknown key."""
    import json

    with open(path) as f:
        if path.endswith((".yaml", ".yml")):
            import yaml

            d = yaml.safe_load(f)
        else:
            d = json.load(f)
    if not isinstance(d, dict):
        raise ValueError(f"{path} must contain a mapping, got {type(d)}")
    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    unknown = sorted(set(d) - fields)
    if unknown:
        raise ValueError(
            f"{path} has unknown TrainConfig keys {unknown}; "
            f"valid: {sorted(fields)}")
    if "cat_features" in d:
        d["cat_features"] = tuple(d["cat_features"])
    if d.get("mesh_shape") is not None:
        d["mesh_shape"] = tuple(d["mesh_shape"])
    return d
