"""Training configuration of the PyTorch/CUDA port.

Port of ddt_tpu/config.py: a frozen TrainConfig with only the fields the
port's path reads. Fields of the reference that are not ported yet
(softmax, missing-value and categorical training, meshes, compressed
histogram collectives, ...) are absent, not silently ignored: passing one
raises TypeError.
"""

from __future__ import annotations

import dataclasses

LOSSES = ("logloss", "mse")
DEVICES = ("cuda", "cpu")
#: cfg.grad_dtype values ("f32" = quantization off; ops/grad.py).
GRAD_DTYPES = ("f32", "int16", "int8")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Hyper-parameters for GBDT training. Frozen: backends are cached on
    it (backends/__init__.py). Use .replace() to derive variants."""

    # --- model ---
    n_trees: int = 100          # boosting rounds
    max_depth: int = 6          # levels of splits; complete heap layout
    n_bins: int = 255
    learning_rate: float = 0.1
    loss: str = "logloss"       # logloss | mse

    # --- regularisation (XGBoost-style gain formula) ---
    reg_lambda: float = 1.0     # L2 on leaf weights
    min_child_weight: float = 1e-3   # min hessian sum per child
    min_split_gain: float = 0.0      # split only if gain > this

    # --- sampling (ops/sampling: stateless counter hashes of cfg.seed) ---
    subsample: float = 1.0           # row fraction per boosting round
    colsample_bytree: float = 1.0    # feature fraction per tree

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
    # Where training and scoring run. "cuda" raises when no card is
    # visible: the entry points never continue on the CPU by themselves.
    device: str = "cuda"        # cuda | cpu

    def __post_init__(self) -> None:
        if self.loss not in LOSSES:
            raise ValueError(f"loss must be one of {LOSSES}, got {self.loss!r}")
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
        if self.hist_subtraction not in ("auto", "on", "off"):
            raise ValueError(
                f"hist_subtraction must be auto|on|off, got "
                f"{self.hist_subtraction!r}")
        if self.predict_impl not in ("auto", "lut", "lut4"):
            raise ValueError(
                f"predict_impl must be auto|lut|lut4, got "
                f"{self.predict_impl!r} (the port has one f32 scoring "
                "path: 'auto'; the reference's 'pallas'/'onehot' choose "
                "between its two TPU paths)")

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)
