"""Binning on the device: the quantizer's transform as PyTorch ops.

Port of ddt_tpu/ops/quantize.py (`transform_binned`, `transform_device`).
The reference computes it in XLA, not Pallas, so it is not one of the TPU
kernels; plain PyTorch on the card does it here. Formula:

    bin = clip( #{e < nv-1 : edges[f, e] < v}, 0, nv - 1 )

with NaN sent to the reserved bin (n_bins - 1) under `missing_bin`, else
to bin 0: bit for bit BinMapper.transform, including +/-inf, -0.0,
duplicate-edge runs and identity (categorical) columns. The count of
edges strictly below v is `searchsorted(edges, v, side='left')` over a
non-decreasing edge row; the reference sums a [block, F, nv-1] compare,
which on the card would write ~7 G booleans at 1M x 28 x 255, so here each
block of rows is transposed to [F, rows] and searched against the [F,
nv-1] edges (8 steps of a binary search a value).

Bound at the Higgs shape (1M x 28): the f32 rows read once and the uint8
bins written once, 140 MB, ~0.042 ms at 3.35 TB/s.

`transforms` counts the calls that binned a CUDA tensor (chip_smoke reads
it around the main path); CPU tensors run the same ops uncounted.
"""

from __future__ import annotations

import numpy as np
import torch

from ddt_tpu_torch.telemetry.annotations import traced_scope

#: Device transforms since the last reset (calls on a CUDA tensor).
transforms = 0

#: Rows a block: one block at the Higgs shape; the [F, rows] transpose
#: and int32 search output of a block are the only transients.
ROW_BLOCK = 1 << 20


def transform_binned(X: torch.Tensor, edges: torch.Tensor, n_bins: int,
                     missing_bin: bool = False,
                     row_block: int = ROW_BLOCK) -> torch.Tensor:
    """uint8 [R, F] bin indices of f32 X [R, F] (NaN allowed), on X's
    device. `edges` f32 [F, >= nv-1] on the same device, non-decreasing
    per row over its first nv-1 columns (nv = n_bins - 1 under
    missing_bin, else n_bins)."""
    global transforms
    if X.dtype != torch.float32 or X.dim() != 2:
        raise TypeError(f"X must be float32 [R, F], got {X.dtype} "
                        f"{tuple(X.shape)}")
    R, F = X.shape
    if edges.shape[0] != F or edges.device != X.device:
        raise ValueError(f"edges {tuple(edges.shape)} on {edges.device} "
                         f"do not match X [R, {F}] on {X.device}")
    if row_block < 1:
        raise ValueError(f"row_block must be >= 1, got {row_block}")
    nv = n_bins - 1 if missing_bin else n_bins
    e = edges[:, :nv - 1].contiguous()
    nan_bin = n_bins - 1 if missing_bin else 0
    out = torch.empty((R, F), dtype=torch.uint8, device=X.device)
    for r0 in range(0, R, row_block):
        xt = X[r0:r0 + row_block].t().contiguous()          # [F, rows]
        if nv > 1:
            # In [0, nv - 1] already: the reference's clip is the identity.
            b = torch.searchsorted(e, xt, side="left", out_int32=True)
        else:
            b = torch.zeros(xt.shape, dtype=torch.int32, device=X.device)
        b = torch.where(torch.isnan(xt), nan_bin, b)
        out[r0:r0 + row_block] = b.t().to(torch.uint8)
    if X.device.type == "cuda":
        transforms += 1
    return out


def device_edges(mapper, device) -> torch.Tensor:
    """The mapper's f32 edges on `device`, uploaded once per (mapper,
    device): edges never change after fit (the same rule as the mapper's
    non_identity_columns memo)."""
    device = torch.device(device)
    cache = mapper.__dict__.setdefault("_device_edges", {})
    key = str(device)
    if key not in cache:
        cache[key] = torch.from_numpy(
            np.ascontiguousarray(mapper.edges, np.float32)).to(device)
    return cache[key]


def transform_device(mapper, X, device="cuda") -> torch.Tensor:
    """Bin a float matrix on `device` with `mapper`'s edges: uint8 [R, F]
    on that device, bit for bit mapper.transform(X). Host X is cast to
    f32 first, exactly as transform casts it (np.asarray(X, float32)),
    then uploaded once; an f32 tensor already on `device` is binned
    where it lies."""
    device = torch.device(device)
    if isinstance(X, torch.Tensor):
        if X.dtype != torch.float32:
            raise TypeError(f"X must be float32, got {X.dtype}")
        with traced_scope("upload"):
            Xd = X.to(device)
    else:
        Xh = np.asarray(X, np.float32)
        if Xh.ndim != 2 or Xh.shape[1] != mapper.n_features:
            raise ValueError(
                f"X must be [rows, {mapper.n_features}], got {Xh.shape}")
        # From pageable host memory: the copy returns once it has landed.
        with traced_scope("upload"):
            Xd = torch.from_numpy(np.ascontiguousarray(Xh)).to(device)
    if Xd.dim() != 2 or Xd.shape[1] != mapper.n_features:
        raise ValueError(
            f"X must be [rows, {mapper.n_features}], got {tuple(Xd.shape)}")
    with traced_scope("bin"):
        return transform_binned(Xd, device_edges(mapper, device),
                                n_bins=mapper.n_bins,
                                missing_bin=mapper.missing_bin)


def feature_bincounts(Xb: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Per-feature bin histogram of a binned uint8 tensor [R, F] on its
    device: int64 [F, n_bins], bit for bit the numpy form
    (data/quantizer.feature_bincounts): one bincount over f * n_bins +
    bin."""
    if Xb.dtype != torch.uint8 or Xb.dim() != 2:
        raise TypeError(f"Xb must be uint8 [rows, features], got "
                        f"{Xb.dtype} {tuple(Xb.shape)}")
    F = Xb.shape[1]
    off = torch.arange(F, dtype=torch.int64, device=Xb.device) * n_bins
    flat = (off[None, :] + Xb.to(torch.int64)).reshape(-1)
    return torch.bincount(flat, minlength=F * n_bins).reshape(F, n_bins)
