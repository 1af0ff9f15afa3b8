"""Traversal kernel wrapper (csrc/traverse.cu): the Hopper counterpart of
ddt_tpu/ops/predict_pallas.py::_traverse_kernel.

One thread per row runs the D-step descent of every pushed-down tree,
with the tree tables of one chunk staged in shared memory (design and
bound are stated in the source). Missing-value and categorical routing and
C > 1 classes are kept, as K3's contract has them.

The plain version of the same function is ops/predict.
predict_effective_plain; ops/predict.predict_raw_effective dispatches CUDA
tensors here and CPU tensors there. This wrapper never falls back: a CPU
tensor, a shape the fits check refuses, or a failed launch raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ddt_tpu_torch import _build

#: Kernel launches since the last reset (chip_smoke reads it around the
#: main path). Counted only where the kernel is launched.
launches = 0

THREADS = 256           # rows per block (kThreads in csrc/traverse.cu)
MAX_CLASSES = 32
_argtypes_set = False


class Tables(NamedTuple):
    """Kernel operands of one CompiledEnsemble, on the card."""

    nodes: torch.Tensor     # int32 [Tpad, Nint, 2]: (feature, threshold)
    flags: torch.Tensor     # uint8 [Tpad, Nint]: bit0 default_left, bit1 cat
    vals: torch.Tensor      # f32 [Tpad, 2^D] bottom-level values
    cls: torch.Tensor       # int32 [Tpad] class of each tree
    max_depth: int
    n_classes: int
    use_missing: bool
    use_cat: bool
    max_feature: int        # largest split feature (-1: no split at all)


def pack_tables(eff_feat, eff_thr, bot_val, cls_oh, max_depth: int,
                eff_dl=None, eff_cat=None) -> Tables:
    """CompiledEnsemble arrays (already on the card) -> kernel operands,
    built once per model (the one host sync reads the largest feature).
    The categorical flag is gated on feature >= 0 here, as the TPU
    kernel's prologue gates it, so pushed-down leaves stay always-left."""
    n_int = (1 << max_depth) - 1
    feat = eff_feat[:, :n_int].to(torch.int32)
    nodes = torch.stack([feat, eff_thr[:, :n_int].to(torch.int32)],
                        dim=-1).contiguous()
    flags = torch.zeros(feat.shape, dtype=torch.uint8, device=feat.device)
    if eff_dl is not None:
        flags |= eff_dl[:, :n_int].to(torch.uint8)
    if eff_cat is not None:
        flags |= ((eff_cat[:, :n_int].bool() & (feat >= 0))
                  .to(torch.uint8) << 1)
    return Tables(
        nodes=nodes, flags=flags.contiguous(),
        vals=bot_val.to(torch.float32).contiguous(),
        cls=cls_oh.argmax(dim=1).to(torch.int32).contiguous(),
        max_depth=max_depth, n_classes=int(cls_oh.shape[1]),
        use_missing=eff_dl is not None, use_cat=eff_cat is not None,
        max_feature=int(feat.max()) if feat.numel() else -1)


def smem_bytes(sub: int, max_depth: int, n_features: int) -> int:
    """Dynamic shared memory of one block staging `sub` trees."""
    n_int = (1 << max_depth) - 1
    n_leaf = 1 << max_depth
    return sub * (n_int * 8 + n_leaf * 4 + 4 + n_int) + n_features * THREADS


def stage_width(tree_chunk: int, max_depth: int, n_features: int,
                smem_limit: int) -> int:
    """Trees staged per pass: the largest divisor of tree_chunk whose
    tables fit beside the row staging area. Raises if one tree does not."""
    for sub in range(tree_chunk, 0, -1):
        if tree_chunk % sub == 0 and \
                smem_bytes(sub, max_depth, n_features) <= smem_limit:
            return sub
    raise ValueError(
        f"one depth-{max_depth} tree with {n_features} features needs "
        f"{smem_bytes(1, max_depth, n_features)} B of shared memory, more "
        f"than the card's {smem_limit} B")


def _lib():
    global _argtypes_set
    lib = _build.library("traverse")
    if not _argtypes_set:
        vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_longlong, ctypes.c_float)
        lib.ddt_traverse_f32.argtypes = [
            vp, vp, vp, vp, vp, vp, i64, i32, i32, i32, i32, i32, i32, i32,
            i32, i32, f32, f32, i32, vp]
        lib.ddt_traverse_f32.restype = i32
        _argtypes_set = True
    return lib


def traverse_cuda(tables: Tables, X: torch.Tensor, *, learning_rate: float,
                  base: float, tree_chunk: int = 64,
                  missing_bin_value: int = -1) -> torch.Tensor:
    """f32 [R, C] margins base + lr * sum of leaf values, X uint8 [R, F]
    contiguous on the card holding the tables."""
    global launches
    if X.device.type != "cuda":
        raise TypeError(f"X must be a CUDA tensor, got {X.device}")
    if X.dtype != torch.uint8 or X.dim() != 2 or not X.is_contiguous():
        raise TypeError("X must be a contiguous uint8 [R, F] tensor")
    for t in tables[:4]:
        if t.device != X.device:
            raise ValueError(f"tables on {t.device}, X on {X.device}")
    R, F = X.shape
    Tpad = tables.nodes.shape[0]
    C = tables.n_classes
    if Tpad % tree_chunk:
        raise ValueError(f"padded tree count {Tpad} is not a multiple of "
                         f"tree_chunk={tree_chunk}")
    if C > MAX_CLASSES:
        raise ValueError(f"{C} classes; the kernel takes at most "
                         f"{MAX_CLASSES}")
    out = torch.empty((R, C), dtype=torch.float32, device=X.device)
    if R == 0:
        return out
    if tables.max_feature >= F:
        raise ValueError(f"split feature {tables.max_feature} is >= the "
                         f"data's {F} columns")
    sub = stage_width(tree_chunk, tables.max_depth, F,
                      _build.smem_limit(X.device))
    lib = _lib()
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.ddt_traverse_f32(
            X.data_ptr(), tables.nodes.data_ptr(), tables.flags.data_ptr(),
            tables.vals.data_ptr(), tables.cls.data_ptr(), out.data_ptr(),
            R, F, Tpad, tables.max_depth, tree_chunk, sub, C,
            missing_bin_value, int(tables.use_missing), int(tables.use_cat),
            float(learning_rate), float(base),
            smem_bytes(sub, tables.max_depth, F), stream)
    _build.check(status, "traverse kernel launch")
    launches += 1
    return out
