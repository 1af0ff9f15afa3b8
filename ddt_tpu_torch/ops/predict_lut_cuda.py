"""LUT kernel wrappers (csrc/lut.cu): the Hopper counterparts of
ddt_tpu/ops/predict_lut.py::_lut_kernel (K4, the int8 tier) and
::_lut4_kernel (K5, the int4 tier).

Both take the reference's node-major operand tuples unchanged
(ops/predict_lut.lut_device_operands, PackedTables.ops) and raw uint8
rows, and write f32 [R, C] = base + lr * sum over tree chunks of the
per-class chunk sums of the selected leaf values. One thread per row runs
K3's descent; the design and the bound are stated in the source.

The plain versions are ops/predict_lut.predict_effective_lut_plain and
predict_effective_lut4_plain; ops/predict_lut's dispatchers send CUDA
tensors here and CPU tensors there. These wrappers never fall back: a CPU
tensor, a shape whose tables do not fit shared memory, or a failed launch
raises.
"""

from __future__ import annotations

import ctypes

import torch

from ddt_tpu_torch import _build

#: Kernel launches since the last reset (chip_smoke reads them around
#: the serve phase). Counted only where a kernel is launched.
launches_lut = 0
launches_lut4 = 0

THREADS = 256           # rows per block (kThreads in csrc/lut.cu)
MAX_CLASSES = 32
#: The H100's opt-in shared memory per block: what the fits guards count
#: against when the scoring device is the CPU.
SMEM_LIMIT_H100 = 232_448
_argtypes_set = False


def tree_bytes(max_depth: int, leaf_dtype: str,
               thr_packed: bool = False) -> int:
    """Shared memory of one staged tree: feature int32 per node, scale and
    class (4 B each), leaves at their width, thresholds (a byte per node,
    half when nibble-packed), and the missing and categorical flags."""
    n_int = (1 << max_depth) - 1
    n_leaf = 1 << max_depth
    leaf_w = {"float16": 2 * n_leaf, "int8": n_leaf,
              "int4": (n_leaf + 1) // 2}[leaf_dtype]
    thr_w = (n_int + 1) // 2 if thr_packed else n_int
    return 4 * n_int + 8 + leaf_w + thr_w + 2 * n_int


def smem_bytes(sub: int, max_depth: int, n_features: int, leaf_dtype: str,
               thr_packed: bool = False) -> int:
    """Dynamic shared memory of one block staging `sub` trees."""
    return (sub * tree_bytes(max_depth, leaf_dtype, thr_packed)
            + n_features * THREADS)


def stage_width(tree_chunk: int, max_depth: int, n_features: int,
                leaf_dtype: str, thr_packed: bool, smem_limit: int) -> int:
    """Trees staged per pass: the largest divisor of tree_chunk whose
    tables fit beside the row staging area. Raises if one tree does not."""
    for sub in range(tree_chunk, 0, -1):
        if tree_chunk % sub == 0 and smem_bytes(
                sub, max_depth, n_features, leaf_dtype,
                thr_packed) <= smem_limit:
            return sub
    raise ValueError(
        f"one depth-{max_depth} {leaf_dtype} LUT tree with {n_features} "
        f"features needs "
        f"{smem_bytes(1, max_depth, n_features, leaf_dtype, thr_packed)} "
        f"B of shared memory, more than the card's {smem_limit} B")


def _lib():
    global _argtypes_set
    lib = _build.library("lut")
    if not _argtypes_set:
        vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_longlong, ctypes.c_float)
        for fn in (lib.ddt_lut_int8, lib.ddt_lut_int4):
            fn.argtypes = [vp] * 9 + [i64] + [i32] * 10 + [f32, f32, i32,
                                                           vp]
            fn.restype = i32
        _argtypes_set = True
    return lib


def _expect(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, X on {device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise TypeError(f"{name} must be {dtype} {tuple(shape)}, got "
                        f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise TypeError(f"{name} must be contiguous")


def _launch(entry: str, ops: tuple, X: torch.Tensor, *, leaf_dtype: str,
            thr_dtype, thr_packed: bool, use_scale: bool, max_depth: int,
            learning_rate: float, base: float, n_classes: int,
            tree_chunk: int, n_trees_padded: int, missing_bin_value: int,
            use_missing: bool, use_cat: bool, cls, max_feature,
            mode_flag: int) -> torch.Tensor:
    if X.device.type != "cuda":
        raise TypeError(f"X must be a CUDA tensor, got {X.device}")
    if X.dtype != torch.uint8 or X.dim() != 2 or not X.is_contiguous():
        raise TypeError("X must be a contiguous uint8 [R, F] tensor")
    R, F = X.shape
    C, tc, Tpad = n_classes, tree_chunk, n_trees_padded
    if Tpad % tc:
        raise ValueError(f"padded tree count {Tpad} is not a multiple of "
                         f"tree_chunk={tc}")
    if C > MAX_CLASSES:
        raise ValueError(f"{C} classes; the kernel takes at most "
                         f"{MAX_CLASSES}")
    n_tc = Tpad // tc
    n_int = (1 << max_depth) - 1
    n_leaf = 1 << max_depth
    ops = list(ops)
    want = 3 + int(use_scale) + 1 + int(use_missing) + int(use_cat)
    if len(ops) != want:
        raise ValueError(f"{len(ops)} operands, expected {want}")
    feat, thr, leaf = ops[:3]
    rest = ops[3:]
    scale = rest.pop(0) if use_scale else None
    coh = rest.pop(0)
    dl = rest.pop(0) if use_missing else None
    cat = rest.pop(0) if use_cat else None
    dev = X.device
    _expect(feat, "feat", torch.int32, (n_tc, n_int * tc), dev)
    thr_w = (n_int + 1) // 2 if thr_packed else n_int
    _expect(thr, "thr", thr_dtype, (n_tc, thr_w * tc), dev)
    if leaf_dtype == "int4":
        _expect(leaf, "leaf", torch.uint8, (n_tc, (n_leaf + 1) // 2 * tc),
                dev)
    else:
        _expect(leaf, "leaf", torch.float16 if leaf_dtype == "float16"
                else torch.int8, (n_tc, n_leaf * tc), dev)
    if scale is not None:
        _expect(scale, "scale", torch.float32, (n_tc, tc), dev)
    _expect(coh, "cls_oh", torch.float32, (Tpad, C), dev)
    for m, name in ((dl, "dl"), (cat, "cat")):
        if m is not None:
            _expect(m, name, torch.int8, (n_tc, n_int * tc), dev)
    if cls is None:
        cls = coh.argmax(dim=1).to(torch.int32)
    _expect(cls, "cls", torch.int32, (Tpad,), dev)
    if max_feature is None:
        max_feature = int(feat.max())
    if max_feature >= F:
        raise ValueError(f"split feature {max_feature} is >= the data's "
                         f"{F} columns")
    out = torch.empty((R, C), dtype=torch.float32, device=dev)
    if R == 0:
        return out
    limit = _build.smem_limit(dev)
    sub = stage_width(tc, max_depth, F, leaf_dtype, thr_packed, limit)
    lib = _lib()

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = getattr(lib, entry)(
            X.data_ptr(), feat.data_ptr(), thr.data_ptr(), leaf.data_ptr(),
            ptr(scale), cls.data_ptr(), ptr(dl), ptr(cat), out.data_ptr(),
            R, F, Tpad, max_depth, tc, sub, C, missing_bin_value,
            int(use_missing), int(use_cat), mode_flag,
            float(learning_rate), float(base),
            smem_bytes(sub, max_depth, F, leaf_dtype, thr_packed), stream)
    _build.check(status, f"{entry} launch")
    return out


def lut_int8_cuda(ops: tuple, X: torch.Tensor, *, max_depth: int,
                  learning_rate: float, base: float, n_classes: int,
                  tree_chunk: int, n_trees_padded: int,
                  missing_bin_value: int, use_missing: bool, use_cat: bool,
                  use_scale: bool, cls=None,
                  max_feature: int | None = None) -> torch.Tensor:
    """K4: f32 [R, C] margins from lut_device_operands' tensors (fp16
    leaves, or int8 leaves with a per-tree scale when use_scale)."""
    global launches_lut
    leaf_dtype = "int8" if use_scale else "float16"
    out = _launch(
        "ddt_lut_int8", ops, X, leaf_dtype=leaf_dtype, thr_dtype=torch.int8,
        thr_packed=False, use_scale=use_scale, max_depth=max_depth,
        learning_rate=learning_rate, base=base, n_classes=n_classes,
        tree_chunk=tree_chunk, n_trees_padded=n_trees_padded,
        missing_bin_value=missing_bin_value, use_missing=use_missing,
        use_cat=use_cat, cls=cls, max_feature=max_feature,
        mode_flag=int(not use_scale))
    if X.shape[0]:
        launches_lut += 1
    return out


def lut_int4_cuda(ops: tuple, X: torch.Tensor, *, max_depth: int,
                  learning_rate: float, base: float, n_classes: int,
                  tree_chunk: int, n_trees_padded: int,
                  missing_bin_value: int, use_missing: bool, use_cat: bool,
                  thr_packed: bool, cls=None,
                  max_feature: int | None = None) -> torch.Tensor:
    """K5: f32 [R, C] margins from PackedTables.ops tensors (nibble
    leaves with a per-tree scale; nibble thresholds when thr_packed)."""
    global launches_lut4
    out = _launch(
        "ddt_lut_int4", ops, X, leaf_dtype="int4",
        thr_dtype=torch.uint8 if thr_packed else torch.int8,
        thr_packed=thr_packed, use_scale=True, max_depth=max_depth,
        learning_rate=learning_rate, base=base, n_classes=n_classes,
        tree_chunk=tree_chunk, n_trees_padded=n_trees_padded,
        missing_bin_value=missing_bin_value, use_missing=use_missing,
        use_cat=use_cat, cls=cls, max_feature=max_feature,
        mode_flag=int(thr_packed))
    if X.shape[0]:
        launches_lut4 += 1
    return out
