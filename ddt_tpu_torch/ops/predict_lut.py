"""TreeLUT-style quantized scoring tables and their two kernels' dispatch.

Port of ddt_tpu/ops/predict_lut.py. The host half is copied as numpy, bit
for bit, so the tables (and their npz round trip) are the same in both
packages:

- `quantize_compiled` turns a CompiledEnsemble into `QuantizedTables`:
  int8 thresholds recentred by -128 (exact: bin ids are integers in
  [0, 255], and a pushed-down leaf's +BIG clips to 255, which no uint8 bin
  exceeds, so it still always goes left), leaves as fp16, or as int8 /
  int4 integers with one f32 scale per tree, and `max_abs_err`, the
  computed bound lr * sum over trees of the tree's worst rounding error;
- `lut_device_operands` lays the int8 tier's tables out node-major,
  [n_tc, width * Tc] with element (chunk c, node n, tree t) at
  c * width * Tc + n * Tc + t;
- `QuantizedTables.pack_int4` makes the int4 tier's layout: leaf planes
  j and j + 2^(D-1) share a byte (low, high nibble, two's complement),
  and the thresholds join the nibble pack when every real threshold is
  <= 14 (nibble 15 is the always-left sentinel, decoded to 256).

Scoring. `predict_effective_lut_ops` (int8 tier, TPU kernel
`_lut_kernel`) and `predict_effective_lut4_ops` (int4 tier, `_lut4_kernel`)
take those operand tuples and binned uint8 rows, and dispatch on the rows'
device: CUDA tensors launch the hand-written kernels of csrc/lut.cu
(ops/predict_lut_cuda.py), CPU tensors run the plain versions here. The
plain versions decode the node-major operands back into pushed-down
arrays (int8 recentring, nibble pairs with sentinel 15 -> 256, leaf sign
extension, q * scale in f32 or f16 -> f32) and score them with
ops/predict.predict_effective_plain: the reference's parity contract,
"LUT equals the f32 path fed the dequantized tables", with the layout
itself under test.

Fits guards. The reference's `predict_lut_fits` / `predict_lut4_fits`
count TPU VMEM and Pallas trace size. Here they count the CUDA kernels'
shared memory: one tree's staged tables plus the block's rows against
the card's opt-in limit (the H100's 232,448 B when the backend runs on
the CPU, so the CPU resolves the tier the card would).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ddt_tpu_torch.ops import predict as predict_ops
from ddt_tpu_torch.ops import predict_lut_cuda
from ddt_tpu_torch.telemetry.annotations import op_scope
from ddt_tpu_torch.telemetry.costmodel import costed

#: int8 bin recentring offset: uint8 bins [0, 255] -> [-128, 127].
_I8_OFFSET = 128
#: largest real threshold a nibble can carry (15 is the always-left
#: sentinel: pack_int4's threshold-packability condition).
_NIB_THR_MAX = 14
#: what the sentinel nibble decodes to: 256 > every uint8 bin value, so
#: "bin > 256" is always false, the +BIG always-left contract.
_NIB_BIG = 256


@dataclasses.dataclass(frozen=True)
class QuantizedTables:
    """int8/fp16/int4 LUT scoring tables for one model version (host
    arrays; backends key their device copies on `token`)."""

    token: str                  # source CompiledEnsemble.token
    tree_chunk: int
    max_depth: int
    n_classes_out: int
    learning_rate: float
    base_score: float
    loss: str
    missing_bin_value: int      # raw (unrecentred) reserved-NaN bin, -1=off
    leaf_dtype: str             # "float16" | "int8" | "int4"
    max_abs_err: float          # documented |lut - f32| bound (module doc)
    eff_feat: np.ndarray        # int32 [Tpad, N] pushed-down features
    thr_i8: np.ndarray          # int8  [Tpad, N] recentred thresholds
    leaf_q: np.ndarray          # f16 [Tpad, 2^D] or int8 [Tpad, 2^D]
    leaf_scale: np.ndarray | None   # f32 [Tpad] per-tree scale (int8/int4)
    cls_oh: np.ndarray          # f32 [Tpad, C] round-major class one-hot
    eff_dl: np.ndarray | None   # bool [Tpad, N] or None
    eff_cat: np.ndarray | None  # bool [Tpad, N] or None

    @property
    def n_trees_padded(self) -> int:
        return int(self.eff_feat.shape[0])

    def arrays(self) -> tuple:
        """Logical table tuple (optional arrays appended when present)."""
        out = [self.eff_feat, self.thr_i8, self.leaf_q]
        if self.leaf_scale is not None:
            out.append(self.leaf_scale)
        out.append(self.cls_oh)
        if self.eff_dl is not None:
            out.append(self.eff_dl)
        if self.eff_cat is not None:
            out.append(self.eff_cat)
        return tuple(out)

    def dequantized(self) -> tuple[np.ndarray, np.ndarray]:
        """(eff_thr int32, bot_val f32) exactly as the kernels see them
        (dequantization is exact; module doc)."""
        thr = self.thr_i8.astype(np.int32) + _I8_OFFSET
        if self.leaf_scale is not None:
            val = (self.leaf_q.astype(np.float32)
                   * self.leaf_scale[:, None].astype(np.float32))
        else:
            val = self.leaf_q.astype(np.float32)
        return thr, val

    def pack_int4(self) -> "PackedTables":
        """The int4 tier's device layout, two nibbles per byte (module
        doc). Thresholds join the pack when every real threshold fits a
        nibble, else they keep the lossless int8 node-major form."""
        if self.leaf_dtype != "int4":
            raise ValueError(
                f"pack_int4 needs leaf_dtype='int4' tables, got "
                f"{self.leaf_dtype!r}; quantize with leaf_dtype='int4'")
        q = self
        tc = q.tree_chunk
        n_tc = q.n_trees_padded // tc
        n_int = (1 << q.max_depth) - 1
        n_leaves = 1 << q.max_depth
        # Packable iff every real threshold is <= 14; the clipped +BIG
        # (255) maps to the sentinel. Categorical nodes compare by
        # equality, so they get no 255 exemption: remapping a category id
        # to 256 would flip "bin == 255 goes left" into always-right.
        thr_raw = q.thr_i8[:, :n_int].astype(np.int32) + _I8_OFFSET
        ok = (thr_raw <= _NIB_THR_MAX) | (thr_raw >= 255)
        if q.eff_cat is not None:
            cat_nodes = (q.eff_cat[:, :n_int].astype(bool)
                         & (q.eff_feat[:, :n_int] >= 0))
            ok &= ~cat_nodes | (thr_raw <= _NIB_THR_MAX)
        thr_packed = bool(np.all(ok))
        if thr_packed:
            nib = np.where(thr_raw >= 255, 15, thr_raw).astype(np.uint8)
            h_n = (n_int + 1) // 2          # n_int = 2^D - 1 is odd
            # Pad the node axis with the sentinel so the halves pair up.
            nib = np.pad(nib, ((0, 0), (0, 2 * h_n - n_int)),
                         constant_values=15)
            thr_op = _pack_nibbles(
                _node_major(nib[:, :h_n], n_tc, tc, h_n, np.uint8),
                _node_major(nib[:, h_n:], n_tc, tc, h_n, np.uint8))
        else:
            thr_op = _node_major(q.thr_i8[:, :n_int], n_tc, tc, n_int,
                                 np.int8)
        # Leaves: int4 values in [-7, 7]; plane j pairs with j + h_l.
        h_l = (n_leaves + 1) // 2
        leaf = np.pad(q.leaf_q.astype(np.int16),
                      ((0, 0), (0, 2 * h_l - n_leaves)))
        leaf_op = _pack_nibbles(
            _node_major(leaf[:, :h_l] & 0xF, n_tc, tc, h_l, np.uint8),
            _node_major(leaf[:, h_l:] & 0xF, n_tc, tc, h_l, np.uint8))
        ops = [
            _node_major(q.eff_feat[:, :n_int], n_tc, tc, n_int, np.int32),
            thr_op,
            leaf_op,
            q.leaf_scale.reshape(n_tc, tc).astype(np.float32),
            np.asarray(q.cls_oh, np.float32),
        ]
        if q.eff_dl is not None:
            ops.append(_node_major(q.eff_dl[:, :n_int], n_tc, tc, n_int,
                                   np.int8))
        if q.eff_cat is not None:
            # Gated on eff_feat >= 0: pushed-down leaves stay always-left.
            cat_eff = (q.eff_cat[:, :n_int].astype(bool)
                       & (q.eff_feat[:, :n_int] >= 0))
            ops.append(_node_major(cat_eff, n_tc, tc, n_int, np.int8))
        return PackedTables(tables=q, thr_packed=thr_packed,
                            ops=tuple(ops))


@dataclasses.dataclass(frozen=True)
class PackedTables:
    """The int4 tier's bit-packed operand layout for one model version:
    node-major arrays in predict_effective_lut4_ops argument order.
    `tables` keeps the logical int4 tier (token, error bound)."""

    tables: QuantizedTables
    thr_packed: bool            # thresholds rode the nibble pack
    ops: tuple                  # node-major operand arrays

    @property
    def token(self) -> str:
        return self.tables.token

    @property
    def max_abs_err(self) -> float:
        return self.tables.max_abs_err

    def arrays(self) -> tuple:
        return self.ops

    def static_kwargs(self) -> dict:
        """predict_effective_lut4_ops' keyword arguments."""
        t = self.tables
        return dict(
            max_depth=t.max_depth, learning_rate=t.learning_rate,
            base=t.base_score, n_classes=t.n_classes_out,
            tree_chunk=t.tree_chunk, n_trees_padded=t.n_trees_padded,
            missing_bin_value=t.missing_bin_value,
            use_missing=t.eff_dl is not None,
            use_cat=t.eff_cat is not None,
            thr_packed=self.thr_packed,
        )


def _pack_nibbles(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Two uint8 nibble arrays -> one byte array (lo | hi << 4)."""
    return ((lo.astype(np.uint8) & 0xF)
            | ((hi.astype(np.uint8) & 0xF) << 4)).astype(np.uint8)


def quantize_compiled(ce, leaf_dtype: str = "float16") -> QuantizedTables:
    """CompiledEnsemble -> QuantizedTables (the rounding contract in the
    module doc). leaf_dtype "int4" keeps the 4-bit integers [-7, 7] in an
    int8 array; `pack_int4()` makes the two-nibbles-per-byte layout."""
    if leaf_dtype not in ("float16", "int8", "int4"):
        raise ValueError(
            f"leaf_dtype must be float16|int8|int4, got {leaf_dtype!r}")
    thr_i8 = (np.clip(ce.eff_thr, 0, 255) - _I8_OFFSET).astype(np.int8)
    bot = np.asarray(ce.bot_val, np.float32)
    if leaf_dtype == "float16":
        leaf_q = bot.astype(np.float16)
        leaf_scale = None
        deq = leaf_q.astype(np.float32)
    else:
        # One rounding step at both integer widths; only the grid changes.
        qmax = 7.0 if leaf_dtype == "int4" else 127.0
        max_abs = np.abs(bot).max(axis=1)                   # [Tpad]
        leaf_scale = np.where(max_abs > 0, max_abs / qmax,
                              1.0).astype(np.float32)
        leaf_q = np.clip(np.rint(bot / leaf_scale[:, None]),
                         -qmax, qmax).astype(np.int8)
        deq = leaf_q.astype(np.float32) * leaf_scale[:, None]
    # Each tree contributes one leaf per row: worst-node errors add up.
    per_tree = np.abs(bot - deq).max(axis=1)                # [Tpad]
    max_abs_err = float(ce.learning_rate * per_tree.sum())
    return QuantizedTables(
        token=ce.token, tree_chunk=ce.tree_chunk, max_depth=ce.max_depth,
        n_classes_out=ce.n_classes_out, learning_rate=ce.learning_rate,
        base_score=ce.base_score, loss=ce.loss,
        missing_bin_value=ce.missing_bin_value, leaf_dtype=leaf_dtype,
        max_abs_err=max_abs_err,
        eff_feat=np.asarray(ce.eff_feat, np.int32), thr_i8=thr_i8,
        leaf_q=leaf_q, leaf_scale=leaf_scale,
        cls_oh=np.asarray(ce.cls_oh, np.float32),
        eff_dl=ce.eff_dl, eff_cat=ce.eff_cat,
    )


def _node_major(a: np.ndarray, n_tc: int, tree_chunk: int, width: int,
                dtype) -> np.ndarray:
    """[Tpad, width] -> [n_tc, width*Tc], block n = node n of every tree
    in the chunk (host-side, once per model version)."""
    return (np.ascontiguousarray(
        np.asarray(a, dtype).reshape(n_tc, tree_chunk, width)
        .transpose(0, 2, 1)).reshape(n_tc, width * tree_chunk))


def lut_device_operands(tables: QuantizedTables) -> tuple:
    """The int8 tier's node-major operand tuple for one model version, in
    predict_effective_lut_ops argument order."""
    q = tables
    n_tc = q.n_trees_padded // q.tree_chunk
    n_int = (1 << q.max_depth) - 1
    n_leaves = 1 << q.max_depth
    ops = [
        _node_major(q.eff_feat[:, :n_int], n_tc, q.tree_chunk, n_int,
                    np.int32),
        _node_major(q.thr_i8[:, :n_int], n_tc, q.tree_chunk, n_int,
                    np.int8),
        _node_major(q.leaf_q, n_tc, q.tree_chunk, n_leaves,
                    np.float16 if q.leaf_scale is None else np.int8),
    ]
    if q.leaf_scale is not None:
        ops.append(q.leaf_scale.reshape(n_tc, q.tree_chunk)
                   .astype(np.float32))
    ops.append(np.asarray(q.cls_oh, np.float32))
    if q.eff_dl is not None:
        ops.append(_node_major(q.eff_dl[:, :n_int], n_tc, q.tree_chunk,
                               n_int, np.int8))
    if q.eff_cat is not None:
        # Gated on eff_feat >= 0: pushed-down leaves stay always-left.
        cat_eff = (q.eff_cat[:, :n_int].astype(bool)
                   & (q.eff_feat[:, :n_int] >= 0))
        ops.append(_node_major(cat_eff, n_tc, q.tree_chunk, n_int,
                               np.int8))
    return tuple(ops)


def lut_static_kwargs(tables: QuantizedTables) -> dict:
    """predict_effective_lut_ops' keyword arguments for `tables`."""
    t = tables
    return dict(
        max_depth=t.max_depth, learning_rate=t.learning_rate,
        base=t.base_score, n_classes=t.n_classes_out,
        tree_chunk=t.tree_chunk, n_trees_padded=t.n_trees_padded,
        missing_bin_value=t.missing_bin_value,
        use_missing=t.eff_dl is not None, use_cat=t.eff_cat is not None,
        use_scale=t.leaf_scale is not None,
    )


# --------------------------------------------------------------------- #
# npz round trip (the layout of ddt_tpu/export/aot.py, so tables carried
# by either package load in the other)
# --------------------------------------------------------------------- #

_TABLE_SCALARS = ("token", "tree_chunk", "max_depth", "n_classes_out",
                  "learning_rate", "base_score", "loss",
                  "missing_bin_value", "leaf_dtype", "max_abs_err")
_TABLE_ARRAYS = ("eff_feat", "thr_i8", "leaf_q", "leaf_scale", "cls_oh",
                 "eff_dl", "eff_cat")


def tables_to_arrays(tables: QuantizedTables) -> dict:
    """QuantizedTables -> npz-ready dict (None optionals become empty
    arrays; scalars ride as 0-d numpy)."""
    d = {}
    for k in _TABLE_SCALARS:
        v = getattr(tables, k)
        d[k] = np.bytes_(v.encode()) if isinstance(v, str) else np.asarray(v)
    for k in _TABLE_ARRAYS:
        v = getattr(tables, k)
        d[k] = np.zeros(0, np.int8) if v is None else np.asarray(v)
    return d


def tables_from_arrays(d: dict) -> QuantizedTables:
    """Inverse of tables_to_arrays (empty optionals back to None)."""
    kw = {}
    for k in _TABLE_SCALARS:
        v = d[k]
        if np.asarray(v).dtype.kind == "S":
            kw[k] = bytes(np.asarray(v).item()).decode()
        elif k in ("learning_rate", "base_score", "max_abs_err"):
            kw[k] = float(v)
        else:
            kw[k] = int(v)
    for k in _TABLE_ARRAYS:
        a = np.asarray(d[k])
        kw[k] = None if a.size == 0 and k != "cls_oh" else a
    return QuantizedTables(**kw)


# --------------------------------------------------------------------- #
# fits guards (shared memory of csrc/lut.cu)
# --------------------------------------------------------------------- #

def predict_lut_fits(n_trees_padded: int, tree_chunk: int, max_depth: int,
                     n_features: int, n_classes: int,
                     smem_limit: int = predict_lut_cuda.SMEM_LIMIT_H100,
                     leaf_dtype: str = "float16") -> bool:
    """Whether the int8-tier kernel takes this shape: whole tree chunks,
    at most MAX_CLASSES classes, and one tree's record beside a block's
    row within `smem_limit` bytes of shared memory (rows too wide for the
    rows mapping take the pairs mapping, as the reference's guard admits
    1024 features at depth 6)."""
    if n_trees_padded % tree_chunk or \
            n_classes > predict_lut_cuda.MAX_CLASSES:
        return False
    return predict_lut_cuda.min_smem(max_depth, n_features, leaf_dtype) \
        <= smem_limit - predict_lut_cuda.STATIC_SMEM


def predict_lut4_fits(n_trees_padded: int, tree_chunk: int, max_depth: int,
                      n_features: int, n_classes: int,
                      smem_limit: int = predict_lut_cuda.SMEM_LIMIT_H100,
                      thr_packed: bool = False) -> bool:
    """predict_lut_fits for the int4 tier's packed tables (the kernel
    decodes thresholds into its node words, so thr_packed does not change
    the count)."""
    if n_trees_padded % tree_chunk or \
            n_classes > predict_lut_cuda.MAX_CLASSES:
        return False
    return predict_lut_cuda.min_smem(max_depth, n_features, "int4") \
        <= smem_limit - predict_lut_cuda.STATIC_SMEM


# --------------------------------------------------------------------- #
# plain versions
# --------------------------------------------------------------------- #

def _from_node_major(a: torch.Tensor, tree_chunk: int,
                     width: int) -> torch.Tensor:
    """[n_tc, width*Tc] -> [Tpad, width] (inverse of _node_major)."""
    n_tc = a.shape[0]
    return (a.reshape(n_tc, width, tree_chunk).transpose(1, 2)
            .reshape(n_tc * tree_chunk, width))


def _decode_masks(rest: list, tree_chunk: int, n_int: int,
                  use_missing: bool, use_cat: bool):
    dl = rest.pop(0) if use_missing else None
    cat = rest.pop(0) if use_cat else None
    return (None if dl is None else
            _from_node_major(dl, tree_chunk, n_int).bool(),
            None if cat is None else
            _from_node_major(cat, tree_chunk, n_int).bool())


def _check_classes(cls_oh, n_trees_padded: int, n_classes: int) -> None:
    if tuple(cls_oh.shape) != (n_trees_padded, n_classes):
        raise ValueError(f"cls_oh is {tuple(cls_oh.shape)}, expected "
                         f"({n_trees_padded}, {n_classes})")


def predict_effective_lut_plain(ops, X, *, max_depth: int,
                                learning_rate: float, base: float,
                                n_classes: int, tree_chunk: int,
                                n_trees_padded: int, missing_bin_value: int,
                                use_missing: bool, use_cat: bool,
                                use_scale: bool) -> torch.Tensor:
    """Plain version of the int8 tier: f32 [R, C] margins from
    lut_device_operands' tuple (as tensors), with K4's keywords."""
    feat, thr, leaf, *rest = ops
    scale = rest.pop(0) if use_scale else None
    cls_oh = rest.pop(0)
    _check_classes(cls_oh, n_trees_padded, n_classes)
    n_int = (1 << max_depth) - 1
    eff_feat = _from_node_major(feat, tree_chunk, n_int)
    eff_thr = _from_node_major(thr, tree_chunk, n_int).to(torch.int32) \
        + _I8_OFFSET
    q = _from_node_major(leaf, tree_chunk, 1 << max_depth).to(torch.float32)
    bot = q if scale is None else q * scale.reshape(-1, 1)
    dl, cat = _decode_masks(rest, tree_chunk, n_int, use_missing, use_cat)
    return predict_ops.predict_effective_plain(
        eff_feat, eff_thr, bot, cls_oh, X, max_depth=max_depth,
        learning_rate=learning_rate, base=base, tree_chunk=tree_chunk,
        eff_dl=dl, missing_bin_value=missing_bin_value, eff_cat=cat)


def predict_effective_lut4_plain(ops, X, *, max_depth: int,
                                 learning_rate: float, base: float,
                                 n_classes: int, tree_chunk: int,
                                 n_trees_padded: int,
                                 missing_bin_value: int, use_missing: bool,
                                 use_cat: bool,
                                 thr_packed: bool) -> torch.Tensor:
    """Plain version of the int4 tier: f32 [R, C] margins from
    PackedTables.ops (as tensors), with K5's keywords."""
    feat, thr, leaf, scale, cls_oh, *rest = ops
    _check_classes(cls_oh, n_trees_padded, n_classes)
    n_int = (1 << max_depth) - 1
    n_leaves = 1 << max_depth
    eff_feat = _from_node_major(feat, tree_chunk, n_int)
    if thr_packed:
        t = _from_node_major(thr, tree_chunk, (n_int + 1) // 2) \
            .to(torch.int32)
        nib = torch.cat([t & 15, t >> 4], dim=1)[:, :n_int]
        eff_thr = torch.where(nib >= 15, _NIB_BIG, nib)
    else:
        eff_thr = _from_node_major(thr, tree_chunk, n_int) \
            .to(torch.int32) + _I8_OFFSET
    lp = _from_node_major(leaf, tree_chunk, (n_leaves + 1) // 2) \
        .to(torch.int32)
    v = torch.cat([lp & 15, (lp >> 4) & 15], dim=1)[:, :n_leaves]
    sext = torch.where(v >= 8, v - 16, v).to(torch.float32)
    bot = sext * scale.reshape(-1, 1)
    dl, cat = _decode_masks(rest, tree_chunk, n_int, use_missing, use_cat)
    return predict_ops.predict_effective_plain(
        eff_feat, eff_thr, bot, cls_oh, X, max_depth=max_depth,
        learning_rate=learning_rate, base=base, tree_chunk=tree_chunk,
        eff_dl=dl, missing_bin_value=missing_bin_value, eff_cat=cat)


# --------------------------------------------------------------------- #
# dispatchers
# --------------------------------------------------------------------- #

def _binned_rows(Xc) -> torch.Tensor:
    Xc = torch.as_tensor(Xc)
    if Xc.dtype.is_floating_point or Xc.dtype.is_complex \
            or Xc.dtype == torch.bool:
        raise ValueError(
            "the LUT kernel requires binned integer data; raw-threshold "
            "scoring has no quantized form")
    return Xc.to(torch.uint8).contiguous()


def _score(kernel, plain, ops, Xc, *, cls, max_feature,
           **kw) -> torch.Tensor:
    X = _binned_rows(Xc)
    C = kw["n_classes"]
    if X.shape[0] == 0:
        out = torch.full((0, C), kw["base"], dtype=torch.float32,
                         device=X.device)
    elif X.device.type == "cuda":
        out = kernel(ops, X, cls=cls, max_feature=max_feature, **kw)
    elif X.device.type == "cpu":
        out = plain(ops, X, **kw)
    else:
        raise TypeError(f"no LUT implementation for {X.device}")
    return out[:, 0] if C == 1 else out


def lut_cost(ops: tuple, Xc, *, max_depth: int, n_classes: int,
             n_trees_padded: int, use_scale: bool = False,
             **kw) -> tuple[int, int]:
    """(operations, bytes) of one int8- or int4-tier call
    (telemetry/costmodel): the rows read and the margins written once,
    every operand byte read once; a compare a level and one add per (row,
    tree), and one multiply more where leaves are scaled (every level
    counted: an upper bound)."""
    R, F = Xc.shape
    tables = sum(t.numel() * t.element_size() for t in ops)
    per = max_depth + 1 + (1 if use_scale else 0)
    return R * n_trees_padded * per, R * F + R * n_classes * 4 + tables


def lut4_cost(ops: tuple, Xc, **kw) -> tuple[int, int]:
    """lut_cost for the int4 tier (per-tree scales: one multiply)."""
    return lut_cost(ops, Xc, use_scale=True, **kw)


@costed("predict_lut", phase="predict", cost=lut_cost)
@op_scope("predict")
def predict_effective_lut_ops(ops: tuple, Xc, *, max_depth: int,
                              learning_rate: float, base: float,
                              n_classes: int, tree_chunk: int,
                              n_trees_padded: int, missing_bin_value: int,
                              use_missing: bool, use_cat: bool,
                              use_scale: bool, cls=None,
                              max_feature: int | None = None
                              ) -> torch.Tensor:
    """int8-tier scores [R] (one class) or [R, C] from node-major operand
    tensors: K4 (csrc/lut.cu) for CUDA rows, the plain version for CPU
    rows. `cls` (int32 class of each tree) and `max_feature` are what the
    kernel derives from the operands when not given; backends cache
    them."""
    return _score(predict_lut_cuda.lut_int8_cuda,
                  predict_effective_lut_plain, ops, Xc,
                  n_classes=n_classes, base=base, cls=cls,
                  max_feature=max_feature, max_depth=max_depth,
                  learning_rate=learning_rate, tree_chunk=tree_chunk,
                  n_trees_padded=n_trees_padded,
                  missing_bin_value=missing_bin_value,
                  use_missing=use_missing, use_cat=use_cat,
                  use_scale=use_scale)


@costed("predict_lut4", phase="predict", cost=lut4_cost)
@op_scope("predict")
def predict_effective_lut4_ops(ops: tuple, Xc, *, max_depth: int,
                               learning_rate: float, base: float,
                               n_classes: int, tree_chunk: int,
                               n_trees_padded: int, missing_bin_value: int,
                               use_missing: bool, use_cat: bool,
                               thr_packed: bool, cls=None,
                               max_feature: int | None = None
                               ) -> torch.Tensor:
    """int4-tier scores from PackedTables.ops tensors: K5 (csrc/lut.cu)
    for CUDA rows, the plain version for CPU rows."""
    return _score(predict_lut_cuda.lut_int4_cuda,
                  predict_effective_lut4_plain, ops, Xc,
                  n_classes=n_classes, base=base, cls=cls,
                  max_feature=max_feature, max_depth=max_depth,
                  learning_rate=learning_rate, tree_chunk=tree_chunk,
                  n_trees_padded=n_trees_padded,
                  missing_bin_value=missing_bin_value,
                  use_missing=use_missing, use_cat=use_cat,
                  thr_packed=thr_packed)


def _on(ops, X: torch.Tensor) -> tuple:
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(X.device)
                 for a in ops)


def predict_effective_lut(tables: QuantizedTables, Xc) -> torch.Tensor:
    """Standalone entry (tests, chip_smoke): builds the node-major
    operands on the rows' device and scores. Backends cache the operands
    instead (backends/cuda.py)."""
    X = _binned_rows(Xc)
    return predict_effective_lut_ops(
        _on(lut_device_operands(tables), X), X, **lut_static_kwargs(tables))


def predict_effective_lut4(packed, Xc) -> torch.Tensor:
    """Standalone entry of the int4 tier; packs int4 QuantizedTables on
    demand."""
    if isinstance(packed, QuantizedTables):
        packed = packed.pack_int4()
    X = _binned_rows(Xc)
    return predict_effective_lut4_ops(_on(packed.ops, X), X,
                                      **packed.static_kwargs())


class LutOperands(NamedTuple):
    """One model version's quantized tier on a device, as backends cache
    it: the operand tensors and the dispatcher's keyword arguments."""

    tier: str                   # "lut" (int8) | "lut4" (int4)
    ops: tuple
    static: dict

    def score(self, X: torch.Tensor) -> torch.Tensor:
        core = (predict_effective_lut4_ops if self.tier == "lut4"
                else predict_effective_lut_ops)
        return core(self.ops, X, **self.static)
