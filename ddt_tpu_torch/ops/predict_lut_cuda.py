"""LUT kernel wrappers (csrc/lut.cu): the Hopper counterparts of
ddt_tpu/ops/predict_lut.py::_lut_kernel (K4, the int8 tier) and
::_lut4_kernel (K5, the int4 tier). The record layout, its packing
(`node_words`, `assemble_records`) and the launch plan are shared with the
f32 traversal kernel (K3, ops/predict_cuda), which is the same template
with f32 leaves.

Both take the reference's node-major operand tuples unchanged
(ops/predict_lut.lut_device_operands, PackedTables.ops) and raw uint8
rows, and write f32 [R, C] = base + lr * sum over tree chunks of the
per-class chunk sums of the selected leaf values.

Once per model (per operand tuple, cached while its tensors live and are
not written to) `pack_records` repacks the operands into one tree-major
record a tree: a 32-bit word per internal node (feature, decoded
threshold, default-left and categorical bits), the tree's class and
scale, then its leaves at their own width. Trailing trees whose leaves
are all zero (CompiledEnsemble's padding) are left out; they would add
+0.0 to every sum. `plan_launch`, a cached pure function of the shapes,
picks the kernel's mapping (one thread a row for large batches, (row,
tree) pairs over threads for small ones), the rows a block, the trees
staged a pass and the shared memory. The design and the bound are stated
in the source.

The plain versions are ops/predict_lut.predict_effective_lut_plain and
predict_effective_lut4_plain; ops/predict_lut's dispatchers send CUDA
tensors here and CPU tensors there. These wrappers never fall back: a CPU
tensor, a shape whose tables do not fit shared memory, or a failed launch
raises.
"""

from __future__ import annotations

import ctypes
import functools
import threading
import weakref
from typing import NamedTuple

import torch

from ddt_tpu_torch import _build
from ddt_tpu_torch.utils import launches as _launches

#: Kernel launches since the last reset (chip_smoke reads them around
#: the serve phase). Counted only where a kernel is launched.
launches_lut = 0
launches_lut4 = 0

THREADS = 256           # threads a block
#: Rows mapping: rows a thread walks side by side, most first; the last
#: (one) always fits where the fits guards admit the shape.
ROWS_PER_THREAD = (2, 1)
MAX_CLASSES = 32
#: The H100's opt-in shared memory per block: what the fits guards count
#: against when the scoring device is the CPU.
SMEM_LIMIT_H100 = 232_448
#: Resident blocks an SM holds at most (2048 threads of THREADS each), and
#: the shared memory the system keeps per block.
MAX_BLOCKS_PER_SM = 2048 // THREADS
SMEM_PER_BLOCK_RESERVED = 1024
#: Rows mapping, when the trees take several passes anyway: passes sized
#: so that this many blocks share an SM (their warps hide the descent's
#: latency), but of at least MIN_PASS_TREES trees.
PASS_BLOCKS_PER_SM = 4
MIN_PASS_TREES = 64
#: Pairs mapping, when no block size lets one wave of blocks hold the
#: batch: blocks an SM (their warps hide the descent's latency), each
#: staging the trees in passes sized for its share.
PAIRS_BLOCKS_PER_SM = 2
#: Pairs mapping: rows a block from which a batch is split over more
#: blocks than PAIRS_BLOCKS_PER_SM an SM (where they fit).
PAIRS_SPLIT_ROWS = 32
#: Static shared memory of either kernel (the TMA copies' mbarrier): the
#: dynamic shared memory may take the opt-in limit less this.
STATIC_SMEM = 16
_argtypes_set = False


def record_bytes(max_depth: int, leaf_dtype: str) -> int:
    """Bytes of one packed tree: a word per internal node, class and scale
    words, the leaves at their width (float32 for K3, float16, int8 or
    int4 for K4/K5), padded to 16 bytes."""
    n_int = (1 << max_depth) - 1
    n_leaf = 1 << max_depth
    leaf_w = {"float32": 4 * n_leaf, "float16": 2 * n_leaf, "int8": n_leaf,
              "int4": (n_leaf + 1) // 2}[leaf_dtype]
    return -(-(4 * (n_int + 2) + leaf_w) // 16) * 16


def smem_bytes(sub: int, max_depth: int, n_features: int,
               leaf_dtype: str, rows: int = THREADS) -> int:
    """Dynamic shared memory of a rows-mapping block staging `sub` trees
    beside its `rows` rows. With one row a thread (THREADS rows) it is
    the least the rows mapping needs."""
    return sub * record_bytes(max_depth, leaf_dtype) + n_features * rows


def _pairs_smem(sub: int, rows: int, tb: int, n_features: int) -> int:
    return sub * (tb + 4 * rows) + rows * n_features


def min_smem(max_depth: int, n_features: int, leaf_dtype: str) -> int:
    """The least dynamic shared memory any launch of this shape needs: one
    tree record beside a pairs block of one row (what the fits guards
    count; plan_launch raises only past it)."""
    return _pairs_smem(1, 1, record_bytes(max_depth, leaf_dtype),
                       n_features)


class Plan(NamedTuple):
    """One launch's shape: `pairs` takes the (row, tree) mapping."""

    pairs: bool
    rows: int           # rows a block
    blocks: int
    sub: int            # trees staged a pass
    smem: int           # dynamic shared memory, bytes


@functools.lru_cache(maxsize=4096)
def plan_launch(n_rows: int, n_trees: int, max_depth: int, n_features: int,
                leaf_dtype: str, n_classes: int, smem_limit: int,
                sm_count: int) -> Plan:
    """The launch of n_rows rows over n_trees packed trees on a card with
    `sm_count` SMs and `smem_limit` bytes of opt-in shared memory a block.

    The rows mapping (two rows a thread where 512 rows fit beside a tree,
    else one) is taken once the batch gives every SM one of its blocks;
    it stages as many trees a pass as fit, except that where it takes
    several passes anyway they are sized so that PASS_BLOCKS_PER_SM
    blocks share an SM (at least MIN_PASS_TREES trees). Below that the
    pairs mapping, with at least enough rows a block to give each thread
    one (row, tree) pair and at most THREADS // n_classes (one summing
    thread a row and class): the fewest rows a block, from those that
    PAIRS_BLOCKS_PER_SM blocks an SM would take (or PAIRS_SPLIT_ROWS, where
    that is fewer), at which the batch fits one wave of blocks, as many an
    SM as their shared memory allows, each staging as many trees a pass
    as fit; where no block size gives such a wave, PAIRS_BLOCKS_PER_SM
    blocks an SM with passes sized for that share.

    Rows too wide for a block of one row a thread (1024 features at
    depth 6: BASELINE config 5) take the pairs mapping at every batch
    size, whatever the leaf kind. Raises ValueError only when one tree
    record beside a pairs block of one row does not fit."""
    smem_limit -= STATIC_SMEM
    tb = record_bytes(max_depth, leaf_dtype)
    T = max(n_trees, 1)
    need = min_smem(max_depth, n_features, leaf_dtype)
    if need > smem_limit:
        raise ValueError(
            f"one depth-{max_depth} {leaf_dtype} tree record ({tb} B) "
            f"beside a block's row of {n_features} features needs {need} B "
            f"of shared memory, more than the card's {smem_limit} B")

    per_block = STATIC_SMEM + SMEM_PER_BLOCK_RESERVED

    def share(k: int) -> int:
        """Dynamic shared memory a block may take when k share an SM: the
        SM holds the opt-in limit plus one block's reserve, and each block
        takes its dynamic bytes, the static ones and the reserve."""
        return (smem_limit + per_block) // k - per_block

    rb = next((h * THREADS for h in ROWS_PER_THREAD
               if smem_bytes(1, max_depth, n_features, leaf_dtype,
                             h * THREADS) <= smem_limit), None)
    if rb is not None and n_rows >= sm_count * rb:
        sub = min(T, (smem_limit - n_features * rb) // tb)
        if sub < T:
            shared = (share(PASS_BLOCKS_PER_SM) - n_features * rb) // tb
            sub = min(sub, max(shared, MIN_PASS_TREES))
        return Plan(False, rb, -(-n_rows // rb), sub,
                    smem_bytes(sub, max_depth, n_features, leaf_dtype, rb))
    # Pairs: the fewest rows a block at which one wave of blocks, as many
    # an SM as their shared memory allows, holds the batch, each block
    # staging as many trees a pass as fit. The search starts at the rows
    # that PAIRS_BLOCKS_PER_SM blocks an SM would take, or at
    # PAIRS_SPLIT_ROWS where that is more: every block copies every tree,
    # so a small batch goes to few blocks, and more blocks an SM pay only
    # once each has many rows to walk.
    cap = max(1, min(n_rows, THREADS // n_classes))
    lo = min(-(-THREADS // T), cap)
    spread = -(-n_rows // (PAIRS_BLOCKS_PER_SM * sm_count))
    for rows in range(min(cap, max(lo, min(spread, PAIRS_SPLIT_ROWS))),
                      cap + 1):
        sub = min(T, (smem_limit - rows * n_features) // (tb + 4 * rows))
        if sub < 1:
            break
        smem = _pairs_smem(sub, rows, tb, n_features)
        per_sm = min(MAX_BLOCKS_PER_SM,
                     (smem_limit + per_block) // (smem + per_block))
        if -(-n_rows // rows) <= per_sm * sm_count:
            return Plan(True, rows, -(-n_rows // rows), sub, smem)
    # No such wave: PAIRS_BLOCKS_PER_SM blocks an SM, passes sized for
    # their share of it.
    rows = min(cap, max(lo, spread))
    budget = share(PAIRS_BLOCKS_PER_SM)
    while rows > 1 and _pairs_smem(1, rows, tb, n_features) > budget:
        rows //= 2
    if _pairs_smem(1, rows, tb, n_features) > budget:
        budget = smem_limit         # one block an SM
    sub = min(T, (budget - rows * n_features) // (tb + 4 * rows))
    return Plan(True, rows, -(-n_rows // rows), sub,
                _pairs_smem(sub, rows, tb, n_features))


class Records(NamedTuple):
    """One model's packed trees on its device (csrc/lut.cu's layout)."""

    rec: torch.Tensor       # uint8 [n_trees, record_bytes]
    n_trees: int            # trees packed: trailing all-zero ones left out
    max_feature: int        # largest split feature (-1: no split at all)


def node_words(f: torch.Tensor, t: torch.Tensor, dl=None,
               cat=None) -> torch.Tensor:
    """int32 [T, n_int] node words from tree-major int32 features and
    thresholds (dl / cat: nonzero where set, or None): the threshold
    clamped to [-1, 256] and stored + 1 in bits 0-8 (a uint8 bin routes
    the same against any threshold beyond that range), default-left bit
    9, categorical bit 10 on real splits only, the feature in bits
    16-31."""
    word = f * 65536 + t.clamp(-1, 256) + 1
    if dl is not None:
        word += dl.ne(0).to(torch.int32) * 512
    if cat is not None:
        word += (cat.ne(0) & (f >= 0)).to(torch.int32) * 1024
    return word


def assemble_records(word: torch.Tensor, cls: torch.Tensor,
                     scale: torch.Tensor, leaves: torch.Tensor,
                     zero: torch.Tensor, max_depth: int,
                     leaf_dtype: str) -> Records:
    """Tree-major records from each tree's node words [T, n_int], class
    [T], f32 scale [T], leaf bytes uint8 [T, .] and which leaves decode to
    zero [T, n_leaf]: trailing trees whose every leaf is zero (and whose
    scale is finite) are left out."""
    T = word.shape[0]
    head = torch.cat([word, cls.reshape(T, 1).to(torch.int32),
                      scale.view(torch.int32).reshape(T, 1)], dim=1)
    nonzero = ~zero.all(dim=1) | ~torch.isfinite(scale)
    idx = torch.nonzero(nonzero).flatten()
    n_trees = int(idx.max()) + 1 if idx.numel() else 0
    tb = record_bytes(max_depth, leaf_dtype)
    body = torch.cat([head.contiguous().view(torch.uint8), leaves], dim=1)
    rec = torch.zeros((n_trees, tb), dtype=torch.uint8, device=word.device)
    rec[:, :body.shape[1]] = body[:n_trees]
    f = word >> 16
    return Records(rec=rec, n_trees=n_trees,
                   max_feature=int(f.max()) if f.numel() else -1)


def pack_records(ops: tuple, *, leaf_dtype: str, thr_packed: bool,
                 max_depth: int, tree_chunk: int, use_missing: bool,
                 use_cat: bool, cls=None) -> Records:
    """The node-major operand tuple of either tier (feat, thr, leaf,
    [scale], cls_oh, [dl], [cat]; scale present for int8 and int4 leaves)
    -> tree-major records, on the operands' device. Bit operations only:
    the same on the CPU and the card."""
    # ops/predict_lut owns the node-major layout and the decodings (it
    # imports this module, so the import waits for the call).
    from ddt_tpu_torch.ops.predict_lut import (_I8_OFFSET, _NIB_BIG,
                                               _from_node_major)

    n_int = (1 << max_depth) - 1
    n_leaf = 1 << max_depth
    h_n, h_l = (n_int + 1) // 2, (n_leaf + 1) // 2
    tc = tree_chunk
    feat, thr, leaf, *rest = ops
    scale = rest.pop(0) if leaf_dtype != "float16" else None
    coh = rest.pop(0)
    dl = rest.pop(0) if use_missing else None
    cat = rest.pop(0) if use_cat else None
    dev = feat.device
    f = _from_node_major(feat, tc, n_int).to(torch.int32)
    if thr_packed:
        t = _from_node_major(thr, tc, h_n).to(torch.int32)
        nib = torch.cat([t & 15, t >> 4], dim=1)[:, :n_int]
        t = torch.where(nib >= 15, _NIB_BIG, nib)
    else:
        t = _from_node_major(thr, tc, n_int).to(torch.int32) + _I8_OFFSET
    word = node_words(
        f, t, dl=None if dl is None else _from_node_major(dl, tc, n_int),
        cat=None if cat is None else _from_node_major(cat, tc, n_int))
    if cls is None:
        cls = coh.argmax(dim=1)
    T = f.shape[0]
    sc = (torch.ones(T, dtype=torch.float32, device=dev) if scale is None
          else scale.reshape(T).to(torch.float32))
    if leaf_dtype == "int4":
        lp = _from_node_major(leaf, tc, h_l).to(torch.int32)
        v = torch.cat([lp & 15, (lp >> 4) & 15], dim=1)[:, :n_leaf]
        zero = v == 0
        if n_leaf % 2:
            v = torch.cat([v, torch.zeros_like(v[:, :1])], dim=1)
        leaf_b = (v[:, 0::2] | (v[:, 1::2] << 4)).to(torch.uint8)
    else:
        lv = _from_node_major(leaf, tc, n_leaf).contiguous()
        if leaf_dtype == "float16":
            zero = (lv.view(torch.int16).to(torch.int32) & 0x7FFF) == 0
        else:
            zero = lv == 0
        leaf_b = lv.view(torch.uint8)
    return assemble_records(word, cls, sc, leaf_b, zero, max_depth,
                            leaf_dtype)


class _Entry(NamedTuple):
    refs: tuple
    versions: tuple
    static: tuple
    records: Records


_cache: dict[int, _Entry] = {}
_cache_lock = threading.Lock()


def records_for(ops: tuple, *, leaf_dtype: str, thr_packed: bool,
                max_depth: int, tree_chunk: int, use_missing: bool,
                use_cat: bool, cls=None, check=None) -> Records:
    """pack_records, once per operand tuple: cached while its tensors live
    and none of them is written to (their version counters). `check()`,
    when given, runs before a tuple is packed."""
    tensors = tuple(ops) + ((cls,) if cls is not None else ())
    static = (leaf_dtype, thr_packed, max_depth, tree_chunk, use_missing,
              use_cat, cls is not None)
    key = id(tensors[0])
    with _cache_lock:
        hit = _cache.get(key)
    if (hit is not None and hit.static == static
            and len(hit.refs) == len(tensors)
            and all(r() is t for r, t in zip(hit.refs, tensors))
            and hit.versions == tuple(t._version for t in tensors)):
        return hit.records
    if check is not None:
        check()
    records = pack_records(ops, leaf_dtype=leaf_dtype, thr_packed=thr_packed,
                           max_depth=max_depth, tree_chunk=tree_chunk,
                           use_missing=use_missing, use_cat=use_cat, cls=cls)
    entry = _Entry(tuple(weakref.ref(t) for t in tensors),
                   tuple(t._version for t in tensors), static, records)
    with _cache_lock:
        fresh = key not in _cache
        _cache[key] = entry
    if fresh:
        weakref.finalize(tensors[0], _forget, key)
    return records


def _forget(key: int) -> None:
    with _cache_lock:
        _cache.pop(key, None)


def sm_count(device: torch.device) -> int:
    """The card's SM count (torch caches the device properties)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def library():
    """csrc/lut.cu's library, its entry points' argument types set (K3's
    ddt_traverse_f32 included)."""
    global _argtypes_set
    lib = _build.library("lut")
    if not _argtypes_set:
        vp, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_longlong, ctypes.c_float)
        common = [vp, vp, vp, i64] + [i32] * 11
        lib.ddt_lut_int8.argtypes = common + [i32, f32, f32, i32, vp]
        lib.ddt_lut_int4.argtypes = common + [f32, f32, i32, vp]
        lib.ddt_traverse_f32.argtypes = common + [f32, f32, i32, vp]
        lib.ddt_lut_empty.argtypes = [vp]
        for fn in (lib.ddt_lut_int8, lib.ddt_lut_int4, lib.ddt_traverse_f32,
                   lib.ddt_lut_empty):
            fn.restype = i32
        _argtypes_set = True
    return lib


def empty_launch(device: torch.device) -> None:
    """Launches csrc/lut.cu's empty kernel on the current stream: the
    latency floor of one launch (chip_smoke times it; not counted)."""
    lib = library()
    with torch.cuda.device(device):
        status = lib.ddt_lut_empty(torch.cuda.current_stream().cuda_stream)
    _build.check(status, "ddt_lut_empty launch")


def _expect(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, X on {device}")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise TypeError(f"{name} must be {dtype} {tuple(shape)}, got "
                        f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise TypeError(f"{name} must be contiguous")


def _check_operands(ops: tuple, dev, *, leaf_dtype: str, thr_dtype,
                    thr_packed: bool, use_scale: bool, max_depth: int,
                    n_classes: int, tree_chunk: int, n_trees_padded: int,
                    use_missing: bool, use_cat: bool, cls) -> None:
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
    want = 3 + int(use_scale) + 1 + int(use_missing) + int(use_cat)
    if len(ops) != want:
        raise ValueError(f"{len(ops)} operands, expected {want}")
    feat, thr, leaf, *rest = ops
    scale = rest.pop(0) if use_scale else None
    coh = rest.pop(0)
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
    for m, name in zip(rest, ("dl",) * use_missing + ("cat",) * use_cat):
        _expect(m, name, torch.int8, (n_tc, n_int * tc), dev)
    if cls is not None:
        _expect(cls, "cls", torch.int32, (Tpad,), dev)


def _launch(entry: str, ops: tuple, X: torch.Tensor, *, leaf_dtype: str,
            thr_dtype, thr_packed: bool, use_scale: bool, max_depth: int,
            learning_rate: float, base: float, n_classes: int,
            tree_chunk: int, n_trees_padded: int, missing_bin_value: int,
            use_missing: bool, use_cat: bool, cls) -> torch.Tensor:
    if X.device.type != "cuda":
        raise TypeError(f"X must be a CUDA tensor, got {X.device}")
    if X.dtype != torch.uint8 or X.dim() != 2 or not X.is_contiguous():
        raise TypeError("X must be a contiguous uint8 [R, F] tensor")
    R, F = X.shape
    dev = X.device
    if ops[0].device != dev:
        raise ValueError(f"feat on {ops[0].device}, X on {dev}")
    kw = dict(leaf_dtype=leaf_dtype, thr_packed=thr_packed,
              max_depth=max_depth, tree_chunk=tree_chunk,
              use_missing=use_missing, use_cat=use_cat)
    records = records_for(ops, cls=cls, check=lambda: _check_operands(
        ops, dev, thr_dtype=thr_dtype, use_scale=use_scale,
        n_classes=n_classes, n_trees_padded=n_trees_padded, cls=cls, **kw),
        **kw)
    if records.max_feature >= F:
        raise ValueError(f"split feature {records.max_feature} is >= the "
                         f"data's {F} columns")
    out = torch.empty((R, n_classes), dtype=torch.float32, device=dev)
    if R == 0:
        return out
    plan = plan_launch(R, records.n_trees, max_depth, F, leaf_dtype,
                       n_classes, _build.smem_limit(dev), sm_count(dev))
    lib = library()
    args = [X.data_ptr(), records.rec.data_ptr(), out.data_ptr(), R, F,
            records.n_trees, max_depth, tree_chunk,
            record_bytes(max_depth, leaf_dtype) // 4, n_classes,
            missing_bin_value if use_missing else -1,
            int(use_missing or use_cat), int(plan.pairs), plan.rows,
            plan.sub]
    if entry == "ddt_lut_int8":
        args.append(int(leaf_dtype == "float16"))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = getattr(lib, entry)(*args, float(learning_rate),
                                     float(base), plan.smem, stream)
    _build.check(status, f"{entry} launch")
    return out


def lut_int8_cuda(ops: tuple, X: torch.Tensor, *, max_depth: int,
                  learning_rate: float, base: float, n_classes: int,
                  tree_chunk: int, n_trees_padded: int,
                  missing_bin_value: int, use_missing: bool, use_cat: bool,
                  use_scale: bool, cls=None,
                  max_feature: int | None = None) -> torch.Tensor:
    """K4: f32 [R, C] margins from lut_device_operands' tensors (fp16
    leaves, or int8 leaves with a per-tree scale when use_scale). `cls`
    (int32 class of each tree) is derived from cls_oh when not given;
    `max_feature` is accepted from callers that cache it, and the packed
    records carry their own."""
    out = _launch(
        "ddt_lut_int8", ops, X,
        leaf_dtype="int8" if use_scale else "float16", thr_dtype=torch.int8,
        thr_packed=False, use_scale=use_scale, max_depth=max_depth,
        learning_rate=learning_rate, base=base, n_classes=n_classes,
        tree_chunk=tree_chunk, n_trees_padded=n_trees_padded,
        missing_bin_value=missing_bin_value, use_missing=use_missing,
        use_cat=use_cat, cls=cls)
    if X.shape[0]:
        _launches.count(__name__, "launches_lut")
    return out


def lut_int4_cuda(ops: tuple, X: torch.Tensor, *, max_depth: int,
                  learning_rate: float, base: float, n_classes: int,
                  tree_chunk: int, n_trees_padded: int,
                  missing_bin_value: int, use_missing: bool, use_cat: bool,
                  thr_packed: bool, cls=None,
                  max_feature: int | None = None) -> torch.Tensor:
    """K5: f32 [R, C] margins from PackedTables.ops tensors (nibble
    leaves with a per-tree scale; nibble thresholds when thr_packed)."""
    out = _launch(
        "ddt_lut_int4", ops, X, leaf_dtype="int4",
        thr_dtype=torch.uint8 if thr_packed else torch.int8,
        thr_packed=thr_packed, use_scale=True, max_depth=max_depth,
        learning_rate=learning_rate, base=base, n_classes=n_classes,
        tree_chunk=tree_chunk, n_trees_padded=n_trees_padded,
        missing_bin_value=missing_bin_value, use_missing=use_missing,
        use_cat=use_cat, cls=cls)
    if X.shape[0]:
        _launches.count(__name__, "launches_lut4")
    return out
