"""Histogram kernel wrapper (csrc/hist.cu): the Hopper counterpart of
ddt_tpu/ops/hist_pallas.py::_hist_kernel (K1, 255 bins) and
::_hist_kernel_t (K2, <= 128 bins), each in its f32 and its integer mode.

Modes, by the dtype of g and h (both the same) and `scales`: f32 g/h
with scales (f32 [2] powers of two on the card, ops/grad.fixed_scales)
sum each row's rint(g * 2^k) into the int64 histogram (`ddt_hist_fx`,
the exact mode every f32 training path runs); f32 g/h without scales sum
into f32 with float atomics (`ddt_hist_f32`, the yardstick it replaced);
int8 or int16 (quantized gradients) sum into the raw int32 histogram
(`ddt_hist_i8`, `ddt_hist_i16`). The exact and integer modes use integer
atomics, exact and order-free, so they equal their plain versions bit for
bit. Every mode adds into its output: the wrapper zeroes a new one, or
takes `out`, a table to accumulate into (the streamed level passes).

The byte bound is ~12.5 us a level at 1M x 28 on the H100 (Xb, the node
index, g and h read once); what sets the kernel's time is the card's rate
of shared-memory atomics, one per (row, feature) and channel. The design,
stated in full in the source: a thread reads a row once (node index
first, so a frozen row or a row of another node range costs 4 bytes) and
its bytes as 4-byte words; in exact mode each int64 add is a native
32-bit add on the low word and, on a carry or a negative value, one on the
high word; one 64-bit compare-and-swap adds g and h in f32 mode, two
native 32-bit adds in integer mode; each block's table (16 bytes a cell
in exact mode, 8 in the others, laid out as the output) is flushed with
TMA bulk
reductions into L2, not one global atomic per cell; the grid holds as
many blocks as the card runs at once. Tried on the card and not taken: a
thread-block cluster holding a level's table in distributed shared memory
(remote atomics cost more than the scans they save) and a packed 64-bit
integer atomic (a compare-and-swap loop on sm_90). The TPU kernels'
one-hot form on tensor cores was not taken: its shared-memory writes per
row cost ~20x the byte bound, and f32 would need TF32.

`plan_tiles` plays the role of hist_pallas.feature_chunks_for: it sizes the
feature slab and node-range widths from the card's real shared-memory
limit, so every shape the trainer produces runs as one launch; it raises
only if one feature of one node does not fit, which cannot happen at
<= 256 bins.

Xb may be a column slab of a wider row-major matrix, read in place: the
kernel takes the row stride (the slab-pipelined level loop of ops/grow
hands it such views). A launch may cover a node range of the level,
`node_lo` to `node_lo + n_nodes`: rows of other nodes add nothing and the
output holds the range's nodes only (the OOM ladder's node slabs,
ops/histogram.py).

The plain versions are ops/histogram.build_histograms_fixed_segment
(exact mode) and build_histograms_segment (the others);
ops/histogram.build_histograms_exact and build_histograms dispatch CUDA
tensors here and CPU tensors there. This wrapper never falls back: a CPU
tensor, a wrong dtype, a plan the card cannot hold or a failed launch
raises.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ddt_tpu_torch import _build
from ddt_tpu_torch.utils import launches as _launches

#: Kernel launches since the last reset (chip_smoke reads them around
#: each path), one count per mode: `launches_exact` for the exact mode,
#: `launches` for f32 g/h with float atomics, `launches_int` for
#: int8/int16. Counted only where the kernel is launched, and once per
#: replay of a captured round (utils/launches).
launches_exact = 0
launches = 0
launches_int = 0

# g/h dtype -> (C entry, mode for ddt_hist_max_blocks, output dtype,
# counter); the exact mode is _EXACT.
_MODES = {torch.float32: ("ddt_hist_f32", 0, torch.float32, "launches"),
          torch.int8: ("ddt_hist_i8", 1, torch.int32, "launches_int"),
          torch.int16: ("ddt_hist_i16", 2, torch.int32, "launches_int")}
_EXACT = ("ddt_hist_fx", 3, torch.int64, "launches_exact")

THREADS = 1024          # kernel block size (kThreads in csrc/hist.cu)
#: One (node, feature, bin): (g, h) as two f32 or two int32, or (exact
#: mode) two int64.
CELL_BYTES = 8
CELL_BYTES_EXACT = 16
_MAX_GRID_Y = 65_535
_argtypes_set = False
_max_blocks: dict = {}


@dataclasses.dataclass(frozen=True)
class TilePlan:
    fs: int             # features per slab
    nr: int             # nodes per block (one node range)
    n_slabs: int
    n_ranges: int
    smem_bytes: int     # dynamic shared memory per block

    @property
    def tiles(self) -> int:
        """Grid rows (y): one per (feature slab, node range)."""
        return self.n_slabs * self.n_ranges


def plan_tiles(n_nodes: int, n_features: int, n_bins: int,
               smem_limit: int, cell_bytes: int = CELL_BYTES) -> TilePlan:
    """Slab and node-range widths whose cells (`cell_bytes` each: 8, or 16
    in exact mode) fit `smem_limit` bytes a block: whole feature rows per
    node when one node's F x B table fits, as many nodes per range as then
    fit; otherwise the widest feature slab one node allows. Widths are
    balanced so that the last slab or range is not a sliver."""
    cell = n_bins * cell_bytes               # one (node, feature) in bytes
    if cell > smem_limit:
        raise ValueError(
            f"one feature of one node needs {cell} B of shared memory, "
            f"more than the card's {smem_limit} B (n_bins={n_bins})")
    per_node = n_features * cell
    if per_node <= smem_limit:
        fs = n_features
        nr = min(n_nodes, smem_limit // per_node)
    else:
        fs = smem_limit // cell
        nr = 1
    n_slabs = -(-n_features // fs)
    fs = -(-n_features // n_slabs)
    n_ranges = -(-n_nodes // nr)
    nr = -(-n_nodes // n_ranges)
    return TilePlan(fs, nr, n_slabs, n_ranges, nr * fs * cell)


def grid_blocks(n_rows: int, tiles: int, max_active: int) -> int:
    """Blocks along the rows: enough that the whole grid (`tiles` rows of
    them) fills the `max_active` blocks the card holds at once, but no
    more than give each block one row per thread."""
    fill = max(1, max_active // max(tiles, 1))
    return max(1, min(fill, -(-n_rows // THREADS)))


def _lib():
    global _argtypes_set
    lib = _build.library("hist")
    if not _argtypes_set:
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for entry, _, _, _ in (*_MODES.values(), _EXACT):
            fn = getattr(lib, entry)
            fn.argtypes = [vp, vp, vp, vp, vp, vp, i64, i64, i32, i32, i32,
                           i32, i32, i32, i32, i32, vp]
            fn.restype = i32
        lib.ddt_hist_max_blocks.argtypes = [i32, i32, ctypes.POINTER(i32)]
        lib.ddt_hist_max_blocks.restype = i32
        _argtypes_set = True
    return lib


def max_active_blocks(device: torch.device, mode: int,
                      smem_bytes: int) -> int:
    """Blocks with `smem_bytes` of shared memory each that the card holds
    at once (occupancy per SM x SMs). Raises when it is 0: the kernel
    could not run at that shape."""
    key = (device.index, mode, smem_bytes)
    if key not in _max_blocks:
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            _build.check(_lib().ddt_hist_max_blocks(
                mode, smem_bytes, ctypes.byref(out)),
                "hist kernel occupancy query")
        if out.value <= 0:
            raise RuntimeError(
                f"the card holds no histogram block with {smem_bytes} B of "
                "shared memory")
        _max_blocks[key] = int(out.value)
    return _max_blocks[key]


def _check_operands(Xb, g, h, node_index, n_nodes, n_bins, scales,
                    node_lo=0):
    if g.dtype not in _MODES:
        raise TypeError(f"g must be float32, int8 or int16, got {g.dtype}")
    if scales is not None and g.dtype != torch.float32:
        raise TypeError(f"the exact mode takes float32 g/h, got {g.dtype}")
    ops = [("Xb", Xb, torch.uint8), ("g", g, g.dtype), ("h", h, g.dtype),
           ("node_index", node_index, torch.int32)]
    if scales is not None:
        ops.append(("scales", scales, torch.float32))
    for name, t, dt in ops:
        if t.device.type != "cuda":
            raise TypeError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != Xb.device:
            raise ValueError(f"{name} is on {t.device}, Xb on {Xb.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t is not Xb and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if scales is not None and scales.shape != (2,):
        raise ValueError(f"scales must be [2], got {tuple(scales.shape)}")
    if Xb.dim() != 2 or (Xb.shape[1] > 1 and Xb.stride(1) != 1) \
            or (Xb.shape[0] > 1 and Xb.stride(0) < Xb.shape[1]):
        raise ValueError("Xb must be row-major [R, F] with unit column "
                         f"stride, got strides {tuple(Xb.stride())}")
    R = Xb.shape[0]
    if g.shape != (R,) or h.shape != (R,) or node_index.shape != (R,):
        raise ValueError("g, h and node_index must be [R] with R = Xb rows")
    if not 1 <= n_bins <= 256:
        raise ValueError(f"n_bins must be in [1, 256], got {n_bins}")
    if n_nodes < 0:
        raise ValueError(f"n_nodes must be >= 0, got {n_nodes}")
    if not 0 <= node_lo < 2 ** 30:
        raise ValueError(f"node_lo must be in [0, 2^30), got {node_lo}")


def build_histograms_cuda(Xb: torch.Tensor, g: torch.Tensor,
                          h: torch.Tensor, node_index: torch.Tensor,
                          n_nodes: int, n_bins: int,
                          scales: torch.Tensor | None = None,
                          out: torch.Tensor | None = None,
                          node_lo: int = 0) -> torch.Tensor:
    """[n_nodes, F, n_bins, 2] on Xb's card: int64 fixed point for f32 g/h
    with `scales` (the exact mode), f32 for f32 g/h without, int32 for
    int8/int16 g/h. Xb uint8 [R, F] row-major (contiguous, or a column
    slab of a wider matrix: its row stride is passed on), g and h [R] of
    one of those dtypes (the same for both), node_index int32 [R] (-1 =
    frozen), scales f32 [2], contiguous; all CUDA tensors on one device.
    With `out` (contiguous, that shape and dtype) the sums are added into
    it and it is returned. The table holds the level's nodes [node_lo,
    node_lo + n_nodes): node node_lo + i at i, rows of other nodes left
    out."""
    _check_operands(Xb, g, h, node_index, n_nodes, n_bins, scales, node_lo)
    entry, mode, out_dtype, counter = (_EXACT if scales is not None
                                       else _MODES[g.dtype])
    R, F = Xb.shape
    shape = (n_nodes, F, n_bins, 2)
    if out is None:
        out = torch.zeros(shape, dtype=out_dtype, device=Xb.device)
    elif (tuple(out.shape) != shape or out.dtype != out_dtype
          or out.device != Xb.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {out_dtype} {shape} on "
                         f"{Xb.device}, got {out.dtype} "
                         f"{tuple(out.shape)} on {out.device}")
    if R == 0 or F == 0 or n_nodes == 0:
        return out
    plan = plan_tiles(n_nodes, F, n_bins, _build.smem_limit(Xb.device),
                      CELL_BYTES_EXACT if scales is not None
                      else CELL_BYTES)
    if plan.tiles > _MAX_GRID_Y:
        raise ValueError(f"{plan.tiles} tiles exceed the grid's y limit")
    blocks_x = grid_blocks(
        R, plan.tiles, max_active_blocks(Xb.device, mode, plan.smem_bytes))
    lib = _lib()
    with torch.cuda.device(Xb.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = getattr(lib, entry)(
            Xb.data_ptr(), g.data_ptr(), h.data_ptr(), node_index.data_ptr(),
            None if scales is None else scales.data_ptr(), out.data_ptr(),
            R, Xb.stride(0) if R > 1 else F, F, n_bins, n_nodes, node_lo,
            plan.fs, plan.nr, blocks_x, plan.smem_bytes, stream)
    _build.check(status, f"hist kernel launch ({entry})")
    _launches.count(__name__, counter)
    return out
