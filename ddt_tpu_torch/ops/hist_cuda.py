"""Histogram kernel wrapper (csrc/hist.cu): the Hopper counterpart of
ddt_tpu/ops/hist_pallas.py::_hist_kernel (K1, 255 bins) and
::_hist_kernel_t (K2, <= 128 bins), each in its f32 and its integer mode.

Modes, by the dtype of g and h (both the same): f32 sums into f32
(`ddt_hist_f32`); int8 or int16 (quantized gradients) sum into the raw
int32 histogram (`ddt_hist_i8`, `ddt_hist_i16`) with integer atomics,
which are exact and order-free, so that mode equals the plain version bit
for bit.

The byte bound is ~12.5 us a level at 1M x 28 on the H100 (Xb, the node
index, g and h read once); what sets the kernel's time is the card's rate
of shared-memory atomics, one per (row, feature) and channel. The design,
stated in full in the source: a thread reads a row once (node index
first, so a frozen row or a row of another node range costs 4 bytes) and
its bytes as 4-byte words; one 64-bit compare-and-swap adds g and h in f32
mode, two native 32-bit adds in integer mode; each block's table (8 bytes
a cell in both modes, laid out as the output) is flushed with TMA bulk
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
hands it such views).

The plain version of the same function is ops/histogram.
build_histograms_segment; ops/histogram.build_histograms dispatches CUDA
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
#: each path), one count per mode: `launches` for f32 g/h, `launches_int`
#: for int8/int16. Counted only where the kernel is launched, and once
#: per replay of a captured round (utils/launches).
launches = 0
launches_int = 0

# g/h dtype -> (C entry, mode for ddt_hist_max_blocks, output dtype).
_MODES = {torch.float32: ("ddt_hist_f32", 0, torch.float32),
          torch.int8: ("ddt_hist_i8", 1, torch.int32),
          torch.int16: ("ddt_hist_i16", 2, torch.int32)}

THREADS = 1024          # kernel block size (kThreads in csrc/hist.cu)
CELL_BYTES = 8          # one (node, feature, bin): (g, h), f32 or int32
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
               smem_limit: int) -> TilePlan:
    """Slab and node-range widths whose cells (8 B each) fit `smem_limit`
    bytes a block: whole feature rows per node when one node's F x B table
    fits, as many nodes per range as then fit; otherwise the widest
    feature slab one node allows. Widths are balanced so that the last
    slab or range is not a sliver."""
    cell = n_bins * CELL_BYTES               # one (node, feature) in bytes
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
        for entry, _, _ in _MODES.values():
            fn = getattr(lib, entry)
            fn.argtypes = [vp, vp, vp, vp, vp, i64, i64, i32, i32, i32, i32,
                           i32, i32, i32, vp]
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


def _check_operands(Xb, g, h, node_index, n_nodes, n_bins):
    if g.dtype not in _MODES:
        raise TypeError(f"g must be float32, int8 or int16, got {g.dtype}")
    for name, t, dt in (("Xb", Xb, torch.uint8), ("g", g, g.dtype),
                        ("h", h, g.dtype),
                        ("node_index", node_index, torch.int32)):
        if t.device.type != "cuda":
            raise TypeError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t is not Xb and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if Xb.dim() != 2 or (Xb.shape[1] > 1 and Xb.stride(1) != 1) \
            or (Xb.shape[0] > 1 and Xb.stride(0) < Xb.shape[1]):
        raise ValueError("Xb must be row-major [R, F] with unit column "
                         f"stride, got strides {tuple(Xb.stride())}")
        if t.device != Xb.device:
            raise ValueError(f"{name} is on {t.device}, Xb on {Xb.device}")
    R = Xb.shape[0]
    if g.shape != (R,) or h.shape != (R,) or node_index.shape != (R,):
        raise ValueError("g, h and node_index must be [R] with R = Xb rows")
    if not 1 <= n_bins <= 256:
        raise ValueError(f"n_bins must be in [1, 256], got {n_bins}")
    if n_nodes < 0:
        raise ValueError(f"n_nodes must be >= 0, got {n_nodes}")


def build_histograms_cuda(Xb: torch.Tensor, g: torch.Tensor,
                          h: torch.Tensor, node_index: torch.Tensor,
                          n_nodes: int, n_bins: int) -> torch.Tensor:
    """[n_nodes, F, n_bins, 2] on Xb's card: f32 for f32 g/h, int32 for
    int8/int16 g/h. Xb uint8 [R, F] row-major (contiguous, or a column
    slab of a wider matrix: its row stride is passed on), g and h [R] of
    one of those dtypes (the same for both), node_index int32 [R] (-1 =
    frozen), contiguous; all CUDA tensors on one device."""
    _check_operands(Xb, g, h, node_index, n_nodes, n_bins)
    entry, mode, out_dtype = _MODES[g.dtype]
    R, F = Xb.shape
    out = torch.zeros((n_nodes, F, n_bins, 2), dtype=out_dtype,
                      device=Xb.device)
    if R == 0 or F == 0 or n_nodes == 0:
        return out
    plan = plan_tiles(n_nodes, F, n_bins, _build.smem_limit(Xb.device))
    if plan.tiles > _MAX_GRID_Y:
        raise ValueError(f"{plan.tiles} tiles exceed the grid's y limit")
    blocks_x = grid_blocks(
        R, plan.tiles, max_active_blocks(Xb.device, mode, plan.smem_bytes))
    lib = _lib()
    with torch.cuda.device(Xb.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = getattr(lib, entry)(
            Xb.data_ptr(), g.data_ptr(), h.data_ptr(), node_index.data_ptr(),
            out.data_ptr(), R, Xb.stride(0) if R > 1 else F, F, n_bins,
            n_nodes, plan.fs, plan.nr, blocks_x, plan.smem_bytes, stream)
    _build.check(status, f"hist kernel launch ({entry})")
    _launches.count(__name__, "launches" if out_dtype == torch.float32
                    else "launches_int")
    return out
