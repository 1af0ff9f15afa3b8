"""Histogram kernel wrapper (csrc/hist.cu): the Hopper counterpart of
ddt_tpu/ops/hist_pallas.py::_hist_kernel (255 bins) and
::_hist_kernel_t (<= 128 bins), each in its f32 and its integer mode.

Modes, by the dtype of g and h (both the same): f32 sums into f32 with
float atomics (`ddt_hist_f32`); int8 or int16 (quantized gradients) sum
into the raw int32 histogram with integer atomics (`ddt_hist_i8`,
`ddt_hist_i16`), which are exact and order-free, so that mode equals the
plain version bit for bit.

The kernel keeps a private (feature slab x node range) histogram per block
in shared memory and flushes it into the zeroed output with global atomics
(design, bound and numerics are stated in the source). `plan_tiles` plays
the role of hist_pallas.feature_chunks_for: it sizes the slab and node-range
widths from the card's real shared-memory limit, so every shape the
trainer produces runs as one launch; it raises only if one feature of one
node does not fit, which cannot happen at <= 256 bins.

The plain version of the same function is ops/histogram.
build_histograms_segment; ops/histogram.build_histograms dispatches CUDA
tensors here and CPU tensors there. This wrapper never falls back: a CPU
tensor, a wrong dtype or a failed launch raises.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ddt_tpu_torch import _build

#: Kernel launches since the last reset (chip_smoke reads them around
#: each path), one count per mode: `launches` for f32 g/h, `launches_int`
#: for int8/int16. Counted only where the kernel is launched.
launches = 0
launches_int = 0

# g/h dtype -> (C entry, output dtype).
_MODES = {torch.float32: ("ddt_hist_f32", torch.float32),
          torch.int8: ("ddt_hist_i8", torch.int32),
          torch.int16: ("ddt_hist_i16", torch.int32)}

THREADS = 1024          # kernel block size (kThreads in csrc/hist.cu)
_MAX_GRID_Y = 65_535
_argtypes_set = False


@dataclasses.dataclass(frozen=True)
class TilePlan:
    fs: int             # features per slab
    nr: int             # nodes per range
    n_slabs: int
    n_ranges: int
    smem_bytes: int     # dynamic shared memory per block

    @property
    def tiles(self) -> int:
        return self.n_slabs * self.n_ranges


def plan_tiles(n_nodes: int, n_features: int, n_bins: int,
               smem_limit: int) -> TilePlan:
    """Slab and node-range widths whose (g, h) cells (f32 or int32, 4 B
    each) fit `smem_limit`
    bytes: whole feature rows per node when one node's F x B table fits,
    as many nodes per range as then fit; otherwise the widest feature slab
    one node allows. Widths are balanced so that the last slab or range is
    not a sliver."""
    cell = n_bins * 2 * 4                    # one (node, feature) in bytes
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


def grid_rows(n_rows: int, tiles: int, n_sms: int, fs: int) -> tuple:
    """(blocks_x, rows_per_block): about two blocks per SM over the whole
    grid, at least one block's worth of threads per chunk, and a chunk's
    (row, feature) count below 2^31 (the kernel's loop index is int32)."""
    blocks_x = max(1, min(-(-2 * n_sms // tiles), -(-n_rows // THREADS)))
    rows_per_block = -(-n_rows // blocks_x)
    limit = (2 ** 31 - 1) // max(fs, 1)
    if rows_per_block > limit:
        rows_per_block = limit
        blocks_x = -(-n_rows // rows_per_block)
    return blocks_x, max(rows_per_block, 1)


def _lib():
    global _argtypes_set
    lib = _build.library("hist")
    if not _argtypes_set:
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for entry, _ in _MODES.values():
            fn = getattr(lib, entry)
            fn.argtypes = [vp, vp, vp, vp, vp, i64, i32, i32, i32, i32, i32,
                           i32, i32, i32, vp]
            fn.restype = i32
        _argtypes_set = True
    return lib


def build_histograms_cuda(Xb: torch.Tensor, g: torch.Tensor,
                          h: torch.Tensor, node_index: torch.Tensor,
                          n_nodes: int, n_bins: int) -> torch.Tensor:
    """[n_nodes, F, n_bins, 2] on Xb's card: f32 for f32 g/h, int32 for
    int8/int16 g/h. Xb uint8 [R, F], g and h [R] of one of those dtypes
    (the same for both), node_index int32 [R] (-1 = frozen), all
    contiguous CUDA tensors on one device."""
    global launches, launches_int
    if g.dtype not in _MODES:
        raise TypeError(f"g must be float32, int8 or int16, got {g.dtype}")
    entry, out_dtype = _MODES[g.dtype]
    for name, t, dt in (("Xb", Xb, torch.uint8), ("g", g, g.dtype),
                        ("h", h, g.dtype),
                        ("node_index", node_index, torch.int32)):
        if t.device.type != "cuda":
            raise TypeError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != Xb.device:
            raise ValueError(f"{name} is on {t.device}, Xb on {Xb.device}")
    R, F = Xb.shape
    if g.shape != (R,) or h.shape != (R,) or node_index.shape != (R,):
        raise ValueError("g, h and node_index must be [R] with R = Xb rows")
    if not 1 <= n_bins <= 256:
        raise ValueError(f"n_bins must be in [1, 256], got {n_bins}")
    out = torch.zeros((n_nodes, F, n_bins, 2), dtype=out_dtype,
                      device=Xb.device)
    if R == 0 or F == 0 or n_nodes == 0:
        return out
    plan = plan_tiles(n_nodes, F, n_bins, _build.smem_limit(Xb.device))
    if plan.tiles > _MAX_GRID_Y:
        raise ValueError(f"{plan.tiles} tiles exceed the grid's y limit")
    n_sms = torch.cuda.get_device_properties(Xb.device).multi_processor_count
    blocks_x, rows_per_block = grid_rows(R, plan.tiles, n_sms, plan.fs)
    lib = _lib()
    with torch.cuda.device(Xb.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = getattr(lib, entry)(
            Xb.data_ptr(), g.data_ptr(), h.data_ptr(), node_index.data_ptr(),
            out.data_ptr(), R, F, n_bins, n_nodes, plan.fs, plan.nr,
            blocks_x, rows_per_block, plan.smem_bytes, stream)
    _build.check(status, f"hist kernel launch ({entry})")
    if out_dtype == torch.float32:
        launches += 1
    else:
        launches_int += 1
    return out
