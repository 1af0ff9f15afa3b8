"""HistogramBuilder: per-(node, feature, bin) gradient/hessian sums.

Port of ddt_tpu/ops/histogram.py. Contract: binned uint8 Xb [R, F], f32
g/h [R] and a level-local node index int32 [R] (-1 for rows frozen at an
earlier leaf) give f32 [n_nodes, F, n_bins, 2] (g, h) sums.

Quantized path (cfg.grad_dtype): int8 or int16 g/h (ops/grad.
quantize_gradients, both the same dtype) give the RAW int32 histogram.
Integer adds commute, so the kernel and the plain version agree bit for
bit, in any order; the caller dequantizes once (ops/grow.py).

Exact path (what f32 training runs, `build_histograms_exact`): f32 g/h
and a pair of power-of-two scales 2^k (ops/grad.fixed_scales) give the
int64 [n_nodes, F, n_bins, 2] sums of q = rint(g * 2^k), the histogram in
64-bit fixed point. Integer adds commute, so the sums do not depend on
the order of the rows: the kernel equals the plain version bit for bit,
a histogram summed over chunks equals the whole one, and every run,
pass and resume sees the same table. With `out` the sums are added into
an existing int64 table (the streamed level passes accumulate a level's
chunks there, on the device). The caller converts to f32 once, at the
split and leaf step (ops/grad.from_fixed).

Two implementations of each function:

- the kernel, ops/hist_cuda.build_histograms_cuda (csrc/hist.cu), taken
  for CUDA tensors;
- the plain version, `build_histograms_segment` (and
  `build_histograms_fixed_segment` for the exact path): the reference's
  segment form (ddt_tpu/ops/histogram.py:79-105), one `index_add_` per
  feature over node*B + bin keys with frozen rows masked out. Taken for
  CPU tensors, where it is also the CPU tests' reference.

`build_histograms` and `build_histograms_exact` dispatch on the tensors'
device. They never hand a CUDA tensor to a plain version. The f32 form
(`build_histograms`, float atomics on the card) stays as the parity
surface the tests hold to the reference and as kernel_bench's yardstick;
no training path reaches it. Under row partitions the caller merges the
ranks' histograms (parallel/comms.hist_reduce).
"""

from __future__ import annotations

import torch

from ddt_tpu_torch.ops import grad as grad_ops
from ddt_tpu_torch.ops import hist_cuda
from ddt_tpu_torch.telemetry.annotations import op_scope
from ddt_tpu_torch.telemetry.costmodel import costed


def hist_cost(Xb, g, h, node_index, n_nodes, n_bins, scales=None,
              out=None) -> tuple[int, int]:
    """(operations, bytes) of one histogram call (telemetry/costmodel):
    the node index of every row, Xb and g, h of every row read once (a
    frozen row's are not read by the kernel, so bytes are an upper
    bound), the table written once (read and written when added into
    `out`), 16 bytes a cell in the exact mode and 8 otherwise; two adds
    per (row, feature)."""
    R, F = Xb.shape
    cell = 16 if scales is not None else 8
    table = n_nodes * F * n_bins * cell * (1 if out is None else 2)
    nbytes = R * 4 + R * F + 2 * R * g.element_size() + table
    return 2 * R * F, nbytes


def build_histograms_segment(Xb: torch.Tensor, g: torch.Tensor,
                             h: torch.Tensor, node_index: torch.Tensor,
                             n_nodes: int, n_bins: int) -> torch.Tensor:
    """Plain version: index_add_ over (node * n_bins + bin) keys, one call
    per feature, frozen rows contributing nothing. Integer g/h widen to
    int32 before they sum (an int8/int16 sum would wrap)."""
    active = node_index >= 0
    idx = torch.where(active, node_index, 0).to(torch.int64)
    acc = torch.float32 if g.is_floating_point() else torch.int32
    vals = torch.stack([torch.where(active, g, 0),
                        torch.where(active, h, 0)], dim=1).to(acc)
    R, F = Xb.shape
    keys = idx[:, None] * n_bins + Xb.to(torch.int64)            # [R, F]
    out = torch.zeros((F, n_nodes * n_bins, 2), dtype=acc,
                      device=Xb.device)
    for f in range(F):
        out[f].index_add_(0, keys[:, f], vals)
    return out.reshape(F, n_nodes, n_bins, 2).permute(1, 0, 2, 3) \
        .contiguous()


@costed("hist", phase="hist", cost=hist_cost)
@op_scope("hist")
def build_histograms(Xb: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                     node_index: torch.Tensor, n_nodes: int,
                     n_bins: int, out: torch.Tensor | None = None
                     ) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors;
    f32 g/h give f32 sums, int8/int16 g/h raw int32 sums; added into
    `out` when given."""
    if Xb.device.type == "cuda":
        return hist_cuda.build_histograms_cuda(Xb, g, h, node_index,
                                               n_nodes, n_bins, out=out)
    if Xb.device.type != "cpu":
        raise TypeError(f"no histogram implementation for {Xb.device}")
    res = build_histograms_segment(Xb, g, h, node_index, n_nodes, n_bins)
    return res if out is None else out.add_(res)


def build_histograms_fixed_segment(Xb: torch.Tensor, g: torch.Tensor,
                                   h: torch.Tensor, node_index: torch.Tensor,
                                   n_nodes: int, n_bins: int,
                                   scales: torch.Tensor,
                                   out: torch.Tensor | None = None
                                   ) -> torch.Tensor:
    """Plain version of the exact path: each row's q = rint(g * 2^k)
    (ops/grad.to_fixed, scales f32 [2]) summed in int64 by index_add_,
    one call per feature, frozen rows adding nothing; added into `out`
    (int64 [n_nodes, F, n_bins, 2]) when given."""
    active = node_index >= 0
    idx = torch.where(active, node_index, 0).to(torch.int64)
    q = torch.stack([grad_ops.to_fixed(g, scales[0]),
                     grad_ops.to_fixed(h, scales[1])], dim=1)
    vals = torch.where(active[:, None], q, 0)
    R, F = Xb.shape
    keys = idx[:, None] * n_bins + Xb.to(torch.int64)            # [R, F]
    acc = torch.zeros((F, n_nodes * n_bins, 2), dtype=torch.int64,
                      device=Xb.device)
    for f in range(F):
        acc[f].index_add_(0, keys[:, f], vals)
    res = acc.view(F, n_nodes, n_bins, 2).permute(1, 0, 2, 3)
    if out is None:
        return res.contiguous()
    return out.add_(res)


@costed("hist", phase="hist", cost=hist_cost)
@op_scope("hist")
def build_histograms_exact(Xb: torch.Tensor, g: torch.Tensor,
                           h: torch.Tensor, node_index: torch.Tensor,
                           n_nodes: int, n_bins: int, scales: torch.Tensor,
                           out: torch.Tensor | None = None) -> torch.Tensor:
    """The exact path's int64 [n_nodes, F, n_bins, 2] fixed-point sums
    (module docstring): the kernel's exact mode for CUDA tensors, the
    plain version for CPU tensors; added into `out` when given."""
    if Xb.device.type == "cuda":
        return hist_cuda.build_histograms_cuda(
            Xb, g, h, node_index, n_nodes, n_bins, scales=scales, out=out)
    if Xb.device.type != "cpu":
        raise TypeError(f"no histogram implementation for {Xb.device}")
    return build_histograms_fixed_segment(Xb, g, h, node_index, n_nodes,
                                          n_bins, scales, out=out)
