"""HistogramBuilder: per-(node, feature, bin) gradient/hessian sums.

Port of ddt_tpu/ops/histogram.py. Contract: binned uint8 Xb [R, F], f32
g/h [R] and a level-local node index int32 [R] (-1 for rows frozen at an
earlier leaf) give f32 [n_nodes, F, n_bins, 2] (g, h) sums.

Quantized path (cfg.grad_dtype): int8 or int16 g/h (ops/grad.
quantize_gradients, both the same dtype) give the RAW int32 histogram.
Integer adds commute, so the kernel and the plain version agree bit for
bit, in any order; the caller dequantizes once (ops/grow.py).

Two implementations of the one function:

- the kernel, ops/hist_cuda.build_histograms_cuda (csrc/hist.cu), taken
  for CUDA tensors;
- the plain version, `build_histograms_segment`: the reference's segment
  form (ddt_tpu/ops/histogram.py:79-105), one `index_add_` per feature
  over node*B + bin keys with frozen rows masked out. Taken for CPU
  tensors, where it is also the CPU tests' reference.

`build_histograms` dispatches on the tensors' device. It never hands a
CUDA tensor to the plain version.
"""

from __future__ import annotations

import torch

from ddt_tpu_torch.ops import hist_cuda


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


def build_histograms(Xb: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                     node_index: torch.Tensor, n_nodes: int,
                     n_bins: int) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors;
    f32 g/h give f32 sums, int8/int16 g/h raw int32 sums."""
    if Xb.device.type == "cuda":
        return hist_cuda.build_histograms_cuda(Xb, g, h, node_index,
                                               n_nodes, n_bins)
    if Xb.device.type != "cpu":
        raise TypeError(f"no histogram implementation for {Xb.device}")
    return build_histograms_segment(Xb, g, h, node_index, n_nodes, n_bins)
