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
device.

The OOM ladder (the reference's degrade ladder, ddt_tpu/backends/
tpu.py:476-528): every histogram a trainer builds passes the `hist.build`
fault-plan seam first (`build_table`), and an allocation failure
(faultplan.is_resource_exhausted: torch.cuda.OutOfMemoryError, or the
injected twin) at a level of ops/grow steps the backend's `HistLadder`
down one rung and runs the level again. The rung is state of the backend
instance (CUDADevice and the backends built on it), as the reference's
`_hist_degrade` is: a step down is sticky for that backend (the same
shapes would fail again) and never touches another one. Each step counts
`hist_oom_degrades` and emits a `hist_oom_degrade` fault event. The
reference steps down among its implementations; the port has one kernel
a mode, so its rungs give up what a level holds beside the kernel's
output. The peak is the most card memory a level's build and split
search hold (ops/grow.py runs the ladder at the level step):

- rung 0 (`k1`): one launch a level, the parent's carried table and the
  sibling subtraction (ops/grow.assemble_subtracted) where
  hist_subtraction is on;
- rung 1 (`k1_no_carry`): both children built from rows; the parent's
  table is no longer held through the level, nor the left half and the
  subtraction's temporaries. The exact and integer sums are order-free,
  so the table is bitwise parent - left. Where subtraction is off this
  rung saves nothing, and the ladder skips it;
- rungs r >= 2 (`k1_nodes_1/4`, `k1_nodes_1/16`): one node slab of
  ceil(n / 4^(r - 1)) nodes at a time, each built by K1 over its node
  range (`node_lo`), split at once and freed before the next slab's
  build; only the [n] split results are kept. The split search is per
  node, so the concatenated results are bitwise the whole level's, and
  its temporaries (several times the table) shrink with the slab.

Where no rung lowers what a build allocates, the ladder does not pretend
to: the streamed level passes (ops/stream.py) add every chunk into one
table of the level, `CUDADevice.build_histograms` returns a whole table,
and on a mesh (ops/grow.grow_tree with a process group) every rank must
issue the same collectives, of the same shapes, whatever its rung, so
the table is built, carried and reduced whole, once a level. Those
builds go through `HistLadder.retry_build`: an injected fault (raised at
the seam, before anything is allocated) is retried at the same rung,
and a real allocation failure is raised at once, the rung unmoved. On a
mesh the ladder steps at the split search alone (rung 1 is skipped):
rungs >= 2 split the reduced table by node slabs, which lowers the
search's temporaries, and a rank that steps down alone changes no
collective.

The ladder is host code. A captured round (backends/cuda._RoundGraph)
replays its kernels without running it: the seam fires only where the
host runs the build, on the granular loop, the streamed loop, and the
fused loop's warm-up round and capture. Inside a capture a step down is
taken and the failure re-raised (`HistLadder.run`): the capture holds the
failed attempt's work, so _RoundGraph drops it and captures the round
again at the new rung. A replay never steps down. The dispatchers
never hand a CUDA tensor to a plain version. The f32 form
(`build_histograms`, float atomics on the card) stays as the parity
surface the tests hold to the reference and as kernel_bench's yardstick;
no training path reaches it. Under row partitions the caller merges the
ranks' histograms (parallel/comms.hist_reduce).
"""

from __future__ import annotations

import logging

import torch

from ddt_tpu_torch.ops import grad as grad_ops
from ddt_tpu_torch.ops import hist_cuda
from ddt_tpu_torch.robustness import emit_fault, faultplan
from ddt_tpu_torch.telemetry import counters as tele_counters
from ddt_tpu_torch.telemetry.annotations import op_scope
from ddt_tpu_torch.telemetry.costmodel import costed
from ddt_tpu_torch.utils import launches


def hist_cost(Xb, g, h, node_index, n_nodes, n_bins, scales=None,
              out=None, node_lo=0) -> tuple[int, int]:
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


def _in_range(node_index: torch.Tensor, n_nodes: int, node_lo: int):
    """(active bool [R], the node's place in the range int64 [R]) for a
    table of the level's nodes [node_lo, node_lo + n_nodes)."""
    local = node_index.to(torch.int64) - node_lo
    active = (node_index >= 0) & (local >= 0) & (local < n_nodes)
    return active, torch.where(active, local, 0)


def build_histograms_segment(Xb: torch.Tensor, g: torch.Tensor,
                             h: torch.Tensor, node_index: torch.Tensor,
                             n_nodes: int, n_bins: int,
                             node_lo: int = 0) -> torch.Tensor:
    """Plain version: index_add_ over (node * n_bins + bin) keys, one call
    per feature, frozen rows and rows outside the node range [node_lo,
    node_lo + n_nodes) contributing nothing. Integer g/h widen to int32
    before they sum (an int8/int16 sum would wrap)."""
    active, idx = _in_range(node_index, n_nodes, node_lo)
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
                     n_bins: int, out: torch.Tensor | None = None,
                     node_lo: int = 0) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors;
    f32 g/h give f32 sums, int8/int16 g/h raw int32 sums, of the level's
    nodes [node_lo, node_lo + n_nodes); added into `out` when given."""
    if Xb.device.type == "cuda":
        return hist_cuda.build_histograms_cuda(
            Xb, g, h, node_index, n_nodes, n_bins, out=out, node_lo=node_lo)
    if Xb.device.type != "cpu":
        raise TypeError(f"no histogram implementation for {Xb.device}")
    res = build_histograms_segment(Xb, g, h, node_index, n_nodes, n_bins,
                                   node_lo)
    return res if out is None else out.add_(res)


def build_histograms_fixed_segment(Xb: torch.Tensor, g: torch.Tensor,
                                   h: torch.Tensor, node_index: torch.Tensor,
                                   n_nodes: int, n_bins: int,
                                   scales: torch.Tensor,
                                   out: torch.Tensor | None = None,
                                   node_lo: int = 0) -> torch.Tensor:
    """Plain version of the exact path: each row's q = rint(g * 2^k)
    (ops/grad.to_fixed, scales f32 [2]) summed in int64 by index_add_,
    one call per feature, frozen rows and rows outside the node range
    [node_lo, node_lo + n_nodes) adding nothing; added into `out` (int64
    [n_nodes, F, n_bins, 2]) when given."""
    active, idx = _in_range(node_index, n_nodes, node_lo)
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
                           out: torch.Tensor | None = None,
                           node_lo: int = 0) -> torch.Tensor:
    """The exact path's int64 [n_nodes, F, n_bins, 2] fixed-point sums
    (module docstring) of the level's nodes [node_lo, node_lo + n_nodes):
    the kernel's exact mode for CUDA tensors, the plain version for CPU
    tensors; added into `out` when given."""
    if Xb.device.type == "cuda":
        return hist_cuda.build_histograms_cuda(
            Xb, g, h, node_index, n_nodes, n_bins, scales=scales, out=out,
            node_lo=node_lo)
    if Xb.device.type != "cpu":
        raise TypeError(f"no histogram implementation for {Xb.device}")
    return build_histograms_fixed_segment(Xb, g, h, node_index, n_nodes,
                                          n_bins, scales, out=out,
                                          node_lo=node_lo)


log = logging.getLogger("ddt_tpu_torch.histogram")

#: The OOM ladder: rungs 0..N_RUNGS - 1 (module docstring); rung r >= 2
#: takes node slabs of ceil(n / RUNG_SPLIT ** (r - 1)) nodes.
RUNG_SPLIT = 4
N_RUNGS = 4


def rung_name(rung: int) -> str:
    if rung == 0:
        return "k1"
    if rung == 1:
        return "k1_no_carry"
    return f"k1_nodes_1/{RUNG_SPLIT ** (rung - 1)}"


def slab_nodes(rung: int, n_nodes: int) -> int:
    """Nodes a slab of a level of `n_nodes` takes at `rung` (the whole
    level at rungs 0 and 1)."""
    if rung < 2:
        return n_nodes
    return max(1, -(-n_nodes // RUNG_SPLIT ** (rung - 1)))


class HistLadder:
    """One backend's OOM ladder (module docstring): its rung and the rungs
    it may take. `carry` says whether rung 1 saves anything here (sibling
    subtraction on, one device); without it rung 1 is skipped."""

    def __init__(self, carry: bool):
        self.rungs = tuple(r for r in range(N_RUNGS) if carry or r != 1)
        self.rung = 0

    def step_down(self, err: BaseException) -> bool:
        """Take the next rung after `err`: True when it was an allocation
        failure and a rung is left, else False (the caller re-raises)."""
        i = self.rungs.index(self.rung)
        if not faultplan.is_resource_exhausted(err) \
                or i + 1 >= len(self.rungs):
            return False
        frm, self.rung = rung_name(self.rung), self.rungs[i + 1]
        tele_counters.record_hist_oom_degrade()
        emit_fault("hist_oom_degrade", from_impl=frm,
                   to_impl=rung_name(self.rung), row_chunk=0)
        log.warning("histogram build out of memory at %s; stepping down to "
                    "%s for the rest of this backend's fits: %s", frm,
                    rung_name(self.rung), str(err)[:200])
        return True

    def run(self, fn):
        """fn(rung) at the ladder's rung, again one rung lower after each
        allocation failure. Inside a CUDA-graph capture the step is taken
        and the failure re-raised: the capture holds the failed attempt's
        work, and its owner captures again at the new rung."""
        while True:
            try:
                return fn(self.rung)
            except Exception as e:
                if not self.step_down(e) or launches.capturing():
                    raise

    def retry_build(self, fn):
        """fn() for a build whose allocation no rung lowers (module
        docstring): retried at the same rung after an injected allocation
        failure, which fires at the seam before anything is allocated, up
        to N_RUNGS attempts; a real one is raised at once, the rung
        unmoved."""
        for attempt in range(N_RUNGS):
            try:
                return fn()
            except faultplan.InjectedResourceExhausted as e:
                if attempt + 1 == N_RUNGS:
                    raise
                log.warning("injected allocation failure at a histogram "
                            "build; retried at %s: %s",
                            rung_name(self.rung), str(e)[:200])


def build_table(Xb: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                node_index: torch.Tensor, n_nodes: int, n_bins: int,
                scales: torch.Tensor | None = None, node_lo: int = 0,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """One table of the level's nodes [node_lo, node_lo + n_nodes) through
    the `hist.build` seam: build_histograms_exact with `scales`, else
    build_histograms; added into `out` when given. The level step of
    ops/grow runs the ladder around it, the other builds
    HistLadder.retry_build."""
    faultplan.inject("hist.build")
    if scales is not None:
        return build_histograms_exact(Xb, g, h, node_index, n_nodes, n_bins,
                                      scales, out=out, node_lo=node_lo)
    return build_histograms(Xb, g, h, node_index, n_nodes, n_bins, out=out,
                            node_lo=node_lo)
