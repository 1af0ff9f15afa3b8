"""The collectives of split finding, on torch.distributed (port of
ddt_tpu/parallel/comms.py:119-371 and of the payload model
ddt_tpu/telemetry/counters.hist_allreduce_bytes).

Every byte the trainer moves between ranks goes through this module. Each
function takes `group`, a torch.distributed process group, or None for a
single process, where it is the identity and no collective runs (the
reference's `axis_name=None`). NCCL carries CUDA tensors and gloo CPU
tensors; a CUDA tensor handed to a group of another backend raises
(`check_group`): there is no quiet path through the host.

- `psum` / `pmax` / `all_gather` / `reduce_scatter`: `dist.all_reduce`,
  `reduce_scatter_tensor` and `all_gather_into_tensor`, each returning a
  new tensor. `reduce_scatter` splits a chosen dim (the feature dim of a
  [n, F, B, 2] histogram), which it first moves outermost, so rank i gets
  contiguous block i of the dim, padded to a multiple of the world size
  by the caller (`pad_to_multiple`).
- `hist_reduce`: the histogram collective, replicated or scattered, on an
  f32 wire, a bf16 one (each partial rounded to bf16, summed in f32) or
  `int32_fixed` (each partial on one fixed-point grid whose scale comes
  from a MAX all-reduce of the local max-abs, summed in int32: the result
  does not depend on the reduction order). `comms_error_bound` bounds
  either compressed wire. Integer (quantized-gradient) histograms merge
  exactly as they are and refuse compression.
  With `async_op=True` it returns a `Pending` whose `wait()` gives the
  merged tensor: the slab-pipelined level loop (ops/grow) issues slab k's
  collective before slab k+1's kernel and waits for all of them before
  the concatenation (on NCCL a wait orders the current stream after the
  collective, so a captured round holds the overlap).
- `combine_shard_winners`: the epilogue of a sharded split search. Each
  rank found the best split of its columns; one all-gather of a packed
  [4, n] int32 record (gain bits, feature, bin, direction) and the
  single-device argmax's tie-break (maximum gain, then the smallest
  global flattened candidate index, the right-direction block first
  under a missing bin; a -inf slab never wins) pick the global winner on
  every rank. It gathers over the world under reduce-scatter (every
  (row, feature) rank owns a distinct column set) and over the feature
  group under allreduce on a 2D mesh.
- `resolve_split_comms` / `resolve_comms_slabs`: the config's "auto"
  choices, resolved once per backend.

Counters (read around a path, as the kernels' launch counters are, and
counted per replay of a captured round through utils/launches):
`calls` collectives, `modeled_bytes` the payload that
`hist_allreduce_bytes` models (histograms as reduced, winners as
gathered, the final leaf sums), `other_bytes` the rest (node totals under
reduce-scatter or a feature axis, the routing broadcast over the feature
group, int32_fixed scales, quantization statistics, losses, digests,
checkpoint barriers).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ddt_tpu_torch.config import COMMS_DTYPES, SPLIT_COMMS
from ddt_tpu_torch.utils import launches as _launches

#: Wire bytes per histogram entry under each comms dtype.
COMMS_DTYPE_BYTES = {"f32": 4, "bf16": 2, "int32_fixed": 4}

#: int32_fixed headroom: each partial's quantized magnitude is capped at
#: (2^30 - 1) // P, so the P-way int32 sum cannot overflow.
_FIXED_CAP = (1 << 30) - 1

#: Collectives and payload bytes since the last reset (see the module
#: docstring).
calls = 0
modeled_bytes = 0
other_bytes = 0

_NOT_LIVE = 1 << 30     # combine key past every real candidate


def world(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def check_group(device: torch.device, group) -> None:
    """Refuse a CUDA tensor on a group that is not NCCL (and a CPU tensor
    on an NCCL one): each device has exactly one wire."""
    backend = str(dist.get_backend(group)).lower()
    if device.type == "cuda" and "nccl" not in backend:
        raise RuntimeError(
            f"CUDA tensors need an NCCL process group, this one is "
            f"{backend!r}: initialise the group with backend='nccl'")
    if device.type != "cuda" and backend == "nccl":
        raise RuntimeError(
            f"{device.type} tensors cannot ride an NCCL process group; "
            "use gloo for CPU ranks")


def _count(nbytes: int, modeled: bool) -> None:
    _launches.count(__name__, "calls")
    _launches.count(__name__, "modeled_bytes" if modeled else "other_bytes",
                    nbytes)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


class Pending:
    """An issued collective: `wait()` waits for it (on NCCL: orders the
    current stream after it) and returns its result. It holds the
    collective's tensors until then."""

    def __init__(self, out: torch.Tensor, work=None, post=None, keep=()):
        self._out, self._work, self._post, self._keep = out, work, post, keep

    def wait(self) -> torch.Tensor:
        if self._work is not None:
            self._work.wait()
            self._work = None
        self._keep = ()
        return self._out if self._post is None else self._post(self._out)


def _all_reduce_pending(x: torch.Tensor, group, op, modeled: bool,
                        async_op: bool = False) -> Pending:
    if group is None:
        return Pending(x)
    check_group(x.device, group)
    out = x.contiguous().clone()
    _count(_nbytes(out), modeled)
    return Pending(out, dist.all_reduce(out, op=op, group=group,
                                        async_op=async_op))


def _all_reduce(x: torch.Tensor, group, op, modeled: bool) -> torch.Tensor:
    return _all_reduce_pending(x, group, op, modeled).wait()


def psum(x: torch.Tensor, group, modeled: bool = False) -> torch.Tensor:
    """Sum of x over the group's ranks (a new tensor on every rank)."""
    return _all_reduce(x, group, dist.ReduceOp.SUM, modeled)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise maximum of x over the group's ranks."""
    return _all_reduce(x, group, dist.ReduceOp.MAX, False)


def all_gather(x: torch.Tensor, group, modeled: bool = False
               ) -> torch.Tensor:
    """[P, *x.shape]: every rank's x, in rank order (x[None] alone)."""
    if group is None:
        return x[None]
    check_group(x.device, group)
    P = world(group)
    flat = x.contiguous().reshape(-1)
    # The concatenated output form: gloo takes no stacked one.
    out = torch.empty(P * flat.numel(), dtype=x.dtype, device=x.device)
    _count(_nbytes(out), modeled)
    dist.all_gather_into_tensor(out, flat, group=group)
    return out.view((P,) + tuple(x.shape))


def _reduce_scatter_pending(x: torch.Tensor, group, dim: int,
                            modeled: bool, async_op: bool = False
                            ) -> Pending:
    if group is None:
        return Pending(x)
    P = world(group)
    if x.shape[dim] % P:
        raise ValueError(
            f"reduce_scatter dim {dim} extent {x.shape[dim]} is not a "
            f"multiple of the world size {P}; pad first")
    check_group(x.device, group)
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // P,) + tuple(src.shape[1:]),
                      dtype=src.dtype, device=src.device)
    _count(_nbytes(out), modeled)
    work = dist.reduce_scatter_tensor(out, src, group=group,
                                      async_op=async_op)
    return Pending(out, work, lambda o: o.movedim(0, dim).contiguous(),
                   keep=(src,))


def reduce_scatter(x: torch.Tensor, group, dim: int,
                   modeled: bool = False) -> torch.Tensor:
    """Sum x over the group and hand rank i contiguous block i of `dim`
    (whose extent must be a multiple of the world size: pad first)."""
    return _reduce_scatter_pending(x, group, dim, modeled).wait()


def psum_ordered(x: torch.Tensor, group, shard: int) -> torch.Tensor:
    """Sum x over the group in row-shard order: every rank's x is
    gathered with the shard it holds, and the parts add shard 0 first,
    so the f32 result does not depend on which rank holds which shard
    (the straggler rotation moves shards between ranks). One all_gather
    of P x (numel + 1) f32 values."""
    if group is None:
        return x
    flat = x.reshape(-1).to(torch.float32)
    tagged = torch.cat([flat, torch.full((1,), float(shard),
                                         dtype=torch.float32,
                                         device=x.device)])
    every = all_gather(tagged, group).reshape(world(group), -1)
    order = torch.argsort(every[:, -1])
    acc = every[order[0], :-1]
    for i in range(1, every.shape[0]):
        acc = acc + every[order[i], :-1]
    return acc.reshape(x.shape).to(x.dtype)


def pad_to_multiple(x: torch.Tensor, dim: int, multiple: int
                    ) -> torch.Tensor:
    """x zero-padded on `dim` up to a multiple of `multiple` (x itself
    when already aligned)."""
    rem = x.shape[dim] % multiple
    if rem == 0:
        return x
    shape = list(x.shape)
    shape[dim] = multiple - rem
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def _reduce(x, group, mode: str, scatter_dim: int,
            async_op: bool) -> Pending:
    if mode == "reduce_scatter":
        return _reduce_scatter_pending(x, group, scatter_dim, True,
                                       async_op)
    return _all_reduce_pending(x, group, dist.ReduceOp.SUM, True, async_op)


def hist_reduce(hist: torch.Tensor, group, *, mode: str = "allreduce",
                comms_dtype: str = "f32", scatter_dim: int = 1,
                async_op: bool = False):
    """Merge the ranks' partial histograms: replicated
    (mode="allreduce") or scattered along `scatter_dim`
    (mode="reduce_scatter", the dim pre-padded to the world size), on an
    f32, bf16 or int32_fixed wire (see the module docstring). Integer
    histograms merge exactly and refuse compression; a single process
    (group None) has no wire and rounds nothing. With `async_op`, a
    Pending whose wait() gives the merged tensor (int32_fixed's scale
    MAX runs before the return)."""
    p = _hist_reduce(hist, group, mode, comms_dtype, scatter_dim, async_op)
    return p if async_op else p.wait()


def _hist_reduce(hist, group, mode, comms_dtype, scatter_dim,
                 async_op) -> Pending:
    if comms_dtype not in COMMS_DTYPES:
        raise ValueError(
            f"comms_dtype must be one of {COMMS_DTYPES}, got {comms_dtype!r}")
    if mode not in ("allreduce", "reduce_scatter"):
        raise ValueError(f"mode must be allreduce|reduce_scatter, got "
                         f"{mode!r}")
    if not hist.is_floating_point():
        if comms_dtype != "f32":
            raise ValueError(
                f"hist_comms_dtype={comms_dtype!r} cannot compress integer "
                "(quantized-gradient) histogram partials: they already "
                "live on one shared fixed-point grid, so quantizing them "
                "again per collective would void the quantized-gradient "
                "error bound; keep hist_comms_dtype='f32'")
        return _reduce(hist, group, mode, scatter_dim, async_op)
    if group is None or comms_dtype == "f32":
        return _reduce(hist, group, mode, scatter_dim, async_op)
    if comms_dtype == "bf16":
        return _reduce(hist.to(torch.bfloat16).to(torch.float32), group,
                       mode, scatter_dim, async_op)
    # int32_fixed: one grid for every rank (scale from the global
    # max-abs), each partial capped so the int32 sum cannot overflow, the
    # dequantize after the integer reduce. torch.round rounds half to
    # even, as jnp.round does.
    dev = hist.device
    cap = torch.full((), _FIXED_CAP // world(group), dtype=torch.float32,
                     device=dev)
    m = pmax(hist.abs().max(), group)
    scale = torch.where(m > 0, m / cap,
                        torch.ones((), dtype=torch.float32, device=dev))
    q = torch.round(hist / scale).to(torch.int32)
    p = _reduce(q, group, mode, scatter_dim, async_op)
    return Pending(p, post=lambda pp: pp.wait().to(torch.float32) * scale)


def comms_error_bound(comms_dtype: str, partitions: int,
                      max_abs: float) -> float:
    """Worst-case absolute per-entry error a compressed merge adds to a
    histogram whose partials are bounded by `max_abs`, against the exact
    f32 merge: bf16 rounds each of the P partials once (relative 2^-9);
    int32_fixed lands each within half a grid step (max_abs / cap), plus
    the one f32 rounding of the dequantized sum."""
    if comms_dtype == "f32":
        return 0.0
    if comms_dtype == "bf16":
        return partitions * max_abs * 2.0 ** -9
    if comms_dtype == "int32_fixed":
        cap = _FIXED_CAP // max(1, partitions)
        return (0.5 * partitions * max_abs / cap
                + partitions * max_abs * 2.0 ** -23)
    raise ValueError(f"unknown comms_dtype {comms_dtype!r}")


def combine_shard_winners(gains: torch.Tensor, feats: torch.Tensor,
                          bins: torch.Tensor, dls: torch.Tensor, group, *,
                          n_features: int, n_bins: int,
                          missing_bin: bool = False):
    """The global best split per node from each rank's slab winner
    (`feats` already global): one all-gather of the four [n] vectors
    packed as int32, then maximum gain, ties to the smallest global
    flattened candidate index (direction block, feature, bin), a -inf
    slab never winning. Returns (gains f32, feats int32, bins int32, dls
    bool), the same on every rank."""
    if group is None:
        return gains, feats, bins, dls
    packed = torch.stack([gains.to(torch.float32).view(torch.int32),
                          feats.to(torch.int32), bins.to(torch.int32),
                          dls.to(torch.int32)])                 # [4, n]
    allp = all_gather(packed, group, modeled=True)              # [P, 4, n]
    ga = allp[:, 0].contiguous().view(torch.float32)
    fa, ba, da = allp[:, 1], allp[:, 2], allp[:, 3]
    flat = fa * n_bins + ba
    if missing_bin:
        flat = flat + da * (n_features * n_bins)
    flat = torch.where(torch.isfinite(ga), flat, _NOT_LIVE)
    best = ga.max(dim=0).values
    key = torch.where(ga == best[None, :], flat, _NOT_LIVE)
    kmin = key.min(dim=0).values
    w = (key == kmin[None, :]).to(torch.int32).argmax(dim=0)[None]

    def take(a):
        return a.gather(0, w)[0]

    return take(ga), take(fa), take(ba), take(da) != 0


def resolve_split_comms(flag: str, *, row_shards: int) -> str:
    """cfg.split_comms -> "allreduce" | "reduce_scatter": "auto" (and a
    forced "reduce_scatter") scatter exactly when rows are partitioned
    (row_shards = hosts x rows > 1), on any mesh with a row wire; a pure
    feature mesh, or one rank, has no row wire to scatter."""
    if flag not in SPLIT_COMMS:
        raise ValueError(
            f"split_comms must be one of {SPLIT_COMMS}, got {flag!r}")
    if flag == "allreduce":
        return "allreduce"
    return "reduce_scatter" if row_shards > 1 else "allreduce"


#: hist_comms_slabs=0 ("auto") on a distributed run, by device type.
#: 1 (no pipelining): on four H100s 4 slabs made the round slower at
#: BASELINE config 5's width (+10%) and at config 3's (2.15x), K1's extra
#: launches costing more than the wire they hide (PERF.md section 6).
AUTO_COMMS_SLABS = {"cuda": 1, "cpu": 1}


def resolve_comms_slabs(flag: int, *, distributed: bool,
                        device_type: str) -> int:
    """cfg.hist_comms_slabs -> the slab count of the level loop's
    pipelined build + collective (port of ddt_tpu/parallel/comms.py:
    365-391): N >= 1 is taken as it is; 0 ("auto") is 1 without a wire,
    else AUTO_COMMS_SLABS of the device."""
    if flag < 0:
        raise ValueError(f"hist_comms_slabs must be >= 0, got {flag}")
    if flag >= 1:
        return flag
    if not distributed:
        return 1
    return AUTO_COMMS_SLABS[device_type]


def hist_allreduce_bytes_by_level(max_depth: int, n_features: int,
                                  n_bins: int, *, partitions: int = 1,
                                  mode: str = "allreduce",
                                  subtraction: bool = False,
                                  comms_dtype: str = "f32",
                                  feature_partitions: int = 1,
                                  grad_dtype: str = "f32",
                                  value_bytes: int | None = None
                                  ) -> list[int]:
    """Per-level payload of the histogram collective for one tree, per
    rank (levels 0..max_depth-1; the reference's telemetry/counters.
    hist_allreduce_bytes_by_level): the level's histogram (left children
    only from level 1 with subtraction) over the rank's F / Pf columns as
    the rank holds it after the collective, at the wire's bytes per value
    (int32 partials on the quantized path), plus the winner combine's
    gathered [4, n_level] int32 records: from every rank (P x Pf) under
    reduce-scatter, from the Pf feature shards under allreduce on a
    feature axis. `partitions` counts the row shards (hosts x rows).
    `value_bytes` overrides the wire's bytes a value (8: the exact path's
    int64 wire under cfg.straggler_repartition)."""
    if grad_dtype != "f32" and comms_dtype != "f32":
        raise ValueError(
            f"grad_dtype={grad_dtype!r} with comms_dtype={comms_dtype!r}: "
            "integer histogram partials refuse compression")
    val_bytes = 4 if grad_dtype != "f32" else COMMS_DTYPE_BYTES[comms_dtype]
    if value_bytes is not None:
        val_bytes = value_bytes
    per_entry = val_bytes * 2                            # (g, h) pairs
    P = max(1, partitions)
    Pf = max(1, feature_partitions)
    f_dev = -(-n_features // Pf)
    out = []
    for d in range(max_depth):
        nodes = 1 << d
        if subtraction and d >= 1:
            nodes //= 2
        if mode == "reduce_scatter":
            f_pad = -(-f_dev // P) * P
            total = nodes * (f_pad // P) * n_bins * per_entry
            total += P * Pf * (1 << d) * 4 * 4
        else:
            total = nodes * f_dev * n_bins * per_entry
            if Pf > 1:
                total += Pf * (1 << d) * 4 * 4
        out.append(total)
    return out


def hist_allreduce_bytes(max_depth: int, n_features: int, n_bins: int,
                         **kw) -> int:
    """One tree's modeled payload per rank: the levels'
    (hist_allreduce_bytes_by_level) plus the final leaf sums' [2^depth,
    2] all-reduce at 4 bytes a value (`value_bytes` when given)."""
    return (sum(hist_allreduce_bytes_by_level(max_depth, n_features,
                                              n_bins, **kw))
            + (1 << max_depth) * (kw.get("value_bytes") or 4) * 2)
