"""Loss gradients/hessians, the training loss, per-leaf (G, H) sums, and
the quantized-gradient step.

Port of ddt_tpu/ops/grad.py: binary logloss, mse and softmax (g, h of
[R, C] for C classes). Elementwise PyTorch in float32, on whatever device
the tensors live on. Instance weights ride the `valid` vector, as in the
reference: the backend multiplies g and h by it, and `mean_loss` takes
the weighted mean.

QUANTIZED GRADIENTS (cfg.grad_dtype): once per tree the f32 gradients
round onto one shared grid,

    scale = max(max|g| / qmax, 2^ceil(log2(sum|g| / 2^30)))
    q     = clip(floor(g / scale + u), -qmax, qmax)     int8 / int16

with `u` the per-(seed ^ channel salt, tree, global row) counter-hash
uniform of ops/sampling (seeded stochastic rounding: unbiased and a pure
function of its key). The max|g| term is exact; the sum-cap term keeps
every int32 accumulator overflow-free by construction (sum|q| <= 2^30 +
n_rows < 2^31 for n_rows < GRAD_ROW_LIMIT) and snaps up to a power of
two, which absorbs the f32 sum-order differences between devices except
at an exact frexp boundary. Histograms, node totals and leaf sums then
add the integer q's and dequantize once (ops/grow.py).

EXACT f32 HISTOGRAMS (cfg.grad_dtype "f32"): the sums are taken in 64-bit
fixed point, so that no sum depends on the order of its terms. Per tree
each channel gets one power-of-two scale 2^k from its global max|g| (or
max|h|, over every row of every chunk and rank) and the global row count
N (`fixed_scales`): with max < 2^e,

    k = min(30, 62 - ceil(log2 N)) - e        (clamped to [-126, 126])
    q = rint(g * 2^k)                          int32: |q| <= 2^30
    sum over N rows                            |sum| <= N * 2^30 <= 2^62

so one row's q fits 32 bits and every sum of q's fits an int64 with a bit
to spare. g * 2^k is exact (a power of two; IEEE subnormals both ways) and
rint rounds half to even as torch.round does, so the card's kernel and the
plain version round every row alike. Histograms, node totals and leaf
sums add the q's in int64 (exact, in any order: across chunks, passes,
ranks and runs), and each aggregate converts to f32 once, A * 2^-k
(`from_fixed`).

Dynamic range: the grid step 2^-k is under max * 2^-29 (2^-30 of the
channel's bound 2^e). A row of |x| keeps about 30 - log2(max / |x|)
significant bits, and one under 2^-31 of the max rounds to 0; a sum over
n rows is off by at most n half-steps. f32 keeps 24 bits of every term,
so the grid is the coarser of the two for rows under ~2^-6 of the tree's
max: a squared-loss target whose residuals spread over 1e6 leaves a
typical row ~10 bits, and a cell of such rows then differs from an f32
sum by up to ~5e-4 of its |sum| (tests/test_torch_exact.py holds the
cells to this bound and such runs' trees to the reference's). The scale
stays one per tree and channel, never per level or node: that is what
lets a table add over chunks, ranks and the sibling subtraction exactly.

Bit-identity with the numpy twin (`quantize_gradients_np`) needs IEEE
operations everywhere: the scale stays a 0-dim tensor on the gradients'
device, because PyTorch's CUDA division by a CPU scalar computes
a * (1/b), which is not the quotient floor(g / scale + u) needs; and the
snapped power of two is built from its exponent bits, not from pow().
"""

from __future__ import annotations

import numpy as np
import torch

from ddt_tpu_torch.config import GRAD_DTYPES
from ddt_tpu_torch.ops import sampling
from ddt_tpu_torch.parallel import comms

#: Symmetric quantized range per dtype (the most negative two's-complement
#: value is deliberately unused).
GRAD_QMAX = {"int16": 32767, "int8": 127}
#: Bytes per quantized g (or h) value.
GRAD_ITEMSIZE = {"f32": 4, "int16": 2, "int8": 1}
#: int32 headroom: the scale is floored so the global sum of |q| cannot
#: exceed this plus one stochastic-rounding step per row.
GRAD_SUM_CAP = 1 << 30
#: Row ceiling of the overflow proof: sum|q| <= GRAD_SUM_CAP + n_rows
#: < 2^31 - 1 needs n_rows < 2^30.
GRAD_ROW_LIMIT = 1 << 30
# Per-channel seed salts for the stochastic-rounding draw: g and h (and
# the bagging mask, which salts nothing) must not share rounding bits.
_G_SALT = 0x67AD5C01
_H_SALT = 0x48E55CA3


def base_score_np(y: np.ndarray, loss: str,
                  sample_weight: np.ndarray | None = None) -> float:
    """Raw-score init on host, as the Driver computes it: log-odds of the
    (weighted) mean label for logloss, the mean for mse, 0 for softmax
    (the reference's reference/numpy_trainer.base_score)."""
    if loss == "softmax":
        return 0.0
    mean = (float(np.mean(y)) if sample_weight is None
            else float(np.average(y, weights=sample_weight)))
    if loss == "logloss":
        p = float(np.clip(mean, 1e-6, 1 - 1e-6))
        return float(np.log(p / (1 - p)))
    if loss == "mse":
        return mean
    raise ValueError(loss)


def base_score(y: torch.Tensor, loss: str) -> torch.Tensor:
    """Raw-score init as an f32 scalar tensor (the device form)."""
    m = y.to(torch.float32).mean()
    if loss == "logloss":
        p = m.clamp(1e-6, 1 - 1e-6)
        return torch.log(p / (1 - p))
    if loss == "mse":
        return m
    if loss == "softmax":
        return torch.zeros((), dtype=torch.float32, device=y.device)
    raise ValueError(loss)


def mean_loss(pred_raw: torch.Tensor, y: torch.Tensor, loss: str,
              valid: torch.Tensor | None = None,
              group=None) -> torch.Tensor:
    """Mean training loss (f32 scalar): over the rows, or weighted by
    `valid` (the instance weights, 0 on a rank's pad rows), whose sum is
    clamped at 1e-12 only (a clamp at 1 would shrink the loss of
    fractional weights). With a process group, the mean over every rank's
    rows: one all-reduce of the (sum, count) pair."""
    yf = y.to(torch.float32)
    if loss == "logloss":
        # Stable logistic loss: log(1 + e^x) - x*y.
        per = torch.logaddexp(torch.zeros_like(pred_raw), pred_raw) \
            - pred_raw * yf
    elif loss == "mse":
        per = torch.square(pred_raw - yf)
    elif loss == "softmax":
        logp = torch.log_softmax(pred_raw.to(torch.float32), dim=1)
        per = -logp.gather(1, y.to(torch.int64)[:, None])[:, 0]
    else:
        raise ValueError(loss)
    if valid is None:
        pair = torch.stack([per.sum(), torch.full(
            (), float(pred_raw.shape[0]), device=per.device)])
        floor = 1.0
    else:
        v = valid.to(torch.float32)
        pair = torch.stack([(per * v).sum(), v.sum()])
        floor = 1e-12
    pair = comms.psum(pair, group)
    return pair[0] / pair[1].clamp(min=floor)


def grad_hess(pred_raw: torch.Tensor, y: torch.Tensor,
              loss: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(g, h) of the loss with respect to the raw scores: f32 [R], or
    [R, C] for softmax (one-vs-all: p - onehot(y), p * (1 - p))."""
    pred = pred_raw.to(torch.float32)
    if loss == "logloss":
        p = torch.sigmoid(pred)
        return p - y.to(torch.float32), p * (1.0 - p)
    if loss == "mse":
        return pred - y.to(torch.float32), torch.ones_like(pred)
    if loss == "softmax":
        p = torch.softmax(pred, dim=1)
        onehot = (y.to(torch.int64)[:, None] == torch.arange(
            pred.shape[1], device=pred.device)[None, :]).to(torch.float32)
        return p - onehot, p * (1.0 - p)
    raise ValueError(loss)


#: Exact f32 path: bits of one row's fixed-point value (|q| <= 2^30, an
#: int32) and of any sum of them over the global rows (<= 2^62, an int64).
FIXED_ROW_BITS = 30
FIXED_SUM_BITS = 62


def fixed_headroom(n_rows_global: int) -> int:
    """Bits one row's |q| may take so that the sum over n_rows_global rows
    fits FIXED_SUM_BITS: FIXED_ROW_BITS until ceil(log2 N) passes 32."""
    return min(FIXED_ROW_BITS,
               FIXED_SUM_BITS - max(0, int(n_rows_global) - 1).bit_length())


def abs_max2(g: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """f32 [2] (max|g|, max|h|) of one tree's gradients (0 for no rows):
    the exact f32 path's statistic, maxed over chunks and ranks."""
    if g.numel() == 0:
        return torch.zeros(2, dtype=torch.float32, device=g.device)
    return torch.stack([g.abs().max(), h.abs().max()]).to(torch.float32)


def fixed_scales(max_abs: torch.Tensor, n_rows_global: int) -> torch.Tensor:
    """f32 [2] power-of-two scales 2^k (module docstring) for channels
    bounded by max_abs [2] (global over every row) over n_rows_global
    rows. frexp gives max = m * 2^e with m in [0.5, 1), so max < 2^e; an
    all-zero channel has e = 0."""
    _, e = torch.frexp(max_abs.to(torch.float32))
    k = (fixed_headroom(n_rows_global) - e.to(torch.int32)).clamp(-126, 126)
    return _exp2(k)


def to_fixed(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int64 rint(x * scale) of f32 x and a 0-dim power-of-two scale: the
    rounding the histogram kernel's exact mode applies to each row."""
    return torch.round(x.to(torch.float32) * scale).to(torch.int64)


def fixed_inverse(scales: torch.Tensor) -> torch.Tensor:
    """2^-k of f32 powers of two 2^k (k in [-126, 126]), exactly: from the
    exponent bits, not from a division."""
    k = ((scales.to(torch.float32).view(torch.int32) >> 23) & 0xFF) - 127
    return _exp2(-k)


def from_fixed(a: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """f32 of int64 fixed-point sums `a` ([..., 2]: the g and h channels
    of `scales` [2]): one rounding to f32, then the exact multiply by
    2^-k."""
    return a.to(torch.float32) * fixed_inverse(scales)


#: Partial sums a node keeps apart before they are added (leaf_gh_sums):
#: row i adds into partial i % LEAF_SPREAD of its node.
LEAF_SPREAD = 256


def leaf_gh_sums(idx: torch.Tensor, active: torch.Tensor, g: torch.Tensor,
                 h: torch.Tensor, n_last: int) -> torch.Tensor:
    """[n_last, 2] per-node (G, H) sums of the active rows (`idx` the
    node of each row). The reference contracts a one-hot on the MXU; here
    one index_add_ into LEAF_SPREAD partials a node, then a sum over them:
    on the card index_add_ adds with atomics, and with one partial a node
    the rows of a level with few nodes would all add into the same few
    addresses, one at a time (`kernel_bench.py --kernels leaf` times both
    forms). Integer g/h sum exactly: int8/int16 (quantized) into int32,
    int64 (the exact f32 path's fixed-point q's) into int64; the caller
    converts. f32 g/h sum in f32."""
    return _leaf_gh_sums(idx, active, g, h, n_last, LEAF_SPREAD)


def _leaf_gh_sums(idx, active, g, h, n_last: int,
                  spread: int) -> torch.Tensor:
    """leaf_gh_sums with `spread` partials a node."""
    acc = (torch.float32 if g.is_floating_point()
           else torch.int64 if g.dtype == torch.int64 else torch.int32)
    gh = torch.stack([torch.where(active, g, 0),
                      torch.where(active, h, 0)], dim=1).to(acc)
    R = g.shape[0]
    k = max(1, min(spread, R))
    slot = idx.to(torch.int64) * k + torch.arange(
        R, dtype=torch.int64, device=g.device) % k
    out = torch.zeros((n_last * k, 2), dtype=acc, device=g.device)
    out.index_add_(0, slot, gh)
    return out.view(n_last, k, 2).sum(dim=1, dtype=acc)


# --------------------------------------------------------------------- #
# quantized gradients (cfg.grad_dtype — see module docstring)
# --------------------------------------------------------------------- #

def grad_quant_dtype(grad_dtype: str) -> torch.dtype:
    """torch dtype for a quantized-gradient mode (validates the name)."""
    if grad_dtype not in GRAD_QMAX:
        raise ValueError(
            f"grad_dtype must be one of {GRAD_DTYPES[1:]} here, got "
            f"{grad_dtype!r}")
    return torch.int8 if grad_dtype == "int8" else torch.int16


def _f32(x, device) -> torch.Tensor:
    """A 0-dim f32 tensor on `device` (divisors must live there), made by
    a fill on the device rather than a copy from the host."""
    return torch.full((), x, dtype=torch.float32, device=device)


def _exp2(p: torch.Tensor) -> torch.Tensor:
    """Exactly 2^p in f32 for int32 p in [-149, 127], from exponent bits:
    a normal power times a power in [2^-23, 1] (exact, subnormals too)."""
    p1 = p.clamp(-126, 127)
    a = ((p1 + 127) << 23).view(torch.float32)
    b = ((p - p1 + 127) << 23).view(torch.float32)
    return a * b


def quant_scale(max_abs: torch.Tensor, sum_abs: torch.Tensor,
                grad_dtype: str) -> torch.Tensor:
    """Quantization step (f32 tensor on the stats' device, elementwise
    over the stats' shape) for values bounded by `max_abs` with total
    mass `sum_abs`: the tensor twin of quant_scale_np, bit for bit (exact
    max, IEEE f32 divides, an exact power of two for the snapped cap
    term). All-zero channels get 1.0."""
    dev = max_abs.device
    base = max_abs.to(torch.float32) / _f32(GRAD_QMAX[grad_dtype], dev)
    raw_cap = sum_abs.to(torch.float32) / _f32(GRAD_SUM_CAP, dev)
    m, e = torch.frexp(raw_cap)
    # ceil(log2(x)): x = m * 2^e with m in [0.5, 1); m == 0.5 (x an exact
    # power of two) snaps to e - 1 = log2(x).
    p = e.to(torch.int32) - (m == 0.5).to(torch.int32)
    cap = torch.where(raw_cap > 0, _exp2(p.clamp(-149, 127)),
                      _f32(0.0, dev))
    scale = torch.maximum(base, cap)
    return torch.where(scale > 0, scale, _f32(1.0, dev))


def quant_scale_np(max_abs: float, sum_abs: float,
                   grad_dtype: str) -> np.float32:
    """Host twin of quant_scale."""
    qmax = GRAD_QMAX[grad_dtype]
    base = np.float32(max_abs) / np.float32(qmax)
    raw_cap = np.float32(sum_abs) / np.float32(GRAD_SUM_CAP)
    cap = np.float32(0.0)
    if raw_cap > 0:
        m, e = np.frexp(raw_cap)
        cap = np.ldexp(np.float32(1.0), int(e) - int(m == np.float32(0.5)))
    scale = np.maximum(base, cap)
    return scale if scale > 0 else np.float32(1.0)


def grad_abs_stats(g: torch.Tensor, h: torch.Tensor, group=None,
                   shard: int | None = None):
    """(max|g|, sum|g|, max|h|, sum|h|) as 0-dim f32 tensors, over every
    rank's rows with a process group (one MAX and one SUM all-reduce).
    The max is exact in any order; the f32 sum's order differs between
    devices and partition counts by ULPs, which the cap term's
    power-of-two snap absorbs except at an exact frexp boundary. With
    `shard` (the row shard this rank holds) the sums add in shard order
    (comms.psum_ordered), whichever rank holds which shard."""
    ag = g.to(torch.float32).abs()
    ah = h.to(torch.float32).abs()
    maxes = comms.pmax(torch.stack([ag.max(), ah.max()]), group)
    part = torch.stack([ag.sum(), ah.sum()])
    sums = (comms.psum(part, group) if shard is None
            else comms.psum_ordered(part, group, shard))
    return maxes[0], sums[0], maxes[1], sums[1]


def quantize_with_scales(g: torch.Tensor, h: torch.Tensor,
                         gscale: torch.Tensor, hscale: torch.Tensor, *,
                         grad_dtype: str, tree_id, seed: int,
                         row_start: int = 0):
    """(qg, qh) int8/int16 [R] from f32 gradients and a pre-derived pair
    of scales (0-dim tensors on g's device). q = floor(g / scale + u),
    u the per-(seed ^ channel salt, tree_id, global row) uniform;
    on-grid values quantize exactly (u < 1 strictly). `tree_id` is an
    int or a 0-dim int64 tensor on g's device (ops/sampling.uniform), the
    form a captured round reads."""
    fq = float(GRAD_QMAX[grad_dtype])
    dt = grad_quant_dtype(grad_dtype)
    n, dev = g.shape[0], g.device
    gscale = torch.as_tensor(gscale, dtype=torch.float32, device=dev)
    hscale = torch.as_tensor(hscale, dtype=torch.float32, device=dev)
    ug = sampling.uniform(seed ^ _G_SALT, tree_id, row_start, n, dev)
    uh = sampling.uniform(seed ^ _H_SALT, tree_id, row_start, n, dev)
    qg = torch.floor(g.to(torch.float32) / gscale + ug).clamp(-fq, fq)
    qh = torch.floor(h.to(torch.float32) / hscale + uh).clamp(-fq, fq)
    return qg.to(dt), qh.to(dt)


def quantize_gradients(g: torch.Tensor, h: torch.Tensor, *,
                       grad_dtype: str, tree_id, seed: int,
                       row_start: int = 0, group=None,
                       n_rows_global: int | None = None,
                       shard: int | None = None):
    """One tree's quantization step on g's device: scales from the |g|,
    |h| stats (over every rank's rows with a process group; summed in
    shard order with `shard`, grad_abs_stats), then seeded
    stochastic rounding keyed by the global row id (this rank's rows
    start at `row_start`; `tree_id` an int or a 0-dim int64 tensor, as in
    quantize_with_scales). Returns (qg, qh, gscale, hscale); dequantize
    any integer aggregate A of the q's as A * scale, once. Refuses
    `n_rows_global` (default: g's rows) past GRAD_ROW_LIMIT, where the
    sum cap no longer guarantees int32 headroom."""
    if n_rows_global is None:
        n_rows_global = g.shape[0]
    if n_rows_global >= GRAD_ROW_LIMIT:
        raise ValueError(
            f"quantized gradients over {n_rows_global} rows exceed the "
            f"int32 overflow proof's row ceiling ({GRAD_ROW_LIMIT}): "
            "sum|q| <= 2^30 + n_rows must stay under INT32_MAX (see "
            "ops/grad.py); use grad_dtype='f32'")
    mg, sg, mh, sh = grad_abs_stats(g, h, group, shard)
    # quant_scale is elementwise: both channels in one pass.
    gscale, hscale = quant_scale(torch.stack([mg, mh]),
                                 torch.stack([sg, sh]), grad_dtype)
    qg, qh = quantize_with_scales(g, h, gscale, hscale,
                                  grad_dtype=grad_dtype, tree_id=tree_id,
                                  seed=seed, row_start=row_start)
    return qg, qh, gscale, hscale


def quantize_gradients_np(g: np.ndarray, h: np.ndarray, *,
                          grad_dtype: str, tree_id: int, seed: int,
                          row_start: int = 0,
                          gscale=None, hscale=None):
    """Host twin of quantize_gradients/quantize_with_scales (scales
    derived from this array's stats when not given). Returns (qg, qh,
    gscale, hscale)."""
    qmax = GRAD_QMAX[grad_dtype]
    npdt = np.int8 if grad_dtype == "int8" else np.int16
    g = np.asarray(g, np.float32)
    h = np.asarray(h, np.float32)
    if gscale is None:
        gscale = quant_scale_np(np.max(np.abs(g), initial=0.0),
                                np.sum(np.abs(g)), grad_dtype)
    if hscale is None:
        hscale = quant_scale_np(np.max(np.abs(h), initial=0.0),
                                np.sum(np.abs(h)), grad_dtype)
    n = g.shape[0]
    ug = sampling.uniform_np(seed ^ _G_SALT, tree_id, row_start, n)
    uh = sampling.uniform_np(seed ^ _H_SALT, tree_id, row_start, n)
    fq = np.float32(qmax)
    qg = np.clip(np.floor(g / np.float32(gscale) + ug), -fq, fq)
    qh = np.clip(np.floor(h / np.float32(hscale) + uh), -fq, fq)
    return qg.astype(npdt), qh.astype(npdt), gscale, hscale


def grad_quant_error_bound(grad_dtype: str, max_abs: float,
                           sum_abs: float, n_rows: int) -> float:
    """Worst-case absolute error of any integer aggregate of quantized
    gradients (a histogram entry, node total or leaf sum over up to
    `n_rows` rows) against the exact sum: one grid step per row from the
    rounding, plus one f32 rounding of the single dequantize multiply."""
    scale = float(quant_scale_np(max_abs, sum_abs, grad_dtype))
    rounding = n_rows * scale
    return rounding + 2.0 ** -23 * (float(sum_abs) + rounding)
