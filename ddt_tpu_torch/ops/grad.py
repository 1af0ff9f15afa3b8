"""Loss gradients/hessians, the training loss, per-leaf (G, H) sums, and
the quantized-gradient step.

Port of ddt_tpu/ops/grad.py (binary logloss and mse; softmax is not
ported yet). Elementwise PyTorch in float32, on whatever device the
tensors live on.

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


def base_score_np(y: np.ndarray, loss: str) -> float:
    """Raw-score init on host, as the Driver computes it: log-odds of the
    mean label for logloss, the mean for mse (the reference's
    reference/numpy_trainer.base_score without sample weights)."""
    mean = float(np.mean(y))
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
    raise ValueError(loss)


def mean_loss(pred_raw: torch.Tensor, y: torch.Tensor,
              loss: str) -> torch.Tensor:
    """Mean training loss over the rows (f32 scalar)."""
    yf = y.to(torch.float32)
    if loss == "logloss":
        # Stable logistic loss: log(1 + e^x) - x*y.
        per = torch.logaddexp(torch.zeros_like(pred_raw), pred_raw) \
            - pred_raw * yf
        return per.sum() / max(pred_raw.shape[0], 1)
    if loss == "mse":
        return torch.square(pred_raw - yf).sum() / max(pred_raw.shape[0], 1)
    raise ValueError(loss)


def grad_hess(pred_raw: torch.Tensor, y: torch.Tensor,
              loss: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(g, h) of the loss with respect to the raw scores, f32 [R]."""
    pred = pred_raw.to(torch.float32)
    yf = y.to(torch.float32)
    if loss == "logloss":
        p = torch.sigmoid(pred)
        return p - yf, p * (1.0 - p)
    if loss == "mse":
        return pred - yf, torch.ones_like(pred)
    raise ValueError(loss)


def leaf_gh_sums(idx: torch.Tensor, active: torch.Tensor, g: torch.Tensor,
                 h: torch.Tensor, n_last: int) -> torch.Tensor:
    """[n_last, 2] per-leaf (G, H) sums of the active rows. The reference
    contracts a one-hot on the MXU; here one index_add_ (the f32 sums
    agree to summation order, which leaf values are tolerance-compared
    on). Integer (quantized) g/h sum exactly into int32; the caller
    dequantizes."""
    if not g.is_floating_point():
        gh = torch.stack([torch.where(active, g, 0),
                          torch.where(active, h, 0)], dim=1).to(torch.int32)
        out = torch.zeros((n_last, 2), dtype=torch.int32, device=g.device)
        return out.index_add_(0, idx.to(torch.int64), gh)
    gh = torch.stack([torch.where(active, g, 0.0),
                      torch.where(active, h, 0.0)], dim=1).float()
    out = torch.zeros((n_last, 2), dtype=torch.float32, device=g.device)
    return out.index_add_(0, idx.to(torch.int64), gh)


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


def grad_abs_stats(g: torch.Tensor, h: torch.Tensor):
    """(max|g|, sum|g|, max|h|, sum|h|) as 0-dim f32 tensors. The max is
    exact in any order; the f32 sum's order differs between devices by
    ULPs, which the cap term's power-of-two snap absorbs except at an
    exact frexp boundary."""
    ag = g.to(torch.float32).abs()
    ah = h.to(torch.float32).abs()
    return ag.max(), ag.sum(), ah.max(), ah.sum()


def quantize_with_scales(g: torch.Tensor, h: torch.Tensor,
                         gscale: torch.Tensor, hscale: torch.Tensor, *,
                         grad_dtype: str, tree_id: int, seed: int,
                         row_start: int = 0):
    """(qg, qh) int8/int16 [R] from f32 gradients and a pre-derived pair
    of scales (0-dim tensors on g's device). q = floor(g / scale + u),
    u the per-(seed ^ channel salt, tree_id, global row) uniform;
    on-grid values quantize exactly (u < 1 strictly)."""
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
                       grad_dtype: str, tree_id: int, seed: int,
                       row_start: int = 0):
    """One tree's quantization step on g's device: scales from the |g|,
    |h| stats, then seeded stochastic rounding. Returns (qg, qh, gscale,
    hscale); dequantize any integer aggregate A of the q's as A * scale,
    once. Refuses row counts past GRAD_ROW_LIMIT, where the sum cap no
    longer guarantees int32 headroom."""
    if g.shape[0] >= GRAD_ROW_LIMIT:
        raise ValueError(
            f"quantized gradients over {g.shape[0]} rows exceed the int32 "
            f"overflow proof's row ceiling ({GRAD_ROW_LIMIT}): sum|q| <= "
            "2^30 + n_rows must stay under INT32_MAX (see ops/grad.py); "
            "use grad_dtype='f32'")
    mg, sg, mh, sh = grad_abs_stats(g, h)
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
