"""SplitGain: scan histogram bins, score splits, argmax per node.

Port of ddt_tpu/ops/split.py (`best_splits_impl`, `node_totals`). Cumulative
sums over the bin axis, the XGBoost gain formula, then an argmax over the
flattened (feature, bin) axis with gains rounded to bfloat16 first and the
first flattened index winning ties, so every implementation picks the same
split from histograms that agree to f32 noise (the reference's
"determinism boundary" notes say where that stops holding). Invalid
candidates score -inf.

The exact f32 path hands an int64 fixed-point histogram (ops/grad, module
docstring) with its inverse scales: the prefix sums over bins, each
side's complement and the missing bin's move are taken in int64, exactly,
and each operand of the gain converts to f32 once. So the gains depend on
the rows alone, not on the order the card summed them in: the same
histogram gives the same split on every run, pass, chunking and resume.
"""

from __future__ import annotations

import torch


def node_totals(hist: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(G, H) per node: sums over bins of feature 0 (any feature sums the
    same rows). f32 [n_nodes] each for an f32 histogram; for an integer
    histogram (the quantized path's raw int32, the exact path's int64)
    the exact integer sums (int64), which the caller converts."""
    return hist[:, 0, :, 0].sum(dim=1), hist[:, 0, :, 1].sum(dim=1)


def _argmax_bf16(gain: torch.Tensor, valid: torch.Tensor):
    """(best gain f32, flat index) per node: gains rounded to bf16, invalid
    candidates -inf, the first maximal flattened index wins."""
    g16 = torch.where(valid, gain, -torch.inf).to(torch.bfloat16)
    flat = g16.to(torch.float32).reshape(gain.shape[0], -1)  # exact widen
    best = torch.argmax(flat, dim=1)
    return flat.gather(1, best[:, None])[:, 0], best


def best_splits_impl(
    hist: torch.Tensor,             # f32 (or int64 fixed point) [n, F, B, 2]
    reg_lambda: float,
    min_child_weight: float,
    feature_mask: torch.Tensor | None = None,   # bool [F]; False = excluded
    missing_bin: bool = False,
    cat_mask: torch.Tensor | None = None,       # bool [F]; True = categorical
    inv_scale: torch.Tensor | None = None,      # f32 [2]: 2^-k (int64 hist)
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-node best split: (gain f32 [n], feature int32 [n], bin int32 [n],
    default_left bool [n]).

    gain = 0.5 * (GL^2/(HL+l) + GR^2/(HR+l) - G^2/(H+l)); a split at bin b
    sends bins <= b left; the last bin is invalid (empty right child);
    children must carry >= min_child_weight hessian mass.

    missing_bin=True: bin B-1 holds NaN rows; both default directions are
    scored and the argmax runs over (direction, feature, bin) with the
    RIGHT block first. cat_mask marks categorical features, whose
    one-vs-rest candidates ("bin == k goes left", every bin valid) replace
    the ordinal gains, in the RIGHT block only.

    An int64 histogram (the exact path) takes `inv_scale`, its f32 [2]
    2^-k per channel: every sum below is then taken in int64 and
    converted once (module docstring).
    """
    n_nodes, F, B, _ = hist.shape
    dev = hist.device
    bins = torch.arange(B, device=dev)
    if hist.is_floating_point():
        GL = torch.cumsum(hist[..., 0], dim=2)          # [n, F, B]
        HL = torch.cumsum(hist[..., 1], dim=2)
        # Per-feature totals (feature f's own cumsum tail): degenerate
        # candidates get an exactly-zero complement.
        G = GL[:, :, B - 1:B]
        H = HL[:, :, B - 1:B]

        def sides(which):
            """(GL, HL, GR, HR) of the ordinal candidates, the single-bin
            (one-vs-rest) ones or the ordinal ones with the missing bin
            moved left."""
            if which == "ordinal":
                GLd, HLd = GL, HL
            elif which == "single":
                GLd, HLd = hist[..., 0], hist[..., 1]
            else:
                GLd = GL + hist[:, :, B - 1:B, 0]
                HLd = HL + hist[:, :, B - 1:B, 1]
            return GLd, HLd, G - GLd, H - HLd
    else:
        if inv_scale is None:
            raise ValueError("an integer histogram needs its inv_scale")
        cum = torch.cumsum(hist.to(torch.int64), dim=2)  # exact
        tot = cum[:, :, B - 1:B]

        def f32(a):
            return a.to(torch.float32) * inv_scale

        G, H = f32(tot).unbind(-1)

        def sides(which):
            left = (cum if which == "ordinal"
                    else hist.to(torch.int64) if which == "single"
                    else cum + hist[:, :, B - 1:B])
            lf, rf = f32(left), f32(tot - left)
            return lf[..., 0], lf[..., 1], rf[..., 0], rf[..., 1]

    def gain_of(which):
        GLd, HLd, GR, HR = sides(which)
        parent = torch.square(G) / (H + reg_lambda)
        gain = 0.5 * (torch.square(GLd) / (HLd + reg_lambda)
                      + torch.square(GR) / (HR + reg_lambda)
                      - parent)
        valid = (HLd >= min_child_weight) & (HR >= min_child_weight)
        valid = valid & ~torch.isnan(gain)           # 0/0 at reg_lambda 0
        if feature_mask is not None:
            valid = valid & feature_mask[None, :, None]
        return gain, valid

    def overlay_cat(gain, valid):
        if cat_mask is None:
            return gain, valid
        gc, vc = gain_of("single")
        m = cat_mask[None, :, None]
        return torch.where(m, gc, gain), torch.where(m, vc, valid)

    if not missing_bin:
        gain, valid = gain_of("ordinal")
        valid = valid & (bins < B - 1)[None, None, :]
        gain, valid = overlay_cat(gain, valid)
        best_gain, best = _argmax_bf16(gain, valid)
        return (best_gain, (best // B).to(torch.int32),
                (best % B).to(torch.int32),
                torch.zeros(n_nodes, dtype=torch.bool, device=dev))

    gain_r, valid_r = gain_of("ordinal")                   # missing RIGHT
    gain_l, valid_l = gain_of("missing_left")              # missing LEFT
    valid_r = valid_r & (bins < B - 1)[None, None, :]
    # t = B-2 under LEFT puts every row left (empty right child).
    valid_l = valid_l & (bins < B - 2)[None, None, :]
    gain_r, valid_r = overlay_cat(gain_r, valid_r)
    if cat_mask is not None:
        valid_l = valid_l & ~cat_mask[None, :, None]        # cat: RIGHT only
    best_gain, best = _argmax_bf16(torch.cat([gain_r, gain_l], dim=1),
                                   torch.cat([valid_r, valid_l], dim=1))
    fb = best % (F * B)
    return (best_gain, (fb // B).to(torch.int32), (fb % B).to(torch.int32),
            best >= F * B)
