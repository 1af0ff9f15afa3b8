"""Loss gradients/hessians, the training loss, and per-leaf (G, H) sums.

Port of the f32 half of ddt_tpu/ops/grad.py (binary logloss and mse;
softmax and the quantized-gradient path are not ported yet). Elementwise
PyTorch in float32, on whatever device the tensors live on.
"""

from __future__ import annotations

import numpy as np
import torch


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
    contracts a one-hot on the MXU; here one index_add_ (the sums agree to
    f32 summation order, which leaf values are tolerance-compared on)."""
    gh = torch.stack([torch.where(active, g, 0.0),
                      torch.where(active, h, 0.0)], dim=1).float()
    out = torch.zeros((n_last, 2), dtype=torch.float32, device=g.device)
    return out.index_add_(0, idx.to(torch.int64), gh)
