"""Rows made from the run's seed, on the device in a few large calls, then
handed to the program as host float arrays (the form a user's rows
arrive in). A configuration names its generator under "generator"; each
follows the recipe of the synthetic generator of the same purpose in
ddt_tpu_torch/data/datasets.py, drawn with torch.Generator instead of
numpy, so the same seed gives the same rows on any card.
"""

from __future__ import annotations

import numpy as np
import torch


def stream_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed for one named stream of a run's seed (any integer)."""
    ss = np.random.SeedSequence([int(seed) & (2**64 - 1), *stream])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _gen(device, seed: int, *stream: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, *stream))
    return g


def _to_host(t: torch.Tensor, dtype) -> np.ndarray:
    """A pageable host copy, made in row blocks so that the card holds one
    copy of the rows at most once more."""
    out = np.empty(tuple(t.shape), dtype)
    step = max(1, (1 << 28) // max(1, t[0].numel() * t.element_size()))
    for lo in range(0, t.shape[0], step):
        out[lo:lo + step] = t[lo:lo + step].cpu().numpy()
    return out


def higgs_like(rows: int, cfg: dict, seed: int, stream: int, device):
    """synthetic_binary's recipe: standard normal features, the label
    whether a nonlinear score of five of them plus noise passes its
    median."""
    g = _gen(device, seed, 1, stream)
    X = torch.randn((rows, cfg["features"]), generator=g, device=device)
    noise = torch.randn((rows,), generator=g, device=device)
    score = (torch.sin(X[:, 0] * 2.0) + X[:, 1] * X[:, 2]
             + 0.5 * X[:, 3].square() - (X[:, 4] > 0.5).float()
             + 0.5 * noise)
    y = (score > score.median()).to(torch.int32)
    return _to_host(X, np.float32), _to_host(y, np.int32)


def covtype_like(rows: int, cfg: dict, seed: int, stream: int, device):
    """synthetic_multiclass's recipe: one normal center a class (scale 2),
    a class drawn uniformly, unit normal noise around its center. The
    centers come from a stream of their own that no run's seed changes,
    as the source is one fixed table: every seed samples the same classes,
    and train and eval rows share them."""
    F, C = cfg["features"], cfg["classes"]
    centers = torch.randn((C, F), generator=_gen(device, 0, 2),
                          device=device) * 2.0
    g = _gen(device, seed, 2, stream)
    y = torch.randint(0, C, (rows,), generator=g, device=device)
    X = centers[y] + torch.randn((rows, F), generator=g, device=device)
    return _to_host(X, np.float32), _to_host(y.to(torch.int32), np.int32)


def criteo_like(rows: int, cfg: dict, seed: int, stream: int, device):
    """synthetic_ctr's recipe: normal numeric columns, categorical ids
    floor(cardinality * u^3) (a few heavy hitters), a quarter positives
    from a signal on two categorical columns and one numeric. The ids are
    encoded once, the same on every rank, by their expected frequency
    rank: id k < n_bins - 1 (whose expected frequency falls with k) to
    bin k + 1, the tail to bin 0, as a frequency encoder does."""
    nn, nc = cfg["numeric_features"], cfg["categorical_features"]
    g = _gen(device, seed, 3, stream)
    Xn = torch.randn((rows, nn), generator=g, device=device)
    u = torch.rand((rows, nc), generator=g, device=device, dtype=torch.float64)
    ids = torch.floor(cfg["cardinality"] * u.pow(3.0)).to(torch.int64)
    del u
    noise = torch.randn((rows,), generator=g, device=device)
    signal = (0.8 * torch.sin((ids[:, 0] % 17).float())
              + 0.6 * ((ids[:, 1] % 5) == 0).float()
              + 0.5 * Xn[:, 0] + 0.7 * noise)
    k = max(1, int(np.ceil(0.75 * rows)))
    y = (signal > signal.kthvalue(k).values).to(torch.int32)
    top = cfg["train"]["n_bins"] - 1
    cat = torch.where(ids < top, ids + 1, torch.zeros_like(ids)).float()
    X = torch.cat([Xn, cat], dim=1)
    return _to_host(X, np.float32), _to_host(y, np.int32)


GENERATORS = {"higgs_like": higgs_like, "covtype_like": covtype_like,
              "criteo_like": criteo_like}


def make_rows(cfg: dict, rows: int, seed: int, stream: int, device):
    """(X float32 [rows, F], y int32 [rows]) on the host."""
    return GENERATORS[cfg["generator"]](rows, cfg, seed, stream, device)
