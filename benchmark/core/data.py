"""Rows made from the run's seed, on the device in a few large calls, then
handed to the program as host float arrays (the form a user's rows
arrive in). A configuration names its generator under "generator".
higgs_like and criteo_like follow the recipes of the synthetic generators
of the same purpose in ddt_tpu_torch/data/datasets.py; covtype_like
follows the source's published shape, with its parameters in the
configuration. All draw with torch.Generator instead of numpy, so the
same seed gives the same rows on any card.
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


def _split(counts, rows: int) -> list:
    """`rows` shared out in proportion to `counts`, largest remainders
    first: the same whole numbers for every seed."""
    c = np.asarray(counts, np.float64)
    share = c * rows / c.sum()
    out = np.floor(share).astype(np.int64)
    rest = np.argsort(-(share - out), kind="stable")[:rows - out.sum()]
    out[rest] += 1
    return out.tolist()


def covtype_like(rows: int, cfg: dict, seed: int, stream: int, device):
    """Rows in the published shape of UCI Covertype: 10 quantitative
    columns, whole numbers within the data's ranges (each column's stand
    centers lo + (hi - lo) * u**skew), then one-hot columns
    of 4 wilderness areas and 40 soil types; the classes in the source's
    proportions (the same counts for every seed, in an order drawn from
    it). Each row comes from a stand, a patch of one class: the stand's
    center in the quantitative columns (its elevation about its class's),
    its area and its soil; the row lies around the center by a share of
    each column's range, and now and then takes its class's area or soil
    in place of its stand's. Stands overlap, so do classes. The source is
    one fixed table, so the stands and the rows come from streams that no
    run's seed changes (train and eval rows share the stands); the seed
    orders the rows. A seed thus changes no job's work, which early
    stopping would otherwise make a seed's own."""
    sh = cfg["shape"]
    quant = sh["quantitative"]
    lo = torch.tensor([q[1] for q in quant], dtype=torch.float32,
                      device=device)
    hi = torch.tensor([q[2] for q in quant], dtype=torch.float32,
                      device=device)
    A, K, Q = sh["wilderness_areas"], sh["soil_types"], len(quant)
    counts = sh["class_counts"]
    C = len(counts)
    # The fixed table: stands shared out over the classes by their rows.
    t = _gen(device, 0, 2)
    n_st = torch.tensor([max(4, n) for n in _split(counts, sh["stands"])],
                        device=device)
    S = int(n_st.sum())
    cls = torch.repeat_interleave(torch.arange(C, device=device), n_st)
    skew = torch.tensor([q[3] for q in quant], dtype=torch.float32,
                        device=device)
    center = lo + (hi - lo) * torch.rand((S, Q), generator=t,
                                         device=device).pow(skew)
    elev = torch.tensor(sh["elevation_by_class"], dtype=torch.float32,
                        device=device)
    center[:, 0] = elev[cls, 0] + elev[cls, 1] * torch.randn(
        (S,), generator=t, device=device)
    area_p = torch.rand((C, A), generator=t, device=device).pow(3)
    soil_p = torch.rand((C, K), generator=t, device=device).pow(6)
    st_area = torch.multinomial(area_p[cls], 1, generator=t).squeeze(1)
    st_soil = torch.multinomial(soil_p[cls], 1, generator=t).squeeze(1)
    # The rows: exact class counts, a stand of the row's class, noise
    # around its center; drawn from a stream of their own, the same rows
    # for every seed, which puts them in its own order.
    g = _gen(device, 0, 3, stream)
    y = torch.repeat_interleave(
        torch.arange(C, device=device),
        torch.tensor(_split(counts, rows), device=device))
    y = y[torch.randperm(rows, generator=g, device=device)]
    first = torch.cumsum(n_st, 0) - n_st
    k = first[y] + torch.minimum(
        (torch.rand((rows,), generator=g, device=device) * n_st[y]).long(),
        n_st[y] - 1)
    Xq = center[k] + torch.randn((rows, Q), generator=g, device=device) \
        * ((hi - lo) * sh["stand_width"])
    Xq[:, 1] = torch.remainder(Xq[:, 1], hi[1] - lo[1])    # aspect, degrees
    Xq = torch.minimum(torch.maximum(Xq.round(), lo), hi)
    stray = sh["stray"]
    area = torch.where(
        torch.rand((rows,), generator=g, device=device) < stray,
        torch.multinomial(area_p[y], 1, generator=g).squeeze(1), st_area[k])
    soil = torch.where(
        torch.rand((rows,), generator=g, device=device) < stray,
        torch.multinomial(soil_p[y], 1, generator=g).squeeze(1), st_soil[k])
    X = torch.cat([Xq, torch.nn.functional.one_hot(area, A).float(),
                   torch.nn.functional.one_hot(soil, K).float()], dim=1)
    order = torch.randperm(rows, generator=_gen(device, seed, 2, stream),
                           device=device)
    return (_to_host(X[order], np.float32),
            _to_host(y[order].to(torch.int32), np.int32))


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
