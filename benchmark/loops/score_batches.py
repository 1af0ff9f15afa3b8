"""Batch scoring in a closed loop of one client: each batch one
`api.predict` on host float rows with the model's mapper, returning
probabilities on the host (binning on the card, the traversal, the
copies both ways).

The model is made at set-up from the seed (the configuration's
"scoring_model": complete trees, split features and bins drawn
uniformly, normal leaf values) with raw thresholds from edges fitted on
the rows; the rows are a pool of `pool_batches` batches of `batch_rows`
made at set-up, and the batches cycle through it. Each batch's output is
kept at `check_rows` positions drawn from the seed for the check.
End to end: `score_rows_per_s` over the window and the 90th percentile
of the batches' times, `score_batch_p90_ms`.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from benchmark.core import data, work
from benchmark.reference import gbdt as ref

import ddt_tpu_torch.api as api
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.data.quantizer import BinMapper
from ddt_tpu_torch.models.tree import TreeEnsemble


@dataclasses.dataclass
class Model:
    """The harness's own copy of the scored ensemble."""
    feature: np.ndarray
    threshold_bin: np.ndarray
    threshold_raw: np.ndarray
    is_leaf: np.ndarray
    leaf_value: np.ndarray
    edges: np.ndarray
    max_depth: int
    learning_rate: float


@dataclasses.dataclass
class State:
    ctx: object
    model: Model
    pool: list
    cfg: TrainConfig
    kept: list = dataclasses.field(default_factory=list)  # (slot, pos, out)
    times: list = dataclasses.field(default_factory=list)
    served: int = 0


def make_model(config: dict, rows: np.ndarray, seed: int) -> Model:
    m = config["scoring_model"]
    T, D, B = m["trees"], m["max_depth"], config["train"]["n_bins"]
    F = rows.shape[1]
    N = (1 << (D + 1)) - 1
    inner = (1 << D) - 1
    rng = np.random.default_rng(data.stream_seed(seed, 5))
    feature = np.full((T, N), -1, np.int32)
    feature[:, :inner] = rng.integers(0, F, (T, inner))
    tb = np.zeros((T, N), np.int32)
    tb[:, :inner] = rng.integers(0, B - 1, (T, inner))
    is_leaf = np.zeros((T, N), bool)
    is_leaf[:, inner:] = True
    leaf = np.zeros((T, N), np.float32)
    leaf[:, inner:] = rng.normal(0.0, m["leaf_std"], (T, N - inner))
    edges = ref.fit_edges(rows, B, data.stream_seed(seed, 6) % 2**31)
    raw = np.where(is_leaf, np.float32(0), edges[np.maximum(feature, 0),
                                                 np.minimum(tb, B - 2)])
    return Model(feature, tb, raw.astype(np.float32), is_leaf, leaf, edges,
                 D, m["learning_rate"])


def program_model(model: Model, config: dict):
    B = config["train"]["n_bins"]
    T, N = model.feature.shape
    ens = TreeEnsemble(
        feature=model.feature.copy(), threshold_bin=model.threshold_bin.copy(),
        threshold_raw=model.threshold_raw.copy(), is_leaf=model.is_leaf.copy(),
        leaf_value=model.leaf_value.copy(),
        split_gain=np.zeros((T, N), np.float32), max_depth=model.max_depth,
        n_features=model.edges.shape[0], learning_rate=model.learning_rate,
        base_score=0.0, loss="logloss", has_raw_thresholds=True,
        default_left=np.zeros((T, N), bool), n_bins=B)
    return ens, BinMapper(edges=model.edges.copy(), n_bins=B)


def setup(ctx) -> State:
    config, mix = ctx.cell.config, ctx.cell.traffic
    with ctx.tracer.span("setup.rows"):
        pool = [data.make_rows(config, mix["batch_rows"], ctx.seed, 10 + p,
                               ctx.device)[0]
                for p in range(mix["pool_batches"])]
    with ctx.tracer.span("setup.model"):
        model = make_model(config, pool[0], ctx.seed)
    st = State(ctx, model, pool, TrainConfig(device=ctx.device.type,
                                             **ctx.overrides))
    st.ens, st.mapper = program_model(model, config)
    with ctx.tracer.span("setup.warm"):
        api.predict(st.ens, pool[0], mapper=st.mapper, cfg=st.cfg)
    return st


def step(st: State) -> None:
    b = st.served
    st.served += 1
    slot = b % len(st.pool)
    t0 = time.perf_counter()
    with st.ctx.tracer.span("bench.predict"):
        out = api.predict(st.ens, st.pool[slot], mapper=st.mapper,
                          cfg=st.cfg)
    st.times.append(time.perf_counter() - t0)
    rows = st.pool[slot].shape[0]
    if out.shape != (rows,):
        raise ValueError(f"batch {b}: {out.shape} scores for {rows} rows")
    rng = np.random.default_rng(data.stream_seed(st.ctx.seed, 7, b))
    pos = rng.integers(0, rows, st.ctx.cell.traffic["check_rows"])
    st.kept.append((slot, pos, out[pos].copy()))


def end_to_end(st: State, window_s: float) -> dict:
    if not st.times:
        return {}
    rows = sum(st.pool[i % len(st.pool)].shape[0]
               for i in range(len(st.times)))
    return {"score_rows_per_s": rows / window_s,
            "score_batch_p90_ms": float(np.quantile(st.times, 0.9)) * 1e3}


def release(st: State) -> None:
    st.ens = st.mapper = None


def _ref_probs(st: State, slot: int, pos: np.ndarray):
    m = st.model
    X = torch.from_numpy(st.pool[slot][pos]).to(st.ctx.device)
    margin = ref.score_raw(X, m.feature, m.threshold_raw, m.is_leaf,
                           m.leaf_value, max_depth=m.max_depth,
                           learning_rate=m.learning_rate, base=0.0)
    return X, torch.sigmoid(margin).cpu().numpy()


def check(st: State) -> dict:
    """The widest gap between a served probability and the reference's,
    over every kept position of every batch of the window."""
    gap = 0.0
    for slot in range(len(st.pool)):
        mine = [(p, o) for s, p, o in st.kept if s == slot]
        if not mine:
            continue
        pos = np.unique(np.concatenate([p for p, _ in mine]))
        X, want = _ref_probs(st, slot, pos)
        for p, o in mine:
            w = want[np.searchsorted(pos, p)]
            gap = max(gap, float(np.max(np.abs(o.astype(np.float64) - w))))
        if st.ctx.tracer.enabled and slot == 0:
            m = st.model
            st.compares_per_row = float(ref.leaf_depths(
                X, m.feature, m.threshold_raw, m.is_leaf,
                m.max_depth).double().mean())
    return {"prob_gap": gap}


def layer_inputs(st: State) -> dict:
    m = st.model
    batches = len(st.times)
    F = m.edges.shape[0]
    T, N = m.feature.shape
    out = {"batches": batches, "work": None}
    cpr = getattr(st, "compares_per_row", None)
    if cpr is not None:
        r = st.pool[0].shape[0]
        out["work"] = {
            "traverse": work.traverse_work(r, F, T, N, cpr * r).scaled(
                batches),
            "binning": work.binning_work(r, F, m.edges.shape[1] + 1).scaled(
                batches)}
    return out
