"""Training jobs back to back: each one `api.train` on host float rows
(edge fitting, binning on the card, the fused boosting loop, the model's
fetch), with the configuration's eval rows and early stopping where it
has them, on one card or on every rank of a row-partitioned group.

The traffic mix gives `warm_rounds` (the warm-up job's rounds, which
build and capture at the window's shapes) and `check_rounds` (rounds of
the checked job whose splits the reference searches again, drawn from
the seed, besides the first three and the last; every leaf of every
round is judged). End to end: `train_round_ms`, the window's
milliseconds over the rounds its jobs trained.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.core import data, work
from benchmark.reference import gbdt as ref

import ddt_tpu_torch.api as api
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.data import quantizer


@dataclasses.dataclass
class State:
    ctx: object
    cfg: TrainConfig
    X: np.ndarray
    y: np.ndarray
    eval_set: tuple | None
    patience: int | None
    jobs: list = dataclasses.field(default_factory=list)


def train_config(ctx, config: dict) -> TrainConfig:
    t = dict(config["train"])
    t.update(ctx.overrides)
    t["cat_features"] = tuple(t.get("cat_features", ()))
    return TrainConfig(device=ctx.device.type, n_partitions=ctx.world,
                       seed=data.stream_seed(ctx.seed, 9) % 2**31, **t)


def setup(ctx) -> State:
    config = ctx.cell.config
    with ctx.tracer.span("setup.rows"):
        X, y = data.make_rows(config, config["rows"], ctx.seed, 0,
                              ctx.device)
        ev = None
        if config.get("eval_rows"):
            ev = data.make_rows(config, config["eval_rows"], ctx.seed, 1,
                                ctx.device)
    st = State(ctx, train_config(ctx, config), X, y, ev,
               config.get("early_stopping_rounds"))
    warm = dataclasses.replace(st, jobs=[])
    warm.cfg = st.cfg.replace(n_trees=ctx.cell.traffic["warm_rounds"])
    with ctx.tracer.span("setup.warm"):
        _job(warm)
    return st


def _job(st: State):
    kw = {}
    if st.eval_set is not None:
        kw = dict(eval_set=st.eval_set,
                  early_stopping_rounds=st.patience)
    tr = st.ctx.tracer
    mapper = None
    if tr.enabled:
        # The traced run fits the edges itself to time them apart: the
        # same work api.train does, in two calls.
        with tr.span("bench.edges"):
            mapper = quantizer.fit_bin_mapper(
                st.X, n_bins=st.cfg.n_bins, seed=st.cfg.seed,
                missing_policy=st.cfg.missing_policy,
                cat_features=st.cfg.cat_features)
    with tr.span("bench.train"):
        return api.train(st.X, st.y, st.cfg, mapper=mapper, **kw)


def step(st: State) -> None:
    st.jobs.append(_job(st))


def rounds_trained(res) -> int:
    return int(res.history[-1]["round"])


def end_to_end(st: State, window_s: float) -> dict:
    rounds = sum(rounds_trained(r) for r in st.jobs)
    return {"train_round_ms": window_s * 1e3 / rounds} if rounds else {}


def release(st: State) -> None:
    """Nothing to drop: a job's result holds host arrays alone."""


def _trees(ens, t0: int, t1: int) -> list:
    return [ref.Tree(ens.feature[t], ens.threshold_bin[t], ens.is_leaf[t],
                     ens.leaf_value[t]) for t in range(t0, t1)]


def check(st: State) -> dict:
    """The plain reference's view of one job drawn from the seed."""
    ctx, config = st.ctx, st.ctx.cell.config
    t = config["train"]
    dev = ctx.device
    if not st.jobs:
        return {}
    rng = np.random.default_rng(data.stream_seed(ctx.seed, 11))
    res = st.jobs[int(rng.integers(len(st.jobs)))]
    ens = res.ensemble
    loss, C = t["loss"], (t["n_classes"] if t["loss"] == "softmax" else 1)
    B, D = t["n_bins"], t["max_depth"]
    cat = tuple(t.get("cat_features", ()))
    edges = ref.fit_edges(st.X, B, st.cfg.seed, cat_features=cat)
    exact = _exact_mismatches(res, edges, st.y, loss, C, B)
    Xb = ref.bin_rows(st.X, edges, dev)
    y = torch.from_numpy(st.y).to(dev)
    cat_mask = None
    if cat:
        cat_mask = torch.zeros(Xb.shape[1], dtype=torch.bool, device=dev)
        cat_mask[list(cat)] = True
    rounds = ens.n_trees // C
    extra = rng.choice(np.arange(3, max(3, rounds - 1)), replace=False,
                       size=min(st.ctx.cell.traffic["check_rounds"],
                                max(0, rounds - 4)))
    checked = sorted({0, 1, 2, rounds - 1, *extra.tolist()} & set(
        range(rounds)))
    bs = ref.base_score(st.y, loss)
    # Margins in float32, the stated precision, added to tree by tree as
    # lr * leaf: the very numbers a sound program's gradients read.
    margin = torch.full((Xb.shape[0],) if C == 1 else (Xb.shape[0], C),
                        bs, dtype=torch.float32, device=dev)
    ev_margin = ev_y = None
    if st.eval_set is not None:
        Xv = ref.bin_rows(st.eval_set[0], edges, dev)
        ev_y = torch.from_numpy(st.eval_set[1]).to(dev)
        ev_margin = torch.full((Xv.shape[0], C), bs, dtype=torch.float32,
                               device=dev)
    # The program's last reported training loss within the model it kept:
    # an early stop keeps the rounds up to the best, which the history
    # runs past.
    reported = [r for r in res.history
                if r.get("train_loss") is not None and r["round"] <= rounds]
    at = reported[-1] if reported else None
    nodes = mism = 0
    leaves = []
    eval_at_best = loss_ref = None
    lr = t["learning_rate"]
    for rnd in range(rounds):
        # Every round's gradients: every leaf of every tree is judged; the
        # split search only in the rounds drawn.
        g, h = ref.grad_hess(margin, y, loss)
        for c, tree in enumerate(_trees(ens, rnd * C, rnd * C + C)):
            gc = g if C == 1 else g[:, c].contiguous()
            hc = h if C == 1 else h[:, c].contiguous()
            if rnd in checked:
                tc = ref.check_tree(
                    Xb, gc, hc, tree, max_depth=D, n_bins=B,
                    reg_lambda=t["reg_lambda"],
                    min_child_weight=t["min_child_weight"],
                    min_split_gain=t["min_split_gain"], cat_mask=cat_mask)
                nodes, mism = nodes + tc.nodes, mism + tc.mismatches
                leaves += tc.leaves
                leaf = tc.leaf_of_row
            else:
                leaf = ref.leaf_index(Xb, tree, D, cat_mask)
                leaves += ref.leaf_values(tree, leaf, gc, hc,
                                          t["reg_lambda"])
            vals = torch.from_numpy(tree.leaf_value.astype(np.float32)).to(
                dev)
            delta = lr * vals[leaf]
            if C == 1:
                margin += delta
            else:
                margin[:, c] += delta
            if ev_margin is not None:
                ev_margin[:, c] += lr * vals[ref.leaf_index(Xv, tree, D,
                                                            cat_mask)]
        if at is not None and rnd + 1 == at["round"]:
            loss_ref = ref.mean_loss(margin, y, loss)
        if ev_margin is not None and rnd == res.best_round:
            eval_at_best = ref.mean_loss(
                ev_margin if C > 1 else ev_margin[:, 0], ev_y, loss)
    out = {"exact_mismatches": float(exact),
           "split_mismatch": mism / max(1, nodes),
           "leaf_gap": ref.leaf_gap(leaves)}
    if loss_ref is not None:
        out["loss_gap"] = abs(at["train_loss"] - loss_ref) / loss_ref
    if eval_at_best is not None:
        out["eval_gap"] = abs(res.best_score - eval_at_best) / eval_at_best
    if ctx.tracer.enabled:
        with ctx.tracer.span("check.work"):
            st.work_per_round = _work_per_round(st, Xb, ens, C, D, cat_mask)
    return out


def _exact_mismatches(res, edges, y, loss, C, B) -> int:
    """Edges, the base score and every split's raw threshold, bit for bit
    (each must equal the reference's), and the model's tree count."""
    ens = res.ensemble
    n = 0
    if res.mapper is None or res.mapper.edges.shape != edges.shape:
        n += edges.size
    else:
        n += int((res.mapper.edges.view(np.uint32)
                  != edges.view(np.uint32)).sum())
    n += int(ens.base_score != ref.base_score(y, loss))
    split = ens.feature >= 0
    f = np.where(split, ens.feature, 0)
    tb = ens.threshold_bin
    want = np.where(tb >= B - 1, np.float32(np.inf),
                    edges[f, np.clip(tb, 0, B - 2)])
    n += int((split & (want.view(np.uint32)
                       != ens.threshold_raw.astype(np.float32).view(
                           np.uint32))).sum())
    n += int(ens.n_trees % C != 0)
    return n


def _work_per_round(st, Xb, ens, C, D, cat_mask) -> dict:
    """The least work of one round on rank 0's rows (a row partition's
    block, or every row on one card), averaged over the model's rounds."""
    local = -(-Xb.shape[0] // st.ctx.world)
    Xr = Xb[:local]
    F = Xb.shape[1]
    B = st.ctx.cell.config["train"]["n_bins"]
    hist = work.Work()
    for tree in _trees(ens, 0, ens.n_trees):
        counts = ref.level_counts(Xr, tree, D, cat_mask)
        hist += work.hist_work(work.built_rows(counts), F, B)
    rounds = ens.n_trees // C
    return {"hist": hist.scaled(1.0 / rounds),
            "rest": work.round_rest_work(local, C, D)}


def layer_inputs(st: State) -> dict:
    rounds = sum(rounds_trained(r) for r in st.jobs)
    per = getattr(st, "work_per_round", None)
    return {"histories": [r.history for r in st.jobs], "rounds": rounds,
            "work": None if per is None else
            {k: v.scaled(rounds) for k, v in per.items()},
            "world": st.ctx.world}
