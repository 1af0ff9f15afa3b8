"""Kernel times on the card, for this checkout and others.

    python -m ddt_tpu_torch.kernel_bench [--kernels hist,lut,traverse,leaf]
                                         [--other DIR ...]

Every time is taken with chip_smoke.py's timer (one launch a call, CUDA
events around each call, a spin kernel before each so that the host's
time in the wrapper stays out, median of the repetitions), each result
checked first.

hist: `ops/hist_cuda.build_histograms_cuda` on chip_smoke.py's histogram
shapes, L2 flushed before each call (REPS): the Higgs shape (1M rows x 28
features, synthetic_binary seed 0) at 255 bins for 1..32 nodes and at 128
and 64 bins for 16 and 32 nodes, uniform node indices with 10% frozen
rows; the node indices of one main-path tree (chip_smoke.main_path_levels:
1, 1, 2, 4, 8, 16 nodes, from level 1 on the left-child index), also
timed without the spin (`tree_levels_call`: there the card waits for the
host's wrapper too, as in the boosting loop); and every row frozen at 1,
4 and 16 nodes (what a launch costs besides the adds). Each in f32, int8
and int16 g/h (logloss gradients at the base score, and their quantized
twins), and in the exact mode (the f32 g/h on their fixed-point grid,
what f32 training runs), checked against the plain version
(chip_smoke.check_hist, check_hist_exact).

lut: the LUT kernels through chip_smoke.lut_callables on models trained
once on the card by this checkout (the Higgs shape, depth 6: 100 trees at
255 and at 15 bins, 1000 trees at 255 bins) and loaded by every checkout
from their npz files: K4 with fp16 and with int8 leaves and K5 on the
100-tree 255-bin model, K5 on the 15-bin one (nibble thresholds), K4 fp16
and K5 on the 1000-tree one (staged pass by pass). Each at 1, 16, 64 and 256 rows
with L2 warm (LUT_REPS_WARM), as a serving loop finds it, and at 1M rows
with L2 flushed (LUT_REPS); each checked bitwise against its plain
version first (both sum tree by tree in one order); K4 fp16 also at
LUT_SWEEP rows (L2 flushed), where the mappings cross. Where the checkout
has it, csrc/lut.cu's empty kernel is timed the same way: the latency
floor of one launch.

leaf: `ops/grad.leaf_gh_sums`'s index_add_ (not a kernel of the port's
own: the level loop's per-node (G, H) sums) on 1M f32 rows, every row
active, uniform node indices at LEAF_NODES nodes, with LEAF_SPREAD
partials a node and with one (`ops/grad._leaf_gh_sums`; a checkout
without it is skipped), L2 warm as in the loop. Each is checked against
an f64 sum first and its largest error reported: the spread form within
the histograms' 1e-5 * the sum of |g| (|h|) + 1e-6; the one-partial form,
one f32 accumulator a node that rounds at every add, within the
recursive-summation bound (R - 1) * 2^-24 * the sum of |g| (|h|).

traverse: the f32 traversal kernel (K3) through chip_smoke.device_operands
(ops/predict_cuda.pack_tables, then traverse_cuda) on the 100-tree and
1000-tree 255-bin models above: at 1, 16, 64 and 256 rows with L2 warm
(LUT_REPS_WARM), at 1M rows with L2 flushed (LUT_REPS), and, on the
100-tree model, at LUT_SWEEP rows and on both sides of the rows mapping's
first batch (a block of 512 rows an SM), L2 flushed; one call of 1 row
with the host's time in the wrapper included (no spin before the start
event: what a serving loop waits for); and the empty kernel timed the
same ways. Each result is checked against the plain version first:
within chip_smoke's old 1e-5 * (|p| + 1), and whether it is bitwise is
reported (chip_smoke holds this checkout to bitwise).

Every package runs in a worker process of its own, so that several
checkouts (this one and, for example, a `git archive` of its parent,
--other DIR, repeatable) build and time their own kernels in one run on
one card, in the order others, this, this, others reversed. The worker
puts the checkout it times first on sys.path and then loads THIS
checkout's chip_smoke.py by path, so every checkout is timed by the same
timer and checks. Prints the card's name and power limit (nvidia-smi)
first and last, then one JSON object per line: the card, one line per
run and a summary.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

REPS = 10
LUT_REPS = 20
LUT_REPS_WARM = 50
FROZEN_NODES = (1, 4, 16)
MODES = ("exact", "f32", "int8", "int16")
#: The LUT cases' models: name -> (bins, trees), trained at the Higgs shape.
#: 1000 trees (BASELINE.json's 1000-tree scoring config) do not fit one
#: block's shared memory: the kernel stages them pass by pass.
LUT_MODELS = {"255": (255, 100), "15": (15, 100), "255x1000": (255, 1000)}
#: Rows a call between serving sizes and 1M (K4 fp16, L2 flushed): where
#: the kernel's two mappings cross.
LUT_SWEEP = (1_024, 4_096, 16_384, 32_768, 49_152, 65_536, 131_072,
             262_144, 524_288)
#: (name, model, leaf dtype) of each LUT case.
LUT_CASES = (("K4 fp16", "255", "float16"), ("K4 int8", "255", "int8"),
             ("K5 255 bins", "255", "int4"), ("K5 15 bins", "15", "int4"),
             ("K4 fp16 1000 trees", "255x1000", "float16"),
             ("K5 1000 trees", "255x1000", "int4"))
#: Nodes of the leaf-sum cases (a depth-6 tree's levels and leaves).
LEAF_NODES = (1, 2, 4, 8, 16, 32, 64)
#: (name, model) of each K3 case; the first also takes the sweep.
TRAVERSE_CASES = (("K3 100 trees", "255"), ("K3 1000 trees", "255x1000"))
HERE = Path(__file__).resolve().parent.parent


def _chip_smoke():
    """This checkout's chip_smoke.py as a module; its package imports
    resolve to whichever ddt_tpu_torch is first on sys.path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _hist_times(cs) -> dict:
    import numpy as np
    import torch

    from ddt_tpu_torch.ops import grad, hist_cuda

    dev = torch.device("cuda")
    X, y = cs.synthetic_binary(cs.ROWS, n_features=cs.FEATURES, seed=0)
    binned = {B: torch.from_numpy(cs.fit_bin_mapper(X, n_bins=B)
                                  .transform(X)).to(dev)
              for B, _ in cs.HIST_SHAPES}
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    run = hist_cuda.build_histograms_cuda

    p0 = float(y.mean())
    g = (p0 - y.astype(np.float32)).astype(np.float32)
    h = np.full(cs.ROWS, p0 * (1 - p0), np.float32)
    gh = {"exact": (g, h), "f32": (g, h)}
    for dt in ("int8", "int16"):
        qg, qh, _, _ = grad.quantize_gradients_np(g, h, grad_dtype=dt,
                                                  tree_id=0, seed=7)
        gh[dt] = (qg, qh)
    gh = {k: tuple(torch.from_numpy(a).to(dev) for a in v)
          for k, v in gh.items()}

    levels = cs.main_path_levels(binned[255], y)
    scales = cs.exact_scales(*gh["exact"])

    def call(args, mode):
        """The launch of `mode` (exact: f32 g/h summed in fixed point on
        the training grid) and its check against the plain version."""
        if mode == "exact":
            return (lambda: run(*args, scales=scales),
                    lambda what: cs.check_hist_exact(args, scales, what))
        return lambda: run(*args), lambda what: cs.check_hist(args, what)

    rng = np.random.default_rng(7)
    out = {"synthetic": {}, "tree_levels": {}}
    for B, nodes in cs.HIST_SHAPES:
        for N in nodes:
            ni = rng.integers(0, N, size=cs.ROWS).astype(np.int32)
            ni[rng.random(cs.ROWS) < 0.1] = -1
            nid = torch.from_numpy(ni).to(dev)
            for mode in MODES:
                fn, chk = call((binned[B], *gh[mode], nid, N, B), mode)
                chk(f"{mode} B={B} N={N}")
                out["synthetic"][f"{mode} {B} {N}"] = cs.time_ms(
                    fn, REPS, flush)
    # Every row frozen: what a launch costs besides the rows' adds (the
    # node-index scan, the table's zeroing and flush, the launch itself).
    out["frozen"] = {}
    nid = torch.full((cs.ROWS,), -1, dtype=torch.int32, device=dev)
    for N in FROZEN_NODES:
        for mode in MODES:
            fn, _ = call((binned[255], *gh[mode], nid, N, 255), mode)
            cs.check(not bool(fn().any()), f"{mode} N={N}: frozen rows")
            out["frozen"][f"{mode} 255 {N}"] = cs.time_ms(fn, REPS, flush)
    out["tree_levels_call"] = {}
    for mode in MODES:
        ts, calls = [], []
        for nid, N in levels:
            fn, chk = call((binned[255], *gh[mode], nid, N, 255), mode)
            chk(f"{mode} main-path level N={N}")
            ts.append(cs.time_ms(fn, REPS, flush))
            calls.append(cs.time_ms(fn, REPS, flush, spin=False))
        out["tree_levels"][mode] = ts
        out["tree_levels_call"][mode] = calls
    out["tree_level_nodes"] = [n for _, n in levels]
    out["tree_level_active_rows"] = [int((ni >= 0).sum()) for ni, _ in levels]
    return out


def _needed_models(kernels: list) -> list:
    names = set()
    if "lut" in kernels:
        names |= {m for _, m, _ in LUT_CASES}
    if "traverse" in kernels:
        names |= {m for _, m in TRAVERSE_CASES}
    return [n for n in LUT_MODELS if n in names]


def _train_models(cs, models: Path, names: list) -> None:
    """The LUT and traversal cases' models, trained on the card, with the
    binned rows they score, into `models`."""
    import numpy as np

    X, y = cs.synthetic_binary(cs.ROWS, n_features=cs.FEATURES, seed=0)
    for name in names:
        B, T = LUT_MODELS[name]
        res = cs.api.train(X, y, cs.TrainConfig(
            n_trees=T, max_depth=cs.DEPTH, n_bins=B))
        res.ensemble.save(str(models / f"ens{name}.npz"))
        np.save(models / f"xb{name}.npy", res.mapper.transform(X))


def _lut_times(cs, models: Path) -> dict:
    import numpy as np
    import torch

    from ddt_tpu_torch.models.tree import TreeEnsemble

    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    out = {}
    for name, model, leaf_dtype in LUT_CASES:
        ce = TreeEnsemble.load(str(models / f"ens{model}.npz")).compile(
            tree_chunk=64)
        Xd = torch.from_numpy(np.load(models / f"xb{model}.npy")).to(dev)
        _, kern, plain = cs.lut_callables(ce.quantize(leaf_dtype), dev)
        cs.check(torch.equal(kern(Xd), plain(Xd)),
                 f"{name}: kernel == plain, bitwise")
        row = {}
        for n in cs.SERVE_SIZES:
            Xn = Xd[:n].contiguous()
            cs.check(torch.equal(kern(Xn), plain(Xn)),
                     f"{name} {n} rows: kernel == plain, bitwise")
            row[str(n)] = cs.time_ms(lambda: kern(Xn), LUT_REPS_WARM)
        row[str(Xd.shape[0])] = cs.time_ms(lambda: kern(Xd), LUT_REPS, flush)
        out[name] = row
        if name == LUT_CASES[0][0]:
            sweep = {}
            for n in LUT_SWEEP:
                Xn = Xd[:n].contiguous()
                sweep[str(n)] = cs.time_ms(lambda: kern(Xn), LUT_REPS, flush)
            out[name + " sweep"] = sweep
    from ddt_tpu_torch.ops import predict_lut_cuda
    if hasattr(predict_lut_cuda, "empty_launch"):
        out["empty kernel"] = {"any": cs.time_ms(
            lambda: predict_lut_cuda.empty_launch(dev), LUT_REPS_WARM)}
    return out


def _close(cs, got, want, what: str) -> bool:
    """got within 1e-5 * (|want| + 1) of want (raises otherwise); returns
    whether the two are bitwise equal."""
    err = (got - want).abs()
    cs.check(bool((err <= 1e-5 * (want.abs() + 1)).all()),
             f"{what}: kernel vs plain max err {float(err.max())}")
    return bool(err.max() == 0) if err.numel() else True


def _traverse_times(cs, models: Path) -> dict:
    import numpy as np
    import torch

    from ddt_tpu_torch.models.tree import TreeEnsemble
    from ddt_tpu_torch.ops import predict_lut_cuda

    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    cross = 512 * torch.cuda.get_device_properties(dev).multi_processor_count
    sweep = sorted(set(LUT_SWEEP) | {cross - 1, cross})
    out = {}
    for name, model in TRAVERSE_CASES:
        ce = TreeEnsemble.load(str(models / f"ens{model}.npz")).compile(
            tree_chunk=64)
        Xd = torch.from_numpy(np.load(models / f"xb{model}.npy")).to(dev)
        _, kern, plain = cs.device_operands(ce, dev)
        bitwise = {str(Xd.shape[0]): _close(cs, kern(Xd), plain(Xd), name)}
        row = {}
        for n in cs.SERVE_SIZES:
            Xn = Xd[:n].contiguous()
            bitwise[str(n)] = _close(cs, kern(Xn), plain(Xn), f"{name} {n}")
            row[str(n)] = cs.time_ms(lambda: kern(Xn), LUT_REPS_WARM)
        X1 = Xd[:1].contiguous()
        row["1 host"] = cs.time_ms(lambda: kern(X1), LUT_REPS_WARM,
                                   spin=False)
        row[str(Xd.shape[0])] = cs.time_ms(lambda: kern(Xd), LUT_REPS, flush)
        out[name] = row
        out[name + " bitwise"] = bitwise
        if name == TRAVERSE_CASES[0][0]:
            out[name + " sweep"] = {
                str(n): cs.time_ms(lambda: kern(Xd[:n].contiguous()),
                                   LUT_REPS, flush) for n in sweep}

    def empty():
        predict_lut_cuda.empty_launch(dev)

    out["empty kernel"] = {
        "any": cs.time_ms(empty, LUT_REPS_WARM),
        "host": cs.time_ms(empty, LUT_REPS_WARM, spin=False)}
    return out


def _leaf_times(cs) -> dict:
    import torch

    from ddt_tpu_torch.ops import grad

    if not hasattr(grad, "_leaf_gh_sums"):
        return {"skipped": "no ops/grad._leaf_gh_sums"}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    g = torch.randn(cs.ROWS, device=dev, generator=gen)
    h = torch.rand(cs.ROWS, device=dev, generator=gen)
    active = torch.ones(cs.ROWS, dtype=torch.bool, device=dev)
    mass = torch.stack([g.abs().sum(), h.abs().sum()]).double()
    tols = {grad.LEAF_SPREAD: 1e-5 * mass + 1e-6,
            1: (cs.ROWS - 1) * 2.0 ** -24 * mass}
    out = {"spread": grad.LEAF_SPREAD}
    for n in LEAF_NODES:
        idx = torch.randint(0, n, (cs.ROWS,), device=dev, generator=gen)
        want = torch.zeros((n, 2), dtype=torch.float64, device=dev)
        want.index_add_(0, idx, torch.stack([g, h], 1).double())
        row = {}
        for k, tol in tols.items():
            err = (grad._leaf_gh_sums(idx, active, g, h, n, k).double()
                   - want).abs()
            cs.check(bool((err <= tol).all()),
                     f"leaf sums, {n} nodes, spread {k}: against f64")
            row[f"spread {k}"] = cs.time_ms(
                lambda: grad._leaf_gh_sums(idx, active, g, h, n, k), REPS)
            row[f"spread {k} max_abs_err"] = err.max(dim=0).values.tolist()
        out[str(n)] = row
    return out


def _worker(repo: str, kernels: list, models: str) -> None:
    """Times the kernels of the package at `repo`; one JSON line."""
    sys.path[0] = repo          # not this file's directory
    cs = _chip_smoke()
    out = {}
    if "hist" in kernels:
        out["hist"] = _hist_times(cs)
    if "lut" in kernels:
        out["lut"] = _lut_times(cs, Path(models))
    if "traverse" in kernels:
        out["traverse"] = _traverse_times(cs, Path(models))
    if "leaf" in kernels:
        out["leaf"] = _leaf_times(cs)
    cs.emit(out)


def _run(repo: Path, kernels: list, models: str, train: bool = False) -> dict:
    cmd = [sys.executable, str(Path(__file__).resolve()), "--worker",
           "--repo", str(repo), "--kernels", ",".join(kernels),
           "--models", models] + (["--train"] if train else [])
    res = subprocess.run(cmd, capture_output=True, text=True, cwd=repo,
                         env={**os.environ, "PYTHONPATH": str(repo)})
    if res.returncode != 0:
        raise RuntimeError(f"worker for {repo} failed:\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def _summary(label: str, r: dict, cs, acc: dict) -> None:
    row = acc.setdefault(label, [])
    s = {}
    if "hist" in r:
        h = r["hist"]
        s["hist_synthetic_per_tree"] = {
            m: sum(h["synthetic"][f"{m} 255 {n}"] for n in cs.TREE_SEQ)
            for m in MODES}
        s["hist_tree_levels_per_tree"] = {m: sum(h["tree_levels"][m])
                                          for m in MODES}
    for k in ("lut", "traverse", "leaf"):
        if k in r:
            s[k] = r[k]
    row.append(s)


def _prebuild(repos: list) -> dict:
    """Builds every checkout's kernels at once (each checkout's _build
    starts one nvcc per source), so that the workers find them built.
    Returns {repo: seconds}; a failed build is reported and its worker
    then fails on its own."""
    import time

    t0 = time.perf_counter()
    procs = {str(r): subprocess.Popen(
        [sys.executable, "-c",
         "from ddt_tpu_torch import _build; _build.build_all()"],
        cwd=r, env={**os.environ, "PYTHONPATH": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in dict.fromkeys(repos)}
    took = {}
    for r, p in procs.items():
        log, _ = p.communicate()
        took[r] = time.perf_counter() - t0
        if p.returncode != 0:
            print(json.dumps({"build": r, "error": log[-4000:]}), flush=True)
    return took


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--repo", default=str(HERE))
    ap.add_argument("--kernels", default="hist,lut")
    ap.add_argument("--models", default="")
    ap.add_argument("--other", action="append", default=[])
    a = ap.parse_args()
    kernels = [k for k in a.kernels.split(",") if k]
    if a.worker:
        if a.train:
            sys.path[0] = a.repo
            cs = _chip_smoke()
            names = _needed_models(kernels)
            _train_models(cs, Path(a.models), names)
            cs.emit({"trained": names})
        else:
            _worker(a.repo, kernels, a.models)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("kernel_bench: needs a CUDA card", file=sys.stderr)
        return 2
    cs = _chip_smoke()
    card = cs.phase_device()
    with tempfile.TemporaryDirectory() as models:
        others = [(f"other {o}", Path(o).resolve()) for o in a.other]
        runs = others + [("this", HERE), ("this", HERE)] + others[::-1]
        cs.emit({"build_s": _prebuild([HERE] + [r for _, r in others])})
        if _needed_models(kernels):
            _run(HERE, kernels, models, train=True)
        summary = {}
        failed = False
        for label, repo in runs:
            try:
                r = _run(repo, kernels, models)
            except RuntimeError as e:   # reported; the other runs go on
                cs.emit({"run": label, "repo": str(repo), "error": str(e)})
                failed = True
                continue
            cs.emit({"run": label, "repo": str(repo), **r})
            _summary(label, r, cs, summary)
    cs.emit({"summary_ms": summary, "per_tree_nodes": list(cs.TREE_SEQ)})
    print(card["smi"], flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
