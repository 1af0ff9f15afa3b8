"""Histogram kernel times on the card, for this checkout and others.

    python -m ddt_tpu_torch.hist_bench [--other DIR ...]

Times `ops/hist_cuda.build_histograms_cuda` with chip_smoke.py's timer
(one launch a call, CUDA events around each call, L2 flushed before each,
median of REPS) on chip_smoke.py's histogram shapes: the Higgs shape (1M
rows x 28 features, synthetic_binary seed 0) at 255 bins for 1..32 nodes
and at 128 and 64 bins for 16 and 32 nodes, uniform node indices with
10% frozen rows; and on the node indices of one main-path tree
(chip_smoke.main_path_levels: 1, 1, 2, 4, 8, 16 nodes, from level 1 on
the left-child index); and with every row frozen at 1, 4 and 16 nodes
(what a launch costs besides the adds). Each in f32, int8 and int16 g/h
(logloss gradients at the base score, and their quantized twins), each
result checked against the plain version first (chip_smoke.check_hist).

The times are the device's: a spin kernel keeps the stream busy while
the host runs the wrapper. The main-path levels are also timed without
it (`tree_levels_call`): there the card waits for the host's wrapper too,
as it does in the boosting loop.

Every package runs in a worker process of its own, so that several
checkouts (this one and, for example, a `git archive` of its parent,
--other DIR, repeatable) build and time their own kernels in one run on
one card, in the order others, this, this, others reversed. The worker
puts the checkout it times first on sys.path and then loads THIS
checkout's chip_smoke.py by path, so every checkout is timed by the same
timer and checks. Prints the card's name and power limit (nvidia-smi)
first and last, then one JSON object per line: the card, one line per
run and a summary of per-tree sums.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

REPS = 10
FROZEN_NODES = (1, 4, 16)
MODES = ("f32", "int8", "int16")
HERE = Path(__file__).resolve().parent.parent


def _chip_smoke():
    """This checkout's chip_smoke.py as a module; its package imports
    resolve to whichever ddt_tpu_torch is first on sys.path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _worker(repo: str) -> None:
    """Times the kernel of the package at `repo`; one JSON line."""
    sys.path[0] = repo          # not this file's directory
    cs = _chip_smoke()
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
    gh = {"f32": (g, h)}
    for dt in ("int8", "int16"):
        qg, qh, _, _ = grad.quantize_gradients_np(g, h, grad_dtype=dt,
                                                  tree_id=0, seed=7)
        gh[dt] = (qg, qh)
    gh = {k: tuple(torch.from_numpy(a).to(dev) for a in v)
          for k, v in gh.items()}

    levels = cs.main_path_levels(binned[255], y)

    rng = np.random.default_rng(7)
    out = {"synthetic": {}, "tree_levels": {}}
    for B, nodes in cs.HIST_SHAPES:
        for N in nodes:
            ni = rng.integers(0, N, size=cs.ROWS).astype(np.int32)
            ni[rng.random(cs.ROWS) < 0.1] = -1
            nid = torch.from_numpy(ni).to(dev)
            for mode in MODES:
                args = (binned[B], *gh[mode], nid, N, B)
                cs.check_hist(args, f"{mode} B={B} N={N}")
                out["synthetic"][f"{mode} {B} {N}"] = cs.time_ms(
                    lambda: run(*args), REPS, flush)
    # Every row frozen: what a launch costs besides the rows' adds (the
    # node-index scan, the table's zeroing and flush, the launch itself).
    out["frozen"] = {}
    nid = torch.full((cs.ROWS,), -1, dtype=torch.int32, device=dev)
    for N in FROZEN_NODES:
        for mode in MODES:
            args = (binned[255], *gh[mode], nid, N, 255)
            cs.check(not bool(run(*args).any()), f"{mode} N={N}: frozen rows")
            out["frozen"][f"{mode} 255 {N}"] = cs.time_ms(
                lambda: run(*args), REPS, flush)
    out["tree_levels_call"] = {}
    for mode in MODES:
        ts, calls = [], []
        for nid, N in levels:
            args = (binned[255], *gh[mode], nid, N, 255)
            cs.check_hist(args, f"{mode} main-path level N={N}")
            ts.append(cs.time_ms(lambda: run(*args), REPS, flush))
            calls.append(cs.time_ms(lambda: run(*args), REPS, flush,
                                    spin=False))
        out["tree_levels"][mode] = ts
        out["tree_levels_call"][mode] = calls
    out["tree_level_nodes"] = [n for _, n in levels]
    out["tree_level_active_rows"] = [int((ni >= 0).sum()) for ni, _ in levels]
    cs.emit(out)


def _run(repo: Path) -> dict:
    cmd = [sys.executable, str(Path(__file__).resolve()), "--worker",
           "--repo", str(repo)]
    res = subprocess.run(cmd, capture_output=True, text=True, cwd=repo,
                         env={**os.environ, "PYTHONPATH": str(repo)})
    if res.returncode != 0:
        raise RuntimeError(f"worker for {repo} failed:\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--repo", default=str(HERE))
    ap.add_argument("--other", action="append", default=[])
    a = ap.parse_args()
    if a.worker:
        _worker(a.repo)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("hist_bench: needs a CUDA card", file=sys.stderr)
        return 2
    cs = _chip_smoke()
    card = cs.phase_device()
    others = [(f"other {o}", Path(o).resolve()) for o in a.other]
    runs = others + [("this", HERE), ("this", HERE)] + others[::-1]
    per_tree = {}
    failed = False
    for label, repo in runs:
        try:
            r = _run(repo)
        except RuntimeError as e:   # reported; the other runs go on
            cs.emit({"run": label, "repo": str(repo), "error": str(e)})
            failed = True
            continue
        cs.emit({"run": label, "repo": str(repo), **r})
        tree = {m: sum(r["synthetic"][f"{m} 255 {n}"] for n in cs.TREE_SEQ)
                for m in MODES}
        levels = {m: sum(r["tree_levels"][m]) for m in MODES}
        per_tree.setdefault(label, []).append(
            {"synthetic_per_tree": tree, "tree_levels_per_tree": levels})
    cs.emit({"summary_ms": per_tree, "per_tree_nodes": list(cs.TREE_SEQ)})
    print(card["smi"], flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
