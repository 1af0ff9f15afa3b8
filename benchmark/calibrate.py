"""Readings that a cell's limits are set from, many seeds in one process:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        --variant sound|control|fault:<name> [--seconds S]

runs the cell's set-up, window and check once a seed, as a benchmark run
does, and prints one JSON line a seed with every number its check
computed. Several variants run in one process one after another, each on
its own group of seeds: `--variant sound,control --seeds 1,2/3,4`.
`sound` runs the program as the configuration states; `control` with the
traffic mix's "control" overrides (the program's own path of lower
precision); `fault:<name>` with a fault of benchmark/faults.py planted.
The benchmark's runs never run this.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--variant", default="sound")
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    p.add_argument("--init", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    from benchmark import faults
    from benchmark.core import harness, launch
    cell = harness.resolve(args.workload)
    variants = args.variant.split(",")
    groups = [[int(s) for s in g.split(",")] for g in args.seeds.split("/")]
    if len(groups) != len(variants):
        p.error("one group of seeds a variant")

    def setting(variant):
        if variant == "control":
            return cell.traffic["control"], contextlib.nullcontext()
        if variant.startswith("fault:"):
            return {}, faults.plant(variant[6:], cell.traffic["kind"])
        return {}, contextlib.nullcontext()

    def one(device, variant, seed, overrides):
        t0 = time.perf_counter()
        res = harness.run_cell(cell, seed=seed, seconds=args.seconds,
                               trace=False, device=device, rank=args.rank,
                               world=cell.chips, t_start=t0,
                               overrides=overrides)
        if res is None:
            return
        print(json.dumps({
            "workload": args.workload, "variant": variant, "seed": seed,
            "correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"],
            "numbers": {**{k: v["value"] for k, v in res["checks"].items()},
                        **res["readings"]},
            "metrics": {k: v["value"] for k, v in res["metrics"].items()},
            "card": res["card"],
            "memory_peak_bytes": res["device"]["memory_peak_bytes"],
            "run_s": time.perf_counter() - t0}), flush=True)

    def body(device):
        for variant, seeds in zip(variants, groups):
            overrides, plant = setting(variant)
            with plant:
                for seed in seeds:
                    one(device, variant, seed, overrides)

    own = list(argv if argv is not None else sys.argv[1:])
    _, ok = launch.run_ranks(__file__, own, cell.chips, args.rank,
                             args.init, body)
    return 0 if ok else 1


if __name__ == "__main__":
    torch.set_num_threads(4)
    sys.exit(main())
