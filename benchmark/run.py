"""Benchmark of ddt_tpu_torch, one cell a run:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for (it exits with 1 and prints no result otherwise). The last
line of standard output is the run's result, one JSON object; the last
lines of standard error are the numbers its check compared, each beside
its limit. See benchmark/README.md.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".bench_cache"
# Kernel caches at fixed paths inside the checkout: only a checkout's first
# run builds.
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # Set by rank 0 for the ranks it starts.
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    p.add_argument("--init", default=None, help=argparse.SUPPRESS)
    return p.parse_args(argv)


def report(res: dict) -> None:
    spans = res.pop("spans")
    print(json.dumps(res), flush=True)
    for name, (n, total) in spans.items():
        print(f"span {name}: {n} x, {total:.3f} s", file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"correct = {res['correct']}; card: {res['card']}",
          file=sys.stderr, flush=True)


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark.core import harness, launch
    cell = harness.resolve(args.workload)
    world = cell.chips
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    if args.rank == 0:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < world:
            print(f"{args.workload} needs {world} CUDA card(s); this machine "
                  f"has {have}", file=sys.stderr)
            return 1
    own = list(argv if argv is not None else sys.argv[1:])
    try:
        res, ranks_ok = launch.run_ranks(
            __file__, own, world, args.rank, args.init,
            lambda device: harness.run_cell(
                cell, seed=args.seed, seconds=args.seconds,
                trace=bool(args.trace), device=device, rank=args.rank,
                world=world, t_start=T_START))
    except harness.ForbiddenModules as e:
        print(f"modules of the reference package loaded: {e.args[0]}",
              file=sys.stderr)
        return 1
    found = harness.forbidden_modules()
    if found:
        print(f"modules of the reference package loaded: {found}",
              file=sys.stderr)
        return 1
    if args.rank != 0:
        return 0
    if not ranks_ok:
        print("a rank failed", file=sys.stderr)
        return 1
    report(res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
