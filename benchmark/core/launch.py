"""Ranks of a cell on several cards: rank 0 is the process the benchmark
was started as; it starts the others as copies of its own command with
the rank appended, and joins them in one torch.distributed group (NCCL),
as a launcher such as torchrun would."""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import torch


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(script: str, argv: list, world: int, init: str) -> list:
    """Ranks 1 .. world-1, each `python script argv --rank k ...`."""
    procs = []
    for k in range(1, world):
        env = {**os.environ, "LOCAL_RANK": str(k)}
        procs.append(subprocess.Popen(
            [sys.executable, script, *argv, "--rank", str(k), "--world",
             str(world), "--init", init],
            stdout=subprocess.DEVNULL, env=env))
    return procs


def finish(procs: list, timeout_s: float = 300.0) -> bool:
    """Wait for every started rank; end any that outlives the timeout.
    True when all exited with 0."""
    ok = True
    for p in procs:
        try:
            ok &= p.wait(timeout=timeout_s) == 0
        except subprocess.TimeoutExpired:
            ok = False
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    return ok


def run_ranks(script: str, argv: list, world: int, rank: int, init,
              body):
    """Run body(device) on card `rank` of a `world`-rank NCCL group (rank 0
    starts the others) and leave the group. Returns (body's result, True
    when every started rank exited with 0)."""
    procs = []
    try:
        if rank == 0 and world > 1:
            init = f"tcp://127.0.0.1:{free_port()}"
            procs = spawn(script, argv, world, init)
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        if world > 1:
            from ddt_tpu_torch.parallel import mesh
            os.environ["LOCAL_RANK"] = str(rank)
            mesh.initialize_multihost(init, world, rank, backend="nccl",
                                      timeout_s=300.0)
        out = body(device)
        if world > 1:
            torch.distributed.destroy_process_group()
    finally:
        ok = finish(procs)
    return out, ok
