"""Start the ranks of a process group on this node (the counterpart of the
reference's tests/mp_worker.py).

    with Pool(4, backend="gloo", device="cpu") as pool:
        results = pool.run(tasks.train, X, y, cfg_kw)   # one per rank

`Pool` spawns `world` processes (torch.multiprocessing, the spawn start
method: nothing of the parent's threads or CUDA state is inherited), each
joined to the group through a FileStore in its own temporary directory,
so that pools started side by side (test workers) never contend for a
port. Rank r gets LOCAL_RANK=r and, on NCCL, card r. `run(fn, *args)`
calls fn(device, *args) on every rank and returns the results in rank
order; a rank that raises makes `run` raise with its traceback. The
workers stay up between runs until `close`. `spawn` is the one-shot form.

`fn` is sent by its import path, so it lives in a module a rank can import
without the caller's (ddt_tpu_torch/parallel/tasks.py holds the
package's); so do its arguments and results, which are pickled.
"""

from __future__ import annotations

import os
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ddt_tpu_torch.parallel import mesh


def _worker(rank: int, world: int, backend: str, device: str,
            init_method: str, timeout_s: float, threads: int, tasks,
            results) -> None:
    os.environ["LOCAL_RANK"] = str(rank)
    torch.set_num_threads(threads)
    try:
        mesh.initialize_multihost(init_method, world, rank, backend=backend,
                                  timeout_s=timeout_s)
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        return
    results.put((rank, True, None))
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            fn, args = task
            try:
                results.put((rank, True, fn(device, *args)))
            except Exception:
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class Pool:
    """`world` ranks of one process group, reused across `run` calls:
    backend="nccl" with device="cuda" (one card a rank) or "gloo" with
    "cpu"; there is no default, so that ranks meant for the cards never
    train on the CPU unasked."""

    def __init__(self, world: int, backend: str, device: str,
                 timeout_s: float = 300.0, threads: int = 1):
        if (device == "cuda") != (backend == "nccl"):
            raise ValueError(
                f"device={device!r} with backend={backend!r}: CUDA ranks "
                "talk over NCCL, CPU ranks over gloo")
        self.world = world
        self.timeout_s = timeout_s
        self._dir = tempfile.mkdtemp(prefix="ddt_pool_")
        ctx = mp.get_context("spawn")
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(world)]
        init = "file://" + os.path.join(self._dir, "store")
        self._procs = [
            ctx.Process(target=_worker, daemon=True, args=(
                r, world, backend, device, init, timeout_s, threads,
                self._tasks[r], self._results))
            for r in range(world)]
        for p in self._procs:
            p.start()
        try:
            self._collect("start")
        except BaseException:
            self.close()
            raise

    def _collect(self, what: str) -> list:
        """One result from every rank (rank order); raises when a rank
        failed, died or ran past the timeout."""
        out: dict = {}
        errors = []
        deadline = time.monotonic() + self.timeout_s
        while len(out) + len(errors) < self.world:
            try:
                r, ok, value = self._results.get(timeout=1.0)
            except queue.Empty:
                dead = [i for i, p in enumerate(self._procs)
                        if not p.is_alive()]
                if dead or time.monotonic() > deadline:
                    missing = sorted(set(range(self.world)) - set(out))
                    raise RuntimeError(
                        f"{what}: ranks {missing} gave no result (dead: "
                        f"{dead}, timeout {self.timeout_s} s)") from None
                continue
            if ok:
                out[r] = value
            else:
                errors.append(f"rank {r}:\n{value}")
        if errors:
            raise RuntimeError(f"{what} failed on {len(errors)} of "
                               f"{self.world} ranks\n" + "\n".join(errors))
        return [out[r] for r in range(self.world)]

    def run(self, fn, *args) -> list:
        """fn(device, *args) on every rank; the results in rank order."""
        for q in self._tasks:
            q.put((fn, args))
        return self._collect(getattr(fn, "__name__", repr(fn)))

    def close(self) -> None:
        """Stop the ranks (each destroys its group) and remove the store."""
        for q, p in zip(self._tasks, self._procs):
            if p.is_alive():
                q.put(None)
        # Results of an abandoned run would keep their writer alive.
        try:
            while True:
                self._results.get(timeout=0.1)
        except queue.Empty:
            pass
        for p in self._procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> "Pool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def spawn(fn, world: int, backend: str, device: str, *args) -> list:
    """fn(device, *args) on `world` fresh ranks; the results in rank
    order (the ranks stop afterwards)."""
    with Pool(world, backend=backend, device=device) as pool:
        return pool.run(fn, *args)
