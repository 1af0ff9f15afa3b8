"""The process group side of ddt_tpu/parallel/mesh.py.

The reference drives every device from one controller through a JAX
`Mesh` and `shard_map`; PyTorch runs one process per card instead, joined
by a torch.distributed process group (NCCL on the cards, gloo across CPU
processes). What carries over:

- `initialize_multihost`: the reference's jax.distributed.initialize
  wrapper (mesh.py:301), here a thin init_process_group whose address,
  world size and rank the caller gives (nothing on a card's machine
  announces a cluster). Idempotent for the same arguments, loud for
  others, as there.
- the rank's device (`rank_device`: cuda:<LOCAL_RANK>, refused when the
  node has more ranks than cards) and the group a backend of
  n_partitions binds (`group_for`); world and rank are
  comms.world / comms.rank of that group.
- the row layout (`row_block`, the reference's TPUDevice._pad_rows and
  row sharding, backends/tpu.py:299-306): R pads to a multiple of P and
  rank r holds contiguous block r; the pad rows sit at the end of the
  last blocks, so a real row's global id is its index in the host matrix.

The JAX `Mesh` / `SpecLayout` machinery has no PyTorch counterpart and is
not ported. A process without an initialised group is the reference's
`axis_name=None`: the single-device path, with no collective.
"""

from __future__ import annotations

import datetime
import os
from typing import NamedTuple

import torch
import torch.distributed as dist

# Arguments of the successful initialize_multihost call (None: never).
_init_args: dict | None = None


def initialize_multihost(init_method: str, world_size: int, rank: int, *,
                         backend: str | None = None,
                         timeout_s: float = 600.0) -> None:
    """init_process_group for this process: `init_method` a
    "tcp://host:port" or "file://path" rendezvous, `backend` "nccl" or
    "gloo" (default: nccl when a card is visible). On NCCL the process is
    bound to its card first (rank_device). A repeat call with the same
    arguments does nothing; with other arguments it raises: a live group
    cannot be re-wired."""
    global _init_args
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    args = dict(init_method=init_method, world_size=world_size, rank=rank,
                backend=backend)
    if _init_args is not None and dist.is_initialized():
        if _init_args == args:
            return
        raise RuntimeError(
            f"initialize_multihost already ran with {_init_args}; cannot "
            f"re-initialise with {args}: destroy the process group first")
    kw = {}
    if backend == "nccl":
        kw["device_id"] = rank_device("cuda", world_size)
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s), **kw)
    _init_args = args


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def group_for(n_partitions: int):
    """The process group a backend of `n_partitions` partitions runs its
    collectives on: the default group when its ranks are those
    partitions, else None (no group, or a rank's scoring backend with
    n_partitions=1 in a larger group: no collective)."""
    if is_initialized() and dist.get_world_size() == n_partitions:
        return dist.group.WORLD
    return None


def check_partitions(n_partitions: int) -> None:
    """Training's rule: cfg.n_partitions is the world size of the
    process group (1 without one). Raises otherwise, on every rank alike,
    before any collective."""
    if not is_initialized():
        if n_partitions > 1:
            raise ValueError(
                f"n_partitions={n_partitions} needs an initialised "
                "torch.distributed process group with that many ranks "
                "(parallel/mesh.initialize_multihost or parallel/spawn)")
        return
    if n_partitions != dist.get_world_size():
        raise ValueError(
            f"n_partitions={n_partitions} but the process group has "
            f"{dist.get_world_size()} ranks: they must be equal")


def local_rank() -> int:
    """This process's index among the ranks of its node: LOCAL_RANK (set
    by torchrun and parallel/spawn), else the global rank."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if is_initialized() else 0


def rank_device(device_type: str, world: int | None = None
                ) -> torch.device:
    """The device this rank trains on: the CPU, or cuda:<LOCAL_RANK>,
    made the current card. NCCL lets no two ranks share a card, so a node
    with more ranks than cards raises."""
    if device_type != "cuda":
        return torch.device(device_type)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but torch.cuda.is_available() is False; pass "
            "device='cpu' to run the plain versions on the CPU")
    lr = local_rank()
    n = torch.cuda.device_count()
    if lr >= n:
        raise RuntimeError(
            f"local rank {lr} of {world or dist.get_world_size()} ranks "
            f"has no card: this node has {n}; run one rank per card")
    dev = torch.device("cuda", lr)
    torch.cuda.set_device(dev)
    return dev


class RowBlock(NamedTuple):
    """This rank's block of a row-partitioned matrix: `rows` [R_local,
    ...] (pad rows included) of a matrix of `n_rows` real rows."""

    rows: torch.Tensor
    n_rows: int


def row_block(n_rows: int, world: int, r: int) -> tuple[int, int, int]:
    """(start, stop, local): rank r's real rows are host rows
    [start, stop); its block holds `local` = ceil(n_rows / world) rows,
    the last (local - (stop - start)) of them padding."""
    local = -(-n_rows // world)
    start = min(r * local, n_rows)
    return start, min(start + local, n_rows), local


def pad_rows(a: torch.Tensor, local: int) -> torch.Tensor:
    """`a` ([n, ...], n <= local) zero-padded on dim 0 to `local` rows."""
    n = a.shape[0]
    if n == local:
        return a
    out = torch.zeros((local,) + tuple(a.shape[1:]), dtype=a.dtype,
                      device=a.device)
    out[:n] = a
    return out
