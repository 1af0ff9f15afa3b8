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
- the layout (`make_mesh_2d`, the reference's mesh.py:218-254): world =
  hosts x rows x features ranks, hosts outermost and features innermost,
  so rank r is host r // (Pr Pf), row r // Pf % Pr and feature shard
  r % Pf; its row shard is host * Pr + row (the reference's
  backends/tpu._local_row_offset). The `Mesh` record holds this rank's
  coordinates and its three groups: the row group (every rank of its
  feature shard, by row shard: the histogram collective, node totals,
  leaf sums, gradient statistics and the loss), the feature group (every
  rank of its host and row: the winner combine under allreduce and the
  routing broadcast) and the world (the winner combine under
  reduce-scatter, the bin-range check, digests and checkpoints).
  `group_for` is the mesh a backend of a config binds.
- the rank's device (`rank_device`: cuda:<LOCAL_RANK>, refused when the
  node has more ranks than cards).
- the data layout: `row_block` (the reference's TPUDevice._pad_rows and
  row sharding, backends/tpu.py:299-306): R pads to a multiple of the row
  shards and row shard s holds contiguous block s, the pad rows at the
  end of the last blocks, so a real row's global id is its index in the
  host matrix; `column_slab` (tpu.py:316-333): F pads with zero columns
  to a multiple of Pf and feature shard f holds contiguous slab f.

The JAX `Mesh` / `SpecLayout` machinery has no PyTorch counterpart and is
not ported. A process without an initialised group is the reference's
`axis_name=None`: the single-device path, with no collective.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, NamedTuple

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
    bound to its card first (rank_device; without LOCAL_RANK, the card
    of its rank). A repeat call with the same
    arguments does nothing; with other arguments it raises: a live group
    cannot be re-wired.

    Transient bootstrap faults (a rendezvous that is still coming up)
    are retried with backoff before the hard failure (utils/retry, seam
    "multihost.init"; the fault plan injects its timeout at the same
    seam)."""
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
        if "LOCAL_RANK" not in os.environ:
            # No launcher named the node-local rank (`cli train
            # --multihost-*` started by hand): one card a process on one
            # node, by rank, the card rank_device names once the group
            # is up.
            torch.cuda.set_device(rank % max(1, torch.cuda.device_count()))
            kw["device_id"] = torch.device("cuda",
                                          torch.cuda.current_device())
        else:
            kw["device_id"] = rank_device("cuda", world_size)
    from ddt_tpu_torch.robustness import faultplan
    from ddt_tpu_torch.utils import retry

    def attempt() -> None:
        faultplan.inject("multihost.init")
        dist.init_process_group(
            backend, init_method=init_method, world_size=world_size,
            rank=rank, timeout=datetime.timedelta(seconds=timeout_s), **kw)

    # Bootstrap waits are long: few, slow attempts with a bring-up-sized
    # deadline (the default I/O policy's is 30 s).
    retry.retry_call(attempt, seam="multihost.init",
                     policy=retry.RetryPolicy(attempts=3, base_s=2.0,
                                              multiplier=2.0, jitter=0.5,
                                              deadline_s=120.0))
    _init_args = args


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


class Mesh(NamedTuple):
    """This rank's place in a hosts x rows x features mesh (make_mesh_2d)
    and the groups it collects over."""

    row_group: Any        # ranks of this feature shard, by row shard
    feature_group: Any    # ranks of this host and row, by feature shard;
    #                       None when there is one feature shard
    world_group: Any      # every rank
    n_hosts: int
    n_rows: int           # row partitions a host
    n_feature_shards: int
    host: int
    row: int
    feature: int

    @property
    def row_shards(self) -> int:
        """Row blocks: hosts x rows."""
        return self.n_hosts * self.n_rows

    @property
    def row_shard(self) -> int:
        """This rank's row block: host * rows + row."""
        return self.host * self.n_rows + self.row


#: (Pr, Pf, hosts) -> (the world group it was built on, its Mesh).
_meshes: dict = {}


def coordinates(rank: int, row_partitions: int, feature_partitions: int
                ) -> tuple[int, int, int]:
    """(host, row, feature shard) of global rank `rank`: hosts outermost,
    features innermost."""
    per_host = row_partitions * feature_partitions
    return (rank // per_host, rank // feature_partitions % row_partitions,
            rank % feature_partitions)


def make_mesh_2d(row_partitions: int, feature_partitions: int = 1,
                 n_hosts: int = 1) -> Mesh:
    """This rank's Mesh of n_hosts x row_partitions x feature_partitions
    ranks, which must be the world. Every rank must call it, in the same
    order, as it builds the subgroups (dist.new_group over explicit rank
    lists; a group of one feature shard is None, a row group of every rank
    is the world). Each new group runs one collective here, outside any
    capture, so that its communicator exists before a boosting round is
    captured. Built once per world and shape."""
    if not is_initialized():
        raise ValueError("make_mesh_2d needs an initialised process group")
    Pr, Pf, Ph = row_partitions, feature_partitions, n_hosts
    world = dist.get_world_size()
    if Ph * Pr * Pf != world:
        raise ValueError(
            f"a mesh of {Ph} hosts x {Pr} rows x {Pf} features needs "
            f"{Ph * Pr * Pf} ranks; the process group has {world}")
    key = (Pr, Pf, Ph)
    hit = _meshes.get(key)
    if hit is not None and hit[0] is dist.group.WORLD:
        return hit[1]
    rank = dist.get_rank()
    host, row, feat = coordinates(rank, Pr, Pf)
    nccl = dist.get_backend() == "nccl"
    dev = torch.device("cuda", torch.cuda.current_device()) if nccl \
        else torch.device("cpu")
    kw = {"device_id": dev} if nccl else {}

    def build(lists):
        mine = None
        for ranks in lists:
            g = dist.new_group(ranks, **kw)
            if rank in ranks:
                mine = g
        return mine

    per_host = Pr * Pf
    row_group, feature_group = dist.group.WORLD, None
    if Pf > 1:
        row_group = build([[h * per_host + r * Pf + f
                            for h in range(Ph) for r in range(Pr)]
                           for f in range(Pf)])
        feature_group = build([[h * per_host + r * Pf + f
                                for f in range(Pf)]
                               for h in range(Ph) for r in range(Pr)])
        for g in (row_group, feature_group):
            dist.all_reduce(torch.zeros(1, device=dev), group=g)
    m = Mesh(row_group, feature_group, dist.group.WORLD, Ph, Pr, Pf, host,
             row, feat)
    _meshes[key] = (dist.group.WORLD, m)
    return m


def binds(cfg) -> bool:
    """Whether a backend of `cfg` binds a mesh: its ranks
    (cfg.world_size) are the process group's (False without a group, and
    for a rank's scoring backend with one partition in a larger
    group)."""
    return is_initialized() and dist.get_world_size() == cfg.world_size


def group_for(cfg) -> Mesh | None:
    """The mesh a backend of `cfg` binds (make_mesh_2d of its layout), or
    None where it binds none (`binds`: no collective)."""
    if binds(cfg):
        return make_mesh_2d(cfg.n_partitions, cfg.feature_partitions,
                            cfg.host_partitions)
    return None


def _layout(cfg) -> str:
    if cfg.world_size == cfg.n_partitions:
        return f"n_partitions={cfg.n_partitions}"
    return (f"host_partitions x n_partitions x feature_partitions = "
            f"{cfg.host_partitions} x {cfg.n_partitions} x "
            f"{cfg.feature_partitions} = {cfg.world_size}")


def check_partitions(cfg) -> None:
    """Training's rule: the mesh's ranks (cfg.world_size = hosts x rows x
    features) are the world size of the process group (1 without one).
    Raises otherwise, on every rank alike, before any collective."""
    if not is_initialized():
        if cfg.world_size > 1:
            raise ValueError(
                f"{_layout(cfg)} needs an initialised torch.distributed "
                "process group with that many ranks (parallel/mesh."
                "initialize_multihost or parallel/spawn)")
        return
    if cfg.world_size != dist.get_world_size():
        raise ValueError(
            f"{_layout(cfg)} but the process group has "
            f"{dist.get_world_size()} ranks: they must be equal")


def local_rank() -> int:
    """This process's index among the ranks of its node: LOCAL_RANK (set
    by torchrun and parallel/spawn), else the global rank. On a node of
    its own a host's ranks have LOCAL_RANK r % (Pr Pf); hosts emulated on
    one node keep r, one card a rank."""
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
    F] (pad rows included, every column: the backend's upload cuts the
    column slab) of a matrix of `n_rows` real rows."""

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


def column_slab(n_features: int, feature_shards: int, f: int
                ) -> tuple[int, int, int]:
    """(lo, hi, width): feature shard f's real columns are [lo, hi) of
    n_features; its slab holds `width` = ceil(n_features / feature_shards)
    columns, the last (width - (hi - lo)) of them zero padding."""
    width = -(-n_features // feature_shards)
    lo = min(f * width, n_features)
    return lo, min(lo + width, n_features), width


def pad_columns(a: torch.Tensor, width: int) -> torch.Tensor:
    """`a` ([n, k], k <= width) zero-padded on dim 1 to `width` columns,
    contiguous."""
    if a.shape[1] == width:
        return a.contiguous()
    out = torch.zeros((a.shape[0], width), dtype=a.dtype, device=a.device)
    out[:, :a.shape[1]] = a
    return out
