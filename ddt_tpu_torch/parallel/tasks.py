"""What a rank runs under parallel/spawn: the functions the distributed
test suites (tests/test_torch_comms.py, tests/test_torch_distributed.py,
tests/test_torch_stream.py, tests/test_torch_chunks.py,
tests/test_torch_cli.py) and
chip_smoke.py's `multi` phase send to their ranks.

They live in the package so that a rank imports torch and the port and
nothing else (the test modules import JAX). Each takes the pool's device
("cpu" or "cuda") first, works on this rank's share of host arrays every
rank was sent whole, and returns host values (numpy arrays, ensembles,
dicts), which the pool pickles back in rank order.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from ddt_tpu_torch import api
from ddt_tpu_torch.backends import cuda as cuda_backend
from ddt_tpu_torch.backends import get_backend
from ddt_tpu_torch.backends.cuda import CUDADevice
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.ops import hist_cuda, predict_cuda
from ddt_tpu_torch.parallel import comms, mesh
from ddt_tpu_torch.utils import checkpoint

#: Counters a training task reads before and after its run.
COUNTERS = ((hist_cuda, "launches_exact"), (hist_cuda, "launches"),
            (hist_cuda, "launches_int"),
            (predict_cuda, "launches"), (comms, "calls"),
            (comms, "modeled_bytes"), (comms, "other_bytes"),
            (cuda_backend, "graph_captures"), (cuda_backend, "graph_replays"))


#: Kernels listed by a profiled window, by device time.
TOP_KERNELS = 8


class Granular(CUDADevice):
    """The backend without the fused rounds: Driver.fit takes the
    granular loop."""

    grow_rounds = None


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _counters() -> dict:
    _sync()
    return {f"{m.__name__.rsplit('.', 1)[-1]}.{n}": getattr(m, n)
            for m, n in COUNTERS}


def _since(before: dict) -> dict:
    return {k: v - before[k] for k, v in _counters().items()}


def _world() -> int:
    return comms.world(dist.group.WORLD)


def _rank() -> int:
    return comms.rank(dist.group.WORLD)


#: TrainConfig fields that lay out the mesh.
LAYOUT = ("n_partitions", "feature_partitions", "host_partitions",
          "mesh_shape")


def _config(device: str, cfg_kw: dict) -> TrainConfig:
    """TrainConfig for this rank: n_partitions the world size unless
    cfg_kw names a layout (the 2D, hosts and refusal tests do)."""
    kw = {"device": device, **cfg_kw}
    if not any(k in cfg_kw for k in LAYOUT):
        kw["n_partitions"] = _world()
    return TrainConfig(**kw)


def train(device: str, X, y, cfg_kw: dict, fit_kw: dict | None = None,
          loop: str = "fused") -> dict:
    """api.train on this rank: X, y the full rows (float, or binned with
    fit_kw binned=True), the granular loop with loop="granular". Returns
    the ensemble, the history, the counters' moves over the run and the
    backend's modeled collective bytes a tree."""
    cfg = _config(device, cfg_kw)
    be = Granular(cfg) if loop == "granular" else get_backend(cfg)
    before = _counters()
    res = api.train(X, y, cfg, backend=be, log_every=1, **(fit_kw or {}))
    return {"ensemble": res.ensemble, "history": res.history,
            "best_round": res.best_round, "counters": _since(before),
            "bytes_model": be.collective_bytes_per_tree(
                res.ensemble.n_features),
            "split_comms": be.split_comms, "rank": be.rank,
            "global_rank": _rank(), "comms_slabs": be.comms_slabs}


def train_logged(device: str, X, y, cfg_kw: dict, paths: list,
                 fit_kw: dict | None = None) -> None:
    """api.train of binned X on this rank with the run log
    paths[global rank] (a rank that is not its host's first writes
    none) and api.train's keywords `fit_kw` (profile, ...)."""
    api.train(X, y, _config(device, cfg_kw), binned=True,
              run_log=paths[_rank()], **(fit_kw or {}))


def cli(device: str, argv: list) -> dict | None:
    """`python -m ddt_tpu_torch.cli <argv>` on this rank (its device
    appended as --device): the last JSON line it printed."""
    import contextlib
    import io
    import json

    from ddt_tpu_torch.cli import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main([*argv, "--device", device])
    if rc != 0:
        raise RuntimeError(f"cli {argv} exited {rc}")
    lines = out.getvalue().strip().splitlines()
    return json.loads(lines[-1]) if lines else None


def train_saves(device: str, X, y, cfg_kw: dict, fit_kw: dict) -> dict:
    """tasks.train with checkpoint writes counted on this rank: the
    result's "saves" is how many checkpoints this rank wrote."""
    saves = []
    real = checkpoint.save_checkpoint

    def counted(*a, **kw):
        saves.append(a[3])
        return real(*a, **kw)

    checkpoint.save_checkpoint = counted
    try:
        out = train(device, X, y, cfg_kw, fit_kw)
    finally:
        checkpoint.save_checkpoint = real
    return dict(out, saves=saves)


def train_own_dir(device: str, X, y, cfg_kw: dict, base: str) -> None:
    """api.train with a checkpoint directory of this rank's own,
    base/rank<r> (ranks that would resume different checkpoints: the
    Driver must refuse them)."""
    api.train(X, y, _config(device, cfg_kw),
              checkpoint_dir=f"{base}/rank{_rank()}", checkpoint_every=1)


def train_shifted(device: str, X, y, cfg_kw: dict, shift: float) -> None:
    """api.train of X + rank * shift on this rank: ranks whose rows
    disagree (api.train must refuse them)."""
    api.train(X + np.float32(_rank() * shift), y,
              _config(device, cfg_kw))


def backend_reuse(device: str, cfg_kw: dict) -> tuple[bool, bool]:
    """Whether get_backend hands this rank its scoring backend
    (n_partitions=1) again from the cache, and a new training backend
    (n_partitions the world size) on every call."""
    score = _config(device, dict(cfg_kw, n_partitions=1))
    grow = _config(device, cfg_kw)
    return (get_backend(score) is get_backend(score),
            get_backend(grow) is not get_backend(grow))


def hist_reduce(device: str, parts: list, perm: list, mode: str,
                comms_dtype: str) -> np.ndarray:
    """comms.hist_reduce of partial parts[perm[rank]] (padded on the
    feature dim for reduce-scatter, as ops/grow pads)."""
    dev = mesh.rank_device(device)
    group = dist.group.WORLD
    x = torch.from_numpy(parts[perm[_rank()]]).to(dev)
    if mode == "reduce_scatter":
        x = comms.pad_to_multiple(x, 1, _world())
    return comms.hist_reduce(x, group, mode=mode,
                             comms_dtype=comms_dtype).cpu().numpy()


def combine(device: str, winners: list, n_features: int, n_bins: int,
            missing_bin: bool) -> tuple:
    """comms.combine_shard_winners of this rank's slab winner
    winners[rank] = (gains, feats, bins, dls)."""
    dev = mesh.rank_device(device)
    args = [torch.from_numpy(np.asarray(a)).to(dev)
            for a in winners[_rank()]]
    out = comms.combine_shard_winners(
        *args, dist.group.WORLD, n_features=n_features, n_bins=n_bins,
        missing_bin=missing_bin)
    return tuple(t.cpu().numpy() for t in out)


def granular_hist(device: str, Xb: np.ndarray, g: np.ndarray,
                  h: np.ndarray, node_index: np.ndarray, n_nodes: int,
                  cfg_kw: dict) -> np.ndarray:
    """The backend's granular build_histograms over the rows split into
    rank blocks (pad rows frozen): every rank's merged histogram."""
    cfg = _config(device, cfg_kw)
    be = get_backend(cfg)
    data = be.upload(Xb)

    def block(a, fill):
        start, stop, local = mesh.row_block(len(a), be.world, be.rank)
        out = np.full(local, fill, a.dtype)
        out[:stop - start] = a[start:stop]
        return out

    return be.build_histograms(data, block(g, 0), block(h, 0),
                               block(node_index, -1),
                               n_nodes).cpu().numpy()


def check_cuda_group(device: str) -> str | None:
    """The refusal of a CUDA tensor on this (non-NCCL) group: its
    message, or None when nothing refused."""
    try:
        comms.check_group(torch.device("cuda"), dist.group.WORLD)
    except RuntimeError as e:
        return str(e)
    return None


def _profile_share(fn) -> dict:
    """Device time of the NCCL kernels against all device time and the
    wall time of fn() (torch.profiler, CPU + CUDA activities)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    _sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        _sync()
        wall = time.perf_counter() - t0
    rows = sorted(((getattr(e, "self_device_time_total", 0.0) * 1e-6,
                    e.count, e.key) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.key.startswith("Activity Buffer")),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    nccl = [r for r in rows if "nccl" in r[2].lower()]
    nccl_s = sum(r[0] for r in nccl)
    return {"wall_s": wall, "device_busy_s": busy, "nccl_device_s": nccl_s,
            "hist_device_s": sum(r[0] for r in rows
                                 if "hist_kernel" in r[2]),
            "nccl_by_kernel": [{"name": k[:80], "device_s": t, "count": c}
                               for t, c, k in nccl],
            "nccl_kernels": sum(r[1] for r in nccl),
            "nccl_share_of_busy": nccl_s / busy if busy > 0 else None,
            "nccl_share_of_wall": nccl_s / wall if wall > 0 else None,
            "top": [{"name": k[:80], "device_s": t, "count": c}
                    for t, c, k in rows[:TOP_KERNELS]]}


def train_timed(device: str, x_path: str, y_path: str, cfg_kw: dict,
                profile_rounds: int) -> dict:
    """chip_smoke's `multi` phase on one rank: api.train of the rows in
    x_path / y_path (.npy, read memory-mapped: a rank reads its block and
    the edge-fitting sample), timed; api.predict of the rank's block
    through K3; then `profile_rounds` fused rounds replayed under
    torch.profiler for the collectives' share of a round. Returns the
    ensemble, the rank's raw scores, the counters over train + predict,
    times and the profile."""
    X = np.load(x_path, mmap_mode="r")
    y = np.load(y_path)
    cfg = _config(device, cfg_kw)
    be = get_backend(cfg)
    before = _counters()
    t0 = time.perf_counter()
    res = api.train(X, y, cfg, backend=be, log_every=1)
    _sync()
    train_s = time.perf_counter() - t0
    trained = _counters()
    start, stop, _ = mesh.row_block(len(y), be.world, be.rank)
    raw = api.predict(res.ensemble, X[start:stop], mapper=res.mapper,
                      raw=True, cfg=cfg.replace(n_partitions=1))
    counters = _since(before)
    train_counters = {k: trained[k] - before[k] for k in trained}
    # The profiled window: replays of the round on the same rows.
    local = mesh.row_block(len(y), be.world, be.rank)[2]
    data = be.upload(mesh.RowBlock(mesh.pad_rows(
        res.mapper.transform_device(X[start:stop], be.device), local),
        len(y)))
    yh = be.upload_labels(y)
    pred = be.init_pred(yh, res.ensemble.base_score)
    be.grow_rounds(data, pred, yh, 1)
    calls = comms.calls
    prof = _profile_share(lambda: be.grow_rounds(data, pred, yh,
                                                 profile_rounds))
    prof["ms_per_round"] = 1e3 * prof["wall_s"] / profile_rounds
    prof["collectives_per_round"] = (comms.calls - calls) / profile_rounds
    blk = cfg.fused_block_rounds
    steady = [r["ms_per_round"] for r in res.history[blk:]]
    return {"ensemble": res.ensemble, "raw": raw.astype(np.float32),
            "rank": be.rank, "device": str(be.device),
            "card": (torch.cuda.get_device_name(be.device)
                     if be.device.type == "cuda" else "cpu"),
            "split_comms": be.split_comms, "train_s": train_s,
            "fused_ms_per_round": float(np.mean(steady)) if steady else None,
            "counters": counters, "train_counters": train_counters,
            "bytes_model": be.collective_bytes_per_tree(
                res.ensemble.n_features),
            "profile": prof}


def _mean_ms(fn, reps: int) -> float:
    """Mean ms of fn() over `reps` calls after one untimed call: CUDA
    events around them on a card (device time), else the host clock
    around calls that end in a synchronize."""
    fn()
    _sync()
    if not torch.cuda.is_available():
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - t0) / reps
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    _sync()
    return s.elapsed_time(e) / reps


def train_mesh(device: str, x_path: str, y_path: str, cfg_kw: dict,
               fit_kw: dict | None, profile_rounds: int) -> dict:
    """chip_smoke's `mesh2d` phase on one rank: api.train of the binned
    rows in x_path / y_path (.npy, read memory-mapped: a rank reads its
    row block and keeps its column slab), timed; api.predict of the
    rank's row block through K3 (the ranks of feature shard 0 return the
    scores: their blocks tile the rows). With `profile_rounds`, that many
    fused rounds on the same rows replayed under torch.profiler (K1's and
    the NCCL kernels' device time) and, with feature shards, the routing
    broadcast (an int32 [R_local] all-reduce over the feature group) timed
    alone. Returns the ensemble, the scores, counters
    over train + predict and over train alone, times and the profile."""
    X = np.load(x_path, mmap_mode="r")
    y = np.load(y_path)
    cfg = _config(device, cfg_kw)
    be = get_backend(cfg)
    before = _counters()
    t0 = time.perf_counter()
    res = api.train(X, y, cfg, backend=be, binned=True, log_every=1,
                    **(fit_kw or {}))
    _sync()
    train_s = time.perf_counter() - t0
    trained = _counters()
    start, stop, local = mesh.row_block(len(y), be.world, be.rank)
    block = torch.from_numpy(np.ascontiguousarray(X[start:stop])).to(
        be.device)
    raw = api.predict(res.ensemble, block, binned=True, raw=True,
                      cfg=TrainConfig(device=device))
    counters = _since(before)
    m = be.mesh
    out = {"ensemble": res.ensemble, "rank": _rank(),
           "coords": (m.host, m.row, m.feature),
           "raw": raw.astype(np.float32) if m.feature == 0 else None,
           "device": str(be.device),
           "split_comms": be.split_comms, "comms_slabs": be.comms_slabs,
           "columns": mesh.column_slab(X.shape[1], m.n_feature_shards,
                                       m.feature)[2],
           "train_s": train_s, "history_len": len(res.history),
           "fused_ms_per_round": float(np.mean(
               [r["ms_per_round"]
                for r in res.history[cfg.fused_block_rounds:]]))
           if len(res.history) > cfg.fused_block_rounds else None,
           "counters": counters,
           "train_counters": {k: trained[k] - before[k] for k in trained},
           "bytes_model": be.collective_bytes_per_tree(
               res.ensemble.n_features)}
    if profile_rounds:
        data = be.upload(mesh.RowBlock(mesh.pad_rows(block, local),
                                       len(y)))
        del block
        yh = be.upload_labels(y)
        pred = be.init_pred(yh, res.ensemble.base_score)
        be.grow_rounds(data, pred, yh, 1)
        other = comms.other_bytes
        prof = _profile_share(lambda: be.grow_rounds(data, pred, yh,
                                                     profile_rounds))
        prof["ms_per_round"] = 1e3 * prof["wall_s"] / profile_rounds
        prof["k1_ms_per_round"] = 1e3 * prof["hist_device_s"] \
            / profile_rounds
        prof["other_bytes_per_round"] = (comms.other_bytes - other) \
            / profile_rounds
        out["profile"] = prof
        if be.feature_group is not None:
            fv = torch.zeros(local, dtype=torch.int32, device=be.device)
            out["route"] = {
                "bytes_per_level": local * 4,
                "ms_per_level": _mean_ms(
                    lambda: comms.psum(fv, be.feature_group), 20)}
    return out


def _chunk_fn(Xb, y, bounds):
    def f(c):
        return Xb[bounds[c]:bounds[c + 1]], y[bounds[c]:bounds[c + 1]]

    f.labels = lambda c: y[bounds[c]:bounds[c + 1]]
    return f


def train_streaming(device: str, Xb, y, bounds, cfg_kw: dict,
                    fit_kw: dict | None = None) -> dict:
    """streaming.fit_streaming on this rank over binned rows Xb cut at
    `bounds` (every rank sent the whole chunks; each uploads its block):
    the ensemble and the counters' moves."""
    from ddt_tpu_torch.streaming import fit_streaming

    cfg = _config(device, cfg_kw)
    before = _counters()
    ens = fit_streaming(_chunk_fn(Xb, y, bounds), len(bounds) - 1, cfg,
                        **(fit_kw or {}))
    return {"ensemble": ens, "counters": _since(before)}


def train_streaming_dir(device: str, src_dir: str, shards_per_chunk: int,
                        cfg_kw: dict) -> dict:
    """streaming.fit_streaming on this rank over a host-sharded shard
    directory (data/chunks.HostShardedChunks: the rank reads its own
    sub-shards only); also how many sub-shard feature reads it made."""
    from ddt_tpu_torch.data.chunks import host_sharded_chunks
    from ddt_tpu_torch.streaming import fit_streaming

    cfg = _config(device, cfg_kw)
    src = host_sharded_chunks(src_dir, shards_per_chunk)
    reads = []
    real = src.read_part

    def counted(c, slot):
        reads.append((c, slot))
        return real(c, slot)

    src.read_part = counted
    ens = fit_streaming(src, src.n_chunks, cfg)
    return {"ensemble": ens, "reads": sorted(set(reads)),
            "owned": src.owned_slots(0)}


def upload_row_shards(device: str, parts: list, total_rows: int,
                      cfg_kw: dict) -> tuple:
    """(upload_row_shards of this rank's parts, upload_chunk of the whole
    chunk) on this rank, as host arrays."""
    cfg = _config(device, cfg_kw)
    be = get_backend(cfg)
    owned = [parts[i] for i in range(len(parts))
             if i * _world() // len(parts) == _rank()]
    a = be.upload_row_shards(owned, total_rows)
    b = be.upload_chunk(np.concatenate(parts))
    return a.cpu().numpy(), b.cpu().numpy()


def train_straggler(device: str, X, y, cfg_kw: dict, plan: dict | None,
                    fit_kw: dict | None = None) -> dict:
    """api.train of binned X on this rank under the fault plan `plan` (a
    dict, armed on every rank; None: no plan) with an in-memory run log
    on every rank (the partition recorder needs one on each). Returns the
    ensemble, the writing rank's fault kinds and partition_phases
    events, the shard this rank holds at the end and the round times."""
    from ddt_tpu_torch.robustness import faultplan
    from ddt_tpu_torch.telemetry.events import RunLog

    cfg = _config(device, cfg_kw)
    log = RunLog()
    prev = faultplan.activate(None if plan is None
                              else faultplan.load_plan(plan))
    be = get_backend(cfg)
    try:
        res = api.train(X, y, cfg, backend=be, binned=True, run_log=log,
                        log_every=1, **(fit_kw or {}))
    finally:
        faultplan.deactivate(prev)
    return {"ensemble": res.ensemble, "rank": _rank(), "shard": be.rank,
            "faults": [e["kind"] for e in log.events("fault")],
            "phases": log.events("partition_phases"),
            "skew": log.events("partition_skew"),
            "ms": [r["ms_per_round"] for r in res.history]}


def train_hist_fault(device: str, X, y, cfg_kw: dict, plan: dict | None,
                     fault_rank: int, fault_rung: int = 0) -> dict:
    """api.train of binned X on this rank's Granular backend, the fault
    plan `plan` armed on rank `fault_rank` alone (None: on none) and that
    rank's ladder set to `fault_rung`. Returns the ensemble, the
    backend's ladder rung and rungs, the faults fired and the degrades
    counted on this rank."""
    from ddt_tpu_torch.robustness import faultplan
    from ddt_tpu_torch.telemetry import counters as tele_counters

    cfg = _config(device, cfg_kw)
    be = Granular(cfg)
    before = tele_counters.snapshot()["hist_oom_degrades"]
    armed = plan is not None and _rank() == fault_rank
    if _rank() == fault_rank:
        be.hist_ladder.rung = fault_rung
    active = faultplan.load_plan(plan) if armed else None
    prev = faultplan.activate(active)
    try:
        res = api.train(X, y, cfg, backend=be, binned=True)
    finally:
        faultplan.deactivate(prev)
    return {"ensemble": res.ensemble, "rung": be.hist_ladder.rung,
            "rungs": be.hist_ladder.rungs,
            "fired": 0 if active is None else len(active.fired_log),
            "degrades": tele_counters.snapshot()["hist_oom_degrades"]
            - before}


def train_streaming_straggler(device: str, src_dir: str,
                              shards_per_chunk: int, cfg_kw: dict,
                              plan: dict | None,
                              fit_kw: dict | None = None) -> dict:
    """fit_streaming on this rank over a host-sharded shard directory
    under the fault plan `plan` (armed on every rank), with an in-memory
    run log on every rank: the ensemble, the writing rank's fault kinds,
    the sub-shards this rank read and the shard it holds at the end."""
    from ddt_tpu_torch.data.chunks import host_sharded_chunks
    from ddt_tpu_torch.robustness import faultplan
    from ddt_tpu_torch.streaming import fit_streaming
    from ddt_tpu_torch.telemetry.events import RunLog

    cfg = _config(device, cfg_kw)
    src = host_sharded_chunks(src_dir, shards_per_chunk)
    reads = []
    real = src.read_part

    def counted(c, slot):
        reads.append((c, slot))
        return real(c, slot)

    src.read_part = counted
    log = RunLog()
    be = get_backend(cfg)
    prev = faultplan.activate(None if plan is None
                              else faultplan.load_plan(plan))
    try:
        ens = fit_streaming(src, src.n_chunks, cfg, backend=be, run_log=log,
                            **(fit_kw or {}))
    finally:
        faultplan.deactivate(prev)
    return {"ensemble": ens, "reads": sorted(set(reads)), "shard": be.rank,
            "faults": [e["kind"] for e in log.events("fault")]}


def train_without_lanes(device: str, X, y, cfg_kw: dict) -> int:
    """api.train of binned X on this rank with no run log, the partition
    recorder's span and flush made to raise if touched: the disabled path
    pays no event, sync or gather. Returns the trees grown."""
    from ddt_tpu_torch.telemetry import events

    def boom(*a, **k):
        raise AssertionError("partition recorder touched without a run log")

    saved = events.PartitionRecorder.flush_round, events._Span.__enter__
    events.PartitionRecorder.flush_round = boom
    events._Span.__enter__ = boom
    try:
        res = api.train(X, y, _config(device, cfg_kw), binned=True)
    finally:
        events.PartitionRecorder.flush_round, events._Span.__enter__ = saved
    return res.ensemble.n_trees



def straggler_timed(device: str, x_path: str, y_path: str, cfg_kw: dict,
                    plan: dict | None, fit_kw: dict | None = None) -> dict:
    """chip_smoke's `straggler` phase on one rank: api.train of the rows in
    x_path / y_path (.npy, memory-mapped) with an in-memory run log on
    every rank, under the fault plan `plan` (None: none). Returns the
    ensemble, the writing rank's fault kinds, the shard held at the end,
    the ms of each round, the ms of each rotation (its ring shifts
    included, synchronized), the modeled histogram-collective bytes and
    the counters' moves."""
    from ddt_tpu_torch import driver as driver_mod
    from ddt_tpu_torch.robustness import faultplan
    from ddt_tpu_torch.telemetry.events import RunLog

    X = np.load(x_path, mmap_mode="r")
    y = np.load(y_path)
    cfg = _config(device, cfg_kw)
    be = get_backend(cfg)
    log = RunLog()
    rotations = []
    real = driver_mod.Driver._repartition

    def timed(self, *a):
        _sync()
        t0 = time.perf_counter()
        real(self, *a)
        _sync()
        rotations.append(1e3 * (time.perf_counter() - t0))

    driver_mod.Driver._repartition = timed
    prev = faultplan.activate(None if plan is None
                              else faultplan.load_plan(plan))
    before = _counters()
    try:
        res = api.train(X, y, cfg, backend=be, run_log=log, log_every=1,
                        **(fit_kw or {}))
    finally:
        faultplan.deactivate(prev)
        driver_mod.Driver._repartition = real
    moved = _since(before)
    return {"ensemble": res.ensemble, "rank": _rank(), "shard": be.rank,
            "faults": [e["kind"] for e in log.events("fault")],
            "ms": [r["ms_per_round"] for r in res.history],
            "rotation_ms": rotations,
            "modeled_bytes": moved["comms.modeled_bytes"],
            "bytes_model": be.collective_bytes_per_tree(
                res.ensemble.n_features),
            "counters": moved}


def multihost_train(init_method: str, world: int, rank: int, out: str,
                    seed: int = 21) -> None:
    """One OS process of a multi-process run (tests/
    test_torch_multiprocess.py): join `world` processes over
    `init_method` (mesh.initialize_multihost, gloo on the CPU), train
    three paths at n_partitions = world on the same seeded rows (or on
    one process without a group when world is 1), and save each model
    as `out` + its name + ".npz": the fused loop in int8 ("fused"), the
    granular loop in f32 with an eval set ("granular") and the streamed
    trainer in int8 over 4 chunks ("streamed")."""
    from ddt_tpu_torch.data import datasets
    from ddt_tpu_torch.data.quantizer import quantize
    from ddt_tpu_torch.streaming import fit_streaming

    if world > 1:
        mesh.initialize_multihost(init_method, world, rank, backend="gloo")
    X, y = datasets.synthetic_binary(2048, n_features=8, seed=seed)
    Xb = quantize(X, n_bins=31, seed=seed)[0]
    base = TrainConfig(n_trees=3, max_depth=4, n_bins=31, device="cpu",
                       n_partitions=world)
    bounds = np.linspace(0, len(y), 5).astype(np.int64)

    def chunk_fn(c):
        return Xb[bounds[c]:bounds[c + 1]], y[bounds[c]:bounds[c + 1]]

    models = {
        "fused": api.train(Xb, y, base.replace(grad_dtype="int8"),
                           binned=True).ensemble,
        "granular": api.train(Xb[:1536], y[:1536], base, binned=True,
                              profile=True,
                              eval_set=(Xb[1536:], y[1536:])).ensemble,
        "streamed": fit_streaming(chunk_fn, 4,
                                  base.replace(grad_dtype="int8"))}
    for name, ens in models.items():
        ens.save(f"{out}{name}.npz")
    if world > 1:
        dist.barrier()
        dist.destroy_process_group()
