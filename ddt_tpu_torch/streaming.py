"""Out-of-core training and scoring: the rows stream through the card in
chunks (port of ddt_tpu/streaming.py's device loop).

BASELINE config 5 (10B rows x 1024 features) holds no binned matrix on
any card: it trains by streaming the row axis. Histograms are small and
additive, so per level

    hist = sum over chunks of build_histograms(chunk, g_chunk, h_chunk,
                                               node_of_row)

with each row's node found again by routing it through the tree grown so
far (ops/stream.partial_node_index) and its gradients computed again from
its chunk's predictions and labels, which stay resident on the card for
the whole run (4 bytes a row and class, and 4 bytes of leaf slot a row
and class): only the binned rows stream. The chunk source is a pure
callable `chunk_fn(c) -> (Xb_chunk uint8 [r, F], y_chunk)` (a host
array, or a tensor; a pinned one is transferred as it is); chunks may
differ in size; empty chunks are refused.

Exactness. The level tables are exact and accumulate on the card: f32
gradients as 64-bit fixed-point sums on each tree's power-of-two grid
(ops/grad "EXACT f32 HISTOGRAMS"; the grid's max |g| and |h| come from
the round-start pass over every chunk and rank), quantized ones as int32
sums on the round's shared scales. A table summed over chunks is the
whole table, so the streamed trees equal the in-memory Driver's bit for
bit, f32 and int8, on the CPU and on the card; and a checkpoint resume
equals the uninterrupted run bit for bit. Nothing is fetched a chunk:
each level's table is reduced over the row group once (an int64 or int32
all-reduce, exact, so a partitioned run equals one device's) and split
on the card, and each tree is copied to the host once.

Passes. A tree reads each chunk max_depth + 1 times: max_depth histogram
passes (LEFT children only from depth 1 on, with sibling subtraction)
and one leaf pass, which also keeps each row's leaf slot. The next round
starts with a pass that reads no chunk (ops/stream.stream_round_start):
the finished trees added to the resident predictions from the slots,
then the new round's statistics.

Uploads (CUDADevice.upload_chunk): pinned host staging, double-buffered
on a side stream and ordered by events, so a chunk's transfer runs under
the previous chunk's kernels; telemetry's `h2d_bytes` counter counts
every transfer. The device chunk cache keeps uploaded chunks on the card up to
a byte budget (`device_chunk_cache`): True takes a share of the card's
free memory (DEVICE_CHUNK_CACHE_SHARE) and nothing on the CPU, where the
"device" is host memory (the reference's rule); an int is a budget in
bytes, honoured everywhere; False re-uploads every pass.

Row partitions (a process group of cfg.n_partitions ranks, every rank
calling fit_streaming with the same source): each chunk is row-sharded
over the group, each rank uploading its block (data/chunks.
HostShardedChunks sources read only the rank's own sub-shards); feature
partitions do not stream.

Telemetry, as the Driver's: `run_log` (a path the trainer owns, or a
RunLog) gets a `streaming_device` manifest with `n_chunks`, a round
event every round ({round, train_loss: None, ms_per_round[,
valid_<metric>]}: a train loss would cost one more pass), heartbeats at
the checkpoint cadence, the resume fault and the early stop, then the
cost events, the phase timings, the counters and run_end. Its phases are
`grad` (the round-start pass), `hist` (the level passes), `leaf`, `gain`
(the rest of the level loop: split search and routing),
`fetch_tree`, `predict` and `eval` (the held-out chunks), timed by
utils/profiling.PhaseTimer, which a run log or `profile=True` turns on.
`profiler_window` and `status` are driven at every round boundary.

Robustness, as the reference's: cfg.fault_plan is activated for the
fit and the fault sink points at its run log (robustness.fit_scope);
every chunk source is wrapped in the stream-read retry seam
(utils/retry.retrying_chunk_fn: training, validation and label-only
reads, and a host-sharded source's part reads, each with the
`stream.chunk_read` injection site inside the retried call; chunk
sources are pure, so a retried read changes nothing). On a mesh with a
run log the partition recorder times each rank's `hist` passes and the
straggler watchdog reads its lanes; with cfg.straggler_repartition the
ranks rotate their row shards at a checkpoint boundary
(CUDADevice.rotate_row_partitions: the resident blocks shift, the chunk
cache is dropped and the host-sharded slot map rotates with them).

The host loop (the reference's, ddt_tpu/streaming.py:503-1018): a
backend without the stream_* surface, the CPU oracle (backends/cpu.
CPUDevice, backend="cpu"), streams the host formulation. Per level each
chunk is read, its rows routed through the partial tree on the host
(`_traverse_partial`), its gradients computed from the round-start
predictions, and its f32 histogram built by the backend and summed over
the chunks in chunk order; the split rule is the oracle's
(`_apply_level_splits`), the final leaves come from the streamed (G, H)
sums (`_apply_final_leaves`), and with sibling subtraction (off by
default on the CPU, as the reference resolves it) right children are
parent - left (`_assemble_subtracted_level`). Binary, mse and softmax
(one tree a class from the round-start predictions), learned missing,
categorical, bagging and colsample, checkpoints and held-out chunks run
as in the reference. `cache_preds=True` (the default) keeps each chunk's
raw scores on the host (4 bytes a row and class), updated a round from
each row's leaf slot (`_leaf_slot`); False recomputes them from the
partial ensemble a pass (`_rescore`). The host loop has no integer
histogram: quantized gradients are refused there, as the reference
refuses them, and `device_chunk_cache` does not apply.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from typing import Callable

import numpy as np
import torch

from ddt_tpu_torch import robustness
from ddt_tpu_torch.api import predict_proba_np
from ddt_tpu_torch.backends import get_backend
from ddt_tpu_torch.backends.base import PACKED_FIELDS
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.driver import Driver
from ddt_tpu_torch.models.tree import TreeEnsemble, empty_ensemble
from ddt_tpu_torch.ops import grad as grad_ops
from ddt_tpu_torch.ops import grow as grow_ops
from ddt_tpu_torch.ops import sampling
from ddt_tpu_torch.ops import split as split_ops
from ddt_tpu_torch.parallel import comms, mesh
from ddt_tpu_torch.reference import numpy_trainer as ref_trainer
from ddt_tpu_torch.telemetry import annotations, costmodel
from ddt_tpu_torch.telemetry import counters as tele_counters
from ddt_tpu_torch.robustness.watchdog import (StragglerWatchdog,
                                               feed_watchdog)
from ddt_tpu_torch.telemetry.events import (
    PartitionRecorder, RoundRecorder, RunLog, comms_manifest_fields,
    derive_run_id, emit_early_stop, emit_train_heartbeat, finish_run_log)
from ddt_tpu_torch.utils import checkpoint, retry
from ddt_tpu_torch.utils.profiling import PhaseTimer
from ddt_tpu_torch.utils.metrics import (GREATER_IS_BETTER, default_metric,
                                         evaluate)

log = logging.getLogger("ddt_tpu_torch.streaming")

ChunkFn = Callable[[int], tuple]

#: Share of the card's free memory (at the start of a fit) the default
#: device chunk cache may take; the rest is the run's working set.
DEVICE_CHUNK_CACHE_SHARE = 0.5


def validate_mapper_config(mapper, cfg: TrainConfig) -> None:
    """The mapper<->config consistency guards api.train enforces, for the
    streaming paths (a mismatched mapper trains a silently wrong model,
    not a crashing one)."""
    if mapper.n_bins != cfg.n_bins:
        raise ValueError(
            f"mapper was fitted with n_bins={mapper.n_bins} but "
            f"cfg.n_bins={cfg.n_bins}")
    if (cfg.missing_policy == "learn") != mapper.missing_bin:
        raise ValueError(
            f"mapper.missing_bin={mapper.missing_bin} but "
            f"cfg.missing_policy={cfg.missing_policy!r}; refit the mapper "
            "with the same policy")
    if cfg.cat_features:
        bad = mapper.non_identity_columns(cfg.cat_features)
        if bad:
            raise ValueError(
                f"cat_features {bad} were not identity-binned by this "
                "mapper; refit it with "
                f"cat_features={tuple(sorted(cfg.cat_features))}")


def binned_chunks(chunk_fn: ChunkFn, mapper, cfg: TrainConfig) -> ChunkFn:
    """Adapt a RAW-float chunk source into the binned source fit_streaming
    consumes, via a fitted BinMapper (data/quantizer.
    fit_bin_mapper_streaming fits one without materialising the
    dataset). Every re-read re-bins (on the host); callers whose binned
    chunks fit somewhere can cache them (data/chunks.write_binned_cache).
    `cfg` is required so the mapper<->config guards hold here too."""
    validate_mapper_config(mapper, cfg)

    def f(c: int):
        X, y = chunk_fn(c)
        return mapper.transform(np.asarray(X, np.float32)), y

    # Side channels: the label-only pass and the shape probe skip the
    # binning of chunks they would throw away.
    f.labels = lambda c: chunk_fn(c)[1]
    f.n_features = mapper.n_features
    return f


class _StreamEval:
    """Held-out-chunk validation: the per-round metric over streamed
    validation chunks, evaluated on the host in f64 over the concatenated
    raw scores (the reference's streamed rule, so auc works), best-round
    tracking and early stopping."""

    def __init__(self, valid_chunk_fn: ChunkFn, n_valid_chunks: int,
                 metric_name: str | None, loss: str,
                 early_stopping_rounds: int | None,
                 history: list | None):
        if n_valid_chunks < 1:
            raise ValueError("validation needs n_valid_chunks >= 1")
        self.fn = valid_chunk_fn
        self.n = n_valid_chunks
        self.metric = metric_name or default_metric(loss)
        if self.metric not in GREATER_IS_BETTER:
            raise ValueError(
                f"unknown metric {self.metric!r}; "
                f"have {sorted(GREATER_IS_BETTER)}")
        if self.metric == "auc" and loss == "softmax":
            raise ValueError(
                "auc is a binary metric; softmax validation supports "
                "logloss or accuracy")
        self.sign = 1.0 if GREATER_IS_BETTER[self.metric] else -1.0
        self.patience = early_stopping_rounds
        self.history = history if history is not None else []
        labels_of = getattr(valid_chunk_fn, "labels", None) or (
            lambda c: valid_chunk_fn(c)[1])
        ys = [np.asarray(labels_of(c)) for c in range(self.n)]
        if any(len(y) == 0 for y in ys):
            raise ValueError("empty validation chunks are not allowed")
        self._ys = ys
        self.y = np.concatenate(ys)
        self.lens = [len(y) for y in ys]
        self.best = -np.inf
        self.best_round: int | None = None
        self.best_score: float | None = None

    def labels(self, c: int) -> np.ndarray:
        """Chunk c's labels without re-reading (or re-binning) it."""
        return self._ys[c]

    def record(self, rnd: int, raw_scores: np.ndarray) -> bool:
        """Score round `rnd`; True when early stopping says stop after
        it."""
        s = evaluate(self.metric, self.y, raw_scores)
        self.history.append({"round": rnd + 1, f"valid_{self.metric}": s})
        log.info("streaming: round %d valid_%s=%.6f", rnd + 1, self.metric,
                 s)
        if self.sign * s > self.best:
            self.best = self.sign * s
            self.best_round = rnd
            self.best_score = s
        if self.patience is None:
            return False
        if self.best_round is None:
            raise ValueError(
                f"validation {self.metric} has been NaN since round 1 "
                "(degenerate validation chunks); cannot early-stop on it")
        return rnd - self.best_round >= self.patience


class _DeviceChunkCache:
    """Uploads chunk c (backend.upload_chunk, or upload_row_shards for a
    host-sharded source) and keeps it on the device while the shared byte
    budget lasts; past it a chunk is uploaded again on every pass into
    the staging buffers. The first upload of each chunk checks its bins
    against n_bins (a device max and one scalar read, over the world on
    a mesh), as the in-memory upload does."""

    def __init__(self, backend, chunk_fn, budget: list, rows: list,
                 n_features: int):
        self._backend = backend
        self._chunk_fn = chunk_fn
        self._budget = budget          # [remaining bytes], train + valid
        self._rows, self._n_features = rows, n_features
        self._cached: dict = {}
        self._seen: set = set()

    def _upload(self, c: int, keep: bool):
        src = self._chunk_fn
        if getattr(src, "host_sharded", False):
            parts = [src.read_part(c, s) for s in src.owned_slots(c)]
            return self._backend.upload_row_shards(parts, src.chunk_rows(c),
                                                   keep)
        return self._backend.upload_chunk(src(c)[0], keep)

    def _size(self, c: int) -> int:
        src = self._chunk_fn
        if getattr(src, "host_sharded", False):
            rows = src.chunk_rows(c)
        else:
            rows = self._rows[c]
        local = self._backend.block_bounds(rows)[2]
        return local * self._n_features

    def drop(self) -> None:
        """After a straggler rotation: the cached blocks belong to the
        shard this rank held; they are dropped and their bytes returned
        to the budget, so the next pass uploads the shard held now. (A
        ring shift of them would need every rank to cache the same
        chunks, and the budget comes from each card's free memory.)"""
        for data in self._cached.values():
            self._budget[0] += data.numel()
        self._cached.clear()

    def get(self, c: int) -> torch.Tensor:
        hit = self._cached.get(c)
        if hit is not None:
            return hit
        keep = self._size(c) <= self._budget[0]
        data = self._upload(c, keep)
        if keep:
            self._budget[0] -= data.numel()
            self._cached[c] = data
        if c not in self._seen:
            self._seen.add(c)
            self._backend.check_bins(data)
        return data


def _cache_budget(device_chunk_cache, backend) -> list:
    if device_chunk_cache is True:
        if backend.device.type != "cuda":
            return [0]
        free, _ = torch.cuda.mem_get_info(backend.device)
        return [int(free * DEVICE_CHUNK_CACHE_SHARE)]
    if device_chunk_cache is False:
        return [0]
    return [int(device_chunk_cache)]


def fit_streaming(
    chunk_fn: ChunkFn,
    n_chunks: int,
    cfg: TrainConfig,
    backend=None,
    cache_preds: bool = True,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 25,
    valid_chunk_fn: ChunkFn | None = None,
    n_valid_chunks: int = 0,
    eval_metric: str | None = None,
    early_stopping_rounds: int | None = None,
    history: list | None = None,
    device_chunk_cache: "bool | int" = True,
    run_log: "RunLog | str | None" = None,
    profile: bool = False,
    profiler_window=None,
    status=None,
) -> TreeEnsemble:
    """Train a GBDT over `n_chunks` streamed chunks (module docstring) on
    cfg.device ("cuda" unless the config says "cpu"), or on the host
    through the CPU oracle (cfg.backend "cpu": the host loop, where
    `cache_preds` applies).

    Validation: held-out chunks (`valid_chunk_fn`, `n_valid_chunks`) are
    scored every round (their margins resident on the device, the metric
    on the host) into `history` ({"round", "valid_<metric>"}); with
    `early_stopping_rounds` training stops after that many rounds without
    improvement and the ensemble is truncated to the best round, as
    Driver.fit truncates. Checkpoints (`checkpoint_dir`, every
    `checkpoint_every` rounds and at the end): a resume rebuilds the
    resident predictions by replaying the restored trees with the
    training loop's own update (ops/stream.stream_update_pred), so the
    resumed run equals the uninterrupted one bit for bit. Sampling:
    bagging keeps a row by the counter hash of (seed, round, global row),
    computed per chunk from its global row offset, and colsample draws
    the Driver's per-(round, class) masks, so sampled runs grow the
    in-memory trees too. Telemetry (`run_log`, `profile`,
    `profiler_window`, `status`): the module docstring; a path-built run
    log is closed, the cost capture removed and a window stopped on every
    exit."""
    own_run_log = isinstance(run_log, str)
    run_log = RunLog.coerce(run_log)
    lanes = run_log is not None
    cost = None
    try:
        if backend is None:
            backend = get_backend(cfg)
        m = backend.mesh
        if run_log is not None and m is not None \
                and (m.row != 0 or m.feature != 0):
            run_log = None          # each host's first rank writes
        if run_log is not None:
            cost = costmodel.activate()
        with robustness.fit_scope(cfg, run_log):
            chunk_fn = retry.retrying_chunk_fn(chunk_fn)
            if valid_chunk_fn is not None:
                valid_chunk_fn = retry.retrying_chunk_fn(valid_chunk_fn)
            return _fit_streaming(
                chunk_fn, n_chunks, cfg, backend, checkpoint_dir,
                checkpoint_every, valid_chunk_fn, n_valid_chunks,
                eval_metric, early_stopping_rounds, history,
                device_chunk_cache, cache_preds,
                _Telemetry(run_log, profile, profiler_window, status,
                           cost, lanes))
    finally:
        costmodel.deactivate(cost)
        if profiler_window is not None:
            profiler_window.close()
        if own_run_log and run_log is not None:
            run_log.close()


class _Telemetry:
    """One streamed run's telemetry state: the run log, the phase timer
    (a run log or profile), the window, the status, the cost collector,
    and the counters' start."""

    def __init__(self, run_log, profile, window, status, cost,
                 lanes: bool = False):
        self.run_log = run_log
        # Whether this rank was given a run log (every rank's partition
        # recorder keys on it), and the recorder and watchdog (start).
        self.lanes = lanes
        self.recorder = None
        self.watchdog = None
        self.profile = profile
        self.window = window
        self.status = status
        self.cost = cost
        self.timer = None
        self.counters_start = None
        self.t0 = time.perf_counter()

    def start(self, backend) -> None:
        """Before pass 0: the timer, and the counters' start so the label
        uploads count."""
        if self.profile or self.run_log is not None:
            self.timer = PhaseTimer(backend.device)
        self.recorder = PartitionRecorder(self.run_log, backend,
                                          active=self.lanes)
        if self.recorder.active:
            self.watchdog = StragglerWatchdog(
                threshold=backend.cfg.straggler_skew_threshold)
        if self.run_log is not None:
            self.counters_start = tele_counters.snapshot()
            tele_counters.reset_device_peak()

    def manifest(self, backend, cfg, rows: int, F: int,
                 n_chunks: int, trainer: str) -> None:
        run_id = None
        if self.run_log is not None or self.window is not None \
                or self.status is not None:
            run_id = derive_run_id(
                trainer=trainer, rows=rows, features=int(F),
                n_chunks=n_chunks, **dataclasses.asdict(cfg))
        if self.window is not None:
            self.window.bind(run_id)
        if self.status is not None:
            self.status.begin_run(run_id=run_id, total_rounds=cfg.n_trees,
                                  rows=rows)
        if self.run_log is None:
            return
        m = backend.mesh
        self.run_log.run_id = run_id
        self.run_log.emit(
            "run_manifest", trainer=trainer,
            backend=backend.name, loss=cfg.loss, n_trees=cfg.n_trees,
            max_depth=cfg.max_depth, n_bins=cfg.n_bins, rows=rows,
            features=int(F), n_classes=cfg.n_outputs, seed=cfg.seed,
            n_chunks=n_chunks, distributed=m is not None, run_id=run_id,
            host=0 if m is None else int(m.host),
            **comms_manifest_fields(backend),
            **(self.window.manifest_fields()
               if self.window is not None else {}))

    def round_end(self, rnd: int, ms: float, ev) -> None:
        tele_counters.record_train_round()
        if self.run_log is None and self.status is None:
            return
        score = None
        if ev is not None and ev.history \
                and ev.history[-1].get("round") == rnd + 1:
            score = ev.history[-1].get(f"valid_{ev.metric}")
        rec = RoundRecorder.make_record(
            rnd, ms, None, None if ev is None else ev.metric, score)
        if self.run_log is not None:
            self.run_log.emit("round", **rec)
        if self.status is not None:
            self.status.round_end(rnd, ms, rec)

    def finish(self, ens: TreeEnsemble, C: int) -> TreeEnsemble:
        if self.profile and self.timer is not None:
            self.timer.log_report(log)
        if self.status is not None:
            self.status.set_phase("done")
        finish_run_log(self.run_log, self.timer, self.counters_start,
                       ens.n_trees // C,
                       round(time.perf_counter() - self.t0, 4),
                       costs=self.cost, partitions=self.recorder)
        return ens


def _fit_streaming(chunk_fn, n_chunks, cfg, backend, checkpoint_dir,
                   checkpoint_every, valid_chunk_fn, n_valid_chunks,
                   eval_metric, early_stopping_rounds, history,
                   device_chunk_cache, cache_preds,
                   tel: _Telemetry) -> TreeEnsemble:
    """fit_streaming's body: pass 0, then the device loop, or the host
    loop for a backend without the stream_* surface."""
    device = getattr(backend, "stream_level_hist", None) is not None
    if cfg.grad_dtype != "f32" and not device:
        # The host loop's histograms are the oracle's f32 ones: a
        # quantized run there would be an f32 run under another name.
        raise NotImplementedError(
            f"grad_dtype={cfg.grad_dtype!r} streaming needs a backend with "
            "the stream_* surface (backend='cuda'; device='cpu' runs it "
            "on the CPU); the host loop has no integer histogram")
    if cfg.feature_partitions > 1:
        raise NotImplementedError(
            "the streamed trainer is row-parallel only: "
            "feature_partitions > 1 does not stream")
    mesh.check_partitions(cfg)
    if early_stopping_rounds is not None and valid_chunk_fn is None:
        raise ValueError("early_stopping_rounds requires valid_chunk_fn")

    tel.start(backend)
    # Pass 0: labels (uploaded now: they stay resident), chunk sizes, the
    # base score; no binned chunk is read.
    y_sum, y_cnt = 0.0, 0
    chunk_lens, y_dev = [], []
    labels_of = getattr(chunk_fn, "labels", None) or (
        lambda c: chunk_fn(c)[1])
    for c in range(n_chunks):
        yc = np.asarray(labels_of(c))
        if len(yc) == 0:
            raise ValueError(
                f"chunk {c} is empty; empty chunks are not allowed "
                "(re-cut the chunk boundaries)")
        y_sum += float(np.sum(yc))
        y_cnt += len(yc)
        chunk_lens.append(len(yc))
        if device:
            y_dev.append(backend.upload_labels(yc))
    chunk_starts = np.concatenate([[0], np.cumsum(chunk_lens)]) \
        .astype(np.int64)
    mean = y_sum / max(1, y_cnt)
    if cfg.loss == "logloss":
        p_ = float(np.clip(mean, 1e-6, 1 - 1e-6))
        bs = float(np.log(p_ / (1 - p_)))
    elif cfg.loss == "softmax":
        bs = 0.0
    else:
        bs = float(mean)
    F = getattr(chunk_fn, "n_features", None)
    if F is None:
        F = chunk_fn(0)[0].shape[1]
    C = cfg.n_outputs
    ens = empty_ensemble(
        cfg.n_trees * C, cfg.max_depth, F, cfg.learning_rate, bs, cfg.loss,
        cfg.n_classes, missing_bin=cfg.missing_policy == "learn",
        n_bins=cfg.n_bins, cat_features=cfg.cat_features)

    tel.manifest(backend, cfg, int(y_cnt), F, n_chunks,
                 "streaming_device" if device else "streaming_host")
    drv = Driver(backend, cfg, checkpoint_dir=checkpoint_dir,
                 checkpoint_every=checkpoint_every)
    start_round = 0
    if checkpoint_dir is not None:
        start_round = checkpoint.try_resume(checkpoint_dir, ens, cfg,
                                            run_log=tel.run_log)
        if backend.mesh is not None:
            drv.check_resume_agrees(ens, start_round)
        if start_round > 0:
            log.info("streaming: resumed from checkpoint at round %d",
                     start_round)
            if tel.run_log is not None:
                tel.run_log.emit("fault", kind="checkpoint_resume",
                                 round=start_round)
        if start_round >= cfg.n_trees:
            return tel.finish(ens, C)
    ev = None
    if valid_chunk_fn is not None:
        ev = _StreamEval(valid_chunk_fn, n_valid_chunks, eval_metric,
                         cfg.loss, early_stopping_rounds, history)
    if not device:
        return tel.finish(_fit_streaming_host(
            chunk_fn, n_chunks, cfg, backend, drv, ens, bs, chunk_lens,
            chunk_starts, start_round, ev, cache_preds, tel), C)
    return tel.finish(_fit_streaming_device(
        chunk_fn, n_chunks, cfg, backend, drv, ens, bs, y_dev, chunk_lens,
        chunk_starts, start_round, ev, device_chunk_cache, tel), C)


def _merge_stats(acc, st, exact: bool):
    """Chunk statistics merged on the device: maxes max; the quantized
    path's sums (columns 1 and 3) add."""
    if acc is None:
        return st
    if exact:
        return torch.maximum(acc, st)
    out = torch.maximum(acc, st)
    out[:, 1::2] = acc[:, 1::2] + st[:, 1::2]
    return out


def _fit_streaming_device(chunk_fn, n_chunks, cfg, backend, drv, ens, bs,
                          y_dev, chunk_lens, chunk_starts, start_round, ev,
                          device_chunk_cache, tel) -> TreeEnsemble:
    """The device loop (fit_streaming's module docstring)."""
    ph = annotations.phase_ctx(tel.timer)
    window = tel.window
    dev = backend.device
    group = backend.group
    C, D, B = cfg.n_outputs, cfg.max_depth, cfg.n_bins
    F = ens.n_features
    exact = cfg.grad_dtype == "f32"
    acc_dtype = torch.int64 if exact else torch.int32
    budget = _cache_budget(device_chunk_cache, backend)
    chunks = _DeviceChunkCache(backend, chunk_fn, budget, chunk_lens, F)
    pred_dev = [backend.init_pred(h, bs) for h in y_dev]
    val_chunks = val_pred = val_y = None
    if ev is not None:
        val_chunks = _DeviceChunkCache(backend, ev.fn, budget, ev.lens, F)
        val_y = [backend.upload_labels(ev.labels(c)) for c in range(ev.n)]
        val_pred = [backend.init_pred(h, bs) for h in val_y]
    # Global row ids of each rank block's first row, and the global rows
    # the exact grid is bounded over (every rank's padded blocks).
    row_start = [backend.chunk_row_start(int(chunk_starts[c]),
                                         chunk_lens[c])
                 for c in range(n_chunks)]
    n_global = sum(backend.block_bounds(n)[2] for n in chunk_lens) \
        * backend.world
    if not exact and n_global >= grad_ops.GRAD_ROW_LIMIT:
        raise ValueError(
            f"quantized streaming over {n_global} rows exceeds the "
            f"overflow proof's row ceiling ({grad_ops.GRAD_ROW_LIMIT}); "
            "use grad_dtype='f32'")

    def tree_full(t):
        return (ens.feature[t], ens.threshold_bin[t], ens.is_leaf[t],
                ens.leaf_value[t], ens.default_left[t])

    if start_round > 0:
        # Resume: the restored trees replayed with the training loop's own
        # update (rounds ascending, classes ascending), one pass.
        for preds, src, n in ((pred_dev, chunks, n_chunks),
                              (val_pred, val_chunks,
                               0 if ev is None else ev.n)):
            for c in range(n):
                data = src.get(c)
                for r in range(start_round):
                    for cls in range(C):
                        backend.stream_update_pred(
                            data, preds[c], tree_full(r * C + cls), cls)

    def passes():
        """(chunk, its rows on the device) for every chunk; the next
        chunk's upload is queued after the caller queued its work on the
        current one."""
        data = chunks.get(0)
        for c in range(n_chunks):
            yield c, data
            if c + 1 < n_chunks:
                data = chunks.get(c + 1)

    subtract = backend.hist_subtraction
    cat_dev = backend.cat_mask(F)
    rec, watchdog = tel.recorder, tel.watchdog
    ordered = cfg.straggler_repartition
    slots = [None] * n_chunks        # [C, R] int32 leaf slots per chunk
    prev_values = None               # the last round's leaf values
    t_out = start_round * C
    rows_local = sum(backend.block_bounds(n)[2] for n in chunk_lens)
    for rnd in range(start_round, cfg.n_trees):
        if window is not None:
            window.round_start(rnd)
        t_round = time.perf_counter()
        # Round start: the previous round's trees into pred, and the new
        # round's statistics; no chunk read.
        with ph("grad"):
            stats = None
            for c in range(n_chunks):
                stats = _merge_stats(stats, backend.stream_round_start(
                    pred_dev[c], y_dev[c], slots[c], prev_values, rnd,
                    row_start[c]), exact)
            if exact:
                stats = comms.pmax(stats, group)
                scales = [grad_ops.fixed_scales(stats[c], n_global)
                          for c in range(C)]
                convert = [grad_ops.fixed_inverse(s) for s in scales]
            else:
                mx = comms.pmax(stats[:, 0::2].contiguous(), group)
                sm = (comms.psum_ordered(stats[:, 1::2].contiguous(), group,
                                         backend.rank) if ordered
                      else comms.psum(stats[:, 1::2].contiguous(), group))
                convert = [grad_ops.quant_scale(mx[c], sm[c],
                                                cfg.grad_dtype)
                           for c in range(C)]
                scales = convert
        round_trees = []
        for cls in range(C):
            fmask = None
            if cfg.colsample_bytree < 1.0:
                fmask = torch.from_numpy(sampling.colsample_mask(
                    cfg.seed, rnd, cls, F, cfg.colsample_bytree)).to(dev)
            tree = grow_ops.new_tree(D, 0, dev)
            parts = (tree.feature, tree.threshold_bin, tree.is_leaf,
                     tree.default_left)

            def level(depth, parent_hist, parent_split, rung, split):
                """One pass: every chunk's rows of level `depth` (LEFT
                children only under sibling subtraction) added into one
                table, reduced over the row group, then split (each
                chunk's build retries an injected fault only, ops/
                histogram; `rung` is 0)."""
                sub = parent_hist is not None
                n_build = (1 << depth) // 2 if sub else 1 << depth
                with ph("hist"):
                    acc = torch.zeros((n_build, F, B, 2), dtype=acc_dtype,
                                      device=dev)
                    for c, data in passes():
                        with rec.span("hist"):
                            backend.stream_level_hist(
                                data, pred_dev[c], y_dev[c], parts, depth,
                                acc, cls, rnd, row_start[c], build_left=sub,
                                scales=scales[cls])
                    acc = comms.psum(acc, group, modeled=True)
                hist = grow_ops.assemble_subtracted(
                    parent_hist, acc, parent_split) if sub else acc
                return split(hist, *split_ops.node_totals(hist)), hist

            def leaf_sums():
                """The leaf pass: the last level's (G, H), and each row's
                leaf slot kept for the next round's pred update."""
                with ph("leaf"):
                    GH = torch.zeros((1 << D, 2), dtype=acc_dtype,
                                     device=dev)
                    for c, data in passes():
                        slot = backend.stream_leaf_gh(
                            data, pred_dev[c], y_dev[c], parts, GH, cls, rnd,
                            row_start[c], scales=scales[cls])
                        if slots[c] is None:
                            slots[c] = torch.empty((C, slot.shape[0]),
                                                   dtype=torch.int32,
                                                   device=dev)
                        slots[c][cls] = slot
                    return comms.psum(GH, group, modeled=True)

            # The level loop: its hist and leaf passes are phases of their
            # own, nested; "gain" keeps the rest (split search, routing).
            with ph("gain"):
                grow_ops.grow_levels(
                    tree, D, level, leaf_sums, reg_lambda=cfg.reg_lambda,
                    min_child_weight=cfg.min_child_weight,
                    min_split_gain=cfg.min_split_gain,
                    hist_subtraction=subtract, feature_mask=fmask,
                    missing_bin=cfg.missing_policy == "learn",
                    cat_mask=cat_dev,
                    dequant=None if exact else convert[cls],
                    inv_scale=convert[cls] if exact else None)
            round_trees.append(tree)
            with ph("fetch_tree"):
                host = backend.fetch_grown_tree(tree)
            for k in PACKED_FIELDS:
                getattr(ens, k)[t_out] = host[k]
            t_out += 1
        prev_values = [t.leaf_value for t in round_trees]

        stop = False
        if ev is not None:
            with ph("predict"):
                scores = []
                for c in range(ev.n):
                    data = val_chunks.get(c)
                    for cls, t in enumerate(round_trees):
                        backend.stream_update_pred(
                            data, val_pred[c],
                            (t.feature, t.threshold_bin, t.is_leaf,
                             t.leaf_value, t.default_left), cls)
                    scores.append(val_pred[c][:ev.lens[c]].cpu().numpy())
            with ph("eval"):
                stop = ev.record(rnd, np.concatenate(scores))
        ms = 1e3 * (time.perf_counter() - t_round)
        tele_counters.record_grad_stream(
            C * tele_counters.grad_stream_bytes(rows_local, D,
                                                cfg.grad_dtype))
        if not exact:
            tele_counters.record_grad_quant_round()
        tel.round_end(rnd, ms, ev)
        if window is not None:
            window.round_end(rnd)
        if stop:
            log.info("streaming: early stop at round %d (best %s=%.6f at "
                     "round %d)", rnd + 1, ev.metric, ev.best_score,
                     ev.best_round + 1)
            emit_early_stop(tel.run_log, rnd + 1, ev.metric,
                            ev.best_round + 1, ev.best_score)
            ens = ens.truncate((ev.best_round + 1) * C)
            drv.save_checkpoint(ens, ev.best_round + 1)
            return ens
        if rec.active:
            feed_watchdog(watchdog, tel.run_log, rnd, rec.flush_round(rnd),
                          log)
        log.info("streaming: round %d/%d done", rnd + 1, cfg.n_trees)
        drv.save_checkpoint(ens, rnd + 1, drv.checkpoint_every)
        every = drv.checkpoint_every
        if (rnd + 1) % every == 0:
            has_dir = drv.checkpoint_dir is not None
            if tel.status is not None and has_dir:
                tel.status.checkpoint_saved(rnd + 1)
            emit_train_heartbeat(
                tel.run_log, rnd=rnd, total_rounds=cfg.n_trees,
                checkpoint_round=rnd + 1 if has_dir else None,
                ms_per_round=ms)
            if watchdog is not None and cfg.straggler_repartition \
                    and watchdog.pending_repartition:
                if backend.rotate_row_partitions():
                    _rotate_resident(backend, chunk_fn, chunks, y_dev,
                                     pred_dev, slots, val_chunks, val_y,
                                     val_pred, row_start, chunk_starts,
                                     chunk_lens)
                    log.warning("streaming: repartitioned at round %d: "
                                "rotated the row shards off the "
                                "straggling rank", rnd + 1)
                    if tel.run_log is not None:
                        tel.run_log.emit("fault", kind="repartition",
                                         round=rnd + 1, rotation=1)
                watchdog.repartition_done()
    drv.save_checkpoint(ens, cfg.n_trees)
    return ens


def _go_right(fv: np.ndarray, nodes: np.ndarray, feature: np.ndarray,
              threshold_bin: np.ndarray, default_left: np.ndarray | None,
              missing_bin_value: int, cat_features: tuple) -> np.ndarray:
    """The routing rule on the host (ordinal, one-vs-rest categorical, the
    reserved NaN bin's learned direction) for rows with bins `fv` at
    heap slots `nodes`."""
    thr = threshold_bin[nodes]
    right = fv > thr
    if cat_features:
        cat = np.isin(feature[nodes], cat_features)
        right = np.where(cat, fv != thr, right)
    if missing_bin_value >= 0:
        right = np.where(fv == missing_bin_value, ~default_left[nodes],
                         right)
    return right


def _traverse_partial(Xb: np.ndarray, feature, threshold_bin, is_leaf,
                      depth: int, default_left=None,
                      missing_bin_value: int = -1,
                      cat_features: tuple = ()) -> np.ndarray:
    """Level-local node of each row at `depth` (int32; -1 for a row frozen
    at a leaf above): the in-memory level loop's (node_id, frozen)
    evolution from the node arrays alone, on the host."""
    R = Xb.shape[0]
    node = np.zeros(R, np.int64)
    frozen = np.zeros(R, bool)
    for _ in range(depth):
        live = ~frozen & ~is_leaf[node]
        frozen |= is_leaf[node]
        f = feature[node[live]]
        fv = Xb[live, f].astype(np.int64)
        right = _go_right(fv, node[live], feature, threshold_bin,
                          default_left, missing_bin_value, cat_features)
        node[live] = 2 * node[live] + 1 + right
    out = (node - ((1 << depth) - 1)).astype(np.int32)
    out[frozen] = -1
    return out


def _apply_level_splits(hist: np.ndarray, cfg: TrainConfig, depth: int,
                        feature, threshold_bin, is_leaf, leaf_value,
                        split_gain, default_left=None,
                        feature_mask: np.ndarray | None = None) -> None:
    """Level `depth`'s decisions from its summed histogram, written into
    the node arrays in place: the oracle's split search
    (reference/numpy_trainer.best_splits) with the round's colsample
    mask; a node without a split becomes a leaf of -G / (H + lambda)."""
    n_level = 1 << depth
    offset = n_level - 1
    G, H = ref_trainer.node_totals(hist)
    cat_mask = None
    if cfg.cat_features:
        cat_mask = np.zeros(hist.shape[1], bool)
        cat_mask[list(cfg.cat_features)] = True
    gains, feats, bins, dls = ref_trainer.best_splits(
        hist, cfg.reg_lambda, cfg.min_child_weight,
        feature_mask=feature_mask,
        missing_bin=cfg.missing_policy == "learn", cat_mask=cat_mask)
    with np.errstate(divide="ignore", invalid="ignore"):   # empty nodes
        value = np.where(H > 0, -G / (H + cfg.reg_lambda), 0.0).astype(
            np.float32)
    do_split = (gains > cfg.min_split_gain) & np.isfinite(gains) & (H > 0)
    for i in range(n_level):
        slot = offset + i
        if do_split[i]:
            feature[slot] = feats[i]
            threshold_bin[slot] = bins[i]
            split_gain[slot] = gains[i]
            if default_left is not None:
                default_left[slot] = dls[i]
        else:
            is_leaf[slot] = True
            leaf_value[slot] = value[i]


def _assemble_subtracted_level(parent_hist: np.ndarray, left: np.ndarray,
                               is_leaf: np.ndarray,
                               depth: int) -> np.ndarray:
    """A level's histogram from the previous level's summed one and this
    level's summed LEFT children: right = parent - left, exactly zero
    under a parent that did not split, interleaved to level order."""
    half = 1 << (depth - 1)
    offset = half - 1
    gate = ~is_leaf[offset:offset + half]
    right = np.where(gate[:, None, None, None], parent_hist - left,
                     left.dtype.type(0))
    out = np.empty((2 * half,) + left.shape[1:], left.dtype)
    out[0::2] = left
    out[1::2] = right
    return out


def _apply_final_leaves(Gl: np.ndarray, Hl: np.ndarray, cfg: TrainConfig,
                        is_leaf: np.ndarray, leaf_value: np.ndarray) -> None:
    """The last level's leaf values from its streamed (G, H) sums."""
    n_last = 1 << cfg.max_depth
    offset = n_last - 1
    with np.errstate(divide="ignore", invalid="ignore"):   # empty nodes
        vals = np.where(Hl > 0, -Gl / (Hl + cfg.reg_lambda), 0.0)
    is_leaf[offset:offset + n_last] = True
    leaf_value[offset:offset + n_last] = vals.astype(np.float32)


def _add_round(preds: list, Xs, trees: list, cfg: TrainConfig) -> None:
    """preds[c] += lr * the leaf each row of chunk c reaches in each of
    the round's trees (one a class), in class order."""
    for c, X in enumerate(Xs):
        for cls, (feature, thr, is_leaf, leaf_value, dl) in enumerate(trees):
            slot = _leaf_slot(X, feature, thr, is_leaf, cfg.max_depth, dl,
                              cfg.missing_bin_value, cfg.cat_features)
            dv = cfg.learning_rate * leaf_value[slot]
            if preds[c].ndim == 2:
                preds[c][:, cls] += dv
            else:
                preds[c] += dv


def _fit_streaming_host(chunk_fn, n_chunks, cfg, backend, drv, ens, bs,
                        chunk_lens, chunk_starts, start_round, ev,
                        cache_preds, tel) -> TreeEnsemble:
    """The host loop (module docstring; the reference's host formulation,
    ddt_tpu/streaming.py:799-1018)."""
    ph = annotations.phase_ctx(tel.timer)
    window = tel.window
    C, D = cfg.n_outputs, cfg.max_depth
    F = ens.n_features
    N = cfg.n_nodes_total
    route_kw = dict(missing_bin_value=cfg.missing_bin_value,
                    cat_features=cfg.cat_features)

    def fresh(n):
        if C > 1:
            return np.zeros((n, C), np.float32)    # softmax: base 0
        return np.full(n, bs, np.float32)

    def resumed(fn, n):
        part = ens.truncate(start_round * C)
        return [part.predict_raw_roundwise(fn(c)[0], binned=True)
                .astype(np.float32) for c in range(n)]

    # The one O(R) structure: each chunk's raw scores (4 bytes a row and
    # class), or recomputed from the partial ensemble a pass.
    preds = None
    if cache_preds:
        preds = ([fresh(n) for n in chunk_lens] if start_round == 0
                 else resumed(chunk_fn, n_chunks))
    val_preds = None
    if ev is not None:
        val_preds = ([fresh(n) for n in ev.lens] if start_round == 0
                     else resumed(ev.fn, ev.n))
    subtract = grow_ops.resolve_hist_subtraction(cfg.hist_subtraction,
                                                 "cpu")
    rows = int(sum(chunk_lens))
    t_out = start_round * C
    for rnd in range(start_round, cfg.n_trees):
        if window is not None:
            window.round_start(rnd)
        t_round = time.perf_counter()

        def chunk_grads(c, Xc, yc, cls, rnd=rnd):
            """Chunk c's (g, h) of class `cls` from the round-start scores,
            bagged by (seed, round, global row)."""
            pred = preds[c] if preds is not None else _rescore(
                ens, rnd * C, Xc, bs)
            g, h = ref_trainer.grad_hess(pred, np.asarray(yc), cfg.loss)
            if g.ndim == 2:
                g, h = g[:, cls], h[:, cls]
            if cfg.subsample < 1.0:
                keep = sampling.row_keep_np(cfg.seed, rnd,
                                            int(chunk_starts[c]), len(yc),
                                            cfg.subsample)
                g, h = g * keep, h * keep
            return g, h

        round_trees = []
        for cls in range(C):
            fmask = None
            if cfg.colsample_bytree < 1.0:
                fmask = sampling.colsample_mask(cfg.seed, rnd, cls, F,
                                                cfg.colsample_bytree)
            feature = np.full(N, -1, np.int32)
            threshold_bin = np.zeros(N, np.int32)
            is_leaf = np.zeros(N, bool)
            leaf_value = np.zeros(N, np.float32)
            split_gain = np.zeros(N, np.float32)
            default_left = np.zeros(N, bool)
            prev_hist = None
            for depth in range(D):
                n_level = 1 << depth
                sub = subtract and prev_hist is not None
                hist = None
                with ph("hist"):
                    for c in range(n_chunks):
                        Xc, yc = chunk_fn(c)
                        ni = _traverse_partial(
                            Xc, feature, threshold_bin, is_leaf, depth,
                            default_left, **route_kw)
                        if sub:
                            is_l = (ni >= 0) & (ni % 2 == 0)
                            ni = np.where(is_l, ni // 2, -1).astype(np.int32)
                        g, h = chunk_grads(c, Xc, yc, cls)
                        part = np.asarray(backend.build_histograms(
                            backend.upload(Xc), g, h, ni,
                            n_level // 2 if sub else n_level))
                        hist = part if hist is None else hist + part
                if sub:
                    hist = _assemble_subtracted_level(prev_hist, hist,
                                                      is_leaf, depth)
                with ph("gain"):
                    _apply_level_splits(hist, cfg, depth, feature,
                                        threshold_bin, is_leaf, leaf_value,
                                        split_gain, default_left,
                                        feature_mask=fmask)
                prev_hist = hist if subtract else None
            n_last = 1 << D
            Gl = np.zeros(n_last, np.float32)
            Hl = np.zeros(n_last, np.float32)
            with ph("leaf"):
                for c in range(n_chunks):
                    Xc, yc = chunk_fn(c)
                    ni = _traverse_partial(Xc, feature, threshold_bin,
                                           is_leaf, D, default_left,
                                           **route_kw)
                    g, h = chunk_grads(c, Xc, yc, cls)
                    act = ni >= 0
                    np.add.at(Gl, ni[act], g[act])
                    np.add.at(Hl, ni[act], h[act])
                _apply_final_leaves(Gl, Hl, cfg, is_leaf, leaf_value)
            ens.feature[t_out] = feature
            ens.threshold_bin[t_out] = threshold_bin
            ens.is_leaf[t_out] = is_leaf
            ens.leaf_value[t_out] = leaf_value
            ens.split_gain[t_out] = split_gain
            if ens.default_left is not None:
                ens.default_left[t_out] = default_left
            t_out += 1
            round_trees.append((feature, threshold_bin, is_leaf, leaf_value,
                                default_left))
        if preds is not None:
            with ph("predict"):
                _add_round(preds, (chunk_fn(c)[0] for c in range(n_chunks)),
                           round_trees, cfg)
        tele_counters.record_grad_stream(
            C * tele_counters.grad_stream_bytes(rows, D, cfg.grad_dtype))
        stop = False
        if ev is not None:
            with ph("eval"):
                _add_round(val_preds, (ev.fn(c)[0] for c in range(ev.n)),
                           round_trees, cfg)
                stop = ev.record(rnd, np.concatenate(val_preds))
        ms = 1e3 * (time.perf_counter() - t_round)
        tel.round_end(rnd, ms, ev)
        if window is not None:
            window.round_end(rnd)
        if stop:
            log.info("streaming: early stop at round %d (best %s=%.6f at "
                     "round %d)", rnd + 1, ev.metric, ev.best_score,
                     ev.best_round + 1)
            emit_early_stop(tel.run_log, rnd + 1, ev.metric,
                            ev.best_round + 1, ev.best_score)
            ens = ens.truncate((ev.best_round + 1) * C)
            drv.save_checkpoint(ens, ev.best_round + 1)
            return ens
        log.info("streaming: round %d/%d done", rnd + 1, cfg.n_trees)
        drv.save_checkpoint(ens, rnd + 1, drv.checkpoint_every)
        if (rnd + 1) % drv.checkpoint_every == 0:
            has_dir = drv.checkpoint_dir is not None
            if tel.status is not None and has_dir:
                tel.status.checkpoint_saved(rnd + 1)
            emit_train_heartbeat(
                tel.run_log, rnd=rnd, total_rounds=cfg.n_trees,
                checkpoint_round=rnd + 1 if has_dir else None,
                ms_per_round=ms)
    drv.save_checkpoint(ens, cfg.n_trees)
    return ens


def _rotate_resident(backend, chunk_fn, chunks, y_dev, pred_dev, slots,
                     val_chunks, val_y, val_pred, row_start, chunk_starts,
                     chunk_lens) -> None:
    """After backend.rotate_row_partitions: every resident block of every
    chunk (labels and weights, predictions, leaf slots, and the
    validation chunks' state) moves to the shard this rank holds now, by
    the backend's ring shift, in place; the chunk caches are dropped; a
    host-sharded source's slot -> process map rotates, so the next upload
    of a chunk reads the new shard's sub-shards; and each chunk's global
    row start follows the shard."""
    for c in range(len(pred_dev)):
        backend.reshard_labels(y_dev[c])
        backend.reshard_rows(pred_dev[c])
        if slots[c] is not None:
            backend.reshard_rows(slots[c], dim=1)
    for cache in (chunks, val_chunks):
        if cache is not None:
            cache.drop()
    if val_pred is not None:
        for c in range(len(val_pred)):
            backend.reshard_labels(val_y[c])
            backend.reshard_rows(val_pred[c])
    if getattr(chunk_fn, "host_sharded", False):
        chunk_fn.rotate_assignment()
    for c in range(len(row_start)):
        row_start[c] = backend.chunk_row_start(int(chunk_starts[c]),
                                               chunk_lens[c])


def predict_streaming(chunk_fn: ChunkFn, n_chunks: int, ens: TreeEnsemble,
                      backend=None, raw: bool = True, sink=None,
                      device: str = "cuda") -> "np.ndarray | int":
    """Out-of-core batch scoring: each binned chunk (chunk_fn(c)[0], uint8
    [r, F]; the labels are ignored) is uploaded through the pinned
    staging, scored where it lies by the backend's serving tier (K3, or
    K4 / K5 under cfg.predict_impl "lut" / "lut4"), and its scores
    copied back while the next chunk's transfer runs. Returns the
    concatenated raw margins ([R] or [R, C]; probabilities with
    raw=False), or, with `sink(c, scores)`, streams each chunk's scores
    out through it and returns the row count. The scoring backend is
    `backend`, else the f32 one of `device`; it must hold no mesh (a
    rank scores whole chunks)."""
    if n_chunks < 1:
        raise ValueError("predict_streaming needs n_chunks >= 1")
    if backend is None:
        backend = get_backend(TrainConfig(device=device))
    if backend.mesh is not None:
        raise ValueError("predict_streaming scores whole chunks: pass a "
                         "backend without a mesh")
    rows = 0
    collected: list = []
    data = backend.upload_chunk(chunk_fn(0)[0])
    for c in range(n_chunks):
        out = backend.score_device(ens, data)
        n = data.shape[0]
        if c + 1 < n_chunks:                 # the next transfer, queued
            data = backend.upload_chunk(chunk_fn(c + 1)[0])
        scores = out[:n].cpu().numpy()
        if not raw:
            scores = predict_proba_np(scores, ens.loss)
        rows += len(scores)
        if sink is None:
            collected.append(scores)
        else:
            sink(c, scores)
    if sink is not None:
        return rows
    return np.concatenate(collected)


def _leaf_slot(Xb: np.ndarray, feature, threshold_bin, is_leaf,
               max_depth: int, default_left=None, missing_bin_value=-1,
               cat_features=()) -> np.ndarray:
    """Heap slot where each row's traversal of one tree ends (host
    numpy, the reference's twin of ops/stream.route)."""
    R = Xb.shape[0]
    node = np.zeros(R, np.int64)
    for _ in range(max_depth):
        live = ~is_leaf[node]
        f = feature[node[live]]
        fv = Xb[live, f].astype(np.int64)
        right = _go_right(fv, node[live], feature, threshold_bin,
                          default_left, missing_bin_value, cat_features)
        node[live] = 2 * node[live] + 1 + right
    return node


def _rescore(ens: TreeEnsemble, n_trees_done: int, Xb, bs) -> np.ndarray:
    """The first n_trees_done trees' raw scores of binned rows (host; [R],
    or [R, C] for softmax)."""
    C = ens.n_classes if ens.loss == "softmax" else 1
    if n_trees_done == 0:
        if C > 1:
            return np.zeros((Xb.shape[0], C), np.float32)
        return np.full(Xb.shape[0], bs, np.float32)
    return ens.truncate(n_trees_done).predict_raw(
        Xb, binned=True).astype(np.float32)
