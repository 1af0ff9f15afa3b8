"""Driver: the host boosting loop over a DeviceBackend.

Port of ddt_tpu/driver.py's two loops with the reference's semantics
(driver.py:268-760 and `_fit_fused`, :815-960) and its telemetry, without
its fault plans and straggler watchdog. `fit` takes the fused block loop
(`_fit_fused`) whenever the backend has `grow_rounds` and the run is not
profiled, as the reference does, and the granular loop (`_fit_granular`)
otherwise; the tests also call the granular loop directly, as the fused
loop's yardstick.

A round grows one tree per output column (C = n_classes for softmax, else
1) from the round's gradients: tree t = rnd * C + c scores class c.

Granular, per round: gradients -> bagging mask (cfg.subsample < 1) ->
per class, grow one tree (with its colsample mask when cfg.colsample_bytree
< 1), add its per-row delta to the class's column, copy it to the host ->
with an eval set, add the round's trees to the eval margins and read the
metric (backend.eval_round).

Fused, per block of K = min(rounds left, cfg.fused_block_rounds) rounds,
cut at `checkpoint_every` boundaries and capped at the early-stopping
patience: the block's colsample masks are drawn on the host as [K, C, F];
the backend runs the K rounds on the device (on the card, replays of one
captured round, the eval step inside it) and the block's trees, losses
and eval scores come back in one fetch. Early stopping replays its rule
over the block's scores: training past the stop changes no earlier tree,
so truncating gives the granular loop's model.

Early stopping: after each round the metric is compared with the best so
far (GREATER_IS_BETTER gives the direction); once it has not improved for
`early_stopping_rounds` rounds the ensemble is truncated to (best_round +
1) * C trees. A metric that has been NaN since round 1 raises.

Checkpoints (utils/checkpoint): every `checkpoint_every` rounds and at the
end. A resumed fit rebuilds pred (and the eval margins) from the saved
trees in the fit loop's own f32 order (TreeEnsemble.predict_raw_roundwise),
so the rounds after it grow the trees an uninterrupted run grows.

The bagging and colsample masks are pure functions of (cfg.seed, round,
class) (ops/sampling); the bagging mask is drawn on the gradients' device
by the hash's tensor twin, bit for bit the reference's row_keep_np, so no
per-round mask crosses the bus. Instance weights ride LabelHandle.valid;
eval metrics stay unweighted, as in the reference.

History and telemetry. Round records ({round, train_loss, ms_per_round
[, valid_<metric>]}) are made by telemetry.events.RoundRecorder: one
joins `history` on every `log_every`-th round, on the last round and on
every round with an eval score, with the train loss on the cadence
rounds only (None elsewhere), on both loops and at any logging level.
With a `run_log` (a JSONL path, which the Driver owns and closes, or a
RunLog): a run manifest, a round event every round, a heartbeat at the
checkpoint cadence, a `checkpoint_resume` fault on a resume, the early
stop, and at the end the cost events of the kernels' dispatchers
(telemetry/costmodel), the phase timings, the counters and run_end. A
run log alone keeps the fused loop: its phases are `grow_block` and
`fetch_tree`, timed by CUDA events read once at the end, and the block's
fetch stays its only sync. `profile=True` runs the granular loop, whose
phases are grad, grow, apply_delta, fetch_tree and eval, with the ops'
`hist` and `gain` nested in `grow` (utils/profiling), and logs the table
at INFO. `profiler_window` (telemetry/profiler.CaptureWindow) captures a
torch.profiler trace of a round range; `status` (telemetry/statusd.
TrainStatus) is updated at every round boundary. With none of the four,
each hook is an `is not None` test. On a mesh each host's first rank
(row 0, feature shard 0) writes the run log, its manifest naming the
host; the other ranks write none.

The mesh (cfg.world_size = host_partitions x n_partitions x
feature_partitions ranks, one process a rank): every rank calls fit with
the same full labels (and rows, or its RowBlock from api.train); the
mesh's ranks must be the process group's. The base score is computed on
the host from the full labels, identical on every rank; the backend
keeps the rank's block of rows and labels (and column slab) and reduces
the histograms and the loss over its row group; an eval set is scored
whole on every rank (the trees are the same everywhere, so the metric is
too, with no collective); the bagging draws start at the rank's global
row.

Checkpoints on a mesh: every rank holds the same ensemble, so global rank
0 alone writes, and an all-reduce over the world follows every save
point (a barrier that also carries rank 0's failure to every rank): no
rank reads or goes on before the pair has landed. A resume reads the
directory on every rank (it must be shared between hosts), then the
ranks all-gather the resumed round and a digest of the resumed trees and
raise if any differs. The layout is not part of the checkpoint's
fingerprint: a run resumes on another mesh or on one device. pred is
rebuilt from the rank's row block at full width (a RowBlock holds it
before the column cut), so it is the uninterrupted run's bit for bit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import logging
import time

import numpy as np
import torch

from ddt_tpu_torch.backends.base import (PACKED_FIELDS, DeviceBackend,
                                         unpack_tree)
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.models.tree import TreeEnsemble, empty_ensemble
from ddt_tpu_torch.ops import sampling
from ddt_tpu_torch.ops.grad import base_score_np
from ddt_tpu_torch.parallel import comms, mesh
from ddt_tpu_torch.telemetry import annotations, costmodel
from ddt_tpu_torch.telemetry import counters as tele_counters
from ddt_tpu_torch.telemetry.events import (
    RoundRecorder, RunLog, comms_manifest_fields, derive_run_id,
    emit_early_stop, emit_train_heartbeat, finish_run_log)
from ddt_tpu_torch.utils import checkpoint
from ddt_tpu_torch.utils.metrics import GREATER_IS_BETTER, default_metric
from ddt_tpu_torch.utils.profiling import PhaseTimer

log = logging.getLogger("ddt_tpu_torch.driver")


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class _Stop:
    """The early-stopping rule over per-round scores."""

    def __init__(self, metric: str, patience: int | None):
        self.metric = metric
        self.sign = 1.0 if GREATER_IS_BETTER[metric] else -1.0
        self.patience = patience
        self.best = -np.inf
        self.best_round: int | None = None
        self.best_score: float | None = None

    def update(self, rnd: int, score: float) -> bool:
        """Record round `rnd`'s score; True when training should stop."""
        if self.sign * score > self.best:
            self.best = self.sign * score
            self.best_round = rnd
            self.best_score = score
        if self.patience is None:
            return False
        if self.best_round is None:
            # NaN never compares greater: name the cause.
            raise ValueError(
                f"validation {self.metric} has been NaN since round 1 "
                "(degenerate eval_set, e.g. constant scores or a "
                "single-class slice); cannot early-stop on it")
        if rnd - self.best_round >= self.patience:
            log.info("early stop at round %d (best %s=%.6f at round %d)",
                     rnd + 1, self.metric, self.best_score,
                     self.best_round + 1)
            return True
        return False


class Driver:
    """Boosting loop: `fit(Xb, y, ...)` -> TreeEnsemble."""

    def __init__(self, backend: DeviceBackend, cfg: TrainConfig,
                 log_every: int = 10,
                 checkpoint_dir: str | None = None,
                 checkpoint_every: int = 25, profile: bool = False,
                 run_log: "RunLog | str | None" = None,
                 profiler_window=None, status=None):
        if checkpoint_dir is not None and checkpoint_every < 1:
            raise ValueError(
                f"checkpoint_every must be >= 1, got {checkpoint_every}")
        if log_every < 1:
            raise ValueError(f"log_every must be >= 1, got {log_every}")
        self.backend = backend
        self.cfg = cfg
        self.log_every = log_every
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        #: Round records ({round, train_loss, ms_per_round
        #: [, valid_<metric>]}, telemetry.events.RoundRecorder).
        self.history: list[dict] = []
        self.best_round: int | None = None
        self.best_score: float | None = None
        self.profile = profile
        # A path means the Driver owns the log (opens and closes it); a
        # RunLog stays the caller's to close.
        self._own_run_log = isinstance(run_log, str)
        self.run_log = RunLog.coerce(run_log)
        self.timer: PhaseTimer | None = None
        self._recorder = RoundRecorder(self.history, None, log_every,
                                       cfg.n_trees, None, log)
        self._cost = None
        self._window = profiler_window
        self._status = status
        #: The run's id (telemetry.events.derive_run_id) when a run log,
        #: window or status asked for one; api.train stamps it into the
        #: saved model's manifest.
        self.run_id: str | None = None

    def fit(self, Xb, y: np.ndarray, eval_set=None,
            eval_metric: str | None = None,
            early_stopping_rounds: int | None = None,
            sample_weight: np.ndarray | None = None) -> TreeEnsemble:
        """Train on binned uint8 rows [R, F]: a host array, or a tensor
        (binned on the device by api.train, say), which the backend takes
        where it lies. `eval_set` = (binned rows, labels) is scored every
        round with `eval_metric` (default: the loss's), unweighted;
        `sample_weight` (float [R], >= 0, not all zero) weights each row's
        g, h and loss, and the base score. A Driver-owned run log is
        closed, the cost capture removed and a capture window stopped on
        every exit, a raise included."""
        try:
            return self._fit(Xb, y, eval_set, eval_metric,
                             early_stopping_rounds, sample_weight)
        finally:
            costmodel.deactivate(self._cost)
            if self._window is not None:
                self._window.close()
            if self._own_run_log and self.run_log is not None:
                self.run_log.close()

    def _writes_log(self) -> bool:
        """Off a mesh, or this host's first rank (row 0, feature 0)."""
        m = self.backend.mesh
        return m is None or (m.row == 0 and m.feature == 0)

    def _prologue(self, R: int, F: int) -> dict | None:
        """Telemetry prologue: the run id, the window's and the status's
        binding, and with a run log the counters' start, the cost capture
        and the manifest. Returns the counters' start snapshot (None
        without a run log). No device sync."""
        cfg = self.cfg
        if self.run_log is not None and not self._writes_log():
            self.run_log = None
        if self.run_log is not None or self._window is not None \
                or self._status is not None:
            self.run_id = derive_run_id(
                trainer="driver", rows=int(R), features=int(F),
                **dataclasses.asdict(cfg))
        if self._window is not None:
            self._window.bind(self.run_id)
        if self._status is not None:
            self._status.begin_run(run_id=self.run_id,
                                   total_rounds=cfg.n_trees, rows=int(R))
        if self.profile or self.run_log is not None:
            self.timer = PhaseTimer(self.backend.device)
        self._recorder.run_log = self.run_log
        if self.run_log is None:
            return None
        self.run_log.run_id = self.run_id
        start = tele_counters.snapshot()
        tele_counters.reset_device_peak()
        self._cost = costmodel.activate()
        m = self.backend.mesh
        self.run_log.emit(
            "run_manifest", trainer="driver", backend=self.backend.name,
            loss=cfg.loss, n_trees=cfg.n_trees, max_depth=cfg.max_depth,
            n_bins=cfg.n_bins, rows=int(R), features=int(F),
            n_classes=cfg.n_outputs, seed=cfg.seed,
            distributed=m is not None, run_id=self.run_id,
            host=0 if m is None else int(m.host),
            **comms_manifest_fields(self.backend),
            **(self._window.manifest_fields()
               if self._window is not None else {}))
        return start

    def _fit(self, Xb, y, eval_set, eval_metric, early_stopping_rounds,
             sample_weight) -> TreeEnsemble:
        cfg = self.cfg
        t_fit0 = time.perf_counter()
        mesh.check_partitions(cfg)
        Xb = self._check_rows(Xb)
        y = np.asarray(y)
        # Every column: a RowBlock is the rank's block before the column
        # cut.
        rows = Xb.rows if isinstance(Xb, mesh.RowBlock) else Xb
        R = Xb.n_rows if isinstance(Xb, mesh.RowBlock) else Xb.shape[0]
        F = rows.shape[1]
        C = cfg.n_outputs
        if y.shape != (R,):
            raise ValueError(f"y must be [R]={R}, got {y.shape}")
        if cfg.cat_features and cfg.cat_features[-1] >= F:
            raise ValueError(f"cat_features index {cfg.cat_features[-1]} "
                             f"out of range for {F} features")
        counters_start = self._prologue(R, F)
        y_dev = self.backend.upload_labels(y, sample_weight=sample_weight)
        bs = base_score_np(y, cfg.loss, sample_weight=sample_weight)
        data = self.backend.upload(Xb)
        pred = self.backend.init_pred(y_dev, bs)
        ens = empty_ensemble(
            cfg.n_trees * C, cfg.max_depth, F, cfg.learning_rate, bs,
            cfg.loss, cfg.n_classes,
            missing_bin=cfg.missing_policy == "learn", n_bins=cfg.n_bins,
            cat_features=cfg.cat_features)

        start = 0
        if self.checkpoint_dir is not None:
            start = checkpoint.try_resume(self.checkpoint_dir, ens, cfg)
            if self.backend.mesh is not None:
                self.check_resume_agrees(ens, start)
            if start > 0:
                pred = self.backend.load_pred(
                    ens.truncate(start * C).predict_raw_roundwise(
                        self._local_rows(Xb), binned=True))
                log.info("resumed from checkpoint at round %d", start)
                if self.run_log is not None:
                    self.run_log.emit("fault", kind="checkpoint_resume",
                                      round=start)

        ev = None
        if eval_set is not None:
            ev = self._eval_state(eval_set, eval_metric,
                                  early_stopping_rounds, ens, start, bs)
        elif early_stopping_rounds is not None:
            raise ValueError("early_stopping_rounds requires an eval_set")
        if getattr(self.backend, "grow_rounds", None) is not None \
                and not self.profile:
            ens = self._fit_fused(data, y_dev, pred, ens, start, ev)
        else:
            with annotations.sub_phases(self.timer) if self.profile \
                    else contextlib.nullcontext():
                ens = self._fit_granular(data, y_dev, pred, ens, start, ev)
        self._finish_run(t_fit0, ens.n_trees // C, counters_start)
        return ens

    def _finish_run(self, t0: float, completed: int,
                    counters_start) -> None:
        """Telemetry epilogue: the phase table at INFO (profiled runs),
        the status's last phase, and the run log's epilogue."""
        if self.profile and self.timer is not None:
            self.timer.log_report(log)
        if self._status is not None:
            self._status.set_phase("done")
        finish_run_log(self.run_log, self.timer, counters_start, completed,
                       round(time.perf_counter() - t0, 4), costs=self._cost)

    @staticmethod
    def _check_rows(Xb):
        if isinstance(Xb, mesh.RowBlock):
            Driver._check_rows(Xb.rows)
            return Xb
        if not isinstance(Xb, torch.Tensor):
            Xb = np.asarray(Xb)
        if Xb.dtype not in (np.uint8, torch.uint8) or Xb.ndim != 2:
            raise TypeError(f"Xb must be uint8 binned data [R, F], got "
                            f"{Xb.dtype} {tuple(Xb.shape)}")
        return Xb

    def _local_rows(self, Xb) -> np.ndarray:
        """The rows this rank's pred covers, at full width, on the host:
        its padded row block on a mesh (a RowBlock's rows), all rows
        without one."""
        if isinstance(Xb, mesh.RowBlock):
            return _host(Xb.rows)
        rows = _host(Xb)
        be = self.backend
        if be.mesh is None:
            return rows
        start, stop, local = mesh.row_block(rows.shape[0], be.world,
                                            be.rank)
        out = np.zeros((local,) + rows.shape[1:], rows.dtype)
        out[:stop - start] = rows[start:stop]
        return out

    def check_resume_agrees(self, ens: TreeEnsemble, start: int) -> None:
        """All-gather the resumed round and a digest of the resumed trees
        over the world; raise on every rank if any rank's differ."""
        h = hashlib.blake2b(digest_size=8)
        k = start * self.cfg.n_outputs
        for name in PACKED_FIELDS:
            h.update(np.ascontiguousarray(getattr(ens, name)[:k]).tobytes())
        mine = torch.tensor(
            [start, int.from_bytes(h.digest(), "little", signed=True)],
            dtype=torch.int64, device=self.backend.device)
        every = comms.all_gather(mine, self.backend.mesh.world_group)
        if not bool((every == mine).all()):
            raise RuntimeError(
                "the ranks resumed different checkpoints (round, digest "
                f"per rank: {every.tolist()}): every rank must read the "
                "same checkpoint_dir")

    def save_checkpoint(self, ens: TreeEnsemble, rounds: int,
              every: int | None = None) -> None:
        """checkpoint.maybe_save; on a mesh the save by global rank 0
        alone, then an all-reduce over the world that every rank waits
        for, which carries rank 0's failure to all of them."""
        be = self.backend
        if be.mesh is None:
            checkpoint.maybe_save(self.checkpoint_dir, ens, self.cfg,
                                  rounds, every)
            return
        if self.checkpoint_dir is None or (every is not None
                                           and rounds % every != 0):
            return
        world = be.mesh.world_group
        err = None
        if comms.rank(world) == 0:
            try:
                checkpoint.save_checkpoint(self.checkpoint_dir, ens,
                                           self.cfg, rounds)
            except OSError as e:
                err = e
        failed = comms.psum(torch.tensor(
            [0 if err is None else 1], dtype=torch.int32,
            device=be.device), world)
        if err is not None:
            raise err
        if int(failed[0]):
            raise RuntimeError(f"rank 0 failed to write the checkpoint of "
                               f"round {rounds} to {self.checkpoint_dir}")

    def _eval_state(self, eval_set, eval_metric, patience, ens, start, bs):
        """(eval rows, margins and labels on the device, the stop rule)."""
        cfg = self.cfg
        C = cfg.n_outputs
        Xv, yv = eval_set
        Xv = self._check_rows(Xv)
        metric = eval_metric or default_metric(cfg.loss)
        if metric not in GREATER_IS_BETTER:
            raise ValueError(f"unknown metric {metric!r}; have "
                             f"{sorted(GREATER_IS_BETTER)}")
        if metric == "auc" and C > 1:
            raise ValueError("auc is a binary metric; softmax eval_set "
                             "supports logloss or accuracy")
        shape = (Xv.shape[0], C) if C > 1 else (Xv.shape[0],)
        raw = np.full(shape, bs, np.float32)
        if start > 0:
            raw = ens.truncate(start * C).predict_raw_roundwise(
                _host(Xv), binned=True).astype(np.float32)
        return (self.backend.upload(Xv, shard=False),
                self.backend.load_pred(raw),
                self.backend.upload_labels(np.asarray(yv), shard=False),
                _Stop(metric, patience))

    def _store(self, ens: TreeEnsemble, slot: int, tree) -> None:
        for k in PACKED_FIELDS:
            getattr(ens, k)[slot] = tree[k]

    def _round_end(self, r: int, ms: float, score, loss_fn) -> None:
        """One finished round: its record (history, run log), the round
        counter and the status's window."""
        self._recorder.record(r, ms, score, loss_fn)
        tele_counters.record_train_round()
        if self._status is not None:
            last = self.history[-1] if self.history else None
            self._status.round_end(
                r, ms, last if last is not None and last["round"] == r + 1
                else RoundRecorder.make_record(r, ms, None))

    def _count_rounds(self, R: int, F: int, n: int) -> None:
        """The per-round modeled counters of n rounds: the histogram
        collectives' payload on a mesh, the g/h stream, the quantized
        rounds."""
        cfg = self.cfg
        C = cfg.n_outputs
        if self.backend.mesh is not None:
            tele_counters.record_collective(
                n * C * self.backend.collective_bytes_per_tree(F))
        tele_counters.record_grad_stream(
            n * C * tele_counters.grad_stream_bytes(R, cfg.max_depth,
                                                    cfg.grad_dtype))
        if cfg.grad_dtype != "f32":
            tele_counters.record_grad_quant_round(n)

    def _finish(self, ens: TreeEnsemble, stop, rounds: int) -> TreeEnsemble:
        """Keep the stop rule's best round, and save the final
        checkpoint."""
        if stop is not None:
            self.best_round, self.best_score = stop.best_round, \
                stop.best_score
        self.save_checkpoint(ens, rounds)
        return ens

    def _early_stop(self, ens: TreeEnsemble, stop, rnd: int) -> TreeEnsemble:
        emit_early_stop(self.run_log, rnd + 1, stop.metric,
                        stop.best_round + 1, stop.best_score)
        ens = ens.truncate((stop.best_round + 1) * self.cfg.n_outputs)
        return self._finish(ens, stop, stop.best_round + 1)

    def _heartbeat(self, rnd: int, K: int, ms: float, checkpoint_round,
                   rows_per_s=None) -> None:
        """A heartbeat when rounds (rnd - K, rnd] crossed a multiple of
        checkpoint_every (rnd is the 1-based count done), at the
        checkpoint cadence with or without a directory. No-op without a
        run log."""
        every = self.checkpoint_every
        if self.run_log is None or rnd // every <= (rnd - K) // every:
            return
        emit_train_heartbeat(
            self.run_log, rnd=rnd - 1, total_rounds=self.cfg.n_trees,
            checkpoint_round=checkpoint_round, ms_per_round=ms,
            rows_per_s=rows_per_s)

    def _saved(self, rnd: int) -> None:
        """Tell the status a checkpoint of `rnd` rounds was written."""
        if self._status is not None and self.checkpoint_dir is not None \
                and rnd % self.checkpoint_every == 0:
            self._status.checkpoint_saved(rnd)

    def _fit_granular(self, data, y_dev, pred, ens: TreeEnsemble,
                      start: int = 0, ev=None) -> TreeEnsemble:
        cfg = self.cfg
        R, F = data.shape[0], self.backend.n_features(data)
        C = cfg.n_outputs
        ph = annotations.phase_ctx(self.timer)
        window = self._window
        stop = None
        if ev is not None:
            val_data, val_pred, val_y, stop = ev
            self._recorder.metric_name = stop.metric
        for rnd in range(start, cfg.n_trees):
            if window is not None:
                window.round_start(rnd)
            t0 = time.perf_counter()
            with ph("grad"):
                g, h = self.backend.grad_hess(pred, y_dev)
            if cfg.subsample < 1.0:
                keep = sampling.row_keep(cfg.seed, rnd,
                                         self.backend.row_start(R), R,
                                         cfg.subsample, device=g.device)
                g, h = self.backend.apply_row_mask(g, h, keep)
            handles = []
            for c in range(C):
                fmask = (sampling.colsample_mask(cfg.seed, rnd, c, F,
                                                 cfg.colsample_bytree)
                         if cfg.colsample_bytree < 1.0 else None)
                with ph("grow"):
                    handle, delta = self.backend.grow_tree(
                        data, g[:, c] if C > 1 else g,
                        h[:, c] if C > 1 else h,
                        feature_mask=fmask, tree_id=rnd * C + c)
                with ph("apply_delta"):
                    pred = self.backend.apply_delta(pred, delta, c)
                with ph("fetch_tree"):
                    tree = self.backend.fetch_tree(handle)
                self._store(ens, rnd * C + c, tree)
                handles.append(handle)
            score = None
            if stop is not None:
                with ph("eval"):
                    val_pred, sc = self.backend.eval_round(
                        val_data, val_pred, handles, val_y, stop.metric)
                    score = float(sc)
            ms = 1e3 * (time.perf_counter() - t0)
            self._count_rounds(R, F, 1)
            self._round_end(rnd, ms, score,
                            lambda: self.backend.loss_value(pred, y_dev))
            if window is not None:
                window.round_end(rnd)
            if stop is not None and stop.update(rnd, score):
                return self._early_stop(ens, stop, rnd)
            if self.checkpoint_dir is not None:
                self.save_checkpoint(ens, rnd + 1, self.checkpoint_every)
                self._saved(rnd + 1)
            self._heartbeat(
                rnd + 1, 1, ms,
                rnd + 1 if self.checkpoint_dir is not None else None,
                rows_per_s=R / (ms / 1e3) if ms > 0 else None)
        return self._finish(ens, stop, cfg.n_trees)

    def _fit_fused(self, data, y_dev, pred, ens: TreeEnsemble,
                   start: int = 0, ev=None) -> TreeEnsemble:
        """Block loop over backend.grow_rounds / grow_rounds_masked /
        grow_rounds_eval: K rounds a call, one fetch of their trees,
        losses and eval scores."""
        cfg = self.cfg
        R, F = data.shape[0], self.backend.n_features(data)
        C = cfg.n_outputs
        ph = annotations.phase_ctx(self.timer)
        window = self._window
        stop = None
        if ev is not None:
            val_data, val_pred, val_y, stop = ev
            self._recorder.metric_name = stop.metric
        rnd = start
        while rnd < cfg.n_trees:
            K = min(cfg.n_trees - rnd, cfg.fused_block_rounds)
            if self.checkpoint_dir is not None:
                nxt = (rnd // self.checkpoint_every + 1) \
                    * self.checkpoint_every
                K = min(K, nxt - rnd)
            if stop is not None and stop.patience is not None:
                K = min(K, max(stop.patience, 1))
            if window is not None:
                # Blocks break at the window's edges, so its capture
                # starts and ends on round boundaries.
                K = window.block_cap(rnd, K)
                window.round_start(rnd)
            t0 = time.perf_counter()
            fmasks = None
            if cfg.colsample_bytree < 1.0:
                fmasks = np.stack([
                    [sampling.colsample_mask(cfg.seed, rnd + k, c, F,
                                             cfg.colsample_bytree)
                     for c in range(C)] for k in range(K)])
            scores = None
            with ph("grow_block"):
                if stop is not None:
                    trees_h, pred, losses_h, val_pred, scores_h = \
                        self.backend.grow_rounds_eval(
                            data, pred, y_dev, K, val_data, val_pred,
                            val_y, stop.metric, first_round=rnd,
                            fmasks=fmasks)
                elif fmasks is not None:
                    trees_h, pred, losses_h = \
                        self.backend.grow_rounds_masked(
                            data, pred, y_dev, K, fmasks, first_round=rnd)
                else:
                    trees_h, pred, losses_h = self.backend.grow_rounds(
                        data, pred, y_dev, K, first_round=rnd)
            with ph("fetch_tree"):
                if stop is not None:
                    trees, losses, scores = self.backend.fetch_rounds(
                        trees_h, losses_h, scores_h)
                else:
                    trees, losses = self.backend.fetch_rounds(trees_h,
                                                              losses_h)
            ms = 1e3 * (time.perf_counter() - t0) / K
            if window is not None:
                # The fetch was the block's sync: the capture holds every
                # launch of rounds [rnd, rnd + K).
                window.round_end(rnd + K - 1)
            tele_counters.record_d2h(trees.nbytes + losses.nbytes)
            self._count_rounds(R, F, K)
            trees = trees.reshape(K, C, len(PACKED_FIELDS), -1)
            for k in range(K):
                r = rnd + k
                for c in range(C):
                    self._store(ens, r * C + c, unpack_tree(trees[k, c]))
                score = None if scores is None else float(scores[k])
                self._round_end(r, ms, score,
                                lambda k=k: float(losses[k]))
                if stop is not None and stop.update(r, score):
                    return self._early_stop(ens, stop, r)
            rnd += K
            if rnd < cfg.n_trees:
                self.save_checkpoint(ens, rnd, self.checkpoint_every)
                self._saved(rnd)
            self._heartbeat(
                rnd, K, ms,
                rnd if self.checkpoint_dir is not None
                and rnd < cfg.n_trees and rnd % self.checkpoint_every == 0
                else None)
        return self._finish(ens, stop, cfg.n_trees)
