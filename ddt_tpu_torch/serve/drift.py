"""Inference-traffic drift and shadow scoring (port of
ddt_tpu/serve/drift.py: `divergence`, `DriftTracker`, `ShadowScorer`).

* `DriftTracker` accumulates per-feature bin histograms of the binned
  uint8 rows the dispatcher scored and scores the rolling window against
  the artifact's training reference (`BinMapper.ref_counts`) with PSI and
  Jensen-Shannon (base 2). The batch's rows are counted where they are:
  rows on the card by one `torch.bincount` there (data/quantizer
  `feature_bincounts` -> ops/quantize), whose [F, n_bins] int64 counts
  are then copied to the host; host rows by numpy. Both are integer
  counts, bitwise the reference's `feature_bincounts`. The window's
  PSI / JS arithmetic is the reference's numpy float64. Alerts are
  latched transitions: crossing the PSI threshold fires once and re-arms
  after recovery; the payload waits in `_pending` for a handler thread to
  write it (the dispatcher does no file I/O).

* `ShadowScorer` re-scores the champion's dispatched batches with a
  challenger on its own daemon thread, off the response path, through a
  drop-on-full queue. On the card it launches on a CUDA stream of its
  own; a batch already on the card is read there after an event recorded
  at enqueue on the dispatcher's stream, and is marked used by the
  scorer's stream (`record_stream`), so the caching allocator cannot
  hand its memory to the dispatcher while the challenger still reads it. The champion's
  responses are delivered before the enqueue and are bitwise those with
  no shadow.

The drift window is a ring of N_SLICES time slices of summed counts, so
its memory is bounded whatever the batch rate. Both trackers' locks are
leaves: nothing is called while they are held.
"""

from __future__ import annotations

import threading

import numpy as np

import torch

from ddt_tpu_torch.data.quantizer import feature_bincounts

#: rolling-window defaults (DriftTracker): a 5-minute window sliced
#: into 16 rotating buckets (~19 s resolution), scored only once it
#: holds MIN_ROWS rows (below that the estimate is noise — the state
#: surfaces None, omit-don't-lie like the SLO burn rate).
WINDOW_S = 300.0
N_SLICES = 16
MIN_ROWS = 256
#: the conventional PSI alert threshold: < 0.1 stable, 0.1-0.25
#: moderate shift, >= 0.25 significant shift (the alert).
PSI_ALERT = 0.25
#: additive smoothing applied to BOTH distributions at scoring time so
#: an empty bin on either side cannot produce log(0) — the reference
#: rides raw counts precisely so the scorer owns this choice.
EPS = 1e-6


def _smooth(counts: np.ndarray, totals: np.ndarray) -> np.ndarray:
    """Raw per-feature counts [F, B] -> smoothed probabilities."""
    b = counts.shape[1]
    return (counts + EPS) / (totals[:, None] + b * EPS)


def divergence(ref_counts: np.ndarray,
               win_counts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-feature (PSI, JS) of a window histogram against the
    reference, both [F]. PSI = sum((q-p) * ln(q/p)) over bins;
    JS = Jensen-Shannon divergence in base 2 (bounded [0, 1]). The ONE
    divergence home — the tracker, tests, and the smoke arm's offline
    recompute all call it."""
    ref_counts = np.asarray(ref_counts, np.float64)
    win_counts = np.asarray(win_counts, np.float64)
    p = _smooth(ref_counts, ref_counts.sum(axis=1))
    q = _smooth(win_counts, win_counts.sum(axis=1))
    psi = ((q - p) * np.log(q / p)).sum(axis=1)
    m = 0.5 * (p + q)
    js = 0.5 * ((p * np.log2(p / m)).sum(axis=1)
                + (q * np.log2(q / m)).sum(axis=1))
    return psi, js


class DriftTracker:
    """Rolling-window per-feature divergence of dispatched traffic
    against a training reference histogram. All methods are cheap,
    lock-scoped host math (no I/O, no device): `observe` runs on the
    dispatcher per batch; `state`/`per_feature`/`take_pending` on
    handler threads."""

    def __init__(self, ref_counts, *, window_s: float = WINDOW_S,
                 min_rows: int = MIN_ROWS, threshold: float = PSI_ALERT):
        ref = np.asarray(ref_counts, np.int64)
        if ref.ndim != 2:
            raise ValueError(
                f"ref_counts must be [n_features, n_bins], got {ref.shape}")
        self._ref = ref
        self.n_features = int(ref.shape[0])
        self.n_bins = int(ref.shape[1])
        self.window_s = float(window_s)
        self.min_rows = int(min_rows)
        self.threshold = float(threshold)
        self._lock = threading.Lock()
        # Time-sliced ring of summed counts: bounded memory no matter
        # the batch rate (module doc). _win/_win_rows are the running
        # window sums, maintained incrementally on rotate.
        self._slices = np.zeros((N_SLICES, self.n_features, self.n_bins),
                                np.int64)
        self._slice_rows = np.zeros(N_SLICES, np.int64)
        self._win = np.zeros((self.n_features, self.n_bins), np.int64)
        self._win_rows = 0
        self._t0 = None            # first-observe anchor
        self._abs_slice = 0        # absolute slice index of the cursor
        self._alerting = False
        self._alerts = 0
        self._pending: list = []   # alert payloads awaiting a handler flush

    # -- ring rotation (call with _lock held) -------------------------- #
    def _rotate_locked(self, now: float) -> None:
        if self._t0 is None:
            self._t0 = now
            return
        span = self.window_s / N_SLICES
        target = int(max(0.0, now - self._t0) / span)
        steps = target - self._abs_slice
        if steps <= 0:
            return
        if steps >= N_SLICES:
            self._slices[:] = 0
            self._slice_rows[:] = 0
            self._win[:] = 0
            self._win_rows = 0
        else:
            for s in range(self._abs_slice + 1, target + 1):
                i = s % N_SLICES
                self._win -= self._slices[i]
                self._win_rows -= int(self._slice_rows[i])
                self._slices[i] = 0
                self._slice_rows[i] = 0
        self._abs_slice = target

    def _scores_locked(self) -> "tuple | None":
        if self._win_rows < self.min_rows:
            # An unscorable window ends the alert episode: holding the
            # latch with no evidence would pair alerting=True with
            # psi_max=None in /healthz — fresh drift after a traffic
            # gap is a NEW episode (a new alert), like an SLO re-breach
            # after the fast window cools.
            self._alerting = False
            return None
        return divergence(self._ref, self._win)

    # -- dispatcher side ------------------------------------------------ #
    def observe(self, now: float, Xb) -> "dict | None":
        """Fold one dispatched uint8 batch (a host array, or a tensor
        counted on its device) into the window and score it. Returns the
        alert payload on a latched False->True transition of (max
        per-feature PSI >= threshold), else None; the same payload is
        buffered for the handler-thread event flush."""
        counts = feature_bincounts(Xb, self.n_bins)
        if isinstance(counts, torch.Tensor):
            counts = counts.cpu().numpy()
        with self._lock:
            self._rotate_locked(now)
            i = self._abs_slice % N_SLICES
            self._slices[i] += counts
            self._slice_rows[i] += len(Xb)
            self._win += counts
            self._win_rows += len(Xb)
            scores = self._scores_locked()
            if scores is None:
                return None
            psi, js = scores
            psi_max = float(psi.max())
            alerting = psi_max >= self.threshold
            alert = None
            if alerting and not self._alerting:
                self._alerts += 1
                f = int(psi.argmax())
                alert = {
                    "psi_max": round(psi_max, 4),
                    "js_max": round(float(js.max()), 4),
                    "psi_mean": round(float(psi.mean()), 4),
                    "feature": f,
                    "window_rows": int(self._win_rows),
                    "window_s": self.window_s,
                    "threshold": self.threshold,
                    "alerts": self._alerts,
                }
                self._pending.append(alert)
            self._alerting = alerting
            return alert

    # -- handler side ---------------------------------------------------- #
    def state(self, now: float) -> dict:
        """Current window scores for /healthz + /metrics. Divergence
        keys are None under min_rows (omit, don't lie)."""
        with self._lock:
            self._rotate_locked(now)
            scores = self._scores_locked()
            out = {
                "window_rows": int(self._win_rows),
                "window_s": self.window_s,
                "threshold": self.threshold,
                "alerting": self._alerting,
                "alerts": self._alerts,
                "psi_max": None, "psi_mean": None,
                "js_max": None, "feature": None,
            }
            if scores is not None:
                psi, js = scores
                out.update(
                    psi_max=round(float(psi.max()), 4),
                    psi_mean=round(float(psi.mean()), 4),
                    js_max=round(float(js.max()), 4),
                    feature=int(psi.argmax()))
            return out

    def per_feature(self, now: float) -> "list | None":
        """Per-feature attribution for GET /debug/drift: [{feature,
        psi, js, window_rows}] sorted worst-first, or None under
        min_rows."""
        with self._lock:
            self._rotate_locked(now)
            scores = self._scores_locked()
            if scores is None:
                return None
            psi, js = scores
            rows = self._win.sum(axis=1)
            out = [{"feature": f, "psi": round(float(psi[f]), 4),
                    "js": round(float(js[f]), 4),
                    "window_rows": int(rows[f])}
                   for f in range(self.n_features)]
            out.sort(key=lambda r: -r["psi"])
            return out

    def has_pending(self) -> bool:
        # Unlocked truthiness read (same idiom as SloBurnTracker): worst
        # case a flush runs one hot-path call late.
        return bool(self._pending)

    def take_pending(self) -> list:
        with self._lock:
            out, self._pending = self._pending, []
            return out


class ShadowScorer:
    """Challenger shadow scoring off the response path (module doc).
    `enqueue` is the dispatcher side: O(1), drop-on-full, never blocks.
    The scorer thread reads the challenger slot's current model
    reference: an evicted challenger skips batches (counted) rather than
    triggering a load from this thread."""

    QUEUE_CAP = 4
    MS_RING = 1024

    def __init__(self, name: str, champion: str, slot, clock):
        self.name = name              # challenger model name
        self.champion = champion
        self._slot = slot             # the challenger's FleetSlot
        self._clock = clock
        self._cv = threading.Condition()
        self._q: list = []
        self._closed = False
        self._rows = 0
        self._diff_sum = 0.0          # sum of |delta| over compared rows
        self._diff_rows = 0
        self._ms: list = []           # challenger per-batch scoring ms
        self._dropped = 0
        self._skipped = 0             # challenger not resident
        self._errors = 0
        self._stream = None           # the scorer's CUDA stream, lazily
        self._thread = threading.Thread(
            target=self._run, name=f"ddt-shadow-{name}", daemon=True)
        self._thread.start()

    # -- dispatcher side ------------------------------------------------ #
    def enqueue(self, Xb, scores) -> None:
        ready = None
        if isinstance(Xb, torch.Tensor) and Xb.is_cuda:
            # The batch was produced on the dispatcher's stream: the
            # scorer's stream waits for this point before reading it.
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(Xb.device))
        with self._cv:
            if self._closed:
                return
            if len(self._q) >= self.QUEUE_CAP:
                self._dropped += 1
                return
            self._q.append((Xb, scores, ready))
            self._cv.notify()

    def _score(self, model, Xb, ready) -> np.ndarray:
        """The challenger's scores of `Xb`. A challenger on the card
        launches on the scorer's own stream; rows already on the card are
        read there after `ready`."""
        dev = model.backend.device
        if dev.type != "cuda":
            return np.asarray(model.score_binned(Xb), np.float64)
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=dev)
        with torch.cuda.stream(self._stream):
            if ready is not None:
                self._stream.wait_event(ready)
                # The allocator must not hand Xb's memory to the
                # dispatcher's stream before this stream is done with it.
                Xb.record_stream(self._stream)
            return np.asarray(model.score_binned(Xb), np.float64)

    # -- scorer thread --------------------------------------------------- #
    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._closed:
                    self._cv.wait(timeout=1.0)
                if not self._q:
                    if self._closed:
                        return
                    continue
                Xb, champ_scores, ready = self._q.pop(0)
            model = self._slot.model
            if model is None:
                with self._cv:
                    self._skipped += 1
                continue
            t0 = self._clock()
            try:
                mine = self._score(model, Xb, ready)
            # A challenger failure never takes the scorer thread down:
            # it is an observer, not a participant.
            except Exception:
                with self._cv:
                    self._errors += 1
                continue
            ms = (self._clock() - t0) * 1e3
            champ = np.asarray(champ_scores, np.float64)
            diff = (float(np.abs(mine - champ).mean())
                    if mine.shape == champ.shape else None)
            with self._cv:
                self._rows += len(Xb)
                if diff is not None:
                    self._diff_sum += diff * len(Xb)
                    self._diff_rows += len(Xb)
                self._ms.append(ms)
                if len(self._ms) > self.MS_RING:
                    del self._ms[: len(self._ms) - self.MS_RING]

    # -- handler side ---------------------------------------------------- #
    def summary(self) -> dict:
        """Online comparison stats for /healthz, /debug/drift, and the
        serve_latency shadow extras. mean_abs_diff/ms_p50 are None until
        the challenger has actually scored something."""
        with self._cv:
            ms = sorted(self._ms)
            return {
                "model": self.name,
                "champion": self.champion,
                "rows": self._rows,
                "mean_abs_diff": (
                    round(self._diff_sum / self._diff_rows, 6)
                    if self._diff_rows else None),
                "ms_p50": (round(ms[len(ms) // 2], 3) if ms else None),
                "dropped": self._dropped,
                "skipped": self._skipped,
                "errors": self._errors,
            }

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=5.0)
