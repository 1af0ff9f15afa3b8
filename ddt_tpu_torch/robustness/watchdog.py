"""Straggler watchdog: act on the partition recorder's lanes (port of
ddt_tpu/robustness/watchdog.py, copied).

The partition recorder (telemetry/events.PartitionRecorder) makes
stragglers visible (per-round `partition_phases` events, the end-of-run
`partition_skew` reduction); the watchdog consumes the same per-round
lanes and DECIDES: when one rank's per-round phase total exceeds the
median of the OTHER lanes by `threshold` for `patience` consecutive
observed rounds, it flags a repartition request. The Driver acts on it
at the next checkpoint boundary (behind `cfg.straggler_repartition`) by
ROTATING the row shards around the row group (CUDADevice.
rotate_row_partitions): the shards' contents are untouched, so the
trained model is unchanged; only which rank (and card) holds which
shard moves, which is the right response to a slow or throttled card
and a no-op for pure data skew.

Signal source: the watchdog observes only where the recorder is active
(a mesh run WITH a run log): the lanes cost one gather a round, which
the disabled path never pays. Detection (fault events
`straggler_detected`) is always on where the recorder is; the ACTION is
behind the config flag.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class StragglerObservation:
    round: int          # 1-based, like every run-log record
    device: int
    skew: float         # max/median of per-device round totals
    streak: int


class StragglerWatchdog:
    """Per-round skew tracker. Feed `observe_round` the recorder's
    flushed {device: {phase: ms}} dict; a non-None return is a
    detection (emit it as a fault event). `pending_repartition` latches
    once the same device straggles `patience` rounds in a row; the
    trainer calls `repartition_done()` after acting."""

    def __init__(self, threshold: float = 2.0, patience: int = 2):
        if threshold <= 1.0:
            raise ValueError(f"threshold must be > 1.0, got {threshold}")
        if patience < 1:
            raise ValueError(f"patience must be >= 1, got {patience}")
        self.threshold = threshold
        self.patience = patience
        self._streak = 0
        self._worst: int | None = None
        self.pending_repartition = False
        self.detections: list[StragglerObservation] = []

    def observe_round(self, rnd: int,
                      parts: "dict | None") -> StragglerObservation | None:
        """`rnd` is 0-based (the trainer's loop index); `parts` maps
        device id -> {phase: ms} for one round (or fused block). Returns
        the detection record when the skew threshold trips, else None.
        An empty/absent observation neither extends nor resets the
        streak (no signal is not evidence of balance).

        Skew = slowest lane / median of the OTHER lanes — deliberately
        not partition_skew_summary's max/median-of-all: a median that
        includes the straggler dilutes the signal, and on a 2-lane mesh
        bounds max/median-of-all below 2.0, which would make the default
        threshold unreachable exactly where small meshes need it."""
        if not parts or len(parts) < 2:
            return None
        totals = {dev: sum(ph.values()) for dev, ph in parts.items()}
        worst = max(sorted(totals), key=lambda d: totals[d])
        rest = sorted(v for d, v in totals.items() if d != worst)
        n = len(rest)
        median = rest[n // 2] if n % 2 else (
            rest[n // 2 - 1] + rest[n // 2]) / 2.0
        if median <= 0:
            return None
        skew = totals[worst] / median
        if skew < self.threshold:
            self._streak = 0
            self._worst = None
            return None
        self._streak = self._streak + 1 if worst == self._worst else 1
        self._worst = worst
        obs = StragglerObservation(round=rnd + 1, device=int(worst),
                                   skew=round(skew, 3),
                                   streak=self._streak)
        self.detections.append(obs)
        if self._streak >= self.patience:
            self.pending_repartition = True
        return obs

    def repartition_done(self) -> None:
        self._streak = 0
        self._worst = None
        self.pending_repartition = False


def feed_watchdog(watchdog: "StragglerWatchdog | None", run_log,
                  rnd: int, parts: "dict | None", logger,
                  prefix: str = "") -> "StragglerObservation | None":
    """One round's flushed partition lanes -> watchdog; a detection
    surfaces as a warning on `logger` plus a `straggler_detected` fault
    event in `run_log`. THE shared feed for the Driver's granular and
    fused loops and the streaming device loop (one home, so the event
    fields cannot drift between trainers). Two attribute checks when
    either side is absent."""
    if watchdog is None or parts is None:
        return None
    obs = watchdog.observe_round(rnd, parts)
    if obs is None:
        return None
    logger.warning(
        "%sstraggler detected: device %d at %.2fx the other lanes' "
        "median (round %d, streak %d)", prefix, obs.device, obs.skew,
        obs.round, obs.streak)
    if run_log is not None:
        run_log.emit("fault", kind="straggler_detected", round=obs.round,
                     device=obs.device, skew=obs.skew, streak=obs.streak)
    return obs
