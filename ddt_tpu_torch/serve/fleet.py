"""FleetEngine: N models served by one process on one card (port of
ddt_tpu/serve/fleet.py: `FleetEngine`, `FleetSlot`, `SloBurnTracker`,
`UnknownModelError`, `ModelUnavailableError`).

- Per-model admission queues: every model has its own `MicroBatcher` in
  driven mode (no thread of its own; all share the fleet's one
  Condition), so per-model coalescing, the pinned admission deadline and
  the express lane carry over from the single-model engine.
- One dispatcher thread runs weighted deficit round robin over the
  queues: each cycle a model with backlog earns `weight x max_batch`
  rows of credit and dispatches micro-batches until it runs out. The
  model reference of a batch is read once, at admission.
- LRU eviction under `max_resident`: publishing model N+1 demotes the
  least recently used idle model by dropping its reference. Each
  ServableModel owns its operands on the card (serve/engine.py), so the
  drop frees them once no dispatch in flight holds the model. The next
  request for an evicted model reloads it on the caller's thread (a
  registry restore and a warm-up, never on the dispatcher), then queues.
- A control plane: `add_model` / `remove_model` / `retag` without
  restart, per-model `serve_latency` windows, the `fleet_evictions` /
  `fleet_reloads` counters and `fault` events (fleet_eviction /
  fleet_reload / fleet_remove), SLO burn tracking, and the drift / shadow
  observers (serve/drift.py).

No file I/O here: loading is the injected `loader` callable's job
(serve/control.py builds it over the registry), invoked only on caller
threads with no fleet lock held; events the dispatcher settles wait for
a handler thread to write them.
"""

from __future__ import annotations

import collections
import threading
import time

from ddt_tpu_torch.serve import drift as serve_drift
from ddt_tpu_torch.serve.batcher import (MicroBatcher, PendingRequest,
                                         ShuttingDown)
from ddt_tpu_torch.serve.engine import (ServeStats, coerce_rows,
                                        dispatch_batch)
from ddt_tpu_torch.telemetry import counters as tele_counters
from ddt_tpu_torch.telemetry.events import RunLog


class UnknownModelError(KeyError):
    """Request routed to a model name the fleet does not serve — the
    HTTP layer renders this as a structured 404 (never a bare 500)."""

    def __init__(self, name, known=()):
        self.name = name
        self.known = sorted(known)
        super().__init__(name)

    def __str__(self):
        return (f"no model named {self.name!r} in the fleet "
                f"(serving: {', '.join(self.known) or 'none'})")


class ModelUnavailableError(RuntimeError):
    """The model exists but cannot serve right now (evicted and its
    reload failed, or the residency race could not settle) — the HTTP
    layer renders this as a structured 503."""

    def __init__(self, name, reason):
        self.name = name
        self.reason = reason
        super().__init__(f"model {name!r} is unavailable: {reason}")


class _EvictedInFlight(RuntimeError):
    """Internal: an express dispatch found its slot evicted between the
    residency check and the gate (a tiny race window) — the submit path
    catches this, reloads, and requeues, so the CLIENT never sees it."""


class SloBurnTracker:
    """Rolling multi-window burn-rate tracking for ONE fleet member's
    latency SLO. The objective is a per-request latency bound
    (FleetSpec.slo_p99_ms) with the p99's implied 1% violation
    allowance; the burn rate over a window is

        burn = (violating requests / window requests) / ALLOWANCE

    so burn 1.0 spends the error budget exactly, burn 2.0 spends it
    twice as fast (the SRE burn-rate convention, degenerated to
    request-count windows over the live latency stream). A breach is a
    LATCHED transition: it fires when every window with at least
    MIN_REQUESTS samples burns at or past BREACH_BURN — the multi-window
    AND is what keeps one slow cold-load from paging — and re-arms only
    after the fast window cools below 1.0, so a continuously burning
    model is ONE `slo_breach` event, not one per batch.

    Thread model: its OWN leaf lock, never held while any fleet lock is
    taken (dispatcher closures and handler threads both call in; the
    fleet may read `burn_rates()` while holding its Condition because
    the nesting is always fleet-lock -> tracker-lock, never reversed).
    Breach payloads are buffered here (`_pending`) and swept by
    handler-thread touchpoints — the dispatcher never does file I/O."""

    #: rolling windows, seconds — fast page-worthy window first.
    WINDOWS_S = (30.0, 300.0)
    #: the p99's violation allowance (1 - 0.99).
    ALLOWANCE = 0.01
    #: burn rate at/past which every qualifying window must sit to latch.
    BREACH_BURN = 2.0
    #: minimum requests in a window before its burn rate is trusted.
    MIN_REQUESTS = 20

    def __init__(self, objective_ms):
        self.objective_ms = float(objective_ms)
        self._lock = threading.Lock()
        self._batches = collections.deque()   # (t, n, n_violating)
        self._latched = False
        self._pending: list = []
        self.breaches = 0

    def _prune_locked(self, now) -> None:
        horizon = now - self.WINDOWS_S[-1]
        while self._batches and self._batches[0][0] < horizon:
            self._batches.popleft()

    def _window_stats_locked(self, now) -> dict:
        out = {}
        for w in self.WINDOWS_S:
            cutoff = now - w
            n = bad = 0
            for t, k, b in self._batches:
                if t >= cutoff:
                    n += k
                    bad += b
            out[w] = (n, bad)
        return out

    def _rate(self, n, bad):
        if n < self.MIN_REQUESTS:
            return None
        return (bad / n) / self.ALLOWANCE

    def record(self, now, latencies_ms) -> "dict | None":
        """Fold one dispatched batch in; on the transition INTO breach,
        buffer the event payload and return it (the caller bumps the
        process counter — a plain int add, safe on any thread)."""
        bad = sum(1 for v in latencies_ms if v > self.objective_ms)
        with self._lock:
            self._batches.append((now, len(latencies_ms), bad))
            self._prune_locked(now)
            stats = self._window_stats_locked(now)
            rates = {w: self._rate(n, b) for w, (n, b) in stats.items()}
            fast = rates[self.WINDOWS_S[0]]
            if self._latched:
                if fast is not None and fast < 1.0:
                    self._latched = False
                return None
            if any(r is None or r < self.BREACH_BURN
                   for r in rates.values()):
                return None
            self._latched = True
            self.breaches += 1
            n_fast = stats[self.WINDOWS_S[0]][0]
            breach = {"burn_rate": round(fast, 3),
                      "objective_ms": self.objective_ms,
                      "window_s": self.WINDOWS_S[0],
                      "requests": n_fast}
            self._pending.append(breach)
            return breach

    def burn_rates(self, now) -> dict:
        """{"30s": rate|None, ...} — None = not enough samples yet."""
        with self._lock:
            self._prune_locked(now)
            stats = self._window_stats_locked(now)
        return {f"{w:g}s": (None if r is None else round(r, 3))
                for w, r in ((w, self._rate(n, b))
                             for w, (n, b) in stats.items())}

    def has_pending(self) -> bool:
        # Unlocked truthiness read: a stale False only delays the flush
        # to the next touchpoint, a stale True costs one empty sweep.
        return bool(self._pending)

    def take_pending(self) -> list:
        with self._lock:
            out, self._pending[:] = list(self._pending), []
        return out


class FleetSlot:
    """One fleet member: its spec, admission queue, residency state,
    and telemetry. Pure state — the engine owns every transition (all
    mutable fields are touched under the fleet Condition, except
    `model`, which is a single-reference publish read once per
    dispatch, the hot-swap idiom)."""

    def __init__(self, spec):
        self.spec = spec
        self.name = spec.name
        self.weight = float(spec.weight)
        self.stats = ServeStats()
        # SLO burn tracking only when the spec declares an objective.
        objective = getattr(spec, "slo_p99_ms", None)
        self.slo = SloBurnTracker(objective) if objective else None
        # Drift: the divergence tracker is armed
        # at LOAD time (the reference histogram lives in the artifact's
        # mapper) and survives evictions — the rolling window is about
        # the traffic, not the residency. `shadow` is the attached
        # challenger's scorer when THIS slot is a shadowed champion;
        # `observer` is the engine-bound dispatch_batch observer
        # closure (bound once in _make_slot_locked).
        self.drift = None            # serve_drift.DriftTracker | None
        self.shadow = None           # serve_drift.ShadowScorer | None
        self.observer = None
        self.model = None            # resident ServableModel | None
        self.loading = False
        self.load_error = None
        self.ever_resident = False
        self.last_used = 0           # fleet LRU clock (monotonic int)
        self.evictions = 0
        self.reloads = 0
        self.deficit = 0.0           # DRR credit, in rows
        self.batcher = None          # bound by FleetEngine._make_slot


class FleetEngine:
    """N models, one device, one dispatcher thread (module doc).

    `specs` is a sequence of fleet specs (serve/control.py's
    FleetSpec: name/ref/weight/tier/max_batch/raw); `loader(spec)` must
    return a warmed-or-warmable ServableModel — it is called on caller
    threads only, never on the dispatcher. `max_resident=None` keeps
    every model resident (no eviction). `autostart=False` +
    `start()` is the test seam for deterministic backlog setup;
    `on_dispatch(name, rows)` observes the dispatch order (fairness
    tests); `clock` is the injectable admission clock shared with every
    batcher."""

    #: the HTTP front end branches on this (fleet routing + /models).
    fleet = True

    def __init__(self, specs, loader, *, max_wait_ms: float = 1.0,
                 max_resident: "int | None" = None, run_log=None,
                 express_lane: bool = True, clock=None,
                 on_dispatch=None, autostart: bool = True,
                 request_traces: bool = True):
        if max_resident is not None and max_resident < 1:
            raise ValueError(
                f"max_resident must be >= 1, got {max_resident}")
        self._loader = loader
        self.max_wait_ms = float(max_wait_ms)
        self.max_resident = max_resident
        self.express_lane = bool(express_lane)
        self.request_traces = bool(request_traces)
        self.run_log = RunLog.coerce(run_log)
        self._clock = clock if clock is not None else time.perf_counter
        self._on_dispatch = on_dispatch
        self._cv = threading.Condition()
        self._slots: dict[str, FleetSlot] = {}
        self._order: list[str] = []      # DRR rotation; mutated under _cv
        self._rr = 0
        self._use_seq = 0
        self._closed = False
        # Lifecycle events the DISPATCHER settled (evictions on queue
        # drain): buffered here and flushed to the run log by the next
        # handler-thread touchpoint (health/emit_latency/reload) — the
        # dispatcher thread never does file I/O.
        self._pending_events: list = []
        for spec in specs:
            if spec.name in self._slots:
                raise ValueError(
                    f"duplicate model name {spec.name!r} in the fleet")
            self._make_slot_locked(spec)
        self._thread = threading.Thread(
            target=self._loop, name="ddt-fleet-dispatcher", daemon=True)
        if autostart:
            self._thread.start()

    def start(self) -> None:
        """Start the dispatcher (only meaningful after
        `autostart=False` — the deterministic-backlog test seam)."""
        if not self._thread.is_alive():
            self._thread.start()

    # ------------------------------------------------------------------ #
    # slots & residency
    # ------------------------------------------------------------------ #

    def _make_slot_locked(self, spec) -> FleetSlot:
        slot = FleetSlot(spec)
        # DRIVEN batcher: shares the fleet Condition (one dispatcher
        # thread parks on every queue), and its express dispatch is a
        # slot-bound closure so the lane works exactly as on the
        # single-model engine — same gate, same error containment.
        slot.batcher = MicroBatcher(
            self._express_fn(slot), max_wait_ms=self.max_wait_ms,
            max_batch=spec.max_batch, clock=self._clock, cv=self._cv,
            own_thread=False, request_traces=self.request_traces)
        slot.observer = self._observer_fn(slot)
        self._slots[spec.name] = slot
        self._order.append(spec.name)
        self._wire_shadow_locked(slot)
        return slot

    def _wire_shadow_locked(self, slot: FleetSlot) -> None:
        """Attach challenger scorers for a just-created slot, in BOTH
        directions (a fleet config may list the shadow before or after
        its champion — boot order is free; control.validate_specs has
        already refused dangling or chained shadow_of)."""
        champ_name = getattr(slot.spec, "shadow_of", None)
        if champ_name is not None:
            champ = self._slots.get(champ_name)
            if champ is not None and champ.shadow is None:
                champ.shadow = serve_drift.ShadowScorer(
                    slot.name, champ.name, slot, self._clock)
        for s in self._slots.values():
            if getattr(s.spec, "shadow_of", None) == slot.name \
                    and slot.shadow is None:
                slot.shadow = serve_drift.ShadowScorer(
                    s.name, slot.name, s, self._clock)

    def _observer_fn(self, slot):
        """dispatch_batch's post-result observer: fold the
        scored batch into the slot's drift window and hand (rows,
        scores) to an attached challenger's shadow queue. Runs AFTER
        every future in the batch has settled — on the dispatcher
        (batch path) or a handler thread (express lane); both sinks
        take only their own leaf locks, and an alert transition bumps
        the process counter here (a plain int add) while the event
        payload waits in the tracker for a handler-thread flush."""
        def observe(Xb, scores, lats):
            trk = slot.drift
            if trk is not None \
                    and trk.observe(self._clock(), Xb) is not None:
                tele_counters.record_drift_alert()
            scorer = slot.shadow
            if scorer is not None:
                scorer.enqueue(Xb, scores)
        return observe

    def _express_fn(self, slot):
        def dispatch(batch, depth):
            # The express lane reads the slot's model itself (there is
            # no admission step to capture it at). An eviction landing
            # in the tiny window between the caller's residency check
            # and this read surfaces as _EvictedInFlight, which
            # predict_async turns into reload-and-requeue — never a
            # client-visible failure.
            model = slot.model
            if model is None:
                raise _EvictedInFlight(slot.name)
            lats = dispatch_batch(model, batch, depth, slot.stats,
                                  observer=slot.observer)
            trk = slot.slo
            if trk is not None and lats \
                    and trk.record(self._clock(), lats) is not None:
                tele_counters.record_slo_breach()
        return dispatch

    def _slot(self, name) -> FleetSlot:
        with self._cv:
            slot = self._slots.get(name)
            if slot is None:
                raise UnknownModelError(name, self._slots)
            return slot

    def _next_use_locked(self) -> int:
        self._use_seq += 1
        return self._use_seq

    def _ensure_resident(self, slot: FleetSlot) -> None:
        """Make `slot` resident, loading on THIS (caller) thread if it
        was evicted; concurrent callers coalesce on one load. No fleet
        lock is held across the load itself."""
        with self._cv:
            while slot.loading and not self._closed:
                self._cv.wait()
            if self._closed:
                raise ShuttingDown("fleet engine is shut down")
            if slot.model is not None:
                return
            slot.loading = True
            slot.load_error = None
        try:
            model = self._loader(slot.spec)
            # Publish-side guarantee (ServeEngine._build's contract): no
            # live request pays for operands or a kernel build; on an
            # already-warm model this is a handful of dispatches.
            model.warmup()
        # Any load failure becomes the slot's structured unavailability.
        except Exception as e:
            with self._cv:
                slot.loading = False
                slot.load_error = f"{type(e).__name__}: {e}"
                self._cv.notify_all()
            raise ModelUnavailableError(slot.name, slot.load_error) from e
        # Drift/shadow misconfiguration is a CONFIG error, not a load
        # failure: it must surface as the structured 4xx (ValueError
        # family), never the 503 the except-arm above would wrap it in.
        try:
            drift_trk = slot.drift if slot.drift is not None \
                else self._derive_drift(slot.spec, model, slot.name)
            self._check_shadow_compat(slot, model)
        except ValueError as e:
            with self._cv:
                slot.loading = False
                slot.load_error = f"{type(e).__name__}: {e}"
                self._cv.notify_all()
            raise
        with self._cv:
            slot.loading = False
            slot.model = model
            slot.drift = drift_trk
            slot.last_used = self._next_use_locked()
            reloaded = slot.ever_resident
            slot.ever_resident = True
            if reloaded:
                slot.reloads += 1
            victims = self._evict_locked(keep=slot)
            self._cv.notify_all()
        # Telemetry OUTSIDE the lock (the run log's append is file I/O).
        self._flush_events()
        if reloaded:
            tele_counters.record_fleet_reload()
            self._emit_lifecycle("fleet_reload", slot)
        for v in victims:
            tele_counters.record_fleet_eviction()
            self._emit_lifecycle("fleet_eviction", v)

    def _derive_drift(self, spec, model, name):
        """DriftTracker for a freshly loaded model, honouring the spec's
        tri-state `drift` flag: None = auto (track when the artifact
        carries a training reference histogram), False = never, True =
        require — a reference-less artifact is then a FleetConfigError
        (a ValueError: the HTTP boundary renders it as a structured
        4xx, never a bare 500)."""
        want = getattr(spec, "drift", None)
        if want is False:
            return None
        ref = getattr(getattr(model, "mapper", None), "ref_counts", None)
        if ref is None:
            if want is True:
                # Deferred import: control.py imports this module at
                # load; by the time a model loads, control is long
                # importable — no cycle at module-exec time.
                from ddt_tpu_torch.serve.control import FleetConfigError
                raise FleetConfigError(
                    f"model {name!r}: drift=true but artifact "
                    f"{spec.ref!r} carries no training reference "
                    "histogram (mapper.ref_counts) — re-export from a "
                    "training run that captured one, or drop "
                    "drift=true")
            return None
        return serve_drift.DriftTracker(ref)

    def _check_shadow_compat(self, slot: FleetSlot, model) -> None:
        """Champion/challenger agreement, checked at load time on
        whichever side loads second: a challenger scores the champion's
        OWN binned traffic verbatim, so the widths must match and both
        must speak the same output convention (`raw`). Violations are
        FleetConfigError (structured 4xx), raised before publish so the
        broken pairing never serves."""
        with self._cv:
            pairs = []   # (shadow slot, shadow model, champ slot, champ model)
            champ_name = getattr(slot.spec, "shadow_of", None)
            if champ_name is not None:
                champ = self._slots.get(champ_name)
                if champ is not None and champ.model is not None:
                    pairs.append((slot, model, champ, champ.model))
            for s in self._slots.values():
                if getattr(s.spec, "shadow_of", None) == slot.name \
                        and s.model is not None:
                    pairs.append((s, s.model, slot, model))
        for sh, sh_model, champ, champ_model in pairs:
            if sh_model.n_features != champ_model.n_features:
                from ddt_tpu_torch.serve.control import FleetConfigError
                raise FleetConfigError(
                    f"shadow {sh.name!r} expects {sh_model.n_features} "
                    f"features but champion {champ.name!r} serves "
                    f"{champ_model.n_features} — a challenger must "
                    "score the champion's own traffic")
            if bool(getattr(sh.spec, "raw", False)) \
                    != bool(getattr(champ.spec, "raw", False)):
                from ddt_tpu_torch.serve.control import FleetConfigError
                raise FleetConfigError(
                    f"shadow {sh.name!r} and champion {champ.name!r} "
                    "disagree on raw= — margin-vs-probability "
                    "divergence would be meaningless")

    def _evict_locked(self, keep: "FleetSlot | None") -> list:
        """LRU demotion down to `max_resident` (called with the fleet
        Condition held — after a publish, and by the dispatcher each
        cycle so an over-budget fleet SETTLES once queues drain). Only
        IDLE models are candidates — empty queue, not mid-load, not the
        one just published; while everything is busy the fleet
        overshoots its budget temporarily rather than failing live
        traffic."""
        if self.max_resident is None:
            return []
        victims = []
        while True:
            resident = [s for s in self._slots.values()
                        if s.model is not None]
            if len(resident) <= self.max_resident:
                break
            cands = [s for s in resident
                     if s is not keep and not s.loading
                     and not s.batcher.backlog_rows_locked()]
            if not cands:
                break
            victim = min(cands, key=lambda s: s.last_used)
            # Demotion is a reference drop: the registry artifact is
            # the cold form, the model's operands on the card go with
            # its last reference, and a batch or express dispatch that
            # already read it keeps scoring with it.
            victim.model = None
            victim.evictions += 1
            victims.append(victim)
        return victims

    def _emit_lifecycle(self, kind: str, slot: FleetSlot) -> None:
        """Emit one lifecycle fault event NOW (handler threads only —
        callers hold no fleet lock)."""
        if self.run_log is None:
            return
        self.run_log.emit(
            "fault", kind=kind, model_name=slot.name,
            artifact_digest=getattr(slot.model, "artifact_digest", None)
            if slot.model is not None else None,
            evictions=slot.evictions, reloads=slot.reloads)

    def _queue_eviction_events_locked(self, victims) -> None:
        """Record dispatcher-settled evictions: counters move now
        (plain int adds), the run-log events wait for a handler thread
        (_flush_events) — the dispatcher never touches the log file."""
        for v in victims:
            tele_counters.record_fleet_eviction()
            self._pending_events.append(
                ("fleet_eviction", v.name, v.evictions, v.reloads))

    def _flush_events(self) -> None:
        """Drain dispatcher-buffered lifecycle events AND pending SLO
        breaches AND pending drift alerts into the run log (handler
        threads: health, emit_latency, reload, and the request path
        when a tracker has something waiting)."""
        with self._cv:
            pending, self._pending_events[:] = \
                list(self._pending_events), []
            slots = list(self._slots.values())
        breaches = []
        drifts = []
        for s in slots:
            if s.slo is not None and s.slo.has_pending():
                for b in s.slo.take_pending():
                    breaches.append((s, b))
            if s.drift is not None and s.drift.has_pending():
                for d in s.drift.take_pending():
                    drifts.append((s, d))
        if self.run_log is None:
            return
        for kind, name, evictions, reloads in pending:
            self.run_log.emit("fault", kind=kind, model_name=name,
                              artifact_digest=None,
                              evictions=evictions, reloads=reloads)
        for s, b in breaches:
            self.run_log.emit("fault", kind="slo_breach",
                              model_name=s.name, **b)
            # A breach drags the evidence out with it: the slot's trace
            # ring is flushed as a `serve_trace` event so the slow tail
            # is attributable after the fact, not just counted.
            self.flush_traces(reason="slo_breach", only=s.name)
        for s, d in drifts:
            # Latched alert transitions (drift.py buffered the payload
            # on whatever thread observed it) land as first-class
            # `drift` events — `report drift` reads them back.
            self.run_log.emit("drift", model_name=s.name, **d)

    # ------------------------------------------------------------------ #
    # request path
    # ------------------------------------------------------------------ #

    @property
    def default_model(self) -> "str | None":
        """The implicit routing target: the fleet's single model when
        there is exactly one, else None (requests must name one)."""
        with self._cv:
            return self._order[0] if len(self._order) == 1 else None

    def _resolve_name(self, model: "str | None") -> str:
        """Routed name -> fleet member name, applying the single-model
        default (one resolution shared by predict_async and the raw
        wire path's width lookup, so the two cannot disagree)."""
        name = model if model is not None else self.default_model
        if name is None:
            with self._cv:
                known = list(self._slots)
            raise UnknownModelError(
                model if model is not None else "(unrouted)", known)
        return name

    def n_features_for(self, name: "str | None" = None) -> int:
        """Feature width of the routed model (loads it if evicted —
        the raw wire path needs the width before it can decode a body;
        `None` resolves the single-model default like predict_async)."""
        name = self._resolve_name(name)
        slot = self._slot(name)
        self._ensure_resident(slot)
        model = slot.model
        if model is None:
            raise ModelUnavailableError(name, "evicted during lookup")
        return model.n_features

    def predict_async(self, rows, model: "str | None" = None,
                      trace_id: "str | None" = None) -> PendingRequest:
        name = self._resolve_name(model)
        rows = coerce_rows(rows)
        slot = self._slot(name)
        # SLO-breach / drift-alert sweep: the dispatcher can only
        # BUFFER these (no file I/O on that thread), so the next
        # request for the slot carries them to the log. has_pending is
        # an unlocked truthiness read — zero cost on the quiet path.
        if ((slot.slo is not None and slot.slo.has_pending())
                or (slot.drift is not None
                    and slot.drift.has_pending())):
            self._flush_events()
        # Residency + enqueue retry loop: an eviction can land between
        # the load and the enqueue (or mid-express) — each lap reloads
        # and tries again; the bound is defensive, in practice one lap.
        for _ in range(8):
            self._ensure_resident(slot)
            if self.express_lane and rows.shape[0] == 1:
                req = slot.batcher.express(rows, 1, trace_id=trace_id)
                if req is not None:
                    if isinstance(req.exception(), _EvictedInFlight):
                        continue          # raced an eviction: reload
                    with self._cv:
                        slot.last_used = self._next_use_locked()
                    return req
            with self._cv:
                if self._closed:
                    raise ShuttingDown("fleet engine is shut down")
                # A remove_model racing this request deletes the slot
                # AFTER our lookup: enqueueing into the orphaned slot
                # would hang forever (the dispatcher rotates over
                # _order, which no longer lists it) — re-check
                # membership under the same lock the removal holds.
                if self._slots.get(name) is not slot:
                    raise UnknownModelError(name, self._slots)
                # Enqueue ATOMICALLY with the residency check (the
                # Condition's lock is reentrant): eviction requires an
                # empty queue under this same lock, so once enqueued
                # the model cannot be demoted until the queue drains.
                if slot.model is not None:
                    slot.last_used = self._next_use_locked()
                    return slot.batcher.submit(rows, rows.shape[0],
                                               trace_id=trace_id)
        raise ModelUnavailableError(
            name, "could not win the residency race (reload storm?)")

    def predict(self, rows, model: "str | None" = None,
                timeout: "float | None" = 30.0):
        return self.predict_async(rows, model=model).result(timeout)

    # ------------------------------------------------------------------ #
    # dispatcher thread: weighted deficit round robin
    # ------------------------------------------------------------------ #

    def _rotation_locked(self, start: int) -> list:
        """Slots in DRR rotation order beginning at index `start` (the
        loop passes its own rotation pointer — every `self._rr` access
        stays inside the two Condition-guarded methods that own it)."""
        order = self._order
        if not order:
            return []
        i = start % len(order)
        return [self._slots[n] for n in order[i:] + order[:i]]

    def _backlog_locked(self) -> int:
        return sum(s.batcher.backlog_rows_locked()
                   for s in self._slots.values())

    def _loop(self) -> None:
        while True:
            admitted = []       # (slot, model, batch, depth)
            with self._cv:
                while True:
                    if self._closed and not self._backlog_locked():
                        return
                    now = self._clock()
                    ready = [s for s in self._rotation_locked(self._rr)
                             if (s.batcher.ready_locked(now)
                                 or (self._closed and s.batcher
                                     .backlog_rows_locked()))]
                    if ready:
                        break
                    timeout = None
                    for s in self._slots.values():
                        dl = s.batcher.head_deadline_locked()
                        if dl is not None:
                            t = max(0.0, dl - now)
                            timeout = t if timeout is None \
                                else min(timeout, t)
                    # cv.wait(timeout) parks the thread — no
                    # sleep-polling.
                    self._cv.wait(timeout)
                for slot in ready:
                    # DRR: earn weight x max_batch rows of credit
                    # (capped — credit never banks across idle spells),
                    # then admit micro-batches until it runs out. The
                    # model reference is captured HERE, under the lock
                    # that eviction runs under: every admitted batch is
                    # scored by exactly the version it was admitted
                    # against (old-or-new-never-a-mix, per model).
                    quantum = slot.weight * slot.batcher.max_batch
                    slot.deficit = min(slot.deficit + quantum, quantum)
                    while (slot.deficit > 0
                           and (slot.batcher.ready_locked(self._clock())
                                or self._closed)):
                        batch, depth = slot.batcher.admit_locked()
                        if not batch:
                            break
                        slot.deficit -= sum(r.n for r in batch)
                        admitted.append(
                            (slot, slot.model, batch, depth))
                    if not slot.batcher.backlog_rows_locked():
                        slot.deficit = 0.0
                if self._order:
                    self._rr = (self._rr + 1) % len(self._order)
                # Over-budget settlement: a storm can make EVERY model
                # busy at publish time (eviction skips busy slots), so
                # the fleet overshoots max_resident; the dispatcher
                # settles it back as soon as queues drain — a pure
                # reference drop, nothing blocking (events are buffered
                # for the next handler thread to flush).
                self._queue_eviction_events_locked(
                    self._evict_locked(keep=None))
            for slot, model, batch, depth in admitted:
                if self._on_dispatch is not None:
                    self._on_dispatch(slot.name,
                                      sum(r.n for r in batch))
                if model is None:
                    # Defensive: enqueue-under-lock makes this
                    # unreachable (eviction needs an empty queue), but
                    # a hung waiter would be strictly worse than a loud
                    # per-request error if the invariant ever breaks.
                    for req in batch:
                        req.set_error(ModelUnavailableError(
                            slot.name, "evicted with queued work"))
                    continue
                slot.batcher.dispatch_under_gate(
                    self._batch_fn(model, slot), batch, depth)

    def _batch_fn(self, model, slot):
        def dispatch(batch, depth):
            lats = dispatch_batch(model, batch, depth, slot.stats,
                                  observer=slot.observer)
            trk = slot.slo
            if trk is not None and lats \
                    and trk.record(self._clock(), lats) is not None:
                # Counter now (plain int add — dispatcher-safe); the
                # run-log event waits in the tracker's pending buffer
                # for a handler-thread sweep.
                tele_counters.record_slo_breach()
        return dispatch

    # ------------------------------------------------------------------ #
    # control plane (add / remove / retag) — caller threads only
    # ------------------------------------------------------------------ #

    def add_model(self, spec, *, load: bool = True) -> dict:
        """Add a model to the fleet without restart. Loud on duplicate
        names; `load=True` makes it resident now (evicting LRU models
        past the budget), else it stays cold until first request. A
        FAILED load rolls the slot back out — the HTTP add path has no
        boot-time ref resolution, and a half-added broken member would
        both 503 every routed request and block the corrected retry
        with 'already in the fleet'."""
        with self._cv:
            if self._closed:
                raise ShuttingDown("fleet engine is shut down")
            if spec.name in self._slots:
                raise ValueError(
                    f"model {spec.name!r} is already in the fleet "
                    "(remove it first, or retag it)")
            # Live shadow attach (boot-time specs go through
            # control.validate_specs; this is the POST /models path, so
            # the same topology rules apply here — ValueError lands in
            # the HTTP layer's structured 400 arm).
            champ_name = getattr(spec, "shadow_of", None)
            if champ_name is not None:
                champ = self._slots.get(champ_name)
                if champ is None:
                    raise ValueError(
                        f"shadow_of={champ_name!r} names no fleet "
                        f"member (serving: "
                        f"{', '.join(sorted(self._slots)) or 'none'})")
                if getattr(champ.spec, "shadow_of", None) is not None:
                    raise ValueError(
                        f"model {champ_name!r} is itself a shadow — "
                        "shadow chains are not supported")
                if champ.shadow is not None:
                    raise ValueError(
                        f"model {champ_name!r} already has shadow "
                        f"{champ.shadow.name!r} (one challenger per "
                        "champion; remove it first)")
            slot = self._make_slot_locked(spec)
            self._cv.notify_all()
        if load:
            try:
                self._ensure_resident(slot)
            except BaseException:
                scorers = []
                with self._cv:
                    if self._slots.get(spec.name) is slot:
                        del self._slots[spec.name]
                        self._order.remove(spec.name)
                        self._rr = 0
                        # Detach any scorer the slot creation wired up
                        # (in either direction) — a rolled-back member
                        # must not leave a live challenger thread.
                        for s in self._slots.values():
                            if s.shadow is not None \
                                    and s.shadow.name == spec.name:
                                scorers.append(s.shadow)
                                s.shadow = None
                        if slot.shadow is not None:
                            scorers.append(slot.shadow)
                            slot.shadow = None
                        slot.batcher.fail_pending_locked(
                            UnknownModelError(spec.name, self._slots))
                        self._cv.notify_all()
                for scorer in scorers:
                    scorer.close()    # join: outside the fleet lock
                raise
        return {"name": slot.name, "resident": slot.model is not None,
                "weight": slot.weight}

    def remove_model(self, name) -> dict:
        """Remove a model: queued requests fail loudly (UnknownModel),
        in-flight batches finish with the reference they hold."""
        with self._cv:
            slot = self._slots.get(name)
            if slot is None:
                raise UnknownModelError(name, self._slots)
            if slot.shadow is not None:
                # A shadowed champion stays put until the experiment is
                # torn down explicitly — silently dropping the target
                # of a live comparison would leave the challenger
                # scoring nothing without anyone deciding that.
                raise ValueError(
                    f"model {name!r} is shadowed by "
                    f"{slot.shadow.name!r}; remove the shadow first")
            scorer = None
            champ_name = getattr(slot.spec, "shadow_of", None)
            if champ_name is not None:
                champ = self._slots.get(champ_name)
                if champ is not None and champ.shadow is not None \
                        and champ.shadow.name == name:
                    scorer, champ.shadow = champ.shadow, None
            failed = slot.batcher.fail_pending_locked(
                UnknownModelError(name, set(self._slots) - {name}))
            del self._slots[name]
            self._order.remove(name)
            self._rr = 0
            slot.model = None
            self._cv.notify_all()
        if scorer is not None:
            scorer.close()    # removing the challenger detaches it
        if self.run_log is not None:
            self.run_log.emit("fault", kind="fleet_remove",
                              model_name=name, failed_requests=failed)
        return {"name": name, "failed_requests": failed}

    def spec_for(self, name):
        """The current spec of fleet member `name` (the HTTP control
        plane's retag path derives the replacement spec from it)."""
        return self._slot(name).spec

    def retag(self, name, spec) -> dict:
        """Re-point an existing fleet member at a new reference and hot
        swap it in — the per-model zero-downtime swap (the model
        reference for each batch is read at admission, so requests see
        exactly the old or the new version, never a mix)."""
        slot = self._slot(name)
        new = self._loader(spec)
        new.warmup()
        # Retag re-derives the drift tracker from the NEW artifact: the
        # reference histogram belongs to the training run behind the
        # new model, so the old rolling window is meaningless against
        # it. Misconfig raises (structured 4xx) before any swap.
        new_drift = self._derive_drift(spec, new, name)
        self._check_shadow_compat(slot, new)
        with self._cv:
            if name not in self._slots:
                raise UnknownModelError(name, self._slots)
            old = slot.model
            slot.spec = spec
            # Retag re-derives the SLO tracker from the NEW spec: a
            # changed objective starts a fresh burn history (old-burn
            # vs new-objective comparisons are meaningless).
            objective = getattr(spec, "slo_p99_ms", None)
            slot.slo = SloBurnTracker(objective) if objective else None
            slot.drift = new_drift
            slot.model = new
            slot.ever_resident = True
            slot.last_used = self._next_use_locked()
            victims = self._evict_locked(keep=slot)
            self._cv.notify_all()
        tele_counters.record_serve_hot_swap()
        old_token = old.token if old is not None else None
        if self.run_log is not None:
            self.run_log.emit(
                "fault", kind="hot_swap", model_name=name,
                old=old_token, new=new.token,
                old_artifact=getattr(old, "artifact_digest", None),
                new_artifact=new.artifact_digest)
        for v in victims:
            tele_counters.record_fleet_eviction()
            self._emit_lifecycle("fleet_eviction", v)
        return {"name": name, "old": old_token, "new": new.token,
                "ref": spec.ref}

    # ------------------------------------------------------------------ #
    # telemetry
    # ------------------------------------------------------------------ #

    def _slot_health_locked(self, slot: FleetSlot) -> dict:
        model = slot.model
        out = {
            "resident": model is not None,
            "weight": slot.weight,
            "max_batch": slot.batcher.max_batch,
            "ref": slot.spec.ref,
            "tier": slot.spec.tier,
            "evictions": slot.evictions,
            "reloads": slot.reloads,
            "queued_rows": slot.batcher.backlog_rows_locked(),
            "load_error": slot.load_error,
        }
        if model is not None:
            out.update(model_token=model.token,
                       predict_impl=model.predict_impl,
                       artifact_digest=model.artifact_digest,
                       n_features=model.n_features)
        if slot.slo is not None:
            # SLO fields appear only when
            # the spec declares an objective — a pre-SLO fleet's health
            # payload is byte-identical to before.
            out.update(slo_p99_ms=slot.slo.objective_ms,
                       slo_burn_rate=slot.slo.burn_rates(self._clock()),
                       slo_breaches=slot.slo.breaches)
        if slot.drift is not None:
            # Drift fields appear only when
            # the artifact carried a reference histogram (same
            # omit-don't-lie convention as the SLO block). Lock nesting
            # is fleet-Condition -> tracker-leaf-lock, the SloBurnTracker
            # precedent.
            d = slot.drift.state(self._clock())
            out.update(drift_psi_max=d["psi_max"],
                       drift_js_max=d["js_max"],
                       drift_alerting=d["alerting"],
                       drift_alerts=d["alerts"],
                       drift_window_rows=d["window_rows"])
        champ_name = getattr(slot.spec, "shadow_of", None)
        if champ_name is not None:
            out["shadow_of"] = champ_name
        if slot.shadow is not None:
            out["shadow"] = slot.shadow.summary()
        return out

    def health(self) -> dict:
        self._flush_events()
        with self._cv:
            models = {name: self._slot_health_locked(s)
                      for name, s in sorted(self._slots.items())}
            resident = sum(1 for s in self._slots.values()
                           if s.model is not None)
        return {
            "ok": True,
            "fleet": True,
            "models": models,
            "resident": resident,
            "resident_models": resident,
            "backlog_rows": sum(m["queued_rows"]
                                for m in models.values()),
            "max_resident": self.max_resident,
            "express_lane": self.express_lane,
            "evictions": sum(m["evictions"] for m in models.values()),
            "reloads": sum(m["reloads"] for m in models.values()),
        }

    def models(self) -> dict:
        """GET /models payload (the health table, without the envelope)."""
        return self.health()["models"]

    def metrics_snapshot(self) -> dict:
        """Live per-model exposition state for `GET /metrics` — strictly
        read-only (non-resetting histograms, live backlog, SLO burn);
        serve/metrics.py renders it to Prometheus text."""
        now = self._clock()
        with self._cv:
            slots = list(self._slots.values())
            resident = sum(1 for s in slots if s.model is not None)
            backlog = {s.name: s.batcher.backlog_rows_locked()
                       for s in slots}
        models = {}
        for s in slots:
            slo = None
            if s.slo is not None:
                slo = {"objective_ms": s.slo.objective_ms,
                       "burn_rates": s.slo.burn_rates(now),
                       "breaches": s.slo.breaches}
            drift = s.drift.state(now) if s.drift is not None else None
            shadow = s.shadow.summary() if s.shadow is not None else None
            models[s.name] = {"hist": s.stats.metrics_state(),
                              "backlog_rows": backlog[s.name],
                              "slo": slo,
                              "drift": drift,
                              "shadow": shadow}
        return {"models": models, "resident_models": resident,
                "max_resident": self.max_resident}

    def debug_drift(self) -> dict:
        """GET /debug/drift payload: per-model reference/window state,
        worst-first per-feature divergence attribution, and the shadow
        comparison. Handler threads only (flushes pending drift
        events on the way)."""
        self._flush_events()
        now = self._clock()
        with self._cv:
            slots = list(self._slots.values())
        models = {}
        for s in slots:
            rec = {"reference": s.drift is not None,
                   "shadow_of": getattr(s.spec, "shadow_of", None)}
            if s.drift is not None:
                rec["state"] = s.drift.state(now)
                rec["per_feature"] = s.drift.per_feature(now)
            if s.shadow is not None:
                rec["shadow"] = s.shadow.summary()
            models[s.name] = rec
        return {"fleet": True, "models": models}

    def debug_traces(self) -> dict:
        """{model_name: [trace records]} — each slot's ring of the last
        N completed request traces (GET /debug/requests)."""
        with self._cv:
            slots = list(self._slots.values())
        return {s.name: s.stats.traces_snapshot() for s in slots}

    def flush_traces(self, reason: str = "on_demand",
                     only: "str | None" = None) -> int:
        """Flush trace rings into the run log as `serve_trace` events
        (one per model with traces); returns the trace count flushed.
        Handler threads only — this is file I/O."""
        if self.run_log is None:
            return 0
        with self._cv:
            slots = [s for s in self._slots.values()
                     if only is None or s.name == only]
        total = 0
        for slot in slots:
            traces = slot.stats.traces_snapshot()
            if not traces:
                continue
            model = slot.model
            self.run_log.emit(
                "serve_trace", traces=traces, count=len(traces),
                model_name=slot.name,
                model_token=model.token if model is not None else None,
                reason=reason)
            total += len(traces)
        return total

    def window_summaries(self, reset: bool = False) -> dict:
        """{model_name: current-window latency summary} for /stats."""
        with self._cv:
            slots = list(self._slots.values())
        out = {}
        for slot in slots:
            s = slot.stats.window_summary(reset=reset)
            if s["requests"] == 0 and not reset:
                continue
            s["model_name"] = slot.name
            out[slot.name] = s
        return out

    def emit_latency(self, reset: bool = True,
                     only: "str | None" = None) -> dict:
        """Emit one `serve_latency` event PER MODEL with traffic this
        window (the model_name dimension — schema-additive); returns
        {model_name: payload} for the models that emitted. `only`
        restricts emission (and the window reset) to ONE model — the
        per-model `/models/<name>/stats?emit=1` surface must not
        silently discard every OTHER model's window."""
        self._flush_events()
        with self._cv:
            slots = list(self._slots.values())
        out = {}
        for slot in slots:
            if only is not None and slot.name != only:
                continue
            summary = slot.stats.window_summary(reset=reset)
            if summary["requests"] == 0:
                continue
            summary["model_name"] = slot.name
            if slot.slo is not None:
                # The window rides its objective out (schema-additive):
                # `report slo` reads it off old logs without needing
                # the fleet config that set it.
                summary["slo_p99_ms"] = slot.slo.objective_ms
            model = slot.model
            if model is not None:
                summary["model_token"] = model.token
                summary["predict_impl"] = model.predict_impl
                if model.artifact_digest is not None:
                    summary["artifact_digest"] = model.artifact_digest
            if slot.drift is not None:
                # Drift rides the latency window out (schema-additive):
                # `report drift` reads divergence off old
                # logs even when no alert ever latched.
                d = slot.drift.state(self._clock())
                if d["psi_max"] is not None:
                    summary["drift_psi_max"] = d["psi_max"]
                    summary["drift_js_max"] = d["js_max"]
                    summary["drift_alerting"] = d["alerting"]
            if slot.shadow is not None:
                sh = slot.shadow.summary()
                summary["shadow_model"] = sh["model"]
                summary["shadow_rows"] = sh["rows"]
                if sh["mean_abs_diff"] is not None:
                    summary["shadow_mean_abs_diff"] = \
                        sh["mean_abs_diff"]
                if sh["ms_p50"] is not None:
                    summary["shadow_ms_p50"] = sh["ms_p50"]
                if sh["dropped"]:
                    summary["shadow_dropped"] = sh["dropped"]
            if self.run_log is not None:
                self.run_log.emit("serve_latency", **summary)
            out[slot.name] = summary
        return out

    def close(self) -> None:
        with self._cv:
            self._closed = True
            scorers = [s.shadow for s in self._slots.values()
                       if s.shadow is not None]
            for slot in self._slots.values():
                slot.batcher.close()      # no own thread: marks closed
            self._cv.notify_all()
        if self._thread.is_alive():
            self._thread.join(10.0)
        for scorer in scorers:
            scorer.close()    # joins the scorer thread — no lock held
        self.emit_latency(reset=True)
        if self.run_log is not None:
            self.run_log.close()
