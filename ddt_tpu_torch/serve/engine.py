"""ServeEngine: device-resident models, micro-batch scoring, latency stats.

Port of ddt_tpu/serve/engine.py. One engine owns:

- a `ServableModel` per live model version: the per-model prologue
  (mapper validation, CompiledEnsemble build, the quantized tables of the
  serving tier, device upload, one warm-up dispatch per bucket shape,
  which on the card also builds the kernel) is paid once at publish, so
  the request path is: bin the batch's rows once, on the device -> pad
  to bucket -> one dispatch -> scatter;
- a `MicroBatcher` whose dispatcher scores each admitted batch against
  the model reference read once per batch. A hot swap is one reference
  store, so every request sees exactly the old or the new model;
- `ServeStats`: per-request p50/p99/p999, coalesce width, queue depth,
  express-lane count, a fixed-bucket latency histogram and a ring of
  request traces.

The tiers: quantize=None serves the f32 traversal (kernel K3), "int8"
the int8 TreeLUT tier (K4), "int4" the int4 tier (K5; all three in
csrc/lut.cu), down the backend's int4 -> int8 -> f32 fits-guard
ladder; `ServableModel.predict_impl` reports the tier that serves. On the
card by default (cfg.device="cuda"); device="cpu" runs the plain versions.

A ServableModel owns its scoring operands on the device (the compiled
model, the tier's tables, the tier: `CUDADevice.prepare_scoring`, built
once at warm-up, outside the backend's per-model cache), as the
reference's RestoredModel owns its programs: once a model is published
no dispatch builds operands, however many models share the backend, and
dropping the last reference to a model frees its tables on the card.

A model restored from the registry (registry/loader.load_servable) is a
ServableModel stamped with its `artifact_digest`, which health() shows;
the engine publishes it as it is, at construction or by swap.

Telemetry: the serve counters (telemetry/counters), `serve_latency`
windows (`emit_latency`), `serve_trace` flushes, the swap's
`fault kind=hot_swap` event and `metrics_snapshot` for `/metrics`. The
fleet (serve/fleet.py) shares `dispatch_batch` and `ServeStats`; the
HTTP front end is serve/http.py.

Left out: the reference's AOT-restored model (RestoredModel scoring
through deserialized programs). The port restores by rebuild or from the
carried tables (registry/loader.py), so `ServableModel.aot` is always
False.

No `time.sleep` and no file reads here: models are handed in as ready
ModelBundles (the http and control layers load them).
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import logging
import threading
import time

import numpy as np
import torch

from ddt_tpu_torch.api import predict_proba_np, validate_mapper_model
from ddt_tpu_torch.backends import get_backend
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.serve.batcher import (MicroBatcher, PendingRequest,
                                         trace_breakdown)
from ddt_tpu_torch.telemetry import counters as tele_counters
from ddt_tpu_torch.telemetry.events import RunLog

log = logging.getLogger("ddt_tpu_torch.serve")


def normalize_quantize(q) -> "str | None":
    """Every spelling of the serving tier -> None | "int8" | "int4":
    bools (True = int8), the cfg.predict_impl spellings ("lut"/"lut4")
    and the leaf-dtype spellings."""
    if q is None or q is False:
        return None
    if q is True:
        return "int8"
    s = str(q).lower()
    if s in ("", "none", "false", "f32"):
        return None
    if s in ("int8", "lut", "true", "float16"):
        return "int8"
    if s in ("int4", "lut4"):
        return "int4"
    raise ValueError(
        f"unknown quantization tier {q!r} (expected int8 or int4)")


#: serving tier -> the cfg.predict_impl that dispatches it.
TIER_IMPL = {"int8": "lut", "int4": "lut4"}
#: serving tier -> the QuantizedTables leaf dtype it quantizes to.
TIER_LEAF_DTYPE = {"int8": "float16", "int4": "int4"}


def default_buckets(max_batch: int) -> tuple[int, ...]:
    """Power-of-two pad-to-bucket ladder up to max_batch: the fixed set of
    batch shapes every dispatch rides."""
    out = [1]
    while out[-1] < max_batch:
        out.append(min(out[-1] * 2, max_batch))
    return tuple(out)


def bucket_for(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class ServableModel:
    """One model version, prepared to score micro-batches.

    Build cost (validation, CompiledEnsemble, quantized tables, device
    upload, one dispatch per bucket) is paid here and in `warmup`, off
    the request path; `score_binned()` is pad + dispatch through the
    operands this model owns (`operands()`). Instances are immutable
    once warm: the engine swaps whole references. `raw=True` scores raw
    margins instead of probabilities; `tables` are carried quantized
    tables (a registry artifact's), which serve as they are."""

    #: Short registry digest of the artifact this model was restored from
    #: (registry/loader); None for a model built from a bundle.
    artifact_digest: "str | None" = None
    #: The reference's flag for a model scoring through deserialized
    #: programs; the port has none (export/aot.py), so always False.
    aot: bool = False

    def __init__(self, bundle, backend, *, quantize=None,
                 buckets: tuple[int, ...] = (1,), raw: bool = False,
                 tables=None):
        self.ens = bundle.ensemble
        self.mapper = bundle.mapper
        self.backend = backend
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.raw = bool(raw)
        self.quantize_tier = normalize_quantize(quantize)
        self.quantized = self.quantize_tier is not None
        if self.mapper is not None:
            validate_mapper_model(self.mapper, self.ens)
        self.compiled = self.ens.compile(tree_chunk=64)
        self.token = self.compiled.token
        if self.quantize_tier:
            if tables is not None:
                # Carried tables define the representation: an int4
                # request must get int4 tables, or the reported error
                # bound would describe the wrong grid.
                if ((tables.leaf_dtype == "int4")
                        != (self.quantize_tier == "int4")):
                    raise ValueError(
                        f"carried tables are leaf_dtype="
                        f"{tables.leaf_dtype!r} but the serving tier is "
                        f"{self.quantize_tier!r}")
                # Seed the memo so the backend's quantized dispatch
                # consumes these tables, not a re-derivation.
                self.compiled.seed_quantized(tables)
                self.tables = self.compiled.quantize(
                    leaf_dtype=tables.leaf_dtype)
            else:
                self.tables = self.compiled.quantize(
                    leaf_dtype=TIER_LEAF_DTYPE[self.quantize_tier])
            self.max_abs_err = self.tables.max_abs_err
        else:
            self.tables = None
            self.max_abs_err = 0.0
        self._ops = None
        self._ops_lock = threading.Lock()

    def operands(self):
        """This model's scoring operands on the backend's device
        (ScoringOperands), built on first use (warm-up) and kept."""
        ops = self._ops
        if ops is None:
            with self._ops_lock:
                if self._ops is None:
                    self._ops = self.backend.prepare_scoring(
                        self.ens, self.compiled)
                ops = self._ops
        return ops

    @property
    def predict_impl(self) -> str:
        """The tier actually serving this model ("lut4" | "lut" | "f32"),
        as the backend's ladder resolved it at warm-up and kept with the
        operands."""
        ops = self._ops
        if ops is not None:
            return ops.tier
        return self.backend.resolved_predict_impl(self.token)

    @property
    def n_features(self) -> int:
        return int(self.ens.n_features)

    def transform(self, rows: np.ndarray) -> torch.Tensor:
        """f32 rows -> uint8 bins on the backend's device, with the
        training-time mapper (bit for bit mapper.transform)."""
        if self.mapper is None:
            raise ValueError(
                "model carries no bin mapper; submit pre-binned uint8 rows")
        return self.mapper.transform_device(rows, self.backend.device)

    def score_binned(self, Xb) -> np.ndarray:
        """Probabilities (raw values for mse, margins with raw=True) for a
        binned block (host uint8 or a uint8 tensor), padded on the device
        to the nearest bucket (each row's score does not depend on the
        other rows of its batch)."""
        n = Xb.shape[0]
        cap = self.buckets[-1]
        if n > cap:
            # An oversize solo request rides bucket shapes too, in
            # largest-bucket pieces.
            return np.concatenate([self.score_binned(Xb[i:i + cap])
                                   for i in range(0, n, cap)])
        Xb = self.backend.device_rows(Xb)
        b = bucket_for(n, self.buckets)
        if n < b:
            Xb = torch.cat([Xb, Xb.new_zeros((b - n, Xb.shape[1]))])
        out = self.backend.predict_raw(self.ens, Xb, compiled=self.compiled,
                                       operands=self.operands())[:n]
        return out if self.raw else predict_proba_np(out, self.ens.loss)

    def warmup(self) -> None:
        """Score every bucket shape before the model is published: the
        tier resolves, the operands are built and uploaded and, on the
        card, the kernel is built, so a swap never makes a live request
        pay for them."""
        dummy = np.zeros((1, self.n_features), np.uint8)
        for b in self.buckets:
            self.score_binned(np.repeat(dummy, b, axis=0))


@dataclasses.dataclass
class _Window:
    """One latency-accounting window. Bounded: the sample deques keep the
    most recent CAP requests/batches; `requests` and `batches` stay exact
    counts."""

    CAP = 65_536

    latencies_ms: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=_Window.CAP))
    widths: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=_Window.CAP))
    requests: int = 0
    queue_depth_max: int = 0
    batches: int = 0
    express: int = 0            # requests the express lane dispatched
    t_start: float = dataclasses.field(default_factory=time.perf_counter)


#: Fixed log-spaced latency histogram upper bounds in ms (0.1 ms doubling
#: to ~3.3 s, plus an implicit overflow bucket): never derived from data,
#: so two snapshots are always bucket-compatible.
HIST_BUCKETS_MS = tuple(round(0.1 * 2.0 ** i, 4) for i in range(16))


def _quantile(sorted_vals: list, q: float) -> float:
    """Nearest-rank quantile on a pre-sorted list (p999 of a small run is
    the honest max, not an interpolation)."""
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(np.ceil(q * len(sorted_vals))) - 1)
    return float(sorted_vals[max(0, i)])


class ServeStats:
    """Thread-safe latency/coalesce accounting: a bounded all-time ring
    plus the current window, a non-resetting latency histogram, and a ring
    of the last TRACE_RING request traces."""

    RING = 65_536
    TRACE_RING = 256

    def __init__(self):
        self._lock = threading.Lock()
        self._all = collections.deque(maxlen=self.RING)
        self._win = _Window()
        self.requests = 0
        self.coalesce_max = 0
        self.express = 0
        self._hist = [0] * (len(HIST_BUCKETS_MS) + 1)
        self._hist_sum_ms = 0.0
        self._traces: collections.deque = collections.deque(
            maxlen=self.TRACE_RING)

    def record_batch(self, n_requests: int, queue_depth: int,
                     latencies_ms: list, express: bool = False,
                     traces: "list | None" = None) -> None:
        with self._lock:
            self.requests += n_requests
            self.coalesce_max = max(self.coalesce_max, n_requests)
            self._all.extend(latencies_ms)
            for v in latencies_ms:
                self._hist[bisect.bisect_left(HIST_BUCKETS_MS, v)] += 1
                self._hist_sum_ms += v
            if traces:
                self._traces.extend(traces)
            w = self._win
            w.batches += 1
            w.requests += n_requests
            w.widths.append(n_requests)
            w.queue_depth_max = max(w.queue_depth_max, queue_depth)
            w.latencies_ms.extend(latencies_ms)
            if express:
                self.express += n_requests
                w.express += n_requests

    def _summary_locked(self, w: _Window) -> dict:
        lat = sorted(w.latencies_ms)
        return {
            "requests": w.requests,
            "batches": w.batches,
            "window_s": round(time.perf_counter() - w.t_start, 6),
            "p50_ms": round(_quantile(lat, 0.50), 4),
            "p99_ms": round(_quantile(lat, 0.99), 4),
            "p999_ms": round(_quantile(lat, 0.999), 4),
            "max_ms": round(lat[-1], 4) if lat else 0.0,
            "coalesce_mean": (round(float(np.mean(w.widths)), 3)
                              if w.widths else 0.0),
            "coalesce_max": max(w.widths) if w.widths else 0,
            "queue_depth_max": w.queue_depth_max,
            "express": w.express,
        }

    def window_summary(self, reset: bool = False) -> dict:
        """The current window's summary; `reset=True` starts a new one."""
        with self._lock:
            out = self._summary_locked(self._win)
            if reset:
                self._win = _Window()
        return out

    def snapshot(self) -> dict:
        """All-time view for health() and tests."""
        with self._lock:
            lat = sorted(self._all)
            return {
                "requests": self.requests,
                "coalesce_max": self.coalesce_max,
                "express": self.express,
                "p50_ms": round(_quantile(lat, 0.50), 4),
                "p99_ms": round(_quantile(lat, 0.99), 4),
                "p999_ms": round(_quantile(lat, 0.999), 4),
            }

    def metrics_state(self) -> dict:
        """The non-resetting histogram state (fixed bounds, per-bucket
        counts with the overflow last, running sum, lifetime count).
        Read-only: never perturbs the window."""
        with self._lock:
            return {"buckets_ms": list(HIST_BUCKETS_MS),
                    "counts": list(self._hist),
                    "sum_ms": round(self._hist_sum_ms, 4),
                    "count": self.requests,
                    "express": self.express}

    def traces_snapshot(self) -> list:
        """Completed-trace ring, oldest first."""
        with self._lock:
            return list(self._traces)


def coerce_rows(rows) -> np.ndarray:
    """Submit-side row normalization: [F] becomes [1, F], anything but
    2-D is refused, non-uint8 input becomes contiguous f32 (uint8 rows are
    pre-binned and pass through)."""
    rows = np.asarray(rows)
    if rows.ndim == 1:
        rows = rows[None, :]
    if rows.ndim != 2:
        raise ValueError(f"rows must be [n, F], got {rows.shape}")
    if rows.dtype != np.uint8:
        rows = np.ascontiguousarray(rows, np.float32)
    return rows


def _bin_batch(model, floats: list) -> list:
    """Bin the float requests' f32 rows: one transform of their
    concatenation on the device, each request's slice of it returned in
    order. If that raises, each request is binned alone, so that a bad
    request fails by itself: its entry is then the exception."""
    try:
        Xb = model.transform(floats[0] if len(floats) == 1
                             else np.concatenate(floats))
    except Exception:
        out = []
        for rows in floats:
            try:
                out.append(model.transform(rows))
            # Delivered to this request's own waiter by the caller.
            except Exception as e:
                out.append(e)
        return out
    offs = np.cumsum([0] + [len(rows) for rows in floats])
    return [Xb[offs[i]:offs[i + 1]] for i in range(len(floats))]


def dispatch_batch(model, batch, queue_depth: int, stats,
                   observer=None) -> list:
    """Score ONE admitted micro-batch against `model` and deliver every
    result or error; shared by ServeEngine._dispatch and the fleet's
    per-model dispatch. The caller read the model reference once, so
    every request in the batch is scored by exactly this version. Returns
    the per-request latencies (ms) of the delivered requests (the fleet's
    SLO tracker reads them).

    Raw float requests are binned here, under the model that scores them
    (binning at submit could pair model A's bins with model B's trees
    across a swap): each is cast to f32 by itself, exactly as
    mapper.transform casts it (so an int64 block beside a float64 one is
    rounded once, as alone), and the batch is binned once on the device
    (_bin_batch). Width, cast and binning failures are per request: a bad
    submission fails its own waiter, never the valid requests beside it.

    `observer(Xb, scores, lats)` (the drift / shadow seam, serve/drift.py)
    runs after every waiter has its result, so it adds nothing ahead of
    the responses, and a failure inside it is contained. It sees the
    batch as scored: the concatenated binned rows (on the device where
    they were binned or uploaded, else the host block), never the
    bucket's padding, and this model's scores.

    Trace marks ride the requests' own `marks` on the batcher's clock
    (None with request traces off); the completed breakdowns land in the
    stats ring before any waiter wakes."""
    clk = None
    for r in batch:
        if r.marks is not None:
            clk = r.marks["_clock"]
            break
    if clk is not None:
        t = clk()
        for r in batch:
            if r.marks is not None:
                r.marks["gate"] = t
    good, blocks = [], []
    floats, float_at = [], []       # f32 rows, and their slots in blocks
    for r in batch:
        # Width against the model actually scoring (submit-time checks saw
        # the pre-swap model).
        if r.rows.shape[1] != model.n_features:
            r.set_error(ValueError(
                f"rows have {r.rows.shape[1]} features; the "
                f"serving model expects {model.n_features}"))
            continue
        if r.rows.dtype == np.uint8:
            good.append(r)
            blocks.append(r.rows)
            continue
        try:
            floats.append(np.asarray(r.rows, np.float32))
        except Exception as e:          # this request's waiter only
            r.set_error(e)
            continue
        float_at.append(len(good))
        good.append(r)
        blocks.append(None)
    if floats:
        for i, Xb in zip(float_at, _bin_batch(model, floats)):
            if isinstance(Xb, Exception):
                good[i].set_error(Xb)
                good[i] = None
            blocks[i] = Xb
        keep = [i for i, r in enumerate(good) if r is not None]
        good = [good[i] for i in keep]
        blocks = [blocks[i] for i in keep]
    if not good:
        return []
    Xb = blocks[0] if len(blocks) == 1 else torch.cat(
        [model.backend.device_rows(b) for b in blocks])
    if clk is not None:
        t = clk()
        for r in good:
            if r.marks is not None:
                r.marks["device"] = t
    scores = model.score_binned(Xb)
    done = time.perf_counter()
    if clk is not None:
        t = clk()
        for r in good:
            if r.marks is not None:
                r.marks["done"] = t
    lats = [(done - r.t_submit) * 1e3 for r in good]
    express = good[0].express
    traces = None
    if clk is not None:
        t = clk()
        traces = []
        for r in good:
            if r.marks is None:
                continue
            r.marks["wake"] = t
            traces.append({"trace_id": r.trace_id, "rows": r.n,
                           "express": r.express, **trace_breakdown(r)})
    # Stats land before any waiter wakes: a caller that reads the window
    # as soon as result() returns finds its own batch in it.
    tele_counters.record_serve_requests(len(good))
    tele_counters.record_serve_batch()
    if express:
        tele_counters.record_serve_express()
    stats.record_batch(len(good), queue_depth, lats, express=express,
                       traces=traces)
    off = 0
    for req in good:
        # Attribution before the result event fires.
        req.model_token = model.token
        req.set_result(scores[off:off + req.n])
        off += req.n
    if observer is not None:
        try:
            observer(Xb, scores, lats)
        # Best effort by contract: an observer never takes the dispatcher
        # down nor touches the delivered results.
        except Exception:
            log.exception("dispatch observer failed")
    return lats


class ServeEngine:
    """The scoring process's core, transport-agnostic (the HTTP front end,
    the CLI and the tests drive this same object).

    Request path: submit -> admission batch (MicroBatcher) -> one dispatch
    against the model reference read at batch start -> scatter ->
    per-request latency recorded. Model path: `swap(bundle)` builds and
    warms the new ServableModel off the request path, then publishes the
    reference (in-flight batches keep the version they started with)."""

    def __init__(self, bundle, cfg: TrainConfig | None = None, *,
                 backend=None, max_wait_ms: float = 1.0,
                 max_batch: int = 256, quantize=None, raw: bool = False,
                 run_log=None, express_lane: bool = True,
                 model_name: "str | None" = None,
                 request_traces: bool = True):
        self.cfg = cfg if cfg is not None else TrainConfig()
        # Optional identity: when set, serve_latency windows, hot_swap
        # events and health() carry the model_name dimension.
        self.model_name = model_name
        self.quantize_tier = normalize_quantize(quantize)
        want_impl = TIER_IMPL.get(self.quantize_tier)
        if want_impl is not None and self.cfg.predict_impl != want_impl:
            # quantize= is the tier opt-in: the backend's dispatch and the
            # engine's error-bound reporting must agree.
            self.cfg = self.cfg.replace(predict_impl=want_impl)
        self.backend = backend if backend is not None \
            else get_backend(self.cfg)
        self.buckets = default_buckets(max_batch)
        self.quantize = self.quantize_tier is not None
        self.raw = bool(raw)
        self.express_lane = bool(express_lane)
        self.stats = ServeStats()
        self.run_log = RunLog.coerce(run_log)
        # Registry root for swaps by reference (`cli serve --registry`
        # sets it; serve/http.py resolves the reference).
        self.registry_root: "str | None" = None
        self.request_traces = bool(request_traces)
        self._swap_lock = threading.Lock()
        self._model = self._build(bundle)
        self._batcher = MicroBatcher(self._dispatch,
                                     max_wait_ms=max_wait_ms,
                                     max_batch=max_batch,
                                     request_traces=self.request_traces)

    # ------------------------------------------------------------------ #
    # model lifecycle
    # ------------------------------------------------------------------ #

    def _build(self, bundle) -> ServableModel:
        if isinstance(bundle, ServableModel):
            bundle.warmup()
            return bundle
        m = ServableModel(bundle, self.backend,
                          quantize=self.quantize_tier,
                          buckets=self.buckets, raw=self.raw)
        m.warmup()
        return m

    @property
    def model_token(self) -> str:
        return self._model.token

    @property
    def n_features(self) -> int:
        """Feature width of the currently served model (the raw wire
        path derives the row count from it)."""
        return self._model.n_features

    def swap(self, bundle) -> dict:
        """Zero-downtime hot swap: build and warm the new version off the
        request path, then publish it with one reference store. Counts a
        hot swap and emits its `fault kind=hot_swap` event. Returns {old,
        new} tokens."""
        with self._swap_lock:               # serialize concurrent swaps
            new = self._build(bundle)
            old = self._model.token
            old_digest = self._model.artifact_digest
            # Readers (_dispatch, health, the express lane) take one
            # unlocked read and see the old or the new model, never a mix.
            self._model = new  # ddtlint: atomic-publish
        tele_counters.record_serve_hot_swap()
        if self.run_log is not None:
            extra = ({"model_name": self.model_name}
                     if self.model_name is not None else {})
            self.run_log.emit("fault", kind="hot_swap", old=old,
                              new=new.token, old_artifact=old_digest,
                              new_artifact=new.artifact_digest, **extra)
        log.info("hot-swapped model %s -> %s", old[:12], new.token[:12])
        return {"old": old, "new": new.token}

    # ------------------------------------------------------------------ #
    # request path
    # ------------------------------------------------------------------ #

    def predict_async(self, rows: np.ndarray,
                      trace_id: "str | None" = None) -> PendingRequest:
        rows = coerce_rows(rows)
        if rows.shape[1] != self._model.n_features:
            raise ValueError(
                f"rows have {rows.shape[1]} features; the served model "
                f"expects {self._model.n_features}")
        if self.express_lane and rows.shape[0] == 1:
            # Express lane: at an empty queue with no batch mid-dispatch,
            # a single row scores here on the caller's thread; under load
            # express() returns None and the request coalesces.
            req = self._batcher.express(rows, 1, trace_id=trace_id)
            if req is not None:
                return req
        return self._batcher.submit(rows, rows.shape[0],
                                    trace_id=trace_id)

    def predict(self, rows: np.ndarray, timeout: float | None = 30.0):
        return self.predict_async(rows).result(timeout)

    def _dispatch(self, batch, queue_depth: int) -> None:
        # One model reference per micro-batch (hot-swap atomicity).
        model = self._model
        dispatch_batch(model, batch, queue_depth, self.stats)

    # ------------------------------------------------------------------ #
    # telemetry
    # ------------------------------------------------------------------ #

    def emit_latency(self, reset: bool = True) -> dict | None:
        """Emit the current window as a `serve_latency` run-log event;
        returns the payload (None when the window is empty: an idle
        server emits nothing)."""
        summary = self.stats.window_summary(reset=reset)
        if summary["requests"] == 0:
            return None
        m = self._model
        summary["model_token"] = m.token
        if self.model_name is not None:
            summary["model_name"] = self.model_name
        summary["predict_impl"] = m.predict_impl
        if m.artifact_digest is not None:
            summary["artifact_digest"] = m.artifact_digest
        if self.run_log is not None:
            self.run_log.emit("serve_latency", **summary)
        return summary

    def debug_traces(self) -> dict:
        """model name -> completed-trace ring (GET /debug/requests); an
        anonymous engine keys on "default"."""
        return {self.model_name or "default":
                self.stats.traces_snapshot()}

    def flush_traces(self, reason: str = "on_demand") -> int:
        """Flush the trace ring into the run log as one `serve_trace`
        event; returns the number of traces flushed (0, and nothing
        emitted, on an empty ring or without a run log)."""
        traces = self.stats.traces_snapshot()
        if not traces or self.run_log is None:
            return 0
        extra = ({"model_name": self.model_name}
                 if self.model_name is not None else {})
        self.run_log.emit("serve_trace", traces=traces, count=len(traces),
                          model_token=self._model.token, reason=reason,
                          **extra)
        return len(traces)

    def metrics_snapshot(self) -> dict:
        """Live, non-resetting state for `/metrics` (serve/metrics.py
        renders it): the latency histogram on the fixed ladder and the
        live backlog. Read-only."""
        return {
            "models": {self.model_name or "default": {
                "hist": self.stats.metrics_state(),
                "backlog_rows": self._batcher.backlog_rows(),
                "slo": None,
            }},
            "resident_models": 1,
            "max_resident": None,
        }

    def health(self) -> dict:
        m = self._model
        return {
            "ok": True,
            "model_name": self.model_name,
            "model_token": m.token,
            "quantized": m.quantized,
            "quantize_tier": m.quantize_tier,
            "predict_impl": m.predict_impl,
            "lut_max_abs_err": m.max_abs_err,
            "buckets": list(self.buckets),
            "express_lane": self.express_lane,
            "artifact_digest": m.artifact_digest,
            "aot": m.aot,
            **self.stats.snapshot(),
        }

    def close(self) -> None:
        self._batcher.close()
        self.emit_latency(reset=True)
        if self.run_log is not None:
            self.run_log.close()
