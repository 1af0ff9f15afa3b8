"""Stdlib HTTP front end of the port's serving plane (port of
ddt_tpu/serve/http.py: `serve_forever`, `decode_raw_rows`, `_swap`,
`_models_post` and the handler, with the same endpoints, status codes and
structured error bodies).

http.server + json only: one thread per connection, each handler thread a
submitter into the engine's admission queue, so concurrent HTTP requests
coalesce into micro-batches like library callers.

Endpoints (JSON unless noted):

- POST /predict   {"rows": [[...], ...], "binned": false}
                  -> {"scores": [...], "model": token}
- POST /predict?binned=raw   the body is the uint8 row block
                  (application/octet-stream; Content-Length = n_rows x
                  n_features required): no JSON, no float parsing, one
                  host-to-device copy of the bytes (decode_raw_rows); a
                  body that is not a whole number of rows is a 400.
- POST /swap      {"model": "/path/to/model.npz"}, or a registry
                  reference ("name@version" | "name@tag" | digest) when
                  the server runs with `cli serve --registry`
                  -> {"old": token, "new": token}
- GET  /healthz   engine.health()
- GET  /stats     the current latency window; "?emit=1" also emits it as
                  a `serve_latency` event and resets it
- GET  /metrics   Prometheus text (serve/metrics.py), read-only
- GET  /debug/requests   {"models": {name: [trace records]}}; "?emit=1"
                  also flushes the rings as `serve_trace` events
- GET  /debug/drift   (fleets) drift windows, per-feature attribution
                  and the shadow comparison
- POST /shutdown  drains and stops the server

Every /predict response carries `X-DDT-Trace-Id` (the client's header is
honoured, else a minted id) and `X-DDT-Timing` (handler, queue, gate,
device, wake, total in ms); with request traces off a client id is still
echoed.

Fleet servers (`cli serve --models/--fleet-config`) add routing by path
(POST /models/<name>/predict, binned=raw included) or by the
`X-DDT-Model` header, GET /models, POST /models {"action": "add" |
"remove" | "retag", ...}, GET /models/<name>/stats. An unknown model is a
structured 404 ({"error", "model", "models"}), a model whose reload
fails a structured 503 ({"error", "model", "reason"}); /swap on a fleet
is a 400 pointing at POST /models.

Model files are loaded here, on handler threads, never in the engine's
dispatch loop.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ddt_tpu_torch.serve.batcher import ShuttingDown, trace_breakdown
from ddt_tpu_torch.serve.engine import normalize_quantize
from ddt_tpu_torch.serve.fleet import (ModelUnavailableError,
                                       UnknownModelError)
from ddt_tpu_torch.serve.metrics import render_metrics
from ddt_tpu_torch.telemetry import counters as tele_counters
from ddt_tpu_torch.telemetry.exposition import EXPOSITION_CONTENT_TYPE

log = logging.getLogger("ddt_tpu_torch.serve.http")

#: request header that routes a /predict to a fleet model (the URL
#: path form is /models/<name>/predict — both work, binned=raw
#: included).
MODEL_HEADER = "X-DDT-Model"

#: trace propagation headers (module doc): the id rides the request in
#: and the response out; the timing breakdown rides the response only.
TRACE_HEADER = "X-DDT-Trace-Id"
TIMING_HEADER = "X-DDT-Timing"

#: X-DDT-Timing segment order (the trace_breakdown keys, ms suffix
#: stripped on the wire: handler=0.012,queue=1.403,...,total=4.791).
_TIMING_KEYS = ("handler_ms", "queue_ms", "gate_ms", "device_ms",
                "wake_ms", "total_ms")


def format_timing(breakdown: "dict | None") -> "str | None":
    """trace_breakdown dict -> the X-DDT-Timing header value."""
    if breakdown is None:
        return None
    return ",".join(f"{k[:-3]}={breakdown[k]}" for k in _TIMING_KEYS)


def _swap(engine, ref: str) -> dict:
    """Resolve a /swap target (a model file on disk, or, when the engine
    carries a registry root, a registry reference), build and warm the
    new model on this handler thread, and publish it. An existing file
    always wins; anything else needs `--registry`, so a mistyped path
    fails loudly instead of being treated as a model name."""
    if os.path.exists(ref):
        from ddt_tpu_torch import api

        return engine.swap(api.load_model(ref))
    registry_root = getattr(engine, "registry_root", None)
    if registry_root is None:
        raise ValueError(
            f"{ref!r} is not a file, and this server was started "
            "without --registry so registry references cannot resolve")
    from ddt_tpu_torch.registry import loader as reg_loader

    # The engine's serving mode wins: a quantized server stays on its
    # tier (an artifact without it -> a loud 400), an f32 server serves
    # the f32 variant even from a quantized artifact.
    report = reg_loader.load_servable(
        registry_root, ref,
        quantize=engine.quantize_tier if engine.quantize else False,
        raw=engine.raw, backend=engine.backend,
        run_log=engine.run_log)
    out = engine.swap(report.model)
    out["artifact_digest"] = report.digest
    out["mode"] = report.mode
    return out


def decode_raw_rows(body, n_features: int,
                    declared_len: "int | None") -> np.ndarray:
    """`binned=raw` wire decode: the body is the uint8 row block.

    Zero-copy: np.frombuffer wraps the received buffer and the reshape
    is a view, so the array handed to the engine is the wire buffer
    itself, and the batch reaches the card in one host-to-device copy of
    n x F bytes. The handler reads the body into a bytearray, so the
    view is writable and `torch.from_numpy` takes it without a copy or a
    warning. The checks are O(1): Content-Length must be declared and
    match what arrived (a truncated body must not become fewer rows),
    and the byte count must be a whole number of `n_features`-wide rows
    (a width mismatch is a 400, never a silent reshape). Bin ids are in
    [0, 255] by construction."""
    if declared_len is None:
        raise ValueError(
            "binned=raw requires a Content-Length header (the row "
            "block is validated against it before it touches the "
            "engine)")
    if len(body) != declared_len:
        raise ValueError(
            f"binned=raw body is {len(body)} bytes but Content-Length "
            f"declared {declared_len}")
    if len(body) == 0:
        raise ValueError("binned=raw body is empty")
    if len(body) % n_features:
        raise ValueError(
            f"binned=raw body of {len(body)} bytes is not a whole "
            f"number of {n_features}-feature rows")
    return np.frombuffer(body, dtype=np.uint8).reshape(-1, n_features)


def _read_body(rfile, n: int) -> bytearray:
    """Up to `n` body bytes into a writable buffer (fewer only when the
    client closes early; decode_raw_rows then refuses the length)."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = rfile.readinto(view[got:])
        if not k:
            break
        got += k
    view.release()
    if got < n:
        del buf[got:]
    return buf


def _models_post(engine, req: dict) -> dict:
    """POST /models control plane (fleet servers only): add / remove /
    retag without restart. The spec coercion reuses the fleet-config
    grammar, so the wire and the config file cannot drift."""
    from ddt_tpu_torch.serve import control as fleet_control

    action = req.get("action")
    if action == "add":
        d = {k: v for k, v in req.items() if k != "action"}
        return engine.add_model(
            fleet_control.coerce_spec(d, "POST /models add"))
    if action == "remove":
        if "name" not in req:
            raise ValueError("POST /models remove needs a 'name'")
        return engine.remove_model(req["name"])
    if action == "retag":
        if "name" not in req or "ref" not in req:
            raise ValueError(
                "POST /models retag needs 'name' and 'ref' (the new "
                "registry reference the model should serve)")
        spec = dataclasses.replace(engine.spec_for(req["name"]),
                                   ref=str(req["ref"]))
        if "tier" in req:
            spec = dataclasses.replace(
                spec, tier=normalize_quantize(req["tier"]))
        return engine.retag(req["name"], spec)
    raise ValueError(
        f"POST /models: unknown action {action!r} (expected add, "
        "remove, or retag)")


def _unknown_model_body(e: UnknownModelError) -> dict:
    """The ONE structured 404 body for an unaddressable model (shared
    by the GET and POST error boundaries — the two surfaces cannot
    drift)."""
    return {"error": str(e), "model": e.name, "models": e.known}


def _make_handler(engine, server_box: dict):
    fleet = bool(getattr(engine, "fleet", False))

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):   # route through logging
            log.debug("%s " + fmt, self.address_string(), *args)

        def _send(self, code: int, payload: dict,
                  headers: "dict | None" = None) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _send_text(self, code: int, text: str) -> None:
            body = text.encode()
            self.send_response(code)
            self.send_header("Content-Type", EXPOSITION_CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(n) if n else b"{}"
            return json.loads(raw or b"{}")

        def _route_model(self) -> "tuple[str, str | None]":
            """Split the URL into (root path, routed model name):
            `/models/<name>/predict` routes by path, anything else by
            the X-DDT-Model header (None = unrouted). A routed request
            against a single-model server is a structured 404 (the
            fleet surface does not exist there), never a bare 500."""
            path = self.path.split("?", 1)[0]
            name = self.headers.get(MODEL_HEADER)
            if path.startswith("/models/"):
                parts = path.split("/", 3)
                if len(parts) == 4:
                    name = parts[2]
                    path = "/" + parts[3]
            if name is not None and not fleet:
                raise UnknownModelError(name, [])
            return path, name

        def do_GET(self):
            try:
                path, name = self._route_model()
                if path == "/healthz":
                    return self._send(200, engine.health())
                if path == "/metrics":
                    # Read-only by contract: both snapshot calls only
                    # READ (counters.snapshot copies, metrics_snapshot
                    # renders live state) — no window reset, no emit.
                    return self._send_text(200, render_metrics(
                        tele_counters.snapshot(),
                        engine.metrics_snapshot()))
                if path == "/debug/requests":
                    out = {"models": engine.debug_traces()}
                    if "emit=1" in self.path:
                        out["flushed"] = engine.flush_traces(
                            reason="on_demand")
                    return self._send(200, out)
                if path == "/debug/drift" and fleet:
                    # Handler thread: debug_drift flushes any pending
                    # drift events on the way (file I/O lives here,
                    # never on the dispatcher).
                    return self._send(200, engine.debug_drift())
                if path == "/models" and fleet:
                    return self._send(200, {"models": engine.models()})
                if path == "/stats":
                    emit = "emit=1" in self.path
                    if fleet:
                        if name is not None:
                            # Unknown names are the same structured
                            # 404 as /predict — a monitoring typo must
                            # not read healthy zeros forever.
                            engine.spec_for(name)
                        if emit:
                            # Per-model emit resets ONLY that model's
                            # window (`only=`); the unrouted form
                            # emits every model.
                            out = engine.emit_latency(reset=True,
                                                      only=name)
                        else:
                            out = engine.window_summaries(reset=False)
                        if name is not None:
                            out = out.get(name) or {"requests": 0,
                                                    "model_name": name}
                        return self._send(200, out)
                    if emit:
                        out = engine.emit_latency(reset=True) or {
                            "requests": 0}
                    else:
                        out = engine.stats.window_summary(reset=False)
                    return self._send(200, out)
                return self._send(404,
                                  {"error": f"no route {self.path}"})
            except UnknownModelError as e:
                return self._send(404, _unknown_model_body(e))

        def do_POST(self):
            try:
                path, name = self._route_model()
                if path == "/predict":
                    qs = self.path.partition("?")[2]
                    ctype = self.headers.get("Content-Type", "")
                    if ("binned=raw" in qs.split("&")
                            or ctype.startswith(
                                "application/octet-stream")):
                        # Zero-copy binned wire path (module doc): the
                        # body bytes become the row array directly —
                        # width derived from the routed model (a swap
                        # race is caught again at dispatch, like every
                        # other request). On a fleet this may reload an
                        # evicted model HERE, on the handler thread —
                        # never the dispatcher's.
                        n = self.headers.get("Content-Length")
                        declared = int(n) if n is not None else None
                        if declared is not None and declared < 0:
                            # read(-1) would block to EOF on a
                            # keep-alive socket — reject before reading.
                            raise ValueError(
                                "binned=raw Content-Length must be "
                                f">= 0, got {declared}")
                        body = _read_body(self.rfile, declared or 0)
                        width = (engine.n_features_for(name) if fleet
                                 else engine.n_features)
                        rows = decode_raw_rows(body, width, declared)
                    else:
                        req = self._body()
                        rows = np.asarray(req["rows"])
                        if req.get("binned"):
                            # astype(uint8) would silently WRAP
                            # out-of-range ids (300 -> 44) and truncate
                            # floats — fail the contract violation
                            # loudly like every other malformed input
                            # in this handler.
                            if rows.dtype.kind not in "iu" or (
                                    rows.size and (int(rows.min()) < 0
                                                   or int(rows.max())
                                                   > 255)):
                                raise ValueError(
                                    "binned rows must be integer bin "
                                    "ids in 0..255")
                            rows = rows.astype(np.uint8)
                    # The dispatcher stamps the token of the model that
                    # ACTUALLY scored the batch — reading engine.
                    # model_token here instead races the hot swap and
                    # mis-attributes responses that straddle it.
                    trace_id = self.headers.get(TRACE_HEADER)
                    if fleet:
                        pending = engine.predict_async(
                            rows, model=name, trace_id=trace_id)
                    else:
                        pending = engine.predict_async(
                            rows, trace_id=trace_id)
                    scores = pending.result(30.0)
                    headers = {}
                    if pending.trace_id is not None:
                        headers[TRACE_HEADER] = pending.trace_id
                        timing = format_timing(trace_breakdown(pending))
                        if timing is not None:
                            headers[TIMING_HEADER] = timing
                    return self._send(200, {
                        "scores": np.asarray(scores).tolist(),
                        "model": pending.model_token},
                        headers=headers)
                if path == "/models" and fleet:
                    return self._send(200,
                                      _models_post(engine, self._body()))
                if path == "/swap":
                    if fleet:
                        raise ValueError(
                            "fleet servers manage models via POST "
                            "/models (action add/remove/retag), not "
                            "/swap")
                    req = self._body()
                    return self._send(200, _swap(engine, req["model"]))
                if path == "/shutdown":
                    self._send(200, {"ok": True})
                    threading.Thread(
                        target=server_box["server"].shutdown,
                        daemon=True).start()
                    return None
                return self._send(404, {"error": f"no route {self.path}"})
            # The handler IS the error boundary: every failure must
            # become a JSON response on the open connection, never an
            # unwound handler (= connection reset with no body). Order
            # matters: TimeoutError is an OSError subclass, and the
            # fleet routing errors subclass KeyError/RuntimeError — the
            # structured 404/503 bodies must win over the generic
            # 400/500 (an unknown or evicted-and-reload-failing model is
            # an addressed, machine-readable refusal, not a bare 500).
            except TimeoutError as e:
                return self._send(504, {"error": f"{type(e).__name__}: "
                                                 f"{e}"})
            except ShuttingDown as e:
                return self._send(503, {"error": f"{type(e).__name__}: "
                                                 f"{e}"})
            except UnknownModelError as e:
                return self._send(404, _unknown_model_body(e))
            except ModelUnavailableError as e:
                return self._send(503, {
                    "error": str(e), "model": e.name,
                    "reason": e.reason})
            except (KeyError, ValueError, TypeError, OSError) as e:
                return self._send(400, {"error": f"{type(e).__name__}: "
                                                 f"{e}"})
            # Dispatch-delivered failures (a scoring error re-raised by
            # result()) can be anything; surfaced as 500, re-raising
            # would just tear the connection down bodyless.
            except Exception as e:
                return self._send(500, {"error": f"{type(e).__name__}: "
                                                 f"{e}"})

    return Handler


def serve_forever(engine, host: str = "127.0.0.1", port: int = 8199,
                  ready_event: "threading.Event | None" = None) -> int:
    """Run the HTTP front end until /shutdown (or KeyboardInterrupt);
    returns the bound port (port=0 takes an ephemeral one, published as
    `engine.http_port`). `ready_event` is set once the socket listens."""
    box: dict = {}

    class _Server(ThreadingHTTPServer):
        # The default socketserver backlog (5) resets connections under
        # exactly the burst concurrency admission batching exists for: a
        # storm of clients must queue at the socket, not fail.
        request_queue_size = 128
        daemon_threads = True

    server = _Server((host, port), _make_handler(engine, box))
    box["server"] = server
    bound = server.server_address[1]
    # Published before ready_event fires, so a launcher thread learns an
    # ephemeral (port=0) binding without racing the blocking loop.
    engine.http_port = bound
    if getattr(engine, "fleet", False):
        log.info("serving fleet on %s:%d (%d model(s))", host, bound,
                 len(engine.models()))
    else:
        log.info("serving on %s:%d (model %s)", host, bound,
                 engine.model_token[:12])
    if ready_event is not None:
        ready_event.set()
    try:
        server.serve_forever(poll_interval=0.05)
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        engine.close()
    return bound
