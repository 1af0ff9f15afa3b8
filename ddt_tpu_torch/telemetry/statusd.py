"""The training operations plane: a live, read-only status daemon
(`cli train --status-port N`; port of ddt_tpu/telemetry/statusd.py).

A daemon thread serves three endpoints off a `TrainStatus` aggregate the
trainer updates at round boundaries:

- ``GET /healthz``       run_id, round i/N with phase, rolling-window
  rows/s and ETA, last checkpoint round + age, fault counters, host peak
  RSS and the card's memory high-water mark;
- ``GET /metrics``       Prometheus text exposition (the shared dialect,
  telemetry/exposition.py): every process counter as
  ``ddt_<name>_total``, plus the train-plane gauges
  (``ddt_train_rows_per_s``, ``ddt_train_round``/``_total_rounds``,
  ``ddt_train_checkpoint_age_seconds``) and the histogram all-reduce
  byte estimate as ``ddt_hist_allreduce_bytes_total``;
- ``GET /debug/rounds``  a ring of recent round records.

Read-only: a scrape never resets a window, emits no run-log event and
mutates no counter, so scrapers and the trainer interleave freely.

Without `--status-port` the trainer never imports this module and holds
no TrainStatus; every round-boundary hook is one `is not None` test.

Threads: the trainer writes through `begin_run` / `round_end` /
`checkpoint_saved`, the handler threads read through `healthz` /
`metrics_text` / `rounds_ring`; every access to mutable state holds
`TrainStatus._lock`, and the critical sections are arithmetic only, so a
scrape never stalls a round.
"""

from __future__ import annotations

import collections
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ddt_tpu_torch.telemetry import counters as tele_counters
from ddt_tpu_torch.telemetry.exposition import (EXPOSITION_CONTENT_TYPE,
                                                _num, render_counters)

log = logging.getLogger("ddt_tpu_torch.statusd")

#: /debug/rounds ring capacity (mirrors serve's /debug/requests ring).
RING_ROUNDS = 256
#: rolling window (rounds) for the rows/s and ETA estimates — wide
#: enough to smooth per-round jitter, narrow enough to track a regime
#: change (e.g. a repartition) within a few checkpoints.
RATE_WINDOW = 32


class TrainStatus:
    """Shared run-progress aggregate between the trainer thread and the
    daemon's handler threads. All mutable state behind one lock; every
    method is O(window) arithmetic at most."""

    def __init__(self, ring: int = RING_ROUNDS,
                 window: int = RATE_WINDOW):
        self._lock = threading.Lock()
        self._run_id = None
        self._phase = "init"
        self._total_rounds = None
        self._rows = None
        self._rounds_done = 0
        self._round_ms = collections.deque(maxlen=window)
        self._ring = collections.deque(maxlen=ring)
        self._checkpoint_round = None
        self._checkpoint_t = None
        self._t_start = time.time()

    # -- trainer-side hooks (one call per boundary) ------------------- #
    def begin_run(self, run_id=None, total_rounds=None, rows=None,
                  phase: str = "train") -> None:
        """Stamp run identity once the trainer has derived it (a restart
        into the same status object resets the progress window)."""
        with self._lock:
            self._run_id = run_id
            self._total_rounds = total_rounds
            self._rows = rows
            self._phase = phase
            self._rounds_done = 0
            self._round_ms.clear()
            self._t_start = time.time()

    def set_phase(self, phase: str) -> None:
        with self._lock:
            self._phase = phase

    def round_end(self, rnd: int, ms: float, record=None) -> None:
        """One completed round: `rnd` 0-based, `ms` host wall time,
        `record` the round-record dict (RoundRecorder.make_record shape)
        for the /debug/rounds ring."""
        with self._lock:
            self._rounds_done = max(self._rounds_done, rnd + 1)
            self._round_ms.append(float(ms))
            if record is not None:
                self._ring.append(record)

    def checkpoint_saved(self, rnd: int) -> None:
        """`rnd` is the 1-based round count the checkpoint covers."""
        with self._lock:
            self._checkpoint_round = rnd
            self._checkpoint_t = time.time()

    # -- scrape-side (read-only) -------------------------------------- #
    def _progress_locked(self) -> dict:
        """Lock-held snapshot of the trainer-owned state; derived rates
        computed here so both /healthz and /metrics agree."""
        window_ms = sum(self._round_ms)
        n_window = len(self._round_ms)
        ms_per_round = window_ms / n_window if n_window else None
        rows_per_s = None
        if ms_per_round and self._rows:
            rows_per_s = self._rows / (ms_per_round / 1e3)
        eta_s = None
        if ms_per_round is not None and self._total_rounds is not None:
            left = max(0, self._total_rounds - self._rounds_done)
            eta_s = round(left * ms_per_round / 1e3, 3)
        return {
            "run_id": self._run_id,
            "phase": self._phase,
            "round": self._rounds_done,
            "total_rounds": self._total_rounds,
            "rows": self._rows,
            "ms_per_round": (round(ms_per_round, 3)
                             if ms_per_round is not None else None),
            "rows_per_s": (round(rows_per_s, 1)
                           if rows_per_s is not None else None),
            "eta_s": eta_s,
            "uptime_s": round(time.time() - self._t_start, 3),
            "last_checkpoint_round": self._checkpoint_round,
            "checkpoint_age_s": (
                round(time.time() - self._checkpoint_t, 3)
                if self._checkpoint_t is not None else None),
        }

    def healthz(self) -> dict:
        """The /healthz body. Process counters and memory watermarks are
        read OUTSIDE the lock — they are module-level monotone state
        with no ordering contract against the round window."""
        with self._lock:
            out = self._progress_locked()
        c = tele_counters.snapshot()
        out["counters"] = {
            "train_rounds": c.get("train_rounds", 0),
            "train_heartbeats": c.get("train_heartbeats", 0),
            "fault_retries": c.get("fault_retries", 0),
            "hist_oom_degrades": c.get("hist_oom_degrades", 0),
            "jit_compiles": c.get("jit_compiles", 0),
        }
        out["host_peak_rss_bytes"] = tele_counters.host_peak_rss_bytes()
        out["device_peak_bytes"] = tele_counters.device_peak_bytes()
        return out

    def metrics_text(self) -> str:
        """The /metrics body (shared exposition dialect). Counter series
        come straight from the process counter snapshot; the train-plane
        gauges from the progress window. Gauges without a value yet are
        OMITTED, not rendered as 0 — a 0 rate is a claim, not an
        absence (the serve-tier convention)."""
        with self._lock:
            p = self._progress_locked()
        c = tele_counters.snapshot()
        out = render_counters(c)
        # The hist all-reduce payload estimate under its paper-facing
        # name: an alias of collective_bytes_est, the counter the
        # histogram collectives already maintain.
        out.append("# TYPE ddt_hist_allreduce_bytes_total counter")
        out.append("ddt_hist_allreduce_bytes_total "
                   f"{_num(c.get('collective_bytes_est', 0))}")
        out.append("# TYPE ddt_train_round gauge")
        out.append(f"ddt_train_round {_num(p['round'])}")
        if p["total_rounds"] is not None:
            out.append("# TYPE ddt_train_total_rounds gauge")
            out.append(f"ddt_train_total_rounds {_num(p['total_rounds'])}")
        if p["rows_per_s"] is not None:
            out.append("# TYPE ddt_train_rows_per_s gauge")
            out.append(f"ddt_train_rows_per_s {_num(p['rows_per_s'])}")
        if p["checkpoint_age_s"] is not None:
            out.append("# TYPE ddt_train_checkpoint_age_seconds gauge")
            out.append("ddt_train_checkpoint_age_seconds "
                       f"{_num(p['checkpoint_age_s'])}")
        out.append("# TYPE ddt_host_peak_rss_bytes gauge")
        out.append("ddt_host_peak_rss_bytes "
                   f"{_num(tele_counters.host_peak_rss_bytes())}")
        dev = tele_counters.device_peak_bytes()
        if dev is not None:
            out.append("# TYPE ddt_device_peak_bytes gauge")
            out.append(f"ddt_device_peak_bytes {_num(dev)}")
        return "\n".join(out) + "\n"

    def rounds_ring(self) -> "list[dict]":
        """The /debug/rounds body: recent round records, oldest first."""
        with self._lock:
            return list(self._ring)


def _make_handler(status: TrainStatus):
    """Handler class closed over the status aggregate (the serve/http.py
    pattern — no globals, several daemons can coexist in one process,
    e.g. tests)."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        server_version = "ddt-statusd"

        def log_message(self, fmt, *args):   # stdlib logs to stderr
            log.debug("statusd: " + fmt, *args)

        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_text(self, code: int, text: str) -> None:
            body = text.encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", EXPOSITION_CONTENT_TYPE)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.split("?", 1)[0]
            if path == "/healthz":
                self._send(200, status.healthz())
            elif path == "/metrics":
                # Read-only: formats snapshots, never emits events,
                # never resets a window.
                self._send_text(200, status.metrics_text())
            elif path == "/debug/rounds":
                ring = status.rounds_ring()
                self._send(200, {"rounds": ring, "n": len(ring)})
            else:
                self._send(404, {"error": f"no route {path}",
                                 "routes": ["/healthz", "/metrics",
                                            "/debug/rounds"]})

    return Handler


class _Server(ThreadingHTTPServer):
    # Identical posture to the serve tier's adapter: handler threads are
    # daemons (a hung scraper cannot block trainer exit), modest listen
    # backlog (this is an ops endpoint, not a traffic port).
    daemon_threads = True
    request_queue_size = 128
    allow_reuse_address = True


class StatusDaemon:
    """Owns the HTTP server and its serving thread. The socket is bound
    in the CALLER's thread, so `port` is final (and an ephemeral port=0
    is resolved) before start() returns — the CLI prints it in the boot
    line a scraper reads."""

    def __init__(self, status: TrainStatus, host: str = "127.0.0.1",
                 port: int = 0):
        self.status = status
        self._server = _Server((host, port), _make_handler(status))
        self.host = host
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._serve, name="ddt-statusd", daemon=True)

    def start(self) -> "StatusDaemon":
        self._thread.start()
        return self

    def _serve(self) -> None:
        try:
            self._server.serve_forever(poll_interval=0.05)
        finally:
            self._server.server_close()

    def close(self) -> None:
        """Idempotent shutdown; joins the serving thread."""
        self._server.shutdown()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)


def start_statusd(status: TrainStatus, host: str = "127.0.0.1",
                  port: int = 0) -> StatusDaemon:
    """Bind + start the daemon thread; returns the handle (`.port` holds
    the bound port even for port=0)."""
    return StatusDaemon(status, host=host, port=port).start()
