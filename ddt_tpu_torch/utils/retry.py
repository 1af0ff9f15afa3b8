"""Jittered exponential backoff with a deadline, for host-loss-prone seams
(port of ddt_tpu/utils/retry.py, copied).

The seams this wraps (stream chunk read, checkpoint save/load, multihost
bootstrap, the per-tree D2H fetch) share one failure shape: a transient
environmental fault — NFS blip, preempted peer, tunnel reset — that a
second attempt moments later survives. The engine is deliberately dumb:
classify (is_transient), back off exponentially with DETERMINISTICALLY
seeded jitter (no wall-clock entropy — chaos runs must replay), respect
a wall-clock deadline, and tell the run log about every attempt
(schema'd `fault` events kind="retry" through the robustness fault
sink, plus the `fault_retries` counter), so recovery is attributable,
never silent.

Hot-path discipline: the FIRST attempt is an inline call inside a bare
try — the no-fault path pays one frame and no allocation, and everything
slower lives in `_backoff_loop`, which the zero-overhead guard test
explodes to prove a clean run never enters it (the telemetry
disabled-path bar).

Clock and sleep are injectable for the fake-clock unit tests
(tests/test_torch_robustness.py: deadline enforcement, jitter bounds,
event emission)."""

from __future__ import annotations

import dataclasses
import errno
import logging
import random
import time
import zlib

from ddt_tpu_torch.robustness import emit_fault
from ddt_tpu_torch.telemetry import counters as tele_counters

log = logging.getLogger("ddt_tpu_torch.retry")

#: Exception types retried by default. TimeoutError/ConnectionError are
#: OSError subclasses but named for the reader.
TRANSIENT_TYPES = (IOError, OSError, TimeoutError, ConnectionError)
#: Runtime-error messages that mark a transient fabric/runtime fault
#: (the status-code prefix in the message is the stable surface).
TRANSIENT_MARKERS = ("UNAVAILABLE", "DEADLINE_EXCEEDED", "ABORTED")
#: OSError errnos that mark a PERMANENT condition — a missing file or a
#: bad path does not heal on attempt 2, so backing off only delays and
#: dresses up a misconfiguration as transient-fault recovery.
PERMANENT_ERRNOS = frozenset({
    errno.ENOENT, errno.EACCES, errno.EPERM, errno.EISDIR, errno.ENOTDIR,
    errno.EEXIST, errno.ENAMETOOLONG, errno.EROFS, errno.ENOSPC,
})


def is_transient(e: BaseException) -> bool:
    """Default retryability: transient I/O and fabric faults only.
    Permanent filesystem errors (ENOENT, EACCES, ... — a mis-named chunk
    file fails identically forever) surface immediately;
    RESOURCE_EXHAUSTED is deliberately NOT transient (the same shape
    OOMs again: that is the histogram ladder's job, backends/cuda.py),
    and InjectedCrash (a simulated process death) never retries."""
    if isinstance(e, TRANSIENT_TYPES):
        return getattr(e, "errno", None) not in PERMANENT_ERRNOS
    msg = str(e)
    return any(m in msg for m in TRANSIENT_MARKERS)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """attempts is the TOTAL try count (first call included). Each
    backoff delay is base_s * multiplier^(attempt-1), jittered DOWN into
    [delay * (1 - jitter), delay] — full delays never stretch, so the
    deadline bound is exact. deadline_s caps elapsed-time-plus-next-
    sleep: the engine gives up rather than start a sleep it knows
    overruns the budget."""

    attempts: int = 4
    base_s: float = 0.05
    multiplier: float = 2.0
    jitter: float = 0.5
    deadline_s: float = 30.0


DEFAULT_POLICY = RetryPolicy()


def retry_call(fn, *args, seam: str, policy: RetryPolicy | None = None,
               retryable=is_transient, clock=time.monotonic,
               sleep=time.sleep, rng: "random.Random | None" = None,
               **kwargs):
    """Call fn(*args, **kwargs), retrying transient failures per
    `policy`. `seam` names the call site in fault events and logs."""
    try:
        return fn(*args, **kwargs)
    except Exception as e:
        if not retryable(e):
            raise
        return _backoff_loop(fn, args, kwargs, seam,
                             policy or DEFAULT_POLICY, retryable, e,
                             clock, sleep, rng)


def _backoff_loop(fn, args, kwargs, seam, policy, retryable, first_error,
                  clock, sleep, rng):
    """The slow path — entered only after a retryable failure (the
    zero-overhead guard test monkeypatches this to explode)."""
    if rng is None:
        # Seeded from the seam NAME only (zlib.crc32 — stable across
        # processes, unlike str hash()), so a replayed chaos run draws
        # the identical jitter sequence.
        rng = random.Random(zlib.crc32(seam.encode()))
    t0 = clock()
    err = first_error
    attempt = 1
    while True:
        tele_counters.record_fault_retry()
        emit_fault("retry", seam=seam, attempt=attempt,
                   error=type(err).__name__, message=str(err)[:200])
        log.warning("retry[%s]: attempt %d/%d failed: %s",
                    seam, attempt, policy.attempts, err)
        if attempt >= policy.attempts:
            emit_fault("retry_exhausted", seam=seam, attempt=attempt,
                       error=type(err).__name__)
            raise err
        delay = policy.base_s * policy.multiplier ** (attempt - 1)
        delay *= 1.0 - policy.jitter * rng.random()
        if clock() - t0 + delay > policy.deadline_s:
            emit_fault("retry_deadline", seam=seam, attempt=attempt,
                       error=type(err).__name__,
                       deadline_s=policy.deadline_s)
            raise err
        sleep(delay)
        attempt += 1
        try:
            return fn(*args, **kwargs)
        except Exception as e:  # classify-and-loop, never swallow
            if not retryable(e):
                raise
            err = e


def retrying_chunk_fn(chunk_fn, policy: RetryPolicy | None = None):
    """Wrap a streaming chunk source (fit_streaming's ChunkFn contract)
    so every read — full chunks AND the label-only side channel —
    retries transient I/O faults, with the `stream.chunk_read`
    injection seam INSIDE the retried callable (an injected IOError on
    attempt 1 is retried like a real one; the plan's `times` budget
    makes attempt 2 clean). Side-channel attributes (n_features,
    n_chunks, binned, labels) are preserved — chunk sources are pure,
    so a retried re-read returns identical data by contract."""
    from ddt_tpu_torch.robustness import faultplan

    def read(c: int):
        faultplan.inject("stream.chunk_read", chunk=c)
        return chunk_fn(c)

    def f(c: int):
        return retry_call(read, c, seam="stream.chunk_read",
                          policy=policy)

    for attr in ("n_features", "n_chunks", "binned"):
        if hasattr(chunk_fn, attr):
            setattr(f, attr, getattr(chunk_fn, attr))
    labels = getattr(chunk_fn, "labels", None)
    if labels is not None:
        def read_labels(c: int):
            faultplan.inject("stream.chunk_read", chunk=c)
            return labels(c)

        f.labels = lambda c: retry_call(
            read_labels, c, seam="stream.chunk_read", policy=policy)
    if getattr(chunk_fn, "host_sharded", False):
        # Host-sharded sources (data.chunks.HostShardedChunks): the
        # per-part X reads go through the SAME retry seam; ownership
        # bookkeeping (owned_slots / rotate_assignment / row counts)
        # passes through to the live source object so an assignment
        # rotation is visible to every holder of this wrapper.
        f.host_sharded = True
        f.n_shards_per_chunk = chunk_fn.n_shards_per_chunk
        f.owned_slots = chunk_fn.owned_slots
        f.rotate_assignment = chunk_fn.rotate_assignment
        f.part_rows = chunk_fn.part_rows
        f.chunk_rows = chunk_fn.chunk_rows

        def read_part(c: int, s: int):
            faultplan.inject("stream.chunk_read", chunk=c)
            return chunk_fn.read_part(c, s)

        f.read_part = lambda c, s: retry_call(
            read_part, c, s, seam="stream.chunk_read", policy=policy)
    return f
