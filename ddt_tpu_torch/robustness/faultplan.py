"""Deterministic, config-driven fault injection (the chaos harness; port
of ddt_tpu/robustness/faultplan.py, copied).

A FaultPlan is a JSON document (`cfg.fault_plan` / `--fault-plan`)
naming WHICH faults fire WHERE and WHEN:

    {"seed": 0, "faults": [
        {"site": "ckpt.save.between", "round": 4},
        {"site": "stream.chunk_read", "chunk": 1, "times": 2},
        {"site": "multihost.init", "times": 1},
        {"site": "hist.build", "times": 1},
        {"site": "straggler", "device": 1, "delay_ms": 400.0,
         "rounds": [2, 6]}
    ]}

Each entry matches a SITE (the seam catalog below, `SITES`)
plus optional criteria (`round`, `chunk`, `device`, a `rounds`
[lo, hi] window, `after_calls` to skip the first N matching calls)
and fires at most `times` times (default 1) — so a retried seam
sees the fault on attempt 1 and clean I/O on attempt 2, exactly the
transient-fault shape the retry layer exists for. An optional `p`
draws per-call from the plan-seeded RNG (deterministic for a fixed
execution order); without `p` matching is fully deterministic.

Zero overhead when disabled: the seams call the module-level
`inject(site, ...)` / `perturb_ms(site, ...)` functions, whose entire
no-plan path is ONE module-global read (guard-tested in
tests/test_torch_robustness.py by making `FaultPlan.fire` explode while
the fused, granular and streamed loops train without a plan).

Every firing emits a `fault` run-log event (kind="injected", site +
context) through the robustness fault sink, so a chaos run's log is
self-describing.
"""

from __future__ import annotations

import dataclasses
import json
import random

import torch

# ----------------------------------------------------------------- #
# injected-fault exception types
# ----------------------------------------------------------------- #


class InjectedCrash(RuntimeError):
    """Simulated process death (e.g. a kill between the checkpoint
    pair's two os.replace calls). Deliberately NOT transient: the retry
    layer must never absorb it — the run dies and a later run recovers."""


class InjectedIOError(IOError):
    """Transient I/O fault (stream-chunk read, checkpoint write)."""


class InjectedTimeout(TimeoutError):
    """Bootstrap/RPC timeout (multihost init)."""


class InjectedResourceExhausted(RuntimeError):
    """Device OOM twin: str() carries RESOURCE_EXHAUSTED so the
    histogram ladder treats it exactly like a real allocation failure
    (is_resource_exhausted)."""

    def __init__(self, msg: str = ""):
        super().__init__(f"RESOURCE_EXHAUSTED: injected {msg}".strip())


class InjectedTransient(RuntimeError):
    """Generic transient runtime fault (fetch_tree D2H): str() carries
    UNAVAILABLE so utils.retry.is_transient retries it."""

    def __init__(self, msg: str = ""):
        super().__init__(f"UNAVAILABLE: injected {msg}".strip())


def is_resource_exhausted(e: BaseException) -> bool:
    """Does `e` look like a device allocation failure? The card's own
    (torch.cuda.OutOfMemoryError, raised by the caching allocator), and
    any error whose message carries RESOURCE_EXHAUSTED (the injected
    twin, and the reference's spelling)."""
    oom = getattr(getattr(torch, "cuda", None), "OutOfMemoryError", None)
    if oom is not None and isinstance(e, oom):
        return True
    return "RESOURCE_EXHAUSTED" in str(e)


# ----------------------------------------------------------------- #
# the seam catalog: site -> default error kind (None = query site)
# ----------------------------------------------------------------- #
ERRORS = {
    "crash": InjectedCrash,
    "io": InjectedIOError,
    "timeout": InjectedTimeout,
    "resource_exhausted": InjectedResourceExhausted,
    "transient": InjectedTransient,
}

#: The injection sites compiled into the real seams. Raising sites get
#: their default error kind (overridable per entry via "error");
#: "straggler" is a QUERY site — perturb_ms() returns an added delay
#: instead of raising.
SITES: dict[str, str | None] = {
    "ckpt.save.write": "io",          # before the ensemble tmp write
    "ckpt.save.between": "crash",     # between the pair's two os.replace
    "ckpt.load": "io",                # checkpoint artifact read
    "stream.chunk_read": "io",        # streaming chunk source read
    "multihost.init": "timeout",      # torch.distributed bootstrap
    "hist.build": "resource_exhausted",  # a histogram kernel launch
    "fetch_tree": "transient",        # per-tree D2H fetch
    "straggler": None,                # per-partition delay (query)
}

_CRITERIA = ("round", "chunk", "device")


@dataclasses.dataclass
class FaultSpec:
    """One plan entry; `fired`/`calls` are runtime state (a plan
    instance is single-use — load a fresh one per run)."""

    site: str
    times: int = 1
    after_calls: int = 0
    round: int | None = None
    chunk: int | None = None
    device: int | None = None
    rounds: tuple[int, int] | None = None   # inclusive [lo, hi] window
    p: float | None = None
    error: str | None = None
    delay_ms: float = 0.0
    fired: int = 0
    calls: int = 0

    def matches(self, ctx: dict) -> bool:
        for key in _CRITERIA:
            want = getattr(self, key)
            if want is not None and ctx.get(key) != want:
                return False
        if self.rounds is not None:
            r = ctx.get("round")
            if r is None or not (self.rounds[0] <= r <= self.rounds[1]):
                return False
        return True


class FaultPlan:
    """The active plan: ordered FaultSpecs + a seeded RNG for `p` draws.
    `fired_log` records every firing (site, ctx) for test assertions."""

    def __init__(self, specs: list[FaultSpec], seed: int = 0):
        self.specs = specs
        self.seed = seed
        self._rng = random.Random(seed)
        self.fired_log: list[tuple[str, dict]] = []

    def _arm(self, site: str, ctx: dict) -> FaultSpec | None:
        """The first spec for `site` that matches ctx and still has
        firings left (call accounting happens here)."""
        for spec in self.specs:
            if spec.site != site or not spec.matches(ctx):
                continue
            spec.calls += 1
            if spec.fired >= spec.times or spec.calls <= spec.after_calls:
                continue
            if spec.p is not None and self._rng.random() >= spec.p:
                continue
            return spec
        return None

    def fire(self, site: str, **ctx) -> None:
        """Raise the configured fault if a spec matches, else return."""
        spec = self._arm(site, ctx)
        if spec is None:
            return
        spec.fired += 1
        self.fired_log.append((site, dict(ctx)))
        self._emit(site, ctx)
        kind = spec.error or SITES[site] or "crash"
        raise ERRORS[kind](
            f"injected fault at {site} "
            f"({', '.join(f'{k}={v}' for k, v in sorted(ctx.items()))})")

    def delay_ms(self, site: str, **ctx) -> float:
        """Query-site firing: the artificial delay for this call, 0.0
        when no spec matches (the straggler seam)."""
        spec = self._arm(site, ctx)
        if spec is None:
            return 0.0
        spec.fired += 1
        self.fired_log.append((site, dict(ctx)))
        self._emit(site, ctx)
        return float(spec.delay_ms)

    def _emit(self, site: str, ctx: dict) -> None:
        from ddt_tpu_torch.robustness import emit_fault

        emit_fault("injected", site=site, **ctx)


def load_plan(src: "str | dict") -> FaultPlan:
    """FaultPlan from a JSON file path or an already-parsed dict.
    Unknown sites and unknown entry keys fail loudly — a typo'd chaos
    plan silently injecting nothing is worse than an error."""
    if isinstance(src, str):
        with open(src) as f:
            d = json.load(f)
    else:
        d = src
    if not isinstance(d, dict) or "faults" not in d:
        raise ValueError("fault plan must be an object with a 'faults' list")
    known = {f.name for f in dataclasses.fields(FaultSpec)} - {
        "fired", "calls"}
    specs = []
    for i, e in enumerate(d["faults"]):
        if not isinstance(e, dict) or "site" not in e:
            raise ValueError(f"fault entry {i} must be an object with 'site'")
        if e["site"] not in SITES:
            raise ValueError(
                f"fault entry {i}: unknown site {e['site']!r}; "
                f"have {sorted(SITES)}")
        unknown = sorted(set(e) - known)
        if unknown:
            raise ValueError(
                f"fault entry {i} has unknown keys {unknown}; "
                f"valid: {sorted(known)}")
        if e.get("error") is not None and e["error"] not in ERRORS:
            raise ValueError(
                f"fault entry {i}: unknown error kind {e['error']!r}; "
                f"have {sorted(ERRORS)}")
        kw = dict(e)
        if "rounds" in kw and kw["rounds"] is not None:
            lo, hi = kw["rounds"]
            kw["rounds"] = (int(lo), int(hi))
        specs.append(FaultSpec(**kw))
    return FaultPlan(specs, seed=int(d.get("seed", 0)))


# ----------------------------------------------------------------- #
# activation — the telemetry-style zero-overhead global
# ----------------------------------------------------------------- #
_ACTIVE: FaultPlan | None = None


def active_plan() -> FaultPlan | None:
    return _ACTIVE


def activate(plan: FaultPlan | None) -> FaultPlan | None:
    """Install `plan`; returns the previous plan so the caller's
    `finally` can restore it (deactivate)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = plan
    return prev


def deactivate(prev: FaultPlan | None = None) -> None:
    global _ACTIVE
    _ACTIVE = prev


def inject(site: str, **ctx) -> None:
    """THE seam entry point: raises the configured fault when the active
    plan says so; one global read and a return otherwise."""
    plan = _ACTIVE
    if plan is not None:
        plan.fire(site, **ctx)


def perturb_ms(site: str, **ctx) -> float:
    """Query-seam entry point (straggler delay): 0.0 with no plan."""
    plan = _ACTIVE
    if plan is None:
        return 0.0
    return plan.delay_ms(site, **ctx)
