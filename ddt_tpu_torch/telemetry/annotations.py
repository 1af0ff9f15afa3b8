"""Host and device phase annotations sharing one naming scheme,
`ddt:<phase>` (port of ddt_tpu/telemetry/annotations.py).

- phase_span(name): a torch.profiler `record_function` range (the host
  track of a torch.profiler trace) and, with a card, an NVTX range of the
  same name. The trainers enter it around each PhaseTimer phase
  (phase_ctx), so a trace carries the names of the run log's
  phase_timings.
- traced_scope(name) / op_scope(name): the ops' own stages (`hist`,
  `gain`, `predict`). The reference names lowered XLA ops with it; here
  the op runs eagerly or inside a captured round, so the scope is a host
  range, and it is one of three things, chosen by one module-global read:
  nothing (no timer, no capture: the hot path pays that read), a
  phase_span while a profiler capture is open (`tracing`), or a
  phase of the sub-phase timer a profiled trainer installs
  (`sub_phases`), nested in the trainer's own phase (utils/profiling).
"""

from __future__ import annotations

import contextlib
import functools

PREFIX = "ddt:"

# None: op scopes are bare. A PhaseTimer: op scopes are its phases (and
# spans). True: op scopes are spans only (a profiler capture is open).
_sink = None


def _span_enter(stack: contextlib.ExitStack, name: str) -> None:
    import torch

    stack.enter_context(torch.profiler.record_function(PREFIX + name))
    if torch.cuda.is_available():
        stack.enter_context(torch.cuda.nvtx.range(PREFIX + name))


def phase_span(name: str):
    """Host profiler range `ddt:<name>` (and an NVTX range on a card)."""
    stack = contextlib.ExitStack()
    _span_enter(stack, name)
    return stack


@contextlib.contextmanager
def tracing():
    """Open op scopes as spans while a profiler capture runs (a
    sub-phase timer already installed keeps its phases, which are spans
    too); restores what was there before."""
    global _sink
    prev = _sink
    if prev is None:
        _sink = True
    try:
        yield
    finally:
        _sink = prev


@contextlib.contextmanager
def sub_phases(timer):
    """Install `timer` as the op scopes' timer for the block (a profiled
    trainer's granular loop); restores what was there before."""
    global _sink
    prev = _sink
    _sink = timer
    try:
        yield
    finally:
        _sink = prev


def traced_scope(name: str):
    """The op stage `ddt:<name>`: a no-op context unless a profiled
    trainer or a profiler capture asked for it (module docstring)."""
    sink = _sink
    if sink is None:
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    _span_enter(stack, name)
    if sink is not True:
        stack.enter_context(sink.phase(name))
    return stack


def op_scope(name: str):
    """traced_scope around a whole function, as a decorator (the ops'
    dispatchers whose whole body is one stage)."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if _sink is None:
                return fn(*args, **kwargs)
            with traced_scope(name):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def phase_ctx(timer):
    """Phase-context factory shared by the trainers' loops: with a
    PhaseTimer, `ph(name)` is its phase plus a phase_span; with None a
    bare nullcontext."""
    if timer is None:
        def ph(name):
            return contextlib.nullcontext()
    else:
        def ph(name):
            stack = contextlib.ExitStack()
            _span_enter(stack, name)
            stack.enter_context(timer.phase(name))
            return stack
    return ph
