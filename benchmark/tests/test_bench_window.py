"""The measured window's length. A traced run closes its window after the
mix's "trace_steps" whole jobs where the mix has the key and --seconds
has not closed it before; an untraced run, and a traced run of a mix
without the key, keep --seconds, the job in flight finishing and
counting. The harness runs a stub loop here on a clock that each job
moves on by a fixed step."""

import types

import pytest

from benchmark.core import harness


class Clock:
    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now


def _window(monkeypatch, trace, job_s=2.0, seconds=10.0, **traffic):
    """The window the loop was handed and the jobs it ran."""
    clock, seen = Clock(), []
    monkeypatch.setattr(harness, "time", clock)

    def step(state):
        clock.now += job_s

    def end_to_end(state, window_s):
        seen.append(window_s)
        return {}

    loop = types.SimpleNamespace(
        setup=lambda ctx: None, step=step, end_to_end=end_to_end,
        release=lambda state: None, check=lambda state: {},
        layer_inputs=lambda state: {})
    cell = harness.Cell("stub.train", 1, {}, {"kind": "stub", **traffic},
                        loop, {"numbers": {}}, [], [])
    res = harness.run_cell(cell, seed=1, seconds=seconds, trace=trace,
                           device="cpu", t_start=0.0)
    assert res["correct"] is True
    return seen[0], res["attempted"]


@pytest.mark.parametrize("trace,traffic,want", [
    # Capped at one job: the window is that whole job.
    (True, {"trace_steps": 1}, (2.0, 1)),
    (True, {"trace_steps": 2}, (4.0, 2)),
    # The same mix untraced keeps --seconds, the job in flight finishing.
    (False, {"trace_steps": 1}, (10.0, 5)),
    # A mix without the key traces the whole window.
    (True, {}, (10.0, 5)),
    # A cap of more jobs than --seconds holds changes nothing.
    (True, {"trace_steps": 60}, (10.0, 5)),
])
def test_trace_steps_bounds_only_the_traced_window(monkeypatch, trace,
                                                   traffic, want):
    assert _window(monkeypatch, trace, **traffic) == want
