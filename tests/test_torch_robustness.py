"""The port's robustness layer against tests/test_robustness.py: the retry
engine, the fault plan, checkpoint hardening, the histogram OOM ladder,
the straggler watchdog and its shard rotation, and the guard that a run
without a plan never touches any of it.

The recovery bar is BIT-IDENTITY: training is deterministic given binned
data, so a fault the layer absorbs leaves the ensemble exactly equal to
an undisturbed run's, f32 and int8. Where the reference has the same
function (the retry engine, the plan, the watchdog), its result on the
same inputs is held beside the port's, exactly. Mesh cases run on gloo
ranks (parallel/spawn); four ranks for the rotation, since two ranks
commute and cannot show a reduction order that follows the shards.
"""

import json
import os
import random

import numpy as np
import pytest
import torch

from ddt_tpu.robustness import faultplan as jfaultplan
from ddt_tpu.robustness import set_fault_sink as jset_fault_sink
from ddt_tpu.robustness.watchdog import StragglerWatchdog as JWatchdog
from ddt_tpu.utils import retry as jretry
from ddt_tpu_torch import api
from ddt_tpu_torch.backends import get_backend
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.driver import Driver
from ddt_tpu_torch.models.tree import TreeEnsemble, empty_ensemble
from ddt_tpu_torch.ops import histogram as hist_ops
from ddt_tpu_torch.parallel import spawn, tasks
from ddt_tpu_torch.robustness import faultplan, set_fault_sink
from ddt_tpu_torch.robustness.watchdog import StragglerWatchdog
from ddt_tpu_torch.streaming import fit_streaming
from ddt_tpu_torch.telemetry.events import RunLog
from ddt_tpu_torch.utils import checkpoint, retry

FIELDS = ("feature", "threshold_bin", "is_leaf", "leaf_value", "split_gain")
STRAGGLER = {"faults": [{"site": "straggler", "device": 1,
                         "delay_ms": 600000.0, "rounds": [1, 6],
                         "times": 100}]}


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    """Every test starts and ends with no active plan, no sink and the
    ladder's top rung."""
    for fp, sink in ((faultplan, set_fault_sink),
                     (jfaultplan, jset_fault_sink)):
        fp.deactivate(None)
        sink(None)
    hist_ops.reset_hist_rung()
    yield
    for fp, sink in ((faultplan, set_fault_sink),
                     (jfaultplan, jset_fault_sink)):
        fp.deactivate(None)
        sink(None)
    hist_ops.reset_hist_rung()


@pytest.fixture(scope="module")
def pools():
    made = {}

    def get(world):
        if world not in made:
            made[world] = spawn.Pool(world, backend="gloo", device="cpu",
                                     timeout_s=180.0)
        return made[world]

    yield get
    for p in made.values():
        p.close()


def _binary(rows=2000, n_bins=29, features=7, seed=5):
    rng = np.random.default_rng(seed)
    Xb = rng.integers(0, n_bins, size=(rows, features), dtype=np.uint8)
    y = (Xb[:, 0] + rng.integers(0, 6, size=rows) > 18).astype(np.float32)
    return Xb, y


def _chunks(Xb, y, n):
    bounds = np.linspace(0, len(y), n + 1).astype(np.int64)

    def f(c):
        return Xb[bounds[c]:bounds[c + 1]], y[bounds[c]:bounds[c + 1]]

    return f


def _assert_ens_equal(a, b):
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                      err_msg=k)


def _cfg(**kw):
    return TrainConfig(**{"n_trees": 5, "max_depth": 3, "n_bins": 29,
                          "device": "cpu", "seed": 2, **kw})


# ------------------------------------------------------------------ #
# retry engine (fake clock), held against the reference's engine
# ------------------------------------------------------------------ #
class FakeClock:
    def __init__(self):
        self.t = 0.0
        self.sleeps = []

    def clock(self):
        return self.t

    def sleep(self, s):
        self.sleeps.append(s)
        self.t += s


def _flaky(fails):
    calls = {"n": 0}

    def f():
        calls["n"] += 1
        if calls["n"] <= fails:
            raise IOError(f"blip {calls['n']}")
        return "ok"

    return f, calls


def test_retry_succeeds_after_transient_failures_and_emits_events():
    rl = RunLog()
    set_fault_sink(rl)
    pol = dict(attempts=4, base_s=1.0, multiplier=2.0, jitter=0.5,
               deadline_s=100.0)
    clk, jclk = FakeClock(), FakeClock()
    f, calls = _flaky(2)
    out = retry.retry_call(f, seam="test.seam",
                           policy=retry.RetryPolicy(**pol),
                           clock=clk.clock, sleep=clk.sleep)
    assert out == "ok" and calls["n"] == 3
    faults = rl.events("fault")
    assert [e["kind"] for e in faults] == ["retry", "retry"]
    assert faults[0]["seam"] == "test.seam"
    assert faults[0]["attempt"] == 1 and faults[1]["attempt"] == 2
    assert faults[0]["error"] == "OSError"
    # The reference's engine backs off by the same seeded jitter.
    jf, _ = _flaky(2)
    jretry.retry_call(jf, seam="test.seam",
                      policy=jretry.RetryPolicy(**pol), clock=jclk.clock,
                      sleep=jclk.sleep)
    assert clk.sleeps == jclk.sleeps


def test_retry_jitter_bounds_and_backoff_growth():
    pol = retry.RetryPolicy(attempts=6, base_s=1.0, multiplier=2.0,
                            jitter=0.5, deadline_s=1e9)
    for seed in range(10):
        clk = FakeClock()
        n = {"v": 0}

        def always_fail():
            n["v"] += 1
            raise IOError("x")

        with pytest.raises(IOError):
            retry.retry_call(always_fail, seam="jitter.test", policy=pol,
                             clock=clk.clock, sleep=clk.sleep,
                             rng=random.Random(seed))
        assert n["v"] == 6 and len(clk.sleeps) == 5
        for k, s in enumerate(clk.sleeps):
            full = pol.base_s * pol.multiplier ** k
            assert full * (1 - pol.jitter) <= s <= full, (k, s)
        jclk = FakeClock()
        with pytest.raises(IOError):
            jretry.retry_call(always_fail, seam="jitter.test",
                              policy=jretry.RetryPolicy(**vars(pol)),
                              clock=jclk.clock, sleep=jclk.sleep,
                              rng=random.Random(seed))
        assert clk.sleeps == jclk.sleeps


def test_retry_deadline_stops_before_overrunning():
    rl = RunLog()
    set_fault_sink(rl)
    clk = FakeClock()

    def always_fail():
        raise IOError("x")

    pol = retry.RetryPolicy(attempts=100, base_s=1.0, multiplier=2.0,
                            jitter=0.0, deadline_s=10.0)
    with pytest.raises(IOError):
        retry.retry_call(always_fail, seam="deadline.test", policy=pol,
                         clock=clk.clock, sleep=clk.sleep)
    # 1 + 2 + 4 = 7 slept; the next 8 s would pass 10 s: refused.
    assert clk.t <= pol.deadline_s and clk.sleeps == [1.0, 2.0, 4.0]
    kinds = [e["kind"] for e in rl.events("fault")]
    assert kinds[-1] == "retry_deadline"


def test_retry_never_absorbs_non_transient():
    calls = {"n": 0}

    def boom():
        calls["n"] += 1
        raise ValueError("logic bug")

    with pytest.raises(ValueError):
        retry.retry_call(boom, seam="typed.test")
    assert calls["n"] == 1


def test_retry_exhausted_emits_and_raises():
    rl = RunLog()
    set_fault_sink(rl)
    clk = FakeClock()
    with pytest.raises(IOError):
        retry.retry_call(
            lambda: (_ for _ in ()).throw(IOError("down")),
            seam="exhaust.test",
            policy=retry.RetryPolicy(attempts=3, base_s=0.01,
                                     deadline_s=100.0),
            clock=clk.clock, sleep=clk.sleep)
    kinds = [e["kind"] for e in rl.events("fault")]
    assert kinds == ["retry", "retry", "retry", "retry_exhausted"]


def test_is_transient_classification():
    cases = [IOError("x"), TimeoutError("x"),
             RuntimeError("UNAVAILABLE: tunnel reset"),
             faultplan.InjectedTransient("d2h"), ValueError("x"),
             faultplan.InjectedCrash("kill"),
             faultplan.InjectedResourceExhausted("hist"),
             FileNotFoundError(2, "no such file"),
             PermissionError(13, "denied"), IsADirectoryError(21, "dir"),
             NotADirectoryError(20, "not a dir"), OSError("nfs blip")]
    want = [True, True, True, True, False, False, False, False, False,
            False, False, True]
    assert [retry.is_transient(e) for e in cases] == want
    assert [jretry.is_transient(e) for e in cases] == want


def test_resource_exhausted_classification():
    """The card's real allocation failure and the injected twin are both
    allocation failures; neither is transient (the ladder's job)."""
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                      "allocate 2.00 GiB")
    assert faultplan.is_resource_exhausted(oom)
    assert faultplan.is_resource_exhausted(
        faultplan.InjectedResourceExhausted("hist"))
    assert faultplan.is_resource_exhausted(
        RuntimeError("RESOURCE_EXHAUSTED: out of memory"))
    assert not faultplan.is_resource_exhausted(RuntimeError("boom"))
    assert not retry.is_transient(oom)


# ------------------------------------------------------------------ #
# fault plan mechanics
# ------------------------------------------------------------------ #
def test_fault_plan_parse_validation():
    for fp in (faultplan, jfaultplan):
        with pytest.raises(ValueError, match="unknown site"):
            fp.load_plan({"faults": [{"site": "nope"}]})
        with pytest.raises(ValueError, match="unknown keys"):
            fp.load_plan({"faults": [{"site": "hist.build", "wat": 1}]})
        with pytest.raises(ValueError, match="unknown error kind"):
            fp.load_plan({"faults": [{"site": "hist.build",
                                      "error": "nope"}]})
        with pytest.raises(ValueError, match="'faults'"):
            fp.load_plan({"seed": 1})
    assert faultplan.SITES == jfaultplan.SITES


def test_fault_plan_times_and_criteria(tmp_path):
    p = tmp_path / "plan.json"
    p.write_text(json.dumps({"faults": [
        {"site": "stream.chunk_read", "chunk": 2, "times": 2},
        {"site": "hist.build", "p": 0.5, "times": 100},
    ]}))
    draws = []
    for fp in (faultplan, jfaultplan):
        plan = fp.load_plan(str(p))
        prev = fp.activate(plan)
        try:
            fp.inject("stream.chunk_read", chunk=1)       # no match
            for _ in range(2):
                with pytest.raises(fp.InjectedIOError):
                    fp.inject("stream.chunk_read", chunk=2)
            fp.inject("stream.chunk_read", chunk=2)       # budget spent
            fired = []
            for _ in range(20):
                try:
                    fp.inject("hist.build")
                    fired.append(0)
                except fp.InjectedResourceExhausted:
                    fired.append(1)
        finally:
            fp.deactivate(prev)
        assert len(plan.fired_log) == 2 + sum(fired)
        draws.append(fired)
    # The seeded p draws are the reference's, draw for draw.
    assert draws[0] == draws[1] and 0 < sum(draws[0]) < 20


def test_fault_plan_injected_events_reach_sink():
    rl = RunLog()
    set_fault_sink(rl)
    prev = faultplan.activate(faultplan.load_plan(
        {"faults": [{"site": "fetch_tree"}]}))
    try:
        with pytest.raises(faultplan.InjectedTransient):
            faultplan.inject("fetch_tree")
    finally:
        faultplan.deactivate(prev)
    ev = rl.events("fault")
    assert len(ev) == 1 and ev[0]["kind"] == "injected"
    assert ev[0]["site"] == "fetch_tree"


def test_straggler_perturbation_is_query_not_raise():
    plan = {"faults": [{"site": "straggler", "device": 1,
                        "delay_ms": 250.0, "rounds": [2, 3], "times": 10}]}
    prev = faultplan.activate(faultplan.load_plan(plan))
    try:
        assert faultplan.perturb_ms("straggler", device=1, round=1) == 0.0
        assert faultplan.perturb_ms("straggler", device=0, round=2) == 0.0
        assert faultplan.perturb_ms("straggler", device=1,
                                    round=2) == 250.0
    finally:
        faultplan.deactivate(prev)
    assert faultplan.perturb_ms("straggler", device=1, round=2) == 0.0


# ------------------------------------------------------------------ #
# checkpoint hardening
# ------------------------------------------------------------------ #
def _mk_ens(cfg, F=7, rounds_filled=0, seed=0):
    ens = empty_ensemble(cfg.n_trees, cfg.max_depth, F, cfg.learning_rate,
                         0.0, cfg.loss, cfg.n_classes, n_bins=cfg.n_bins)
    rng = np.random.default_rng(seed)
    k = rounds_filled
    if k:
        ens.feature[:k] = rng.integers(0, F, ens.feature[:k].shape)
        ens.leaf_value[:k] = rng.random(ens.leaf_value[:k].shape,
                                        dtype=np.float32)
    return ens


def test_torn_pair_falls_back_to_last_good_history(tmp_path):
    cfg = _cfg(n_trees=10)
    ck = str(tmp_path / "ck")
    e2 = _mk_ens(cfg, rounds_filled=2, seed=1)
    checkpoint.save_checkpoint(ck, e2, cfg, 2)
    e4 = _mk_ens(cfg, rounds_filled=4, seed=2)
    prev = faultplan.activate(faultplan.load_plan(
        {"faults": [{"site": "ckpt.save.between", "round": 4}]}))
    try:
        with pytest.raises(faultplan.InjectedCrash):
            checkpoint.save_checkpoint(ck, e4, cfg, 4)
    finally:
        faultplan.deactivate(prev)
    rl = RunLog()
    fresh = _mk_ens(cfg)
    assert checkpoint.try_resume(ck, fresh, cfg, run_log=rl) == 2
    np.testing.assert_array_equal(fresh.feature[:2], e2.feature[:2])
    kinds = [e["kind"] for e in rl.events("fault")]
    assert "checkpoint_corrupt" in kinds and "checkpoint_fallback" in kinds


def test_corrupt_cursor_json_is_no_checkpoint_not_a_crash(tmp_path):
    cfg = _cfg(n_trees=10)
    ck = str(tmp_path / "ck")
    os.makedirs(ck)
    with open(os.path.join(ck, checkpoint.CURSOR_FILE), "w") as f:
        f.write('{"completed_rounds": 2, "conf')
    with open(os.path.join(ck, checkpoint.CKPT_FILE), "wb") as f:
        f.write(b"PK\x03\x04 garbage npz")
    rl = RunLog()
    assert checkpoint.try_resume(ck, _mk_ens(cfg), cfg, run_log=rl) == 0
    kinds = [e["kind"] for e in rl.events("fault")]
    assert "checkpoint_corrupt" in kinds
    assert "checkpoint_unrecoverable" in kinds


def test_unreadable_npz_with_valid_cursor_falls_back(tmp_path):
    cfg = _cfg(n_trees=10)
    ck = str(tmp_path / "ck")
    checkpoint.save_checkpoint(ck, _mk_ens(cfg, rounds_filled=2, seed=3),
                               cfg, 2)
    e4 = _mk_ens(cfg, rounds_filled=4, seed=4)
    checkpoint.save_checkpoint(ck, e4, cfg, 4)
    garbage = os.path.join(ck, "garbage.bin")
    with open(garbage, "wb") as f:
        f.write(b"PK\x03\x04 torn npz")
    os.replace(garbage, os.path.join(ck, checkpoint.CKPT_FILE))
    fresh = _mk_ens(cfg)
    rl = RunLog()
    assert checkpoint.try_resume(ck, fresh, cfg, run_log=rl) == 4
    np.testing.assert_array_equal(fresh.feature[:4], e4.feature[:4])
    assert "checkpoint_fallback" in [e["kind"] for e in rl.events("fault")]


def test_history_keeps_last_k(tmp_path):
    cfg = _cfg(n_trees=20)
    ck = str(tmp_path / "ck")
    for r in (2, 4, 6, 8, 10):
        checkpoint.save_checkpoint(ck, _mk_ens(cfg, rounds_filled=r), cfg,
                                   r)
    hist = sorted(d for d in os.listdir(ck)
                  if d.startswith(checkpoint.HISTORY_PREFIX))
    assert hist == ["ckpt-000006", "ckpt-000008", "ckpt-000010"]


def test_old_format_cursor_without_digest_still_resumes(tmp_path):
    cfg = _cfg(n_trees=10)
    ck = str(tmp_path / "ck")
    os.makedirs(ck)
    e3 = _mk_ens(cfg, rounds_filled=3, seed=5)
    e3.save(os.path.join(ck, checkpoint.CKPT_FILE))
    with open(os.path.join(ck, checkpoint.CURSOR_FILE), "w") as f:
        json.dump({"completed_rounds": 3,
                   "config": checkpoint.cfg_fingerprint(cfg)}, f)
    fresh = _mk_ens(cfg)
    assert checkpoint.try_resume(ck, fresh, cfg) == 3
    np.testing.assert_array_equal(fresh.feature[:3], e3.feature[:3])


def test_incompatible_config_still_raises(tmp_path):
    cfg = _cfg(n_trees=10)
    ck = str(tmp_path / "ck")
    checkpoint.save_checkpoint(ck, _mk_ens(cfg, rounds_filled=2), cfg, 2)
    other = cfg.replace(learning_rate=0.5)
    with pytest.raises(ValueError, match="incompatible config"):
        checkpoint.try_resume(ck, _mk_ens(other), other)


def test_robustness_knobs_are_resume_compatible(tmp_path):
    """A run that crashed under a fault plan resumes without one: the
    robustness fields (and the backend) are outside the fingerprint."""
    cfg = _cfg(n_trees=10, fault_plan="/tmp/plan.json",
               straggler_repartition=True, straggler_skew_threshold=3.0,
               backend="cpu")
    ck = str(tmp_path / "ck")
    checkpoint.save_checkpoint(ck, _mk_ens(cfg, rounds_filled=2), cfg, 2)
    clean = _cfg(n_trees=10)
    assert checkpoint.try_resume(ck, _mk_ens(clean), clean) == 2


# ------------------------------------------------------------------ #
# end-to-end chaos: injected faults -> bitwise ensembles
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("grad_dtype", ["f32", "int8"])
def test_injected_stream_read_fault_is_bit_exact(grad_dtype):
    Xb, y = _binary()
    cfg = _cfg(grad_dtype=grad_dtype)
    clean = fit_streaming(_chunks(Xb, y, 4), 4, cfg)
    rl = RunLog()
    prev = faultplan.activate(faultplan.load_plan({"faults": [
        {"site": "stream.chunk_read", "chunk": 1, "times": 1},
        {"site": "stream.chunk_read", "chunk": 3, "times": 1},
    ]}))
    try:
        chaotic = fit_streaming(_chunks(Xb, y, 4), 4, cfg, run_log=rl)
    finally:
        faultplan.deactivate(prev)
    _assert_ens_equal(clean, chaotic)
    kinds = [e["kind"] for e in rl.events("fault")]
    assert kinds.count("injected") == 2 and "retry" in kinds
    assert rl.events("counters")[0]["fault_retries"] >= 2


@pytest.mark.parametrize("grad_dtype", ["f32", "int8"])
def test_injected_fetch_tree_fault_is_bit_exact(grad_dtype):
    Xb, y = _binary(1200)
    cfg = _cfg(n_trees=4, grad_dtype=grad_dtype)
    # profile=True takes the granular loop, which fetches tree by tree.
    ref = api.train(Xb, y, cfg, binned=True, profile=True)
    prev = faultplan.activate(faultplan.load_plan(
        {"faults": [{"site": "fetch_tree", "times": 2}]}))
    try:
        chaotic = api.train(Xb, y, cfg, binned=True, profile=True)
    finally:
        faultplan.deactivate(prev)
    _assert_ens_equal(ref.ensemble, chaotic.ensemble)


@pytest.mark.parametrize("grad_dtype", ["f32", "int8"])
def test_injected_ckpt_write_fault_is_bit_exact(tmp_path, grad_dtype):
    """A torn ensemble write (ckpt.save.write) is retried; the run and its
    checkpoint are the undisturbed run's."""
    Xb, y = _binary(1200)
    cfg = _cfg(n_trees=6, grad_dtype=grad_dtype)
    ref = api.train(Xb, y, cfg, binned=True)
    rl = RunLog()
    prev = faultplan.activate(faultplan.load_plan(
        {"faults": [{"site": "ckpt.save.write", "round": 2, "times": 2}]}))
    try:
        chaotic = api.train(Xb, y, cfg, binned=True, run_log=rl,
                            checkpoint_dir=str(tmp_path / "ck"),
                            checkpoint_every=2)
    finally:
        faultplan.deactivate(prev)
    _assert_ens_equal(ref.ensemble, chaotic.ensemble)
    kinds = [e["kind"] for e in rl.events("fault")]
    assert kinds.count("injected") == 2 and kinds.count("retry") == 2
    resumed = empty_ensemble(6, 3, 7, cfg.learning_rate, 0.0, "logloss")
    assert checkpoint.try_resume(str(tmp_path / "ck"), resumed, cfg) == 6


def test_granular_fit_without_checkpointing_accepts_every_0():
    Xb, y = _binary(600)
    cfg = _cfg(n_trees=2)
    ens = Driver(get_backend(cfg), cfg, log_every=10**9,
                 checkpoint_dir=None, checkpoint_every=0,
                 profile=True).fit(Xb, y)
    assert ens.feature.shape[0] == cfg.n_trees


def test_cfg_fault_plan_is_activated_by_the_trainer(tmp_path):
    Xb, y = _binary(900)
    p = tmp_path / "plan.json"
    p.write_text(json.dumps({"faults": [{"site": "fetch_tree",
                                         "times": 1}]}))
    rl = RunLog()
    res = api.train(Xb, y, _cfg(n_trees=3, fault_plan=str(p)), binned=True,
                    profile=True, run_log=rl)
    assert res.ensemble.n_trees == 3
    kinds = [e["kind"] for e in rl.events("fault")]
    assert "injected" in kinds and "retry" in kinds
    assert faultplan.active_plan() is None


def test_multihost_init_timeout_retries(monkeypatch):
    from ddt_tpu_torch.parallel import mesh as mesh_lib

    calls = {"n": 0}

    def fake_init(*a, **kw):
        calls["n"] += 1

    monkeypatch.setattr(mesh_lib.dist, "init_process_group", fake_init)
    monkeypatch.setattr(mesh_lib, "_init_args", None)
    monkeypatch.setattr(retry.time, "sleep", lambda s: None)
    prev = faultplan.activate(faultplan.load_plan(
        {"faults": [{"site": "multihost.init", "times": 1}]}))
    try:
        mesh_lib.initialize_multihost("tcp://127.0.0.1:9999", 1, 0,
                                      backend="gloo")
    finally:
        faultplan.deactivate(prev)
    assert calls["n"] == 1      # attempt 2 reached the real bootstrap
    monkeypatch.setattr(mesh_lib, "_init_args", None)


@pytest.mark.parametrize("grad_dtype", ["f32", "int8"])
def test_hist_oom_degrade_ladder_is_value_identical(grad_dtype):
    """Every rung's table is bitwise the top rung's (exact int64 and
    int32 sums are order-free); the step is sticky and reported."""
    cfg = _cfg(grad_dtype=grad_dtype)
    be = get_backend(cfg)
    rng = np.random.default_rng(0)
    Xb = rng.integers(0, 29, size=(512, 5), dtype=np.uint8)
    if grad_dtype == "f32":
        g = rng.standard_normal(512).astype(np.float32)
        h = rng.random(512, dtype=np.float32)
    else:
        g = rng.integers(-127, 128, 512).astype(np.int8)
        h = rng.integers(0, 128, 512).astype(np.int8)
    ni = rng.integers(-1, 16, 512).astype(np.int32)
    data = be.upload(Xb)
    top = be.build_histograms(data, g, h, ni, 16)
    rl = RunLog()
    set_fault_sink(rl)
    for rung in (1, 2, 3):
        prev = faultplan.activate(faultplan.load_plan(
            {"faults": [{"site": "hist.build"}]}))
        try:
            out = be.build_histograms(data, g, h, ni, 16)
        finally:
            faultplan.deactivate(prev)
        assert hist_ops.hist_rung() == rung
        assert torch.equal(out, top), rung
        # Sticky: a build with no fault stays on the rung.
        assert torch.equal(be.build_histograms(data, g, h, ni, 16), top)
        assert hist_ops.hist_rung() == rung
    ev = [e for e in rl.events("fault") if e["kind"] == "hist_oom_degrade"]
    assert [e["to_impl"] for e in ev] == [hist_ops.rung_name(r)
                                          for r in (1, 2, 3)]
    # The bottom rung re-raises: there is nothing below it.
    prev = faultplan.activate(faultplan.load_plan(
        {"faults": [{"site": "hist.build"}]}))
    try:
        with pytest.raises(faultplan.InjectedResourceExhausted):
            be.build_histograms(data, g, h, ni, 16)
    finally:
        faultplan.deactivate(prev)


@pytest.mark.parametrize("grad_dtype", ["f32", "int8"])
def test_hist_oom_rung_step_in_training_is_bit_exact(grad_dtype):
    """hist.build on the granular loop steps down a rung mid-run: the
    ensemble is the undisturbed run's and the counter moves."""
    Xb, y = _binary(1500)
    cfg = _cfg(n_trees=4, max_depth=4, grad_dtype=grad_dtype)
    ref = api.train(Xb, y, cfg, binned=True, profile=True)
    rl = RunLog()
    prev = faultplan.activate(faultplan.load_plan(
        {"faults": [{"site": "hist.build", "after_calls": 5,
                     "times": 2}]}))
    try:
        chaotic = api.train(Xb, y, cfg, binned=True, profile=True,
                            run_log=rl)
    finally:
        faultplan.deactivate(prev)
    _assert_ens_equal(ref.ensemble, chaotic.ensemble)
    assert hist_ops.hist_rung() == 2
    assert rl.events("counters")[0]["hist_oom_degrades"] == 2


# ------------------------------------------------------------------ #
# straggler watchdog + rotation
# ------------------------------------------------------------------ #
def test_watchdog_unit_detection_and_latch():
    balanced = {0: {"grow": 100.0}, 1: {"grow": 110.0}, 2: {"grow": 95.0}}
    skewed = {0: {"grow": 100.0}, 1: {"grow": 400.0}, 2: {"grow": 95.0}}
    other = {0: {"grow": 500.0}, 1: {"grow": 100.0}, 2: {"grow": 95.0}}
    seqs = []
    for cls in (StragglerWatchdog, JWatchdog):
        wd = cls(threshold=1.5, patience=2)
        seq = [wd.observe_round(0, balanced)]
        obs = wd.observe_round(1, skewed)
        assert obs.device == 1 and obs.streak == 1
        assert not wd.pending_repartition
        seq += [obs, wd.observe_round(2, skewed)]
        assert seq[-1].streak == 2 and wd.pending_repartition
        wd.repartition_done()
        assert not wd.pending_repartition
        seq += [wd.observe_round(3, skewed), wd.observe_round(4, other)]
        assert seq[-2].streak == 1 and seq[-1].streak == 1
        seqs.append([None if o is None else (o.round, o.device, o.skew,
                                             o.streak) for o in seq])
    assert seqs[0] == seqs[1]
    with pytest.raises(ValueError):
        StragglerWatchdog(threshold=1.0)


def test_injected_straggler_detection_and_repartition_bit_exact(pools):
    """Two gloo ranks: the injected straggler trips the watchdog, the
    flag rotates the shards at the checkpoint cadence, and the ensemble
    is bitwise the undisturbed run's (with the flag on)."""
    Xb, y = _binary(1600)
    kw = dict(n_trees=6, max_depth=3, n_bins=29, seed=4,
              straggler_repartition=True)
    ref = pools(2).run(tasks.train_straggler, Xb, y, kw, None, None)
    out = pools(2).run(tasks.train_straggler, Xb, y, kw, STRAGGLER,
                       dict(checkpoint_every=2))
    for o in out:
        _assert_ens_equal(ref[0]["ensemble"], o["ensemble"])
    kinds = out[0]["faults"]
    assert "straggler_detected" in kinds and "repartition" in kinds
    assert [o["shard"] for o in out] != [0, 1]       # it moved


@pytest.mark.parametrize("case", [
    dict(split_comms="allreduce"),
    dict(split_comms="reduce_scatter"),
    dict(grad_dtype="int8"),
    dict(mesh_shape=(2, 2)),
], ids=["f32-allreduce", "f32-reduce_scatter", "int8", "2x2"])
def test_four_rank_rotation_bit_exact(pools, tmp_path, case):
    """Four gloo ranks, three rotations: the trees are bitwise the
    undisturbed run's; the reduction does not depend on which rank holds
    which shard. On the f32 path the exact int64 wire makes them one
    device's trees too."""
    Xb, y = _binary(1603)
    kw = dict(n_trees=6, max_depth=3, n_bins=29, seed=4,
              straggler_repartition=True, **case)
    ref = pools(4).run(tasks.train_straggler, Xb, y, kw, None, None)
    out = pools(4).run(tasks.train_straggler, Xb, y, kw, STRAGGLER,
                       dict(checkpoint_every=2,
                            checkpoint_dir=str(tmp_path / "ck")))
    for o in out:
        _assert_ens_equal(ref[0]["ensemble"], o["ensemble"])
    assert out[0]["faults"].count("repartition") == 3
    rows = "mesh_shape" not in case
    assert [o["shard"] for o in out] == ([1, 2, 3, 0] if rows
                                         else [1, 1, 0, 0])
    if case.get("grad_dtype", "f32") == "f32" and rows:
        one = api.train(Xb, y, _cfg(**{k: v for k, v in kw.items()
                                       if k != "straggler_repartition"}),
                        binned=True, profile=True)
        _assert_ens_equal(one.ensemble, out[0]["ensemble"])


@pytest.mark.parametrize("cache", [0, 1 << 30], ids=["uncached",
                                                     "cached"])
def test_streamed_rotation_bit_exact(pools, tmp_path, cache):
    """The streamed trainer on two ranks over host-sharded chunks: the
    rotation moves the resident blocks, drops the chunk cache and
    rotates the slot -> process map, and the ensemble is the undisturbed
    run's."""
    from ddt_tpu_torch.data import chunks as chunks_lib

    Xb, y = _binary(2048, features=8, seed=4)
    d = str(tmp_path / "shards")
    chunks_lib.shard_arrays(Xb, y, d, n_chunks=4)
    kw = dict(n_trees=6, max_depth=3, n_bins=29, seed=4,
              straggler_repartition=True)
    ref = pools(2).run(tasks.train_streaming_straggler, d, 2, kw, None,
                       dict(device_chunk_cache=cache))
    out = pools(2).run(tasks.train_streaming_straggler, d, 2, kw, STRAGGLER,
                       dict(checkpoint_every=2, device_chunk_cache=cache,
                            checkpoint_dir=str(tmp_path / "ck")))
    for o in out:
        _assert_ens_equal(ref[0]["ensemble"], o["ensemble"])
    kinds = out[0]["faults"]
    assert "straggler_detected" in kinds and "repartition" in kinds
    # After the rotation each rank read the other's sub-shards too.
    assert set(out[0]["reads"]) > set(ref[0]["reads"])


def test_straggler_timed_task_counts_the_int64_wire(pools, tmp_path):
    """chip_smoke's straggler task on four gloo ranks: float rows from
    .npy files, flag off / on / rotating; the rotating run's trees are the
    undisturbed run's, each rotation is timed, and the modeled bytes a
    round follow the wire (the f32 path's int64 values under the flag:
    twice the histograms' bytes)."""
    from ddt_tpu_torch.data.datasets import synthetic_binary

    X, y = synthetic_binary(6000, n_features=10, seed=0)
    xp, yp = str(tmp_path / "x.npy"), str(tmp_path / "y.npy")
    np.save(xp, X)
    np.save(yp, y)
    kw = dict(n_trees=6, max_depth=4, n_bins=63)
    off = pools(4).run(tasks.straggler_timed, xp, yp, kw, None, None)
    on_kw = dict(kw, straggler_repartition=True)
    on = pools(4).run(tasks.straggler_timed, xp, yp, on_kw, None, None)
    hit = pools(4).run(tasks.straggler_timed, xp, yp, on_kw, STRAGGLER,
                       dict(checkpoint_every=2,
                            checkpoint_dir=str(tmp_path / "ck")))
    for r in hit:
        _assert_ens_equal(on[0]["ensemble"], r["ensemble"])
        assert len(r["rotation_ms"]) == 3
    for r in off + on:
        assert r["modeled_bytes"] == 6 * r["bytes_model"]
    assert on[0]["bytes_model"] > off[0]["bytes_model"]
    assert hit[0]["faults"].count("repartition") == 3


def test_partition_phases_carry_injected_straggler_lane(pools):
    Xb, y = _binary(1600)
    kw = dict(n_trees=3, max_depth=3, n_bins=29, seed=4)
    plan = {"faults": [{"site": "straggler", "device": 0,
                        "delay_ms": 123.0, "times": 1}]}
    out = pools(2).run(tasks.train_straggler, Xb, y, kw, plan, None)
    pp = out[0]["phases"]
    assert pp and not out[1]["phases"]         # rank 0 writes the log
    lanes = {p["device"]: p["phases"] for p in pp[0]["partitions"]}
    assert lanes[0].get("straggler_injected") == 123.0
    assert "straggler_injected" not in lanes[1]


# ------------------------------------------------------------------ #
# zero-overhead guard
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("loop", ["fused", "granular", "streamed"])
def test_no_plan_no_overhead_guard(monkeypatch, tmp_path, loop):
    """With no plan active, firing, backoff, perturbation and the
    ladder's step all explode if touched; training (checkpointed, so
    every seam runs) completes anyway, on each loop."""
    from ddt_tpu_torch.utils import retry as retry_mod

    def _boom(*a, **k):
        raise AssertionError("robustness slow path touched with no plan")

    monkeypatch.setattr(faultplan.FaultPlan, "fire", _boom)
    monkeypatch.setattr(faultplan.FaultPlan, "delay_ms", _boom)
    monkeypatch.setattr(retry_mod, "_backoff_loop", _boom)
    monkeypatch.setattr(retry_mod.time, "sleep", _boom)
    monkeypatch.setattr(hist_ops.tele_counters, "record_hist_oom_degrade",
                        _boom)
    Xb, y = _binary(900)
    cfg = _cfg(n_trees=4)
    if loop == "streamed":
        ens = fit_streaming(_chunks(Xb, y, 3), 3, cfg,
                            checkpoint_dir=str(tmp_path / "ck"),
                            checkpoint_every=2)
    else:
        ens = api.train(Xb, y, cfg, binned=True, profile=loop == "granular",
                        checkpoint_dir=str(tmp_path / "ck"),
                        checkpoint_every=2).ensemble
    assert ens.n_trees == 4


def test_atomic_save_model_and_ensemble(tmp_path):
    cfg = _cfg(n_trees=4)
    ens = _mk_ens(cfg, rounds_filled=2, seed=7)
    p = str(tmp_path / "model.npz")
    api.save_model(p, ens)
    assert os.path.exists(p) and not os.path.exists(p + ".tmp.npz")
    loaded = api.load_model(p)
    np.testing.assert_array_equal(loaded.ensemble.feature, ens.feature)
    bare = str(tmp_path / "bare")
    ens.save(bare)
    assert os.path.exists(bare + ".npz")
    TreeEnsemble.load(bare + ".npz")
