"""Process-level fault injection on the port's CLI, against
tests/test_faultinject.py: a real `python -m ddt_tpu_torch.cli train`
child is killed mid-run (SIGKILL after its first checkpoint, or the fault
plan's `ckpt.save.between` crash between the checkpoint pair's two
replaces), a second child resumes from the checkpoint directory, and the
final ensemble must be bitwise the uninterrupted run's, f32 and int8:
training is deterministic given binned data, and resume rescoring
replays the fit loop's own f32 order.

The children run on the CPU (`--device=cpu`; the SIGKILL case on the
`--backend=cpu` oracle, as the reference's runs its CPU backend).
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from ddt_tpu_torch.models.tree import TreeEnsemble

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("feature", "threshold_bin", "is_leaf", "leaf_value", "split_gain")


def _cli(args, **kw):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return subprocess.Popen(
        [sys.executable, "-m", "ddt_tpu_torch.cli", *args], cwd=REPO,
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, **kw)


def _equal(a_path, b_path):
    a, b = TreeEnsemble.load(a_path), TreeEnsemble.load(b_path)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                      err_msg=k)
    assert np.any(a.split_gain > 0)


# Sized so the kill lands well inside training: the oracle grows ~0.2 s
# a tree here and the first cursor appears at tree 2 of 24.
SIGKILL_ARGS = [
    "train", "--backend=cpu", "--dataset=higgs", "--rows=50000",
    "--bins=63", "--trees=24", "--depth=5", "--seed=7",
    "--checkpoint-every=2",
]


def test_sigkill_mid_training_then_resume_is_exact(tmp_path):
    ck = str(tmp_path / "ck")
    out_a = str(tmp_path / "interrupted.npz")
    out_b = str(tmp_path / "clean.npz")
    p = _cli(SIGKILL_ARGS + ["--checkpoint-dir", ck, "--out", out_a])
    cursor = os.path.join(ck, "cursor.json")
    deadline = time.time() + 240
    while time.time() < deadline:
        if os.path.exists(cursor):
            break
        if p.poll() is not None:
            pytest.fail("training finished before a checkpoint appeared; "
                        "slow the config down")
        time.sleep(0.05)
    else:
        p.kill()
        pytest.fail("no checkpoint appeared in time")
    os.kill(p.pid, signal.SIGKILL)
    p.wait()
    assert not os.path.exists(out_a), "model should not exist after SIGKILL"
    p2 = _cli(SIGKILL_ARGS + ["--checkpoint-dir", ck, "--out", out_a])
    assert p2.wait(timeout=240) == 0, p2.stderr.read()[-2000:]
    p3 = _cli(SIGKILL_ARGS + ["--checkpoint-dir", str(tmp_path / "ck2"),
                              "--out", out_b])
    assert p3.wait(timeout=240) == 0, p3.stderr.read()[-2000:]
    _equal(out_a, out_b)


@pytest.mark.parametrize("grad_dtype", ["f32", "int8"])
def test_ckpt_between_crash_then_resume_is_exact(tmp_path, grad_dtype):
    """The fault plan kills the child between the checkpoint pair's
    replaces (InjectedCrash, never retried): the torn pair falls back to
    the last good history pair, and the resumed child, without the plan,
    ends where the uninterrupted run ends."""
    args = ["train", "--device=cpu", "--dataset=higgs", "--rows=3000",
            "--bins=31", "--trees=8", "--depth=4", "--seed=3",
            f"--grad-dtype={grad_dtype}", "--checkpoint-every=2"]
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps(
        {"faults": [{"site": "ckpt.save.between", "round": 6}]}))
    ck = str(tmp_path / "ck")
    out_a = str(tmp_path / "resumed.npz")
    out_b = str(tmp_path / "clean.npz")
    p = _cli(args + ["--checkpoint-dir", ck, "--out", out_a,
                     f"--fault-plan={plan}"])
    assert p.wait(timeout=240) != 0
    assert b"InjectedCrash" in p.stderr.read()
    assert not os.path.exists(out_a)
    with open(os.path.join(ck, "cursor.json")) as f:
        assert json.load(f)["completed_rounds"] == 4   # the torn pair's
    p2 = _cli(args + ["--checkpoint-dir", ck, "--out", out_a])
    assert p2.wait(timeout=240) == 0, p2.stderr.read()[-2000:]
    p3 = _cli(args + ["--out", out_b])
    assert p3.wait(timeout=240) == 0, p3.stderr.read()[-2000:]
    _equal(out_a, out_b)
