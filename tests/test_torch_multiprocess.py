"""Real multi-process runs of the port, the twin of tests/
test_multiprocess.py: OS processes wired by parallel/mesh.
initialize_multihost over a tcp:// rendezvous on localhost (gloo on the
CPU), each training the same rows at n_partitions = the process count.
Every process's trees are bitwise equal to every other's (replicas of
one computation) on each path (the fused loop in int8, the granular loop
in f32 with an eval set, the streamed trainer in int8), and equal to one
process without a group: bitwise where the sums are exact (int8), but for
proven bf16 ties in f32 (the wire sums f32). The one-process models are
held against the reference on the same seeded rows with tests/
tree_compare.py's comparator: int8 (the fused loop, the streamed
trainer) against its device backend on JAX-CPU (its CPU backend refuses
quantized gradients), f32 (the granular loop) against its CPU backend.
Also the guard that makes a repeated initialize_multihost a no-op or an
error, and `cli train --multihost-*` in two processes, held the same way
against the reference's `cli train` on one process.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from ddt_tpu import api as japi
from ddt_tpu.cli import main as jmain
from ddt_tpu.config import TrainConfig as JConfig
from ddt_tpu.data import datasets as jdatasets
from ddt_tpu.data.quantizer import quantize as jquantize
from ddt_tpu.models.tree import TreeEnsemble as JEnsemble
from ddt_tpu.streaming import fit_streaming as jfit_streaming
from ddt_tpu_torch.data import datasets
from ddt_tpu_torch.data.quantizer import quantize
from ddt_tpu_torch.models.tree import TreeEnsemble
from ddt_tpu_torch.parallel import mesh
from tree_compare import assert_trees_match_mod_ties

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("feature", "threshold_bin", "is_leaf", "leaf_value")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _wait(procs, what: str) -> None:
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), (
        f"{what} failed:\n" + "\n----\n".join(x[-3000:] for x in logs))


def _worker(init, world, rank, out):
    code = ("import sys; from ddt_tpu_torch.parallel import tasks; "
            "tasks.multihost_train(sys.argv[1], int(sys.argv[2]), "
            "int(sys.argv[3]), sys.argv[4])")
    return subprocess.Popen(
        [sys.executable, "-c", code, init, str(world), str(rank), out],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


@pytest.fixture(scope="module")
def reference_models():
    """The reference's models of parallel/tasks.multihost_train's three
    paths, on the same seeded rows (seed 21), which both packages bin
    alike."""
    X, y = jdatasets.synthetic_binary(2048, n_features=8, seed=21)
    Xb = jquantize(X, n_bins=31, seed=21)[0]
    Xp, yp = datasets.synthetic_binary(2048, n_features=8, seed=21)
    np.testing.assert_array_equal(Xb, quantize(Xp, n_bins=31, seed=21)[0])
    np.testing.assert_array_equal(y, yp)
    base = dict(n_trees=3, max_depth=4, n_bins=31)
    int8 = JConfig(backend="tpu", grad_dtype="int8", **base)
    bounds = np.linspace(0, len(y), 5).astype(np.int64)

    def chunk_fn(c):
        return Xb[bounds[c]:bounds[c + 1]], y[bounds[c]:bounds[c + 1]]

    return {
        "fused": japi.train(Xb, y, int8, binned=True,
                            log_every=10**9).ensemble,
        "granular": japi.train(Xb[:1536], y[:1536],
                               JConfig(backend="cpu", **base), binned=True,
                               log_every=10**9,
                               eval_set=(Xb[1536:], y[1536:])).ensemble,
        "streamed": jfit_streaming(chunk_fn, 4, int8)}


@pytest.mark.parametrize("nproc", [2, 4], ids=["2proc", "4proc"])
def test_multiprocess_bringup_bit_identical(nproc, tmp_path,
                                            reference_models):
    init = f"tcp://localhost:{_free_port()}"
    outs = [str(tmp_path / f"p{i}_") for i in range(nproc)]
    single = str(tmp_path / "single_")
    procs = [_worker(init, nproc, i, outs[i]) for i in range(nproc)]
    procs.append(_worker("unused", 1, 0, single))
    _wait(procs, "multihost worker")
    for name in ("fused", "granular", "streamed"):
        ens = [TreeEnsemble.load(f"{o}{name}.npz") for o in outs]
        one = TreeEnsemble.load(f"{single}{name}.npz")
        for i in range(1, nproc):
            for k in FIELDS:
                np.testing.assert_array_equal(
                    getattr(ens[0], k), getattr(ens[i], k),
                    err_msg=f"process {i} {name} {k}")
        assert_trees_match_mod_ties(reference_models[name], one, 0.0)
        if name == "granular":     # f32: the wire sums f32
            assert_trees_match_mod_ties(one, ens[0], 0.0)
        else:                      # int8: exact sums
            for k in FIELDS:
                np.testing.assert_array_equal(getattr(one, k),
                                              getattr(ens[0], k),
                                              err_msg=f"{name} {k}")


def test_initialize_multihost_guard(monkeypatch):
    """The idempotence guard, in process: with a live group a repeat call
    with the same arguments does nothing, with others it raises (a live
    group cannot be re-wired). No rendezvous is made: the guard answers
    first."""
    args = dict(init_method="tcp://localhost:1", world_size=2, rank=0,
                backend="gloo")
    monkeypatch.setattr(mesh, "_init_args", args)
    monkeypatch.setattr(mesh.dist, "is_initialized", lambda: True)

    def no_init(*a, **k):
        raise AssertionError("the guard let a second bootstrap through")

    monkeypatch.setattr(mesh.dist, "init_process_group", no_init)
    mesh.initialize_multihost("tcp://localhost:1", 2, 0, backend="gloo")
    with pytest.raises(RuntimeError, match="cannot re-initialise"):
        mesh.initialize_multihost("tcp://localhost:1", 2, 1, backend="gloo")


def test_cli_multihost_train(tmp_path):
    """`cli train --multihost-*` in two OS processes running the same
    command: each joins the group (gloo), trains its row block and
    writes its own --out; the two models are bitwise equal, and equal to
    the reference's `cli train` of all the rows on its CPU backend but
    for proven bf16 ties (the wire sums f32)."""
    port = _free_port()
    outs = [str(tmp_path / f"cli{i}.npz") for i in range(2)]
    args = ["--rows=2048", "--trees=3", "--depth=3", "--bins=31"]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ddt_tpu_torch.cli", "train", "--device=cpu",
         *args, "--partitions=2", f"--multihost-coordinator=localhost:{port}",
         "--multihost-processes=2", f"--multihost-id={i}",
         f"--out={outs[i]}"], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(2)]
    _wait(procs, "cli multihost worker")
    a, b = (TreeEnsemble.load(o) for o in outs)
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                      err_msg=k)
    assert a.n_trees == 3
    ref = str(tmp_path / "ref.npz")
    assert jmain(["train", "--backend=cpu", *args, f"--out={ref}"]) == 0
    assert_trees_match_mod_ties(JEnsemble.load(ref), a, 0.0)


@pytest.mark.parametrize("rank", [0, 1, 3])
def test_initialize_multihost_binds_each_nccl_process_to_its_card(
        monkeypatch, rank):
    """A process started without a launcher's LOCAL_RANK (`cli train
    --multihost-*` by hand) is bound to the card of its rank before the
    NCCL rendezvous, not every process to card 0 (which NCCL refuses).
    The card calls are faked: no card is needed, no group is made."""
    seen = {}
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.setattr(mesh, "_init_args", None)
    monkeypatch.setattr(mesh.torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(mesh.torch.cuda, "set_device",
                        lambda d: seen.setdefault("set", d))
    monkeypatch.setattr(mesh.torch.cuda, "current_device",
                        lambda: seen["set"])

    def fake_init(backend, **kw):
        seen["backend"], seen["device_id"] = backend, kw["device_id"]

    monkeypatch.setattr(mesh.dist, "init_process_group", fake_init)
    mesh.initialize_multihost("tcp://localhost:1", 4, rank, backend="nccl")
    assert seen["backend"] == "nccl" and seen["set"] == rank
    assert seen["device_id"] == mesh.torch.device("cuda", rank)
    monkeypatch.setattr(mesh, "_init_args", None)
