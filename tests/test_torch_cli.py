"""The port's command line against ddt_tpu's on the CPU (mirrors
tests/test_cli.py case by case, `--device cpu` in place of the
reference's `--backend`; `bench` in tests/test_torch_bench.py), with its
refusals and
the registry workflow (tests/test_registry.py::test_cli_registry_workflow).

Models trained through both CLIs on the same seeded dataset are compared
through tests/tree_compare.py (f32 histograms: equal but at split-gain
ties); artifacts and scores of the port's own commands are held to its
API bitwise.
"""

import json
import os

import numpy as np
import pytest

from ddt_tpu.cli import main as jmain
from ddt_tpu_torch import api
from ddt_tpu_torch.backends import get_backend
from ddt_tpu_torch.cli import main
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.data.datasets import synthetic_binary
from ddt_tpu_torch.driver import Driver
from ddt_tpu_torch.models.tree import TreeEnsemble
from ddt_tpu_torch.parallel import spawn, tasks
from tree_compare import assert_trees_match_mod_ties


def _run(capsys, argv, entry=main):
    rc = entry(argv)
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


def test_cli_train_predict_roundtrip(tmp_path, capsys):
    model = str(tmp_path / "ens.npz")
    rec = _run(capsys, ["train", "--device=cpu", "--dataset=higgs",
                        "--rows=2000", "--trees=4", "--depth=3", "--bins=31",
                        f"--out={model}"])
    assert rec["trees"] == 4 and rec["device"] == "cpu"
    assert rec["final_train_loss"] < 0.693
    scores = str(tmp_path / "scores.npy")
    rec = _run(capsys, ["predict", "--device=cpu", f"--model={model}",
                        "--dataset=higgs", "--rows=500", "--bins=31",
                        f"--out={scores}"])
    assert rec["rows"] == 500
    s = np.load(scores)
    assert s.shape == (500,) and (0 <= s).all() and (s <= 1).all()
    X, _ = synthetic_binary(500, seed=0)
    np.testing.assert_array_equal(s, api.predict(api.load_model(model), X,
                                                 device="cpu"))


def test_cli_model_matches_the_reference_cli(tmp_path, capsys):
    """The same command through both CLIs (the reference on JAX-CPU):
    trees equal but at ties."""
    a, b = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    argv = ["train", "--dataset=higgs", "--rows=3000", "--trees=5",
            "--depth=4", "--bins=31"]
    _run(capsys, argv + ["--backend=tpu", f"--out={a}"], entry=jmain)
    _run(capsys, argv + ["--device=cpu", f"--out={b}"])
    ref, port = TreeEnsemble.load(a), TreeEnsemble.load(b)
    assert_trees_match_mod_ties(ref, port, 0.0, leaf_rtol=2e-4,
                                leaf_atol=2e-5)


@pytest.mark.parametrize("tier", [None, "int8", "int4"])
def test_cli_predict_tiers_equal_api_predict(tmp_path, capsys, tier):
    model = str(tmp_path / "m.npz")
    _run(capsys, ["train", "--device=cpu", "--rows=2000", "--trees=6",
                  "--depth=4", "--bins=31", f"--out={model}"])
    out = str(tmp_path / "s.npy")
    argv = ["predict", "--device=cpu", f"--model={model}", "--rows=700",
            "--bins=31", f"--out={out}", "--seed=3"]
    rec = _run(capsys, argv + ([f"--quantized={tier}"] if tier else []))
    assert rec["quantized"] == tier
    X, _ = synthetic_binary(700, seed=3)
    impl = {None: "auto", "int8": "lut", "int4": "lut4"}[tier]
    want = api.predict(api.load_model(model), X,
                       cfg=TrainConfig(device="cpu", predict_impl=impl))
    np.testing.assert_array_equal(np.load(out), want)


@pytest.fixture(scope="module")
def pool():
    p = spawn.Pool(4, backend="gloo", device="cpu", timeout_s=120.0)
    yield p
    p.close()


def test_cli_train_with_partitions_on_ranks(pool, tmp_path):
    """--partitions 4 on four ranks (parallel/spawn; torchrun on real
    hosts): every rank trains the one-process model; rank 0 writes it."""
    out = str(tmp_path / "p.npz")
    recs = pool.run(tasks.cli, ["train", "--dataset=higgs", "--rows=2000",
                                "--trees=3", "--depth=3", "--bins=31",
                                "--partitions=4", f"--out={out}"])
    assert [r["trees"] for r in recs] == [3] * 4
    one = str(tmp_path / "one.npz")
    main(["train", "--device=cpu", "--dataset=higgs", "--rows=2000",
          "--trees=3", "--depth=3", "--bins=31", f"--out={one}"])
    assert_trees_match_mod_ties(TreeEnsemble.load(one),
                                TreeEnsemble.load(out), 0.0,
                                leaf_rtol=2e-4, leaf_atol=2e-5)


def test_cli_train_feature_partitions_and_early_stop(pool, tmp_path):
    out = str(tmp_path / "m.npz")
    recs = pool.run(tasks.cli, [
        "train", "--dataset=higgs", "--rows=2000", "--bins=31",
        "--trees=12", "--depth=3", "--partitions=2",
        "--feature-partitions=2", "--out", out, "--valid-frac=0.2",
        "--metric=auc", "--early-stop=8"])
    rec = recs[0]
    assert rec["best_round"] >= 1 and 0.5 < rec["best_score"] <= 1.0
    assert rec["trees"] <= 12
    assert all(r["best_round"] == rec["best_round"] for r in recs)


def test_cli_partitions_without_ranks_refuse(tmp_path):
    with pytest.raises(SystemExit, match="process group"):
        main(["train", "--device=cpu", "--rows=500", "--trees=1",
              "--depth=2", "--bins=15", "--partitions=4",
              f"--out={tmp_path / 'x.npz'}"])


def test_cli_covertype_softmax(tmp_path, capsys):
    model = str(tmp_path / "cov.npz")
    _run(capsys, ["train", "--device=cpu", "--dataset=covertype",
                  "--rows=1500", "--trees=2", "--depth=3", "--bins=31",
                  f"--out={model}"])
    ens = TreeEnsemble.load(model)
    assert ens.loss == "softmax" and ens.n_classes == 7
    assert ens.n_trees == 2 * 7


def test_cli_criteo_categoricals(tmp_path, capsys):
    rec = _run(capsys, ["train", "--device=cpu", "--dataset=criteo",
                        "--rows=2000", "--trees=2", "--depth=3", "--bins=100",
                        f"--out={tmp_path / 'c.npz'}"])
    assert rec["final_train_loss"] < 0.60
    rec = _run(capsys, ["train", "--device=cpu", "--dataset=criteo",
                        "--rows=2000", "--trees=2", "--depth=3", "--bins=100",
                        "--cat-splits=onehot", f"--out={tmp_path / 'o.npz'}"])
    assert len(TreeEnsemble.load(str(tmp_path / "o.npz")).cat_features)


@pytest.mark.parametrize("flag", ["--hist-impl=segment"])
def test_cli_unported_flags_are_absent(tmp_path, flag):
    """The reference's flags for fields the port lacks are refused, not
    ignored."""
    with pytest.raises(SystemExit):
        main(["train", "--device=cpu", "--rows=100", "--trees=1",
              "--depth=2", "--bins=15", flag,
              f"--out={tmp_path / 'x.npz'}"])


@pytest.mark.parametrize("flags", [["--multihost-coordinator=h:1"],
                                   ["--multihost-coordinator=h:1",
                                    "--multihost-id=0"]])
def test_cli_multihost_coordinator_needs_processes(tmp_path, flags):
    """--multihost-coordinator without --multihost-processes is refused
    before any rendezvous, as the reference refuses it (no cluster to
    discover the process count from)."""
    with pytest.raises(SystemExit, match="multihost"):
        main(["train", "--device=cpu", "--rows=100", "--trees=1",
              "--depth=2", "--bins=15", *flags,
              f"--out={tmp_path / 'x.npz'}"])


@pytest.mark.parametrize("flags,field,want", [
    (["--backend=cpu"], "backend", "cpu"),
    (["--fault-plan={plan}"], "fault_plan", "plan"),
    (["--straggler-repartition"], "straggler_repartition", True),
    (["--straggler-skew-threshold=3.5"], "straggler_skew_threshold", 3.5),
])
def test_cli_robustness_flags(tmp_path, capsys, monkeypatch, flags, field,
                              want):
    """The flags ported with the robustness slice reach the run's
    TrainConfig (a fault plan is armed for the run and disarmed after)."""
    import json as _json

    from ddt_tpu_torch import api as tapi
    from ddt_tpu_torch.robustness import faultplan

    plan = tmp_path / "p.json"
    plan.write_text(_json.dumps({"faults": [{"site": "fetch_tree"}]}))
    seen = {}
    real = tapi.train

    def spy(X, y, cfg=None, **kw):
        seen["cfg"] = cfg
        seen["plan"] = faultplan.active_plan()
        return real(X, y, cfg, **kw)

    monkeypatch.setattr(tapi, "train", spy)
    _run(capsys, ["train", "--device=cpu", "--rows=100", "--trees=1",
                  "--depth=2", "--bins=15",
                  *[f.format(plan=plan) for f in flags],
                  f"--out={tmp_path / 'x.npz'}"])
    got = getattr(seen["cfg"], field)
    assert got == (str(plan) if want == "plan" else want)
    assert (seen["plan"] is not None) == (field == "fault_plan")
    assert faultplan.active_plan() is None


def test_cli_unknown_device_fails_loudly(tmp_path):
    with pytest.raises(SystemExit):
        main(["train", "--device=fpga", "--dataset=higgs", "--rows=100",
              "--trees=1", "--depth=2", "--bins=15",
              f"--out={tmp_path / 'x.npz'}"])


def test_cli_fpga_backend_fails_loudly(tmp_path):
    from ddt_tpu_torch.backends import FPGADevice

    with pytest.raises(NotImplementedError, match="FPGA"):
        main(["train", "--backend=fpga", "--dataset=higgs", "--rows=100",
              "--trees=1", "--depth=2", "--bins=15",
              f"--out={tmp_path / 'x.npz'}"])
    cfg = TrainConfig(backend="fpga")
    with pytest.raises(NotImplementedError, match="FPGA") as err:
        get_backend(cfg)
    assert "'cuda'" in str(err.value) and "'cpu'" in str(err.value)
    with pytest.raises(NotImplementedError, match="FPGA"):
        FPGADevice(cfg)
    assert not (tmp_path / "x.npz").exists()


def test_cli_cuda_without_a_card_refuses(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cmd in (["train", "--rows=100"],
                ["predict", f"--model={tmp_path / 'm.npz'}"]):
        with pytest.raises(SystemExit, match="--device cpu"):
            main(cmd + ["--device=cuda"])


def test_cli_inspect(tmp_path, capsys):
    model = str(tmp_path / "ens.npz")
    _run(capsys, ["train", "--device=cpu", "--dataset=higgs", "--rows=2000",
                  "--trees=4", "--depth=3", "--bins=31", f"--out={model}"])
    assert main(["inspect", f"--model={model}", "--tree=0",
                 "--importance=gain"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(out[0])
    assert rec["n_trees"] == 4 and rec["n_splits"] > 0
    assert rec["top_features_by_gain"]
    assert out[1].startswith(("f", "leaf="))
    assert jmain(["inspect", f"--model={model}", "--tree=0",
                  "--importance=gain"]) == 0
    ref = capsys.readouterr().out.strip().splitlines()
    assert ref[1:] == out[1:]
    assert json.loads(ref[0]) == rec
    with pytest.raises(SystemExit):
        main(["inspect", f"--model={model}", "--tree=99"])


def test_cli_train_streaming(tmp_path, capsys):
    model = str(tmp_path / "s.npz")
    rec = _run(capsys, ["train", "--device=cpu", "--rows=4000", "--trees=4",
                        "--depth=3", "--bins=31", "--stream-chunks=4",
                        f"--out={model}"])
    assert rec["streamed_chunks"] == 4 and rec["trees"] == 4
    b = api.load_model(model)
    assert b.mapper is not None
    X, y = synthetic_binary(4000, seed=0)
    cfg = TrainConfig(n_trees=4, max_depth=3, n_bins=31, device="cpu")
    full = Driver(get_backend(cfg), cfg).fit(b.mapper.transform(X), y)
    np.testing.assert_array_equal(full.feature, b.ensemble.feature)
    with pytest.raises(SystemExit, match="valid-frac"):
        main(["train", "--device=cpu", "--rows=1000", "--trees=2",
              "--stream-chunks=2", "--early-stop=2"])
    with pytest.raises(SystemExit, match="exceeds the row count"):
        main(["train", "--device=cpu", "--rows=3", "--trees=2",
              "--stream-chunks=4"])


def test_cli_train_streaming_validation(tmp_path, capsys):
    rec = _run(capsys, ["train", "--device=cpu", "--rows=3000", "--trees=25",
                        "--depth=3", "--bins=31", "--stream-chunks=3",
                        "--valid-frac=0.25", "--metric=auc",
                        "--early-stop=3", "--lr=0.9",
                        f"--out={tmp_path / 's.npz'}"])
    assert rec["best_round"] >= 1 and 0.5 < rec["best_score"] <= 1.0
    assert rec["trees"] == rec["best_round"] < 25


def test_cli_stream_dir_train_and_predict(tmp_path, capsys):
    """--stream-dir trains from npz shards and predict --stream-dir
    scores them shard by shard, equal to the in-memory scores."""
    from ddt_tpu_torch.data import chunks

    X, y = synthetic_binary(3000, seed=2)
    shards = str(tmp_path / "shards")
    chunks.shard_arrays(X, y, shards, n_chunks=3)
    model = str(tmp_path / "m.npz")
    rec = _run(capsys, ["train", "--device=cpu", f"--stream-dir={shards}",
                        "--trees=3", "--depth=3", "--bins=31",
                        f"--out={model}"])
    assert rec["streamed_chunks"] == 3
    with pytest.raises(SystemExit, match="drop --stream-chunks"):
        main(["train", "--device=cpu", f"--stream-dir={shards}",
              "--stream-chunks=2", f"--out={model}"])
    out = str(tmp_path / "scores")
    rec = _run(capsys, ["predict", "--device=cpu", f"--model={model}",
                        f"--stream-dir={shards}", f"--out={out}"])
    assert rec["rows"] == 3000 and rec["streamed_chunks"] == 3
    got = np.concatenate([np.load(os.path.join(out, f"scores_{c:05d}.npy"))
                          for c in range(3)])
    np.testing.assert_array_equal(
        got, api.predict(api.load_model(model), X, device="cpu"))


def test_cli_config_file(tmp_path, capsys):
    yml = tmp_path / "c.yaml"
    yml.write_text("n_trees: 5\nmax_depth: 3\nreg_lambda: 2.5\n")
    model = str(tmp_path / "m.npz")
    rec = _run(capsys, ["train", "--device=cpu", "--rows=1000",
                        "--trees=99", "--bins=31", f"--config={yml}",
                        f"--out={model}"])
    assert rec["trees"] == 5 and rec["depth"] == 3
    js = tmp_path / "c.json"
    js.write_text('{"n_trees": 4, "learning_rate": 0.2}')
    rec = _run(capsys, ["train", "--device=cpu", "--rows=1000", "--bins=31",
                        f"--config={js}", f"--out={model}"])
    assert rec["trees"] == 4
    bad = tmp_path / "bad.json"
    bad.write_text('{"n_treez": 4}')
    with pytest.raises(SystemExit, match="n_treez"):
        main(["train", "--device=cpu", "--rows=500", f"--config={bad}"])
    with pytest.raises(SystemExit, match="config"):
        main(["train", "--device=cpu", "--rows=500",
              "--config=/nonexistent.yaml"])
    unported = tmp_path / "u.json"
    unported.write_text('{"hist_impl": "segment"}')
    with pytest.raises(SystemExit, match="hist_impl"):
        main(["train", "--device=cpu", "--rows=500",
              f"--config={unported}"])
    c = TrainConfig.from_file(str(yml))
    assert (c.n_trees, c.max_depth, c.reg_lambda) == (5, 3, 2.5)


def test_cli_config_file_syncs_pipeline_fields(tmp_path, capsys):
    js = tmp_path / "c.json"
    js.write_text('{"device": "cpu", "n_trees": 3, "seed": 7}')
    rec = _run(capsys, ["train", "--device=cuda", "--rows=800", "--bins=31",
                        f"--config={js}", f"--out={tmp_path / 'm.npz'}"])
    assert rec["device"] == "cpu"
    bag = tmp_path / "bag.yaml"
    bag.write_text("subsample: 0.5\nn_trees: 3\n")
    model2 = str(tmp_path / "bagged.npz")
    rec = _run(capsys, ["train", "--device=cpu", "--rows=800", "--bins=31",
                        "--stream-chunks=2", f"--config={bag}",
                        f"--out={model2}"])
    assert rec["streamed_chunks"] == 2 and os.path.exists(model2)
    with pytest.raises(SystemExit, match="trace-dir"):
        main(["train", "--device=cpu", "--rows=800", "--bins=31",
              "--stream-chunks=2", "--trace-dir", str(tmp_path / "tr")])
    model3 = str(tmp_path / "profiled.npz")
    rec = _run(capsys, ["train", "--device=cpu", "--rows=800", "--bins=31",
                        "--stream-chunks=2", "--profile", f"--config={bag}",
                        f"--out={model3}"])
    assert rec["streamed_chunks"] == 2 and os.path.exists(model3)


def test_cli_xprof_rounds_refuses_a_bad_window(tmp_path):
    with pytest.raises(SystemExit, match="xprof-rounds"):
        main(["train", "--device=cpu", "--rows=300", "--trees=2",
              "--xprof-dir", str(tmp_path), "--xprof-rounds", "5:2"])


def test_cli_report_and_trace_fail_loudly_on_garbage(tmp_path):
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"event": "nonsense", "schema": 1, "t": 0, "seq": 0}\n'
                   '{"event": "run_end"}\n')
    with pytest.raises(SystemExit, match="unknown run-log event"):
        main(["report", "--log", str(bad)])
    with pytest.raises(SystemExit, match="report:"):
        main(["report", "--log", str(tmp_path / "missing.jsonl")])
    with pytest.raises(SystemExit, match="trace:"):
        main(["trace", "--log", str(bad), "--out",
              str(tmp_path / "t.json")])
    with pytest.raises(SystemExit, match="report diff:"):
        main(["report", "diff", str(bad), str(bad)])
    with pytest.raises(SystemExit):
        main(["report"])                          # no --log


@pytest.mark.parametrize("sub", ["fleet", "slo", "drift"])
def test_cli_report_rollups_fail_loudly_without_their_data(tmp_path, sub,
                                                           capsys):
    log = str(tmp_path / "r.jsonl")
    _run(capsys, ["train", "--device=cpu", "--rows=600", "--trees=2",
                  "--depth=2", "--bins=15", f"--run-log={log}",
                  f"--out={tmp_path / 'm.npz'}"])
    with pytest.raises(SystemExit, match="report:"):
        main(["report", "--log", log, sub])
    with pytest.raises(SystemExit, match="report:"):
        jmain(["report", "--log", log, sub])


def test_cli_train_run_log_round_trip(tmp_path, capsys):
    """train --run-log, then report (both packages' renderings equal),
    report --json and trace."""
    log = str(tmp_path / "run.jsonl")
    rec = _run(capsys, ["train", "--device=cpu", "--dataset=higgs",
                        "--rows=2357", "--trees=3", "--depth=3", "--bins=23",
                        "--valid-frac=0.2", f"--run-log={log}",
                        f"--out={tmp_path / 'ens.npz'}"])
    assert rec["run_log"] == log and rec["run_id"]
    summary = _run(capsys, ["report", "--log", log, "--json"])
    assert summary["phases"] and summary["metric"] == "logloss"
    assert [c["round"] for c in summary["metric_curve"]] == [1, 2, 3]
    assert summary["completed_rounds"] == 3
    assert summary["counters"]["jit_compiles"] == 0     # no card here
    assert main(["report", "--log", log]) == 0
    text = capsys.readouterr().out
    assert jmain(["report", "--log", log]) == 0
    assert capsys.readouterr().out == text
    assert "phases (host wallclock):" in text and "jit_compiles=" in text
    tr = _run(capsys, ["trace", "--log", log, "--out",
                       str(tmp_path / "t.json")])
    assert tr["events"] > 0 and tr["trace_events"] > 0
    bundle = api.load_model(str(tmp_path / "ens.npz"))
    assert bundle.manifest["run_id"] == rec["run_id"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    d = tmp_path_factory.mktemp("reg")
    X, y = synthetic_binary(2000, n_features=8, seed=1)
    res = api.train(X, y, TrainConfig(device="cpu", n_trees=5, max_depth=3,
                                      n_bins=31))
    path = str(d / "m.npz")
    res.save(path)
    return {"path": path, "X": X}


def test_cli_registry_workflow(trained, tmp_path, capsys):
    """push (with a tag and a run log) -> list -> tag -> get, and the
    refusals; the served artifact scores like the file."""
    root = str(tmp_path / "reg")
    log = str(tmp_path / "reg.jsonl")
    a = _run(capsys, ["registry", "--registry", root, "push", "--model",
                      trained["path"], "--name", "higgs", "--tag", "prod",
                      "--run-log", log])
    assert a["cmd"] == "registry_push" and a["version"] == 1
    b = _run(capsys, ["registry", "--registry", root, "push", "--model",
                      trained["path"], "--name", "higgs", "--quantize",
                      "int4"])
    assert b["version"] == 2 and b["digest"] != a["digest"]
    assert main(["registry", "--registry", root, "list"]) == 0
    text = capsys.readouterr().out
    assert "higgs@1" in text and "[prod]" in text and "higgs@2" in text
    inv = _run(capsys, ["registry", "--registry", root, "list", "--json"])
    assert [v["version"] for v in inv["names"]["higgs"]["versions"]] == \
        [1, 2]
    t = _run(capsys, ["registry", "--registry", root, "tag", "higgs@2",
                      "prod"])
    assert t["cmd"] == "registry_tag"
    g = _run(capsys, ["registry", "--registry", root, "get", "higgs@prod"])
    assert g["digest"] == b["digest"] and g["n_files"] > 0
    events = [json.loads(line) for line in open(log)]
    assert [e["event"] for e in events] == ["artifact"]
    assert events[0]["action"] == "push"
    with pytest.raises(SystemExit, match="registry get"):
        main(["registry", "--registry", root, "get", "nope@9"])
    with pytest.raises(SystemExit, match="registry push"):
        main(["registry", "--registry", root, "push", "--model",
              trained["path"], "--tag", "x"])
    with pytest.raises(SystemExit, match="registry push"):
        main(["registry", "--registry", root, "push", "--model",
              str(tmp_path / "missing.npz")])


# tests/test_chunks.py's CLI cases: --stream-dir shard directories.

def test_cli_stream_dir_matches_stream_chunks(tmp_path, capsys):
    from ddt_tpu_torch.data import chunks

    X, y = synthetic_binary(3000, n_features=8, seed=0)
    d = str(tmp_path / "shards")
    chunks.shard_arrays(X, y, d, n_chunks=3)
    src = str(tmp_path / "data.npz")
    np.savez(src, X=X, y=y)
    m_mem, m_dir = str(tmp_path / "mem.npz"), str(tmp_path / "dir.npz")
    rec = _run(capsys, ["train", "--device=cpu", f"--data={src}",
                        "--trees=3", "--depth=3", "--bins=31",
                        "--stream-chunks=3", f"--out={m_mem}"])
    rec2 = _run(capsys, ["train", "--device=cpu", "--trees=3", "--depth=3",
                         "--bins=31", f"--stream-dir={d}", f"--out={m_dir}"])
    assert rec["rows"] == rec2["rows"] == 3000
    e1, e2 = TreeEnsemble.load(m_mem), TreeEnsemble.load(m_dir)
    for k in ("feature", "threshold_bin", "leaf_value"):
        np.testing.assert_array_equal(getattr(e1, k), getattr(e2, k))


def test_cli_stream_dir_validation_and_cache_modes(tmp_path, capsys):
    from ddt_tpu_torch.data import chunks

    X, y = synthetic_binary(3000, n_features=8, seed=2)
    d = str(tmp_path / "shards")
    chunks.shard_arrays(X, y, d, n_chunks=4)
    cache = str(tmp_path / "cache")
    m1, m2 = str(tmp_path / "m1.npz"), str(tmp_path / "m2.npz")
    common = ["train", "--device=cpu", "--trees=6", "--depth=3",
              "--bins=31", f"--stream-dir={d}", "--valid-frac=0.25",
              "--metric=auc", "--early-stop=4"]
    rec = _run(capsys, common + [f"--stream-cache-dir={cache}",
                                 f"--out={m1}"])
    assert rec["streamed_chunks"] == 3 and rec["rows"] == 2250
    assert "best_score" in rec
    cached = chunks.directory_chunks(str(tmp_path / "cache" / "train"))
    assert cached.binned and cached.n_chunks == 3
    _run(capsys, common + ["--stream-cache-dir=", f"--out={m2}"])
    e1, e2 = TreeEnsemble.load(m1), TreeEnsemble.load(m2)
    np.testing.assert_array_equal(e1.feature, e2.feature)
    np.testing.assert_array_equal(e1.leaf_value, e2.leaf_value)
    with pytest.raises(SystemExit, match="holds out all"):
        main(common[:-3] + ["--valid-frac=1.0", f"--out={m2}"])


def test_cli_stream_dir_prebinned(tmp_path, capsys):
    from ddt_tpu_torch.data import chunks
    from ddt_tpu_torch.data.datasets import stress_binned_chunk

    Xb, y = stress_binned_chunk(0, 1200, n_features=16, seed=7)
    d = str(tmp_path / "binned")
    chunks.shard_arrays(Xb, y, d, n_chunks=3)
    assert chunks.directory_chunks(d).binned
    m = str(tmp_path / "m.npz")
    rec = _run(capsys, ["train", "--device=cpu", "--trees=2", "--depth=3",
                        "--bins=255", f"--stream-dir={d}", f"--out={m}"])
    assert rec["trees"] == 2
    b = api.load_model(m)
    assert b.mapper is None
    p = b.ensemble.predict(Xb, binned=True)
    assert p[y == 1].mean() > p[y == 0].mean()


def test_cli_predict_stream_dir(tmp_path, capsys):
    from ddt_tpu_torch.data import chunks
    from ddt_tpu_torch.data.datasets import stress_binned_chunk

    Xb, yb = stress_binned_chunk(0, 900, n_features=16, seed=8)
    db = str(tmp_path / "binned")
    chunks.shard_arrays(Xb, yb, db, n_chunks=2)
    mb = str(tmp_path / "mb.npz")
    _run(capsys, ["train", "--device=cpu", "--trees=2", "--depth=3",
                  "--bins=255", f"--stream-dir={db}", f"--out={mb}"])
    out = str(tmp_path / "sb")
    rec = _run(capsys, ["predict", "--device=cpu", f"--model={mb}",
                        f"--stream-dir={db}", f"--out={out}"])
    assert rec["rows"] == 900
    got = np.concatenate([np.load(os.path.join(out, f"scores_{c:05d}.npy"))
                          for c in range(2)])
    np.testing.assert_array_equal(
        got, api.predict(TreeEnsemble.load(mb), Xb, binned=True,
                         device="cpu"))


def test_cli_predict_stream_dir_guards(tmp_path, capsys):
    from ddt_tpu_torch.data import chunks
    from ddt_tpu_torch.data.datasets import stress_binned_chunk

    m = str(tmp_path / "cm.npz")
    _run(capsys, ["train", "--device=cpu", "--dataset=criteo", "--rows=1200",
                  "--trees=2", "--depth=3", "--bins=31", f"--out={m}"])
    X, y = synthetic_binary(600, n_features=8, seed=1)
    d = str(tmp_path / "raw")
    chunks.shard_arrays(X, y, d, n_chunks=2)
    with pytest.raises(SystemExit, match="categorical encoder"):
        main(["predict", "--device=cpu", f"--model={m}",
              f"--stream-dir={d}", f"--out={tmp_path / 's'}"])
    Xb, yb = stress_binned_chunk(0, 800, n_features=16, seed=2)
    db = str(tmp_path / "b16")
    chunks.shard_arrays(Xb, yb, db, n_chunks=2)
    mb = str(tmp_path / "mb.npz")
    _run(capsys, ["train", "--device=cpu", "--trees=2", "--depth=2",
                  "--bins=255", f"--stream-dir={db}", f"--out={mb}"])
    Xw, yw = stress_binned_chunk(0, 800, n_features=24, seed=2)
    dw = str(tmp_path / "b24")
    chunks.shard_arrays(Xw, yw, dw, n_chunks=2)
    with pytest.raises(SystemExit, match="24 features"):
        main(["predict", "--device=cpu", f"--model={mb}",
              f"--stream-dir={dw}", f"--out={tmp_path / 's2'}"])


def test_cli_train_streams_through_the_cpu_oracle(tmp_path, capsys):
    """`train --backend cpu --stream-chunks N` runs fit_streaming's host
    loop (the CPU oracle has no stream_* surface): the trees equal the
    in-memory oracle fit of the same rows but for proven bf16 ties."""
    from tree_compare import assert_trees_match_mod_ties

    common = ["train", "--device=cpu", "--backend=cpu", "--rows=3000",
              "--trees=3", "--depth=3", "--bins=31"]
    streamed, whole = str(tmp_path / "s.npz"), str(tmp_path / "w.npz")
    rec = _run(capsys, [*common, "--stream-chunks=4", f"--out={streamed}"])
    assert rec["streamed_chunks"] == 4 and rec["trees"] == 3
    _run(capsys, [*common, f"--out={whole}"])
    assert_trees_match_mod_ties(TreeEnsemble.load(whole),
                                TreeEnsemble.load(streamed), 0.0)
