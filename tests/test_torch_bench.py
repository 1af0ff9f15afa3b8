"""The port's bench library and `cli bench` (ddt_tpu_torch/bench.py) against
ddt_tpu/bench.py on the CPU.

Twins of the reference's bench tests (tests/test_cli.py
test_cli_bench_histogram_cpu, tests/test_comms.py
test_bench_hist_comms_ab_smoke, tests/test_mesh2d.py
test_bench_hist_2d_smoke, tests/test_grad_quant.py
test_bench_hist_quant_ab_smoke), run on both packages with the same
arguments. Tolerances: the deterministic fields (payload models, meshes,
the seeded inputs and ensembles) are equal; `final_train_loss` of the CPU
oracle within 1e-6 relative of the reference's CPU backend (the oracle's
trees are the reference's, bit for bit), of the cuda backend on the CPU
within 1e-4 relative of the reference's default backend on JAX-CPU. The
port's rank arms run on gloo ranks, the reference's on its CPU devices,
with the layout passed to both. Times are only held finite and > 0.
"""

import json
import math

import numpy as np
import pytest
import torch

from ddt_tpu import bench as jbench
from ddt_tpu.cli import main as jmain
from ddt_tpu_torch import bench
from ddt_tpu_torch.cli import main
from ddt_tpu_torch.utils import card

#: The reference's compile counters, which the port replaces by
#: graph_captures / launches; and what the port adds to every record.
JIT_KEYS = {"jit_compiles", "jit_compiles_timed"}
PORT_KEYS = {"graph_captures", "launches", "device"}


def _run(capsys, argv, entry):
    rc = entry(argv)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _positive(*values):
    for v in values:
        assert math.isfinite(v) and v > 0, v


def _cpu_record(rec):
    assert rec["device"] == "cpu"
    assert rec["graph_captures"] == 0 and rec["launches"] == {}


# ------------------------------------------------------------------ #
# the seeded inputs
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("seed", [0, 7])
def test_hist_inputs_bitwise_the_reference(seed):
    got = bench._hist_inputs(3000, 6, 31, 8, seed)
    want = jbench._hist_inputs(3000, 6, 31, 8, seed)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 3])
def test_predict_setup_bitwise_the_reference(seed):
    _, Xb, ens = bench._predict_setup(500, 6, 31, 12, 4, seed,
                                      backend="cpu", device="cpu")
    _, jXb, jens = jbench._predict_setup(500, 6, 31, 12, 4, seed,
                                         backend="cpu")
    np.testing.assert_array_equal(Xb, jXb)
    for k in ("feature", "threshold_bin", "threshold_raw", "is_leaf",
              "leaf_value", "split_gain", "default_left"):
        np.testing.assert_array_equal(getattr(ens, k), getattr(jens, k),
                                      err_msg=k)
    assert (ens.max_depth, ens.n_features, ens.learning_rate,
            ens.base_score, ens.loss) == (
        jens.max_depth, jens.n_features, jens.learning_rate,
        jens.base_score, jens.loss)


# ------------------------------------------------------------------ #
# cli bench
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("port_flags,ref_backend", [
    (["--backend=cpu"], "cpu"),
    (["--backend=cuda", "--device=cpu"], "tpu"),
], ids=["oracle", "cuda_on_cpu"])
def test_cli_bench_histogram_keys_equal_the_reference(capsys, port_flags,
                                                      ref_backend):
    args = ["bench", "--kernel=histogram", "--rows=20000", "--features=6",
            "--bins=31", "--iters=1"]
    rec = _run(capsys, args + port_flags, main)
    ref = _run(capsys, args + [f"--backend={ref_backend}"], jmain)
    assert set(rec) == (set(ref) - JIT_KEYS) | PORT_KEYS
    assert rec["kernel"] == "histogram"
    _positive(rec["mrows_per_sec_per_chip"], rec["sec_per_build"])
    _cpu_record(rec)
    if ref_backend == "cpu":
        assert rec["impl"] in ("native-c++", "numpy")
    else:
        assert rec["impl"] == "plain-exact"
        for k in ("hist_roofline_flops_util", "hist_roofline_hbm_util"):
            assert 0 < rec[k] <= 1.05


@pytest.mark.parametrize("kernel", sorted(bench.ARMS))
def test_cli_bench_takes_every_reference_kernel(kernel, monkeypatch):
    # Every one of the reference's nine choices parses; without a card
    # each refuses to start on --device cuda (the default).
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        main(["bench", f"--kernel={kernel}", "--device=cuda"])


def test_cli_bench_refuses_hist_impl():
    with pytest.raises(SystemExit) as err:
        main(["bench", "--kernel=histogram", "--device=cpu",
              "--hist-impl=auto"])
    assert err.value.code == 2


def test_run_bench_refuses_unknown_arguments():
    with pytest.raises(TypeError, match="hist_impl"):
        bench.run_bench("histogram", hist_impl="auto", device="cpu")
    with pytest.raises(ValueError, match="unknown bench kernel"):
        bench.run_bench("nope")


def test_multi_rank_arm_raises_past_the_visible_cards(monkeypatch):
    # No fallback to gloo or to the CPU: the check runs before any rank.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="one card a rank"):
        bench.bench_hist_comms_ab(rows=1000, features=4, bins=15, depth=2,
                                  iters=1, reps=1, host_partitions=1,
                                  n_partitions=2, device="cuda")
    with pytest.raises(ValueError, match="one card a rank"):
        bench.bench_hist_2d(rows=1000, features=8, bins=15, depth=2,
                            iters=1, reps=1, n_partitions=1,
                            feature_partitions=2, device="cuda")


@pytest.mark.parametrize("line,want", [
    ("NVIDIA H100 80GB HBM3, 700.00 W",
     {"name": "NVIDIA H100 80GB HBM3", "power_limit_w": 700.0}),
    ("NVIDIA H100 80GB HBM3, 350.00 W",
     {"name": "NVIDIA H100 80GB HBM3", "power_limit_w": 350.0}),
    ("Some Card, [N/A]", {"name": "Some Card", "power_limit_w": None}),
])
def test_card_stamp_parses_nvidia_smi(line, want):
    assert card.parse_line(line) == want
    assert card.stamp("cpu") == "cpu"


# ------------------------------------------------------------------ #
# the reference's four bench tests, on both packages
# ------------------------------------------------------------------ #

def test_bench_hist_comms_ab_equals_the_reference():
    kw = dict(rows=20_000, features=12, bins=31, depth=3, iters=1, reps=2,
              host_partitions=2, n_partitions=2)
    out = bench.bench_hist_comms_ab(device="cpu", **kw)
    ref = jbench.bench_hist_comms_ab(**kw)
    assert out["kernel"] == ref["kernel"] == "hist_comms_ab"
    for k in ("payload_ratio", "payload_bytes_allreduce", "payload_bytes_rs",
              "host_partitions", "n_partitions"):
        assert out[k] == ref[k], k
    assert out["payload_ratio"] >= 2.0
    assert set(ref) <= set(out)
    _positive(out["mrows_rs"], out["mrows_allreduce"],
              out["ratio_allreduce_over_rs"])
    assert out["ranks"] == 4
    _cpu_record(out)


def test_bench_hist_2d_equals_the_reference():
    kw = dict(rows=20_000, features=64, bins=15, depth=3, iters=1, reps=2,
              n_partitions=2, feature_partitions=2)
    out = bench.bench_hist_2d(device="cpu", **kw)
    ref = jbench.bench_hist_2d(**kw)
    assert out["kernel"] == ref["kernel"] == "hist_2d_ab"
    for k in ("mesh_1d", "mesh_2d", "payload_ratio",
              "payload_bytes_replicated", "payload_bytes_1d",
              "payload_bytes_2d"):
        assert out[k] == ref[k], k
    assert out["mesh_2d"][1] > 1
    assert out["payload_ratio"] > 0.75 * (out["mesh_2d"][0]
                                          * out["mesh_2d"][1])
    assert set(ref) <= set(out)
    _positive(out["mrows_1d"], out["mrows_2d"], out["ratio_1d_over_2d"])
    _cpu_record(out)


@pytest.mark.parametrize("grad_dtype,ratio", [("int8", 4.0), ("int16", 2.0)])
def test_bench_hist_quant_ab_equals_the_reference(grad_dtype, ratio):
    kw = dict(kernel="hist_quant", rows=1500, features=4, bins=31, depth=2,
              iters=1, seed=1, grad_dtype=grad_dtype)
    out = bench.run_bench(device="cpu", **kw)
    ref = jbench.run_bench(**kw)
    assert out["grad_dtype"] == grad_dtype
    for k in ("payload_ratio", "grad_stream_bytes_f32",
              "grad_stream_bytes_quant"):
        assert out[k] == ref[k], k
    assert out["payload_ratio"] == ratio
    assert set(ref) <= set(out)
    _positive(out["mrows_quant"], out["mrows_f32"],
              out["ratio_f32_over_quant"])
    _cpu_record(out)


# ------------------------------------------------------------------ #
# train
# ------------------------------------------------------------------ #

TRAIN_KW = dict(rows=2000, features=6, bins=31, trees=3, depth=3, seed=0)


def test_bench_train_oracle_loss_equals_the_reference():
    out = bench.bench_train(backend="cpu", device="cpu", **TRAIN_KW)
    ref = jbench.bench_train(backend="cpu", **TRAIN_KW)
    assert out["final_train_loss"] == pytest.approx(
        ref["final_train_loss"], rel=1e-6)
    assert set(out) == (set(ref) - JIT_KEYS) | PORT_KEYS
    _positive(out["wallclock_s"], out["trees_per_sec"])
    _cpu_record(out)


def test_bench_train_cuda_backend_loss_equals_the_reference():
    out = bench.bench_train(device="cpu", **TRAIN_KW)
    ref = jbench.bench_train(**TRAIN_KW)
    assert out["final_train_loss"] == pytest.approx(
        ref["final_train_loss"], rel=1e-4)
    assert out["backend"] == "cuda"
    _cpu_record(out)


# ------------------------------------------------------------------ #
# the histogram's other arms
# ------------------------------------------------------------------ #

def test_bench_histogram_ab_and_one_dispatch_on_cpu():
    kw = dict(rows=4000, features=4, n_nodes=4, iters=1, reps=2)
    ab = bench.bench_histogram_ab(device="cpu", **kw)
    ref = jbench.bench_histogram_ab(**kw)
    assert set(ref) <= set(ab)
    _positive(ab["mrows_a"], ab["mrows_b"], ab["ratio_b_over_a"])
    assert 0 < ab["hist_roofline_hbm_util"] <= 1.05
    _cpu_record(ab)
    od = bench.bench_histogram_one_dispatch(rows=4000, features=4, bins=31,
                                            n_nodes=4, iters=2, reps=3,
                                            device="cpu")
    assert od["sec_per_build_min"] <= od["sec_per_build"]
    _positive(od["mrows_per_sec_per_chip"], od["mrows_per_sec_per_chip_min"])
    _cpu_record(od)


def test_bench_hist_fused_ab_on_cpu():
    out = bench.bench_hist_fused_ab(rows=2000, features=4, bins=31, depth=3,
                                    iters=1, reps=2, device="cpu")
    _positive(out["mrows_on"], out["mrows_off"], out["ratio_on_over_off"])
    assert 0 < out["hist_fused_roofline_hbm_util"] <= 1.05
    assert out["launches_expected"] == {}
    _cpu_record(out)


# ------------------------------------------------------------------ #
# scoring, serving, the registry: witnesses at tiny sizes
# ------------------------------------------------------------------ #

SCORE_KW = dict(rows=2000, features=6, bins=31, trees=20, depth=4)


def test_bench_predict_keys_and_both_arms():
    out = bench.bench_predict(device="cpu", **SCORE_KW)
    ref = jbench.bench_predict(backend="cpu", **SCORE_KW)
    assert set(out) == (set(ref) - JIT_KEYS) | PORT_KEYS
    _positive(out["mrows_per_sec"])
    recs = bench.bench_predict_both(device="cpu", reps=2, **SCORE_KW)
    assert [r["resident"] for r in recs] == [True, False, "compute_only"]
    for r in recs:
        _positive(r["mrows_per_sec"])
        _cpu_record(r)
    assert 0 < recs[2]["predict_roofline_flops_util"] <= 1.05


def test_bench_predict_cuda_ab_witnesses_bitwise():
    out = bench.bench_predict_cuda_ab(plain_rows=700, reps=2, device="cpu",
                                      **SCORE_KW)
    assert out["exact_match"] is True
    assert (out["rows"], out["plain_rows"]) == (2000, 700)
    _positive(out["cuda_mrows_per_sec"], out["plain_mrows_per_sec"],
              out["ratio_cuda_over_plain"])
    _cpu_record(out)


def test_bench_predict_lut_ab_within_the_bound():
    out = bench.bench_predict_lut_ab(reps=2, device="cpu", **SCORE_KW)
    assert 0 <= out["lut_max_abs_err"] <= out["lut_err_bound"]
    _positive(out["lut_mrows_per_sec"], out["f32_mrows_per_sec"])
    _cpu_record(out)


def test_bench_predict_lut4_ab_within_the_bound_and_express():
    kw = dict(rows=2000, features=6, trees=20, depth=4, reps=2,
              n_single=8, n_storm=32, max_wait_ms=5.0)
    out = bench.bench_predict_lut4_ab(ab=True, device="cpu", **kw)
    assert 0 <= out["lut4_max_abs_err"] <= out["lut4_err_bound"]
    assert out["lut4_thr_packed"] is True        # 15 bins: nibble pack
    assert out["express_hits_empty"] == 8
    ref = jbench.bench_predict_lut4_ab(ab=False, **kw)
    assert set(ref) - JIT_KEYS <= set(out)
    _cpu_record(out)


def test_bench_serve_latency_keys():
    kw = dict(rows=500, trees=10, depth=3, qps_points=(100, 400, 8000),
              n_requests=16)
    out = bench.bench_serve_latency(device="cpu", **kw)
    ref = jbench.bench_serve_latency(backend="cpu", **kw)
    assert set(out) == (set(ref) - JIT_KEYS) | PORT_KEYS
    assert [a["qps"] for a in out["arms"]] == [100, 400, 8000]
    assert all(a["requests"] == 16 for a in out["arms"])
    _positive(out["cold_predict_ms"], out["serve_p99_ms"])
    _cpu_record(out)


@pytest.mark.parametrize("quantize", [False, True])
def test_bench_registry_restores_bitwise(quantize):
    out = bench.bench_registry_cold_load(trees=10, depth=3,
                                         quantize=quantize, device="cpu")
    assert out["bitwise"] is True and out["nvcc_builds_timed"] == 0
    assert out["mode"] == ("tables-fallback" if quantize else "rebuild")
    _positive(out["registry_rebuild_cold_ms"], out["registry_aot_cold_ms"])
    _cpu_record(out)
