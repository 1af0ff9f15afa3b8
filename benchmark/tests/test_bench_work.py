"""The rooflines' and `mfu` shares' counts on shapes counted by hand."""

import numpy as np
import pytest

from benchmark.core import work
from benchmark.core.harness import read_layer
from benchmark.core.trace import Summary

#: Kernel names as the card's trace gives them.
K1 = "void (anonymous namespace)::hist_kernel<float, true>(Args)"
K3 = "void (anonymous namespace)::lut_rows<1, 3, 2, 6, false>(Args)"
PEAKS = {"hbm_bytes_per_s": 100.0, "f32_adds_per_s": 10.0,
         "int32_ops_per_s": 5.0}


def test_built_rows_takes_the_root_and_each_smaller_child():
    levels = [np.array([10]), np.array([6, 4]), np.array([3, 3, 1, 3]),
              np.array([1, 2, 0, 3, 0, 0, 2, 1])]
    # Level 2: min(3,3) + min(1,3) = 4 rows over 2 nodes; the leaf level
    # builds nothing.
    assert work.built_rows(levels) == [(10, 1), (4, 1), (4, 2)]
    # A parent left unsplit has two empty children: no node, no rows.
    assert work.built_rows([np.array([5]), np.array([0, 0]),
                            np.array([0] * 4)]) == [(5, 1), (0, 0)]


def test_hist_work_counts_rows_cells_and_adds():
    w = work.hist_work([(10, 1), (4, 2)], n_features=3, n_bins=4)
    # rows * (index 4 + 3 bins + g, h 8) + nodes * F * B * 8
    assert w.bytes == 10 * 15 + 1 * 3 * 4 * 8 + 4 * 15 + 2 * 3 * 4 * 8
    assert w.f32_adds == 2 * 3 * (10 + 4)
    assert work.least_s(w, PEAKS) == pytest.approx(max(w.bytes / 100.0,
                                                       w.f32_adds / 10.0))


def test_round_and_traverse_and_binning_work():
    r = work.round_rest_work(n_rows=10, n_classes=2, max_depth=3)
    assert r.bytes == 2 * 3 * 10 * 9 + 10 * (4 + 12 * 2)
    t = work.traverse_work(n_rows=10, n_features=3, n_trees=2, n_nodes=7,
                           compares=50)
    assert t.bytes == 10 * 3 + 2 * 7 * 12 + 10 * 4
    assert (t.f32_adds, t.int32_ops) == (20, 50)
    assert work.least_s(t, PEAKS) == pytest.approx(max(
        t.bytes / 100.0, 20 / 10.0 + 50 / 5.0))
    b = work.binning_work(n_rows=10, n_features=3, n_bins=5)
    assert b.bytes == 10 * 3 * 5 + 3 * 4 * 4


def _summary(kernels, copies=None, busy=1.0, window=2.0):
    return Summary(window_s=window, busy_s=busy, kernels=kernels,
                   copies=copies or {}, device_ops=[], idle_gaps=[])


def test_readers_divide_least_time_by_device_time():
    hist = work.Work(bytes=200.0, f32_adds=10.0)       # least 2 s
    x = {"summary": _summary({K1: 4.0, "ddt_route": 1.0,
                              "ncclKernel_AllReduce": 1.0}),
         "peaks": PEAKS, "rounds": 2, "world": 4,
         "work": {"hist": hist, "rest": work.Work(bytes=100.0)},
         "end_to_end": {"train_round_ms": 2000.0}}
    assert read_layer("train.hist_roofline", x) == pytest.approx(50.0)
    assert read_layer("train.grow_device_ms_per_round", x) == \
        pytest.approx(500.0)
    assert read_layer("train.comms_device_pct", x) == pytest.approx(100 / 6)
    assert read_layer("device_idle_pct.train", x) == pytest.approx(50.0)
    # (2 s + 1 s) least over 2 rounds, against 2 s a round.
    assert read_layer("train.step_mfu_pct", x) == pytest.approx(75.0)


def test_readers_return_nothing_without_a_trace():
    x = {"summary": None, "peaks": PEAKS, "work": None, "rounds": 1,
         "world": 1, "end_to_end": {}, "spans": {}, "histories": []}
    for m in ("train.hist_roofline", "train.grow_device_ms_per_round",
              "train.comms_device_pct", "device_idle_pct.train",
              "train.step_mfu_pct", "train.edges_ms",
              "train.loop_ms_per_round"):
        assert read_layer(m, x) is None, m


def test_score_readers():
    x = {"summary": _summary({K3: 2.0},
                             {"Memcpy HtoD (Pageable -> Device)": 0.3,
                              "Memcpy DtoH (Device -> Pageable)": 0.1}),
         "peaks": PEAKS, "batches": 3, "window_s": 4.0,
         "work": {"traverse": work.Work(int32_ops=5.0),
                  "binning": work.Work(bytes=100.0)}}
    assert read_layer("score.h2d_ms_per_batch", x) == pytest.approx(100.0)
    assert read_layer("score.traverse_roofline", x) == \
        pytest.approx(50.0)
    assert read_layer("score.step_mfu_pct", x) == pytest.approx(50.0)
    assert read_layer("device_idle_pct.score", x) == pytest.approx(50.0)
