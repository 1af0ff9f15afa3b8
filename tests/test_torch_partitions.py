"""The port's partition recorder (telemetry/events.PartitionRecorder)
against tests/test_flight_recorder.py's partition cases, on gloo ranks:
every rank times its own phases and the ranks gather their lanes once a
round, so the first rank's log carries one lane a rank; its
partition_skew equals the offline recompute from the partition_phases
events (telemetry/events.partition_skew_summary, the reduction `report`
reads); `report` renders the straggler table and `trace` exports the
lanes; and without a run log nothing of it runs.
"""

import numpy as np
import pytest

from ddt_tpu_torch.parallel import spawn, tasks
from ddt_tpu_torch.telemetry import perfetto, report
from ddt_tpu_torch.telemetry.events import (PartitionRecorder, RunLog,
                                            partition_skew_summary)


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


def _binary(rows, features=7, bins=29, seed=0):
    rng = np.random.default_rng(seed)
    Xb = rng.integers(0, bins, size=(rows, features), dtype=np.uint8)
    y = (Xb[:, 0] > bins // 2).astype(np.float32)
    return Xb, y


def _recompute_skew(events):
    totals = {}
    for e in events:
        if e["event"] != "partition_phases":
            continue
        for part in e["partitions"]:
            d = totals.setdefault(part["device"], {})
            for ph, ms in part["phases"].items():
                d[ph] = d.get(ph, 0.0) + ms
    return partition_skew_summary(totals)


@pytest.mark.parametrize("profile", [False, True], ids=["fused", "granular"])
def test_mesh_partition_skew_matches_offline_recompute(pools, tmp_path,
                                                       profile):
    cfg = dict(n_trees=4, max_depth=3, n_bins=29)
    Xb, y = _binary(2048)
    paths = [str(tmp_path / f"rank{r}.jsonl") for r in range(4)]
    outs = pools(4).run(tasks.train_logged, Xb, y, cfg, paths,
                        dict(profile=profile))
    assert outs == [None] * 4
    events = report.read_events(paths[0])
    pp = [e for e in events if e["event"] == "partition_phases"]
    assert len(pp) == (4 if profile else 1)    # a round, or the block
    for e in pp:
        assert [p["device"] for p in e["partitions"]] == [0, 1, 2, 3]
        for p in e["partitions"]:
            assert p["hist_allreduce_bytes"] > 0
            assert all(ms >= 0 for ms in p["phases"].values())
            assert set(p["phases"]) == {"hist" if profile else "grow_block"}
    skew = [e for e in events if e["event"] == "partition_skew"]
    assert len(skew) == 1 and skew[0]["n_partitions"] == 4
    recomputed = _recompute_skew(events)
    emitted = skew[0]["phases"]
    assert [p["phase"] for p in emitted] == [p["phase"] for p in recomputed]
    for a, b in zip(emitted, recomputed):
        assert a["ms_max"] == pytest.approx(b["ms_max"], abs=0.01)
        assert a["ms_median"] == pytest.approx(b["ms_median"], abs=0.01)
        assert a["max_device"] == b["max_device"]
    man = events[0]
    assert man["event"] == "run_manifest" and len(man["run_id"]) == 12
    summary = report.summarize(events)
    assert summary["n_partitions"] == 4
    assert summary["partition_skew"] == emitted
    assert "partitions (4 lanes" in report.render(summary)
    # Only the host's first rank writes.
    import os

    assert not any(os.path.exists(p) for p in paths[1:])


def test_streaming_mesh_run_emits_partition_lanes(pools, tmp_path):
    Xb, y = _binary(960, seed=3)
    path = str(tmp_path / "stream.jsonl")
    outs = pools(2).run(tasks.train_streaming, Xb, y, [0, 480, 960],
                        dict(n_trees=2, max_depth=3, n_bins=29),
                        dict(run_log=path))
    assert outs[0]["ensemble"].n_trees == 2
    events = report.read_events(path)
    pp = [e for e in events if e["event"] == "partition_phases"]
    assert len(pp) == 2                        # one a round
    assert {ph for e in pp for p in e["partitions"]
            for ph in p["phases"]} == {"hist"}
    skew = [e for e in events if e["event"] == "partition_skew"]
    assert skew and skew[-1]["n_partitions"] == 2
    assert _recompute_skew(events)[0]["phase"] == \
        skew[-1]["phases"][0]["phase"]


@pytest.mark.parametrize("loop", ["fused", "granular"])
def test_disabled_telemetry_never_gathers_lanes(pools, loop):
    """Without a run log a mesh fit never enters a span nor flushes the
    recorder: no event, no sync, no gather."""
    Xb, y = _binary(1024, seed=5)
    kw = dict(n_trees=2, max_depth=3, n_bins=29,
              straggler_repartition=loop == "granular")
    assert pools(2).run(tasks.train_without_lanes, Xb, y, kw) == [2, 2]


def test_partition_recorder_inert_without_mesh_or_log():
    class NoMesh:
        mesh = None
        device = None

    class Mesh:
        world_group = None

    class WithMesh:
        mesh = Mesh()
        device = None

    # A run log, but one device: inactive.
    rec = PartitionRecorder(RunLog(), NoMesh(), active=True)
    assert not rec.active
    with rec.span("hist"):
        pass
    assert rec.flush_round(0) is None
    rec.emit_skew()
    # A mesh, but no run log on the ranks: inactive, nothing recorded.
    rec = PartitionRecorder(None, WithMesh(), active=False)
    assert not rec.active and rec.flush_round(0) is None
    assert rec.span("hist") is rec.span("grow_block")   # one null context


def test_trace_export_mesh_run_has_partition_lanes(pools, tmp_path):
    Xb, y = _binary(2048, seed=13)
    paths = [str(tmp_path / f"rank{r}.jsonl") for r in range(4)]
    pools(4).run(tasks.train_logged, Xb, y,
                 dict(n_trees=3, max_depth=3, n_bins=29), paths,
                 dict(profile=True))
    events = report.read_events(paths[0])
    recs = perfetto.to_trace_events(events)["traceEvents"]
    assert any(r["ph"] == "X" and r["tid"] == 0
               and r["name"].startswith("round ") for r in recs)
    lanes = [r for r in recs if r["ph"] == "X"
             and r["name"].startswith("ddt:")]
    assert {r["tid"] for r in lanes} == {1, 2, 3, 4}
    assert all(r["args"]["hist_allreduce_bytes"] > 0 for r in lanes)
    pp = [e for e in events if e["event"] == "partition_phases"][0]
    dev0 = pp["partitions"][0]
    got = [r for r in lanes if r["args"]["device"] == 0
           and r["args"]["round"] == pp["round"]]
    assert sorted(r["dur"] for r in got) == pytest.approx(
        sorted(ms * 1e3 for ms in dev0["phases"].values()))
