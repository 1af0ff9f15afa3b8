"""BENCHMARK.json's keys, names and units, and every file it names found
by name."""

import json
import re
import shutil

from benchmark.core import harness

from .conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_names_and_units(manifest):
    assert set(manifest) == TOP
    assert 1 <= manifest["run_seconds"] <= 51
    assert all(_line(w) for w in manifest["command"])
    for c in manifest["configs"]:
        assert set(c) <= {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"])
        assert c["file"].startswith(tuple(p + "/" for p in manifest["paths"]))
        assert all(NAME.match(k) for k in c["reduced"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
    metrics = manifest["end_to_end"] + manifest["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in manifest["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in manifest["per_layer"]:
        assert _line(m["layer"])
        assert m["moves"] in {e["name"] for e in manifest["end_to_end"]}
    assert len(json.dumps(manifest)) < 64 * 1024


def test_every_cell_resolves_and_reports(manifest):
    for w in manifest["workloads"]:
        cell = harness.resolve(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e
            assert (ROOT / "benchmark" / "layers" / f"{m['name']}.py").exists()
        assert cell.chips == w["chips"]
        assert cell.limits["numbers"]
        # The idle share has no "workloads" list: it follows the metric
        # it moves into every cell that reports that.
        assert len([m for m in cell.per_layer
                    if m["name"].startswith("device_idle_pct.")]) == 1


def test_new_files_are_found_without_edits(tmp_path, manifest):
    """A configuration, a mix of an existing kind and a per-layer metric
    added as files and entries in a copy of the benchmark."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = tmp_path / "benchmark"
    cfg = json.loads((b / "configs" / "higgs.json").read_text())
    cfg.update(name="higgs_wide", features=64)
    (b / "configs" / "higgs_wide.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "traffic" / "train_jobs.json").read_text())
    mix.update(check_rounds=1)
    (b / "traffic" / "train_jobs_short.json").write_text(json.dumps(mix))
    (b / "limits" / "higgs_wide.train.json").write_text(
        (b / "limits" / "higgs.train.json").read_text())
    (b / "layers" / "train.jobs_traced.py").write_text(
        "def read(x):\n    return float(len(x['histories']))\n")
    m = dict(manifest)
    m["configs"] = manifest["configs"] + [
        {"name": "higgs_wide", "source": "https://example.org/wide",
         "file": "benchmark/configs/higgs_wide.json", "reduced": [],
         "why": "wider rows"}]
    m["workloads"] = manifest["workloads"] + [
        {"name": "higgs_wide.train", "config": "higgs_wide",
         "traffic": "train_jobs_short", "chips": 1, "why": "wide"}]
    # The new cell joins the list of cells that report train_round_ms.
    m["end_to_end"] = [dict(e) for e in manifest["end_to_end"]]
    for e in m["end_to_end"]:
        if e["name"] == "train_round_ms":
            e["workloads"] = e["workloads"] + ["higgs_wide.train"]
    m["per_layer"] = manifest["per_layer"] + [
        {"name": "train.jobs_traced", "unit": "jobs", "better": "higher",
         "source": "program_span", "layer": "fused boosting loop",
         "moves": "train_round_ms"}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    cell = harness.resolve("higgs_wide.train", root=tmp_path)
    assert cell.config["features"] == 64
    assert cell.traffic["check_rounds"] == 1
    assert "train.jobs_traced" in {x["name"] for x in cell.per_layer}
    assert harness.read_layer("train.jobs_traced", {"histories": [[], []]},
                              root=tmp_path) == 2.0
