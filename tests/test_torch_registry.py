"""The port's registry: store, servable artifacts and restores, on the CPU.

Mirrors tests/test_registry.py:158-548 on the port (push / resolve /
list / tag, dense versions under concurrent pushers, corrupt and torn
objects, staging litter, names; restores at f32, int8 and int4 bitwise
api.predict, tier pinning, the carried tables serving, the engine
serving a restored model). The reference restores per-bucket jax.export
programs; the port restores through its kernels, and its counterpart of
"zero retrace" is a cold process that restores and scores with no
kernel build (`_build.builds` 0). Left out with the modules they need:
the CLI (tests/test_registry.py:613), the run-log cases (:559, :587) and
the swap by registry reference (:450).

Across packages, on one registry directory: a reference push restored by
the port scores bitwise the port's api.predict at each tier; a port push
restored by the reference (its rebuild / tables-fallback path) agrees
within the predictions contract: bitwise on exact-grid leaves (every
partial sum exact in f32, so the leaf choice is all that is compared),
margins within 1e-5 * (|p| + 1) on a trained model.
"""

import json
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from ddt_tpu import api as japi
from ddt_tpu.config import TrainConfig as JConfig
from ddt_tpu.data.quantizer import BinMapper as JMapper
from ddt_tpu.models import tree as jtree
from ddt_tpu.registry import loader as jloader
from ddt_tpu_torch import _build, api
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.data import datasets
from ddt_tpu_torch.export import aot
from ddt_tpu_torch.models.tree import TreeEnsemble
from ddt_tpu_torch.registry import IntegrityError, Registry, RegistryError
from ddt_tpu_torch.registry import manifest as manifest_mod
from ddt_tpu_torch.registry import store as store_mod
from ddt_tpu_torch.registry.loader import load_servable, push_servable
from ddt_tpu_torch.serve import ServeEngine

ROOT = Path(__file__).resolve().parent.parent
MAX_BATCH = 16          # bucket ladder (1, 2, 4, 8, 16)
TIERS = ((False, "auto"), ("int8", "lut"), ("int4", "lut4"))


@pytest.fixture(scope="module")
def trained():
    X, y = datasets.synthetic_binary(2500, n_features=8, seed=7)
    res = api.train(X, y, n_trees=6, max_depth=3, n_bins=31, device="cpu")
    cfg = TrainConfig(n_bins=31, device="cpu")
    return dict(X=X, res=res, cfg=cfg, Xb=res.mapper.transform(X))


@pytest.fixture(scope="module")
def pushed(trained, tmp_path_factory):
    """The model exported with the int8 tier and pushed once."""
    root = str(tmp_path_factory.mktemp("registry"))
    out = push_servable(root, _bundle(trained), name="higgs",
                        max_batch=MAX_BATCH, quantize=True)
    return dict(root=root, **out)


def _bundle(trained):
    return api.ModelBundle(ensemble=trained["res"].ensemble,
                           mapper=trained["res"].mapper)


def _want(trained, X, impl="auto"):
    return api.predict(trained["res"].ensemble, X,
                       mapper=trained["res"].mapper,
                       cfg=trained["cfg"].replace(predict_impl=impl))


# --------------------------------------------------------------------- #
# store: push / resolve / list / tag, atomicity, corruption
# --------------------------------------------------------------------- #
def _fake_stage(reg: Registry, payload: bytes, kind: str = "servable"
                ) -> str:
    """A hand-built artifact for store-level tests: its content, and so
    its digest, varies with `payload`."""
    stage = reg.stage()
    with open(os.path.join(stage, "blob.bin"), "wb") as f:
        f.write(payload)
    manifest_mod.write_artifact_manifest(stage, {"kind": kind})
    return stage


def test_push_resolve_list_tag_roundtrip(tmp_path):
    reg = Registry(str(tmp_path / "reg"))
    d1 = reg.push(_fake_stage(reg, b"one"), "m")
    d2 = reg.push(_fake_stage(reg, b"two"), "m")
    assert (d1["version"], d2["version"]) == (1, 2)
    assert d1["digest"] != d2["digest"]
    for ref in (d1["digest"], d1["digest"][:10], "m@1"):
        assert reg.resolve(ref) == d1["digest"]
    for ref in ("m", "m@latest", "m@2"):
        assert reg.resolve(ref) == d2["digest"]
    tag = reg.tag("m@1", "prod")
    assert tag["version"] == 1
    assert reg.resolve("m@prod") == d1["digest"]
    inv = reg.list()
    assert [v["version"] for v in inv["names"]["m"]["versions"]] == [1, 2]
    assert inv["names"]["m"]["tags"] == {"prod": 1}
    assert inv["anonymous"] == []
    with pytest.raises(RegistryError):
        reg.resolve("m@3")
    with pytest.raises(RegistryError):
        reg.resolve("nosuch")
    with pytest.raises(RegistryError):
        reg.tag("m@1", "7")               # numeric tags are reserved


def test_push_same_content_is_idempotent(tmp_path):
    reg = Registry(str(tmp_path / "reg"))
    a = reg.push(_fake_stage(reg, b"same"), "m")
    b = reg.push(_fake_stage(reg, b"same"), "m")
    assert a == b
    assert len(reg.list()["names"]["m"]["versions"]) == 1


def test_concurrent_pushers_get_dense_unique_versions(tmp_path):
    reg = Registry(str(tmp_path / "reg"))
    n_distinct, errs, results = 12, [], []
    payloads = [f"model-{i}".encode() for i in range(n_distinct)]
    payloads += [b"model-0"] * 3          # a same-content race too
    stages = [_fake_stage(reg, p) for p in payloads]
    barrier = threading.Barrier(len(stages))

    def push(stage):
        try:
            barrier.wait(timeout=30)
            results.append(reg.push(stage, "m"))
        # Worker-thread boundary: every failure must reach errs, never
        # die silently on the thread.
        except Exception as e:  # ddtlint: disable=broad-except
            errs.append(e)

    threads = [threading.Thread(target=push, args=(s,)) for s in stages]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errs, errs
    versions = sorted(v["version"]
                      for v in reg.list()["names"]["m"]["versions"])
    assert versions == list(range(1, n_distinct + 1))
    for r in results:
        assert r["version"] in versions
    assert len({r["digest"] for r in results}) == n_distinct
    assert [r for r in results if r["digest"] == reg.resolve("m@1")]
    for v in versions:
        reg.get(f"m@{v}")
    assert len(reg.list()["anonymous"]) == 0


def test_corrupt_and_torn_artifacts_are_rejected(tmp_path):
    reg = Registry(str(tmp_path / "reg"))
    d = reg.push(_fake_stage(reg, b"payload"), "m")
    obj = reg.object_dir(d["digest"])
    with open(os.path.join(obj, "blob.bin"), "r+b") as f:
        f.write(b"X")
    with pytest.raises(IntegrityError, match="sha256 mismatch"):
        reg.get("m@1")
    with open(os.path.join(obj, "blob.bin"), "wb") as f:
        f.write(b"payload")
    reg.get("m@1")
    with open(os.path.join(obj, "extra.bin"), "wb") as f:
        f.write(b"sneaky")
    with pytest.raises(IntegrityError, match="drifted"):
        reg.get("m@1")
    os.remove(os.path.join(obj, "extra.bin"))
    man_path = os.path.join(obj, manifest_mod.MANIFEST_FILE)
    with open(man_path, encoding="utf-8") as f:
        man = json.load(f)
    man["kind"] = "tampered"
    with open(man_path + ".t", "w", encoding="utf-8") as f:
        json.dump(man, f, sort_keys=True)
    os.replace(man_path + ".t", man_path)
    with pytest.raises(IntegrityError, match="addressed"):
        reg.get("m@1")
    with open(man_path, "w", encoding="utf-8") as f:
        f.write('{"artifact_schema": 1, "files"')
    with pytest.raises(IntegrityError, match="not valid JSON"):
        reg.get("m@1")


def test_staging_litter_is_invisible(tmp_path):
    reg = Registry(str(tmp_path / "reg"))
    reg.push(_fake_stage(reg, b"x"), "m")
    dead = reg.stage()
    with open(os.path.join(dead, "half-written"), "wb") as f:
        f.write(b"torn")
    inv = reg.list()
    assert set(inv["names"]) == {"m"}
    assert inv["anonymous"] == []


def test_bad_names_rejected(tmp_path):
    reg = Registry(str(tmp_path / "reg"))
    for bad in ("", "a@b", "a/b", ".hidden"):
        with pytest.raises(RegistryError):
            reg.push(_fake_stage(reg, b"y"), bad)


def test_stage_sweeps_stale_crash_litter(tmp_path):
    reg = Registry(str(tmp_path / "reg"))
    stale = reg.stage()
    old = time.time() - 2 * store_mod._STAGE_SWEEP_AGE_S
    os.utime(stale, (old, old))
    fresh = reg.stage()
    reg.stage()
    assert not os.path.isdir(stale)
    assert os.path.isdir(fresh)


# --------------------------------------------------------------------- #
# export -> restore -> score, bitwise api.predict
# --------------------------------------------------------------------- #
def test_servable_manifest_fields(trained, pushed):
    _, man, digest = Registry(pushed["root"]).get("higgs@1")
    assert digest == pushed["digest"]
    assert man["kind"] == "servable"
    assert man["model_token"] == trained["res"].ensemble.cache_token()
    assert man["buckets"] == [1, 2, 4, 8, 16]
    assert man["quantized"]["tier"] == "int8"
    assert man["quantized"]["leaf_dtype"] == "float16"
    assert man["platforms"] == [] and man["lut_platforms"] == []
    assert man["restorer"] == "ddt_tpu_torch"
    assert man["kernels"] == {"lut": {
        "source_hash": _build.source_hash("lut"), "arch": "sm_90a"}}
    assert man["drift_reference"] is True
    assert sorted(man["files"]) == ["lut_tables.npz", "model.npz"]
    # The same model pushed again is the same object and version.
    again = push_servable(pushed["root"], _bundle(trained), name="higgs",
                          max_batch=MAX_BATCH, quantize=True)
    assert again == {k: pushed[k] for k in ("digest", "name", "version")}


def test_f32_restore_bitexact_vs_api_predict(trained, pushed):
    rep = load_servable(pushed["root"], "higgs@1", quantize=False,
                        device="cpu")
    assert rep.mode == "rebuild"
    m = rep.model
    assert m.artifact_digest == pushed["digest"]
    assert not m.quantized
    m.warmup()
    assert m.predict_impl == "f32"
    X = trained["X"]
    # Across the buckets, and past the largest (largest-bucket pieces).
    for n in (1, 3, 8, MAX_BATCH, 5 * MAX_BATCH + 3):
        got = m.score_binned(trained["Xb"][:n])
        assert np.array_equal(_want(trained, X[:n]), got), n
    raw = load_servable(pushed["root"], "higgs@1", quantize=False,
                        raw=True, device="cpu").model
    want = api.predict(trained["res"].ensemble, X[:20],
                       mapper=trained["res"].mapper, raw=True, device="cpu")
    assert np.array_equal(raw.score_binned(trained["Xb"][:20]), want)


def test_lut_restore_bitexact_and_bounded(trained, pushed):
    rep = load_servable(pushed["root"], pushed["digest"], device="cpu")
    assert rep.mode == "tables-fallback"
    m = rep.model
    assert m.quantized and m.quantize_tier == "int8"
    assert m.max_abs_err == rep.manifest["quantized"]["max_abs_err"] > 0
    m.warmup()
    assert m.predict_impl == "lut"
    for n in (1, 7, MAX_BATCH):
        got = m.score_binned(trained["Xb"][:n])
        assert np.array_equal(_want(trained, trained["X"][:n], "lut"),
                              got), n


def test_lut4_push_restore_bitexact_and_tier_pinned(trained, tmp_path):
    root = str(tmp_path / "reg4")
    push_servable(root, _bundle(trained), name="m4", max_batch=8,
                  quantize="int4")
    rep = load_servable(root, "m4", device="cpu")
    m = rep.model
    assert rep.mode == "tables-fallback"
    assert m.quantized and m.quantize_tier == "int4"
    assert rep.manifest["quantized"]["tier"] == "int4"
    assert rep.manifest["quantized"]["leaf_dtype"] == "int4"
    assert m.max_abs_err == rep.manifest["quantized"]["max_abs_err"]
    m.warmup()
    assert m.predict_impl == "lut4"
    for n in (1, 7, 8, 19):
        got = m.score_binned(trained["Xb"][:n])
        assert np.array_equal(_want(trained, trained["X"][:n], "lut4"),
                              got), n
    with pytest.raises(RegistryError, match="tier"):
        load_servable(root, "m4", quantize="int8", device="cpu")
    rep32 = load_servable(root, "m4", quantize=False, device="cpu")
    assert rep32.mode == "rebuild"
    rep32.model.warmup()
    assert rep32.model.predict_impl == "f32"


def test_tables_fallback_serves_carried_tables(trained, pushed):
    rep = load_servable(pushed["root"], "higgs@1", quantize=True,
                        cfg=trained["cfg"])
    assert rep.mode == "tables-fallback"
    assert rep.model.tables.token == rep.manifest["model_token"]
    assert rep.model.max_abs_err == \
        rep.manifest["quantized"]["max_abs_err"]
    # The seeded memo is the dispatch source: quantize() returns the
    # carried object itself, so the backend cannot re-derive it.
    assert rep.model.compiled.quantize() is rep.model.tables
    rep.model.warmup()
    got = rep.model.score_binned(trained["Xb"][:6])
    assert np.array_equal(_want(trained, trained["X"][:6], "lut"), got)


def test_restore_rejects_model_blob_swap(trained, pushed, tmp_path):
    root2 = str(tmp_path / "reg2")
    src = Registry(pushed["root"]).object_dir(pushed["digest"])
    dst = Registry(root2).object_dir(pushed["digest"])
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    shutil.copytree(src, dst)
    X = trained["X"]
    other = api.train(X, (X[:, 0] < 0).astype(np.float32), n_trees=6,
                      max_depth=3, n_bins=31, device="cpu")
    api.save_model(os.path.join(dst, "model.npz"), other.ensemble,
                   mapper=other.mapper)
    with pytest.raises(IntegrityError):
        load_servable(root2, pushed["digest"], device="cpu")


def test_quantized_restore_without_lut_export_refused(trained, tmp_path):
    root = str(tmp_path / "reg")
    push_servable(root, _bundle(trained), name="f32only", max_batch=8,
                  quantize=False)
    with pytest.raises(ValueError, match="without the quantized"):
        load_servable(root, "f32only", quantize=True, device="cpu")
    reg = Registry(root)
    reg.push(_fake_stage(reg, b"z", kind="other"), "junk")
    with pytest.raises(RegistryError, match="not a servable"):
        load_servable(root, "junk", device="cpu")


def test_engine_serves_restored_model_and_stamps_digest(trained, pushed):
    rep = load_servable(pushed["root"], "higgs@1", quantize=False,
                        cfg=trained["cfg"])
    eng = ServeEngine(rep.model, trained["cfg"], max_wait_ms=5.0,
                      max_batch=MAX_BATCH)
    try:
        got = eng.predict(trained["X"][:5])
        assert np.array_equal(_want(trained, trained["X"][:5]), got)
        assert eng.health()["artifact_digest"] == pushed["digest"]
        assert eng.model_token == trained["res"].ensemble.cache_token()
        # A swap to a bundle-built model clears the stamp.
        eng.swap(_bundle(trained))
        assert eng.health()["artifact_digest"] is None
    finally:
        eng.close()


def test_cold_process_restores_with_no_kernel_build(trained, pushed):
    """The port's counterpart of the reference's zero-retrace witness: a
    fresh interpreter restores the artifact and scores with
    _build.builds == 0 (here on the CPU, where nothing is built; the
    card's cold child is chip_smoke's lifecycle phase)."""
    code = (
        "import json, sys, numpy as np\n"
        "from ddt_tpu_torch import _build\n"
        "from ddt_tpu_torch.registry.loader import load_servable\n"
        "rep = load_servable(sys.argv[1], 'higgs@1', device='cpu')\n"
        "Xb = np.load(sys.argv[2])\n"
        "out = rep.model.score_binned(Xb)\n"
        "print(json.dumps({'builds': _build.builds, 'mode': rep.mode,\n"
        "                  'digest': rep.digest, 'scores': out.tolist()}))\n")
    xb = os.path.join(pushed["root"], "rows.npy")
    np.save(xb, trained["Xb"][:9])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code, pushed["root"], xb],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    os.remove(xb)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["builds"] == 0
    assert (got["mode"], got["digest"]) == ("tables-fallback",
                                           pushed["digest"])
    want = _want(trained, trained["X"][:9], "lut")
    assert np.array_equal(np.asarray(got["scores"], np.float32),
                          want.astype(np.float32))


def test_build_counter_counts_nvcc_runs(tmp_path, monkeypatch):
    """_build.builds counts the nvcc processes a process starts: one per
    missing library, none for a library already built."""
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'touch "$2"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    before = _build.builds
    took = _build.build_all(["lut", "device"])
    assert sorted(took) == ["device", "lut"]
    assert _build.builds - before == 2
    assert _build.lib_path("lut").exists()
    assert _build.build_all(["lut", "device"]) == {}
    assert _build.builds - before == 2


# --------------------------------------------------------------------- #
# across packages, one registry directory
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("quantize,impl", TIERS)
def test_reference_push_restored_by_port(trained, tmp_path, quantize, impl):
    root = str(tmp_path / "reg")
    res = trained["res"]
    jb = japi.ModelBundle(
        ensemble=jtree.TreeEnsemble.from_dict(res.ensemble.to_dict()),
        mapper=JMapper.load(res.mapper.save()))
    out = jloader.push_servable(root, jb, name="ref", max_batch=4,
                                quantize=quantize)
    art_dir, man, _ = Registry(root).get("ref")
    assert man["platforms"]                 # the reference's AOT programs
    rep = load_servable(root, "ref", device="cpu")
    assert rep.digest == out["digest"]
    assert rep.mode == ("tables-fallback" if quantize else "rebuild")
    rep.model.warmup()
    for n in (1, 4, 11):
        got = rep.model.score_binned(trained["Xb"][:n])
        assert np.array_equal(_want(trained, trained["X"][:n], impl),
                              got), n
    # Its aot/ blobs are verified with every other file.
    blob = next(p for p in sorted(Path(art_dir, aot.AOT_DIR).iterdir()))
    blob.write_bytes(blob.read_bytes() + b"\0")
    with pytest.raises(IntegrityError, match="sha256 mismatch"):
        load_servable(root, "ref", device="cpu")


def _exact_grid_bundle(seed=0):
    """6 trees at depth 3 over 8 features, 31 bins, leaves on the 1/8
    grid (every partial sum exact in f32)."""
    from ddt_tpu_torch.models.tree import empty_ensemble

    rng = np.random.default_rng(seed)
    T, D, F, B = 6, 3, 8, 31
    ens = empty_ensemble(T, D, F, 0.125, 0.25, "logloss", n_bins=B)
    N = ens.n_nodes_total
    ens.feature[:] = rng.integers(0, F, size=(T, N))
    ens.threshold_bin[:] = rng.integers(0, B - 1, size=(T, N))
    ens.is_leaf[:] = rng.random((T, N)) < 0.25
    ens.leaf_value[:] = rng.integers(-7, 8, size=(T, N)) / 8.0
    Xb = rng.integers(0, B, (40, F), dtype=np.uint8)
    return api.ModelBundle(ensemble=ens), Xb


@pytest.mark.parametrize("quantize,impl", TIERS)
def test_port_push_restored_by_reference(trained, tmp_path, quantize,
                                         impl):
    root = str(tmp_path / "reg")
    jcfg = JConfig(backend="tpu", n_bins=31, predict_impl=impl)
    grid, Xg = _exact_grid_bundle()
    for name, bundle, Xb, X in (
            ("trained", _bundle(trained), trained["Xb"][:40],
             trained["X"][:40]),
            ("grid", grid, Xg, None)):
        push_servable(root, bundle, name=name, max_batch=8,
                      quantize=quantize)
        rep = jloader.load_servable(root, name, cfg=jcfg)
        assert rep.mode == ("tables-fallback" if quantize else "rebuild")
        rep.model.warmup()
        got = np.asarray(rep.model.score_binned(Xb))
        if X is None:
            want = api.predict(bundle.ensemble, Xb, binned=True,
                               cfg=TrainConfig(device="cpu",
                                               predict_impl=impl))
            assert np.array_equal(want, got)
        else:
            want = _want(trained, X, impl)
            assert np.all(np.abs(got - want) <= 1e-5 * (np.abs(want) + 1))


def test_port_artifact_model_and_tables_load_in_reference(trained, pushed):
    """The restored representation is the carried one in both packages:
    the reference reads the port's model.npz (digest verified) and
    lut_tables.npz into equal arrays."""
    from ddt_tpu.export import aot as jaot

    art_dir, man, _ = Registry(pushed["root"]).get("higgs")
    b = japi.load_model(os.path.join(art_dir, aot.MODEL_FILE))
    assert b.manifest["kind"] == "model_bundle"
    assert TreeEnsemble.from_dict(b.ensemble.to_dict()).cache_token() \
        == man["model_token"]
    with np.load(os.path.join(art_dir, aot.LUT_TABLES_FILE)) as z:
        jt = jaot.tables_from_arrays(dict(z))
    assert jt.token == man["model_token"]
    assert jt.max_abs_err == man["quantized"]["max_abs_err"]
