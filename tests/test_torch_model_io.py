"""The port's model artifacts against ddt_tpu's, on the CPU.

Mirrors tests/test_registry.py's embedded-manifest cases (save_model /
load_model / TreeEnsemble.save) on the port, holds the manifest digests
(arrays_digest, the artifact-directory digest) and the TreeEnsemble
inspection methods (feature_importances, dump, dump_text, concat,
CompiledEnsemble.token) equal to the reference's for the same model, and
loads bundles saved by either package in the other: equal scores,
verified digests. Models are trained by the port on the CPU; the
reference side gets the same arrays through its from_dict / load.
"""

import dataclasses
import hashlib
import time

import numpy as np
import pytest

from ddt_tpu import api as japi
from ddt_tpu.data.categorical import CategoricalEncoder as JEncoder
from ddt_tpu.data.quantizer import BinMapper as JMapper
from ddt_tpu.models.tree import TreeEnsemble as JEnsemble
from ddt_tpu.registry import manifest as jmanifest
from ddt_tpu_torch import api
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.data.categorical import fit_categorical_encoder
from ddt_tpu_torch.data.datasets import synthetic_binary, synthetic_ctr
from ddt_tpu_torch.data.quantizer import BinMapper
from ddt_tpu_torch.models.tree import TreeEnsemble
from ddt_tpu_torch.registry import IntegrityError
from ddt_tpu_torch.registry import manifest as manifest_mod


@pytest.fixture(scope="module")
def trained():
    X, y = synthetic_binary(2500, n_features=8, seed=7)
    res = api.train(X, y, n_trees=6, max_depth=3, n_bins=31, device="cpu")
    return dict(X=X, res=res, cfg=TrainConfig(n_bins=31, device="cpu"))


@pytest.fixture(scope="module")
def cat_trained():
    """A model with one-vs-rest categorical splits and its encoder."""
    Xn, Xc, y = synthetic_ctr(3000, seed=1)
    enc = fit_categorical_encoder(Xc, n_bins=31)
    X = np.concatenate([Xn, enc.transform(Xc).astype(np.float32)], axis=1)
    cat = tuple(range(Xn.shape[1], X.shape[1]))
    res = api.train(X, y, n_trees=5, max_depth=4, n_bins=31,
                    cat_features=cat, device="cpu")
    assert res.ensemble.has_cat_splits
    return dict(X=X, res=res, enc=enc)


def _ref(ens: TreeEnsemble) -> JEnsemble:
    return JEnsemble.from_dict(ens.to_dict())


# --------------------------------------------------------------------- #
# embedded npz manifests (tests/test_registry.py:70-133, on the port)
# --------------------------------------------------------------------- #
def test_save_model_embeds_verified_manifest(trained, tmp_path):
    p = str(tmp_path / "m.npz")
    api.save_model(p, trained["res"].ensemble, mapper=trained["res"].mapper,
                   run_id="deadbeef1234", cfg=trained["cfg"])
    man = api.load_model(p).manifest
    assert man is not None
    assert man["manifest_schema"] == manifest_mod.MANIFEST_SCHEMA
    assert man["kind"] == "model_bundle"
    assert man["run_id"] == "deadbeef1234"
    assert man["config_fingerprint"] == \
        manifest_mod.config_fingerprint_digest(trained["cfg"])
    assert len(man["digest"]) == 64
    with np.load(p) as z:
        d = dict(z)
    assert manifest_mod.arrays_digest(d) == man["digest"]


def test_train_result_save_writes_the_bundle(trained, tmp_path):
    p = str(tmp_path / "r.npz")
    trained["res"].save(p)
    b = api.load_model(p)
    assert b.manifest["config_fingerprint"] == \
        manifest_mod.config_fingerprint_digest(trained["res"].cfg)
    assert b.encoder is None
    assert np.array_equal(b.mapper.edges, trained["res"].mapper.edges)
    assert b.ensemble.cache_token() == trained["res"].ensemble.cache_token()


def test_save_model_bytes_are_deterministic(trained, tmp_path):
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    api.save_model(a, trained["res"].ensemble, mapper=trained["res"].mapper)
    time.sleep(0.01)
    api.save_model(b, trained["res"].ensemble, mapper=trained["res"].mapper)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert hashlib.sha256(fa.read()).digest() \
            == hashlib.sha256(fb.read()).digest()


def test_load_model_rejects_tampered_payload(trained, tmp_path):
    p = str(tmp_path / "m.npz")
    api.save_model(p, trained["res"].ensemble, mapper=trained["res"].mapper)
    with np.load(p) as z:
        d = dict(z)
    d["leaf_value"] = np.array(d["leaf_value"])
    d["leaf_value"][0, 0] += 1.0
    np.savez_compressed(str(tmp_path / "evil"), **d)
    with pytest.raises(IntegrityError, match="digest mismatch"):
        api.load_model(str(tmp_path / "evil.npz"))
    # verify=False is the registry loader's path: no digest pass.
    assert api.load_model(str(tmp_path / "evil.npz"),
                          verify=False).manifest is not None


def test_legacy_manifestless_npz_still_loads(trained, tmp_path):
    p = str(tmp_path / "legacy.npz")
    d = trained["res"].ensemble.to_dict()
    d.update({f"mapper_{k}": v
              for k, v in trained["res"].mapper.save().items()})
    np.savez_compressed(p, **d)
    b = api.load_model(p)
    assert b.manifest is None
    want = api.predict(trained["res"].ensemble, trained["X"][:8],
                       mapper=trained["res"].mapper, device="cpu")
    got = api.predict(b, trained["X"][:8], device="cpu")
    assert np.array_equal(want, got)


@pytest.mark.parametrize("loader", ["port", "reference"])
def test_tree_ensemble_save_carries_manifest(trained, tmp_path, loader):
    """TreeEnsemble.save embeds the tree_ensemble manifest, which both
    packages' load_model verify."""
    p = str(tmp_path / "ens.npz")
    trained["res"].ensemble.save(p)
    assert TreeEnsemble.load(p).n_trees == trained["res"].ensemble.n_trees
    b = (api if loader == "port" else japi).load_model(p)
    assert b.manifest["kind"] == "tree_ensemble"
    assert b.mapper is None
    with np.load(p) as z:
        assert jmanifest.arrays_digest(dict(z)) == b.manifest["digest"]


# --------------------------------------------------------------------- #
# digests and the compiled token equal the reference's
# --------------------------------------------------------------------- #
def test_arrays_digest_and_token_match_reference(trained, cat_trained):
    for ens in (trained["res"].ensemble, cat_trained["res"].ensemble):
        d = ens.to_dict()
        assert manifest_mod.arrays_digest(d) == jmanifest.arrays_digest(d)
        assert ens.compile(64).token == _ref(ens).compile(64).token
        assert ens.cache_token() == _ref(ens).cache_token()


def test_artifact_manifest_digest_matches_reference(tmp_path):
    meta = {"kind": "servable", "buckets": [1, 2, 4], "quantized": None}
    digests = []
    for mod, sub in ((manifest_mod, "a"), (jmanifest, "b")):
        d = tmp_path / sub
        (d / "aot").mkdir(parents=True)
        (d / "model.npz").write_bytes(b"model bytes")
        (d / "aot" / "blob.bin").write_bytes(b"\x00\x01")
        digests.append(mod.write_artifact_manifest(str(d), meta))
        assert (d / "manifest.json").read_bytes() == \
            (tmp_path / "a" / "manifest.json").read_bytes()
    assert digests[0] == digests[1]
    # Each package reads and verifies the other's directory.
    man_a, dig_a = jmanifest.read_artifact_manifest(str(tmp_path / "a"))
    man_b, dig_b = manifest_mod.read_artifact_manifest(str(tmp_path / "b"))
    assert (man_a, dig_a) == (man_b, dig_b)


# --------------------------------------------------------------------- #
# TreeEnsemble inspection methods against the reference
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("method", ["importance_split", "importance_gain",
                                    "dump", "dump_text"])
def test_tree_methods_match_reference(trained, cat_trained, method):
    for ens in (trained["res"].ensemble, cat_trained["res"].ensemble):
        ref = _ref(ens)
        if method.startswith("importance"):
            kind = method.split("_")[1]
            got = ens.feature_importances(kind)
            assert got.dtype == np.float32
            assert np.array_equal(got, ref.feature_importances(kind))
        else:
            for t in range(ens.n_trees):
                assert getattr(ens, method)(t) == getattr(ref, method)(t)
    with pytest.raises(ValueError, match="importance kind"):
        trained["res"].ensemble.feature_importances("cover")


def test_concat_matches_reference(trained):
    ens = trained["res"].ensemble
    parts = [ens.truncate(2), _tail(ens, 2)]
    got = TreeEnsemble.concat(parts)
    want = JEnsemble.concat([_ref(p) for p in parts])
    for k, v in want.to_dict().items():
        assert np.array_equal(np.asarray(got.to_dict()[k]), np.asarray(v)), k
    assert got.cache_token() == ens.cache_token()


def _tail(ens: TreeEnsemble, start: int) -> TreeEnsemble:
    """Trees [start:] of `ens` (the second half of a resumed run)."""
    return dataclasses.replace(
        ens, **{k: getattr(ens, k)[start:] for k in (
            "feature", "threshold_bin", "threshold_raw", "is_leaf",
            "leaf_value", "split_gain", "default_left")})


# --------------------------------------------------------------------- #
# bundles cross-load: saved by either package, loaded by the other
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_bundle_cross_loads(cat_trained, tmp_path, writer):
    res, enc, X = cat_trained["res"], cat_trained["enc"], cat_trained["X"]
    p = str(tmp_path / "bundle.npz")
    if writer == "port":
        api.save_model(p, res.ensemble, mapper=res.mapper, encoder=enc,
                       run_id="cafe")
        b = japi.load_model(p)
        ens = TreeEnsemble.from_dict(b.ensemble.to_dict())
        assert isinstance(b.mapper, JMapper)
        assert isinstance(b.encoder, JEncoder)
    else:
        japi.save_model(p, _ref(res.ensemble),
                        mapper=JMapper.load(res.mapper.save()),
                        encoder=JEncoder.load(enc.save()), run_id="cafe")
        b = api.load_model(p)
        ens = b.ensemble
    assert b.manifest["kind"] == "model_bundle"
    assert b.manifest["run_id"] == "cafe"
    with np.load(p) as z:
        assert manifest_mod.arrays_digest(dict(z)) == b.manifest["digest"]
    for k, v in enc.save().items():
        assert np.array_equal(np.asarray(b.encoder.save()[k]), v), k
    # The same artifact bytes from either writer (fixed zip times, the
    # same keys and manifest).
    other = str(tmp_path / "other.npz")
    (japi if writer == "port" else api).save_model(
        other, b.ensemble, mapper=b.mapper, encoder=b.encoder,
        run_id="cafe")
    with open(p, "rb") as fa, open(other, "rb") as fb:
        assert fa.read() == fb.read()
    port_mapper = BinMapper.load(b.mapper.save())
    want = api.predict(res.ensemble, X, mapper=res.mapper, raw=True,
                       device="cpu")
    got = api.predict(ens, X, mapper=port_mapper, raw=True, device="cpu")
    assert np.array_equal(want, got)
