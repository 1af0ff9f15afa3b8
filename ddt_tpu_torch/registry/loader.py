"""Restore a servable model from a registry artifact.

Port of ddt_tpu/registry/loader.py. `load_servable(root, ref)` turns a
digest-addressed artifact (pushed by either package) back into a
`ServableModel` the serve engine publishes as it is (`ServeEngine(model)`
/ `engine.swap(model)`): the verifying read of registry/store hands over
the object directory, model.npz restores the ensemble, mapper and
encoder, and a quantized tier serves the artifact's carried
lut_tables.npz, never a re-quantization, so the manifest's `max_abs_err`
keeps describing what serves.

The reference restores per-bucket jax.export programs when they cover
its platform. The port has no such programs (export/aot.py): it takes
the reference's own fallback ladder for every artifact, "rebuild" (f32)
or "tables-fallback" (int8 / int4), scoring through the backend's kernels
(K3, or K4 / K5 on the carried tables). A reference artifact's `aot/`
blobs are verified by sha256 with every other file and then ignored. The
counterpart of the reference's zero-retrace restore is that no kernel is
rebuilt: a cold process whose kernels are built (ddt_tpu_torch/_build/)
restores and scores with `_build.builds` at 0.

Tier rules (the reference's): quantize=None follows the artifact, True
takes the artifact's tier, "int8" / "int4" demand that tier; a tier the
artifact does not carry, or a quantized request on an f32-only artifact,
refuses.

Every restore emits an `artifact` run-log event (action "load", the
digest, the manifest's kind / run_id / token, the mode) when `run_log=`
is given, and `push_servable` passes its `run_log` to the store's push.

File reads happen here, on the caller's thread, never in the engine's
dispatch loop.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import shutil

import numpy as np

from ddt_tpu_torch.registry.manifest import IntegrityError
from ddt_tpu_torch.registry.store import DIGEST_LEN, Registry, RegistryError

log = logging.getLogger("ddt_tpu_torch.registry.loader")


def _emit_artifact_event(run_log, action: str, digest: str, man: dict,
                         mode: str | None = None) -> None:
    if run_log is None:
        return
    run_log.emit("artifact", action=action, digest=digest,
                 kind=man.get("kind"), run_id=man.get("run_id"),
                 model_token=(man.get("model_token") or "")[:12] or None,
                 mode=mode)


@dataclasses.dataclass
class LoadReport:
    """What the restore did."""

    digest: str
    mode: str            # rebuild | tables-fallback
    model: "object"      # serve.engine.ServableModel
    manifest: dict


def load_servable(root, ref: str, *, quantize=None, raw: bool = False,
                  backend=None, cfg=None, device: str = "cuda",
                  run_log=None) -> LoadReport:
    """Restore a servable model from registry reference `ref` (digest,
    `name`, `name@version` or `name@tag`; see the module docstring for
    `quantize`). The model scores on `backend` if given, else on the
    backend of `cfg` (its predict_impl set to the restored tier), else on
    the one of `device`. `run_log` (a RunLog, or a path, opened and
    closed here) receives the `artifact` load event."""
    from ddt_tpu_torch import api
    from ddt_tpu_torch.backends import get_backend
    from ddt_tpu_torch.config import TrainConfig
    from ddt_tpu_torch.export import aot
    from ddt_tpu_torch.serve.engine import (TIER_IMPL, ServableModel,
                                            normalize_quantize)
    from ddt_tpu_torch.telemetry.events import RunLog

    # A log opened here from a path is closed here; a caller's RunLog
    # stays the caller's to close.
    if isinstance(run_log, str):
        with RunLog(run_log) as own:
            return load_servable(root, ref, quantize=quantize, raw=raw,
                                 backend=backend, cfg=cfg, device=device,
                                 run_log=own)
    reg = root if isinstance(root, Registry) else Registry(root)
    art_dir, man, digest = reg.get(ref)
    if man.get("kind") != "servable":
        raise RegistryError(
            f"{ref!r} ({digest}) is a {man.get('kind')!r} artifact, not "
            "a servable export")
    # reg.get's verifying read has sha256'd model.npz against the
    # artifact manifest: skip the embedded digest's second pass.
    bundle = api.load_model(os.path.join(art_dir, aot.MODEL_FILE),
                            verify=False)
    ce = bundle.ensemble.compile(tree_chunk=int(man["tree_chunk"]))
    if ce.token != man["model_token"]:
        raise IntegrityError(
            f"{digest}: model.npz rebuilds to token {ce.token[:12]} but "
            f"the manifest pins {str(man['model_token'])[:12]}")
    qmeta = man.get("quantized")
    # Artifacts from before the int4 tier carry no "tier": int8.
    art_tier = qmeta.get("tier", "int8") if qmeta else None
    if quantize is None:
        tier = art_tier
    elif quantize is True:
        tier = art_tier or "int8"
    else:
        tier = normalize_quantize(quantize)
    if tier and qmeta is None:
        raise ValueError(
            f"{ref!r} was exported without the quantized variant; "
            f"re-push with quantize={tier!r} to serve a LUT tier")
    if tier and tier != art_tier:
        raise RegistryError(
            f"{ref!r} carries the {art_tier!r} quantized tier but "
            f"{tier!r} was requested: the carried tables are the "
            f"representation that serves; re-push with quantize={tier!r}")
    kernels = man.get("kernels")
    if kernels is not None and kernels != aot.kernels_key():
        log.warning("artifact %s was exported against kernel build %s; "
                    "this checkout builds %s (the model serves through "
                    "this checkout's kernels)", digest, kernels,
                    aot.kernels_key())
    if backend is None:
        impl = TIER_IMPL.get(tier, "auto")
        if cfg is None:
            cfg = TrainConfig(device=device, predict_impl=impl)
        elif cfg.predict_impl != impl:
            cfg = cfg.replace(predict_impl=impl)
        backend = get_backend(cfg)
    mode = "tables-fallback" if tier else "rebuild"
    model = ServableModel(
        bundle, backend, quantize=tier,
        buckets=tuple(sorted(int(b) for b in man["buckets"])), raw=raw,
        tables=_load_tables(art_dir, man) if tier else None)
    model.artifact_digest = digest
    _emit_artifact_event(run_log, "load", digest, man, mode=mode)
    log.info("restored %s from %s (%s)", man["model_token"][:12], digest,
             mode)
    return LoadReport(digest=digest, mode=mode, model=model, manifest=man)


def _load_tables(art_dir: str, man: dict):
    """The carried quantized tables (lut_tables.npz), token-checked
    against the manifest (Registry.get has verified the file's hash)."""
    from ddt_tpu_torch.export import aot
    from ddt_tpu_torch.ops.predict_lut import tables_from_arrays

    path = os.path.join(art_dir, aot.LUT_TABLES_FILE)
    with np.load(path) as z:
        tables = tables_from_arrays(dict(z))
    if tables.token != man["model_token"]:
        raise IntegrityError(
            f"{path}: quantized tables carry token {tables.token[:12]} "
            f"but the manifest pins {str(man['model_token'])[:12]}")
    return tables


def push_servable(root, bundle, *, name: str | None = None,
                  max_batch: int = 256, quantize=False, raw: bool = False,
                  tree_chunk: int = 64, run_id: str | None = None,
                  tag: str | None = None, run_log=None) -> dict:
    """Export and publish in one call: stage a servable artifact for the
    engine's power-of-two bucket ladder up to `max_batch`, then push it
    (an `artifact` push event to `run_log`, a RunLog or a path). `quantize`
    is the tier (False | True/"int8" | "int4"). Returns the store's
    {digest, name, version}."""
    from ddt_tpu_torch.export import aot
    from ddt_tpu_torch.serve.engine import default_buckets
    from ddt_tpu_torch.telemetry.events import RunLog

    if tag is not None and name is None:
        raise RegistryError(
            "a tag needs a name to live under (tags are rows of the name "
            "index); pass name= alongside tag=")
    reg = root if isinstance(root, Registry) else Registry(root)
    stage = reg.stage()
    try:
        aot.stage_servable(stage, bundle, buckets=default_buckets(max_batch),
                           quantize=quantize, raw=raw,
                           tree_chunk=tree_chunk, run_id=run_id)
        # stage_servable hashed every file moments ago in this process.
        return reg.push(stage, name, tag=tag, run_log=RunLog.coerce(run_log),
                        verify_files=False)
    except BaseException:
        shutil.rmtree(stage, ignore_errors=True)
        raise


def short_digest(digest: str) -> str:
    return digest[:DIGEST_LEN]
