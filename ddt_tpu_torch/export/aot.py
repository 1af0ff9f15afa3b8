"""The servable artifact: what a registry object holds for the port.

Port of ddt_tpu/export/aot.py's `stage_servable`. The reference ships one
serialized jax.export program per bucket shape (`aot/predict_*.bin`), so a
cold serving process never re-traces the model. PyTorch has no twin of
those programs and none is emulated: the port's scoring path is its
kernels (csrc/lut.cu, K3 / K4 / K5), built once per checkout, and a cold
process whose kernels are built restores and serves with no nvcc run
(registry/loader). The artifact holds:

- `model.npz`: the api.save_model bundle (ensemble, mapper, encoder,
  embedded manifest);
- for a quantized tier, `lut_tables.npz`: the tables in
  ops/predict_lut.tables_to_arrays' layout (the reference's), so the
  quantized representation and its `max_abs_err` bound are what serves
  after a restore, never a re-quantization;
- `manifest.json`: the reference's fields (kind "servable", model_token,
  tree_chunk, buckets, raw, quantized {tier, leaf_dtype, max_abs_err},
  drift_reference, run_id, git_rev, ...), with `platforms` and
  `lut_platforms` empty (no JAX program rides along, so the reference's
  loader rebuilds from model.npz and the carried tables), and the port's
  own: `restorer` "ddt_tpu_torch", `torch_version`, and `kernels`, the
  build key (`_build.source_hash`) and arch of the kernel source that
  scores it.

The manifest carries no timestamp: its bytes are the artifact's digest,
and exporting the same model again must give the same address.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from ddt_tpu_torch import _build
from ddt_tpu_torch.ops import predict_lut
from ddt_tpu_torch.registry import manifest as manifest_mod
from ddt_tpu_torch.utils.atomic import atomic_savez

MODEL_FILE = "model.npz"
LUT_TABLES_FILE = "lut_tables.npz"
#: The reference's directory of serialized programs (listed in its
#: artifacts' manifests; the port writes none and reads none).
AOT_DIR = "aot"
#: The kernel source that scores every tier (K3, K4 and K5).
KERNEL_SOURCE = "lut"
RESTORER = "ddt_tpu_torch"


@dataclasses.dataclass
class StagedArtifact:
    stage_dir: str
    manifest: dict
    digest: str          # full sha256 of the manifest bytes


def kernels_key() -> dict:
    """The manifest's `kernels` entry: csrc/lut.cu's build key and arch."""
    return {KERNEL_SOURCE: {"source_hash": _build.source_hash(KERNEL_SOURCE),
                            "arch": _build.ARCH}}


def stage_servable(
    stage_dir: str,
    bundle,                       # api.ModelBundle (or TrainResult-like)
    *,
    buckets: tuple,
    quantize=False,               # False | True/"int8" | "int4"
    raw: bool = False,
    tree_chunk: int = 64,
    run_id: str | None = None,
) -> StagedArtifact:
    """Write a complete servable artifact into `stage_dir` (the registry's
    staging area): model.npz, lut_tables.npz for a quantized tier
    (True/"int8" the fp16-leaf int8 tables, "int4" the int4 ones) and
    the finalized manifest.json. Returns the manifest and the digest;
    `Registry.push(stage_dir, ...)` publishes it."""
    from ddt_tpu_torch import api
    from ddt_tpu_torch.serve.engine import (TIER_LEAF_DTYPE,
                                            normalize_quantize)

    ens = bundle.ensemble
    buckets = tuple(sorted({int(b) for b in buckets}))
    if not buckets or buckets[0] < 1:
        raise ValueError(f"buckets must be positive ints, got {buckets}")
    emb = getattr(bundle, "manifest", None) or {}
    if run_id is None:
        run_id = emb.get("run_id")
    os.makedirs(stage_dir, exist_ok=True)
    api.save_model(os.path.join(stage_dir, MODEL_FILE), ens,
                   mapper=bundle.mapper,
                   encoder=getattr(bundle, "encoder", None), run_id=run_id)
    ce = ens.compile(tree_chunk=tree_chunk)
    tier = normalize_quantize(quantize)
    quantized_meta = None
    if tier:
        tables = ce.quantize(leaf_dtype=TIER_LEAF_DTYPE[tier])
        quantized_meta = {"tier": tier, "leaf_dtype": tables.leaf_dtype,
                          "max_abs_err": tables.max_abs_err}
        if tier == "int4":
            quantized_meta["thr_packed"] = tables.pack_int4().thr_packed
        atomic_savez(os.path.join(stage_dir, LUT_TABLES_FILE),
                     compressed=True, deterministic=True,
                     **predict_lut.tables_to_arrays(tables))
    meta = {
        "kind": "servable",
        "model_token": ce.token,
        "loss": ens.loss,
        "n_classes": int(ens.n_classes),
        "n_features": int(ens.n_features),
        "n_trees": int(ens.n_trees),
        "max_depth": int(ens.max_depth),
        "tree_chunk": int(tree_chunk),
        "buckets": list(buckets),
        "raw": bool(raw),
        "has_mapper": bundle.mapper is not None,
        "has_encoder": getattr(bundle, "encoder", None) is not None,
        # Whether the mapper carries the training bin histogram (the
        # serving tier's drift reference).
        "drift_reference": getattr(bundle.mapper, "ref_counts",
                                   None) is not None,
        "platforms": [],
        "lut_platforms": [],
        "quantized": quantized_meta,
        "run_id": run_id,
        "config_fingerprint": emb.get("config_fingerprint"),
        "git_rev": manifest_mod.git_rev(),
        "restorer": RESTORER,
        "torch_version": torch.__version__,
        "kernels": kernels_key(),
    }
    digest = manifest_mod.write_artifact_manifest(stage_dir, meta)
    return StagedArtifact(stage_dir=stage_dir, manifest=dict(meta),
                          digest=digest)
