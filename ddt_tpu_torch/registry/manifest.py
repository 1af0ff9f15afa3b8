"""Artifact manifests: provenance and integrity of every persisted model.

Port of ddt_tpu/registry/manifest.py (stdlib and numpy). Two forms:

- **npz-embedded** (`api.save_model`, `TreeEnsemble.save`): one JSON blob
  under the `manifest_json` key inside the npz: schema version, content
  digest of the payload arrays, training `run_id`, config fingerprint,
  git rev. `read_npz_manifest` recomputes the digest at load and raises
  `IntegrityError` on a mismatch; files without the key (written before
  manifests existed) load as before.
- **artifact-directory** (a registry object, `objects/<digest>/`): a
  `manifest.json` beside the files it describes, with a sha256 per file
  and the export metadata. The artifact digest is the sha256 of the
  canonical manifest bytes, so a flipped byte in any file changes the
  address.

The digests are computed exactly as the reference computes them, so the
two packages verify each other's files.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import subprocess

import numpy as np

#: npz key holding the embedded manifest blob.
NPZ_MANIFEST_KEY = "manifest_json"
#: embedded-manifest schema (bumped when a required field changes meaning).
MANIFEST_SCHEMA = 1
#: artifact-directory schema (the registry object layout).
ARTIFACT_SCHEMA = 1
MANIFEST_FILE = "manifest.json"


class IntegrityError(ValueError):
    """A persisted artifact does not match its recorded digests (torn
    write, bit rot, tampering). A ValueError, so callers that guard loads
    with `except ValueError` keep working."""


@functools.lru_cache(maxsize=1)
def git_rev() -> str | None:
    """The checkout's HEAD (short), or None outside a git checkout.
    Memoized: every model save stamps it."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() if out.returncode == 0 else None


def arrays_digest(arrays: dict) -> str:
    """Content digest of an npz payload: sha256 over every (key, dtype,
    shape, bytes) in sorted key order, the manifest key excluded (the
    manifest cannot cover its own bytes)."""
    h = hashlib.sha256()
    for k in sorted(arrays):
        if k == NPZ_MANIFEST_KEY:
            continue
        a = np.asarray(arrays[k])
        h.update(k.encode())
        h.update(str(a.dtype).encode())
        h.update(repr(a.shape).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def build_npz_manifest(arrays: dict, *, kind: str, run_id: str | None = None,
                       config_fingerprint: str | None = None,
                       **extras) -> dict:
    """The embedded-manifest dict of one npz payload. No timestamps: the
    manifest is part of the file bytes a registry digest covers, and the
    same model saved twice must give the same bytes."""
    man = {
        "manifest_schema": MANIFEST_SCHEMA,
        "kind": kind,
        "digest": arrays_digest(arrays),
        "run_id": run_id,
        "config_fingerprint": config_fingerprint,
        "git_rev": git_rev(),
    }
    man.update(extras)
    return man


def embed_npz_manifest(arrays: dict, *, kind: str,
                       run_id: str | None = None,
                       config_fingerprint: str | None = None,
                       **extras) -> dict:
    """Add the manifest blob to `arrays` in place (under
    NPZ_MANIFEST_KEY); returns the manifest dict."""
    man = build_npz_manifest(arrays, kind=kind, run_id=run_id,
                             config_fingerprint=config_fingerprint, **extras)
    arrays[NPZ_MANIFEST_KEY] = np.bytes_(
        json.dumps(man, sort_keys=True).encode())
    return man


def read_npz_manifest(arrays: dict, *, verify: bool = True,
                      source: str = "artifact") -> dict | None:
    """The embedded manifest of a loaded npz dict, digest-verified unless
    `verify=False`. None for a file without one; IntegrityError when one
    is present and the payload no longer hashes to its digest."""
    blob = arrays.get(NPZ_MANIFEST_KEY)
    if blob is None:
        return None
    try:
        man = json.loads(bytes(np.asarray(blob).item()))
    except (ValueError, TypeError) as e:
        raise IntegrityError(
            f"{source}: embedded manifest is not valid JSON ({e})") from e
    if verify:
        actual = arrays_digest(arrays)
        if man.get("digest") != actual:
            raise IntegrityError(
                f"{source}: content digest mismatch — manifest says "
                f"{str(man.get('digest'))[:16]}…, payload hashes to "
                f"{actual[:16]}… (torn write or corrupted file); "
                "re-export the artifact")
    return man


def config_fingerprint_digest(cfg) -> str:
    """Short digest of the resumability fingerprint of `cfg`
    (utils/checkpoint.cfg_fingerprint): the manifest field that links a
    model to its training configuration. It is computed over this
    package's TrainConfig, whose fields differ from the reference's, so
    the value differs from the reference's for the same run."""
    from ddt_tpu_torch.utils.checkpoint import cfg_fingerprint

    blob = json.dumps(cfg_fingerprint(cfg), sort_keys=True, default=str)
    return hashlib.sha1(blob.encode()).hexdigest()[:12]


# --------------------------------------------------------------------- #
# artifact-directory manifests (the registry object layout)
# --------------------------------------------------------------------- #

def file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _walk_files(art_dir: str) -> list[str]:
    """Every file under `art_dir` but the manifest, as sorted
    /-separated relative paths (the file set the digest covers)."""
    out = []
    for dirpath, _dirnames, fns in os.walk(art_dir):
        for fn in fns:
            rel = os.path.relpath(os.path.join(dirpath, fn),
                                  art_dir).replace(os.sep, "/")
            if rel != MANIFEST_FILE:
                out.append(rel)
    return sorted(out)


def write_artifact_manifest(art_dir: str, meta: dict) -> str:
    """Finalize a staged artifact directory: hash every file into a
    `files` map, write manifest.json (tmp, then os.replace) and return the
    artifact digest (sha256 of the canonical manifest bytes)."""
    files = {rel: {"sha256": file_sha256(os.path.join(art_dir, rel)),
                   "bytes": os.path.getsize(os.path.join(art_dir, rel))}
             for rel in _walk_files(art_dir)}
    man = {"artifact_schema": ARTIFACT_SCHEMA, **meta, "files": files}
    blob = json.dumps(man, sort_keys=True).encode()
    final = os.path.join(art_dir, MANIFEST_FILE)
    tmp = final + ".tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, final)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    return hashlib.sha256(blob).hexdigest()


def read_artifact_manifest(art_dir: str, *, verify_files: bool = True
                           ) -> tuple[dict, str]:
    """(manifest, artifact digest) of one object directory. The manifest
    must parse and, with `verify_files`, every listed file must exist with
    its recorded sha256 and no unlisted file may sit in the directory.
    Raises IntegrityError otherwise."""
    path = os.path.join(art_dir, MANIFEST_FILE)
    try:
        with open(path, "rb") as f:
            blob = f.read()
        man = json.loads(blob)
    except OSError as e:
        raise IntegrityError(f"{art_dir}: unreadable manifest: {e}") from e
    except ValueError as e:
        raise IntegrityError(
            f"{art_dir}: manifest is not valid JSON ({e})") from e
    if not isinstance(man, dict) or "files" not in man:
        raise IntegrityError(f"{art_dir}: manifest missing the files map")
    digest = hashlib.sha256(blob).hexdigest()
    if verify_files:
        listed = set(man["files"])
        present = set(_walk_files(art_dir))
        if present != listed:
            raise IntegrityError(
                f"{art_dir}: file set drifted from the manifest "
                f"(missing: {sorted(listed - present)}, "
                f"unlisted: {sorted(present - listed)})")
        for rel, rec in sorted(man["files"].items()):
            actual = file_sha256(os.path.join(art_dir, rel))
            if actual != rec["sha256"]:
                raise IntegrityError(
                    f"{art_dir}/{rel}: sha256 mismatch — manifest says "
                    f"{rec['sha256'][:16]}…, file hashes to "
                    f"{actual[:16]}… (torn or corrupted artifact)")
    return man, digest
