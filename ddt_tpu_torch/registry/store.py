"""Digest-addressed on-disk model registry.

Port of ddt_tpu/registry/store.py, with the same on-disk layout, so one
registry directory serves both packages:

    <root>/
      objects/<digest16>/        # one immutable artifact per content digest
        manifest.json            # per-file sha256 map + export metadata
        model.npz                # the api.save_model artifact
        lut_tables.npz           # quantized tables (quantized exports)
        aot/predict_*.bin        # the reference's serialized programs
      names/<name>.json          # version index: [{version, digest, …}]
      names/<name>.lock          # O_EXCL read-modify-write lock
      staging/…                  # in-flight pushes (same filesystem)

Write discipline:

- **Objects land atomically.** A push stages its files under
  `staging/`, finalizes the manifest and `os.rename`s the whole
  directory to `objects/<digest>`: readers see a complete artifact or
  nothing, and a killed push leaves only staging litter, which a later
  push sweeps. Content addressing makes concurrent pushes of the same
  content idempotent: whoever renames first wins, and the other finds
  the object present and succeeds without a second copy.
- **The name index is small JSON, locked then replaced.** Version
  assignment is a read-modify-write under `names/<name>.lock`
  (O_CREAT|O_EXCL with bounded retry), and the index lands via
  tmp-then-`os.replace`: concurrent pushers get dense, unique versions.
- **Reads verify.** `get()` re-hashes every file against the manifest
  and the manifest against its address; a torn or tampered object raises
  `IntegrityError`, never serves.

`push(..., run_log=)` emits the reference's `artifact` run-log event (a
telemetry RunLog).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import tempfile
import time
import uuid

from ddt_tpu_torch.registry.manifest import (
    IntegrityError, read_artifact_manifest)

log = logging.getLogger("ddt_tpu_torch.registry")

#: hex chars of the artifact sha256 used as the object directory name
#: (and the canonical short form printed everywhere).
DIGEST_LEN = 16
_LOCK_TIMEOUT_S = 10.0
_LOCK_POLL_S = 0.02
#: staged pushes older than this are crash litter (a live export runs
#: seconds, not hours) — swept by the next stage() call.
_STAGE_SWEEP_AGE_S = 3600.0


class RegistryError(ValueError):
    """Bad reference / missing object / misused registry — user-facing,
    distinct from IntegrityError (which means the BYTES are wrong)."""


class Registry:
    """One on-disk registry root. Thread- and process-safe for pushes
    (object renames are atomic; the name index is lock-serialized);
    reads need no locking at all — objects are immutable once visible."""

    def __init__(self, root: str):
        self.root = str(root)

    # ------------------------------------------------------------------ #
    # paths
    # ------------------------------------------------------------------ #

    @property
    def objects_dir(self) -> str:
        return os.path.join(self.root, "objects")

    @property
    def names_dir(self) -> str:
        return os.path.join(self.root, "names")

    def object_dir(self, digest: str) -> str:
        return os.path.join(self.objects_dir, digest[:DIGEST_LEN])

    def stage(self) -> str:
        """A fresh staging directory ON THE REGISTRY FILESYSTEM (the
        final `os.rename` into objects/ must never cross devices).
        Sweeps crash litter first: a SIGKILLed pusher's stage never got
        its cleanup, so stale push_* dirs (mtime older than the sweep
        age — far beyond any live export) are reclaimed here, best
        effort, without ever touching a concurrent pusher's fresh
        stage."""
        staging = os.path.join(self.root, "staging")
        os.makedirs(staging, exist_ok=True)
        cutoff = time.time() - _STAGE_SWEEP_AGE_S
        for entry in os.listdir(staging):
            if not entry.startswith("push_"):
                continue
            path = os.path.join(staging, entry)
            try:
                if os.path.getmtime(path) < cutoff:
                    log.info("sweeping stale stage %s", path)
                    shutil.rmtree(path, ignore_errors=True)
            except OSError:
                pass                    # raced with its owner: leave it
        return tempfile.mkdtemp(prefix="push_", dir=staging)

    # ------------------------------------------------------------------ #
    # push
    # ------------------------------------------------------------------ #

    def push(self, stage_dir: str, name: str | None = None, *,
             tag: str | None = None, run_log=None,
             verify_files: bool = True) -> dict:
        """Publish a finalized staged artifact (export.aot.stage_servable
        wrote it, manifest.json included). Returns {digest, name,
        version} (version None for anonymous pushes). Emits an
        `artifact` push event when `run_log` (a RunLog) is given.
        `verify_files=False` skips re-hashing every staged file, for
        callers that built the stage in this process (the manifest
        writer hashed them already)."""
        if tag is not None and name is None:
            raise RegistryError(
                "a tag needs a name to live under (tags are rows of "
                "the name index); pass name= alongside tag=")
        man, digest = read_artifact_manifest(stage_dir,
                                             verify_files=verify_files)
        os.makedirs(self.objects_dir, exist_ok=True)
        dst = self.object_dir(digest)
        if os.path.isdir(dst):
            # Content-addressed idempotence: the object is already
            # published (same bytes by construction) — drop the stage.
            shutil.rmtree(stage_dir, ignore_errors=True)
        else:
            try:
                os.rename(stage_dir, dst)       # the atomic publish
            except OSError:
                if not os.path.isdir(dst):      # not a lost same-digest
                    raise                       # race — a real failure
                shutil.rmtree(stage_dir, ignore_errors=True)
        version = None
        if name is not None:
            version = self._record_version(name, digest, man, tag=tag)
        if run_log is not None:
            run_log.emit(
                "artifact", action="push", digest=digest[:DIGEST_LEN],
                name=name, version=version, kind=man.get("kind"),
                run_id=man.get("run_id"), model_token=man.get(
                    "model_token", "")[:12] or None)
        log.info("registry push %s%s -> %s", name or "(anonymous)",
                 f"@{version}" if version else "", digest[:DIGEST_LEN])
        return {"digest": digest[:DIGEST_LEN], "name": name,
                "version": version}

    def _record_version(self, name: str, digest: str, man: dict, *,
                        tag: str | None = None) -> int:
        _check_name(name)
        os.makedirs(self.names_dir, exist_ok=True)
        with self._name_lock(name):
            idx = self._read_index(name)
            for v in idx["versions"]:
                if v["digest"] == digest[:DIGEST_LEN]:
                    # Same content re-pushed under the same name: reuse
                    # the version (push is idempotent end to end).
                    if tag is not None:
                        idx["tags"][tag] = v["version"]
                        self._write_index(name, idx)
                    return v["version"]
            version = 1 + max((v["version"] for v in idx["versions"]),
                              default=0)
            idx["versions"].append({
                "version": version, "digest": digest[:DIGEST_LEN],
                "pushed_at": time.time(),
                "run_id": man.get("run_id"),
                "model_token": (man.get("model_token") or "")[:12] or None,
                "quantized": bool(man.get("quantized")),
            })
            if tag is not None:
                idx["tags"][tag] = version
            self._write_index(name, idx)
        return version

    # ------------------------------------------------------------------ #
    # resolve / get / list / tag
    # ------------------------------------------------------------------ #

    def resolve(self, ref: str) -> str:
        """Reference -> full object-dir digest. Forms: `<digest>` (full
        or unique prefix, >= 8 hex chars), `name` (latest version),
        `name@<version>`, `name@<tag>`, `name@latest`."""
        ref = str(ref).strip()
        if not ref:
            raise RegistryError("empty registry reference")
        if "@" in ref:
            name, _, sel = ref.partition("@")
            return self._resolve_named(name, sel)
        # A bare hex string long enough to be unambiguous is a digest;
        # anything else is a name.
        if len(ref) >= 8 and all(c in "0123456789abcdef" for c in ref):
            cands = [d for d in self._object_digests()
                     if d.startswith(ref[:DIGEST_LEN])]
            if len(cands) == 1:
                return cands[0]
            if len(cands) > 1:
                raise RegistryError(
                    f"digest prefix {ref!r} is ambiguous ({len(cands)} "
                    "objects match); use more characters")
            # fall through: maybe it IS a model name that looks hexy
        return self._resolve_named(ref, "latest")

    def _resolve_named(self, name: str, sel: str) -> str:
        idx = self._read_index(name)
        if not idx["versions"]:
            raise RegistryError(
                f"no model named {name!r} in registry {self.root}")
        if sel in ("", "latest"):
            return idx["versions"][-1]["digest"]
        if sel.isdigit():
            for v in idx["versions"]:
                if v["version"] == int(sel):
                    return v["digest"]
            raise RegistryError(
                f"{name}@{sel}: no such version (have 1.."
                f"{idx['versions'][-1]['version']})")
        if sel in idx["tags"]:
            return self._resolve_named(name, str(idx["tags"][sel]))
        raise RegistryError(
            f"{name}@{sel}: no such version or tag "
            f"(tags: {sorted(idx['tags']) or 'none'})")

    def get(self, ref: str, *, verify: bool = True
            ) -> tuple[str, dict, str]:
        """(object dir, manifest, short digest) for a reference, with a
        full integrity check by default (every file re-hashed against
        the manifest, the manifest re-hashed against the address)."""
        digest = self.resolve(ref)
        d = self.object_dir(digest)
        if not os.path.isdir(d):
            raise RegistryError(
                f"{ref!r} resolves to {digest} but the object is missing "
                f"from {self.objects_dir} (pruned externally?)")
        man, full = read_artifact_manifest(d, verify_files=verify)
        if not full.startswith(digest[:DIGEST_LEN]):
            raise IntegrityError(
                f"{d}: manifest hashes to {full[:DIGEST_LEN]} but the "
                f"object is addressed as {digest[:DIGEST_LEN]} — the "
                "manifest was rewritten in place")
        return d, man, digest[:DIGEST_LEN]

    def list(self, name: str | None = None) -> dict:
        """Registry inventory: {name: {versions: […], tags: {…}}} (one
        entry when `name` is given), plus anonymous object digests not
        referenced by any name."""
        names = {}
        if name is not None:
            names[name] = self._read_index(name)
        else:
            try:
                files = sorted(os.listdir(self.names_dir))
            except OSError:
                files = []
            for fn in files:
                if fn.endswith(".json"):
                    n = fn[:-len(".json")]
                    names[n] = self._read_index(n)
        referenced = {v["digest"] for idx in names.values()
                      for v in idx["versions"]}
        anonymous = ([d for d in self._object_digests()
                      if d not in referenced] if name is None else [])
        return {"root": self.root, "names": names, "anonymous": anonymous}

    def tag(self, ref: str, tag: str) -> dict:
        """Point `name`'s tag at the version `ref` resolves to; ref must
        be name-qualified (tags live in the name index)."""
        if "@" not in ref:
            ref = ref + "@latest"
        name, _, sel = ref.partition("@")
        _check_name(name)
        if not tag or tag == "latest" or tag.isdigit():
            raise RegistryError(
                f"tag {tag!r} is reserved (versions and 'latest' resolve "
                "first); pick a non-numeric tag name")
        digest = self._resolve_named(name, sel)
        with self._name_lock(name):
            idx = self._read_index(name)
            version = next(v["version"] for v in idx["versions"]
                           if v["digest"] == digest)
            idx["tags"][tag] = version
            self._write_index(name, idx)
        return {"name": name, "tag": tag, "version": version,
                "digest": digest}

    # ------------------------------------------------------------------ #
    # name-index plumbing
    # ------------------------------------------------------------------ #

    def _index_path(self, name: str) -> str:
        return os.path.join(self.names_dir, f"{name}.json")

    def _read_index(self, name: str) -> dict:
        _check_name(name)
        try:
            with open(self._index_path(name), encoding="utf-8") as f:
                idx = json.load(f)
        except OSError:
            return {"versions": [], "tags": {}}
        except ValueError as e:
            # The index lands via os.replace, so a torn one means bit
            # rot, not a crashed writer — surface it.
            raise IntegrityError(
                f"{self._index_path(name)}: corrupt name index ({e})"
            ) from e
        idx.setdefault("versions", [])
        idx.setdefault("tags", {})
        return idx

    def _write_index(self, name: str, idx: dict) -> None:
        final = self._index_path(name)
        tmp = f"{final}.{uuid.uuid4().hex[:8]}.tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(idx, f, sort_keys=True)
            os.replace(tmp, final)
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise

    def _name_lock(self, name: str):
        return _PathLock(os.path.join(self.names_dir, f"{name}.lock"))

    def _object_digests(self) -> list[str]:
        try:
            return sorted(os.listdir(self.objects_dir))
        except OSError:
            return []


class _PathLock:
    """O_CREAT|O_EXCL lockfile with bounded retry — the smallest
    mutual-exclusion primitive that works across processes on any
    filesystem. Held only around the tiny name-index read-modify-write,
    never around artifact hashing or renames."""

    def __init__(self, path: str,
                 timeout_s: float = _LOCK_TIMEOUT_S):
        self.path = path
        self.timeout_s = timeout_s

    def __enter__(self) -> "_PathLock":
        deadline = time.monotonic() + self.timeout_s
        while True:
            try:
                fd = os.open(self.path,
                             os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.write(fd, str(os.getpid()).encode())
                os.close(fd)
                return self
            except FileExistsError:
                if time.monotonic() >= deadline:
                    raise RegistryError(
                        f"timed out after {self.timeout_s:.0f}s waiting "
                        f"for {self.path} (a crashed pusher may have "
                        "left a stale lock; remove it to recover)"
                    ) from None
                time.sleep(_LOCK_POLL_S)

    def __exit__(self, *exc) -> None:
        try:
            os.remove(self.path)
        except OSError:
            pass


def _check_name(name: str) -> None:
    """Names become filenames: keep them path-safe and unambiguous with
    digests/refs (no '@', no separators, not pure hex-ish enforcement —
    resolve() prefers digests only at >= 8 hex chars)."""
    if not name or any(c in name for c in "@/\\") or name.startswith("."):
        raise RegistryError(
            f"invalid model name {name!r}: names must be non-empty, "
            "contain no '@' or path separators, and not start with '.'")
