"""Atomic npz artifact writes (docs/ROBUSTNESS.md atomic-artifact-write).

THE shared tmp-then-`os.replace` dance for every persistent-artifact
writer (model save, checkpoint ensemble, chunk/cache shards) — one home,
so a future hardening (fsync-before-replace, say) lands once. ddtlint's
`atomic-artifact-write` rule enforces the pattern; this helper is how
the artifact-owning modules comply."""

from __future__ import annotations

import os

import numpy as np


def atomic_savez(path, *, compressed: bool = False,
                 deterministic: bool = False, **arrays) -> str:
    """np.savez[_compressed] via a tmp-suffixed sibling + os.replace, so
    a process killed mid-save leaves the previous artifact intact —
    never a torn npz at the canonical name. Mirrors np.savez's
    suffixing (a bare path gains .npz) so the final name matches what a
    direct call produced. Returns the final path; a failed write
    removes its tmp sibling before re-raising.

    `deterministic=True` additionally pins every zip member's mtime to
    the epoch, making the FILE BYTES a pure function of the arrays:
    npz is a zip, and zip stamps each entry with 2-second-resolution
    wall time, so two otherwise-identical saves straddling a tick would
    hash differently — which would break the registry's content
    addressing (same model re-pushed must reuse its digest and version,
    docs/REGISTRY.md). Model artifacts opt in; bulk writers (checkpoint
    cadence, chunk caches) skip the extra rewrite pass."""
    final = str(path)
    if not final.endswith(".npz"):
        final += ".npz"
    tmp = final + ".tmp.npz"
    save = np.savez_compressed if compressed else np.savez
    try:
        save(tmp, **arrays)
        if deterministic:
            _strip_zip_times(tmp)
        os.replace(tmp, final)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    return final


def _strip_zip_times(path: str) -> None:
    """Rewrite a zip in place with every member stamped 1980-01-01 (the
    zip epoch) — the one nondeterministic input np.savez bakes into the
    bytes. Entries keep their compression type; the rewrite happens on
    the tmp sibling BEFORE os.replace, so atomicity is untouched."""
    import zipfile

    tmp2 = path + ".tmp.det"
    try:
        with zipfile.ZipFile(path) as src, \
                zipfile.ZipFile(tmp2, "w") as dst:
            for info in src.infolist():
                zi = zipfile.ZipInfo(info.filename,
                                     date_time=(1980, 1, 1, 0, 0, 0))
                zi.compress_type = info.compress_type
                zi.external_attr = info.external_attr
                dst.writestr(zi, src.read(info.filename))
        os.replace(tmp2, path)
    except BaseException:
        try:
            os.remove(tmp2)
        except OSError:
            pass
        raise
