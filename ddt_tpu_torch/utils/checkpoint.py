"""Checkpoint and resume of a training run.

Port of ddt_tpu/utils/checkpoint.py, with its fault-plan injection sites
(`ckpt.save.write` before the ensemble write, `ckpt.save.between`
between the pair's two replaces, `ckpt.load` before the cursor read) and its
retry seams (`ckpt.save` around the ensemble and cursor writes,
`ckpt.load` around the cursor and npz reads; utils/retry). After every `checkpoint_every` rounds the Driver writes the partial
ensemble and a cursor (completed rounds, config fingerprint, the
ensemble file's sha256); resume loads the node arrays into the fresh
ensemble and the Driver rebuilds the boosting state by rescoring them in
the fit loop's own order (TreeEnsemble.predict_raw_roundwise), so a
resumed run grows the trees an uninterrupted one grows.

- Pair atomicity: ensemble.npz and cursor.json are two os.replace's; the
  cursor carries the digest of the ensemble it describes, so a crash
  between them is a detected torn pair, never a skewed resume.
- History: each landed pair is hard-linked (copy fallback) into
  `ckpt-<round>/`, the newest KEEP_LAST kept; a torn or corrupt top-level
  pair falls back to the newest valid history pair, and with none left
  training starts afresh (a warning, never a crash).
- A valid checkpoint written by an incompatible config raises: resuming
  another run would corrupt this one silently.
- Fault events (`checkpoint_corrupt` per bad candidate,
  `checkpoint_fallback` on recovery, `checkpoint_unrecoverable`) go to
  the caller's run log, or to the process fault sink.

The ensemble file is the TreeEnsemble npz both packages read, so a
checkpoint's model loads in either. The cursor's fingerprint is this
package's TrainConfig.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import os
import re
import shutil
import zipfile

from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.models.tree import TreeEnsemble
from ddt_tpu_torch.robustness import emit_fault, faultplan
from ddt_tpu_torch.utils import retry
from ddt_tpu_torch.utils.atomic import atomic_savez

log = logging.getLogger("ddt_tpu_torch.checkpoint")

CKPT_FILE = "ensemble.npz"
CURSOR_FILE = "cursor.json"
HISTORY_PREFIX = "ckpt-"
_HISTORY_RE = re.compile(re.escape(HISTORY_PREFIX) + r"(\d+)$")
#: Retained `ckpt-<round>` history pairs (beyond the top-level pair).
KEEP_LAST = 3
CURSOR_SCHEMA = 2
#: Fields that may differ across a resume: the round target (resuming to
#: train further is the point) and where and how the rounds run, the
#: partition layout and the backend included (the reference's list,
#: ddt_tpu/utils/checkpoint.py:75-86): a run checkpointed on one mesh
#: resumes on another, or on one device. The robustness knobs are system
#: knobs too: a run that crashed under a fault plan resumes without one.
_SYSTEM_FIELDS = ("n_trees", "device", "fused_block_rounds",
                  "predict_impl", "n_partitions", "feature_partitions",
                  "host_partitions", "mesh_shape", "backend", "fault_plan",
                  "straggler_repartition", "straggler_skew_threshold")


def cfg_fingerprint(cfg: TrainConfig) -> dict:
    """The config fields that must match for a checkpoint to resume."""
    d = dataclasses.asdict(cfg)
    for k in _SYSTEM_FIELDS:
        d.pop(k)
    # JSON round-trips tuples as lists.
    d["cat_features"] = list(d["cat_features"])
    return d


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _history_dirs(ckpt_dir: str) -> list[tuple[int, str]]:
    """(round, path) of every ckpt-<round> history dir, newest first."""
    try:
        names = os.listdir(ckpt_dir)
    except OSError:
        return []
    out = [(int(m.group(1)), os.path.join(ckpt_dir, n))
           for n in names if (m := _HISTORY_RE.match(n))]
    out.sort(reverse=True)
    return out


def _link_or_copy(src: str, dst: str) -> None:
    """Hard link, or a copy where links fail. A later os.replace of the
    source leaves the linked inode alone."""
    if os.path.exists(dst):
        os.remove(dst)
    try:
        os.link(src, dst)
    except OSError:
        shutil.copy2(src, dst)


def _retain_history(ckpt_dir: str, completed_rounds: int,
                    keep_last: int) -> None:
    """Link the landed pair into ckpt-<round>/ and prune older history
    past `keep_last`; a failure here never fails the save that landed."""
    hist = os.path.join(ckpt_dir, f"{HISTORY_PREFIX}{completed_rounds:06d}")
    try:
        os.makedirs(hist, exist_ok=True)
        for name in (CKPT_FILE, CURSOR_FILE):
            _link_or_copy(os.path.join(ckpt_dir, name),
                          os.path.join(hist, name))
    except OSError as e:
        log.warning("checkpoint history retention failed for round %d: %s",
                    completed_rounds, e)
        return
    for _, path in _history_dirs(ckpt_dir)[keep_last:]:
        shutil.rmtree(path, ignore_errors=True)


def save_checkpoint(ckpt_dir: str, ens: TreeEnsemble, cfg: TrainConfig,
                    completed_rounds: int,
                    keep_last: int = KEEP_LAST) -> None:
    """Atomically write the ensemble, then the cursor naming its digest,
    then retain the pair in the history."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, CKPT_FILE)

    def write_ensemble() -> str:
        faultplan.inject("ckpt.save.write", round=completed_rounds)
        atomic_savez(final, compressed=True, **ens.to_dict())
        return _sha256_file(final)

    digest = retry.retry_call(write_ensemble, seam="ckpt.save")
    # A crash here leaves ensemble.npz one save ahead of cursor.json: the
    # digest below is how resume detects it.
    faultplan.inject("ckpt.save.between", round=completed_rounds)
    cur = {"completed_rounds": int(completed_rounds),
           "config": cfg_fingerprint(cfg),
           "ensemble_digest": digest,
           "ckpt_schema": CURSOR_SCHEMA}

    def write_cursor() -> None:
        tmp = os.path.join(ckpt_dir, CURSOR_FILE + ".tmp")
        with open(tmp, "w") as f:
            json.dump(cur, f)
        os.replace(tmp, os.path.join(ckpt_dir, CURSOR_FILE))

    retry.retry_call(write_cursor, seam="ckpt.save")
    _retain_history(ckpt_dir, completed_rounds, keep_last)


def maybe_save(ckpt_dir: str | None, ens: TreeEnsemble, cfg: TrainConfig,
               completed_rounds: int, every: int | None = None) -> None:
    """save_checkpoint when a directory is set and either `every` is None
    (forced: the end-of-training save) or the round is on the cadence."""
    if ckpt_dir is None:
        return
    if every is not None and completed_rounds % every != 0:
        return
    save_checkpoint(ckpt_dir, ens, cfg, completed_rounds)


def _read_pair(d: str) -> "dict | str | None":
    """The {"rounds", "cur", "saved"} pair in directory `d` when present
    and consistent; a string reason when torn or corrupt; None when
    absent."""
    cursor_path = os.path.join(d, CURSOR_FILE)
    ckpt_path = os.path.join(d, CKPT_FILE)
    have_cursor = os.path.exists(cursor_path)
    have_ckpt = os.path.exists(ckpt_path)
    if not have_cursor and not have_ckpt:
        return None
    if not have_cursor:
        return f"{CKPT_FILE} present but {CURSOR_FILE} missing"
    if not have_ckpt:
        return f"{CURSOR_FILE} present but {CKPT_FILE} missing"
    def read_cursor():
        faultplan.inject("ckpt.load")
        with open(cursor_path) as f:
            return json.load(f)

    try:
        cur = retry.retry_call(read_cursor, seam="ckpt.load")
    except (json.JSONDecodeError, UnicodeDecodeError, OSError) as e:
        return f"{CURSOR_FILE} unreadable: {type(e).__name__}: {e}"
    if not isinstance(cur, dict) or "completed_rounds" not in cur \
            or "config" not in cur:
        return f"{CURSOR_FILE} malformed (missing required fields)"
    digest = cur.get("ensemble_digest")
    if digest is not None:
        try:
            actual = _sha256_file(ckpt_path)
        except OSError as e:
            return f"{CKPT_FILE} unreadable: {e}"
        if actual != digest:
            return (f"{CKPT_FILE} does not match the cursor's digest "
                    "(torn checkpoint write)")
    try:
        saved = retry.retry_call(TreeEnsemble.load, ckpt_path,
                                 seam="ckpt.load")
    except (OSError, ValueError, KeyError, EOFError,
            zipfile.BadZipFile) as e:
        return f"{CKPT_FILE} unreadable: {type(e).__name__}: {e}"
    return {"rounds": int(cur["completed_rounds"]), "cur": cur,
            "saved": saved}


def try_resume(ckpt_dir: str, ens: TreeEnsemble, cfg: TrainConfig,
               run_log=None) -> int:
    """Load the newest valid checkpoint's trees into `ens` (in place) and
    return its completed rounds (0: nothing to resume). Torn or corrupt
    pairs fall back to older history with a warning and fault events
    (into `run_log`, else the process fault sink); a valid pair of an
    incompatible config, or with more rounds than cfg.n_trees, raises."""
    def fault(kind: str, **fields) -> None:
        if run_log is not None:
            run_log.emit("fault", kind=kind, **fields)
        else:
            emit_fault(kind, **fields)

    candidates = [("latest", ckpt_dir)] + [
        (f"{HISTORY_PREFIX}{r:06d}", p) for r, p in _history_dirs(ckpt_dir)]
    saw_corrupt = False
    for label, d in candidates:
        res = _read_pair(d)
        if res is None:
            continue
        if isinstance(res, str):
            log.warning("checkpoint %s (%s): %s; trying older history",
                        label, d, res)
            fault("checkpoint_corrupt", candidate=label, reason=res)
            saw_corrupt = True
            continue
        cur, saved, rounds = res["cur"], res["saved"], res["rounds"]
        if cur["config"] != cfg_fingerprint(cfg):
            raise ValueError(
                f"checkpoint at {ckpt_dir} was written by an incompatible "
                "config; refusing to resume. Delete the directory to start "
                "fresh.")
        if rounds > cfg.n_trees:
            raise ValueError(
                f"checkpoint at {ckpt_dir} has {rounds} completed rounds "
                f"but cfg.n_trees={cfg.n_trees}; raise n_trees to resume.")
        if saw_corrupt:
            log.warning("checkpoint fallback: resuming from %s at round %d",
                        label, rounds)
            fault("checkpoint_fallback", candidate=label, round=rounds)
        k = rounds * cfg.n_outputs
        for name in ("feature", "threshold_bin", "threshold_raw", "is_leaf",
                     "leaf_value", "split_gain", "default_left"):
            getattr(ens, name)[:k] = getattr(saved, name)[:k]
        return rounds
    if saw_corrupt:
        log.warning("no valid checkpoint survives in %s; starting fresh",
                    ckpt_dir)
        fault("checkpoint_unrecoverable")
    return 0
