"""Cross-host run-log merge: N per-host JSONL logs -> one timeline.
(Copied from ddt_tpu/telemetry/merge.py.)

Multi-host training (parallel/mesh.initialize_multihost) is SPMD: every
host runs the same program and writes its OWN run log with its OWN
clock. This module joins those logs into a single event stream the
report and trace consumers can read as one run:

- **Join key**: the manifests' `run_id` (schema v2, a deterministic
  config digest — telemetry.events.derive_run_id — identical on every
  host by SPMD construction). Logs whose manifests carry DIFFERENT run
  ids are refused loudly: merging unrelated runs silently is the worst
  failure mode a merge tool can have. Pre-v2 logs without run ids merge
  on trust (the caller named the files).
- **Clock offset**: estimated from the manifests — every host emits its
  manifest at the same program point (right before the first upload, a
  breath after the collective bootstrap barrier), so
  `offset_h = t_manifest_h - t_manifest_0` captures wall-clock skew up
  to the bootstrap jitter. Adjusted times are host-0's clock.
- **Deterministic ordering**: events sort by (adjusted t, host, seq) —
  a total order, so the merged stream is byte-stable no matter the
  input file order (tested with interleaved rounds + a fabricated
  offset).

Every merged event gains/keeps a `host` field (from its manifest, else
the input position) so per-host lanes survive into `report` and the
Perfetto export.
"""

from __future__ import annotations

from ddt_tpu_torch.telemetry.report import read_events


def _manifest(events: list[dict]) -> dict | None:
    for e in events:
        if e["event"] == "run_manifest":
            return e
    return None


def merge_events(per_host: list[list[dict]]) -> list[dict]:
    """Merge N hosts' event lists (each a validated read_events result)
    into one host-0-clock timeline. Returns NEW event dicts (inputs are
    not mutated); raises ValueError on run-id mismatch or a hostless
    log list."""
    if not per_host:
        raise ValueError("merge needs at least one event list")
    manifests = []
    for i, events in enumerate(per_host):
        m = _manifest(events)
        if m is None:
            raise ValueError(f"input {i}: no run_manifest — cannot "
                             "estimate its clock offset")
        manifests.append(m)
    run_ids = {m.get("run_id") for m in manifests}
    if len(run_ids) > 1 and run_ids != {None}:
        raise ValueError(
            f"refusing to merge logs from different runs: run_ids="
            f"{sorted(str(r) for r in run_ids)} (the merge key is the "
            "manifest run_id; these logs were not written by one run)")
    # Host labels: the manifests' own `host` where stamped (v2);
    # pre-v2 hostless logs are labelled by MANIFEST-TIME rank — a
    # property of the logs, not of argument order, so the merged
    # stream stays byte-identical no matter how the shell glob ordered
    # the files.
    unlabelled = sorted(
        (i for i, m in enumerate(manifests) if "host" not in m),
        key=lambda i: (manifests[i]["t"], manifests[i].get("seq", 0)))
    rank = {idx: r for r, idx in enumerate(unlabelled)}
    hosts = [m.get("host", rank.get(i)) for i, m in enumerate(manifests)]
    # Reference clock: the lowest-numbered host.
    ref = min(range(len(manifests)), key=lambda i: (hosts[i],
                                                    manifests[i]["t"]))
    t0 = manifests[ref]["t"]
    merged: list[dict] = []
    for i, events in enumerate(per_host):
        offset = manifests[i]["t"] - t0
        host = hosts[i]
        for e in events:
            rec = dict(e)
            rec["t"] = rec["t"] - offset
            rec.setdefault("host", host)
            merged.append(rec)
    merged.sort(key=lambda e: (e["t"], e["host"], e["seq"]))
    return merged


def merge_paths(paths: list[str]) -> list[dict]:
    """read_events + merge_events over JSONL paths — the `report` /
    `trace` CLI entry (a single path passes through un-merged, so the
    one-log case costs nothing new)."""
    if len(paths) == 1:
        return read_events(paths[0])
    return merge_events([read_events(p) for p in paths])
