"""The device a run measures: its name, count, power limit and peak
memory, and the peaks of its data sheet."""

from __future__ import annotations

import json
import subprocess
from pathlib import Path

import torch


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi prints them, or why
    it could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=False)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"not read: {out.stderr.strip()[:200]}"


def memory_peak(device) -> int:
    if torch.device(device).type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def describe(device, count: int, peak_bytes: int) -> dict:
    if torch.device(device).type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": count, "memory_peak_bytes": peak_bytes}
    return {"platform": "cpu", "kind": "cpu", "count": count,
            "memory_peak_bytes": peak_bytes}


def load_peaks(bench_dir: Path, kind: str) -> dict | None:
    """The peaks file whose "match" is part of the device's name."""
    for p in sorted((bench_dir / "peaks").glob("*.json")):
        d = json.loads(p.read_text())
        if d["match"] in kind:
            return d
    return None
