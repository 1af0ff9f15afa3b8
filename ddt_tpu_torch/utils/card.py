"""The card's own numbers, as nvidia-smi gives them.

A time taken on a card is only comparable beside the card's name and
power limit: an H100 set below its 700 W runs slower under load. Records
taken on a card carry `stamp(device)`, {"name": ..., "power_limit_w":
...}, read from

    nvidia-smi --query-gpu=name,power.limit --format=csv,noheader

and records taken on the CPU carry "cpu".
"""

from __future__ import annotations

import subprocess

import torch

QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"]


def smi_lines() -> list[str]:
    """nvidia-smi's `name, power.limit` line of every card (raises when
    nvidia-smi fails)."""
    out = subprocess.run(QUERY, capture_output=True, text=True, check=True,
                         timeout=60).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def parse_line(line: str) -> dict:
    """"NVIDIA H100 80GB HBM3, 700.00 W" -> {"name": "NVIDIA H100 80GB
    HBM3", "power_limit_w": 700.0} (None where nvidia-smi prints no
    number)."""
    name, _, limit = line.rpartition(",")
    try:
        watts = float(limit.split()[0])
    except (IndexError, ValueError):
        watts = None
    return {"name": name.strip(), "power_limit_w": watts}


def smi_line(index: int = 0) -> str:
    """nvidia-smi's line of torch's card `index`: the line at that index
    when its name is torch's, else the first line with torch's name."""
    want = torch.cuda.get_device_name(index)
    lines = smi_lines()
    if index < len(lines) and parse_line(lines[index])["name"] == want:
        return lines[index]
    for ln in lines:
        if parse_line(ln)["name"] == want:
            return ln
    raise RuntimeError(f"nvidia-smi lists no card named {want!r}: {lines}")


def stamp(device) -> "dict | str":
    """The record stamp of `device`: the card's name and power limit, or
    "cpu"."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    return parse_line(smi_line(index))
