"""Kernel build and loader: `csrc/*.cu` -> one shared library per source.

Each source is compiled at first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

and loaded with ctypes. The sources have a plain C interface (no PyTorch
headers), so a build takes seconds; every source is started at once, one
nvcc process each. The library's file name carries a hash of the source
and the flags, so an edited source is rebuilt and a stale library is never
loaded. Builds write to a temporary name and are renamed into place.

Binding rules, kept by the wrapper modules (ops/hist_cuda.py,
ops/predict_cuda.py): every pointer and the stream are `c_void_p`; each C
entry returns `cudaGetLastError()` and the wrapper raises on a non-zero
value; outputs and scratch are allocated by the wrapper with torch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_smem_optin: dict[int, int] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's kernels are built "
            "from ddt_tpu_torch/csrc at first use")
    return found


def sources() -> list[str]:
    """Library names: one per csrc/<name>.cu."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names: list[str] | None = None) -> dict[str, float]:
    """Build every missing library, all nvcc processes at once. Returns
    {name: seconds} for the libraries built by this call (empty when all
    were current). Raises with nvcc's output if any build fails."""
    names = sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp, out)
    took = {}
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"{name}.cu: nvcc exit {proc.returncode}\n"
                          f"{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return took


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            _libs[name] = lib
        return lib


def smem_limit(device) -> int:
    """The card's opt-in dynamic shared memory per block, in bytes
    (csrc/device.cu), for a torch.device of type cuda."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _smem_optin:
        lib = library("device")
        lib.ddt_smem_optin.argtypes = [ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_int)]
        lib.ddt_smem_optin.restype = ctypes.c_int
        out = ctypes.c_int(0)
        check(lib.ddt_smem_optin(idx, ctypes.byref(out)),
              "cudaDeviceGetAttribute(MaxSharedMemoryPerBlockOptin)")
        _smem_optin[idx] = int(out.value)
    return _smem_optin[idx]


def check(status: int, what: str) -> None:
    """Raise when a C entry returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")
