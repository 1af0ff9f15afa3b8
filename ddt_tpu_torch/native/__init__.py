"""ctypes bindings for the port's native CPU reference kernels (port of
ddt_tpu/native/__init__.py; the C++ sources beside this file are the
port's own copies of the reference's).

The library is built at first use with

    g++ -O3 -march=native -funroll-loops -fPIC -fopenmp -std=c++17 \\
        histogram.cpp split_gain.cpp csv_loader.cpp -shared -fopenmp \\
        -o _build/libddtnative-<hash>.so

(the reference Makefile's flags) into the package's gitignored `_build/`.
The file name carries a hash of the sources and the flags, so an edited
source is rebuilt and a stale library is never loaded. An exclusive file
lock serialises concurrent builders (the test suite runs several worker
processes); the build writes a temporary name and renames it into place.
The versioned symbols are checked after loading (`ddt_traverse_v3`: a
library with another traversal ABI fails here instead of being called
with mismatched arguments).

`available()` says whether the library loads; `load()` raises ImportError
with the build's error when it does not (backends/cpu.CPUDevice with
use_native=True surfaces it, so a baseline is never quietly a NumPy
number).

Exports (the reference's, same contracts):
    histogram_native(Xb, g, h, node_index, n_nodes, n_bins) -> np.ndarray
    traverse_native(Xb, feature, thr_bin, is_leaf, max_depth, ...) -> [T, R]
    split_gain_native(hist, reg_lambda, min_child_weight)
        -> (gain, feature, bin)
    split_gain_full_native(hist, reg_lambda, min_child_weight,
                           feature_mask, missing_bin, cat_mask)
        -> (gain, feature, bin, default_left)
    csv_parse_native(data, skip_rows=0, max_rows=None) -> float64 [rows, cols]
    omp_max_threads(), omp_set_threads(n), omp_threads(n) (a context)
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR.parent / "_build"
SOURCES = ("histogram.cpp", "split_gain.cpp", "csv_loader.cpp")
CXXFLAGS = ["-O3", "-march=native", "-funroll-loops", "-fPIC", "-fopenmp",
            "-std=c++17"]
LDFLAGS = ["-shared", "-fopenmp"]
_SYMBOLS = ("ddt_build_histograms", "ddt_traverse_v3", "ddt_split_gain",
            "ddt_split_gain_full", "ddt_csv_parse", "ddt_omp_max_threads",
            "ddt_omp_set_threads")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_error: Exception | None = None


def source_hash() -> str:
    """16 hex digits of sha256(sources + flags): the library's build key."""
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((SRC_DIR / name).read_bytes())
    h.update(" ".join(CXXFLAGS + LDFLAGS).encode())
    return h.hexdigest()[:16]


def lib_path() -> Path:
    return BUILD_DIR / f"libddtnative-{source_hash()}.so"


def build() -> Path:
    """Compile the library unless it is there (under the file lock)."""
    import fcntl

    path = lib_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".native.lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if path.exists():            # built while this process waited
            return path
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            ["g++", *CXXFLAGS, *[str(SRC_DIR / s) for s in SOURCES],
             *LDFLAGS, "-o", str(tmp)],
            capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed ({proc.returncode}): "
                               f"{proc.stderr[-2000:]}")
        os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The loaded library (built at first use); ImportError when it
    cannot be built or lacks a symbol."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise ImportError(f"native kernels unavailable: {_error}")
        try:
            lib = ctypes.CDLL(str(build()))
            missing = [s for s in _SYMBOLS if not hasattr(lib, s)]
            if missing:
                raise RuntimeError(f"{lib_path().name} lacks {missing}")
            _bind(lib)
        except Exception as e:  # no toolchain, a failed build, a bad ABI
            _error = e
            raise ImportError(f"native kernels unavailable: {e}") from e
        _lib = lib
        return lib


def available() -> bool:
    """Whether the native library loads (building it if need be)."""
    try:
        load()
        return True
    except ImportError:
        return False


def _bind(lib: ctypes.CDLL) -> None:
    u8, f32, i32 = (ctypes.POINTER(ctypes.c_uint8),
                    ctypes.POINTER(ctypes.c_float),
                    ctypes.POINTER(ctypes.c_int32))
    lib.ddt_build_histograms.argtypes = [
        u8, f32, f32, i32, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, f32]
    lib.ddt_build_histograms.restype = None
    lib.ddt_traverse_v3.argtypes = [
        u8, i32, i32, u8, u8, u8, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, i32]
    lib.ddt_traverse_v3.restype = None
    lib.ddt_split_gain_full.argtypes = [
        f32, ctypes.c_int32, ctypes.c_int64, ctypes.c_int32, ctypes.c_float,
        ctypes.c_float, u8, ctypes.c_int32, u8, f32, i32, i32, u8]
    lib.ddt_split_gain_full.restype = None
    lib.ddt_split_gain.argtypes = [
        f32, ctypes.c_int32, ctypes.c_int64, ctypes.c_int32, ctypes.c_float,
        ctypes.c_float, f32, i32, i32]
    lib.ddt_split_gain.restype = None
    lib.ddt_csv_parse.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p, ctypes.c_int64]
    lib.ddt_csv_parse.restype = ctypes.c_int64
    lib.ddt_omp_max_threads.argtypes = []
    lib.ddt_omp_max_threads.restype = ctypes.c_int32
    lib.ddt_omp_set_threads.argtypes = [ctypes.c_int32]
    lib.ddt_omp_set_threads.restype = None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def omp_max_threads() -> int:
    """OpenMP max team size the kernels will use (1 = serial path)."""
    return int(load().ddt_omp_max_threads())


def omp_set_threads(n: int) -> None:
    """Pin the kernels' OpenMP team size. The multi-thread histogram
    reduction is deterministic per team size, but its summation order
    differs from the serial row order (f32 reassociation, ~1e-6);
    bit-exactness contracts pin 1."""
    load().ddt_omp_set_threads(int(n))


class omp_threads:
    """Context manager pinning the kernels' OpenMP team size (default 1,
    the serial bit-exact path); the previous size comes back on exit."""

    def __init__(self, n: int = 1):
        self._n = n

    def __enter__(self):
        self._prev = omp_max_threads()
        omp_set_threads(self._n)
        return self

    def __exit__(self, *exc):
        omp_set_threads(self._prev)
        return False


def histogram_native(Xb: np.ndarray, g: np.ndarray, h: np.ndarray,
                     node_index: np.ndarray, n_nodes: int,
                     n_bins: int) -> np.ndarray:
    """C++ HistogramBuilder: f32 [n_nodes, F, n_bins, 2]; the contract of
    reference/numpy_trainer.build_histograms."""
    lib = load()
    R, F = Xb.shape
    Xb = np.ascontiguousarray(Xb, np.uint8)
    g = np.ascontiguousarray(g, np.float32)
    h = np.ascontiguousarray(h, np.float32)
    node_index = np.ascontiguousarray(node_index, np.int32)
    out = np.zeros((n_nodes, F, n_bins, 2), np.float32)
    lib.ddt_build_histograms(
        _ptr(Xb, ctypes.c_uint8), _ptr(g, ctypes.c_float),
        _ptr(h, ctypes.c_float), _ptr(node_index, ctypes.c_int32),
        R, F, n_nodes, n_bins, _ptr(out, ctypes.c_float))
    return out


def split_gain_native(hist: np.ndarray, reg_lambda: float,
                      min_child_weight: float):
    """C++ SplitGain: (gain, feature, bin), bitwise
    reference/numpy_trainer.best_splits (same f32 cumsum order and
    bf16-rounded first-index tie-break)."""
    lib = load()
    n_nodes, F, B, _ = hist.shape
    hist = np.ascontiguousarray(hist, np.float32)
    gain = np.empty(n_nodes, np.float32)
    feat = np.empty(n_nodes, np.int32)
    bin_ = np.empty(n_nodes, np.int32)
    lib.ddt_split_gain(
        _ptr(hist, ctypes.c_float), n_nodes, F, B, reg_lambda,
        min_child_weight, _ptr(gain, ctypes.c_float),
        _ptr(feat, ctypes.c_int32), _ptr(bin_, ctypes.c_int32))
    return gain, feat, bin_


def split_gain_full_native(hist: np.ndarray, reg_lambda: float,
                           min_child_weight: float,
                           feature_mask: np.ndarray | None = None,
                           missing_bin: bool = False,
                           cat_mask: np.ndarray | None = None):
    """C++ SplitGain, full oracle contract (colsample masks, the NaN bin's
    direction, categorical one-vs-rest): (gain, feature, bin,
    default_left), bitwise reference/numpy_trainer.best_splits."""
    lib = load()
    n_nodes, F, B, _ = hist.shape
    hist = np.ascontiguousarray(hist, np.float32)
    gain = np.empty(n_nodes, np.float32)
    feat = np.empty(n_nodes, np.int32)
    bin_ = np.empty(n_nodes, np.int32)
    dl = np.empty(n_nodes, np.uint8)
    null_u8 = ctypes.POINTER(ctypes.c_uint8)()
    fm = (np.ascontiguousarray(feature_mask, np.uint8)
          if feature_mask is not None else None)
    cm = (np.ascontiguousarray(cat_mask, np.uint8)
          if cat_mask is not None else None)
    lib.ddt_split_gain_full(
        _ptr(hist, ctypes.c_float), n_nodes, F, B, reg_lambda,
        min_child_weight,
        _ptr(fm, ctypes.c_uint8) if fm is not None else null_u8,
        1 if missing_bin else 0,
        _ptr(cm, ctypes.c_uint8) if cm is not None else null_u8,
        _ptr(gain, ctypes.c_float), _ptr(feat, ctypes.c_int32),
        _ptr(bin_, ctypes.c_int32), _ptr(dl, ctypes.c_uint8))
    return gain, feat, bin_, dl.astype(bool)


def traverse_native(Xb: np.ndarray, feature: np.ndarray, thr_bin: np.ndarray,
                    is_leaf: np.ndarray, max_depth: int,
                    default_left: np.ndarray | None = None,
                    missing_bin_value: int = -1,
                    cat_node: np.ndarray | None = None) -> np.ndarray:
    """C++ batch traversal: the leaf heap slot of each (tree, row), int32
    [T, R]. `missing_bin_value` >= 0 routes rows in that bin by
    default_left[t, n]; `cat_node[t, n]` marks one-vs-rest nodes ("bin ==
    thr goes left")."""
    lib = load()
    R, F = Xb.shape
    T, N = feature.shape
    Xb = np.ascontiguousarray(Xb, np.uint8)
    feature = np.ascontiguousarray(feature, np.int32)
    thr_bin = np.ascontiguousarray(thr_bin, np.int32)
    leaf8 = np.ascontiguousarray(is_leaf, np.uint8)
    if missing_bin_value >= 0 and default_left is None:
        raise ValueError("missing_bin_value needs default_left")
    null_u8 = ctypes.POINTER(ctypes.c_uint8)()
    dl_ptr = cat_ptr = null_u8
    if default_left is not None:
        dl8 = np.ascontiguousarray(default_left, np.uint8)
        dl_ptr = _ptr(dl8, ctypes.c_uint8)
    if cat_node is not None:
        cat8 = np.ascontiguousarray(cat_node, np.uint8)
        cat_ptr = _ptr(cat8, ctypes.c_uint8)
    out = np.empty((T, R), np.int32)
    lib.ddt_traverse_v3(
        _ptr(Xb, ctypes.c_uint8), _ptr(feature, ctypes.c_int32),
        _ptr(thr_bin, ctypes.c_int32), _ptr(leaf8, ctypes.c_uint8),
        dl_ptr, cat_ptr, R, F, T, N, max_depth, missing_bin_value,
        _ptr(out, ctypes.c_int32))
    return out


def csv_parse_native(data: bytes, skip_rows: int = 0,
                     max_rows: int | None = None) -> np.ndarray:
    """Parse an in-memory CSV byte buffer into a float64 [rows, cols]
    matrix (the np.loadtxt(delimiter=",") subset the data layer uses:
    '#' comments and blank lines skipped, strict column counts); rows
    parse under an OpenMP parallel-for."""
    lib = load()
    cap = data.count(b"\n") + 1
    n_cols = 0
    pos = 0
    skipped = 0
    while skipped < skip_rows and pos < len(data):
        nl = data.find(b"\n", pos)
        pos = len(data) if nl < 0 else nl + 1
        skipped += 1
    while pos < len(data):
        nl = data.find(b"\n", pos)
        end = len(data) if nl < 0 else nl
        payload = data[pos:end].split(b"#", 1)[0].strip()
        if payload:
            n_cols = payload.count(b",") + 1
            break
        pos = end + 1
    if n_cols == 0:
        return np.empty((0, 0), np.float64)
    out = np.empty((cap, n_cols), np.float64)
    ncols_io = np.array([n_cols], np.int64)
    err = ctypes.create_string_buffer(256)
    rows = lib.ddt_csv_parse(
        data, len(data), skip_rows, -1 if max_rows is None else max_rows,
        _ptr(out, ctypes.c_double), cap,
        ncols_io.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), err,
        len(err))
    if rows < 0:
        raise ValueError(f"csv parse: {err.value.decode()}")
    return out[:rows]
