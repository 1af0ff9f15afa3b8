"""File-backed chunk sources for the streaming trainer (port of
ddt_tpu/data/chunks.py; numpy, the same files and naming).

The 10B-row config (BASELINE config 5) cannot hold a dataset in host
memory; streaming.fit_streaming already trains from any pure
``chunk_fn(c) -> (X_chunk, y_chunk)``. This module provides the on-disk
realization: a directory of npz shards, a writer that cuts one, and a
binned-cache writer so every re-read of a chunk streams uint8 straight
from disk instead of re-binning floats (fit_streaming re-reads every
chunk (max_depth+1) times per tree).

Shard layout: ``<dir>/chunk_00000.npz`` ... each holding arrays ``X``
([rows, F] — float32 raw features, or uint8 when pre-binned) and ``y``
([rows] labels). Shards stream in filename order; sizes may differ (each
distinct size jit-compiles its own device program — the writers cut
near-equal sizes so at most two programs compile).

O(chunk) guarantee: nothing here holds more than one shard in memory at
a time; the label-only accessor decompresses just the ``y`` member (npz
members are read lazily), so fit_streaming's pass 0 never touches X.
"""

from __future__ import annotations

import glob
import os
import re

import numpy as np

from ddt_tpu_torch.utils.atomic import atomic_savez

CHUNK_PREFIX = "chunk_"
_CHUNK_RE = re.compile(re.escape(CHUNK_PREFIX) + r"(\d+)\.npz$")


def _chunk_path(out_dir: str, c: int) -> str:
    return os.path.join(out_dir, f"{CHUNK_PREFIX}{c:05d}.npz")


def _atomic_savez(path: str, **arrays) -> None:
    """Shard writes are tmp-then-os.replace (utils/atomic.py): a writer
    killed mid-shard leaves no torn chunk_*.npz for a later training run
    to choke on — the reader's canonical-name regex (_CHUNK_RE,
    $-anchored) never matches the .tmp.npz name, so a partial write is
    invisible to chunk_files."""
    atomic_savez(path, **arrays)


def _purge_stale(out_dir: str, n_chunks: int) -> None:
    """Drop shards with index >= n_chunks that a prior (larger) run left
    behind — otherwise directory_chunks would report the stale count and
    serve the old run's data. Called AFTER writing so re-sharding in
    place never deletes data before reading it; non-canonical filenames
    that merely match the glob (chunk_backup.npz) are left alone."""
    for path in glob.glob(os.path.join(out_dir, CHUNK_PREFIX + "*.npz")):
        m = _CHUNK_RE.search(os.path.basename(path))
        if m and int(m.group(1)) >= n_chunks:
            os.remove(path)


def chunk_files(src_dir: str) -> list[str]:
    files = sorted(
        f for f in glob.glob(os.path.join(src_dir, CHUNK_PREFIX + "*.npz"))
        if _CHUNK_RE.search(os.path.basename(f))
    )
    if not files:
        raise ValueError(
            f"no {CHUNK_PREFIX}*.npz shards in {src_dir!r} — write them "
            "with data.chunks.shard_arrays / shard_file"
        )
    return files


def shard_arrays(
    X: np.ndarray,
    y: np.ndarray,
    out_dir: str,
    n_chunks: int | None = None,
    chunk_rows: int | None = None,
) -> list[str]:
    """Writer utility: cut an in-memory (X, y) into npz shards (linspace
    bounds — every row covered, sizes differ by at most one). Exactly one
    of n_chunks / chunk_rows. Returns the written paths."""
    if (n_chunks is None) == (chunk_rows is None):
        raise ValueError("pass exactly one of n_chunks / chunk_rows")
    rows = len(y)
    if rows == 0:
        raise ValueError("cannot shard an empty dataset")
    if n_chunks is None:
        n_chunks = max(1, -(-rows // chunk_rows))
    if n_chunks > rows:
        raise ValueError(
            f"n_chunks={n_chunks} exceeds the row count ({rows}); empty "
            "chunks are not allowed"
        )
    os.makedirs(out_dir, exist_ok=True)
    bounds = np.linspace(0, rows, n_chunks + 1).astype(np.int64)
    paths = []
    for c in range(n_chunks):
        p = _chunk_path(out_dir, c)
        _atomic_savez(p, X=X[bounds[c]:bounds[c + 1]],
                      y=y[bounds[c]:bounds[c + 1]])
        paths.append(p)
    _purge_stale(out_dir, n_chunks)
    return paths


def shard_file(
    src: str,
    out_dir: str,
    chunk_rows: int,
    label_col: str = "auto",
    normalize_labels: bool | None = None,
) -> list[str]:
    """Shard a dataset file (.npz/.csv[.gz]/libsvm — data.datasets.load_file
    formats) into npz chunk shards. The source file is materialised once
    to split it (these formats aren't seekable by row); from then on
    training streams the shards in O(chunk_rows) memory — run this once on
    a big-memory box, train anywhere."""
    from ddt_tpu_torch.data.datasets import load_file

    X, y = load_file(src, label_col=label_col,
                     normalize_labels=normalize_labels)
    return shard_arrays(X, y, out_dir, chunk_rows=chunk_rows)


def shard_stress_chunks(
    out_dir: str,
    rows: int,
    n_chunks: int,
    n_features: int = 64,
    seed: int = 7,
    n_bins: int = 63,
) -> int:
    """Cut `rows` of the deterministic stress generator
    (data.datasets.stress_binned_chunk) into npz shards, ONE chunk in
    memory at a time (the writer itself is O(chunk) — the scale
    harnesses assert that). The single home of the stress-shard naming
    contract the scale experiments and RSS tests share; returns the
    per-chunk row count."""
    from ddt_tpu_torch.data.datasets import stress_binned_chunk

    os.makedirs(out_dir, exist_ok=True)
    chunk_rows = rows // n_chunks
    for c in range(n_chunks):
        Xc, yc = stress_binned_chunk(
            c, chunk_rows, n_features=n_features, seed=seed,
            n_bins=n_bins)
        _atomic_savez(_chunk_path(out_dir, c), X=Xc, y=yc)
        del Xc, yc
    _purge_stale(out_dir, n_chunks)
    return chunk_rows


def directory_chunks(src_dir: str):
    """ChunkFn over a shard directory. Exposes the side-channel accessors
    fit_streaming/binned_chunks use: ``.labels(c)`` (reads only the y
    member), ``.n_features``, ``.n_chunks``, ``.binned`` (True when the
    shards hold uint8 pre-binned data)."""
    files = chunk_files(src_dir)

    def f(c: int):
        with np.load(files[c]) as d:
            return d["X"], d["y"]

    def labels(c: int):
        with np.load(files[c]) as d:
            return d["y"]

    with np.load(files[0]) as d0:
        X0 = d0["X"]
        f.n_features = int(X0.shape[1])
        f.binned = X0.dtype == np.uint8

    f.labels = labels
    f.n_chunks = len(files)
    return f


class HostShardedChunks:
    """Per-host-addressable chunk source (the reference's host-sharded
    ingest).

    Every group of `shards_per_chunk` consecutive ``chunk_*.npz`` files
    forms one LOGICAL training chunk: logical chunk ``c`` is the row
    concatenation of sub-shards ``c*spc .. (c+1)*spc - 1`` in file
    order. A view for process ``p`` (a rank of the row group: one
    process a rank) reads the feature matrix of ONLY the sub-shards the
    chunk-shard→process ``assignment`` maps to ``p``, and fit_streaming
    assembles the rank's block of the chunk from them
    (CUDADevice.upload_row_shards), so ingest bandwidth scales with the
    rank count instead of bottlenecking one reader.

    Labels deliberately stay a GLOBAL side channel (``labels(c)`` reads
    every sub-shard's ``y`` member): the base score, chunk lengths, and
    validity masks are global metadata, and at 4 bytes/row labels are
    noise next to the F bytes/row feature matrix the ownership contract
    protects. npz members load lazily, so the label read never touches
    an unowned shard's ``X``.

    The ownership CONTRACT: with ``process_count > 1`` a full-chunk
    call (``source(c)``) raises — nothing on the host-sharded path may
    materialize another process's feature rows. Single-process views
    own every slot, so the callable form keeps working (the in-memory
    comparators ride it).

    ``rotate_assignment()`` rotates the slot→process map by one process
    (the reference's straggler response, whose watchdog the port does
    not have yet); the GLOBAL row order never changes."""

    host_sharded = True

    def __init__(self, src_dir: str, shards_per_chunk: int,
                 process_index: int | None = None,
                 process_count: int | None = None,
                 assignment: "tuple | None" = None):
        if process_index is None or process_count is None:
            # This process's rank of the initialised torch.distributed
            # group (one process a rank), else the only process.
            import torch.distributed as dist

            live = dist.is_available() and dist.is_initialized()
            process_index = dist.get_rank() if live else 0
            process_count = dist.get_world_size() if live else 1
        files = chunk_files(src_dir)
        if shards_per_chunk < 1:
            raise ValueError(
                f"shards_per_chunk must be >= 1, got {shards_per_chunk}")
        if len(files) % shards_per_chunk:
            raise ValueError(
                f"{len(files)} shard files do not group into logical "
                f"chunks of {shards_per_chunk} sub-shards; re-cut the "
                "shards (data.chunks.shard_arrays with a multiple)")
        if shards_per_chunk % process_count:
            raise ValueError(
                f"shards_per_chunk={shards_per_chunk} must be a multiple "
                f"of process_count={process_count} so every host owns an "
                "equal contiguous block")
        self._files = files
        self.n_shards_per_chunk = shards_per_chunk
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.n_chunks = len(files) // shards_per_chunk
        if assignment is None:
            # Contiguous blocks: slot s -> host s*P//spc, so each host's
            # sub-shards are adjacent rows (matching the hosts-outermost
            # mesh's contiguous addressable row range).
            assignment = tuple(
                s * process_count // shards_per_chunk
                for s in range(shards_per_chunk))
        self.assignment = tuple(int(a) for a in assignment)
        if sorted(set(self.assignment)) != list(range(process_count)):
            raise ValueError(
                f"assignment {self.assignment} must cover every process "
                f"in [0, {process_count})")
        with np.load(files[0]) as d0:
            X0 = d0["X"]
            self.n_features = int(X0.shape[1])
            self.binned = X0.dtype == np.uint8
        self._lens: dict = {}

    # -- ownership ----------------------------------------------------- #

    def owned_slots(self, c: int) -> list[int]:
        """Sub-shard slots of logical chunk `c` this process reads (the
        assignment is chunk-independent: skew is a host property)."""
        return [s for s in range(self.n_shards_per_chunk)
                if self.assignment[s] == self.process_index]

    def rotate_assignment(self) -> None:
        """Rotate the slot→process map by one process; the global row
        order is untouched."""
        P = self.process_count
        self.assignment = tuple((a + 1) % P for a in self.assignment)

    # -- reads --------------------------------------------------------- #

    def _file(self, c: int, s: int) -> str:
        return self._files[c * self.n_shards_per_chunk + s]

    def read_part(self, c: int, s: int) -> np.ndarray:
        """Feature matrix of sub-shard `s` of logical chunk `c` — the
        ONLY sanctioned X read on a multi-process view, and only for
        owned slots."""
        if self.process_count > 1 and self.assignment[s] != \
                self.process_index:
            raise PermissionError(
                f"process {self.process_index} asked for sub-shard "
                f"(chunk {c}, slot {s}) owned by process "
                f"{self.assignment[s]} — the host-sharded ownership "
                "contract forbids cross-host chunk reads")
        with np.load(self._file(c, s)) as d:
            return d["X"]

    def part_rows(self, c: int) -> list[int]:
        """Per-slot row counts of logical chunk `c` (y-member reads
        only — cached)."""
        lens = self._lens.get(c)
        if lens is None:
            lens = []
            for s in range(self.n_shards_per_chunk):
                with np.load(self._file(c, s)) as d:
                    lens.append(int(d["y"].shape[0]))
            self._lens[c] = lens
        return lens

    def chunk_rows(self, c: int) -> int:
        return sum(self.part_rows(c))

    def labels(self, c: int) -> np.ndarray:
        """Logical chunk c's GLOBAL labels (y members only, every slot)."""
        ys = []
        for s in range(self.n_shards_per_chunk):
            with np.load(self._file(c, s)) as d:
                ys.append(d["y"])
        return np.concatenate(ys)

    def __call__(self, c: int):
        """Full logical chunk — single-process only (comparators, the
        host loop); a multi-process call is an ownership violation."""
        if self.process_count > 1:
            raise PermissionError(
                "full-chunk reads are forbidden on a multi-process "
                "host-sharded source (ownership contract); use "
                "read_part(c, slot) for owned slots")
        X = np.concatenate([self.read_part(c, s)
                            for s in range(self.n_shards_per_chunk)])
        return X, self.labels(c)


def host_sharded_chunks(src_dir: str, shards_per_chunk: int,
                        process_index: int | None = None,
                        process_count: int | None = None) -> \
        HostShardedChunks:
    """This process's view of a host-sharded shard directory (see
    HostShardedChunks). The fit_streaming-facing constructor."""
    return HostShardedChunks(src_dir, shards_per_chunk,
                             process_index=process_index,
                             process_count=process_count)


def write_binned_cache(
    raw_chunk_fn,
    n_chunks: int,
    mapper,
    cache_dir: str,
):
    """Transform each raw chunk ONCE through a fitted BinMapper and persist
    the uint8 result; returns a directory_chunks source over the cache.
    This is the optional binned-chunk cache: fit_streaming re-reads every
    chunk (max_depth+1) times per tree, and uint8-from-disk beats
    re-binning floats on every pass (and is 4x smaller on disk than the
    float32 it replaces). O(chunk) memory throughout."""
    os.makedirs(cache_dir, exist_ok=True)
    for c in range(n_chunks):
        X, y = raw_chunk_fn(c)
        _atomic_savez(_chunk_path(cache_dir, c),
                      X=mapper.transform(np.asarray(X, np.float32)), y=y)
    _purge_stale(cache_dir, n_chunks)
    return directory_chunks(cache_dir)
