"""File-backed chunk sources and streamed binning in the port (data/chunks,
data/quantizer.fit_bin_mapper_streaming) on the CPU.

- tests/test_chunks.py's four non-CLI cases (the CLI ones come with the
  port's CLI): npz shard round trips, the writers' validation, the binned
  cache's stale-shard purge, shard_file; each port writer's files read
  back through the reference's directory_chunks, and the other way.
- fit_bin_mapper_streaming: edges bitwise equal to the reference's for the
  same chunks and seed (saturated and unsaturated reservoir, the learned
  missing bin, categorical columns), and to fit_bin_mapper when the
  sample holds every row.
- tests/test_mesh2d.py's host-sharded cases on gloo ranks: the ownership
  contract, host-sharded streamed training bitwise equal to directory
  streaming at the same logical chunks (and to the in-memory trees), each
  rank reading only its own sub-shards, and upload_row_shards equal to
  the whole chunk's upload on every rank.
"""

import numpy as np
import pytest

from ddt_tpu.data import chunks as j_chunks
from ddt_tpu.data.quantizer import \
    fit_bin_mapper_streaming as j_fit_streaming_mapper
from ddt_tpu_torch.backends import get_backend
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.data import chunks as chunks_mod
from ddt_tpu_torch.data import datasets
from ddt_tpu_torch.data.quantizer import (fit_bin_mapper,
                                          fit_bin_mapper_streaming, quantize)
from ddt_tpu_torch.driver import Driver
from ddt_tpu_torch.parallel import spawn, tasks
from ddt_tpu_torch.streaming import fit_streaming

FIELDS = ("feature", "threshold_bin", "is_leaf", "leaf_value", "split_gain",
          "default_left")


def test_shard_roundtrip(tmp_path):
    X, y = datasets.synthetic_binary(1003, n_features=7, seed=3)
    d = str(tmp_path / "shards")
    paths = chunks_mod.shard_arrays(X, y, d, n_chunks=4)
    assert len(paths) == 4
    for src in (chunks_mod.directory_chunks(d),
                j_chunks.directory_chunks(d)):
        assert src.n_chunks == 4 and src.n_features == 7
        assert not src.binned
        np.testing.assert_array_equal(
            X, np.concatenate([src(c)[0] for c in range(4)]))
        np.testing.assert_array_equal(
            y, np.concatenate([src(c)[1] for c in range(4)]))
        np.testing.assert_array_equal(src.labels(2), src(2)[1])
    # A reference writer's shards read in the port.
    d2 = str(tmp_path / "ref")
    j_chunks.shard_arrays(X, y, d2, chunk_rows=300)
    src = chunks_mod.directory_chunks(d2)
    assert src.n_chunks == 4
    np.testing.assert_array_equal(
        X, np.concatenate([src(c)[0] for c in range(4)]))


def test_shard_arrays_validates(tmp_path):
    X, y = datasets.synthetic_binary(10, n_features=5, seed=1)
    with pytest.raises(ValueError, match="exactly one"):
        chunks_mod.shard_arrays(X, y, str(tmp_path), n_chunks=2,
                                chunk_rows=5)
    with pytest.raises(ValueError, match="exceeds"):
        chunks_mod.shard_arrays(X, y, str(tmp_path), n_chunks=11)
    with pytest.raises(ValueError, match="no chunk_"):
        chunks_mod.directory_chunks(str(tmp_path / "empty"))


def test_binned_cache_clears_stale_shards(tmp_path):
    X, y = datasets.synthetic_binary(400, n_features=6, seed=7)
    mapper = fit_bin_mapper(X, n_bins=15)
    cache = str(tmp_path / "cache")

    def raw4(c):
        return X[c * 100:(c + 1) * 100], y[c * 100:(c + 1) * 100]

    src = chunks_mod.write_binned_cache(raw4, 4, mapper, cache)
    assert src.n_chunks == 4

    def raw2(c):
        return X[c * 200:(c + 1) * 200], y[c * 200:(c + 1) * 200]

    src = chunks_mod.write_binned_cache(raw2, 2, mapper, cache)
    assert src.n_chunks == 2
    assert sum(len(src.labels(c)) for c in range(2)) == 400
    np.testing.assert_array_equal(src(1)[0], mapper.transform(X[200:]))

    raw_dir = str(tmp_path / "raw")
    chunks_mod.shard_arrays(X, y, raw_dir, n_chunks=3)
    raw_src = chunks_mod.directory_chunks(raw_dir)
    src = chunks_mod.write_binned_cache(raw_src, 3, mapper, raw_dir)
    assert src.n_chunks == 3 and src.binned
    assert sum(len(src.labels(c)) for c in range(3)) == 400

    foreign = tmp_path / "raw" / "chunk_backup.npz"
    np.savez(foreign, junk=np.zeros(1))
    chunks_mod.shard_arrays(X, y, raw_dir, n_chunks=2)
    assert foreign.exists()
    assert not (tmp_path / "raw" / "chunk_00002.npz").exists()
    assert chunks_mod.directory_chunks(raw_dir).n_chunks == 2


def test_shard_file_chunk_rows(tmp_path):
    X, y = datasets.synthetic_binary(900, n_features=5, seed=4)
    src_npz = str(tmp_path / "data.npz")
    np.savez(src_npz, X=X, y=y)
    d = str(tmp_path / "shards")
    paths = chunks_mod.shard_file(src_npz, d, chunk_rows=400)
    assert len(paths) == 3
    src = chunks_mod.directory_chunks(d)
    assert sum(len(src.labels(c)) for c in range(3)) == 900
    # And the stress writer: one chunk in memory at a time, the
    # generator's rows.
    rows = chunks_mod.shard_stress_chunks(str(tmp_path / "stress"), 1000, 4,
                                          n_features=8, seed=2, n_bins=15)
    src = chunks_mod.directory_chunks(str(tmp_path / "stress"))
    assert rows == 250 and src.binned
    np.testing.assert_array_equal(
        src(3)[0], datasets.stress_binned_chunk(3, 250, n_features=8,
                                                seed=2, n_bins=15)[0])


@pytest.mark.parametrize("max_sample,policy,cat", [
    (500, "zero", ()), (100_000, "zero", ()), (700, "learn", ()),
    (500, "zero", (1,))])
def test_fit_bin_mapper_streaming_equals_reference(max_sample, policy, cat):
    rng = np.random.default_rng(5)
    X = rng.standard_normal((3000, 6)).astype(np.float32)
    X[rng.random(X.shape) < 0.05] = np.nan
    X[:, 1] = rng.integers(0, 9, 3000)

    def chunk_fn(c):
        return X[c * 600:(c + 1) * 600], None

    kw = dict(n_bins=31, max_sample=max_sample, seed=3,
              missing_policy=policy, cat_features=cat)
    got = fit_bin_mapper_streaming(chunk_fn, 5, **kw)
    want = j_fit_streaming_mapper(chunk_fn, 5, **kw)
    np.testing.assert_array_equal(got.edges, want.edges)
    assert (got.missing_bin, got.cat_features) == (want.missing_bin,
                                                   want.cat_features)
    if max_sample >= len(X):
        np.testing.assert_array_equal(
            got.edges, fit_bin_mapper(X, n_bins=31, seed=3,
                                      missing_policy=policy,
                                      cat_features=cat).edges)
    with pytest.raises(ValueError, match="no chunks"):
        fit_bin_mapper_streaming(chunk_fn, 0)


def _shard_dir(tmp_path, Xb, y, n_files):
    d = str(tmp_path / f"shards{n_files}")
    chunks_mod.shard_arrays(Xb, y, d, n_chunks=n_files)
    return d


def test_host_sharded_ownership_contract(tmp_path):
    X, y = datasets.synthetic_binary(1024, n_features=6, seed=1)
    Xb, _ = quantize(X, n_bins=15, seed=1)
    d = _shard_dir(tmp_path, Xb, y, 8)
    v0 = chunks_mod.HostShardedChunks(d, 4, process_index=0,
                                      process_count=2)
    v1 = chunks_mod.HostShardedChunks(d, 4, process_index=1,
                                      process_count=2)
    assert v0.n_chunks == 2
    assert v0.owned_slots(0) == [0, 1] and v1.owned_slots(0) == [2, 3]
    with pytest.raises(PermissionError, match="ownership"):
        v0.read_part(0, 2)
    with pytest.raises(PermissionError, match="ownership"):
        v1.read_part(1, 0)
    with pytest.raises(PermissionError, match="full-chunk"):
        v1(0)
    np.testing.assert_array_equal(
        np.concatenate([v0.labels(c) for c in range(2)]), y)
    v0.rotate_assignment()
    assert v0.assignment == (1, 1, 0, 0)
    assert v0.owned_slots(0) == [2, 3]
    with pytest.raises(ValueError, match="group"):
        chunks_mod.HostShardedChunks(d, 3, process_index=0,
                                     process_count=1)
    with pytest.raises(ValueError, match="multiple"):
        chunks_mod.HostShardedChunks(d, 4, process_index=0,
                                     process_count=3)
    # One process (no group): the view owns every slot.
    one = chunks_mod.host_sharded_chunks(d, 4)
    assert one.process_count == 1 and one.owned_slots(0) == [0, 1, 2, 3]


def test_host_sharded_streamed_bitwise_vs_plain(tmp_path):
    """Two gloo ranks, each reading only its own sub-shards, grow the
    directory source's streamed trees bitwise, which are the in-memory
    trees."""
    X, y = datasets.synthetic_binary(4096, n_features=10, seed=11)
    Xb, _ = quantize(X, n_bins=31, seed=11)
    kw = dict(n_trees=3, max_depth=4, n_bins=31)
    d8 = _shard_dir(tmp_path, Xb, y, 8)      # 2 logical x 4 sub-shards
    with spawn.Pool(2, backend="gloo", device="cpu",
                    timeout_s=120.0) as pool:
        outs = pool.run(tasks.train_streaming_dir, d8, 4, kw)
    d2 = _shard_dir(tmp_path, Xb, y, 2)      # the same logical bounds
    cfg = TrainConfig(device="cpu", **kw)
    e_dir = fit_streaming(chunks_mod.directory_chunks(d2), 2, cfg)
    e_mem = Driver(get_backend(cfg), cfg).fit(Xb, y)
    for r, o in enumerate(outs):
        assert o["owned"] == [2 * r, 2 * r + 1]
        assert {s for _, s in o["reads"]} == {2 * r, 2 * r + 1}
        for k in FIELDS:
            np.testing.assert_array_equal(getattr(e_dir, k),
                                          getattr(o["ensemble"], k))
            np.testing.assert_array_equal(getattr(e_mem, k),
                                          getattr(o["ensemble"], k))


def test_upload_row_shards_matches_upload():
    rng = np.random.default_rng(0)
    parts = [rng.integers(0, 15, size=(250, 6), dtype=np.uint8)
             for _ in range(4)]
    with spawn.Pool(2, backend="gloo", device="cpu",
                    timeout_s=120.0) as pool:
        outs = pool.run(tasks.upload_row_shards, parts, 1000,
                        dict(n_bins=15))
    for r, (a, b) in enumerate(outs):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            a, np.concatenate(parts)[r * 500:(r + 1) * 500])
    # One process: the parts are the whole chunk.
    be = get_backend(TrainConfig(device="cpu", n_bins=15))
    np.testing.assert_array_equal(
        be.upload_row_shards(parts, 1000).numpy(), np.concatenate(parts))
