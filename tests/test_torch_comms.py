"""The port's collectives (ddt_tpu_torch/parallel/comms.py) on gloo ranks
on the CPU, mirroring tests/test_comms.py.

One pool of ranks per world size (2 and 4), spawned once through
parallel/spawn.py and reused by every case; the ranks run
parallel/tasks.py. Held:

- hist_reduce: the all-reduce equals the sum of the partials; the
  reduce-scatter hands rank i the sum's contiguous block i of the feature
  dim padded to the world size (F = 9 over 4 ranks included); integer
  partials merge exactly; int32_fixed is bitwise the same whichever rank
  holds which partial, and int32_fixed and bf16 stay within
  comms_error_bound of the exact sum;
- comms_error_bound equals the reference's over a grid; integer partials
  with a compressed wire raise;
- combine_shard_winners equals the numpy single-device flattened argmax
  (the rule ddt_tpu/parallel/comms.py documents) over slab winners with
  ties across ranks, a missing-bin direction block and an all -inf slab;
- the resolve_split_comms table, the TrainConfig validation of the new
  fields, and the refusal of a CUDA tensor on a gloo group.
"""

import numpy as np
import pytest

from ddt_tpu.parallel import comms as jcomms
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.parallel import comms, spawn, tasks

WORLDS = (2, 4)


@pytest.fixture(scope="module")
def pools():
    made = {}

    def get(world):
        if world not in made:
            made[world] = spawn.Pool(world, backend="gloo", device="cpu",
                                     timeout_s=120.0)
        return made[world]

    yield get
    for p in made.values():
        p.close()


def _partials(P, shape, seed, integer=False):
    rng = np.random.default_rng(seed)
    if integer:
        return [rng.integers(-1000, 1000, shape).astype(np.int32)
                for _ in range(P)]
    return [(rng.standard_normal(shape) * 10).astype(np.float32)
            for _ in range(P)]


@pytest.mark.parametrize("P", WORLDS)
def test_allreduce_equals_the_sum(pools, P):
    parts = _partials(P, (3, 5, 16, 2), seed=P)
    want = np.sum(np.stack(parts), axis=0, dtype=np.float64)
    outs = pools(P).run(tasks.hist_reduce, parts, list(range(P)),
                        "allreduce", "f32")
    for got in outs:
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
        np.testing.assert_array_equal(got, outs[0])


@pytest.mark.parametrize("P,F", [(2, 10), (4, 9), (4, 3)])
def test_reduce_scatter_hands_each_rank_its_padded_block(pools, P, F):
    parts = _partials(P, (2, F, 8, 2), seed=F)
    want = np.sum(np.stack(parts), axis=0, dtype=np.float64)
    b = -(-F // P)
    padded = np.zeros((2, P * b, 8, 2))
    padded[:, :F] = want
    outs = pools(P).run(tasks.hist_reduce, parts, list(range(P)),
                        "reduce_scatter", "f32")
    for r, got in enumerate(outs):
        assert got.shape == (2, b, 8, 2)
        np.testing.assert_allclose(got, padded[:, r * b:(r + 1) * b],
                                   rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("mode", ["allreduce", "reduce_scatter"])
def test_integer_partials_merge_exactly(pools, P, mode):
    parts = _partials(P, (2, 8, 4, 2), seed=7, integer=True)
    want = np.sum(np.stack(parts), axis=0)
    outs = pools(P).run(tasks.hist_reduce, parts, list(range(P)), mode,
                        "f32")
    got = np.concatenate(outs, axis=1) if mode == "reduce_scatter" \
        else outs[0]
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("P", WORLDS)
def test_int32_fixed_is_rank_order_independent_and_bounded(pools, P):
    parts = _partials(P, (4, 6, 16, 2), seed=11)
    exact = np.sum(np.stack(parts), axis=0, dtype=np.float64)
    max_abs = max(float(np.abs(p).max()) for p in parts)
    runs = [pools(P).run(tasks.hist_reduce, parts, perm, "allreduce",
                         "int32_fixed")
            for perm in (list(range(P)), list(range(P))[::-1])]
    for got in runs[0] + runs[1]:
        np.testing.assert_array_equal(got, runs[0][0])
    err = np.abs(runs[0][0] - exact).max()
    assert err <= comms.comms_error_bound("int32_fixed", P, max_abs)
    assert err > 0                  # it did go through the grid


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("mode", ["allreduce", "reduce_scatter"])
def test_bf16_wire_within_the_bound(pools, P, mode):
    parts = _partials(P, (2, 8, 16, 2), seed=13)
    exact = np.sum(np.stack(parts), axis=0, dtype=np.float64)
    max_abs = max(float(np.abs(p).max()) for p in parts)
    outs = pools(P).run(tasks.hist_reduce, parts, list(range(P)), mode,
                        "bf16")
    got = np.concatenate(outs, axis=1)[:, :8] \
        if mode == "reduce_scatter" else outs[0]
    err = np.abs(got - exact).max()
    assert 0 < err <= comms.comms_error_bound("bf16", P, max_abs)


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int32_fixed"])
@pytest.mark.parametrize("P", [1, 2, 4, 8, 64])
@pytest.mark.parametrize("max_abs", [0.0, 1.0, 123.5, 2.0 ** 20])
def test_error_bound_equals_reference(dtype, P, max_abs):
    assert comms.comms_error_bound(dtype, P, max_abs) == \
        jcomms.comms_error_bound(dtype, P, max_abs)


def test_error_bound_refuses_unknown_dtype():
    with pytest.raises(ValueError):
        comms.comms_error_bound("fp8", 8, 1.0)


@pytest.mark.parametrize("dtype", ["bf16", "int32_fixed"])
def test_integer_partials_refuse_compression(dtype):
    import torch

    with pytest.raises(ValueError, match="integer"):
        comms.hist_reduce(torch.zeros((1, 2, 4, 2), dtype=torch.int32), None,
                          comms_dtype=dtype)


def _slab_winner(gain, lo, hi, n_bins, missing_bin):
    """numpy: the first maximal flattened (direction, feature, bin) of
    gain [D, F, B] restricted to features [lo, hi) -> (gain, global
    feature, bin, direction)."""
    D = gain.shape[0]
    slab = gain[:, lo:hi].reshape(-1)
    if slab.size == 0:
        return -np.inf, lo, 0, False
    k = int(np.argmax(slab))
    d, rest = divmod(k, (hi - lo) * n_bins)
    f, b = divmod(rest, n_bins)
    return float(slab[k]), lo + f, b, bool(missing_bin and d == 1 and D == 2)


def _tie_table(n_nodes, F, B, missing_bin, seed):
    """Gains [n, D, F, B] rounded to a coarse grid (many exact ties
    across features and directions), with engineered cases per node."""
    rng = np.random.default_rng(seed)
    D = 2 if missing_bin else 1
    g = np.round(rng.random((n_nodes, D, F, B)) * 4).astype(np.float32)
    g[0] = -np.inf
    g[0, D - 1, F - 1, 2] = 3.0            # the only live candidate
    g[1] = 1.0                             # every candidate tied
    if missing_bin:
        g[2] = 0.0
        g[2, 1, 0, 1] = 5.0                # LEFT block, first feature
        g[2, 0, F - 1, 0] = 5.0            # RIGHT block, last feature
    g[3] = -np.inf                         # nothing valid at all
    return g


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("missing_bin", [False, True])
def test_combine_equals_single_device_argmax(pools, P, missing_bin):
    n_nodes, F, B = 6, 9, 5
    gain = _tie_table(n_nodes, F, B, missing_bin, seed=P)
    b = -(-F // P)
    winners = []
    for r in range(P):
        lo, hi = min(r * b, F), min(r * b + b, F)
        # At P = 4, F = 9 the last rank's slab is all padding (-inf).
        rows = [_slab_winner(gain[n], lo, hi, B, missing_bin)
                for n in range(n_nodes)]
        winners.append((np.array([w[0] for w in rows], np.float32),
                        np.array([w[1] for w in rows], np.int32),
                        np.array([w[2] for w in rows], np.int32),
                        np.array([w[3] for w in rows], bool)))
    outs = pools(P).run(tasks.combine, winners, F, B, missing_bin)
    for n in range(n_nodes):
        flat = gain[n].reshape(-1)
        k = int(np.argmax(flat))
        d, rest = divmod(k, F * B)
        f, bb = divmod(rest, B)
        for ga, fa, ba, da in outs:
            if not np.isfinite(flat[k]):
                assert not np.isfinite(ga[n])
                continue
            assert (ga[n], fa[n], ba[n], bool(da[n])) == (flat[k], f, bb,
                                                          d == 1), n
    if missing_bin:
        # The RIGHT block precedes the LEFT one whichever rank holds it.
        assert outs[0][1][2] == F - 1 and not outs[0][3][2]


def test_combine_without_group_is_the_identity():
    import torch

    t = (torch.ones(2), torch.zeros(2, dtype=torch.int32),
         torch.zeros(2, dtype=torch.int32), torch.zeros(2, dtype=torch.bool))
    assert all(a is b for a, b in zip(
        comms.combine_shard_winners(*t, None, n_features=1, n_bins=2), t))


@pytest.mark.parametrize("flag,shards,want", [
    ("auto", 4, "reduce_scatter"), ("auto", 1, "allreduce"),
    ("reduce_scatter", 2, "reduce_scatter"),
    ("reduce_scatter", 1, "allreduce"), ("allreduce", 4, "allreduce"),
    ("allreduce", 1, "allreduce")])
def test_resolve_split_comms(flag, shards, want):
    assert comms.resolve_split_comms(flag, row_shards=shards) == want
    assert jcomms.resolve_split_comms(
        flag, distributed=shards > 1, row_shards=shards) == want


def test_resolve_split_comms_refuses_unknown():
    with pytest.raises(ValueError, match="split_comms"):
        comms.resolve_split_comms("ring", row_shards=2)


@pytest.mark.parametrize("bad,match", [
    (dict(split_comms="ring"), "split_comms"),
    (dict(hist_comms_dtype="fp8"), "hist_comms_dtype"),
    (dict(n_partitions=0), "n_partitions"),
    (dict(grad_dtype="int8", hist_comms_dtype="bf16"), "double-quantize"),
    (dict(grad_dtype="int16", hist_comms_dtype="int32_fixed"),
     "double-quantize")])
def test_config_validates_comms_fields(bad, match):
    with pytest.raises(ValueError, match=match):
        TrainConfig(**bad)


@pytest.mark.parametrize("kw", [
    dict(max_depth=6, n_features=28, n_bins=255),
    dict(max_depth=6, n_features=39, n_bins=255, partitions=4,
         mode="reduce_scatter", subtraction=True),
    dict(max_depth=4, n_features=9, n_bins=31, partitions=4,
         mode="reduce_scatter", comms_dtype="bf16"),
    dict(max_depth=5, n_features=10, n_bins=63, partitions=2,
         subtraction=True, grad_dtype="int8")])
def test_payload_model_equals_reference(kw):
    from ddt_tpu.telemetry import counters as jcounters

    args = (kw.pop("max_depth"), kw.pop("n_features"), kw.pop("n_bins"))
    assert comms.hist_allreduce_bytes(*args, **kw) == \
        jcounters.hist_allreduce_bytes(*args, **kw)


def test_cuda_tensor_refused_on_a_gloo_group(pools):
    msgs = pools(2).run(tasks.check_cuda_group)
    assert all(m is not None and "NCCL" in m for m in msgs)
