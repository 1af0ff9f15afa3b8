"""The port's plain traversal against ddt_tpu's scorers on the CPU.

Held bitwise on exact-grid leaf values (multiples of 1/8, the method of
tests/test_predict_lut4.py): every partial sum is then exact in f32, so
the leaf CHOICE is all that is compared, against the reference's Pallas
traversal kernel in interpret mode and against its one-hot path, with
missing-value routing, categorical one-vs-rest nodes and 3 classes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddt_tpu.models import tree as jtree
from ddt_tpu.ops import predict as jpred
from ddt_tpu.ops import predict_pallas as jpp
from ddt_tpu_torch.backends.cuda import CUDADevice
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.models import tree as ttree
from ddt_tpu_torch.ops import predict as tpred
from ddt_tpu_torch.ops import predict_cuda, predict_lut_cuda


def _exact_ens(T=9, depth=3, F=4, B=31, C=1, missing=False, cat=(),
               seed=0):
    rng = np.random.default_rng(seed)
    N = 2 ** (depth + 1) - 1
    ens = jtree.empty_ensemble(
        T, depth, F, 0.125, 0.25, "softmax" if C > 1 else "logloss",
        n_classes=max(C, 2), missing_bin=missing, n_bins=B,
        cat_features=tuple(cat))
    ens.feature[:] = rng.integers(0, F, size=(T, N))
    ens.threshold_bin[:] = rng.integers(0, B - 1, size=(T, N))
    ens.is_leaf[:] = rng.random((T, N)) < 0.25
    ens.leaf_value[:] = rng.integers(-7, 8, size=(T, N)) / 8.0
    if missing:
        ens.default_left[:] = rng.random((T, N)) < 0.5
    return ens


def _X(R, F=4, B=31, seed=1):
    return np.random.default_rng(seed).integers(0, B, (R, F), dtype=np.uint8)


def _port_plain(ens_j, X, tree_chunk=64):
    ce = ttree.TreeEnsemble.from_dict(ens_j.to_dict()).compile(tree_chunk)
    ops = [torch.from_numpy(a) for a in ce.arrays()]
    ef, et, bv, coh, *rest = ops
    dl = rest.pop(0) if ce.eff_dl is not None else None
    cat = rest.pop(0) if ce.eff_cat is not None else None
    return tpred.predict_raw_effective(
        ef, et, bv, coh, torch.from_numpy(X), max_depth=ce.max_depth,
        learning_rate=ce.learning_rate, base=ce.base_score,
        tree_chunk=tree_chunk, eff_dl=dl,
        missing_bin_value=ce.missing_bin_value, eff_cat=cat).numpy()


def _ref_kwargs(ens):
    use_missing = ens.missing_bin and ens.default_left is not None
    kw = dict(max_depth=ens.max_depth, learning_rate=ens.learning_rate,
              base=ens.base_score,
              n_classes=ens.n_classes if ens.loss == "softmax" else 1,
              missing_bin_value=ens.n_bins - 1 if use_missing else -1)
    if use_missing:
        kw["default_left"] = jnp.asarray(ens.default_left)
    if ens.has_cat_splits:
        kw["cat_node"] = jnp.asarray(np.isin(ens.feature, ens.cat_features))
    return kw


@pytest.mark.parametrize("kw", [
    dict(), dict(C=3, missing=True, cat=(1,)), dict(T=70, depth=2),
])
def test_plain_matches_reference_pallas_bitwise(kw):
    ens = _exact_ens(**kw)
    X = _X(300)
    want = np.asarray(jpp.predict_raw_pallas(
        jnp.asarray(ens.feature), jnp.asarray(ens.threshold_bin),
        jnp.asarray(ens.is_leaf), jnp.asarray(ens.leaf_value),
        jnp.asarray(X), tree_chunk=32, interpret=True, **_ref_kwargs(ens)))
    np.testing.assert_array_equal(_port_plain(ens, X, tree_chunk=32), want)


@pytest.mark.parametrize("kw", [
    dict(C=3, missing=True, cat=(0, 2)), dict(missing=True),
    dict(cat=(3,)), dict(C=3, T=130, depth=4),
])
def test_plain_matches_reference_onehot_bitwise(kw):
    ens = _exact_ens(**kw)
    X = _X(1000, seed=2)
    X[::7, 1] = 30                       # reserved missing bin rows
    ce = ens.compile(tree_chunk=64)
    ops = [jnp.asarray(a) for a in ce.arrays()]
    ef, et, bv, coh, *rest = ops
    dl = rest.pop(0) if ce.eff_dl is not None else None
    cat = rest.pop(0) if ce.eff_cat is not None else None
    want = np.asarray(jpred.predict_raw_effective(
        ef, et, bv, coh, jnp.asarray(X), max_depth=ce.max_depth,
        learning_rate=ce.learning_rate, base=ce.base_score,
        n_classes=ce.n_classes_out, tree_chunk=64, eff_dl=dl,
        missing_bin_value=ce.missing_bin_value, eff_cat=cat,
        use_pallas=False))
    got = _port_plain(ens, X)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ens.predict_raw(X, binned=True))


def test_plain_random_leaves_close_to_host_oracle():
    ens = _exact_ens(T=40, depth=4, missing=True, cat=(2,))
    ens.leaf_value[:] = np.random.default_rng(3).standard_normal(
        ens.leaf_value.shape)
    X = _X(500, seed=4)
    np.testing.assert_allclose(_port_plain(ens, X),
                               ens.predict_raw(X, binned=True),
                               rtol=1e-5, atol=1e-5)


def test_empty_batch():
    ens = _exact_ens()
    out = _port_plain(ens, _X(0))
    assert out.shape == (0,)


def test_backend_predict_on_cpu_uses_plain_and_caches():
    ens = ttree.TreeEnsemble.from_dict(_exact_ens(T=20).to_dict())
    be = CUDADevice(TrainConfig(device="cpu"))
    X = _X(700, seed=5)
    before = predict_cuda.launches
    got = be.predict_raw(ens, X)
    assert predict_cuda.launches == before
    np.testing.assert_array_equal(got, ens.predict_raw(X, binned=True))
    assert len(be._predict_cache) == 1
    (_, ops), = be._predict_cache.values()
    assert isinstance(ops, tpred.PlainOperands)  # prepared once per model
    be.predict_raw(ens, X[:10])
    assert len(be._predict_cache) == 1           # cache hit, no rebuild
    assert next(iter(be._predict_cache.values()))[1] is ops
    ens.leaf_value[0, 0] += 1.0                  # in-place edit: new token
    be.predict_raw(ens, X[:10])
    assert len(be._predict_cache) == 2


def test_kernel_wrapper_refuses_cpu_tensors():
    ens = ttree.TreeEnsemble.from_dict(_exact_ens(missing=True,
                                                  cat=(1,)).to_dict())
    ce = ens.compile()
    ef, et, bv, coh, dl, cat = (torch.from_numpy(a) for a in ce.arrays())
    tables = predict_cuda.pack_tables(ef, et, bv, coh, ce.max_depth,
                                      eff_dl=dl, eff_cat=cat)
    # Node words: default-left bit, categorical bit on real splits only.
    u = _unpack(tables)
    n_int = 2 ** ce.max_depth - 1
    n = tables.n_trees
    np.testing.assert_array_equal(u["dl"], dl[:n, :n_int].numpy())
    np.testing.assert_array_equal(
        u["cat"], (cat[:n, :n_int] & (ef[:n, :n_int] >= 0)).numpy())
    np.testing.assert_array_equal(u["feature"], ef[:n, :n_int].numpy())
    assert u["cls"].tolist() == [0] * n
    assert tables.max_feature == int(ef[:, :n_int].max())
    with pytest.raises(TypeError, match="prepared on the CPU"):
        tpred.predict_prepared(tables, torch.from_numpy(_X(10)),
                               learning_rate=0.1, base=0.0)
    with pytest.raises(TypeError, match="CUDA tensor"):
        predict_cuda.traverse_cuda(tables, torch.from_numpy(_X(10)),
                                   learning_rate=0.1, base=0.0)


# --------------------------------------------------------------------- #
# K3's host half (ops/predict_cuda.pack_tables and the shared launch plan,
# ops/predict_lut_cuda.plan_launch at f32 leaves), checked on the CPU.
# The records are walked here in numpy exactly as csrc/lut.cu walks them.
# --------------------------------------------------------------------- #

#: Real-node thresholds outside a uint8 bin's range, and at its edge.
ODD_THRESHOLDS = (-7, -1, 255, 256, 1000)
H100 = dict(smem_limit=predict_lut_cuda.SMEM_LIMIT_H100, sm_count=132)


def _odd_ens(missing, seed=0):
    """A 3-class model over 256 bins (rows reach bin 255) whose real
    nodes, categorical ones included, take the thresholds of
    ODD_THRESHOLDS a third of the time."""
    ens = _exact_ens(T=12, depth=3, F=4, B=256, C=3, missing=missing,
                     cat=(1, 3), seed=seed)
    rng = np.random.default_rng(seed + 7)
    odd = rng.random(ens.threshold_bin.shape) < 0.35
    ens.threshold_bin[:] = np.where(
        odd, rng.choice(ODD_THRESHOLDS, size=odd.shape), ens.threshold_bin)
    return ens


K3_VARIANTS = [
    pytest.param(dict(), 31, id="plain"),
    pytest.param(dict(C=3, missing=True, cat=(1,)), 31,
                 id="missing-cat-3class"),
    pytest.param(dict(T=70, depth=2), 31, id="70trees-depth2"),
    pytest.param("odd", 256, id="odd-thresholds"),
    pytest.param("odd-missing", 256, id="odd-thresholds-missing"),
]


def _k3_ens(variant, exact=True, seed=0):
    if variant in ("odd", "odd-missing"):
        ens = _odd_ens(variant == "odd-missing", seed=seed)
    else:
        ens = _exact_ens(seed=seed, **variant)
    if not exact:
        ens.leaf_value[:] = np.random.default_rng(seed + 3) \
            .standard_normal(ens.leaf_value.shape).astype(np.float32)
    return ens


def _k3_rows(ens, B, R=400, seed=1):
    X = _X(R, F=ens.n_features, B=B, seed=seed)
    if ens.missing_bin:
        X[::5, 0] = B - 1                  # reserved missing bin rows
    return X


def _pack(ce):
    ops = [torch.from_numpy(a) for a in ce.arrays()]
    ef, et, bv, coh, *rest = ops
    dl = rest.pop(0) if ce.eff_dl is not None else None
    cat = rest.pop(0) if ce.eff_cat is not None else None
    return predict_cuda.pack_tables(ef, et, bv, coh, ce.max_depth,
                                    eff_dl=dl, eff_cat=cat)


def _unpack(tables) -> dict:
    """The record layout of csrc/lut.cu read back field by field, f32
    leaves: feature, threshold (stored + 1), dl and cat per node, class,
    scale and the leaves, each [n_trees, .]."""
    D = tables.max_depth
    n_int, n_leaf = (1 << D) - 1, 1 << D
    assert tables.rec.shape[1] == predict_lut_cuda.record_bytes(
        D, "float32")
    words = np.ascontiguousarray(tables.rec.numpy()).view(np.int32)
    w = words[:, :n_int]
    return {"feature": w >> 16, "threshold": (w & 0x1FF) - 1,
            "dl": (w >> 9) & 1, "cat": (w >> 10) & 1,
            "cls": words[:, n_int],
            "scale": words[:, n_int + 1].view(np.float32),
            "leaf": words[:, n_int + 2:n_int + 2 + n_leaf].view(np.float32)}


def _walk(tables, X, *, tree_chunk, learning_rate, base, missing_bin_value):
    """csrc/lut.cu's descent and sum over K3's records, in numpy f32: a
    word per level, node = 2 node + 1 + go, the f32 leaf, class sums tree
    by tree, acc += chunk sum, base + lr * acc."""
    u = _unpack(tables)
    f32 = np.float32
    n_int = (1 << tables.max_depth) - 1
    mbv = missing_bin_value if tables.use_missing else -1
    R = X.shape[0]
    rows = np.arange(R)
    acc = np.zeros((R, tables.n_classes), f32)
    cs = np.zeros_like(acc)
    for t in range(tables.n_trees):
        if t and t % tree_chunk == 0:
            acc, cs = (acc + cs).astype(f32), np.zeros_like(cs)
        node = np.zeros(R, np.int64)
        for _ in range(tables.max_depth):
            f, th = u["feature"][t, node], u["threshold"][t, node]
            v = np.where(f >= 0, X[rows, np.maximum(f, 0)], 0).astype(
                np.int64)
            go = np.where(u["cat"][t, node] == 1, v != th, v > th)
            go = np.where(v == mbv, u["dl"][t, node] == 0, go)
            node = 2 * node + np.where(go, 2, 1)
        c = int(u["cls"][t])
        cs[:, c] = cs[:, c] + u["leaf"][t, node - n_int]
    out = f32(base) + f32(learning_rate) * (acc + cs)
    return out[:, 0] if tables.n_classes == 1 else out


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "random"])
@pytest.mark.parametrize("variant,B", K3_VARIANTS)
def test_k3_records_walked_as_the_kernel_equal_plain_and_reference(
        variant, B, exact):
    """K3's records, walked as the kernel walks them (trailing zero trees
    left out), equal the port's plain version bitwise on any leaves (the
    same tree-order sums), and on exact-grid leaves the reference's
    interpret-mode Pallas kernel too, thresholds beyond the bins'
    range included."""
    ens = _k3_ens(variant, exact=exact)
    X = _k3_rows(ens, B)
    tc = 32
    ce = ttree.TreeEnsemble.from_dict(ens.to_dict()).compile(tc)
    walked = _walk(_pack(ce), X, tree_chunk=tc,
                   learning_rate=ce.learning_rate, base=ce.base_score,
                   missing_bin_value=ce.missing_bin_value)
    np.testing.assert_array_equal(walked, _port_plain(ens, X, tree_chunk=tc))
    if exact:
        want = np.asarray(jpp.predict_raw_pallas(
            jnp.asarray(ens.feature), jnp.asarray(ens.threshold_bin),
            jnp.asarray(ens.is_leaf), jnp.asarray(ens.leaf_value),
            jnp.asarray(X), tree_chunk=tc, interpret=True,
            **_ref_kwargs(ens)))
        np.testing.assert_array_equal(walked, want)
        np.testing.assert_array_equal(walked, ens.predict_raw(X, binned=True))


@pytest.mark.parametrize("variant,B", K3_VARIANTS)
def test_k3_records_hold_the_compiled_arrays(variant, B):
    """Every field of K3's records, decoded back, is the CompiledEnsemble's
    own: feature, threshold clamped to [-1, 256], default-left,
    categorical gated on feature >= 0, class, scale 1.0 and the f32
    bottom-level values bit for bit."""
    ce = ttree.TreeEnsemble.from_dict(
        _k3_ens(variant, exact=False).to_dict()).compile(8)
    tables = _pack(ce)
    u = _unpack(tables)
    n, n_int = tables.n_trees, (1 << ce.max_depth) - 1
    assert n == ce.n_trees_padded - int(np.all(
        ce.bot_val == 0, axis=1)[::-1].cumprod().sum())
    feat = ce.eff_feat[:n, :n_int]
    np.testing.assert_array_equal(u["feature"], feat)
    np.testing.assert_array_equal(
        u["threshold"], np.clip(ce.eff_thr[:n, :n_int], -1, 256))
    np.testing.assert_array_equal(
        u["dl"], np.zeros_like(feat) if ce.eff_dl is None
        else ce.eff_dl[:n, :n_int])
    np.testing.assert_array_equal(
        u["cat"], np.zeros_like(feat) if ce.eff_cat is None
        else ce.eff_cat[:n, :n_int] & (feat >= 0))
    np.testing.assert_array_equal(u["cls"], ce.cls_oh[:n].argmax(axis=1))
    np.testing.assert_array_equal(u["scale"], np.ones(n, np.float32))
    np.testing.assert_array_equal(u["leaf"].view(np.int32),
                                  ce.bot_val[:n].view(np.int32))
    if variant in ("odd", "odd-missing"):
        real = feat >= 0
        assert {-1, 256} <= set(u["threshold"][real].tolist())


def _higgs_like(trees=100):
    """A port ensemble at the Higgs shape (28 features, depth 6, 255 bins)
    with random leaves."""
    ens = ttree.TreeEnsemble.from_dict(_exact_ens(
        T=trees, depth=6, F=28, B=255).to_dict())
    ens.leaf_value[:] = np.random.default_rng(4).standard_normal(
        ens.leaf_value.shape)
    return ens


def test_k3_trailing_zero_trees_are_the_padding():
    """CompiledEnsemble pads 100 trees to 128 with zero leaves: exactly
    those 28 are left out of the records; a real tree at the end whose
    leaves are all +-0.0 goes too (it adds +0.0), one in the middle
    stays."""
    ce = _higgs_like().compile(tree_chunk=64)
    assert ce.n_trees_padded == 128
    tables = _pack(ce)
    assert (tables.n_trees, tables.n_trees_padded) == (100, 128)
    assert tuple(tables.rec.shape) == (
        100, predict_lut_cuda.record_bytes(6, "float32"))
    ens = _higgs_like()
    ens.leaf_value[97:] = 0.0
    ens.leaf_value[99, ::2] = -0.0
    assert _pack(ens.compile(tree_chunk=64)).n_trees == 97
    ens = _higgs_like()
    ens.leaf_value[50] = 0.0
    assert _pack(ens.compile(tree_chunk=64)).n_trees == 100


def test_k3_plan_higgs_shape_takes_both_mappings():
    """100 depth-6 trees x 28 features on an H100 at f32 leaves: serving
    batches spread over many blocks (pairs), from 67,584 rows (a block of
    512 rows an SM) two rows a thread, every tree staged in one pass,
    within the card's 232,448 B."""
    plan = predict_lut_cuda.plan_launch
    for R in (1, 16, 64, 256, 257):
        p = plan(R, 100, 6, 28, "float32", 1, **H100)
        assert p.pairs and p.smem <= H100["smem_limit"]
        assert p.blocks == -(-R // p.rows) and p.blocks >= min(R, 64) // 3
    assert plan(67_583, 100, 6, 28, "float32", 1, **H100).pairs
    p = plan(67_584, 100, 6, 28, "float32", 1, **H100)
    assert not p.pairs and p.rows == 512 and p.blocks == 132
    p = plan(1_000_000, 100, 6, 28, "float32", 1, **H100)
    assert not p.pairs and (p.rows, p.sub, p.blocks) == (512, 100, 1954)
    assert p.smem == 100 * 528 + 28 * 512 <= H100["smem_limit"]
    # 7 classes: at most 36 rows a pairs block (one thread a row and
    # class sums).
    p = plan(256, 70, 6, 28, "float32", 7, **H100)
    assert p.pairs and p.rows * 7 <= predict_lut_cuda.THREADS


@pytest.mark.parametrize("C", [1, 3, 7, 32])
@pytest.mark.parametrize("F,T,depth", [(28, 100, 6), (7, 13, 3),
                                       (300, 1000, 8), (1, 0, 1)])
def test_k3_plan_covers_every_row_within_the_card(C, F, T, depth):
    """Any batch at f32 leaves: every row in exactly one block, one summing
    thread a (row, class), at least one tree a pass, within shared
    memory; the rows mapping from a block of 512 rows an SM on."""
    rows_from = None
    for R in (1, 2, 31, 255, 256, 257, 1000, 67_583, 67_584, 135_169,
              1_000_000):
        p = predict_lut_cuda.plan_launch(R, T, depth, F, "float32", C,
                                         **H100)
        assert p.blocks * p.rows >= R > (p.blocks - 1) * p.rows
        assert p.sub >= 1 and p.smem <= H100["smem_limit"]
        if p.pairs:
            assert rows_from is None and 1 <= p.rows
            assert p.rows * C <= predict_lut_cuda.THREADS
        else:
            assert p.rows in (256, 512)
            rows_from = R if rows_from is None else rows_from
    assert rows_from == 67_584


def test_k3_plan_stages_1000_trees_pass_by_pass():
    """1000 depth-6 trees (528 KB of f32 records) do not fit one block:
    serving batches take passes as large as fit, one block an SM; the rows
    mapping's passes are sized for four blocks an SM. One tree too many
    for shared memory is refused."""
    limit, per_block = H100["smem_limit"], 16 + 1024
    plan = predict_lut_cuda.plan_launch
    for R in (1, 256):
        p = plan(R, 1000, 6, 28, "float32", 1, **H100)
        assert p.pairs and 400 <= p.sub < 1000 and p.smem <= limit
        assert p.blocks <= H100["sm_count"]
    p = plan(1_000_000, 1000, 6, 28, "float32", 1, **H100)
    assert not p.pairs and p.sub == 81
    assert 4 * (p.smem + per_block) <= limit + 1024
    with pytest.raises(ValueError, match="shared memory"):
        plan(1, 100, 15, 28, "float32", 1, **H100)


def test_k3_plan_takes_pairs_for_rows_too_wide_for_a_block():
    """1024 features at depth 6 (BASELINE config 5): 256 rows of 1 KB
    beside a tree exceed shared memory, so K3 takes the pairs mapping at
    every batch size, every row covered within the card; so do the
    quantized tiers' leaf kinds (K4, K5), which the reference's guards
    admit at this shape too."""
    plan = predict_lut_cuda.plan_launch
    for leaf_dtype in ("float32", "float16", "int8", "int4"):
        for R in (1, 256, 67_584, 500_000, 1_000_000):
            p = plan(R, 20, 6, 1024, leaf_dtype, 1, **H100)
            assert p.pairs and p.sub == 20 and p.smem <= H100["smem_limit"]
            assert p.blocks * p.rows >= R > (p.blocks - 1) * p.rows


def test_k3_plan_spreads_a_large_batch_over_two_blocks_an_sm():
    """100 trees: the pairs mapping takes the fewest rows a block that let
    one wave hold the batch (42 rows, three blocks an SM, at 16,384
    rows); where no block size does (49,152 rows), two blocks an SM whose
    passes fit their half of it. Every row covered, within the card."""
    limit, per_block = H100["smem_limit"], 16 + 1024
    plan = predict_lut_cuda.plan_launch
    p = plan(16_384, 100, 6, 28, "float32", 1, **H100)
    assert p.pairs and (p.rows, p.blocks, p.sub) == (42, 391, 100)
    assert 3 * (p.smem + per_block) <= limit + 1024
    p = plan(49_152, 100, 6, 28, "float32", 1, **H100)
    assert p.pairs and p.blocks == 2 * H100["sm_count"] - 1
    assert p.sub < 100 and 2 * (p.smem + per_block) <= limit + 1024
    assert p.blocks * p.rows >= 49_152


# --------------------------------------------------------------------- #
# api.predict(n_partitions=): rows sharded over k devices in one process
# --------------------------------------------------------------------- #
def test_api_predict_n_partitions_flag():
    """Mirror of tests/test_predict_pallas.py::
    test_api_predict_n_partitions_flag: n_partitions=4 (four blocks on the
    CPU, scored by the plain version) is bitwise the one-device result,
    on binned and float rows, and bitwise the reference's 4-device row
    mesh on an exact-grid model."""
    from ddt_tpu import api as japi
    from ddt_tpu_torch import api
    from ddt_tpu_torch.backends import row_sharded_backend
    from ddt_tpu_torch.data.datasets import synthetic_binary

    X, y = synthetic_binary(1500, n_features=6, seed=6)
    res = api.train(X, y, n_trees=4, max_depth=3, n_bins=31, device="cpu")
    Xb = res.mapper.transform(X)
    want = api.predict(res.ensemble, Xb, binned=True, raw=True,
                       device="cpu")
    got = api.predict(res.ensemble, Xb, binned=True, n_partitions=4,
                      raw=True, device="cpu")
    np.testing.assert_array_equal(want, got)
    for n in (1, 3, 4, 1001):            # blocks empty, short and uneven
        np.testing.assert_array_equal(
            api.predict(res.ensemble, X[:n], mapper=res.mapper,
                        n_partitions=4, device="cpu"),
            api.predict(res.ensemble, X[:n], mapper=res.mapper,
                        device="cpu"))
    sc = row_sharded_backend(4, "cpu")
    assert row_sharded_backend(4, "cpu") is sc      # memoised
    assert len(sc.shards) == 4
    assert all(len(be._predict_cache) == 1 for be in sc.shards)
    # Blocks already on the shards' devices (the resident arm).
    from ddt_tpu_torch.parallel import mesh

    blocks = [torch.from_numpy(Xb[a:b]) for a, b, _ in (
        mesh.row_block(len(Xb), 4, i) for i in range(4))]
    np.testing.assert_array_equal(sc.predict_raw(res.ensemble, blocks),
                                  want)
    with pytest.raises(ValueError, match="3 blocks for 4 shards"):
        sc.predict_raw(res.ensemble, blocks[:3])
    # A cfg or backend wins over the flag, as in the reference.
    be = CUDADevice(TrainConfig(device="cpu"))
    np.testing.assert_array_equal(
        api.predict(res.ensemble, Xb, binned=True, raw=True, backend=be,
                    n_partitions=4), want)
    # The reference's row mesh on the same exact-grid model.
    ens = _exact_ens(T=12, depth=3, F=6)
    Xg = _X(1500, F=6, seed=8)
    ref = japi.predict(ens, Xg, binned=True, n_partitions=4, raw=True)
    port = api.predict(ttree.TreeEnsemble.from_dict(ens.to_dict()), Xg,
                       binned=True, n_partitions=4, raw=True, device="cpu")
    np.testing.assert_array_equal(np.asarray(ref), port)


def test_api_predict_n_partitions_above_visible_cards_raises():
    from ddt_tpu_torch import api
    from ddt_tpu_torch.backends import RowShardedScorer

    ens = ttree.TreeEnsemble.from_dict(_exact_ens().to_dict())
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="CUDA cards visible"):
        api.predict(ens, _X(8), binned=True,
                    n_partitions=max(2, visible + 1))
    with pytest.raises(ValueError, match="n_partitions must be"):
        RowShardedScorer(0, "cpu")
