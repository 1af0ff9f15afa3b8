"""The port's quantized (TreeLUT) tiers against ddt_tpu on the CPU.

Models are made with the reference's own recipe (tests/test_predict_lut4.py
`_rand_ens` / `_rows`, numpy seeds) and carried into the port with
to_dict / from_dict. The reference's Pallas kernels run in interpret mode.

- Tables: quantize_compiled (every field, max_abs_err included),
  lut_device_operands, pack_int4().ops and thr_packed are bitwise equal
  for leaf_dtype float16, int8 and int4, across 1 and 3 classes, missing,
  categorical, 13 and 31 bins and ragged tree counts.
- Scores: the port's plain versions equal predict_effective_lut /
  predict_effective_lut4 bitwise on exact-grid models (leaves on a
  power-of-two grid whose per-tree scale is exact, so quantization is
  lossless and every partial sum is exact in f32: the order cannot
  matter). On random models they agree within 1e-5 absolute (f32 sums in
  another order), and both stay within max_abs_err * (1 + 1e-5) + 1e-6 of
  the f32 path.
- The LUT kernels' host half (ops/predict_lut_cuda): the launch plan
  (mapping, rows a block, trees a pass, shared memory) for any batch on
  an H100's limits, and the packed tree records: each field read back
  equals the quantized tables', the padding trees are left out, and the
  records walked in numpy exactly as csrc/lut.cu walks them equal the
  plain version bitwise on any model and the reference's interpret-mode
  kernel on exact-grid ones.
- The backend's tier ladder on CUDADevice(device="cpu").
"""

import logging

import numpy as np
import pytest
import torch

from ddt_tpu.export import aot as jaot
from ddt_tpu.models.tree import empty_ensemble as j_empty_ensemble
from ddt_tpu.ops import predict_lut as jlut
from ddt_tpu_torch import api as tapi
from ddt_tpu_torch.backends.cuda import CUDADevice
from ddt_tpu_torch.config import TrainConfig
from ddt_tpu_torch.models.tree import TreeEnsemble
from ddt_tpu_torch.ops import predict as tpred
from ddt_tpu_torch.ops import predict_lut, predict_lut_cuda


def _rand_ens(seed=0, trees=12, depth=3, features=7, bins=31,
              loss="logloss", n_classes=2, missing=False, cat=(),
              exact_grid=False, qmax=7):
    """tests/test_predict_lut4.py's recipe; exact_grid puts leaves on the
    1/(qmax+1) grid with each tree's max |leaf| pinned to qmax/(qmax+1),
    so scale = 1/(qmax+1) exactly (qmax 7: int4; 127: int8)."""
    rng = np.random.default_rng(seed)
    n_nodes = 2 ** (depth + 1) - 1
    ens = j_empty_ensemble(
        trees, depth, features, 0.125 if exact_grid else 0.1,
        0.25, loss, n_classes=n_classes,
        missing_bin=missing, n_bins=bins, cat_features=tuple(cat))
    ens.feature[:] = rng.integers(0, features, size=(trees, n_nodes))
    ens.threshold_bin[:] = rng.integers(
        0, bins - (2 if missing else 1), size=(trees, n_nodes))
    ens.is_leaf[:] = rng.random((trees, n_nodes)) < 0.25
    if exact_grid:
        q = rng.integers(-qmax, qmax + 1,
                         size=(trees, n_nodes)).astype(np.float32)
        ens.leaf_value[:] = q / (qmax + 1)
        ens.is_leaf[:, [(1 << d) - 1 for d in range(depth)]] = False
        ens.leaf_value[:, (1 << depth) - 1] = qmax / (qmax + 1)
    else:
        ens.leaf_value[:] = rng.standard_normal(
            (trees, n_nodes)).astype(np.float32)
    if missing:
        ens.default_left[:] = rng.random((trees, n_nodes)) < 0.5
    return ens


def _rows(ens, rows=50, bins=31, missing=False, seed=1):
    rng = np.random.default_rng(seed)
    Xb = rng.integers(0, bins - (1 if missing else 0),
                      size=(rows, ens.n_features)).astype(np.uint8)
    if missing:
        mask = rng.random(Xb.shape) < 0.2
        Xb[mask] = bins - 1
    return Xb


def _port(ens_j) -> TreeEnsemble:
    return TreeEnsemble.from_dict(ens_j.to_dict())


# bins 13 -> thresholds fit a nibble (thr_packed), 31 -> the int8 form.
VARIANTS = [
    pytest.param(dict(), 13, id="binary-thrpacked"),
    pytest.param(dict(), 31, id="binary-thr8"),
    pytest.param(dict(loss="softmax", n_classes=3, trees=12), 13,
                 id="softmax3-thrpacked"),
    pytest.param(dict(missing=True), 13, id="missing-thrpacked"),
    pytest.param(dict(missing=True), 31, id="missing-thr8"),
    pytest.param(dict(cat=(1, 4)), 13, id="categorical-thrpacked"),
    pytest.param(dict(cat=(1, 4)), 31, id="categorical-thr8"),
    pytest.param(dict(loss="softmax", n_classes=3, cat=(0, 2), trees=9),
                 31, id="softmax3-cat-ragged"),
    pytest.param(dict(trees=13, depth=4), 13, id="ragged-deep"),
]
LEAF_DTYPES = ["float16", "int8", "int4"]


def _assert_tables_equal(got, want):
    for f in ("token", "tree_chunk", "max_depth", "n_classes_out",
              "learning_rate", "base_score", "loss", "missing_bin_value",
              "leaf_dtype", "max_abs_err"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("eff_feat", "thr_i8", "leaf_q", "leaf_scale", "cls_oh",
              "eff_dl", "eff_cat"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)


def _assert_ops_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("leaf_dtype", LEAF_DTYPES)
@pytest.mark.parametrize("variant,bins", VARIANTS)
def test_tables_and_operands_bitwise(variant, bins, leaf_dtype):
    ens = _rand_ens(bins=bins, **variant)
    want = ens.compile(tree_chunk=8).quantize(leaf_dtype=leaf_dtype)
    got = _port(ens).compile(tree_chunk=8).quantize(leaf_dtype=leaf_dtype)
    _assert_tables_equal(got, want)
    _assert_ops_equal(got.arrays(), want.arrays())
    _assert_ops_equal(got.dequantized(), want.dequantized())
    if leaf_dtype == "int4":
        pg, pw = got.pack_int4(), want.pack_int4()
        assert pg.thr_packed == pw.thr_packed
        _assert_ops_equal(pg.ops, pw.ops)
        assert pg.static_kwargs() == pw.static_kwargs()
    else:
        _assert_ops_equal(predict_lut.lut_device_operands(got),
                          jlut.lut_device_operands(want))


def _scores(ens_j, leaf_dtype, Xb):
    """(port plain, reference interpret-mode kernel, port tables)."""
    t_ref = ens_j.compile(tree_chunk=8).quantize(leaf_dtype=leaf_dtype)
    t = _port(ens_j).compile(tree_chunk=8).quantize(leaf_dtype=leaf_dtype)
    if leaf_dtype == "int4":
        got = predict_lut.predict_effective_lut4(t, Xb).numpy()
        want = np.asarray(jlut.predict_effective_lut4(t_ref, Xb,
                                                      tile_r=16))
    else:
        got = predict_lut.predict_effective_lut(t, Xb).numpy()
        want = np.asarray(jlut.predict_effective_lut(t_ref, Xb, tile_r=16))
    return got, want, t


@pytest.mark.parametrize("leaf_dtype", LEAF_DTYPES)
@pytest.mark.parametrize("variant,bins", VARIANTS)
def test_plain_bitwise_on_exact_grid(variant, bins, leaf_dtype):
    missing = variant.get("missing", False)
    ens = _rand_ens(bins=bins, exact_grid=True,
                    qmax=127 if leaf_dtype == "int8" else 7, **variant)
    Xb = _rows(ens, bins=bins, missing=missing)
    got, want, t = _scores(ens, leaf_dtype, Xb)
    assert t.max_abs_err == 0.0             # the grid is lossless
    if leaf_dtype == "int4":
        assert t.pack_int4().thr_packed == (bins <= 15)
    np.testing.assert_array_equal(got, want)
    # ... and the lossless grid scores exactly as the f32 host oracle.
    np.testing.assert_array_equal(got, ens.predict_raw(Xb, binned=True))


def _f32_port(ens_j, Xb):
    ce = _port(ens_j).compile(tree_chunk=8)
    ops = [torch.from_numpy(a) for a in ce.arrays()]
    ef, et, bv, coh, *rest = ops
    dl = rest.pop(0) if ce.eff_dl is not None else None
    cat = rest.pop(0) if ce.eff_cat is not None else None
    return tpred.predict_raw_effective(
        ef, et, bv, coh, torch.from_numpy(Xb), max_depth=ce.max_depth,
        learning_rate=ce.learning_rate, base=ce.base_score, tree_chunk=8,
        eff_dl=dl, missing_bin_value=ce.missing_bin_value,
        eff_cat=cat).numpy()


@pytest.mark.parametrize("leaf_dtype", LEAF_DTYPES)
@pytest.mark.parametrize("variant,bins", VARIANTS[1:8:2])
def test_plain_random_models_within_bound(variant, bins, leaf_dtype):
    missing = variant.get("missing", False)
    ens = _rand_ens(bins=bins, **variant)
    Xb = _rows(ens, bins=bins, missing=missing)
    got, want, t = _scores(ens, leaf_dtype, Xb)
    assert float(np.abs(got - want).max()) <= 1e-5
    f32 = _f32_port(ens, Xb)
    bound = t.max_abs_err * (1 + 1e-5) + 1e-6
    assert t.max_abs_err > 0                # the leaves really round
    assert float(np.abs(got - f32).max()) <= bound
    assert float(np.abs(want - f32).max()) <= bound


@pytest.mark.parametrize("leaf_dtype", LEAF_DTYPES)
def test_tables_cross_load_through_the_npz_layout(leaf_dtype):
    """Tables the reference carries (export/aot.tables_to_arrays) load
    into the port and score as the reference does; the port's dict loads
    back into the reference unchanged."""
    ens = _rand_ens(bins=13, cat=(2,), exact_grid=True,
                    qmax=127 if leaf_dtype == "int8" else 7)
    Xb = _rows(ens, bins=13)
    t_ref = ens.compile(tree_chunk=8).quantize(leaf_dtype=leaf_dtype)
    t = predict_lut.tables_from_arrays(jaot.tables_to_arrays(t_ref))
    _assert_tables_equal(t, t_ref)
    if leaf_dtype == "int4":
        got = predict_lut.predict_effective_lut4(t, Xb).numpy()
        want = np.asarray(jlut.predict_effective_lut4(t_ref, Xb))
    else:
        got = predict_lut.predict_effective_lut(t, Xb).numpy()
        want = np.asarray(jlut.predict_effective_lut(t_ref, Xb))
    np.testing.assert_array_equal(got, want)
    back = jaot.tables_from_arrays(predict_lut.tables_to_arrays(t))
    _assert_tables_equal(back, t_ref)


def test_empty_batch_returns_base():
    ens = _port(_rand_ens(loss="softmax", n_classes=3))
    t = ens.compile(tree_chunk=8).quantize()
    out = predict_lut.predict_effective_lut(t, np.zeros((0, 7), np.uint8))
    assert out.shape == (0, 3) and out.dtype == torch.float32
    t4 = _port(_rand_ens()).compile(tree_chunk=8).quantize("int4")
    assert predict_lut.predict_effective_lut4(
        t4, np.zeros((0, 7), np.uint8)).shape == (0,)


def test_non_integer_rows_raise_as_in_the_reference():
    ens = _rand_ens()
    Xf = _rows(ens).astype(np.float32)
    t = _port(ens).compile(tree_chunk=8).quantize()
    with pytest.raises(ValueError, match="binned integer"):
        predict_lut.predict_effective_lut(t, Xf)
    with pytest.raises(ValueError, match="binned integer"):
        predict_lut.predict_effective_lut4(
            _port(ens).compile(tree_chunk=8).quantize("int4"), Xf)
    with pytest.raises(ValueError, match="binned integer"):
        jlut.predict_effective_lut(
            ens.compile(tree_chunk=8).quantize(), Xf)
    # Integer rows of a wider dtype are taken, as the reference takes them.
    Xi = _rows(ens).astype(np.int32)
    np.testing.assert_array_equal(
        predict_lut.predict_effective_lut(t, Xi).numpy(),
        predict_lut.predict_effective_lut(t, Xi.astype(np.uint8)).numpy())


def test_unknown_leaf_dtype_and_non_int4_pack_raise():
    ce = _port(_rand_ens()).compile(tree_chunk=8)
    with pytest.raises(ValueError, match="float16\\|int8\\|int4"):
        ce.quantize(leaf_dtype="int2")
    with pytest.raises(ValueError, match="int4"):
        ce.quantize().pack_int4()


def test_thr_pack_refuses_categorical_sentinel_collision():
    """tests/test_predict_lut4.py:237 on the port: a categorical node
    whose bin id would clip into the sentinel refuses the pack; the same
    255 on a numeric node packs."""
    ens = _rand_ens(bins=31, cat=(1,))
    ens.threshold_bin[:] = ens.threshold_bin % 15
    ens.feature[0, 0] = 1
    ens.is_leaf[0, 0] = False
    ens.threshold_bin[0, 0] = 255
    t = _port(ens).compile(tree_chunk=8).quantize(leaf_dtype="int4")
    assert not t.pack_int4().thr_packed
    ens2 = _rand_ens(bins=31, cat=(1,))
    ens2.threshold_bin[:] = ens2.threshold_bin % 15
    ens2.feature[0, 0] = 0
    ens2.is_leaf[0, 0] = False
    ens2.threshold_bin[0, 0] = 255
    t2 = _port(ens2).compile(tree_chunk=8).quantize(leaf_dtype="int4")
    assert t2.pack_int4().thr_packed
    # And the values decide, not n_bins: one threshold at 15 unpacks.
    ens3 = _rand_ens(bins=31)
    ens3.threshold_bin[:] = ens3.threshold_bin % 15
    assert _port(ens3).compile(tree_chunk=8).quantize(
        "int4").pack_int4().thr_packed
    ens3.threshold_bin[0, 0] = 15
    ens3.is_leaf[0, 0] = False
    assert not _port(ens3).compile(tree_chunk=8).quantize(
        "int4").pack_int4().thr_packed


def test_quantize_memoized_and_seedable():
    ens = _port(_rand_ens())
    ce = ens.compile(tree_chunk=8)
    t1 = ce.quantize(leaf_dtype="int4")
    assert ce.quantize(leaf_dtype="int4") is t1
    ce2 = ens.compile(tree_chunk=8)
    ce2.seed_quantized(t1)
    assert ce2.quantize(leaf_dtype="int4") is t1


def test_fits_guards_count_shared_memory():
    limit = predict_lut_cuda.SMEM_LIMIT_H100
    # The Higgs shape fits both tiers with room for every tree at once.
    assert predict_lut.predict_lut_fits(128, 64, 6, 28, 1)
    assert predict_lut.predict_lut4_fits(128, 64, 6, 28, 1, thr_packed=True)
    for leaf_dtype in LEAF_DTYPES:
        for R in (1, 256, 1_000_000):
            assert predict_lut_cuda.plan_launch(
                R, 100, 6, 28, leaf_dtype, 1, limit, 132).sub == 100
    # Rows of 1000 features (256 KB staged per rows-mapping block) take
    # the pairs mapping; only a row too wide beside one tree record does
    # not fit.
    assert predict_lut.predict_lut_fits(64, 64, 6, 1000, 1)
    assert predict_lut.predict_lut4_fits(64, 64, 6, 1000, 1)
    assert predict_lut_cuda.plan_launch(
        1, 64, 6, 1000, "int4", 1, limit, 132).pairs
    assert not predict_lut.predict_lut_fits(64, 64, 6, 240_000, 1)
    assert not predict_lut.predict_lut4_fits(64, 64, 6, 240_000, 1)
    with pytest.raises(ValueError, match="shared memory"):
        predict_lut_cuda.plan_launch(1, 64, 6, 240_000, "int4", 1, limit,
                                     132)
    # Ragged chunks and more classes than the kernel holds are refused.
    assert not predict_lut.predict_lut_fits(100, 64, 6, 28, 1)
    assert not predict_lut.predict_lut4_fits(64, 64, 6, 28, 33)
    # A card with less shared memory refuses sooner.
    need = (predict_lut_cuda.min_smem(6, 28, "float16")
            + predict_lut_cuda.STATIC_SMEM)
    assert not predict_lut.predict_lut_fits(64, 64, 6, 28, 1,
                                            smem_limit=need - 1)
    assert predict_lut.predict_lut_fits(64, 64, 6, 28, 1, smem_limit=need)


# --------------------------------------------------------------------- #
# The kernels' host half: the launch plan and the packed tree records
# (ops/predict_lut_cuda), checked on the CPU. The records are walked here
# in numpy exactly as csrc/lut.cu walks them.
# --------------------------------------------------------------------- #

H100 = dict(smem_limit=predict_lut_cuda.SMEM_LIMIT_H100, sm_count=132)


@pytest.mark.parametrize("leaf_dtype", LEAF_DTYPES)
def test_plan_higgs_shape_takes_both_mappings(leaf_dtype):
    """100 depth-6 trees x 28 features on an H100: serving batches spread
    over many blocks (pairs), from 67,584 rows (a block of 512 rows an
    SM) two rows a thread, every tree staged in one pass, within the
    card's 232,448 B."""
    plan = predict_lut_cuda.plan_launch
    for R in (1, 16, 64, 256, 257):
        p = plan(R, 100, 6, 28, leaf_dtype, 1, **H100)
        assert p.pairs and p.smem <= H100["smem_limit"]
        assert p.blocks == -(-R // p.rows) and p.blocks >= min(R, 64) // 3
    assert plan(67_583, 100, 6, 28, leaf_dtype, 1, **H100).pairs
    p = plan(67_584, 100, 6, 28, leaf_dtype, 1, **H100)  # a block an SM
    assert not p.pairs and p.rows == 512 and p.blocks == 132
    # 600 features: 512 rows do not fit beside a tree, 256 do.
    assert plan(1_000_000, 100, 6, 600, leaf_dtype, 1, **H100).rows == 256
    p = plan(1_000_000, 100, 6, 28, leaf_dtype, 1, **H100)
    assert not p.pairs and p.rows == 512 and p.blocks == 1954
    assert p.smem == predict_lut_cuda.smem_bytes(100, 6, 28, leaf_dtype,
                                                 512)
    assert p.smem <= H100["smem_limit"]


def test_plan_stages_a_large_ensemble_pass_by_pass():
    """1000 depth-6 trees (~400 KB of fp16 records) do not fit one block.
    Serving batches (pairs) take passes as large as fit, two here; the
    rows mapping takes passes small enough for four blocks an SM, counted
    with each block's static and reserved shared memory."""
    limit, per_block = H100["smem_limit"], 16 + 1024
    for R in (1, 256):
        p = predict_lut_cuda.plan_launch(R, 1000, 6, 28, "float16", 1,
                                         **H100)
        assert p.pairs and 500 <= p.sub < 1000 and p.smem <= limit
        # Each such block takes an SM: the batch fills at most the card.
        assert p.blocks <= H100["sm_count"]
    p = predict_lut_cuda.plan_launch(1_000_000, 1000, 6, 28, "float16", 1,
                                     **H100)
    assert not p.pairs and p.sub == 107
    assert 4 * (p.smem + per_block) <= limit + 1024
    # Wide rows leave a quarter too little: passes of one tree chunk.
    p = predict_lut_cuda.plan_launch(1_000_000, 1000, 6, 200, "float16", 1,
                                     **H100)
    assert p.sub == predict_lut_cuda.MIN_PASS_TREES


@pytest.mark.parametrize("C", [1, 3, 7, 32])
@pytest.mark.parametrize("F,T,depth", [(28, 100, 6), (7, 13, 3),
                                       (300, 1000, 8), (1, 0, 1)])
def test_plan_covers_every_row_within_the_card(C, F, T, depth):
    """Any batch: every row in exactly one block, one summing thread a
    (row, class), at least one tree a pass, within shared memory; the
    rows mapping from a block of 512 rows an SM on."""
    for leaf_dtype in LEAF_DTYPES:
        rows_from = None
        for R in (1, 2, 31, 255, 256, 257, 1000, 67_583, 67_584, 135_169,
                  270_336, 1_000_000):
            p = predict_lut_cuda.plan_launch(R, T, depth, F, leaf_dtype, C,
                                             **H100)
            assert p.blocks * p.rows >= R > (p.blocks - 1) * p.rows
            assert p.sub >= 1 and p.smem <= H100["smem_limit"]
            if p.pairs:
                assert rows_from is None    # no switch back
                assert p.rows * C <= predict_lut_cuda.THREADS
                assert p.rows >= 1
            else:
                assert p.rows in (256, 512)
                rows_from = R if rows_from is None else rows_from
        assert rows_from == 67_584          # a block of 512 rows an SM


def _higgs_like(trees=100, leaf_zero_tail=0):
    """A port ensemble at the Higgs shape (28 features, depth 6, 255 bins),
    `trees` trees with random leaves; the last `leaf_zero_tail` real trees
    get all-zero leaves."""
    ens = _port(_rand_ens(trees=trees, depth=6, features=28, bins=255))
    ens.leaf_value[trees - leaf_zero_tail:] = 0.0
    return ens


def _records(tables, leaf_dtype):
    if leaf_dtype == "int4":
        p = tables.pack_int4()
        ops, thr_packed = p.ops, p.thr_packed
    else:
        ops, thr_packed = predict_lut.lut_device_operands(tables), False
    ops = tuple(torch.from_numpy(a) for a in ops)
    rec = predict_lut_cuda.pack_records(
        ops, leaf_dtype=leaf_dtype, thr_packed=thr_packed,
        max_depth=tables.max_depth, tree_chunk=tables.tree_chunk,
        use_missing=tables.eff_dl is not None,
        use_cat=tables.eff_cat is not None)
    return ops, rec


def _unpack_records(records, max_depth, leaf_dtype) -> dict:
    """csrc/lut.cu's record layout read back field by field: feature,
    threshold (stored + 1), dl and cat per node, class, scale, and the leaves' integer
    codes (fp16 bits, int8, or int4 nibbles as 0-15), each [n_trees, .]."""
    n_int = (1 << max_depth) - 1
    n_leaf = 1 << max_depth
    rec = records.rec.numpy()
    head = np.ascontiguousarray(rec[:, :4 * (n_int + 2)]).view(np.int32)
    w = head[:, :n_int]
    lb = np.ascontiguousarray(rec[:, 4 * (n_int + 2):])
    if leaf_dtype == "float16":
        codes = np.ascontiguousarray(lb[:, :2 * n_leaf]).view(np.int16)
    elif leaf_dtype == "int8":
        codes = lb[:, :n_leaf].view(np.int8)
    else:
        b = lb[:, :(n_leaf + 1) // 2].astype(np.int32)
        codes = np.stack([b & 15, b >> 4], axis=2).reshape(
            len(rec), -1)[:, :n_leaf]
    return {"feature": w >> 16, "threshold": (w & 0x1FF) - 1,
            "dl": (w >> 9) & 1, "cat": (w >> 10) & 1, "cls": head[:, n_int],
            "scale": np.ascontiguousarray(head[:, n_int + 1]).view(
                np.float32), "leaf": codes}


@pytest.mark.parametrize("leaf_dtype", LEAF_DTYPES)
def test_trailing_zero_trees_are_the_padding(leaf_dtype):
    """CompiledEnsemble pads 100 trees to 128 with zero leaves: exactly
    those 28 are left out of the records; a real tree with zero leaves at
    the end goes too (it adds +0.0), one in the middle stays."""
    ce = _higgs_like().compile(tree_chunk=64)
    assert ce.n_trees_padded == 128
    _, rec = _records(ce.quantize(leaf_dtype), leaf_dtype)
    assert rec.n_trees == 100
    assert tuple(rec.rec.shape) == (
        100, predict_lut_cuda.record_bytes(6, leaf_dtype))
    _, rec = _records(_higgs_like(leaf_zero_tail=3).compile(
        tree_chunk=64).quantize(leaf_dtype), leaf_dtype)
    assert rec.n_trees == 97
    ens = _higgs_like()
    ens.leaf_value[50] = 0.0
    _, rec = _records(ens.compile(tree_chunk=64).quantize(leaf_dtype),
                      leaf_dtype)
    assert rec.n_trees == 100


@pytest.mark.parametrize("leaf_dtype", LEAF_DTYPES)
@pytest.mark.parametrize("variant,bins", VARIANTS)
def test_records_hold_the_tables_tree_major(variant, bins, leaf_dtype):
    """Every field of the packed records, decoded back, is the quantized
    tables' own: feature, threshold (recentred or nibble-decoded, 256 for
    the nibble sentinel), default-left, categorical gated on feature >= 0,
    class, scale and the leaves' codes."""
    t = _port(_rand_ens(bins=bins, **variant)).compile(
        tree_chunk=8).quantize(leaf_dtype)
    _, rec = _records(t, leaf_dtype)
    u = _unpack_records(rec, t.max_depth, leaf_dtype)
    n, D = rec.n_trees, t.max_depth
    n_int = (1 << D) - 1
    feat = t.eff_feat[:n, :n_int]
    np.testing.assert_array_equal(u["feature"], feat)
    thr = t.thr_i8[:n, :n_int].astype(np.int32) + 128
    if leaf_dtype == "int4" and t.pack_int4().thr_packed:
        thr = np.where(thr >= 255, 256, thr)
    np.testing.assert_array_equal(u["threshold"], thr)
    dl = (np.zeros_like(feat) if t.eff_dl is None
          else t.eff_dl[:n, :n_int].astype(np.int32))
    np.testing.assert_array_equal(u["dl"], dl)
    cat = (np.zeros_like(feat) if t.eff_cat is None
           else (t.eff_cat[:n, :n_int] & (feat >= 0)).astype(np.int32))
    np.testing.assert_array_equal(u["cat"], cat)
    np.testing.assert_array_equal(u["cls"], t.cls_oh[:n].argmax(axis=1))
    np.testing.assert_array_equal(
        u["scale"], np.ones(n, np.float32) if t.leaf_scale is None
        else t.leaf_scale[:n])
    if leaf_dtype == "float16":
        np.testing.assert_array_equal(u["leaf"], t.leaf_q[:n].view(np.int16))
    else:
        np.testing.assert_array_equal(
            u["leaf"], t.leaf_q[:n] & (0xF if leaf_dtype == "int4" else -1))


def _walk_records(rec, Xb, *, max_depth, leaf_dtype, tree_chunk, n_classes,
                  learning_rate, base, missing_bin_value, use_missing):
    """csrc/lut.cu's descent and sum over packed records, in numpy f32: a
    word per level, node = 2 node + 1 + go, the leaf decoded at its width,
    class sums tree by tree, acc += chunk sum, base + lr * acc."""
    u = _unpack_records(rec, max_depth, leaf_dtype)
    f32 = np.float32
    n_int = (1 << max_depth) - 1
    mbv = missing_bin_value if use_missing else -1
    R = Xb.shape[0]
    rows = np.arange(R)
    acc = np.zeros((R, n_classes), f32)
    cs = np.zeros((R, n_classes), f32)
    for t in range(rec.n_trees):
        if t and t % tree_chunk == 0:
            acc, cs = (acc + cs).astype(f32), np.zeros_like(cs)
        node = np.zeros(R, np.int64)
        for _ in range(max_depth):
            f, th = u["feature"][t, node], u["threshold"][t, node]
            v = np.where(f >= 0, Xb[rows, np.maximum(f, 0)], 0).astype(
                np.int64)
            go = np.where(u["cat"][t, node] == 1, v != th, v > th)
            go = np.where(v == mbv, u["dl"][t, node] == 0, go)
            node = 2 * node + np.where(go, 2, 1)
        code = u["leaf"][t, node - n_int]
        if leaf_dtype == "float16":
            val = code.astype(np.int16).view(np.float16).astype(f32)
        else:
            q = code.astype(np.int64)
            if leaf_dtype == "int4":
                q = np.where(q >= 8, q - 16, q)
            val = q.astype(f32) * f32(u["scale"][t])
        c = int(u["cls"][t])
        cs[:, c] = cs[:, c] + val
    return f32(base) + f32(learning_rate) * (acc + cs)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "random"])
@pytest.mark.parametrize("leaf_dtype", LEAF_DTYPES)
@pytest.mark.parametrize("variant,bins", VARIANTS)
def test_records_walked_as_the_kernel_equal_the_reference(variant, bins,
                                                          leaf_dtype, exact):
    """The records, walked as the kernel walks them (trailing zero trees
    left out), equal the port's plain version bitwise on any model (the
    same tree-order sums), and on exact-grid models the reference's
    interpret-mode Pallas kernel too."""
    missing = variant.get("missing", False)
    ens = _rand_ens(bins=bins, exact_grid=exact,
                    qmax=127 if leaf_dtype == "int8" else 7, **variant)
    Xb = _rows(ens, bins=bins, missing=missing)
    got_plain, want, t = _scores(ens, leaf_dtype, Xb)
    ops, rec = _records(t, leaf_dtype)
    walked = _walk_records(
        rec, Xb, max_depth=t.max_depth, leaf_dtype=leaf_dtype,
        tree_chunk=t.tree_chunk, n_classes=t.n_classes_out,
        learning_rate=t.learning_rate, base=t.base_score,
        missing_bin_value=t.missing_bin_value,
        use_missing=t.eff_dl is not None)
    if t.n_classes_out == 1:
        walked = walked[:, 0]
    np.testing.assert_array_equal(walked, got_plain)
    if exact:
        np.testing.assert_array_equal(walked, want)


def test_records_are_cached_per_operand_tuple():
    """Packed once per model: the same tuple hits the cache; a tuple
    written in place, or a new one, is packed again."""
    t = _port(_rand_ens()).compile(tree_chunk=8).quantize()
    ops = tuple(torch.from_numpy(a)
                for a in predict_lut.lut_device_operands(t))
    kw = dict(leaf_dtype="float16", thr_packed=False, max_depth=3,
              tree_chunk=8, use_missing=False, use_cat=False)
    first = predict_lut_cuda.records_for(ops, **kw)
    assert predict_lut_cuda.records_for(ops, **kw) is first
    ops[2].zero_()                      # every leaf now 0: nothing to walk
    again = predict_lut_cuda.records_for(ops, **kw)
    assert again is not first and again.n_trees == 0
    fresh = tuple(a.clone() for a in ops)
    assert predict_lut_cuda.records_for(fresh, **kw) is not again


def test_kernel_wrappers_refuse_cpu_tensors():
    t = _port(_rand_ens()).compile(tree_chunk=8).quantize()
    ops = tuple(torch.from_numpy(a)
                for a in predict_lut.lut_device_operands(t))
    kw = predict_lut.lut_static_kwargs(t)
    with pytest.raises(TypeError, match="CUDA tensor"):
        predict_lut_cuda.lut_int8_cuda(ops, torch.from_numpy(_rows(
            _rand_ens())), **kw)
    p = _port(_rand_ens(bins=13)).compile(tree_chunk=8).quantize(
        "int4").pack_int4()
    with pytest.raises(TypeError, match="CUDA tensor"):
        predict_lut_cuda.lut_int4_cuda(
            tuple(torch.from_numpy(a) for a in p.ops),
            torch.from_numpy(_rows(_rand_ens(), bins=13)),
            **p.static_kwargs())


def test_predict_impl_values():
    assert TrainConfig(predict_impl="lut4").predict_impl == "lut4"
    for bad in ("pallas", "onehot", "int8"):
        with pytest.raises(ValueError, match="auto\\|lut\\|lut4"):
            TrainConfig(predict_impl=bad)


def test_backend_lut4_dispatch_and_fallback_ladder(monkeypatch, caplog):
    """tests/test_predict_lut4.py:283 on CUDADevice(device="cpu"):
    predict_impl='lut4' serves the packed tables; with the int4 guard
    refusing the int8 tier serves, and with both refusing f32 serves
    exactly; each step warns and resolved_predict_impl reports it."""
    ens = _port(_rand_ens(trees=8, bins=13))
    Xb = _rows(ens, rows=33, bins=13)
    ce = ens.compile()
    be_f32 = CUDADevice(TrainConfig(device="cpu", n_bins=13))
    want = be_f32.predict_raw(ens, Xb)
    assert be_f32.resolved_predict_impl(ce.token) == "f32"
    be_l4 = CUDADevice(TrainConfig(device="cpu", n_bins=13,
                                   predict_impl="lut4"))
    assert be_l4.resolved_predict_impl(ce.token) == "f32"   # not scored
    got = be_l4.predict_raw(ens, Xb)
    assert be_l4.resolved_predict_impl(ce.token) == "lut4"
    bound = ce.quantize(leaf_dtype="int4").max_abs_err
    assert float(np.abs(got - want).max()) <= bound * (1 + 1e-5) + 1e-6
    np.testing.assert_array_equal(
        got, predict_lut.predict_effective_lut4(
            ce.quantize(leaf_dtype="int4"), Xb).numpy())

    monkeypatch.setattr(predict_lut, "predict_lut4_fits",
                        lambda *a, **k: False)
    be_l8 = CUDADevice(TrainConfig(device="cpu", n_bins=13,
                                   predict_impl="lut4"))
    with caplog.at_level(logging.WARNING):
        got8 = be_l8.predict_raw(ens, Xb)
    assert "int8 LUT tier" in caplog.text
    assert be_l8.resolved_predict_impl(ce.token) == "lut"
    np.testing.assert_array_equal(
        got8, predict_lut.predict_effective_lut(ce.quantize(), Xb).numpy())

    monkeypatch.setattr(predict_lut, "predict_lut_fits",
                        lambda *a, **k: False)
    caplog.clear()
    be_ff = CUDADevice(TrainConfig(device="cpu", n_bins=13,
                                   predict_impl="lut4"))
    with caplog.at_level(logging.WARNING):
        np.testing.assert_array_equal(be_ff.predict_raw(ens, Xb), want)
    assert "f32 path" in caplog.text
    assert be_ff.resolved_predict_impl(ce.token) == "f32"


def test_api_predict_takes_a_bundle_and_a_tier():
    from ddt_tpu_torch.data.quantizer import fit_bin_mapper

    rng = np.random.default_rng(0)
    X = rng.standard_normal((300, 7)).astype(np.float32)
    mapper = fit_bin_mapper(X, n_bins=13)
    ens = _port(_rand_ens(bins=13))
    bundle = tapi.ModelBundle(ensemble=ens, mapper=mapper)
    Xb = mapper.transform(X)
    for impl, want in (
            ("auto", ens.predict_raw(Xb, binned=True)),
            ("lut4", predict_lut.predict_effective_lut4(
                ens.compile().quantize("int4"), Xb).numpy())):
        got = tapi.predict(bundle, X, raw=True,
                           cfg=TrainConfig(device="cpu", predict_impl=impl))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    bad = tapi.ModelBundle(ensemble=ens, mapper=fit_bin_mapper(
        X, n_bins=13, missing_policy="learn"))
    with pytest.raises(ValueError, match="missing_bin"):
        tapi.predict(bad, X, device="cpu")


def test_validate_mapper_model_refuses_non_identity_categorical():
    from ddt_tpu_torch.data.quantizer import fit_bin_mapper

    rng = np.random.default_rng(1)
    X = rng.integers(0, 10, size=(400, 7)).astype(np.float32)
    ens = _port(_rand_ens(bins=13, cat=(1, 4)))
    tapi.validate_mapper_model(
        fit_bin_mapper(X, n_bins=13, cat_features=(1, 4)), ens)
    quantile = fit_bin_mapper(X, n_bins=13)
    assert quantile.non_identity_columns((4, 1)) == [1, 4]
    with pytest.raises(ValueError, match="identity-bin"):
        tapi.validate_mapper_model(quantile, ens)
    with pytest.raises(ValueError, match="out of range"):
        quantile.non_identity_columns((9,))


# --------------------------------------------------------------------- #
# BASELINE config 5's width (1024 features, depth 6) on the quantized
# tiers: the pairs mapping takes the rows a block of one row a thread
# cannot hold, so K4 and K5 serve the shape the reference's guards admit
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("leaf_dtype", ["float16", "int8", "int4"])
def test_plan_launch_at_config5_width_gives_a_plan(leaf_dtype):
    limit = predict_lut_cuda.SMEM_LIMIT_H100
    for R in (1, 256, 67_584, 1_000_000):
        p = predict_lut_cuda.plan_launch(R, 64, 6, 1024, leaf_dtype, 1,
                                         limit, 132)
        assert p.pairs and p.sub >= 1 and p.smem <= limit
        assert p.blocks * p.rows >= R > (p.blocks - 1) * p.rows


@pytest.mark.parametrize("impl", ["lut", "lut4"])
@pytest.mark.parametrize("features,depth", [(1024, 6), (28, 6), (1024, 7)])
def test_resolved_tier_equals_reference_guards(impl, features, depth):
    """The backend's ladder picks the tier the reference's fits guards
    pick for the same model shape. (Past these shapes the two guards
    count different machines: at depth 8 the reference's TPU working set
    refuses 1024 features, which the card's shared memory still serves.)"""
    ens = _port(_rand_ens(seed=5, trees=64, depth=depth, features=features,
                          bins=255))
    ce = ens.compile(tree_chunk=64)
    shape = (ce.n_trees_padded, ce.tree_chunk, ce.max_depth, features,
             ce.n_classes_out)
    want = ("lut4" if impl == "lut4" and jlut.predict_lut4_fits(*shape)
            else "lut" if jlut.predict_lut_fits(*shape) else "f32")
    be = CUDADevice(TrainConfig(device="cpu", n_bins=255,
                                predict_impl=impl))
    X = np.random.default_rng(5).integers(0, 255, size=(8, features),
                                          dtype=np.uint8)
    be.predict_raw(ens, X)
    assert be.resolved_predict_impl(ce.token) == want
    assert want != "f32" or features != 1024 or depth != 6
