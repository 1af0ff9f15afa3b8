"""The port's plain histogram against ddt_tpu's on the CPU, and the CUDA
kernel's host-side planning (tiling, grid) and its warp queue's slot
arithmetic (a model of csrc/hist.cu's walk) that the CPU can check.

The plain version (ops/histogram.build_histograms_segment, index_add_
over node*B + bin keys) is held to the reference's Pallas kernel run in
interpret mode with f32 inputs and to its segment_sum path at 255, 128
and 64 bins with frozen rows and ragged row counts. Tolerance
rtol = atol = 1e-5: the same f32 sums in another order (the MXU-order
contraction of the Pallas form; the CPU scatter order of segment_sum).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddt_tpu.ops.hist_pallas import build_histograms_pallas
from ddt_tpu.ops.histogram import build_histograms_segment as j_segment
from ddt_tpu_torch.ops import hist_cuda, histogram

#: The H100's opt-in shared memory per block (cudaDevAttrMaxShared-
#: MemoryPerBlockOptin): the plan the card actually runs.
H100_SMEM = 232_448


def _case(R, F, B, N, seed=0, frozen=0.2):
    rng = np.random.default_rng(seed)
    Xb = rng.integers(0, B, size=(R, F), dtype=np.uint8)
    g = rng.standard_normal(R).astype(np.float32)
    h = rng.random(R).astype(np.float32)
    ni = rng.integers(0, N, size=R).astype(np.int32)
    ni[rng.random(R) < frozen] = -1
    return Xb, g, h, ni


def _plain(Xb, g, h, ni, N, B):
    return histogram.build_histograms_segment(
        *(torch.from_numpy(a) for a in (Xb, g, h, ni)), N, B).numpy()


@pytest.mark.parametrize("R,F,B,N", [
    (1000, 4, 255, 4),      # 255 bins: K1's regime
    (777, 3, 128, 8),       # ragged rows, 128 bins: K2's regime
    (1024, 4, 64, 2),       # 64 bins: K2's padded-64 layout
    (513, 2, 255, 1),       # root level
])
def test_plain_matches_reference_pallas_f32(R, F, B, N):
    Xb, g, h, ni = _case(R, F, B, N)
    want = np.asarray(build_histograms_pallas(
        Xb, g, h, ni, N, B, tile_r=256, interpret=True,
        input_dtype=jnp.float32))
    got = _plain(Xb, g, h, ni, N, B)
    assert got.shape == want.shape == (N, F, B, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("R,F,B,N", [
    (3000, 6, 255, 8), (2049, 5, 128, 32), (999, 7, 64, 16),
    (64, 3, 255, 1),
])
def test_plain_matches_reference_segment(R, F, B, N):
    Xb, g, h, ni = _case(R, F, B, N, seed=1)
    want = np.asarray(j_segment(Xb, g, h, ni, N, B))
    got = _plain(Xb, g, h, ni, N, B)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # Mass conservation per node.
    for n in range(N):
        np.testing.assert_allclose(got[n, 0, :, 0].sum(),
                                   g[ni == n].sum(), rtol=1e-4, atol=1e-4)


def test_plain_all_frozen_is_zero():
    Xb, g, h, ni = _case(300, 3, 16, 4)
    ni[:] = -1
    assert not _plain(Xb, g, h, ni, 4, 16).any()


def test_dispatch_takes_plain_on_cpu_and_kernel_refuses_cpu():
    Xb, g, h, ni = _case(200, 3, 31, 2)
    args = [torch.from_numpy(a) for a in (Xb, g, h, ni)]
    before = hist_cuda.launches
    got = histogram.build_histograms(*args, 2, 31)
    assert hist_cuda.launches == before
    np.testing.assert_array_equal(
        got.numpy(), histogram.build_histograms_segment(*args, 2, 31).numpy())
    with pytest.raises(TypeError, match="CUDA tensor"):
        hist_cuda.build_histograms_cuda(*args, 2, 31)


def _block_tiles(p, N, F):
    """(first node, nodes, first feature, features) of every grid row, by
    the kernel's own index math (csrc/hist.cu): y = range * n_slabs +
    slab."""
    out = []
    for y in range(p.tiles):
        slab, rng = y % p.n_slabs, y // p.n_slabs
        f0, n0 = slab * p.fs, rng * p.nr
        out.append((n0, min(p.nr, N - n0), f0, min(p.fs, F - f0)))
    return out


def _assert_covers_once(p, N, F, B, smem):
    assert p.smem_bytes == p.nr * p.fs * B * 8 <= smem
    seen = np.zeros((N, F), np.int64)
    for n0, nw, f0, fw in _block_tiles(p, N, F):
        assert nw >= 1 and fw >= 1 and nw * fw * B * 8 <= p.smem_bytes
        seen[n0:n0 + nw, f0:f0 + fw] += 1
    assert (seen == 1).all()


PLAN_SHAPES = [
    (1, 28, 255), (2, 28, 255), (4, 28, 255), (8, 28, 255), (16, 28, 255),
    (32, 28, 255), (64, 28, 255), (32, 28, 128), (32, 28, 64),
    (32, 28, 63), (64, 28, 64), (64, 54, 255), (4, 120, 256),
    (512, 28, 255), (3, 1000, 256), (16, 1, 255), (16, 3, 255),
    (16, 29, 255), (16, 120, 255), (8, 1000, 255), (5, 3, 1),
]


@pytest.mark.parametrize("N,F,B", PLAN_SHAPES)
def test_plan_tiles_covers_and_fits(N, F, B):
    p = hist_cuda.plan_tiles(N, F, B, H100_SMEM)
    assert p.n_slabs * p.fs >= F > (p.n_slabs - 1) * p.fs
    assert p.n_ranges * p.nr >= N > (p.n_ranges - 1) * p.nr
    if F * B * 8 <= H100_SMEM:
        assert p.n_slabs == 1           # whole rows per node when they fit
    _assert_covers_once(p, N, F, B, H100_SMEM)


@pytest.mark.parametrize("smem", [101_376, 166_912])
@pytest.mark.parametrize("N,F,B", PLAN_SHAPES[::5])
def test_plan_tiles_follows_the_cards_limit(smem, N, F, B):
    # Cards with less shared memory a block (sm_86, sm_80 opt-in limits)
    # get narrower tiles of the same cover.
    p = hist_cuda.plan_tiles(N, F, B, smem)
    _assert_covers_once(p, N, F, B, smem)
    assert p.tiles >= hist_cuda.plan_tiles(N, F, B, H100_SMEM).tiles


def test_plan_tiles_main_path_shapes():
    # One tree of the main path (255 bins, sibling subtraction) builds 1,
    # 1, 2, 4, 8, 16 nodes: 4 nodes (228,480 B) fit one block.
    for N in (1, 1, 2, 4, 8, 16):
        p = hist_cuda.plan_tiles(N, 28, 255, H100_SMEM)
        assert (p.fs, p.n_slabs) == (28, 1)
        assert (p.nr, p.n_ranges) == (min(N, 4), -(-N // 4))
    p = hist_cuda.plan_tiles(32, 28, 255, H100_SMEM)
    assert (p.fs, p.nr, p.tiles) == (28, 4, 8)
    assert hist_cuda.plan_tiles(64, 28, 255, H100_SMEM).tiles == 16
    # K2's regime: 32 nodes at 64 or 63 bins in 2 ranges of 16, at 128
    # bins in 4 of 8.
    for B in (64, 63):
        p = hist_cuda.plan_tiles(32, 28, B, H100_SMEM)
        assert (p.nr, p.tiles) == (16, 2)
    assert hist_cuda.plan_tiles(32, 28, 128, H100_SMEM).tiles == 4


def test_plan_tiles_raises_when_one_cell_row_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        hist_cuda.plan_tiles(1, 28, 255, 1000)
    with pytest.raises(ValueError, match="shared memory"):
        hist_cuda.plan_tiles(1, 1, 256, 2047)


@pytest.mark.parametrize("R,tiles,active", [
    (1_000_000, 1, 264), (1_000_000, 4, 132), (1_000_000, 8, 132),
    (5, 1, 264), (10_000_000, 9, 132), (3_000_000_000, 1, 132),
    (1_000_000, 200, 132),
])
def test_grid_blocks(R, tiles, active):
    bx = hist_cuda.grid_blocks(R, tiles, active)
    assert bx >= 1
    assert bx * tiles <= max(active, tiles)       # one wave when it fits
    assert (bx - 1) * hist_cuda.THREADS < R       # every block has rows


def _nth_set_bit(mask: int, j: int) -> int:
    """csrc/hist.cu's nth_set_bit: five halvings on popcounts."""
    pos, b = 0, 16
    while b:
        c = bin(mask & ((1 << b) - 1)).count("1")
        if j >= c:
            j, mask, pos = j - c, mask >> b, pos + b
        b >>= 1
    return pos


#: csrc/hist.cu's kRunAt: a strip with this many rows in the range runs at
#: once.
RUN_AT = 28


def _warp_queue(in_range: np.ndarray) -> tuple[list, int]:
    """One warp's walk over its 32-row strips (rows of in_range [S, 32]),
    by the kernel's queue (csrc/hist.cu, design point 1): a strip with
    RUN_AT or more rows in the range runs at once; lane L of any other
    strip fetches new row
    j = (L - count) % 32 from the mask's j-th set bit into slot L (q0) if
    L >= count, else slot L + 32 (q1); 32 pending rows run and shift q1
    down; the rest run at the end. Returns (rows added, passes)."""
    q0, q1, count, added, passes = [None] * 32, [None] * 32, 0, [], 0
    for s, strip in enumerate(in_range):
        mask = sum(1 << i for i in range(32) if strip[i])
        n = bin(mask).count("1")
        if n >= RUN_AT:
            added += [32 * s + i for i in range(32) if strip[i]]
            passes += 1
            continue
        if n == 0:
            continue
        for lane in range(32):
            j = (lane - count) % 32
            if j < n:
                row = 32 * s + _nth_set_bit(mask, j)
                if lane >= count:
                    q0[lane] = row
                else:
                    q1[lane] = row
        count += n
        if count >= 32:
            added += q0
            passes += 1
            q0, count = list(q1), count - 32
    if count:
        added += q0[:count]
        passes += 1
    return added, passes


def test_nth_set_bit_finds_each_set_bit():
    rng = np.random.default_rng(0)
    for mask in [1, 1 << 31, (1 << 32) - 1, 0x12345678,
                 *rng.integers(1, 1 << 32, size=50).tolist()]:
        bits = [i for i in range(32) if mask >> i & 1]
        assert [_nth_set_bit(mask, j) for j in range(len(bits))] == bits


@pytest.mark.parametrize("share", [0.03, 0.3, 0.7, 0.9, 0.97, 1.0])
def test_warp_queue_adds_every_row_of_the_range_once(share):
    """The queue's slot arithmetic loses and repeats no row, whatever
    share of a strip is in the range (full strips mixed in), and a warp's
    passes are its strips run at once plus ceil(other rows / 32)."""
    rng = np.random.default_rng(int(share * 100))
    in_range = rng.random((40, 32)) < share
    in_range[::7] = True
    added, passes = _warp_queue(in_range)
    want = np.flatnonzero(in_range.reshape(-1))
    assert sorted(added) == want.tolist()
    per_strip = in_range.sum(axis=1)
    now = per_strip >= RUN_AT
    queued = int(per_strip[~now].sum())
    assert passes == int(now.sum()) + -(-queued // 32)
