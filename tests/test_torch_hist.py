"""The port's plain histogram against ddt_tpu's on the CPU, and the CUDA
kernel's host-side planning (tiling, grid) that the CPU can check.

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


@pytest.mark.parametrize("N,F,B", [
    (1, 28, 255), (2, 28, 255), (16, 28, 255), (32, 28, 255),
    (32, 28, 128), (32, 28, 64), (64, 54, 255), (4, 120, 256),
    (512, 28, 255), (3, 1000, 256),
])
def test_plan_tiles_covers_and_fits(N, F, B):
    p = hist_cuda.plan_tiles(N, F, B, H100_SMEM)
    assert p.smem_bytes == p.nr * p.fs * B * 8 <= H100_SMEM
    assert p.n_slabs * p.fs >= F > (p.n_slabs - 1) * p.fs
    assert p.n_ranges * p.nr >= N > (p.n_ranges - 1) * p.nr
    if F * B * 8 <= H100_SMEM:
        assert p.n_slabs == 1           # whole rows per node when they fit


def test_plan_tiles_main_path_shapes():
    # Level 0 runs in one tile; level 5 (32 nodes) in 8 node ranges.
    assert hist_cuda.plan_tiles(1, 28, 255, H100_SMEM).tiles == 1
    p = hist_cuda.plan_tiles(32, 28, 255, H100_SMEM)
    assert (p.fs, p.nr, p.tiles) == (28, 4, 8)


def test_plan_tiles_raises_when_one_cell_row_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        hist_cuda.plan_tiles(1, 28, 255, 1000)


@pytest.mark.parametrize("R,tiles,fs", [
    (1_000_000, 1, 28), (1_000_000, 8, 28), (5, 1, 3), (10_000_000, 4, 28),
    (3_000_000_000, 1, 28),
])
def test_grid_rows(R, tiles, fs):
    bx, rpb = hist_cuda.grid_rows(R, tiles, 132, fs)
    assert bx >= 1 and bx * rpb >= R > (bx - 1) * rpb
    assert rpb * fs < 2 ** 31
