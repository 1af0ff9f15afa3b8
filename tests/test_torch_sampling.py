"""The port's counter hashes (ddt_tpu_torch/ops/sampling.py) against
ddt_tpu.ops.sampling on the CPU, bit for bit.

The numpy half is a verbatim copy and must give the reference's bits; the
tensor twin (`uniform`, `row_keep`) carries 32-bit words in int64 and must
equal both reference twins (uniform_np and uniform_jax) for row ids that
cross 2^31 and 2^32 and for 64-bit row bases.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddt_tpu.ops import sampling as ref
from ddt_tpu_torch.ops import sampling

CASES = [
    # seed, round, row_start, n
    (0, 0, 0, 1000),
    (11, 5, 0, 4097),
    (7, 3, 2 ** 31 - 300, 600),                 # crosses 2^31
    (9, 2, (1 << 33) + 0xFFFFFF00, 700),        # a lo-word carry
    (3, 1, 2 ** 32 - 64, 64),                   # ends just below 2^32
    (2 ** 40 + 3, 99, 2 ** 32 - 5, 10),         # seed wider than 32 bits
    (-1, 7, 2 ** 62, 257),                      # negative seed, huge base
]


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("seed,rnd,start,n", CASES)
def test_uniform_twin_equals_reference_np(seed, rnd, start, n):
    want = ref.uniform_np(seed, rnd, start, n)
    got = sampling.uniform(seed, rnd, start, n)
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # The numpy half is the reference's own copy.
    np.testing.assert_array_equal(
        _bits(sampling.uniform_np(seed, rnd, start, n)), _bits(want))
    assert float(got.max()) < 1.0 and float(got.min()) >= 0.0


@pytest.mark.parametrize("seed,rnd,start,n", CASES[:5])
def test_uniform_twin_equals_reference_jax(seed, rnd, start, n):
    want = ref.uniform_jax(jnp.int32(rnd), jnp.int32(0), n, seed=seed,
                           row_start_lo=jnp.uint32(start & 0xFFFFFFFF),
                           row_start_hi=jnp.uint32(start >> 32))
    got = sampling.uniform(seed, rnd, start, n)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_mul32_keeps_the_low_bits_near_two_to_the_32():
    """(x * m) mod 2^32 from the 16-bit halves equals the uint32 product,
    for words at the top of the range where x * m exceeds 2^63."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        np.arange(2 ** 32 - 4096, 2 ** 32, dtype=np.uint64),
        rng.integers(0, 2 ** 32, size=20_000, dtype=np.uint64),
        np.array([0, 1, 2 ** 31 - 1, 2 ** 31, 0xFFFF, 0x10000],
                 dtype=np.uint64)])
    for m in (sampling._M1, sampling._M2, 0xFFFFFFFF):
        want = (x.astype(np.uint32) * np.uint32(m)).astype(np.int64)
        got = sampling._mul32(torch.from_numpy(x.astype(np.int64)), m)
        np.testing.assert_array_equal(got.numpy(), want)
        if m >= 2 ** 31:
            assert int(x.max()) * m > 2 ** 63      # plain int64 would wrap
    want = ref._mix32_np(x.astype(np.uint32)).astype(np.int64)
    got = sampling._mix32(torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("subsample", [0.5, 0.8, 0.999, 1e-3])
def test_row_keep_twins_equal_reference(subsample):
    n, start = 5000, (1 << 32) - 2500
    want = ref.row_keep_np(4, 6, start, n, subsample)
    np.testing.assert_array_equal(
        sampling.row_keep(4, 6, start, n, subsample).numpy(), want)
    np.testing.assert_array_equal(
        sampling.row_keep_np(4, 6, start, n, subsample), want)
    assert sampling.row_keep(4, 6, 0, 10, subsample).dtype == torch.bool


def test_row_keep_matches_reference_jax_mask():
    want = np.asarray(ref.row_keep_jax(jnp.int32(3), jnp.int32(0), 4096,
                                       seed=17, subsample=0.7))
    got = sampling.row_keep(17, 3, 0, 4096, 0.7).numpy()
    np.testing.assert_array_equal(got.astype(np.float32), want)


@pytest.mark.parametrize("seed,rnd", [(0, 0), (1, 7), (2 ** 33, 2 ** 20),
                                      (-5, 3)])
def test_round_key_equals_reference(seed, rnd):
    assert sampling.round_key(seed, rnd) == ref.round_key(seed, rnd)


@pytest.mark.parametrize("seed,rnd,c,F,frac", [
    (0, 0, 0, 28, 0.8), (3, 11, 0, 28, 0.5), (5, 2, 1, 7, 0.9),
    (1, 4, 0, 3, 1e-9),     # degenerate draw: the rescue keeps rnd % F
    (2, 5, 0, 1, 1e-9),
])
def test_colsample_mask_equals_reference(seed, rnd, c, F, frac):
    want = ref.colsample_mask(seed, rnd, c, F, frac)
    got = sampling.colsample_mask(seed, rnd, c, F, frac)
    np.testing.assert_array_equal(got, want)
    assert got.any()
    if frac < 1e-6:
        assert got.sum() == 1 and got[rnd % F]


def test_uniform_on_a_device_tensor_keeps_its_device():
    u = sampling.uniform(1, 2, 3, 8, device=torch.device("cpu"))
    assert u.device.type == "cpu"
    assert sampling.row_keep(1, 2, 3, 8, 0.5, device="cpu").shape == (8,)
