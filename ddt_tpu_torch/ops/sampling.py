"""Stateless counter-based sampling masks and uniforms.

Port of ddt_tpu/ops/sampling.py, whole. Bagging (cfg.subsample) keeps a
row in a boosting round by a pure function of (seed, round, global row
id), and the quantized-gradient stochastic rounding (ops/grad.py) draws
its uniforms from the same hash with a salted seed. No RNG stream is
carried: every path computes the identical bit for a row.

Hash: the 'lowbias32' integer finalizer applied to the row id's two
32-bit words, keyed per (seed, round). The top 24 bits form the uniform,
exact in f32, so the `< subsample` compare is exact on every device.

Two twins:

- the numpy half (`_mix32_host`, `round_key`, `_mix32_np`, `uniform_np`,
  `row_keep_np`, `colsample_mask`), copied from the reference verbatim;
- the tensor twin `uniform` / `row_keep`, which runs on any device and
  equals `uniform_np` bit for bit. PyTorch's uint32 has few operations,
  so the twin carries 32-bit words in int64 and multiplies by 16-bit
  halves of the constant: no product reaches 2^63, so nothing relies on
  signed wraparound, and every step is masked back to 32 bits. Row ids
  are int64 (bases below 2^63; the numpy twin takes uint64).

colsample_bytree stays host-drawn (`colsample_mask`): its [F] masks are
a few bytes, and this is the one home of the degenerate-draw rescue.
"""

from __future__ import annotations

import numpy as np
import torch

_M1 = 0x7FEB352D
_M2 = 0x846CA68B
_GOLD = 0x9E3779B9
_KEY2 = 0x85EBCA6B
_MASK32 = 0xFFFFFFFF


def _mix32_host(x: int) -> int:
    """lowbias32 on a python int (mod 2^32) — the scalar key path."""
    x &= 0xFFFFFFFF
    x ^= x >> 16
    x = (x * _M1) & 0xFFFFFFFF
    x ^= x >> 15
    x = (x * _M2) & 0xFFFFFFFF
    x ^= x >> 16
    return x


def round_key(seed: int, rnd: int) -> int:
    """Per-(seed, round) 32-bit key, computed with python ints so both
    twins (and any future one) can reproduce it exactly."""
    k = _mix32_host((seed & 0xFFFFFFFF) ^ _GOLD)
    return _mix32_host(k ^ ((rnd * _KEY2) & 0xFFFFFFFF))


def _mix32_np(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x = x * np.uint32(_M1)
    x ^= x >> np.uint32(15)
    x = x * np.uint32(_M2)
    x ^= x >> np.uint32(16)
    return x


def uniform_np(seed: int, rnd: int, row_start: int, n: int) -> np.ndarray:
    """f32 [n] uniforms in [0, 1) for global rows [row_start, row_start
    + n) — the generic counter-hash draw behind row_keep_np, exposed so
    other per-(seed, round, row) randomness (the grad-quant stochastic
    rounding, ops/grad.py — which salts the seed per channel) shares the
    one hash and its 24-bit-exact-in-f32 property. Strictly < 1 (the top
    24 bits over 2^-24), so floor(x + u) of an on-grid x never rounds."""
    ids = np.arange(row_start, row_start + n, dtype=np.uint64)
    lo = (ids & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (ids >> np.uint64(32)).astype(np.uint32)
    key = np.uint32(round_key(seed, rnd))
    bits = _mix32_np(lo ^ _mix32_np(hi ^ key))
    return (bits >> np.uint32(8)).astype(np.float32) * np.float32(2.0 ** -24)


def row_keep_np(seed: int, rnd: int, row_start: int, n: int,
                subsample: float) -> np.ndarray:
    """bool [n]: keep bits for global rows [row_start, row_start + n)."""
    return uniform_np(seed, rnd, row_start, n) < np.float32(subsample)


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x * m) mod 2^32 for int64 x in [0, 2^32): the constant's 16-bit
    halves keep every product below 2^48."""
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 on int64 words in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 15)
    x = _mul32(x, _M2)
    return x ^ (x >> 16)


def uniform(seed: int, rnd: int, row_start: int, n: int,
            device="cpu") -> torch.Tensor:
    """f32 [n] uniforms in [0, 1) on `device` for global rows
    [row_start, row_start + n): the tensor twin of uniform_np, bit for
    bit (the reference's uniform_jax in PyTorch). 0 <= row_start and
    row_start + n <= 2^63."""
    ids = torch.arange(n, dtype=torch.int64, device=device) + row_start
    lo = ids & _MASK32
    key = round_key(seed, rnd)
    if row_start >> 32 == (row_start + max(n, 1) - 1) >> 32:
        # One high word for the whole range: its hash is a host constant.
        inner = _mix32_host((row_start >> 32) ^ key)
    else:
        inner = _mix32((ids >> 32) ^ key)
    bits = _mix32(lo ^ inner)
    # < 2^24: exact in f32, and so is the power-of-two multiply.
    return (bits >> 8).to(torch.float32) * (2.0 ** -24)


def row_keep(seed: int, rnd: int, row_start: int, n: int, subsample: float,
             device="cpu") -> torch.Tensor:
    """bool [n] on `device`: the tensor twin of row_keep_np."""
    # The f32 threshold as an exact python float: the compare runs in f32.
    return uniform(seed, rnd, row_start, n, device) \
        < float(np.float32(subsample))


def colsample_mask(seed: int, rnd: int, c: int, F: int,
                   colsample_bytree: float) -> np.ndarray:
    """The per-(seed, round, class) colsample feature mask — ONE home for
    the rng tuple and the degenerate-draw rescue, because the fused ==
    granular == streamed ensemble-parity guarantee depends on every path
    drawing bit-identical masks."""
    m = (np.random.default_rng(
        (seed, 104729, rnd, c)).random(F) < colsample_bytree)
    if not m.any():                 # degenerate draw: keep 1 feature
        m[rnd % F] = True
    return m
