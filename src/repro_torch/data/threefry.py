"""Counter-based Threefry-2x32 in numpy uint32: the generator behind
`jax.random`, as jax 0.9.0 defines it with `jax_threefry_partitionable`
True (its default): a key is two uint32 words, `split` and the random bits
of a shape hash the 64-bit flat index (hi, lo) of each element under the
key, and 32-bit bits are the two output words xor-ed.

The port keeps its own copy so that the data pipeline and the launcher's
initial weights are the reference's for the same seed, with nothing of JAX
imported: `uniform` and `bernoulli` give the same bits; `normal` goes
through float32 `erfinv`, which differs from XLA's by a few ulps.
"""

from __future__ import annotations

import numpy as np
import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _u32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.uint32).reshape(-1)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """20 rounds of Threefry-2x32 of the counter words (x0, x1) under `key`
    [2] uint32 -> the two output words (uint32 arrays; arithmetic wraps)."""
    k0, k1 = _u32(key[0]), _u32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(_PARITY))
    x0 = _u32(x0) + ks[0]
    x1 = _u32(x1) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def PRNGKey(seed: int) -> np.ndarray:  # noqa: N802 (the reference's name)
    """`jax.random.PRNGKey(seed)` without x64: the seed as int32, its high
    word 0, its low word the seed's bits."""
    s = int(np.int64(seed).astype(np.int32))
    return np.array([0, s & 0xFFFFFFFF], dtype=np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """`jax.random.fold_in`: the key hashed with the counter (0, data)."""
    y0, y1 = threefry2x32(key, 0, int(data) & 0xFFFFFFFF)
    return np.concatenate([y0, y1])


def _flat_counter(n: int):
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(np.uint32), (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """`jax.random.split`: key i is the hash of the counter (hi(i), lo(i))."""
    y0, y1 = threefry2x32(key, *_flat_counter(num))
    return np.stack([y0, y1], axis=1)


def random_bits(key: np.ndarray, shape: tuple) -> np.ndarray:
    """32 random bits per element of `shape` (row-major flat index as the
    counter), the two output words xor-ed."""
    n = int(np.prod(shape, dtype=np.int64))
    y0, y1 = threefry2x32(key, *_flat_counter(n))
    return (y0 ^ y1).reshape(shape)


def uniform(key: np.ndarray, shape: tuple, minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """`jax.random.uniform` in float32: 23 random mantissa bits under the
    exponent of 1.0, minus 1, scaled to [minval, maxval)."""
    bits = random_bits(key, shape)
    one = np.array(1.0, np.float32).view(np.uint32)
    floats = ((bits >> np.uint32(9)) | one).view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo)


def bernoulli(key: np.ndarray, p: float, shape: tuple) -> np.ndarray:
    """`jax.random.bernoulli`: uniform(key, shape) < p in float32."""
    return uniform(key, shape) < np.float32(p)


def normal(key: np.ndarray, shape: tuple) -> np.ndarray:
    """`jax.random.normal` in float32: sqrt(2) · erfinv(u) with u uniform
    on [nextafter(-1, 0), 1). u is the reference's bit for bit; erfinv is
    torch's float32 one, a few ulps from XLA's."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    u = uniform(key, shape, lo, 1.0)
    return (np.float32(np.sqrt(2)) * torch.erfinv(torch.from_numpy(u)).numpy()).astype(np.float32)
