"""The train flips' key stream, written out plainly for the reference.

A frozen copy of the arithmetic the program draws its flips with: JAX's
threefry2x32 (20 rounds), ``PRNGKey(seed)`` with the seed's low 32 bits,
``split`` and ``fold_in`` over partitionable counts, and
``bernoulli(key, 0.5, shape)`` as ``uniform < 0.5`` on the top 23 bits of
each element's hash.  Published as Salmon et al., "Parallel random numbers:
as easy as 1, 2, 3" (SC'11); the counter layout is JAX's
``jax_threefry_partitionable`` one.  Python ints for key operations, numpy
uint32 for the bits.
"""

from __future__ import annotations

import numpy as np

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k1: int, k2: int, x1, x2):
    """The hash of the count pairs (``x1``, ``x2``) under the key words
    ``k1``, ``k2``: Python ints or uint32 arrays in, the same out."""
    scalar = np.isscalar(x1)
    if scalar:
        x1, x2 = np.uint32(x1 & _MASK), np.uint32(x2 & _MASK)
    ks = (np.uint32(k1), np.uint32(k2), np.uint32(k1 ^ k2 ^ 0x1BD11BDA))
    x = np.asarray(x1, np.uint32) + ks[0]
    y = np.asarray(x2, np.uint32) + ks[1]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x = x + y
                y = ((y << np.uint32(r)) | (y >> np.uint32(32 - r))) ^ x
            x = x + ks[(i + 1) % 3]
            y = y + ks[(i + 2) % 3] + np.uint32(i + 1)
    if scalar:
        return int(x), int(y)
    return x, y


def prng_key(seed: int) -> tuple:
    """(high word 0, the seed's low 32 bits)."""
    return 0, int(seed) & _MASK


def split(key) -> list:
    """Two keys: key i is the hash of the 64-bit count i."""
    return [threefry2x32(key[0], key[1], 0, i) for i in range(2)]


def fold_in(key, data: int) -> tuple:
    return threefry2x32(key[0], key[1], 0, int(data) & _MASK)


def bernoulli_half(key, shape) -> np.ndarray:
    """``uniform(key, shape) < 0.5``: element i (row-major) takes the xor of
    the two words of the hash of the 64-bit count i."""
    n = int(np.prod(shape))
    idx = np.arange(n, dtype=np.uint64)
    a, b = threefry2x32(key[0], key[1], (idx >> np.uint64(32)).astype(np.uint32), idx.astype(np.uint32))
    bits = a ^ b
    unit = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    return (unit < np.float32(0.5)).reshape(shape)


def train_flips(seed: int, step: int, shape) -> np.ndarray:
    """The flips of train step ``step`` (0-based) of a run seeded ``seed``:
    the data key is the second half of ``split(PRNGKey(seed))``, folded
    with the step."""
    data_key = split(prng_key(seed))[1]
    return bernoulli_half(fold_in(data_key, step), tuple(shape))
