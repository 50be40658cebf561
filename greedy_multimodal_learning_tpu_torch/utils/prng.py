"""The JAX package's random streams without jax: threefry2x32 keys and the
samplers it draws from (``jax/_src/prng.py``, ``jax/_src/random.py``, JAX
0.9 defaults: the threefry2x32 implementation with
``jax_threefry_partitionable=True``), and flax's static fold-in of a scope
path (``flax/core/scope.py::_fold_in_static``, ``flax_fix_rng_separator``
off).

A key is a (2,) ``numpy.uint32`` array, as a raw JAX key.  Every integer
step runs in numpy uint32 (or Python ints for one block), so it is exact
and the same on every machine; the float transforms are numpy float32 with
the operations in JAX's order, and the fused multiply-adds XLA's CPU code
makes of them emulated (:func:`fma32`):

* :func:`uniform`, :func:`bernoulli` and :func:`randint` give JAX's bits;
* :func:`normal` takes XLA's float32 ``erf_inv`` polynomial
  (``ErfInv32``), whose ``log1p`` is numpy's, so it agrees with JAX within
  4 float32 ulps rather than bit for bit.

The arrays are made on the host, large ones in blocks over a thread pool
(:func:`draw` makes several together); a caller moves them to its device.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import math
import os
from typing import Iterable, Sequence, Union

import numpy as np

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# Elements a block of the array samplers: a large draw (an r3d-18
# convolution holds 7M weights) runs block by block over threads.
_BLOCK = 1 << 18
_THREADS = min(8, os.cpu_count() or 1)


def _threefry_arrays(k1, k2, x1, x2):
    """Threefry-2x32 (20 rounds) of the uint32 arrays ``x1``, ``x2`` under
    the key words ``k1``, ``k2`` (``prng.py:863-936``), in place on copies."""
    k1, k2 = np.uint32(k1), np.uint32(k2)
    ks = (k1, k2, np.uint32(k1 ^ k2 ^ np.uint32(0x1BD11BDA)))
    x0 = np.array(x1, dtype=np.uint32, copy=True)
    y = np.array(x2, dtype=np.uint32, copy=True)
    x0 += ks[0]
    y += ks[1]
    tmp = np.empty_like(y)
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 += y
                np.left_shift(y, np.uint32(r), out=tmp)
                np.right_shift(y, np.uint32(32 - r), out=y)
                y |= tmp
                y ^= x0
            x0 += ks[(i + 1) % 3]
            y += ks[(i + 2) % 3]
            y += np.uint32(i + 1)
    return x0, y


def _threefry_ints(k1: int, k2: int, x1: int, x2: int):
    """:func:`_threefry_arrays` of one block in Python ints (a key
    operation's few hashes cost microseconds this way, not numpy's
    per-call overhead)."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0, y = (x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + y) & _MASK
            y = (((y << r) | (y >> (32 - r))) & _MASK) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        y = (y + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, y


def threefry2x32(key, x1, x2):
    """The threefry-2x32 hash of the count pairs (``x1``, ``x2``) under
    ``key``; uint32 arrays (or Python ints) in, the same out."""
    k1, k2 = (int(v) for v in np.asarray(key, np.uint32))
    if np.isscalar(x1) and np.isscalar(x2):
        return _threefry_ints(k1, k2, int(x1) & _MASK, int(x2) & _MASK)
    return _threefry_arrays(k1, k2, np.asarray(x1, np.uint32), np.asarray(x2, np.uint32))


def _key(words) -> np.ndarray:
    return np.array([int(w) & _MASK for w in words], dtype=np.uint32)


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` (``threefry_seed``, ``prng.py:802-830``)
    with 64-bit types off: the high word 0, the low word the seed's low 32
    bits (two's complement), so a seed outside 32 bits wraps as JAX's."""
    return _key((0, int(seed) & _MASK))


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` (partitionable, ``prng.py:1143-1160``):
    key i is the hash of the 64-bit count i.  Returns (num, 2) uint32."""
    return np.stack([_key(threefry2x32(key, i >> 32, i & _MASK)) for i in range(int(num))])


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` (``prng.py:1163-1170``): the hash
    of the count pair (0, data as uint32)."""
    return _key(threefry2x32(key, 0, int(data) & _MASK))


def fold_in_static(key, parts: Iterable[Union[str, int]]) -> np.ndarray:
    """flax's ``_fold_in_static``: ``key`` folded with the first 4 bytes
    (big-endian) of the SHA-1 of ``parts`` (strings as UTF-8, ints as their
    minimal big-endian bytes, no separator); no parts returns ``key``."""
    parts = tuple(parts)
    if not parts:
        return np.asarray(key, np.uint32)
    digest = hashlib.sha1()
    for x in parts:
        if isinstance(x, str):
            digest.update(x.encode("utf-8"))
        elif isinstance(x, int):
            digest.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
        else:
            raise ValueError(f"expected int or string, got {x!r}")
    return fold_in(key, int.from_bytes(digest.digest()[:4], byteorder="big"))


def _bits_block(k1, k2, start: int, stop: int) -> np.ndarray:
    idx = np.arange(start, stop, dtype=np.uint64)
    a, b = _threefry_arrays(k1, k2, (idx >> np.uint64(32)).astype(np.uint32), idx.astype(np.uint32))
    a ^= b
    return a


def _draw_many(requests) -> list:
    """``transform`` of the partitionable random bits of ``shape`` under
    ``key``, for each (key, shape, transform, dtype) of ``requests``: every
    request's blocks of :data:`_BLOCK` elements run together over one
    thread pool (numpy releases the GIL inside each operation)."""
    outs, jobs = [], []
    for key, shape, transform, dtype in requests:
        shape = tuple(int(d) for d in shape)
        n = math.prod(shape)
        k1, k2 = (int(v) for v in np.asarray(key, np.uint32))
        out = np.empty(n, dtype)
        if n == 1:  # one hash in Python ints
            a, b = _threefry_ints(k1, k2, 0, 0)
            out[:] = transform(np.array([a ^ b], np.uint32))
        else:
            jobs += [(out, k1, k2, transform, start, min(start + _BLOCK, n)) for start in range(0, n, _BLOCK)]
        outs.append(out.reshape(shape))

    def fill(job):
        out, k1, k2, transform, start, stop = job
        out[start:stop] = transform(_bits_block(k1, k2, start, stop))

    if len(jobs) == 1:
        fill(jobs[0])
    elif jobs:
        with concurrent.futures.ThreadPoolExecutor(min(len(jobs), _THREADS)) as pool:
            list(pool.map(fill, jobs))
    return outs


def _draw(key, shape: Sequence[int], transform, dtype) -> np.ndarray:
    return _draw_many([(key, shape, transform, dtype)])[0]


def random_bits(key, shape: Sequence[int]) -> np.ndarray:
    """32 random bits an element (``_threefry_random_bits_partitionable``,
    ``prng.py:1184``): element i (row-major) is the xor of the two words of
    the hash of the 64-bit count i."""
    return _draw(key, shape, lambda bits: bits, np.uint32)


def _unit_floats(bits: np.ndarray) -> np.ndarray:
    """float32 in [0, 1) from the top 23 bits: the mantissa under exponent
    1, minus 1 (``random.py:473-486``)."""
    return ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)


def fma32(a, b, c) -> np.ndarray:
    """``a * b + c`` of float32 values rounded once to float32, as XLA's
    CPU code contracts a product and a sum into one fused multiply-add.
    The product is exact in float64 and the sum rounds there; rounding that
    to float32 again is wrong only where the float64 sum lies on a float32
    midpoint, and there the sum is rounded to odd (TwoSum's error says
    which way), which makes the second rounding exact."""
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    c = np.broadcast_to(np.asarray(c, np.float64), p.shape)
    s = p + c
    tie = np.flatnonzero((s.view(np.int64) & 0x1FFFFFFF) == 0x10000000)
    if tie.size:
        pt, ct, st = p.flat[tie], c.flat[tie], s.flat[tie]
        back = st - pt
        err = (pt - (st - back)) + (ct - back)
        s.flat[tie] = np.where(err == 0, st, np.nextafter(st, np.where(err > 0, np.inf, -np.inf)))
    return s.astype(np.float32)


def _scaled(lo, hi):
    """Unit floats f -> ``max(lo, f * (hi - lo) + lo)`` in float32, the
    product and the sum fused (:func:`fma32`) as XLA fuses them."""
    lo, hi = np.float32(lo), np.float32(hi)
    if lo == 0 and hi == 1:  # f * 1 + 0 is f under any rounding
        return lambda bits: _unit_floats(bits)
    return lambda bits: np.maximum(lo, fma32(_unit_floats(bits), hi - lo, lo))


def uniform(key, shape: Sequence[int] = (), minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``
    (``random.py:435-487``): the bounds rounded to float32, then ``max(minval,
    f * (maxval - minval) + minval)`` in float32."""
    return _draw(key, shape, _scaled(minval, maxval), np.float32)


def bernoulli(key, p: float = 0.5, shape: Sequence[int] = ()) -> np.ndarray:
    """``jax.random.bernoulli(key, p, shape)`` in mode ``'low'``
    (``random.py:1075-1095``): ``uniform(key, shape) < p`` in float32."""
    p = np.float32(p)
    return _draw(key, shape, lambda bits: _unit_floats(bits) < p, np.bool_)


def randint(key, shape: Sequence[int], minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval)`` as int32
    (``random.py:581-652``): two 32-bit draws from the key's two halves,
    combined modulo the span as JAX does to cut the bias."""
    minval, maxval = int(minval), int(maxval)
    span = 1 if maxval <= minval else maxval - minval
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape).astype(np.uint64), random_bits(k2, shape).astype(np.uint64)
    multiplier = (2 ** 16 % span) ** 2 % span
    # every intermediate stays below span**2 + span < 2**32, as in uint32
    offset = ((higher % span) * multiplier + lower % span) % span
    return (minval + offset.astype(np.int64)).astype(np.int32)


# XLA's ErfInv32 (xla/client/lib/math.cc; stablehlo's chlo.erf_inv for
# float32): a degree-9 polynomial in w = -log1p(-x^2), one set of
# coefficients for w < 5, another in sqrt(w) beyond.
_ERFINV_LT5 = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
                        -0.00125372503, -0.00417768164, 0.246640727, 1.50140941], np.float32)
_ERFINV_GE5 = np.array([-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
                        -0.0076224613, 0.00943887047, 1.00167406, 2.83297682], np.float32)


def _horner(w: np.ndarray, coefficients) -> np.ndarray:
    """``p = c_i + p * w`` over ``coefficients`` in float32, each step one
    fused multiply-add as XLA emits it: the product exact in float64, the
    sum rounded once more to float32.  Unlike :func:`fma32` it leaves the
    two roundings apart where the float64 sum falls on a float32 midpoint
    (a chance under 2**-28 a step), which the ulp bound of :func:`normal`
    covers."""
    w = w.astype(np.float64)
    p = np.full(w.shape, coefficients[0], np.float64)
    for c in coefficients[1:]:
        p *= w
        p += np.float64(c)
        p = p.astype(np.float32).astype(np.float64)
    return p.astype(np.float32)


def erf_inv(x: np.ndarray) -> np.ndarray:
    """float32 inverse error function, XLA's ``ErfInv32`` step by step, its
    Horner steps fused (:func:`_horner`); the w >= 5 branch (|x| above
    0.9966) is evaluated on its elements only."""
    x = np.asarray(x, np.float32)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        w = -np.log1p(-x * x)
        p = _horner(w - np.float32(2.5), _ERFINV_LT5)
        large = np.flatnonzero(w >= np.float32(5.0))
        if large.size:
            p[large] = _horner(np.sqrt(w[large]) - np.float32(3.0), _ERFINV_GE5)
        out = p * x
        edge = np.abs(x) == np.float32(1.0)
        return np.where(edge, x * np.finfo(np.float32).max, out).astype(np.float32, copy=False)


_TO_OPEN_UNIT = _scaled(np.nextafter(np.float32(-1.0), np.float32(0.0)), 1.0)


def _standard_normal(bits: np.ndarray) -> np.ndarray:
    return np.float32(np.sqrt(2)) * erf_inv(_TO_OPEN_UNIT(bits))


def normal(key, shape: Sequence[int] = ()) -> np.ndarray:
    """``jax.random.normal(key, shape, float32)`` (``random.py:867-874``):
    ``sqrt(2) * erf_inv(u)`` for u uniform in (nextafter(-1, 0), 1)."""
    return _draw(key, shape, _standard_normal, np.float32)


def draw(requests) -> list:
    """Several draws made together (their blocks share one thread pool):
    each request is ``("normal", key, shape)`` or ``("uniform", key, shape,
    minval, maxval)``; returns the arrays :func:`normal` and :func:`uniform`
    return, in order."""
    made = []
    for kind, key, shape, *bounds in requests:
        if kind == "normal":
            made.append((key, shape, _standard_normal, np.float32))
        elif kind == "uniform":
            made.append((key, shape, _scaled(*bounds), np.float32))
        else:
            raise ValueError(f"unknown sampler {kind!r}")
    return _draw_many(made)


def key_chain(key, steps: int) -> np.ndarray:
    """The first half of ``split`` applied ``steps`` times: the random
    controller's key after ``steps`` steps from ``key``."""
    k1, k2 = (int(v) for v in np.asarray(key, np.uint32))
    for _ in range(int(steps)):  # split(key)[0]: the hash of the count 0
        k1, k2 = _threefry_ints(k1, k2, 0, 0)
    return _key((k1, k2))
