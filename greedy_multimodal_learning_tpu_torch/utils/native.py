"""The host-side data helpers of ``csrc/fastio.cc`` (host C++, not a kernel):
batch collation and the view gather, copies made in C with the interpreter
lock released (``ctypes`` releases it for the call), so the pipeline's
producer thread overlaps the step loop.  The counterpart of
``greedy_multimodal_learning_tpu/utils/native.py``.

The library is built with ``g++`` at first use (``ops/build.py``) and a
failed build raises: there is no quiet fallback.  The numpy versions
(``*_numpy``) compute the same bytes; the tests hold the library to them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np

from ..ops.build import load

_PTR = ctypes.POINTER(ctypes.c_void_p)


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded ``fastio`` library, built first if needed."""
    L = load("fastio")
    L.gml_collate_u8.argtypes = [_PTR, ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32]
    L.gml_collate_u8.restype = None
    L.gml_gather_views_u8.argtypes = [
        _PTR, ctypes.c_int32, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int64, ctypes.c_void_p,
        ctypes.c_int32,
    ]
    L.gml_gather_views_u8.restype = None
    return L


def collate_u8(samples: Sequence[np.ndarray], batch_size: int) -> np.ndarray:
    """Equal-shape uint8 samples stacked into a (batch_size, *shape) batch
    whose rows past ``len(samples)`` are zero.  Raises ValueError on other
    input (an empty list, more samples than rows, another dtype or shape)."""
    if not samples or len(samples) > batch_size:
        raise ValueError(f"collate_u8: {len(samples)} samples for a batch of {batch_size}")
    first = samples[0]
    # contiguous copies where needed, held until the call returns
    arrays = [np.ascontiguousarray(s) for s in samples]
    for a in arrays:
        if a.dtype != np.uint8 or a.shape != first.shape:
            raise ValueError(f"collate_u8: a {a.dtype} {a.shape} sample among uint8 {first.shape} samples")
    out = np.empty((batch_size,) + first.shape, np.uint8)
    ptrs = (ctypes.c_void_p * len(arrays))(*[a.ctypes.data for a in arrays])
    lib().gml_collate_u8(ptrs, len(arrays), first.nbytes, out.ctypes.data, batch_size)
    return out


def collate_u8_numpy(samples: Sequence[np.ndarray], batch_size: int) -> np.ndarray:
    """The numpy version of :func:`collate_u8`."""
    imgs = np.stack(samples)
    pad = np.zeros((batch_size - len(samples),) + imgs.shape[1:], imgs.dtype)
    return np.concatenate([imgs, pad])


def gather_views_u8(stack: np.ndarray, view_indices: Sequence[int]) -> np.ndarray:
    """Rows ``view_indices`` of a (V, ...) uint8 view stack, as a new
    contiguous array.  Raises ValueError on another dtype or an index out of
    range."""
    stack = np.ascontiguousarray(stack)
    idx = np.ascontiguousarray(view_indices, np.int32)
    if stack.dtype != np.uint8 or stack.ndim < 2:
        raise ValueError(f"gather_views_u8: a {stack.dtype} stack of {stack.ndim} dims, want uint8 of 2 or more")
    if idx.ndim != 1 or idx.size == 0 or idx.min() < 0 or idx.max() >= stack.shape[0]:
        raise ValueError(f"gather_views_u8: views {idx.tolist()} of a stack of {stack.shape[0]}")
    out = np.empty((idx.size,) + stack.shape[1:], np.uint8)
    ptrs = (ctypes.c_void_p * 1)(stack.ctypes.data)
    lib().gml_gather_views_u8(ptrs, 1, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), idx.size,
                              stack[0].nbytes, out.ctypes.data, 1)
    return out


def gather_views_u8_numpy(stack: np.ndarray, view_indices: Sequence[int]) -> np.ndarray:
    """The numpy version of :func:`gather_views_u8`."""
    return np.ascontiguousarray(stack[list(view_indices)])
