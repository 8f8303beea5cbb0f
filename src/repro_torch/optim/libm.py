"""The C library's float32 ``cosf`` and ``powf``, which XLA's CPU backend
calls for the reference's float32 ``cos`` and ``pow`` (numpy's float32
``power`` and torch's ``cos`` round otherwise in up to a fifth of cases).
The schedules and AdamW's bias corrections are host scalars, so the port
calls them directly."""
from __future__ import annotations

import ctypes
import ctypes.util
import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def _fn(name: str, nargs: int):
    fn = getattr(ctypes.CDLL(ctypes.util.find_library("m")), name)
    fn.argtypes, fn.restype = [ctypes.c_float] * nargs, ctypes.c_float
    return fn


def cosf(x) -> np.float32:
    return np.float32(_fn("cosf", 1)(float(np.float32(x))))


def powf(x, y) -> np.float32:
    return np.float32(_fn("powf", 2)(float(np.float32(x)), float(np.float32(y))))
