"""The counter hash of the BernK mask (port of ``repro/kernels/randk.py``).

Only :func:`hash_uniform` so far, on the host in numpy: the SEED codec's BERN
decode rematerializes its mask with it (``wire/seedonly.py``). The ``bernk``
Hopper kernel that applies the mask on the card comes with the BernK
compressor.
"""
from __future__ import annotations

import numpy as np

_M1 = 2654435761
_M2 = 2246822519


def hash_uniform(idx, seed: int, worker: int) -> np.ndarray:
    """Deterministic per-index uniform in [0, 1), float32; bit-equal to the
    reference's jnp version. 3-round xorshift-multiply of (seed, worker,
    index) in uint32 arithmetic (numpy arrays wrap mod 2**32), then
    ``float32(h) * 2**-32``."""
    h = np.asarray(idx).astype(np.uint32) * np.uint32(_M1)
    h = h ^ np.uint32((seed % (1 << 32) + (worker % (1 << 32)) * _M2) % (1 << 32))
    h = h ^ (h >> 15)
    h = h * np.uint32(_M2)
    h = h ^ (h >> 13)
    h = h * np.uint32(_M1)
    h = h ^ (h >> 16)
    return h.astype(np.float32) * np.float32(1.0 / 4294967296.0)
