"""The few ``jax.random`` functions the SEED/PERM decode and the synthetic LM
data need, in numpy.

The reference rebuilds Definition 5's permutation of a SEED/PERM message from
``jax.random`` (``repro/wire/seedonly.py``: ``PermK(n, worker)(fold_in(
PRNGKey(seed), round), delta)``). The port has no JAX, so this module
re-derives those draws bit for bit, pinned to JAX 0.9.0 with its default
``jax_threefry_partitionable = True`` and x64 off:

* :func:`threefry2x32`, the Threefry-2x32 hash (20 rounds, 5 key injections);
* :func:`PRNGKey` (key data ``[0, seed mod 2**32]`` for a Python int that fits
  int64, as JAX converts it through ``np.int64`` with x64 off);
* :func:`fold_in` and :func:`split`: under the partitionable scheme
  ``split(key, n)[i]`` is ``threefry2x32(key, (0, i))``, which is also
  ``fold_in(key, i)``;
* :func:`random_bits`, 32-bit: ``y1 ^ y2`` of ``threefry2x32(key, (0, j))``
  for the flat index j;
* :func:`permutation` of ``range(d)``, ``jax.random._shuffle``: ``ceil(3 ln d
  / ln(2**32 - 1))`` rounds, each splitting the key, drawing 32-bit sort keys
  and sorting stably by them;
* :func:`uniform`, float32 in [0, 1) from the 32-bit draws: the synthetic
  LM data's tokens (``repro_torch.data``).

Keys are ``uint32`` arrays of shape [2], as ``jax.random.PRNGKey`` returns them.
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x1, x2):
    """Threefry-2x32 of the counter pairs (x1, x2) under ``key`` ([2] uint32),
    as ``jax._src.prng._threefry2x32_lowering``; returns (y1, y2) uint32."""
    k1, k2 = (np.uint32(k) for k in np.asarray(key, dtype=np.uint32))
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [np.array(x1, dtype=np.uint32, copy=True), np.array(x2, dtype=np.uint32, copy=True)]
    x[0] += ks[0]
    x[1] += ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] += x[1]
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] += ks[(i + 1) % 3]
        x[1] += ks[(i + 2) % 3]
        x[1] += np.uint32(i + 1)
    return x[0], x[1]


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a Python int with x64 off: [0, seed
    mod 2**32]; outside the int64 range it raises ``OverflowError``, as JAX
    does through ``np.int64(seed)``."""
    s = int(np.int64(seed))
    return np.array([0, s & 0xFFFFFFFF], dtype=np.uint32)


def _counters(num: int):
    """The (hi, lo) words of the 64-bit counters 0..num-1 (``iota_2x32_shape``)."""
    j = np.arange(num, dtype=np.uint64)
    return (j >> np.uint64(32)).astype(np.uint32), (j & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: [num, 2] uint32 keys."""
    y1, y2 = threefry2x32(key, *_counters(num))
    return np.stack([y1, y2], axis=-1)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``, data taken mod 2**32."""
    y1, y2 = threefry2x32(key, [0], [int(data) & 0xFFFFFFFF])
    return np.array([y1[0], y2[0]], dtype=np.uint32)


def random_bits(key: np.ndarray, size: int) -> np.ndarray:
    """``jax.random.bits(key, (size,), uint32)``: [size] uint32."""
    y1, y2 = threefry2x32(key, *_counters(size))
    return y1 ^ y2


def shuffle_rounds(size: int) -> int:
    """Sort rounds of ``jax.random._shuffle`` over ``size`` values (its
    float64 formula: 1 up to d = 1625, 2 from d = 1626)."""
    uint32max = np.iinfo(np.uint32).max
    return int(np.ceil(3 * np.log(max(1, size)) / np.log(uint32max)))


def permutation(key: np.ndarray, d: int) -> np.ndarray:
    """``jax.random.permutation(key, d)``: a permutation of range(d), int32."""
    x = np.arange(d, dtype=np.int32)
    for _ in range(shuffle_rounds(d)):
        key, subkey = split(key)
        order = np.argsort(random_bits(subkey, d), kind="stable")
        x = x[order]
    return x


def uniform(key: np.ndarray, shape) -> np.ndarray:
    """``jax.random.uniform(key, shape)`` (float32 in [0, 1)): the 23 high
    bits of each 32-bit draw as the mantissa of a float in [1, 2), less 1.0
    (``(bits >> 9) | 0x3F800000`` read as float32, minus 1.0)."""
    shape = tuple(shape)
    bits = random_bits(key, int(np.prod(shape, dtype=np.int64)))
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1.0)
    return floats.reshape(shape)
