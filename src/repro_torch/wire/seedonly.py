"""SEED codec: O(1)-byte messages for shared-randomness compressors
(DESIGN.md §2 / §3.2). Port of ``repro/wire/seedonly.py``.

The receiver already holds the replicated ``delta``; the message carries
the RNG coordinates it needs to rematerialize its mask. Payload after the
common header (28 bytes, fixed):

    [u8 family][pad x3][u32 seed][u32 round][f32 scale]
    [u32 n][u32 worker][f32 param]

All three families rematerialize here bit for bit. PERM re-derives
Definition 5's permutation as the reference draws it from ``jax.random``
(``permutation(fold_in(PRNGKey(seed), round), d)``), through the numpy port
of those draws in :mod:`repro_torch.core.jax_random` (JAX 0.9.0).
"""
from __future__ import annotations

import struct

import numpy as np

from ..core import jax_random
from ..kernels.randk import hash_uniform
from .spec import CodecID, CorruptFrame, SeedFamily, SeedMessage, TruncatedFrame, pack_header

_PAYLOAD = struct.Struct("<BxxxIIfIIf")


def encode_seed(msg: SeedMessage, d: int) -> bytes:
    return pack_header(CodecID.SEED, d) + _PAYLOAD.pack(
        int(msg.family),
        msg.seed & 0xFFFFFFFF,
        msg.round & 0xFFFFFFFF,
        msg.scale,
        msg.n,
        msg.worker,
        msg.param,
    )


def decode_seed(buf: bytes, offset: int, d: int) -> SeedMessage:
    if len(buf) < offset + _PAYLOAD.size:
        raise TruncatedFrame("truncated seed wire message")
    family, seed, rnd, scale, n, worker, param = _PAYLOAD.unpack_from(buf, offset)
    try:
        family = SeedFamily(family)
    except ValueError as e:
        raise CorruptFrame(f"corrupt seed wire message: bad family {family}") from e
    return SeedMessage(
        family=family, seed=seed, round=rnd, scale=scale,
        n=n, worker=worker, param=param,
    )


def apply_seed(msg: SeedMessage, delta) -> np.ndarray:
    """Rematerialize the mask from the RNG coordinates and apply it to the
    receiver-local ``delta``: Q_i(delta) without any index/value payload."""
    x = np.ascontiguousarray(np.asarray(delta), dtype=np.float32).reshape(-1)
    d = x.size
    if msg.family == SeedFamily.BERN:
        u = hash_uniform(np.arange(d, dtype=np.uint32), msg.seed + msg.round, msg.worker)
        out = np.where(u < msg.param, x / msg.param, 0.0)
    elif msg.family == SeedFamily.ROTK:
        r = int(msg.param)
        keep = (np.arange(d) % msg.n) == ((msg.worker + r) % msg.n)
        out = np.where(keep, x * msg.n, 0.0)
    elif msg.family == SeedFamily.PERM:
        out = _permk(msg, x)
    else:  # pragma: no cover
        raise ValueError(msg.family)
    return (out * msg.scale).astype(np.float32)


def _permk(msg: SeedMessage, x: np.ndarray) -> np.ndarray:
    """The reference's ``PermK(n, worker)(fold_in(PRNGKey(seed), round), x)``
    in float32, in its order of operations: worker i keeps block i of the
    permutation (``dynamic_slice``: a start past the end is clamped to d - q),
    ``(x * mask) * n``; worker 0 also keeps the d - q*n leftover entries."""
    d, n = x.size, msg.n
    perm = jax_random.permutation(jax_random.fold_in(jax_random.PRNGKey(msg.seed), msg.round), d)
    q = d // n
    start = min(msg.worker * q, d - q)
    mask = np.zeros(d, dtype=np.float32)
    mask[perm[start:start + q]] = 1.0
    out = x * mask * np.float32(n)
    if d > q * n and msg.worker == 0:
        tmask = np.zeros(d, dtype=np.float32)
        tmask[perm[q * n:]] = 1.0
        out = out + x * tmask * np.float32(n)
    return out
