"""SEED codec: O(1)-byte messages for shared-randomness compressors
(DESIGN.md §2 / §3.2). Port of ``repro/wire/seedonly.py``.

The receiver already holds the replicated ``delta``; the message carries
the RNG coordinates it needs to rematerialize its mask. Payload after the
common header (28 bytes, fixed):

    [u8 family][pad x3][u32 seed][u32 round][f32 scale]
    [u32 n][u32 worker][f32 param]

BERN and ROTK rematerialize here bit for bit. PERM re-derives Definition 5's
permutation from ``jax.random`` in the reference; the port has no threefry2x32
/ ``jax.random.permutation`` yet (pinned to JAX 0.9.0 when it comes), so
:func:`apply_seed` raises :class:`PermDecodeUnavailable` for it.
"""
from __future__ import annotations

import struct

import numpy as np

from ..kernels.randk import hash_uniform
from .spec import CodecID, CorruptFrame, SeedFamily, SeedMessage, TruncatedFrame, pack_header

_PAYLOAD = struct.Struct("<BxxxIIfIIf")


class PermDecodeUnavailable(NotImplementedError):
    """The PERM family's mask needs a port of threefry2x32 and
    ``jax.random.permutation`` (pinned to JAX 0.9.0), which the port lacks."""


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
        raise PermDecodeUnavailable(
            "SEED/PERM decode needs the PermK mask of jax.random.permutation: the port "
            "has no threefry2x32 / jax.random.permutation port yet (pinned to JAX 0.9.0)")
    else:  # pragma: no cover
        raise ValueError(msg.family)
    return (out * msg.scale).astype(np.float32)
