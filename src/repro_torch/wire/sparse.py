"""SPARSE and DENSE codecs: host numpy encode/decode (DESIGN.md §3.1, §3.4).

Port of ``repro/wire/sparse.py``, byte-identical to it. SPARSE payload after
the common header:

    [u8 mag_dtype] [u8 pad x3] [u32 count]
    [index stream:     count * ceil(log2 d) bits, word-aligned]
    [sign stream:      count * 1 bit,             word-aligned]
    [magnitude stream: count * MAG_BITS bits,     word-aligned]

DENSE payload: [u8 mag_dtype] [u8 pad x3] [value stream: d * MAG_BITS bits].

Every conversion is done on bit patterns in numpy ``uint32``, never with a
float cast, so the bytes do not hang on how a host's numpy or CPU converts:

* fp32 -> fp16 is numpy's ``npy_floatbits_to_halfbits`` (``halffloat.c``):
  round to nearest even for normals, subnormals and overflow to inf; a NaN
  becomes ``0x7c00 + (mantissa >> 13)`` (``0x7c01`` if that is ``0x7c00``)
  with its sign, so a signalling NaN stays signalling;
* fp32 -> bf16 is ml_dtypes' rule: ``(bits + 0x7FFF + ((bits >> 16) & 1)) >> 16``
  for a non-NaN, ``sign | 0x7FC0`` for a NaN;
* fp16 -> fp32 is ``npy_halfbits_to_floatbits`` and bf16 -> fp32 is
  ``bits << 16``, both exact.

Validity is "magnitude bits != 0" (``np.nonzero`` on an IEEE host): fp32
denormals are kept, -0.0 is elided.
"""
from __future__ import annotations

import struct

import numpy as np

from . import bitstream as bs
from .spec import (
    CodecID,
    CorruptFrame,
    MAG_BITS,
    MagDType,
    TruncatedFrame,
    index_width,
    mag_dtype,
    pack_header,
)

_PAYLOAD = struct.Struct("<BxxxI")
_DENSE_PAYLOAD = struct.Struct("<Bxxx")
_U32 = np.dtype("<u4")


def f32_to_f16_bits(bits: np.ndarray) -> np.ndarray:
    """fp16 bit patterns (uint32, < 2**16) of fp32 bit patterns: numpy's
    ``npy_floatbits_to_halfbits``, element-wise."""
    b = np.asarray(bits, dtype=np.uint32)
    sgn = (b >> 16) & 0x8000
    fexp = b & 0x7F800000
    fsig = b & 0x007FFFFF
    # exponent overflow: inf, or a NaN that keeps its sign and top mantissa bits
    nan = np.uint32(0x7C00) + (fsig >> 13)
    nan = np.where(nan == 0x7C00, np.uint32(0x7C01), nan)
    big = np.where((fexp == 0x7F800000) & (fsig != 0), nan, np.uint32(0x7C00))
    # exponent underflow: a subnormal half or a signed zero
    shift = np.uint32(113) - np.clip(fexp >> 23, 102, 113)
    ssig = (np.uint32(0x00800000) + fsig) >> shift
    ssig = ssig + np.where(((ssig & 0x3FFF) != 0x1000) | ((b & 0x7FF) != 0),
                           np.uint32(0x1000), np.uint32(0))
    small = np.where(fexp < 0x33000000, np.uint32(0), ssig >> 13)
    # normal: rebias the exponent, round the mantissa (a carry bumps the exponent)
    nsig = fsig + np.where((fsig & 0x3FFF) != 0x1000, np.uint32(0x1000), np.uint32(0))
    normal = ((fexp - np.uint32(0x38000000)) >> 13) + (nsig >> 13)
    h = np.where(fexp >= 0x47800000, big, np.where(fexp <= 0x38000000, small, normal))
    return (sgn + h).astype(np.uint32)


def f32_to_bf16_bits(bits: np.ndarray) -> np.ndarray:
    """bf16 bit patterns (uint32, < 2**16) of fp32 bit patterns: round to
    nearest even, a NaN to ``sign | 0x7FC0`` (ml_dtypes)."""
    b = np.asarray(bits, dtype=np.uint32)
    nan = ((b >> 16) & 0x8000) | np.uint32(0x7FC0)
    rne = (b + np.uint32(0x7FFF) + ((b >> 16) & 1)) >> 16  # no wrap: NaNs take the other branch
    return np.where((b & 0x7FFFFFFF) > 0x7F800000, nan, rne).astype(np.uint32)


def f16_to_f32_bits(h: np.ndarray) -> np.ndarray:
    """fp32 bit patterns of fp16 bit patterns: ``npy_halfbits_to_floatbits``
    (exact; NaN payloads shifted up, a signalling NaN stays signalling)."""
    h = np.asarray(h, dtype=np.uint32) & 0xFFFF
    sgn = (h & 0x8000) << 16
    hexp = h & 0x7C00
    hsig = h & 0x03FF
    # subnormal: hsig * 2**-24 = 1.f * 2**(p - 24) with p the top set bit of hsig
    p = np.zeros_like(hsig)
    for k in range(1, 10):
        p = np.where(hsig >> k, np.uint32(k), p)
    sub = ((p + 103) << 23) + ((hsig << (23 - p)) & 0x007FFFFF)
    sub = np.where(hsig == 0, np.uint32(0), sub)
    special = np.uint32(0x7F800000) | (hsig << 13)
    normal = ((h & 0x7FFF) + np.uint32(0x1C000)) << 13
    out = np.where(hexp == 0, sub, np.where(hexp == 0x7C00, special, normal))
    return (sgn | out).astype(np.uint32)


def to_wire_bits(bits: np.ndarray, m: MagDType) -> np.ndarray:
    """Wire-dtype bit patterns (uint32) of fp32 bit patterns."""
    b = np.asarray(bits, dtype=np.uint32)
    if m == MagDType.FP32:
        return b
    return f32_to_f16_bits(b) if m == MagDType.FP16 else f32_to_bf16_bits(b)


def from_wire_bits(bits: np.ndarray, m: MagDType) -> np.ndarray:
    """fp32 bit patterns (uint32) of wire-dtype bit patterns."""
    b = np.asarray(bits, dtype=np.uint32)
    if m == MagDType.FP32:
        return b
    return f16_to_f32_bits(b) if m == MagDType.FP16 else (b & 0xFFFF) << 16


def _f32_bits(x) -> np.ndarray:
    if hasattr(x, "detach"):  # a torch tensor, on any device
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(x), dtype=np.float32).reshape(-1).view(_U32)


def encode_sparse(x, *, mag="fp32") -> bytes:
    """Encode a dense sparsified fp32 vector (entries with zero magnitude
    bits are elided)."""
    m = mag_dtype(mag)
    bits = _f32_bits(x)
    d = bits.size
    magbits = bits & 0x7FFFFFFF
    idx = np.flatnonzero(magbits).astype(np.uint32)
    parts = [
        pack_header(CodecID.SPARSE, d),
        _PAYLOAD.pack(int(m), idx.size),
        bs.to_bytes(bs.pack_u32(idx, index_width(d))),
        bs.to_bytes(bs.pack_u32(bits[idx] >> 31, 1)),
        bs.to_bytes(bs.pack_u32(to_wire_bits(magbits[idx], m), MAG_BITS[m])),
    ]
    return b"".join(parts)


def decode_sparse(buf: bytes, offset: int, d: int) -> np.ndarray:
    """Decode the payload at ``offset`` (past the common header) -> fp32 [d]."""
    if len(buf) < offset + _PAYLOAD.size:
        raise TruncatedFrame("truncated sparse wire message")
    m, count = _PAYLOAD.unpack_from(buf, offset)
    try:
        m = MagDType(m)
    except ValueError as e:
        raise CorruptFrame(f"corrupt sparse wire message: bad mag dtype {m}") from e
    offset += _PAYLOAD.size
    if count > d:
        raise CorruptFrame(f"corrupt sparse wire message: count {count} > d={d}")
    widths = (index_width(d), 1, MAG_BITS[m])
    if len(buf) < offset + sum(4 * bs.n_words(count, w) for w in widths):
        raise TruncatedFrame("truncated sparse wire message")
    streams = []
    for width in widths:
        nbytes = 4 * bs.n_words(count, width)
        words = bs.from_bytes(buf[offset : offset + nbytes])
        streams.append(bs.unpack_u32(words, width, count))
        offset += nbytes
    idx, sign, magbits = streams
    if idx.size and int(idx.max()) >= d:
        raise CorruptFrame(f"corrupt sparse wire message: index {int(idx.max())} >= d={d}")
    vals = from_wire_bits(magbits, m) ^ (sign << 31)  # negation flips the sign bit
    out = np.zeros(d, dtype=_U32)
    out[idx] = vals
    return out.view(np.float32)


def encode_dense(x, *, mag="fp32") -> bytes:
    """DENSE codec: raw values (full-sync broadcast rounds), sign kept."""
    m = mag_dtype(mag)
    bits = _f32_bits(x)
    return b"".join(
        [
            pack_header(CodecID.DENSE, bits.size),
            _DENSE_PAYLOAD.pack(int(m)),
            bs.to_bytes(bs.pack_u32(to_wire_bits(bits, m), MAG_BITS[m])),
        ]
    )


def decode_dense(buf: bytes, offset: int, d: int) -> np.ndarray:
    if len(buf) < offset + _DENSE_PAYLOAD.size:
        raise TruncatedFrame("truncated dense wire message")
    (m,) = _DENSE_PAYLOAD.unpack_from(buf, offset)
    try:
        m = MagDType(m)
    except ValueError as e:
        raise CorruptFrame(f"corrupt dense wire message: bad mag dtype {m}") from e
    offset += _DENSE_PAYLOAD.size
    nbytes = 4 * bs.n_words(d, MAG_BITS[m])
    if len(buf) < offset + nbytes:
        raise TruncatedFrame("truncated dense wire message")
    bits = bs.unpack_u32(bs.from_bytes(buf[offset : offset + nbytes]), MAG_BITS[m], d)
    return from_wire_bits(bits, m).view(np.float32)
