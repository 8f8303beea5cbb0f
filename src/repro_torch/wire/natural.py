"""NATURAL codec: sign + fp32 exponent, 9 bits per value (DESIGN.md §3.3).

Natural compression (Horvath et al. 2022) rounds every value to a signed
power of two, so the fp32 mantissa of its output is always zero: the wire
only needs [sign:1][biased exponent:8] per coordinate — exactly the
9 bits/value of ``CommModel.natural_bits``. Zero is exponent field 0
(fp32 zero/subnormal band; natural compression never emits subnormals).

Payload after the common header: one 9-bit token stream, word-aligned.
Encoding a value with a non-zero mantissa silently drops the mantissa —
the codec is only exact on natural-compression outputs (tested).

A copy of ``repro/wire/natural.py`` (numpy only).
"""
from __future__ import annotations

import numpy as np

from . import bitstream as bs
from .spec import CodecID, TruncatedFrame, pack_header

TOKEN_BITS = 9


def encode_natural(x) -> bytes:
    v = np.ascontiguousarray(np.asarray(x), dtype=np.float32).reshape(-1)
    bits = v.view("<u4")
    sign = bits >> np.uint32(31)
    exp = (bits >> np.uint32(23)) & np.uint32(0xFF)
    token = (sign << np.uint32(8)) | exp
    return pack_header(CodecID.NATURAL, v.size) + bs.to_bytes(
        bs.pack_u32(token, TOKEN_BITS)
    )


def decode_natural(buf: bytes, offset: int, d: int) -> np.ndarray:
    if len(buf) < offset + 4 * bs.n_words(d, TOKEN_BITS):
        raise TruncatedFrame("truncated natural wire message")
    words = bs.from_bytes(buf[offset : offset + 4 * bs.n_words(d, TOKEN_BITS)])
    token = bs.unpack_u32(words, TOKEN_BITS, d)
    sign = token >> np.uint32(8)
    exp = token & np.uint32(0xFF)
    bits = (sign << np.uint32(31)) | (exp << np.uint32(23))
    return bits.astype("<u4").view(np.float32).copy()
