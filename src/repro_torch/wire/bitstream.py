"""Host-side bit packing: LSB-first into little-endian uint32 words.

This is the single bit-layout convention of the wire format (DESIGN.md §3):
value ``i`` of width ``w`` occupies absolute bit positions
``[i*w, (i+1)*w)``; bit ``b`` lives in word ``b // 32`` at in-word offset
``b % 32`` (LSB-first). The CUDA kernels of ``csrc/pack.cu`` implement the
identical layout on the card, so host- and device-produced streams are
byte-interchangeable (asserted in tests/test_torch_wire.py and chip_smoke.py).

A copy of ``repro/wire/bitstream.py`` (numpy only), kept so that the port
imports nothing of ``repro``.

Every stream starts word-aligned; codecs concatenate per-field streams
(indices, signs, magnitudes) with word padding between them so each can be
packed/unpacked as one vectorized call.
"""
from __future__ import annotations

import numpy as np

_WORD = np.dtype("<u4")


def n_words(count: int, width: int) -> int:
    """Words needed for ``count`` values of ``width`` bits each."""
    return -(-count * width // 32)


def pack_u32(values: np.ndarray, width: int) -> np.ndarray:
    """Pack ``values`` (uint-like, each < 2**width) into little-endian uint32
    words, LSB-first. width in [1, 32]."""
    assert 1 <= width <= 32, width
    v = np.ascontiguousarray(values, dtype=np.uint64)
    if width < 32:
        assert v.size == 0 or int(v.max()) < (1 << width), "value overflows width"
    n = v.size
    nw = n_words(n, width)
    pos = np.arange(n, dtype=np.uint64) * np.uint64(width)
    word = (pos >> np.uint64(5)).astype(np.int64)
    off = pos & np.uint64(31)
    shifted = v << off  # fits in uint64: width + 31 <= 63
    out = np.zeros(nw + 1, dtype=np.uint64)
    np.add.at(out, word, shifted & np.uint64(0xFFFFFFFF))
    np.add.at(out, word + 1, shifted >> np.uint64(32))
    return out[:nw].astype(_WORD)


def unpack_u32(words: np.ndarray, width: int, count: int) -> np.ndarray:
    """Inverse of :func:`pack_u32`: read ``count`` values of ``width`` bits."""
    assert 1 <= width <= 32, width
    w = np.concatenate([np.ascontiguousarray(words, dtype=_WORD), np.zeros(1, _WORD)])
    w64 = w.astype(np.uint64)
    pos = np.arange(count, dtype=np.uint64) * np.uint64(width)
    word = (pos >> np.uint64(5)).astype(np.int64)
    off = pos & np.uint64(31)
    v = (w64[word] >> off) | (w64[word + 1] << (np.uint64(32) - off))
    mask = np.uint64((1 << width) - 1)
    return (v & mask).astype(np.uint32)


def to_bytes(words: np.ndarray) -> bytes:
    return np.ascontiguousarray(words, dtype=_WORD).tobytes()


def from_bytes(buf: bytes) -> np.ndarray:
    if len(buf) % 4 != 0:
        from .spec import TruncatedFrame

        raise TruncatedFrame(f"bitstream not word-aligned ({len(buf)} bytes)")
    return np.frombuffer(buf, dtype=_WORD)
