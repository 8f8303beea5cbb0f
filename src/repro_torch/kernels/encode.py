"""Device encode of the SPARSE and DENSE wire codecs (port of
``repro/kernels/encode.py``: ``_sparse_device``/``sparse_encode``,
``_rows_device``/``encode_rows``, ``_dense_device``/``dense_encode``).

Every buffer is byte-identical to the port's host codec
(``repro_torch.wire.encode_sparse`` / ``encode_dense``), which is
byte-identical to the reference's host codec. Per call:

1. the stream kernel ``csrc/encode.cu`` (:func:`sparse_streams`, or
   :func:`dense_bits`) turns each fp32 value into its wire bit patterns;
2. SPARSE only, :func:`_compact_streams` (torch ops, as the reference leaves
   it to XLA outside its Pallas bodies): the valid entries of each row move
   to the front in ascending index order (an inclusive ``cumsum`` of the
   valid flags gives each one its slot, one ``scatter_``) and everything
   behind the count is zero, the host codec's padding;
3. the pack kernel ``csrc/pack.cu`` packs each full-length stream of every
   row into one int32 buffer, with the counts in its first column;
4. one host read of that buffer; the host adds the 16 fixed header bytes
   and trims each stream to ``n_words(count, width)``.

A CUDA tensor launches the kernels (or raises); a CPU tensor runs their
plain versions (``ref.sparse_streams_ref`` etc.) through the same steps.
"""
from __future__ import annotations

import ctypes
import struct
from typing import Optional

import numpy as np
import torch

from ..wire import bitstream as bs
from ..wire.spec import MAG_BITS, CodecID, MagDType, index_width, mag_dtype, pack_header
from . import ops, ref, runtime

# Payload layouts of wire/sparse.py (DESIGN.md §3.1/§3.4)
_SPARSE_PAYLOAD = struct.Struct("<BxxxI")  # [u8 mag][pad x3][u32 count]
_DENSE_PAYLOAD = struct.Struct("<Bxxx")    # [u8 mag][pad x3]


def device_encode_enabled(override: Optional[bool], tensor: torch.Tensor) -> bool:
    """Should an encode call site take the device path for ``tensor``?

    An explicit bool wins; None means "on for a CUDA tensor, off for a CPU
    tensor" (the reference's auto is "on for the TPU"). The device path on a
    CPU tensor runs the kernels' plain versions, so forcing it there is a
    test of the pipeline, not a speed-up."""
    if override is not None:
        return bool(override)
    return tensor.device.type == "cuda"


# ---------------------------------------------------------------------------
# the stream kernels
# ---------------------------------------------------------------------------


def sparse_streams(X: torch.Tensor, mag):
    """(sign, magnitude, valid) int32 streams of fp32 message rows X [rows, d]
    (see ``ref.sparse_streams_ref``)."""
    m = mag_dtype(mag)
    if X.dtype != torch.float32 or X.dim() != 2:
        raise TypeError(f"sparse_streams: X must be [rows, d] float32, got {X.dtype} {tuple(X.shape)}")
    if not runtime.on_cuda(X):
        return ref.sparse_streams_ref(X, int(m))
    if not X.is_contiguous():
        raise ValueError("sparse_streams: X must be contiguous")
    rows, d = X.shape
    sign, magbits, valid = (torch.empty((rows, d), dtype=torch.int32, device=X.device)
                            for _ in range(3))
    fn = runtime.function("encode", "sparse_streams", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    err = fn(X.data_ptr(), rows, d, int(m), sign.data_ptr(), magbits.data_ptr(),
             valid.data_ptr(), runtime.stream_ptr(X))
    runtime.check(err, "sparse_streams")
    runtime.count_launch("sparse_streams")
    return sign, magbits, valid


def dense_bits(x: torch.Tensor, mag) -> torch.Tensor:
    """The wire-dtype bit pattern of each value of fp32 x [d], sign kept
    (int32; see ``ref.dense_bits_ref``)."""
    m = mag_dtype(mag)
    if x.dtype != torch.float32 or x.dim() != 1:
        raise TypeError(f"dense_bits: x must be [d] float32, got {x.dtype} {tuple(x.shape)}")
    if not runtime.on_cuda(x):
        return ref.dense_bits_ref(x, int(m))
    if not x.is_contiguous():
        raise ValueError("dense_bits: x must be contiguous")
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    fn = runtime.function("encode", "dense_bits", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])
    err = fn(x.data_ptr(), x.shape[0], int(m), out.data_ptr(), runtime.stream_ptr(x))
    runtime.check(err, "dense_bits")
    runtime.count_launch("dense_bits")
    return out


# ---------------------------------------------------------------------------
# SPARSE: compaction, packing, host assembly
# ---------------------------------------------------------------------------


def _compact_streams(sign, magbits, valid):
    """Move each row's valid entries to the front in ascending index order
    (``np.nonzero`` order) and zero everything behind the count. Returns
    ([3, rows, d] int32 view: index, sign, magnitude; counts [rows] int64)."""
    rows, d = valid.shape
    slot = torch.cumsum(valid, dim=1)  # int64, inclusive
    dest = torch.where(valid != 0, slot - 1, d)  # invalid entries go to a spare column
    idx = torch.arange(d, dtype=torch.int32, device=valid.device).expand(rows, d)
    out = torch.zeros((3, rows, d + 1), dtype=torch.int32, device=valid.device)
    out.scatter_(2, dest.expand(3, rows, d), torch.stack([idx, sign, magbits]))
    return out[..., :d], slot[:, -1]


def _pack_sparse(streams, counts, d: int, m: MagDType):
    """Pack the three full-length streams of every row into one int32 buffer
    [rows, 1 + words]: column 0 the count, then the index, sign and magnitude
    words. Returns (buffer, words per stream)."""
    rows = counts.shape[0]
    widths = (index_width(d), 1, MAG_BITS[m])
    nws = [bs.n_words(d, w) for w in widths]
    buf = torch.empty((rows, 1 + sum(nws)), dtype=torch.int32, device=counts.device)
    buf[:, 0] = counts
    o = 1
    for s, w, nw in zip(streams, widths, nws):
        ops.pack_bits(s, w, out=buf[:, o:o + nw])
        o += nw
    return buf, nws


def _assemble_sparse(d: int, m: MagDType, row: np.ndarray, nws) -> bytes:
    """Header + payload header + each stream trimmed to its count's words."""
    count = int(row[0])
    parts = [pack_header(CodecID.SPARSE, d), _SPARSE_PAYLOAD.pack(int(m), count)]
    if count:
        o = 1
        for w, nw in zip((index_width(d), 1, MAG_BITS[m]), nws):
            parts.append(row[o:o + bs.n_words(count, w)].tobytes())
            o += nw
    return b"".join(parts)


def encode_rows(X: torch.Tensor, *, mag="fp32") -> list[bytes]:
    """SPARSE encode of every message row of X [n, d] fp32: one stream
    launch, three pack launches and one host read for all n buffers. Each
    buffer equals ``wire.encode_sparse(X[i])``."""
    m = mag_dtype(mag)
    if X.dim() != 2:
        raise ValueError(f"encode_rows: X must be [n, d], got {tuple(X.shape)}")
    n, d = X.shape
    if d == 0:
        return [pack_header(CodecID.SPARSE, 0) + _SPARSE_PAYLOAD.pack(int(m), 0)] * n
    streams, counts = _compact_streams(*sparse_streams(X.contiguous(), m))
    buf, nws = _pack_sparse(streams, counts, d, m)
    host = buf.cpu().numpy().view("<u4")  # the one host read of the call
    return [_assemble_sparse(d, m, host[i], nws) for i in range(n)]


def sparse_encode(x: torch.Tensor, *, mag="fp32") -> bytes:
    """SPARSE encode of one message x [d] fp32; equals
    ``wire.encode_sparse(x)``."""
    if x.dim() != 1:
        raise ValueError(f"sparse_encode: x must be [d], got {tuple(x.shape)}")
    return encode_rows(x.unsqueeze(0), mag=mag)[0]


def dense_encode(x: torch.Tensor, *, mag="fp32") -> bytes:
    """DENSE encode of x [d] fp32 (full-sync rounds); equals
    ``wire.encode_dense(x)``."""
    m = mag_dtype(mag)
    if x.dim() != 1:
        raise ValueError(f"dense_encode: x must be [d], got {tuple(x.shape)}")
    words = ops.pack_bits(dense_bits(x.contiguous(), m), MAG_BITS[m])
    return (pack_header(CodecID.DENSE, x.shape[0]) + _DENSE_PAYLOAD.pack(int(m))
            + words.cpu().numpy().view("<u4").tobytes())

