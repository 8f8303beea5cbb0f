"""Device encode of the SPARSE and DENSE wire codecs (port of
``repro/kernels/encode.py``: ``sparse_encode``, ``encode_rows``,
``dense_encode``, and the fused compress-and-encode paths ``mask_encode``,
``encode_per_worker`` and ``topk_encode``).

Every buffer is byte-identical to the port's host codec
(``repro_torch.wire.encode_sparse`` / ``encode_dense``) over the matching
compressor output, which is byte-identical to the reference's host codec.
Per call:

1. a stream kernel of ``csrc/encode.cu`` turns each fp32 value into its wire
   bit patterns: :func:`sparse_streams` for given message rows,
   :func:`mask_streams` for the BernK messages of one vector (one row per
   worker id), :func:`topk_streams` for block top-k (per-block slots with
   the kept values' global indices), or :func:`dense_bits`;
2. SPARSE only, :func:`_compact_streams` (torch ops, as the reference leaves
   it to XLA outside its Pallas bodies): the valid entries of each row move
   to the front in stream order (an inclusive ``cumsum`` of the valid flags
   gives each one its slot, one ``scatter_``) and everything behind the
   count is zero, the host codec's padding;
3. the pack kernel ``csrc/pack.cu`` packs each full-length stream of every
   row into one int32 buffer, with the counts in its first column;
4. one host read of that buffer; the host adds the 16 fixed header bytes
   and trims each stream to ``n_words(count, width)``.

A CUDA tensor launches the kernels (or raises); a CPU tensor runs their
plain versions (``ref.sparse_streams_ref`` etc.) through the same steps.

The receiver's side is :func:`decode_device`: a SPARSE, NATURAL or DENSE
message decoded where the parameters live, every stream unpacked on the card
by the ``unpack_bits`` kernel.
"""
from __future__ import annotations

import ctypes
import struct
from typing import Optional

import numpy as np
import torch

from ..wire import bitstream as bs
from ..wire.spec import (HEADER_BYTES, MAG_BITS, CodecID, CorruptFrame, MagDType, TruncatedFrame,
                         index_width, mag_dtype, pack_header, unpack_header)
from . import ops, randk, ref, runtime
from . import topk as _topk

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


def _i32_pattern(v: int) -> int:
    """The int32 holding the uint32 pattern of ``v mod 2**32``."""
    v %= 1 << 32
    return v - (1 << 32) if v >= 1 << 31 else v


def mask_streams(x: torch.Tensor, workers: torch.Tensor, keep_prob: float, seed: int, mag):
    """(sign, magnitude, valid) int32 streams [rows, d] of the BernK message
    of fp32 x [d] for each worker id of ``workers`` [rows] int32 (on x's
    device; see ``ref.mask_streams_ref``)."""
    m = mag_dtype(mag)
    if x.dtype != torch.float32 or x.dim() != 1:
        raise TypeError(f"mask_streams: x must be [d] float32, got {x.dtype} {tuple(x.shape)}")
    if workers.dtype != torch.int32 or workers.dim() != 1:
        raise TypeError(f"mask_streams: workers must be [rows] int32, got {workers.dtype} "
                        f"{tuple(workers.shape)}")
    kp, recip, _ = randk.keep_prob_constants(keep_prob)
    if not runtime.on_cuda(x, workers):
        return ref.mask_streams_ref(x, workers, keep_prob, seed, int(m))
    if not (x.is_contiguous() and workers.is_contiguous()):
        raise ValueError("mask_streams: x and workers must be contiguous")
    rows, d = workers.shape[0], x.shape[0]
    sign, magbits, valid = (torch.empty((rows, d), dtype=torch.int32, device=x.device)
                            for _ in range(3))
    fn = runtime.function("encode", "mask_streams", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p])
    err = fn(x.data_ptr(), workers.data_ptr(), rows, d, seed % (1 << 32), kp, recip, int(m),
             sign.data_ptr(), magbits.data_ptr(), valid.data_ptr(), runtime.stream_ptr(x))
    runtime.check(err, "mask_streams")
    runtime.count_launch("mask_streams")
    return sign, magbits, valid


def topk_streams(x: torch.Tensor, k: int, block: int, mag):
    """(index, sign, magnitude, valid) int32 streams [nblocks, min(k, block)]
    of block top-k over fp32 x [nblocks * block] (see
    ``ref.topk_streams_ref``)."""
    m = mag_dtype(mag)
    if x.dtype != torch.float32 or x.dim() != 1:
        raise TypeError(f"topk_streams: x must be [d] float32, got {x.dtype} {tuple(x.shape)}")
    if not 0 < block <= _topk.MAX_BLOCK:
        raise ValueError(
            f"topk_streams: block={block} outside 1..{_topk.MAX_BLOCK}: a block's keys "
            f"must fit the {runtime.MAX_SMEM_BYTES}-byte (227 KB) shared-memory limit")
    if k < 1:
        raise ValueError(f"topk_streams: k={k} < 1")
    if x.shape[0] % block:
        raise ValueError(f"topk_streams: d={x.shape[0]} is not a multiple of block={block}")
    if not runtime.on_cuda(x):
        return ref.topk_streams_ref(x, k, block, int(m))
    if not x.is_contiguous():
        raise ValueError("topk_streams: x must be contiguous")
    nblocks, ks = x.shape[0] // block, min(k, block)
    streams = [torch.empty((nblocks, ks), dtype=torch.int32, device=x.device) for _ in range(4)]
    fn = runtime.function("encode", "topk_streams", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    err = fn(x.data_ptr(), nblocks, block, k, int(m), *(t.data_ptr() for t in streams),
             runtime.stream_ptr(x))
    runtime.check(err, "topk_streams")
    runtime.count_launch("topk_streams")
    return tuple(streams)


# ---------------------------------------------------------------------------
# SPARSE: compaction, packing, host assembly
# ---------------------------------------------------------------------------


def _compact_streams(idx, sign, magbits, valid):
    """Move each row's valid entries to the front in stream order (for the
    streams here, ascending index: ``np.nonzero`` order) and zero everything
    behind the count. All four are [rows, L]; returns ([3, rows, L] int32
    view: index, sign, magnitude; counts [rows] int64)."""
    rows, L = valid.shape
    slot = torch.cumsum(valid, dim=1)  # int64, inclusive
    dest = torch.where(valid != 0, slot - 1, L)  # invalid entries go to a spare column
    out = torch.zeros((3, rows, L + 1), dtype=torch.int32, device=valid.device)
    out.scatter_(2, dest.expand(3, rows, L), torch.stack([idx, sign, magbits]))
    return out[..., :L], slot[:, -1]


def _pack_sparse(streams, counts, d: int, m: MagDType):
    """Pack the three full-length streams [3, rows, L] of every row of a
    d-value message into one int32 buffer [rows, 1 + words]: column 0 the
    count, then the index, sign and magnitude words. Returns (buffer, words
    per stream)."""
    rows = counts.shape[0]
    widths = (index_width(d), 1, MAG_BITS[m])
    nws = [bs.n_words(streams.shape[-1], w) for w in widths]
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


def _empty_sparse(m: MagDType) -> bytes:
    return pack_header(CodecID.SPARSE, 0) + _SPARSE_PAYLOAD.pack(int(m), 0)


def _encode_streams(d: int, m: MagDType, idx, sign, magbits, valid) -> list[bytes]:
    """Compaction, packing, the one host read and the assembly of the
    SPARSE buffers of a d-value message per row of the streams [rows, L]."""
    streams, counts = _compact_streams(idx, sign, magbits, valid)
    buf, nws = _pack_sparse(streams, counts, d, m)
    host = buf.cpu().numpy().view("<u4")  # the one host read of the call
    return [_assemble_sparse(d, m, row, nws) for row in host]


def _arange_rows(rows: int, d: int, device) -> torch.Tensor:
    return torch.arange(d, dtype=torch.int32, device=device).expand(rows, d)


def encode_rows(X: torch.Tensor, *, mag="fp32") -> list[bytes]:
    """SPARSE encode of every message row of X [n, d] fp32: one stream
    launch, three pack launches and one host read for all n buffers. Each
    buffer equals ``wire.encode_sparse(X[i])``."""
    m = mag_dtype(mag)
    if X.dim() != 2:
        raise ValueError(f"encode_rows: X must be [n, d], got {tuple(X.shape)}")
    n, d = X.shape
    if d == 0:
        return [_empty_sparse(m)] * n
    return _encode_streams(d, m, _arange_rows(n, d, X.device), *sparse_streams(X.contiguous(), m))


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



# ---------------------------------------------------------------------------
# fused compress + SPARSE encode
# ---------------------------------------------------------------------------


def _as_f32_vector(x: torch.Tensor, what: str) -> torch.Tensor:
    if x.dim() != 1:
        raise ValueError(f"{what}: x must be [d], got {tuple(x.shape)}")
    return x.to(torch.float32).contiguous()  # the reference encodes x.astype(float32)


def mask_encode(x: torch.Tensor, *, keep_prob: float, seed: int, worker: int = 0,
                mag="fp32") -> bytes:
    """Fused BernK compress + SPARSE encode of x [d]: one ``mask_streams``
    launch. Equals ``wire.encode_sparse(ops.bernk(x, keep_prob=..., seed=...,
    worker=...))`` for fp32 x; with ``seed = msg.seed + msg.round`` its mask
    is the SEED codec's BERN mask (its values are not: that decode divides,
    see ``ref.bernk_ref``)."""
    m = mag_dtype(mag)
    x = _as_f32_vector(x, "mask_encode")
    if x.shape[0] == 0:
        return _empty_sparse(m)
    workers = torch.full((1,), _i32_pattern(worker), dtype=torch.int32, device=x.device)
    d = x.shape[0]
    return _encode_streams(d, m, _arange_rows(1, d, x.device),
                           *mask_streams(x, workers, keep_prob, seed, m))[0]


def encode_per_worker(x: torch.Tensor, *, n_workers: int, keep_prob: float, seed: int,
                      mode: str = "ind", mag="fp32") -> list[bytes]:
    """The n per-worker BernK messages of one shared x [d], SPARSE-encoded.

    ``mode="ind"`` hashes each worker id independently: one ``mask_streams``
    launch over n worker rows and one host read; ``mode="same"`` encodes
    worker 0 once and repeats the buffer. Each buffer equals the matching
    :func:`mask_encode` call."""
    if mode == "same":
        return [mask_encode(x, keep_prob=keep_prob, seed=seed, worker=0, mag=mag)] * n_workers
    if mode != "ind":
        raise ValueError(f"encode_per_worker mode must be ind|same, got {mode!r}")
    m = mag_dtype(mag)
    x = _as_f32_vector(x, "encode_per_worker")
    d = x.shape[0]
    if d == 0:
        return [_empty_sparse(m)] * n_workers
    workers = torch.arange(n_workers, dtype=torch.int32, device=x.device)
    return _encode_streams(d, m, _arange_rows(n_workers, d, x.device),
                           *mask_streams(x, workers, keep_prob, seed, m))


def topk_encode(x: torch.Tensor, *, k_per_block: int, block: int = 1024, mag="fp32") -> bytes:
    """Fused block-TopK compress + SPARSE encode of x [d] (zero-padded to a
    multiple of ``block``): one ``topk_streams`` launch, then the compaction
    over the per-block slots. Equals ``wire.encode_sparse(ops.block_topk(x,
    k_per_block=..., block=...))`` for fp32 x."""
    m = mag_dtype(mag)
    x = _as_f32_vector(x, "topk_encode")
    d = x.shape[0]
    if d == 0:
        return _empty_sparse(m)
    xp = torch.nn.functional.pad(x, (0, (-d) % block))
    streams = topk_streams(xp, k_per_block, block, m)
    return _encode_streams(d, m, *(t.reshape(1, -1) for t in streams))[0]


# ---------------------------------------------------------------------------
# decode on the card
# ---------------------------------------------------------------------------

_NATURAL_BITS = 9  # wire/natural.py's token: [sign:1][biased exponent:8]


def _f16_to_f32_bits(h: torch.Tensor) -> torch.Tensor:
    """fp32 patterns of fp16 patterns, int64 in and out: numpy's
    ``npy_halfbits_to_floatbits``, as ``wire.sparse.f16_to_f32_bits`` (exact;
    NaN payloads shifted up, a signalling NaN stays signalling)."""
    h = h & 0xFFFF
    sgn = (h & 0x8000) << 16
    hexp = h & 0x7C00
    hsig = h & 0x03FF
    # subnormal: hsig * 2**-24 = 1.f * 2**(p - 24), p the top set bit of hsig
    p = torch.zeros_like(hsig)
    for k in range(1, 10):
        p = torch.where((hsig >> k) != 0, k, p)
    sub = ((p + 103) << 23) + (torch.bitwise_left_shift(hsig, 23 - p) & 0x007FFFFF)
    sub = torch.where(hsig == 0, 0, sub)
    special = 0x7F800000 | (hsig << 13)
    normal = ((h & 0x7FFF) + 0x1C000) << 13
    return sgn | torch.where(hexp == 0, sub, torch.where(hexp == 0x7C00, special, normal))


def _from_wire_bits(b: torch.Tensor, m: MagDType) -> torch.Tensor:
    """fp32 patterns (int64) of wire-dtype patterns (int64)."""
    if m == MagDType.FP32:
        return b
    return _f16_to_f32_bits(b) if m == MagDType.FP16 else (b & 0xFFFF) << 16


def _words(buf: bytes, offset: int, nwords: int, device) -> torch.Tensor:
    """``nwords`` little-endian u32 words of ``buf`` from ``offset`` as an
    int32 tensor on ``device`` (one host-to-device copy)."""
    host = np.frombuffer(buf, dtype="<i4", count=nwords, offset=offset)
    return torch.from_numpy(host.copy()).to(device)


def _mag(m: int, what: str) -> MagDType:
    try:
        return MagDType(m)
    except ValueError as e:
        raise CorruptFrame(f"corrupt {what} wire message: bad mag dtype {m}") from e


def _scatter_last(idx: torch.Tensor, vals: torch.Tensor, d: int) -> torch.Tensor:
    """int32 [d]: zeros with ``vals[i]`` at ``idx[i]``, the last entry winning
    where an index repeats (numpy's ``out[idx] = vals``). A scatter with
    duplicates on CUDA keeps an arbitrary one, so the entries are sorted
    stably by index and all but the last of each run go to a spare slot."""
    order = torch.sort(idx, stable=True).indices
    s = idx[order]
    last = torch.ones_like(s, dtype=torch.bool)
    last[:-1] = s[1:] != s[:-1]
    out = torch.zeros(d + 1, dtype=torch.int32, device=idx.device)
    out.scatter_(0, torch.where(last, s, d), vals[order])
    return out[:d]


def _decode_streams(buf: bytes, device) -> torch.Tensor:
    """The torch decode behind :func:`decode_device` on ``device``: the host
    codec's checks in its order, the streams unpacked by ``ops.unpack_bits``
    (the kernel on a CUDA device, its plain version on the CPU), the fp16 /
    bf16 -> fp32 conversions on bit patterns."""
    codec, d = unpack_header(buf)
    off = HEADER_BYTES
    if codec == CodecID.SPARSE:
        if len(buf) < off + _SPARSE_PAYLOAD.size:
            raise TruncatedFrame("truncated sparse wire message")
        m, count = _SPARSE_PAYLOAD.unpack_from(buf, off)
        m = _mag(m, "sparse")
        off += _SPARSE_PAYLOAD.size
        if count > d:
            raise CorruptFrame(f"corrupt sparse wire message: count {count} > d={d}")
        widths = (index_width(d), 1, MAG_BITS[m])
        nws = [bs.n_words(count, w) for w in widths]
        if len(buf) < off + 4 * sum(nws):
            raise TruncatedFrame("truncated sparse wire message")
        words = _words(buf, off, sum(nws), device)
        streams, o = [], 0
        for w, nw in zip(widths, nws):
            streams.append(ref.u32(ops.unpack_bits(words[o:o + nw], w, count)))
            o += nw
        idx, sign, magbits = streams
        if count:
            top = int(idx.max())
            if top >= d:
                raise CorruptFrame(f"corrupt sparse wire message: index {top} >= d={d}")
        vals = ref.as_i32(_from_wire_bits(magbits, m) ^ (sign << 31))
        return _scatter_last(idx, vals, d).view(torch.float32)
    if codec == CodecID.NATURAL:
        nw = bs.n_words(d, _NATURAL_BITS)
        if len(buf) < off + 4 * nw:
            raise TruncatedFrame("truncated natural wire message")
        token = ref.u32(ops.unpack_bits(_words(buf, off, nw, device), _NATURAL_BITS, d))
        return ref.as_i32(((token >> 8) << 31) | ((token & 0xFF) << 23)).view(torch.float32)
    if codec == CodecID.DENSE:
        if len(buf) < off + _DENSE_PAYLOAD.size:
            raise TruncatedFrame("truncated dense wire message")
        (m,) = _DENSE_PAYLOAD.unpack_from(buf, off)
        m = _mag(m, "dense")
        off += _DENSE_PAYLOAD.size
        nw = bs.n_words(d, MAG_BITS[m])
        if len(buf) < off + 4 * nw:
            raise TruncatedFrame("truncated dense wire message")
        bits = ref.u32(ops.unpack_bits(_words(buf, off, nw, device), MAG_BITS[m], d))
        return ref.as_i32(_from_wire_bits(bits, m)).view(torch.float32)
    raise ValueError(f"{codec.name} wire messages carry no payload to decode on a device; "
                     "the SEED codec needs the receiver-local delta (wire.decode(buf, delta=...))")


def decode_device(buf: bytes, device="cuda") -> torch.Tensor:
    """Decode a SPARSE, NATURAL or DENSE wire message to fp32 [d] on
    ``device``, bit for bit what the host codec (``wire.decode``) gives.

    On the card every stream is unpacked by the ``unpack_bits`` kernel and
    the rest (checks, fp16/bf16 -> fp32 on bit patterns, the scatter) are
    torch ops there, so a model update is decoded where the parameters live;
    only the message's bytes cross to the card. On the CPU the host codec is
    the plain version. Raises what ``wire.decode`` raises, with the same
    exception types (TruncatedFrame, CorruptFrame); a SEED message raises
    ValueError."""
    dev = runtime.resolve_device(device)
    codec, _ = unpack_header(buf)
    if codec == CodecID.SEED or dev.type == "cuda":
        return _decode_streams(buf, dev)
    from .. import wire

    return torch.from_numpy(wire.decode(buf))
