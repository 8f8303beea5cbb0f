"""Codec registry and top-level encode/decode dispatch (port of
``repro/wire/registry.py``).

``decode(buf)`` inspects the common header and routes to the right codec.
Payload-carrying codecs (SPARSE / NATURAL / DENSE) decode to a dense fp32
vector standalone; the SEED codec needs the receiver-local ``delta``
(DESIGN.md §2) and raises without it.

``codec_for`` maps the port's compressor families to their natural wire
codec: Identity -> DENSE, TopK / BlockTopK / RandK / ScaledUnbiased ->
SPARSE, PermK / RotK / BernK -> SEED, NaturalCompression -> NATURAL.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import compressors as C
from .natural import decode_natural, encode_natural
from .seedonly import apply_seed, decode_seed
from .sparse import decode_dense, decode_sparse, encode_dense, encode_sparse
from .spec import HEADER_BYTES, CodecID, unpack_header


def decode(buf: bytes, *, delta=None) -> np.ndarray:
    """Decode a wire message to a dense fp32 vector [d] on the host.

    ``delta`` (receiver-local replicated vector) is required for SEED
    messages and ignored otherwise.
    """
    codec, d = unpack_header(buf)
    if codec == CodecID.SPARSE:
        return decode_sparse(buf, HEADER_BYTES, d)
    if codec == CodecID.NATURAL:
        return decode_natural(buf, HEADER_BYTES, d)
    if codec == CodecID.DENSE:
        return decode_dense(buf, HEADER_BYTES, d)
    if codec == CodecID.SEED:
        if delta is None:
            raise ValueError(
                "SEED message needs the receiver-local delta to rematerialize"
            )
        msg = decode_seed(buf, HEADER_BYTES, d)
        return apply_seed(msg, delta)
    raise ValueError(codec)  # pragma: no cover


def peek(buf: bytes) -> tuple[CodecID, int]:
    """(codec, d) of a message without decoding the payload."""
    return unpack_header(buf)


def codec_for(comp: C.Compressor) -> CodecID:
    """The natural wire codec for a compressor family."""
    if isinstance(comp, (C.BernK, C.RotK, C.PermK)):
        return CodecID.SEED
    if isinstance(comp, C.NaturalCompression):
        return CodecID.NATURAL
    if isinstance(comp, C.Identity):
        return CodecID.DENSE
    return CodecID.SPARSE


def _device_path(x, device_encode: Optional[bool]) -> bool:
    """Take the device path (``kernels/encode.py``) for ``x``? Only a tensor
    can; ``device_encode`` True forces it, False forces the host numpy codec,
    None takes it for a CUDA tensor. Both give the same bytes."""
    from ..kernels import encode as kenc

    return isinstance(x, torch.Tensor) and kenc.device_encode_enabled(device_encode, x)


def encode(x, comp: Optional[C.Compressor] = None, *, mag="fp32",
           device_encode: Optional[bool] = None) -> bytes:
    """Encode a compressor output with its family's natural payload codec.

    SEED-family compressors still encode here as SPARSE (explicit payload):
    a true O(1) SEED message needs the RNG coordinates, not just the
    output — use :func:`repro_torch.wire.encode_seed` for that.

    NATURAL payloads are encoded on the host, before any device path is
    considered (the reference's order); ``device_encode`` picks the encoder
    of SPARSE/DENSE payloads (see :func:`_device_path`).
    """
    codec = codec_for(comp) if comp is not None else CodecID.SPARSE
    if codec == CodecID.NATURAL:
        return encode_natural(x.detach().cpu() if isinstance(x, torch.Tensor) else x)
    if _device_path(x, device_encode):
        from ..kernels import encode as kenc

        if codec == CodecID.DENSE:
            return kenc.dense_encode(x, mag=mag)
        return kenc.sparse_encode(x, mag=mag)
    if codec == CodecID.DENSE:
        return encode_dense(x, mag=mag)
    return encode_sparse(x, mag=mag)


def encode_rows(X, *, mag="fp32", device_encode: Optional[bool] = None) -> list[bytes]:
    """SPARSE encode of every message row of X [n, d]; the device path does
    all rows in one batch (``kernels.encode.encode_rows``). ``device_encode``
    as in :func:`encode`."""
    if _device_path(X, device_encode):
        from ..kernels import encode as kenc

        return kenc.encode_rows(X, mag=mag)
    if isinstance(X, torch.Tensor):
        X = X.detach().cpu().numpy()
    return [encode_sparse(row, mag=mag) for row in X]
