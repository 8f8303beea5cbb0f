"""repro_torch.wire — packed bitstream codecs for compressed downlink
messages (port of ``repro.wire``, byte-identical to it, numpy only):

* SPARSE  — (index: ceil(log2 d) bits, sign: 1 bit, magnitude:
  fp32/fp16/bf16) for RandK / TopK / BlockTopK messages;
* SEED    — O(1) bytes of RNG coordinates for shared-randomness families;
* NATURAL — sign + exponent, 9 bits/value;
* DENSE   — raw values for full-sync broadcast rounds.

Layout reference: DESIGN.md §3. The device path for SPARSE/DENSE is
``repro_torch/kernels/encode.py``; measured-vs-analytic parity:
``python -m repro_torch.wire_bench``.
"""
from .bitstream import from_bytes, n_words, pack_u32, to_bytes, unpack_u32  # noqa: F401
from .natural import decode_natural, encode_natural  # noqa: F401
from .registry import codec_for, decode, encode, encode_rows, peek  # noqa: F401
from .seedonly import apply_seed, decode_seed, encode_seed  # noqa: F401
from .sparse import decode_dense, decode_sparse, encode_dense, encode_sparse  # noqa: F401
from .spec import (  # noqa: F401
    HEADER_BYTES,
    MAG_BITS,
    CodecID,
    CorruptFrame,
    MagDType,
    SeedFamily,
    SeedMessage,
    TruncatedFrame,
    WireError,
    index_width,
    mag_dtype,
)


def measured_bits(buf: bytes) -> int:
    """Wire size of an encoded message, in bits."""
    return 8 * len(buf)
