"""Wire format constants, header layout and message specs (DESIGN.md §3).

Every message starts with an 8-byte common header:

    [u16 magic = 0x5749 ("WI")] [u8 version] [u8 codec_id] [u32 d]

followed by a codec-specific payload. All integers are little-endian;
all bit streams follow bitstream.py's LSB-first uint32-word convention.

A copy of ``repro/wire/spec.py`` (standard library only), kept so that the
port imports nothing of ``repro``.
"""
from __future__ import annotations

import dataclasses
import enum
import math
import struct

MAGIC = 0x5749  # "WI"
VERSION = 1

_HEADER = struct.Struct("<HBBI")
HEADER_BYTES = _HEADER.size  # 8


class WireError(ValueError):
    """Base class for wire-level decode failures.

    Subclasses ``ValueError`` so pre-hierarchy callers keep working; the
    transport layer (repro.transport) catches the subclasses to tell a
    retransmit-recoverable failure from a poisoned message.
    """


class TruncatedFrame(WireError):
    """Buffer ended before the declared payload — recoverable: the rest of
    the message may still arrive (or a retransmit will carry it whole)."""


class CorruptFrame(WireError):
    """Contents fail validation (magic / version / CRC / field range) —
    the message itself is damaged and must be retransmitted or resynced."""


class CodecID(enum.IntEnum):
    SPARSE = 1   # (index, sign, magnitude) streams
    SEED = 2     # shared-randomness coordinates, O(1) bytes
    NATURAL = 3  # sign + fp32 exponent, 9 bits/value, dense
    DENSE = 4    # raw values, dense


class MagDType(enum.IntEnum):
    """Magnitude dtype selector for SPARSE/DENSE payloads."""

    FP32 = 0
    FP16 = 1
    BF16 = 2


#: wire bits per magnitude for each dtype selector
MAG_BITS = {MagDType.FP32: 32, MagDType.FP16: 16, MagDType.BF16: 16}

_MAG_NAMES = {"fp32": MagDType.FP32, "fp16": MagDType.FP16, "bf16": MagDType.BF16}


def mag_dtype(name_or_enum) -> MagDType:
    if isinstance(name_or_enum, MagDType):
        return name_or_enum
    return _MAG_NAMES[str(name_or_enum)]


class SeedFamily(enum.IntEnum):
    """Shared-randomness compressor families the SEED codec can carry."""

    BERN = 0   # counter-hash Bernoulli mask (kernels/randk.py)
    ROTK = 1   # cyclic partition with shared rotation
    PERM = 2   # Definition 5 PermK via a jax.random permutation


@dataclasses.dataclass(frozen=True)
class SeedMessage:
    """O(1) downlink message for shared-randomness compressors.

    The receiver already holds the (replicated) ``delta``; these fields are
    the RNG coordinates it needs to rematerialize its mask locally
    (DESIGN.md §2). ``param`` is family-specific: keep_prob for BERN,
    rotation for ROTK, unused for PERM.
    """

    family: SeedFamily
    seed: int          # uint32 counter seed / PRNGKey seed
    round: int         # uint32 round counter (folded into the key)
    scale: float       # multiplier applied to kept coordinates
    n: int             # worker-family size
    worker: int        # receiver's worker index
    param: float = 0.0


def index_width(d: int) -> int:
    """ceil(log2 d) bits per coordinate index (min 1)."""
    return max(1, math.ceil(math.log2(max(d, 2))))


def pack_header(codec: CodecID, d: int) -> bytes:
    return _HEADER.pack(MAGIC, VERSION, int(codec), d)


def unpack_header(buf: bytes) -> tuple[CodecID, int]:
    if len(buf) < HEADER_BYTES:
        raise TruncatedFrame("truncated wire message (no header)")
    magic, version, codec, d = _HEADER.unpack_from(buf, 0)
    if magic != MAGIC:
        raise CorruptFrame(f"bad magic {magic:#x}")
    if version != VERSION:
        raise CorruptFrame(f"unsupported wire version {version}")
    try:
        codec = CodecID(codec)
    except ValueError as e:
        raise CorruptFrame(f"unknown codec id {codec}") from e
    return codec, d
