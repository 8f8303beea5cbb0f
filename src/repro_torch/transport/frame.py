"""Length-prefixed transport frames with CRC32C trailers (DESIGN.md §8.1).

A frame wraps one wire message (repro_torch.wire buffer) or a control payload:

    [u16 magic = 0x4652 ("FR")] [u8 version] [u8 ftype]
    [u32 seq] [u32 length]                      <- 12-byte header
    [payload: length bytes]
    [u32 crc32c over header + payload]          <- 4-byte trailer

All integers little-endian. ``seq`` is a per-link monotonic counter for
DATA/SYNC frames (control frames carry the seq they refer to). The CRC is
CRC32C (Castagnoli, reflected poly 0x82F63B78) over everything before the
trailer, so a single flipped bit anywhere in the frame is detected.

Decode failures reuse the wire exception hierarchy — a short buffer
raises :class:`~repro_torch.wire.TruncatedFrame`, a bad magic/version/CRC raises
:class:`~repro_torch.wire.CorruptFrame` — so receivers classify transport- and
codec-level damage uniformly.

A copy of ``repro/transport/frame.py`` on the port's wire errors: frames and
CRCs are byte-identical to the reference's.
"""
from __future__ import annotations

import dataclasses
import enum
import struct

from ..wire.spec import CorruptFrame, TruncatedFrame

FRAME_MAGIC = 0x4652  # "FR"
FRAME_VERSION = 1

_HEADER = struct.Struct("<HBBII")
HEADER_BYTES = _HEADER.size  # 12
CRC_BYTES = 4
FRAME_OVERHEAD = HEADER_BYTES + CRC_BYTES  # 16 bytes per frame
MAX_PAYLOAD = 1 << 30  # sanity bound: a corrupt length field cannot OOM us


class FrameType(enum.IntEnum):
    DATA = 1     # incremental payload; only valid at seq == expected
    SYNC = 2     # self-contained payload; repairs any sequence gap
    ACK = 3      # cumulative: "I have delivered everything below seq"
    NAK = 4      # "retransmit from seq" (corrupt frame or gap detected)
    RESYNC = 5   # "I cannot be repaired by replay; promote to a SYNC"


@dataclasses.dataclass(frozen=True)
class Frame:
    ftype: FrameType
    seq: int
    payload: bytes = b""

    @property
    def is_control(self) -> bool:
        return self.ftype in (FrameType.ACK, FrameType.NAK, FrameType.RESYNC)


# -- CRC32C (Castagnoli) ------------------------------------------------------

_CRC_POLY = 0x82F63B78


def _make_tables(n: int = 8) -> tuple:
    """Slicing-by-n lookup tables (table 0 is the classic byte table)."""
    t0 = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (_CRC_POLY if crc & 1 else 0)
        t0.append(crc)
    tables = [tuple(t0)]
    for k in range(1, n):
        prev = tables[k - 1]
        tables.append(tuple(t0[v & 0xFF] ^ (v >> 8) for v in prev))
    return tuple(tables)


_T = _make_tables()


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC32C of ``data``; chainable via the ``crc`` argument.

    Pure-python slicing-by-8 — no hardware CRC dependency; tens of MB/s,
    plenty for frame trailers (bulk payload speed lives in the codecs).
    """
    c = ~crc & 0xFFFFFFFF
    t0, t1, t2, t3, t4, t5, t6, t7 = _T
    mv = memoryview(data)
    n8 = len(mv) - (len(mv) % 8)
    for i in range(0, n8, 8):
        c ^= int.from_bytes(mv[i : i + 4], "little")
        hi = int.from_bytes(mv[i + 4 : i + 8], "little")
        c = (
            t7[c & 0xFF] ^ t6[(c >> 8) & 0xFF] ^ t5[(c >> 16) & 0xFF] ^ t4[c >> 24]
            ^ t3[hi & 0xFF] ^ t2[(hi >> 8) & 0xFF] ^ t1[(hi >> 16) & 0xFF] ^ t0[hi >> 24]
        )
    for b in mv[n8:]:
        c = t0[(c ^ b) & 0xFF] ^ (c >> 8)
    return ~c & 0xFFFFFFFF


# -- encode / decode ----------------------------------------------------------


def encode_frame(ftype: FrameType, seq: int, payload: bytes = b"") -> bytes:
    head = _HEADER.pack(FRAME_MAGIC, FRAME_VERSION, int(ftype), seq & 0xFFFFFFFF,
                        len(payload))
    body = head + payload
    return body + struct.pack("<I", crc32c(body))


def is_frame(buf: bytes) -> bool:
    """True if ``buf`` starts with the transport frame magic (cheap peek —
    lets endpoints accept both framed and bare wire messages)."""
    return len(buf) >= 2 and struct.unpack_from("<H", buf, 0)[0] == FRAME_MAGIC


def decode_frame(buf: bytes, offset: int = 0) -> tuple[Frame, int]:
    """Decode one frame at ``offset``; returns (frame, next_offset).

    Raises :class:`TruncatedFrame` when the buffer ends early and
    :class:`CorruptFrame` on magic/version/type/length/CRC damage.
    """
    if len(buf) < offset + HEADER_BYTES:
        raise TruncatedFrame("truncated transport frame (no header)")
    magic, version, ftype, seq, length = _HEADER.unpack_from(buf, offset)
    if magic != FRAME_MAGIC:
        raise CorruptFrame(f"bad frame magic {magic:#x}")
    if version != FRAME_VERSION:
        raise CorruptFrame(f"unsupported frame version {version}")
    try:
        ftype = FrameType(ftype)
    except ValueError as e:
        raise CorruptFrame(f"unknown frame type {ftype}") from e
    if length > MAX_PAYLOAD:
        raise CorruptFrame(f"frame length {length} exceeds bound")
    end = offset + HEADER_BYTES + length + CRC_BYTES
    if len(buf) < end:
        raise TruncatedFrame(
            f"truncated transport frame ({len(buf) - offset} of {end - offset} bytes)"
        )
    body = buf[offset : end - CRC_BYTES]
    (want,) = struct.unpack_from("<I", buf, end - CRC_BYTES)
    got = crc32c(body)
    if got != want:
        raise CorruptFrame(f"frame CRC mismatch ({got:#x} != {want:#x})")
    return Frame(ftype=ftype, seq=seq, payload=bytes(buf[offset + HEADER_BYTES : end - CRC_BYTES])), end
