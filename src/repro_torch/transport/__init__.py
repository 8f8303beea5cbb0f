"""repro_torch.transport — fault-tolerant framing + delivery for wire messages
(a copy of ``repro.transport`` on the port's wire errors and tracing).

The layer between the repro_torch.wire codecs (byte buffers) and the training /
serving loops that must survive a lossy WAN (DESIGN.md §8):

* :mod:`~repro_torch.transport.frame` — length-prefixed frames with CRC32C
  trailers and monotonic sequence numbers;
* :mod:`~repro_torch.transport.channel` — the Channel protocol, in-process
  loopback, and the fault-injecting wrapper;
* :mod:`~repro_torch.transport.faults` — seeded :class:`FaultSpec` failure
  models (drop / corrupt / truncate / duplicate / reorder / straggler);
* :mod:`~repro_torch.transport.link` — reliable delivery: retry with
  exponential backoff, bounded replay, receiver gap detection, and the
  resync handshake that lets MARINA-P promote its next round to a full
  sync broadcast (and EF21-P re-anchor its shift) instead of dying.
"""
from .channel import Channel, FaultyChannel, LoopbackChannel  # noqa: F401
from .faults import FAULT_CLASSES, FaultInjector, FaultSpec  # noqa: F401
from .frame import (  # noqa: F401
    CRC_BYTES,
    FRAME_OVERHEAD,
    HEADER_BYTES,
    Frame,
    FrameType,
    crc32c,
    decode_frame,
    encode_frame,
    is_frame,
)
from .link import (  # noqa: F401
    DeliveryFailed,
    Fleet,
    Link,
    LinkStats,
    SequenceGap,
    StaleDelta,
    TransportError,
)
