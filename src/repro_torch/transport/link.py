"""Reliable delivery over unreliable channels (DESIGN.md §8.3).

One :class:`Link` is a unidirectional reliable pipe: a sender endpoint and
a receiver endpoint joined by a data channel (server -> worker) and an ack
channel (worker -> server), either of which may be a
:class:`~repro_torch.transport.channel.FaultyChannel`. The protocol:

* every payload is framed (CRC32C + monotonic ``seq`` — frame.py);
* the receiver delivers strictly in order, stashes bounded out-of-order
  arrivals, re-acks duplicates, and answers damage/gaps with NAK(expected)
  (cumulative ACKs carry the *next needed* seq);
* the sender keeps a bounded replay ring; NAKs inside the ring replay
  immediately, timeouts retransmit with exponential backoff, and when the
  ring can no longer repair the gap (or retries exhaust) the link flags
  ``resync_needed`` — the *application* then promotes its next message to
  a self-contained SYNC frame (MARINA-P: the Bernoulli full-broadcast
  branch; EF21-P: a dense shift re-anchor), which repairs any gap.

Latency is virtual (channel ticks), so every retry/backoff/recovery path
is deterministic under a seeded FaultSpec. :class:`Fleet` bundles one link
per worker and aggregates counters into ``transport/*`` metrics for
repro_torch.obs trackers.

A copy of ``repro/transport/link.py`` on the port's wire errors and
``repro_torch.obs.trace``.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Dict, List, Optional

from ..obs.trace import maybe_attr, maybe_span
from ..wire.spec import CorruptFrame, TruncatedFrame, WireError

from .channel import Channel, FaultyChannel, LoopbackChannel
from .faults import FaultSpec
from .frame import Frame, FrameType, decode_frame, encode_frame


class TransportError(RuntimeError):
    """Base class for link-level (non-codec) transport failures."""


class DeliveryFailed(TransportError):
    """Sender exhausted its retry budget; the link needs a resync."""


class StaleDelta(TransportError):
    """A framed delta's seq is at or behind the last applied one."""


class SequenceGap(TransportError):
    """A framed DATA delta skips ahead — applying it would corrupt state."""


@dataclasses.dataclass
class LinkStats:
    """Counters for one link (aggregated fleet-wide by :class:`Fleet`)."""

    frames_sent: int = 0          # first transmissions (DATA + SYNC)
    retries: int = 0              # retransmissions (timeout or NAK replay)
    resyncs: int = 0              # times the link entered resync_needed
    forced_syncs: int = 0         # SYNC frames sent to repair the link
    delivery_failures: int = 0    # sends that exhausted the retry budget
    corrupt_detected: int = 0     # CRC/codec damage caught at the receiver
    truncated_detected: int = 0
    duplicates_dropped: int = 0
    gaps_detected: int = 0
    delivered_frames: int = 0
    payload_bytes_delivered: int = 0
    wire_bytes_sent: int = 0      # includes retransmits + frame overhead
    recovery_ticks: List[int] = dataclasses.field(default_factory=list)

    @property
    def goodput(self) -> float:
        """Delivered payload bytes / total wire bytes sent (with overhead)."""
        if self.wire_bytes_sent == 0:
            return 1.0
        return self.payload_bytes_delivered / self.wire_bytes_sent

    def merge(self, other: "LinkStats") -> None:
        for f in dataclasses.fields(self):
            if f.name == "recovery_ticks":
                self.recovery_ticks.extend(other.recovery_ticks)
            else:
                setattr(self, f.name, getattr(self, f.name) + getattr(other, f.name))

    def as_metrics(self, prefix: str = "transport") -> Dict[str, float]:
        rec = self.recovery_ticks
        return {
            f"{prefix}/frames_sent": self.frames_sent,
            f"{prefix}/retries": self.retries,
            f"{prefix}/resyncs": self.resyncs,
            f"{prefix}/forced_syncs": self.forced_syncs,
            f"{prefix}/delivery_failures": self.delivery_failures,
            f"{prefix}/corrupt_detected": self.corrupt_detected,
            f"{prefix}/truncated_detected": self.truncated_detected,
            f"{prefix}/duplicates_dropped": self.duplicates_dropped,
            f"{prefix}/gaps_detected": self.gaps_detected,
            f"{prefix}/delivered_frames": self.delivered_frames,
            f"{prefix}/goodput": self.goodput,
            f"{prefix}/recovery_ticks_mean": (sum(rec) / len(rec)) if rec else 0.0,
            f"{prefix}/recovery_ticks_max": max(rec) if rec else 0.0,
        }


class _Receiver:
    """Receiver endpoint: validate, order, deliver; answer with ACK/NAK."""

    def __init__(self, stats: LinkStats, *, window: int = 32) -> None:
        self.stats = stats
        self.window = window
        self.expected = 0
        self.delivered: collections.deque = collections.deque()
        self._stash: Dict[int, bytes] = {}
        self._last_naked = -1

    def on_frame(self, raw: bytes) -> List[bytes]:
        """Process one arrival; returns control frames for the ack channel."""
        try:
            frame, _ = decode_frame(raw)
        except TruncatedFrame:
            self.stats.truncated_detected += 1
            return self._nak()
        except CorruptFrame:
            self.stats.corrupt_detected += 1
            return self._nak()
        if frame.is_control:  # misrouted control frame: ignore
            return []
        if frame.ftype == FrameType.SYNC:
            if frame.seq < self.expected:  # stale duplicate of an old sync
                self.stats.duplicates_dropped += 1
                return [self._ack()]
            self._deliver(frame)
            self.expected = frame.seq + 1
            self._stash = {s: p for s, p in self._stash.items() if s >= self.expected}
            self._flush()
            return [self._ack()]
        # DATA
        if frame.seq < self.expected or frame.seq in self._stash:
            self.stats.duplicates_dropped += 1
            return [self._ack()]
        if frame.seq == self.expected:
            self._deliver(frame)
            self.expected += 1
            self._flush()
            self._last_naked = -1
            return [self._ack()]
        # gap: frame.seq > expected
        self.stats.gaps_detected += 1
        if frame.seq < self.expected + self.window:
            self._stash[frame.seq] = frame.payload
        return self._nak() + [self._ack()]

    def _deliver(self, frame: Frame) -> None:
        self.delivered.append(frame.payload)
        self.stats.delivered_frames += 1
        self.stats.payload_bytes_delivered += len(frame.payload)

    def _flush(self) -> None:
        while self.expected in self._stash:
            payload = self._stash.pop(self.expected)
            self.delivered.append(payload)
            self.stats.delivered_frames += 1
            self.stats.payload_bytes_delivered += len(payload)
            self.expected += 1

    def _ack(self) -> bytes:
        return encode_frame(FrameType.ACK, self.expected)

    def _nak(self) -> List[bytes]:
        if self._last_naked == self.expected:
            return []  # one NAK per missing seq; duplicates add nothing
        self._last_naked = self.expected
        return [encode_frame(FrameType.NAK, self.expected)]


class _Sender:
    """Sender endpoint: seq assignment, bounded replay ring, NAK replay."""

    def __init__(self, data: Channel, stats: LinkStats, *, replay_depth: int) -> None:
        self.data = data
        self.stats = stats
        self.replay_depth = replay_depth
        self.next_seq = 0
        self.acked_upto = 0  # every seq below this is delivered
        self.resync_needed = False
        self._replay: "collections.OrderedDict[int, bytes]" = collections.OrderedDict()

    def transmit_new(self, payload: bytes, ftype: FrameType) -> int:
        seq = self.next_seq
        self.next_seq += 1
        raw = encode_frame(ftype, seq, payload)
        self._replay[seq] = raw
        while len(self._replay) > self.replay_depth:
            self._replay.popitem(last=False)
        self.stats.frames_sent += 1
        self._put(raw)
        return seq

    def retransmit(self, seq: int) -> bool:
        raw = self._replay.get(seq)
        if raw is None:
            return False
        self.stats.retries += 1
        self._put(raw)
        return True

    def on_control(self, raw: bytes) -> None:
        try:
            frame, _ = decode_frame(raw)
        except WireError:
            return  # damaged ack/nak: the retry timer covers it
        if frame.ftype == FrameType.ACK:
            if frame.seq > self.acked_upto:
                self.acked_upto = frame.seq
                for s in [s for s in self._replay if s < frame.seq]:
                    del self._replay[s]
        elif frame.ftype == FrameType.NAK:
            # replay everything from the hole; a miss means the ring was
            # evicted and only an application-level SYNC can repair it
            missing = [s for s in range(frame.seq, self.next_seq) if s >= self.acked_upto]
            for s in missing:
                if not self.retransmit(s):
                    self._flag_resync()
                    break
        elif frame.ftype == FrameType.RESYNC:
            self._flag_resync()

    def _flag_resync(self) -> None:
        if not self.resync_needed:
            self.resync_needed = True
            self.stats.resyncs += 1

    def _put(self, raw: bytes) -> None:
        self.stats.wire_bytes_sent += len(raw)
        self.data.send(raw)


class Link:
    """In-process reliable link driving both endpoints' virtual clocks.

    ``send`` blocks (in virtual ticks, not wall time) until the payload is
    cumulatively acked or the retry budget is spent. A socket transport
    would split the two endpoints across processes and replace ``_pump``
    with its event loop; the framing and recovery logic stay as-is.
    """

    def __init__(
        self,
        *,
        fault_spec: Optional[FaultSpec] = None,
        ack_fault_spec: Optional[FaultSpec] = None,
        timeout: int = 4,
        max_retries: int = 8,
        backoff: float = 2.0,
        replay_depth: int = 32,
        window: int = 32,
        name: str = "link",
    ) -> None:
        self.name = name
        self.stats = LinkStats()
        self.tracker = None  # repro_torch.obs Tracker: per-send link/* spans (§10)
        data: Channel = LoopbackChannel()
        if fault_spec is not None and fault_spec.any_faults:
            data = FaultyChannel(data, fault_spec)
        ack: Channel = LoopbackChannel()
        if ack_fault_spec is not None and ack_fault_spec.any_faults:
            ack = FaultyChannel(ack, ack_fault_spec)
        self.data = data
        self.ack = ack
        self.timeout = timeout
        self.max_retries = max_retries
        self.backoff = backoff
        self.sender = _Sender(data, self.stats, replay_depth=replay_depth)
        self.receiver = _Receiver(self.stats, window=window)

    @property
    def resync_needed(self) -> bool:
        return self.sender.resync_needed

    def send(self, payload: bytes, *, sync: bool = False) -> bool:
        """Deliver one payload reliably; returns False on delivery failure.

        ``sync=True`` sends a self-contained SYNC frame, which repairs any
        receiver-side gap and clears the link's resync flag on delivery.

        With a ``tracker`` attached, the whole send -> ack cycle is traced
        as a ``link/<name>`` span (retry/resync deltas and the carried
        LinkStats counters as attrs, DESIGN.md §10.2), with a zero-width
        ``link/<name>/retry`` marker span per retransmission attempt.
        """
        was_resync = self.sender.resync_needed
        r0, rs0, tick0 = self.stats.retries, self.stats.resyncs, self.data.now
        with maybe_span(
            self.tracker, f"link/{self.name}",
            ftype="SYNC" if sync else "DATA", bytes=len(payload),
        ) as sp:
            ok = self._send(payload, sync=sync)
            maybe_attr(
                sp,
                delivered=ok,
                seq=self.sender.next_seq - 1,
                retries=self.stats.retries - r0,
                resyncs=self.stats.resyncs - rs0,
                resync_needed=self.sender.resync_needed,
                repaired_resync=bool(sync and was_resync and ok),
                ticks=self.data.now - tick0,
            )
        return ok

    def _send(self, payload: bytes, *, sync: bool = False) -> bool:
        ftype = FrameType.SYNC if sync else FrameType.DATA
        if sync and self.sender.resync_needed:
            self.stats.forced_syncs += 1  # a repair, not an organic sync round
        start = self.data.now
        seq = self.sender.transmit_new(payload, ftype)
        timeout = self.timeout
        retransmits = 0
        for attempt in range(self.max_retries + 1):
            for _ in range(timeout):
                self._pump()
                if self.sender.acked_upto > seq:
                    if attempt > 0 or retransmits > 0:
                        self.stats.recovery_ticks.append(self.data.now - start)
                    if sync:
                        self.sender.resync_needed = False
                    return True
            if attempt < self.max_retries:
                if self.sender.retransmit(seq):
                    retransmits += 1
                    if self.tracker is not None:
                        with self.tracker.span(
                            f"link/{self.name}/retry", seq=seq, attempt=attempt + 1
                        ):
                            pass
                timeout = max(1, math.ceil(timeout * self.backoff))
        self.stats.delivery_failures += 1
        self.sender._flag_resync()
        return False

    def send_nowait(self, payload: bytes, *, sync: bool = False) -> int:
        """Pipelined transmit: enqueue a frame without waiting for its ack.

        Pair with :meth:`flush`. Pipelining is what exercises receiver gap
        detection and out-of-order stashing — a dropped frame is noticed
        when its successor arrives, NAKed, and repaired from the replay
        ring without stalling the pipe.
        """
        if sync and self.sender.resync_needed:
            self.stats.forced_syncs += 1
        return self.sender.transmit_new(payload, FrameType.SYNC if sync else FrameType.DATA)

    def flush(self) -> bool:
        """Pump until every in-flight frame is acked (go-back-N timeouts:
        after ``timeout`` quiet ticks, retransmit all unacked frames, with
        exponential backoff). Returns False if the retry budget ran out.
        Traced as a ``link/<name>/flush`` span when a tracker is attached."""
        r0, rs0 = self.stats.retries, self.stats.resyncs
        with maybe_span(self.tracker, f"link/{self.name}/flush",
                        inflight=self.inflight) as sp:
            ok = self._flush()
            maybe_attr(sp, delivered=ok, retries=self.stats.retries - r0,
                       resyncs=self.stats.resyncs - rs0)
        return ok

    def _flush(self) -> bool:
        target = self.sender.next_seq
        timeout = self.timeout
        start = self.data.now
        for attempt in range(self.max_retries + 1):
            for _ in range(timeout):
                self._pump()
                if self.sender.acked_upto >= target:
                    if attempt > 0:
                        self.stats.recovery_ticks.append(self.data.now - start)
                    return True
            if attempt < self.max_retries:
                for s in range(self.sender.acked_upto, target):
                    if not self.sender.retransmit(s):
                        break
                timeout = max(1, math.ceil(timeout * self.backoff))
        self.stats.delivery_failures += target - self.sender.acked_upto
        self.sender._flag_resync()
        return False

    @property
    def inflight(self) -> int:
        return self.sender.next_seq - self.sender.acked_upto

    def recv(self) -> List[bytes]:
        """Pop every payload delivered in order so far."""
        out = list(self.receiver.delivered)
        self.receiver.delivered.clear()
        return out

    def _pump(self) -> None:
        """One virtual tick: move data frames forward, control frames back."""
        for raw in self.data.poll():
            for ctrl in self.receiver.on_frame(raw):
                self.ack.send(ctrl)
        for raw in self.ack.poll():
            self.sender.on_control(raw)

    def settle(self, ticks: int = 8) -> None:
        """Drain in-flight traffic (late stragglers, duplicate copies)."""
        for _ in range(ticks):
            self._pump()


class Fleet:
    """One reliable link per worker + fleet-wide counters for repro_torch.obs."""

    def __init__(self, links: List[Link]) -> None:
        self.links = links

    @classmethod
    def make(
        cls,
        n: int,
        fault_spec: Optional[FaultSpec] = None,
        *,
        ack_faults: bool = False,
        **link_kwargs,
    ) -> "Fleet":
        """n links; worker i's injector is seeded ``spec.seed + i`` so the
        fleet shares one failure model but not one fault stream."""
        links = []
        for i in range(n):
            spec = fault_spec.with_seed(fault_spec.seed + i) if fault_spec else None
            aspec = (
                fault_spec.with_seed(fault_spec.seed + 10_000 + i)
                if (fault_spec and ack_faults)
                else None
            )
            links.append(Link(fault_spec=spec, ack_fault_spec=aspec,
                              name=f"worker{i}", **link_kwargs))
        return cls(links)

    def __len__(self) -> int:
        return len(self.links)

    def __iter__(self):
        return iter(self.links)

    @property
    def resync_needed(self) -> bool:
        return any(l.resync_needed for l in self.links)

    def attach_tracker(self, tracker) -> None:
        """Point every link's span instrumentation at ``tracker`` (§10).
        Link sends running inside an open round span parent under it."""
        for l in self.links:
            l.tracker = tracker

    def send_per_worker(self, payloads: List[bytes], *, sync: bool = False) -> List[bool]:
        assert len(payloads) == len(self.links)
        return [l.send(p, sync=sync) for l, p in zip(self.links, payloads)]

    def broadcast(self, payload: bytes, *, sync: bool = False) -> List[bool]:
        return [l.send(payload, sync=sync) for l in self.links]

    def drain(self) -> List[List[bytes]]:
        return [l.recv() for l in self.links]

    def stats(self) -> LinkStats:
        total = LinkStats()
        for l in self.links:
            total.merge(l.stats)
        return total

    def injected_counts(self) -> Dict[str, int]:
        """Fault-injector ground truth (what the channels actually did)."""
        out: Dict[str, int] = {}
        for l in self.links:
            for ch in (l.data, l.ack):
                if isinstance(ch, FaultyChannel):
                    for k, v in ch.counts.items():
                        out[k] = out.get(k, 0) + v
        return out

    def log_to(self, tracker, *, step: Optional[int] = None) -> Dict[str, float]:
        metrics = self.stats().as_metrics()
        if tracker is not None:
            tracker.log(metrics, step=step)
        return metrics
