"""Channel abstraction: in-process loopback + fault-injecting wrapper.

A channel is a unidirectional, unreliable byte-buffer pipe with virtual
time: ``send`` enqueues a buffer, ``poll`` advances the clock one *tick*
and returns everything whose delivery time has arrived. Ticks are the
latency unit of the whole transport layer — retry timeouts, straggler
delays and reorder windows are all counted in ticks, so tests and
benchmarks are deterministic and never sleep.

:class:`LoopbackChannel` delivers in order with zero latency;
:class:`FaultyChannel` wraps any channel and pushes each send through a
seeded :class:`~repro_torch.transport.faults.FaultInjector` (drops, bit-flips,
truncation, reordering, duplication, straggler latency). A socket-backed
channel can implement the same protocol later without touching the
framing or reliability layers (ROADMAP: replica-fleet transport).

A copy of ``repro/transport/channel.py`` (standard library only).
"""
from __future__ import annotations

import heapq
import itertools
from typing import List, Optional, Protocol

from .faults import FaultInjector, FaultSpec


class Channel(Protocol):
    def send(self, buf: bytes, *, delay: int = 0) -> None:
        """Enqueue ``buf`` for delivery ``delay`` ticks from now."""

    def poll(self) -> List[bytes]:
        """Advance one tick; return buffers whose delivery time arrived."""

    @property
    def now(self) -> int:
        """Current tick count."""


class LoopbackChannel:
    """In-process channel: a delay-aware priority queue over virtual ticks."""

    def __init__(self) -> None:
        self._tick = 0
        self._order = itertools.count()  # FIFO among equal delivery times
        self._heap: list = []

    @property
    def now(self) -> int:
        return self._tick

    def send(self, buf: bytes, *, delay: int = 0) -> None:
        heapq.heappush(self._heap, (self._tick + max(delay, 0), next(self._order), buf))

    def poll(self) -> List[bytes]:
        self._tick += 1
        out = []
        while self._heap and self._heap[0][0] <= self._tick:
            out.append(heapq.heappop(self._heap)[2])
        return out

    def pending(self) -> int:
        return len(self._heap)


class FaultyChannel:
    """Wrap a channel with seeded fault injection on the send side."""

    def __init__(self, inner: Channel, spec: FaultSpec,
                 injector: Optional[FaultInjector] = None) -> None:
        self.inner = inner
        self.spec = spec
        self.injector = injector or FaultInjector(spec)

    @property
    def now(self) -> int:
        return self.inner.now

    @property
    def counts(self):
        """Injected-fault counters, by class."""
        return self.injector.counts

    def send(self, buf: bytes, *, delay: int = 0) -> None:
        for extra, out in self.injector.plan(buf):
            self.inner.send(out, delay=delay + extra)

    def poll(self) -> List[bytes]:
        return self.inner.poll()

    def pending(self) -> int:
        return self.inner.pending()
