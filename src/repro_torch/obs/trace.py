"""Span-based round tracing over the Tracker event protocol (DESIGN.md §10).

A *span* is a fourth event kind next to metrics/row/timer:

    span  {"kind": "span", "name": str, "span_id": int, "parent": int|None,
           "t0": float, "t1": float, "attrs": {str: scalar}}

``t0``/``t1`` are ``time.perf_counter()`` seconds (monotonic within one
process — the clock Perfetto export and critical-path analysis need);
``span_id``/``parent`` are a per-tracker deterministic counter, so two
runs that execute the same span sequence produce the same tree ids and
a span stream round-trips through JSONL unchanged.

Spans are opened with the context-manager API on any tracker::

    with tracker.span("round", round=t) as sp:
        with tracker.span("broadcast"):
            ...
        sp.attrs["gamma"] = gamma          # attrs may be added until exit

Nesting is tracked per tracker on the host thread (the training/serving
loops are single-threaded host loops): the innermost open span is the
parent of the next one, across call boundaries — a transport link whose
``send`` runs inside an algorithm's round span parents its ``link/*``
spans under that round automatically. The span *event* is emitted at
exit, so children appear before their parent in the stream; consumers
(analyze.py) reconstruct order-independently.

Instrumented paths emit this vocabulary (see DESIGN.md §10.2):

    round                 one optimizer round / train step / cohort round
      subgrad             the jitted step (subgrad + stepsize + compress, fused)
      stepsize            host read of gamma (attrs carry the reacted value)
      broadcast           downlink delivery section
        encode            wire codec serialization
        link/<name>       one reliable-link send -> ack cycle (LinkStats
                          deltas as attrs: retries, resyncs, delivered)
        link/<name>/retry zero-width marker per retransmission attempt
    serve/request         one DecodeEngine.run call
      prefill, decode     the two serving phases
    serve/delta_sync      one in-flight model-update application

A copy of ``repro/obs/trace.py`` (standard library only), kept so that the
port imports nothing of ``repro``.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, Optional

SPAN_KIND = "span"


class Span:
    """One open span; mutate ``attrs`` freely until the context exits."""

    __slots__ = ("name", "span_id", "parent", "attrs", "t0", "t1")

    def __init__(self, name: str, span_id: int, parent: Optional[int],
                 attrs: Dict[str, Any]) -> None:
        self.name = name
        self.span_id = span_id
        self.parent = parent
        self.attrs = attrs
        self.t0: float = 0.0
        self.t1: float = 0.0

    @property
    def duration(self) -> float:
        return self.t1 - self.t0

    def event(self) -> Dict[str, Any]:
        from .tracker import _scalar

        return {
            "kind": SPAN_KIND,
            "name": self.name,
            "span_id": self.span_id,
            "parent": self.parent,
            "t0": self.t0,
            "t1": self.t1,
            "attrs": {str(k): _scalar(v) for k, v in self.attrs.items()},
        }


class _TraceState:
    """Per-tracker open-span stack + deterministic id counter."""

    __slots__ = ("stack", "next_id")

    def __init__(self) -> None:
        self.stack: List[Span] = []
        self.next_id = 0


def _state(tracker) -> _TraceState:
    st = getattr(tracker, "_trace_state", None)
    if st is None:
        st = _TraceState()
        tracker._trace_state = st
    return st


@contextlib.contextmanager
def span(tracker, name: str, **attrs):
    """Open one span on ``tracker``; emits the span event at exit."""
    st = _state(tracker)
    sp = Span(str(name), st.next_id,
              st.stack[-1].span_id if st.stack else None, dict(attrs))
    st.next_id += 1
    st.stack.append(sp)
    sp.t0 = time.perf_counter()
    try:
        yield sp
    finally:
        sp.t1 = time.perf_counter()
        if st.stack and st.stack[-1] is sp:
            st.stack.pop()
        else:  # mis-nested exit: drop back to this span's frame
            while st.stack and st.stack[-1] is not sp:
                st.stack.pop()
            if st.stack:
                st.stack.pop()
        tracker.emit(sp.event())


@contextlib.contextmanager
def maybe_span(tracker, name: str, **attrs):
    """``tracker.span(...)`` when a tracker is attached, else a no-op.

    Yields the open :class:`Span` or ``None`` — call sites guard attr
    writes with ``if sp is not None`` (or write through ``maybe_attr``).
    """
    if tracker is None:
        yield None
    else:
        with span(tracker, name, **attrs) as sp:
            yield sp


def maybe_attr(sp: Optional[Span], **attrs) -> None:
    """Set attrs on a possibly-None span (maybe_span's companion)."""
    if sp is not None:
        sp.attrs.update(attrs)
