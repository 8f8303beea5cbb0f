"""Tracker protocol + composite backends (DESIGN.md §7).

A tracker receives *events* — normalized dicts with a ``kind``:

    metrics  {"kind": "metrics", "step": int|None, "wall_time": float,
              "metrics": {flat_name: scalar|str}}
    row      {"kind": "row", "name": str, "us_per_call": float,
              "derived": scalar|str, "wall_time": float}
    timer    {"kind": "timer", "name": str, "seconds": float,
              "step": int|None, "wall_time": float}
    span     {"kind": "span", "name": str, "span_id": int, "parent": int|None,
              "t0": float, "t1": float, "attrs": {...}}      (trace.py, §10)
    profile  {"kind": "profile", "name": str, "trace_dir": str,
              "wall_time": float}              (torch.profiler provenance)

``log`` flattens nested dicts with "/" and coerces tensor/numpy scalars to
python numbers, so every backend sees the same flat schema. ``row`` is the
benchmark-harness shape (today's ``name,us_per_call,derived`` CSV line).
``time_block`` is a host timer that waits for the card: the handle's
``block(x)`` synchronises the CUDA device of the tensors in ``x`` before the
clock stops, so queued kernels are charged to the block that launched them.

Backends compose: :class:`CompositeTracker` fans every event out, so one
call site can feed the stdout CSV, a JSONL event log, and the
``BENCH_*.json`` aggregator (bench_json.py) at once.

Port of ``repro/obs/tracker.py``: ``jax.block_until_ready`` becomes a
``torch.cuda.synchronize`` of the tensors' devices, ``jax.profiler`` becomes
``torch.profiler``.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, IO, Iterable, List, Mapping, Optional

import torch


def _scalar(v: Any) -> Any:
    """Coerce 0-d tensors and numpy values to python scalars; pass strings/bools through."""
    if isinstance(v, (str, bool, int, float)) or v is None:
        return v
    if isinstance(v, torch.Tensor):
        return v.item() if v.numel() == 1 else str(v)
    for attr in ("item",):  # numpy scalars, 0-d arrays
        fn = getattr(v, attr, None)
        if callable(fn):
            try:
                return fn()
            except (TypeError, ValueError):
                break
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


def flatten_metrics(d: Mapping[str, Any], *, sep: str = "/", prefix: str = "") -> Dict[str, Any]:
    """Flatten nested dicts: {"a": {"b": 1}} -> {"a/b": 1}; scalars coerced."""
    out: Dict[str, Any] = {}
    for k, v in d.items():
        name = f"{prefix}{sep}{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(flatten_metrics(v, sep=sep, prefix=name))
        else:
            out[name] = _scalar(v)
    return out


def _devices(x: Any, out: set) -> set:
    if isinstance(x, torch.Tensor):
        out.add(x.device)
    elif isinstance(x, Mapping):
        for v in x.values():
            _devices(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _devices(v, out)
    return out


def block_until_ready(x: Any) -> Any:
    """Wait until the card has finished the work queued on the CUDA devices
    of the tensors in ``x`` (a tensor, or dicts/lists/tuples of them);
    nothing to wait for on the CPU. Returns ``x``."""
    for dev in _devices(x, set()):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return x


class _TimerHandle:
    """Yielded by ``time_block``; ``block(x)`` waits for the card's work on ``x``."""

    def __init__(self) -> None:
        self.seconds: Optional[float] = None

    def block(self, x: Any) -> Any:
        return block_until_ready(x)


class Tracker:
    """Base tracker: backends override :meth:`emit` (and maybe :meth:`finish`)."""

    def emit(self, event: Dict[str, Any]) -> None:
        raise NotImplementedError

    def finish(self) -> None:
        """Flush/close. Composite calls this once per run."""

    # -- logging API ---------------------------------------------------------

    def log(self, metrics: Mapping[str, Any], *, step: Optional[int] = None) -> None:
        self.emit(
            {
                "kind": "metrics",
                "step": None if step is None else int(step),
                "wall_time": time.time(),
                "metrics": flatten_metrics(metrics),
            }
        )

    def log_row(self, name: str, us_per_call: float, derived: Any) -> None:
        """One benchmark row — today's ``name,us_per_call,derived`` CSV line."""
        self.emit(
            {
                "kind": "row",
                "name": str(name),
                "us_per_call": float(us_per_call),
                "derived": _scalar(derived),
                "wall_time": time.time(),
            }
        )

    @contextlib.contextmanager
    def time_block(self, name: str, *, step: Optional[int] = None):
        """Host timer; call ``handle.block(out)`` on device outputs inside the block."""
        handle = _TimerHandle()
        t0 = time.perf_counter()
        try:
            yield handle
        finally:
            handle.seconds = time.perf_counter() - t0
            self.emit(
                {
                    "kind": "timer",
                    "name": str(name),
                    "seconds": handle.seconds,
                    "step": None if step is None else int(step),
                    "wall_time": time.time(),
                }
            )

    def span(self, name: str, **attrs):
        """Open a trace span (DESIGN.md §10) — ``with tracker.span("round",
        round=t) as sp:``. Nested spans parent automatically; the span
        event is emitted through :meth:`emit` at exit."""
        from .trace import span as _span

        return _span(self, name, **attrs)

    @contextlib.contextmanager
    def profile(self, name: str, trace_dir: Optional[str] = None):
        """torch.profiler trace around a block (the card's kernels too, where
        one is present); no-op unless a trace dir is given (or
        REPRO_OBS_TRACE_DIR is set). The Chrome trace lands in
        ``<trace_dir>/<name>/trace.json``, and a ``{"kind": "profile", "name",
        "trace_dir"}`` event records its directory, so profiler artifacts are
        discoverable from the event log instead of silently landing on disk."""
        trace_dir = trace_dir or os.environ.get("REPRO_OBS_TRACE_DIR")
        if not trace_dir:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        path = os.path.join(trace_dir, name)
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            yield
        os.makedirs(path, exist_ok=True)
        prof.export_chrome_trace(os.path.join(path, "trace.json"))
        self.emit(
            {
                "kind": "profile",
                "name": str(name),
                "trace_dir": path,
                "wall_time": time.time(),
            }
        )


class NullTracker(Tracker):
    def emit(self, event: Dict[str, Any]) -> None:
        pass


class MemoryTracker(Tracker):
    """In-memory event list — the test/inspection backend."""

    def __init__(self) -> None:
        self.events: List[Dict[str, Any]] = []

    def emit(self, event: Dict[str, Any]) -> None:
        self.events.append(event)


class JsonlTracker(Tracker):
    """Append-only JSONL event log (one event per line)."""

    def __init__(self, path: str) -> None:
        self.path = path
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._fh: Optional[IO[str]] = open(path, "a")

    def emit(self, event: Dict[str, Any]) -> None:
        assert self._fh is not None, "JsonlTracker already finished"
        json.dump(event, self._fh, default=str)
        self._fh.write("\n")
        self._fh.flush()

    def finish(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def read_jsonl(path: str) -> List[Dict[str, Any]]:
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


class CsvStdoutTracker(Tracker):
    """Prints ``row`` events in the harness's ``name,us_per_call,derived``
    CSV format (other event kinds are ignored)."""

    def __init__(self, stream: Optional[IO[str]] = None, *, header: bool = False) -> None:
        import sys

        self.stream = stream if stream is not None else sys.stdout
        if header:
            print("name,us_per_call,derived", file=self.stream)

    def emit(self, event: Dict[str, Any]) -> None:
        if event.get("kind") != "row":
            return
        print(
            f"{event['name']},{event['us_per_call']:.1f},{event['derived']}",
            file=self.stream,
        )


class CompositeTracker(Tracker):
    """Fan every event out to child backends."""

    def __init__(self, *trackers: Tracker) -> None:
        self.trackers: List[Tracker] = [t for t in trackers if t is not None]

    def emit(self, event: Dict[str, Any]) -> None:
        for t in self.trackers:
            t.emit(event)

    def finish(self) -> None:
        for t in self.trackers:
            t.finish()


def events_equal(a: Iterable[Mapping[str, Any]], b: Iterable[Mapping[str, Any]]) -> bool:
    """Compare event streams ignoring wall-clock and timer/span jitter."""

    def norm(events):
        out = []
        for e in events:
            e = {k: v for k, v in e.items()
                 if k not in ("wall_time", "seconds", "t0", "t1")}
            out.append(json.loads(json.dumps(e, default=str)))
        return out

    return norm(a) == norm(b)
