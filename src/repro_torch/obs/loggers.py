"""Shared process-wide logger + default event tracker (DESIGN.md §7.3).

``get_logger(name)`` gives every CLI (dryrun, reanalyze, benchmarks) one
consistently formatted human stream instead of ad-hoc ``print``s.

``default_tracker()`` is the structured twin: a process-wide tracker that
mirrors events into the JSONL file named by ``REPRO_OBS_JSONL`` (if set),
so dry-run compile timings land in the same event stream as benchmark
events. Without the env var it is a no-op sink — callers never guard.

Counterpart of ``repro/obs/loggers.py``; the port's loggers live under
``repro_torch`` and read the reference's environment variables.
"""
from __future__ import annotations

import logging
import os
import sys
from typing import Optional

from .tracker import CompositeTracker, JsonlTracker, NullTracker, Tracker

_FORMAT = "[%(name)s] %(message)s"
_configured = False
_default_tracker: Optional[Tracker] = None


def get_logger(name: str = "repro_torch") -> logging.Logger:
    """Stdout logger with the repo's one-line format, configured once."""
    global _configured
    root = logging.getLogger("repro_torch")
    if not _configured:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(_FORMAT))
        root.addHandler(handler)
        root.setLevel(os.environ.get("REPRO_OBS_LOGLEVEL", "INFO").upper())
        root.propagate = False
        _configured = True
    return root if name in ("repro_torch", None) else logging.getLogger(f"repro_torch.{name}")


def default_tracker() -> Tracker:
    """Process-wide structured sink; JSONL-backed iff REPRO_OBS_JSONL is set."""
    global _default_tracker
    if _default_tracker is None:
        path = os.environ.get("REPRO_OBS_JSONL")
        _default_tracker = (
            CompositeTracker(JsonlTracker(path)) if path else NullTracker()
        )
    return _default_tracker


def reset_default_tracker() -> None:
    """Drop the cached default (tests re-point REPRO_OBS_JSONL)."""
    global _default_tracker
    if _default_tracker is not None:
        _default_tracker.finish()
    _default_tracker = None
