"""repro_torch.obs — unified tracking, telemetry, and persistent perf artifacts
(port of ``repro.obs``; imports neither JAX nor ``repro``).

Three layers (DESIGN.md §7):

* :mod:`~repro_torch.obs.tracker` — the Tracker protocol and composable backends
  (in-memory, JSONL event log, stdout CSV, composite fan-out);
* :mod:`~repro_torch.obs.bench_json` — the schema-versioned ``BENCH_<suite>.json``
  sink, validator and provenance capture (git rev, torch/CUDA versions,
  device);
* :mod:`~repro_torch.obs.loggers` — the shared human logger + process-default
  structured sink used by the launch CLIs;
* :mod:`~repro_torch.obs.trace` — span-based round tracing (``tracker.span``)
  over the same event protocol (DESIGN.md §10);
* :mod:`~repro_torch.obs.analyze` — the post-mortem CLI: span-tree validation,
  Chrome/Perfetto export, per-round critical-path attribution;
* :mod:`~repro_torch.obs.hist` — streaming percentile histograms shared by the
  BENCH sink and the analyzer.

Port artifacts keep schema v1, so the reference's regression gating
(``benchmarks/bench_diff.py``) reads them as well.
"""
from .bench_json import SCHEMA_VERSION, BenchJsonSink, environment, load, validate
from .hist import StreamingHistogram, percentile
from .loggers import default_tracker, get_logger, reset_default_tracker
from .trace import SPAN_KIND, Span, maybe_attr, maybe_span, span
from .tracker import (
    CompositeTracker,
    CsvStdoutTracker,
    JsonlTracker,
    MemoryTracker,
    NullTracker,
    Tracker,
    events_equal,
    flatten_metrics,
    read_jsonl,
)

__all__ = [
    "SCHEMA_VERSION",
    "SPAN_KIND",
    "BenchJsonSink",
    "CompositeTracker",
    "CsvStdoutTracker",
    "JsonlTracker",
    "MemoryTracker",
    "NullTracker",
    "Span",
    "StreamingHistogram",
    "Tracker",
    "default_tracker",
    "environment",
    "events_equal",
    "flatten_metrics",
    "get_logger",
    "load",
    "maybe_attr",
    "maybe_span",
    "percentile",
    "read_jsonl",
    "reset_default_tracker",
    "span",
    "validate",
]
