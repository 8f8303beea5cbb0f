"""Post-mortem round-trace analysis CLI (DESIGN.md §10.3).

Reconstructs the span tree from a JSONL event log (repro_torch.obs JsonlTracker
stream carrying ``kind: "span"`` events — trace.py), then:

* validates it (t0 <= t1 on every span, unique ids, no orphan parents);
* exports Chrome/Perfetto ``trace_event`` JSON (``--perfetto out.json``)
  loadable at https://ui.perfetto.dev;
* prints a per-round critical-path table: round duration, phase
  breakdown, the slowest worker link, retry/resync attribution, and
  degraded-round detection (any link span reporting retries, a resync,
  or a failed delivery);
* prints streaming p50/p99 latency histograms per span name
  (:class:`repro_torch.obs.hist.StreamingHistogram` — the same estimator the
  BENCH sink uses).

Usage:
    python -m repro_torch.obs.analyze run.jsonl [--perfetto trace.json]
        [--max-rounds N] [--require-degraded]
    python -m repro_torch.obs.analyze --validate-trace trace.json

Exit code 0 = trace well-formed (and, with ``--require-degraded``, at
least one degraded round attributed to a specific link); 1 otherwise.

A copy of ``repro/obs/analyze.py`` (standard library only), kept so that
the port imports nothing of ``repro``.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

from .hist import StreamingHistogram
from .trace import SPAN_KIND


@dataclasses.dataclass
class SpanNode:
    """One reconstructed span + its children (time-ordered)."""

    name: str
    span_id: int
    parent: Optional[int]
    t0: float
    t1: float
    attrs: Dict[str, Any]
    children: List["SpanNode"] = dataclasses.field(default_factory=list)

    @property
    def duration(self) -> float:
        return self.t1 - self.t0

    def walk(self) -> Iterable["SpanNode"]:
        yield self
        for c in self.children:
            yield from c.walk()

    def signature(self) -> Any:
        """Deterministic structural identity: names, nesting, and attrs
        (timestamps excluded) — what a seeded run must reproduce."""
        return (
            self.name,
            tuple(sorted((k, repr(v)) for k, v in self.attrs.items())),
            tuple(c.signature() for c in self.children),
        )


def span_events(events: Iterable[Mapping[str, Any]]) -> List[Dict[str, Any]]:
    return [dict(e) for e in events if e.get("kind") == SPAN_KIND]


def validate_spans(events: Iterable[Mapping[str, Any]]) -> List[str]:
    """Schema violations in a span event stream (empty = valid)."""
    errors: List[str] = []
    seen: Dict[int, str] = {}
    spans = span_events(events)
    for i, e in enumerate(spans):
        where = f"span[{i}] ({e.get('name')!r})"
        for field in ("name", "span_id", "t0", "t1"):
            if field not in e:
                errors.append(f"{where}: missing {field}")
        if not isinstance(e.get("attrs", {}), Mapping):
            errors.append(f"{where}: attrs not an object")
        sid = e.get("span_id")
        if isinstance(sid, int):
            if sid in seen:
                errors.append(f"{where}: duplicate span_id {sid} (also {seen[sid]!r})")
            seen[sid] = e.get("name")
        t0, t1 = e.get("t0"), e.get("t1")
        if isinstance(t0, (int, float)) and isinstance(t1, (int, float)) and t1 < t0:
            errors.append(f"{where}: t1 < t0 ({t1} < {t0})")
    for i, e in enumerate(spans):
        parent = e.get("parent")
        if parent is not None and parent not in seen:
            errors.append(
                f"span[{i}] ({e.get('name')!r}): orphan parent id {parent}"
            )
    return errors


def build_tree(events: Iterable[Mapping[str, Any]]) -> List[SpanNode]:
    """Span events (any order) -> time-ordered forest of root SpanNodes."""
    nodes: Dict[int, SpanNode] = {}
    for e in span_events(events):
        nodes[e["span_id"]] = SpanNode(
            name=e["name"], span_id=e["span_id"], parent=e.get("parent"),
            t0=float(e["t0"]), t1=float(e["t1"]), attrs=dict(e.get("attrs", {})),
        )
    roots: List[SpanNode] = []
    for n in nodes.values():
        if n.parent is not None and n.parent in nodes:
            nodes[n.parent].children.append(n)
        else:
            roots.append(n)
    for n in nodes.values():
        n.children.sort(key=lambda c: (c.t0, c.span_id))
    roots.sort(key=lambda r: (r.t0, r.span_id))
    return roots


# -- Perfetto export ----------------------------------------------------------


def to_perfetto(events: Iterable[Mapping[str, Any]],
                *, process_name: str = "repro") -> Dict[str, Any]:
    """Chrome ``trace_event`` JSON (complete "X" events, µs timestamps).

    Spans from one host thread strictly nest, so everything lands on one
    track; ``span_id``/``parent`` travel in ``args`` alongside the attrs
    so Perfetto's query layer can rebuild the tree.
    """
    trace_events: List[Dict[str, Any]] = [
        {"ph": "M", "pid": 1, "name": "process_name",
         "args": {"name": process_name}},
        {"ph": "M", "pid": 1, "tid": 1, "name": "thread_name",
         "args": {"name": "host-loop"}},
    ]
    for e in span_events(events):
        args = {k: v for k, v in e.get("attrs", {}).items()}
        args["span_id"] = e["span_id"]
        if e.get("parent") is not None:
            args["parent"] = e["parent"]
        trace_events.append(
            {
                "name": e["name"],
                "cat": "span",
                "ph": "X",
                "ts": float(e["t0"]) * 1e6,
                "dur": max(0.0, (float(e["t1"]) - float(e["t0"])) * 1e6),
                "pid": 1,
                "tid": 1,
                "args": args,
            }
        )
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}


def validate_perfetto(doc: Mapping[str, Any]) -> List[str]:
    """Well-formedness of an exported Chrome trace document."""
    errors: List[str] = []
    evs = doc.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents missing or not a list"]
    for i, e in enumerate(evs):
        if not isinstance(e, Mapping):
            errors.append(f"traceEvents[{i}] is not an object")
            continue
        ph = e.get("ph")
        if ph not in ("X", "M"):
            errors.append(f"traceEvents[{i}].ph {ph!r} not in (X, M)")
            continue
        if not isinstance(e.get("name"), str):
            errors.append(f"traceEvents[{i}].name missing")
        if ph == "X":
            for field in ("ts", "dur", "pid", "tid"):
                if not isinstance(e.get(field), (int, float)):
                    errors.append(f"traceEvents[{i}].{field} missing or non-numeric")
            if isinstance(e.get("dur"), (int, float)) and e["dur"] < 0:
                errors.append(f"traceEvents[{i}].dur negative")
    return errors


# -- per-round critical path --------------------------------------------------


@dataclasses.dataclass
class RoundReport:
    """Critical-path attribution for one round span."""

    index: int
    label: str
    duration_s: float
    phases: Dict[str, float]            # direct-child name -> seconds
    slowest_link: Optional[str]
    slowest_link_s: float
    retries: int
    resyncs: int
    failed_links: List[str]
    degraded: bool
    culprit: Optional[str]              # link name the degradation traces to
    gamma: Optional[float]

    def row(self) -> str:
        phases = " ".join(f"{k}={v * 1e3:.2f}ms" for k, v in self.phases.items())
        tail = ""
        if self.degraded:
            tail = f"  DEGRADED <- {self.culprit} (retries={self.retries}, resyncs={self.resyncs})"
        link = (f"{self.slowest_link}={self.slowest_link_s * 1e3:.2f}ms"
                if self.slowest_link else "-")
        gamma = f"{self.gamma:.3e}" if self.gamma is not None else "-"
        return (f"{self.index:>5}  {self.duration_s * 1e3:>9.2f}ms  gamma={gamma:<10} "
                f"slowest_link={link:<24} {phases}{tail}")


def _link_spans(node: SpanNode) -> List[SpanNode]:
    return [s for s in node.walk()
            if s.name.startswith("link/") and not s.name.endswith("/retry")]


def round_reports(roots: List[SpanNode]) -> List[RoundReport]:
    """One report per ``round`` / ``serve/request`` root span."""
    out: List[RoundReport] = []
    idx = 0
    for r in roots:
        if r.name not in ("round", "serve/request"):
            continue
        links = _link_spans(r)
        retries = sum(int(s.attrs.get("retries", 0) or 0) for s in links)
        resyncs = sum(int(s.attrs.get("resyncs", 0) or 0) for s in links)
        failed = [s.name for s in links if s.attrs.get("delivered") is False]
        # degradation attribution: the link with failed delivery, else the
        # one that spent the most repair effort (retries + resyncs)
        culprit = None
        if failed:
            culprit = failed[0]
        else:
            worst = max(links, default=None,
                        key=lambda s: (int(s.attrs.get("retries", 0) or 0)
                                       + int(s.attrs.get("resyncs", 0) or 0)))
            if worst is not None and (int(worst.attrs.get("retries", 0) or 0)
                                      + int(worst.attrs.get("resyncs", 0) or 0)) > 0:
                culprit = worst.name
        slowest = max(links, default=None, key=lambda s: s.duration)
        gamma = None
        for s in r.walk():
            if "gamma" in s.attrs:
                gamma = float(s.attrs["gamma"])
                break
        label = str(r.attrs.get("round", r.attrs.get("step", idx)))
        out.append(
            RoundReport(
                index=idx,
                label=label,
                duration_s=r.duration,
                phases={c.name: c.duration for c in r.children},
                slowest_link=slowest.name if slowest is not None else None,
                slowest_link_s=slowest.duration if slowest is not None else 0.0,
                retries=retries,
                resyncs=resyncs,
                failed_links=failed,
                degraded=culprit is not None,
                culprit=culprit,
                gamma=gamma,
            )
        )
        idx += 1
    return out


def latency_histograms(events: Iterable[Mapping[str, Any]]) -> Dict[str, StreamingHistogram]:
    """Per-span-name streaming duration histograms (seconds)."""
    hists: Dict[str, StreamingHistogram] = {}
    for e in span_events(events):
        h = hists.setdefault(e["name"], StreamingHistogram())
        h.add(float(e["t1"]) - float(e["t0"]))
    return hists


# -- CLI ----------------------------------------------------------------------


def _read_jsonl(path: str) -> List[Dict[str, Any]]:
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def report(events: List[Dict[str, Any]], *, max_rounds: Optional[int] = None) -> Tuple[str, int]:
    """(rendered report, number of degraded rounds)."""
    roots = build_tree(events)
    reports = round_reports(roots)
    lines = [f"spans: {len(span_events(events))}   round-level spans: {len(reports)}"]
    degraded = [r for r in reports if r.degraded]
    shown = reports if max_rounds is None else reports[:max_rounds]
    if shown:
        lines.append("\nround  duration     per-round critical path")
        for r in shown:
            lines.append(r.row())
        if len(shown) < len(reports):
            lines.append(f"... ({len(reports) - len(shown)} more rounds)")
    lines.append(
        f"\ndegraded rounds: {len(degraded)}/{len(reports)}"
        + (
            "  (culprits: "
            + ", ".join(sorted({r.culprit for r in degraded if r.culprit}))
            + ")"
            if degraded
            else ""
        )
    )
    hists = latency_histograms(events)
    if hists:
        lines.append("\nspan latency (streaming histogram):")
        lines.append(f"{'name':<28} {'n':>6} {'p50':>12} {'p99':>12}")
        for name in sorted(hists):
            h = hists[name]
            lines.append(
                f"{name:<28} {h.n:>6} {h.quantile(0.5) * 1e3:>10.3f}ms "
                f"{h.quantile(0.99) * 1e3:>10.3f}ms"
            )
    return "\n".join(lines), len(degraded)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("log", nargs="?", help="JSONL event log with span events")
    ap.add_argument("--perfetto", metavar="OUT",
                    help="write Chrome/Perfetto trace_event JSON here")
    ap.add_argument("--max-rounds", type=int, default=24,
                    help="rows shown in the per-round table (default 24)")
    ap.add_argument("--require-degraded", action="store_true",
                    help="exit non-zero unless >=1 degraded round is attributed")
    ap.add_argument("--validate-trace", metavar="TRACE_JSON",
                    help="validate a previously exported Chrome trace and exit")
    args = ap.parse_args(argv)

    if args.validate_trace:
        with open(args.validate_trace) as fh:
            doc = json.load(fh)
        errors = validate_perfetto(doc)
        if errors:
            print(f"{args.validate_trace}: INVALID")
            for e in errors:
                print(f"  - {e}")
            return 1
        n = sum(1 for e in doc["traceEvents"] if e.get("ph") == "X")
        print(f"{args.validate_trace}: ok ({n} span events)")
        return 0

    if not args.log:
        ap.error("provide a JSONL log (or --validate-trace)")
    events = _read_jsonl(args.log)
    errors = validate_spans(events)
    if errors:
        print(f"{args.log}: INVALID span stream")
        for e in errors:
            print(f"  - {e}")
        return 1

    if args.perfetto:
        doc = to_perfetto(events)
        pf_errors = validate_perfetto(doc)
        assert not pf_errors, f"exporter produced an invalid trace: {pf_errors}"
        with open(args.perfetto, "w") as fh:
            json.dump(doc, fh)
        print(f"wrote {args.perfetto} "
              f"({sum(1 for e in doc['traceEvents'] if e['ph'] == 'X')} events; "
              "load at https://ui.perfetto.dev)")

    text, n_degraded = report(events, max_rounds=args.max_rounds)
    print(text)
    if args.require_degraded and n_degraded == 0:
        print("FAIL: no degraded round attributed (--require-degraded)")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
