"""Schema-versioned ``BENCH_<suite>.json`` perf artifacts (DESIGN.md §7.2).

One document per benchmark suite run:

    {
      "schema_version": 1,
      "suite": "wire",
      "created_unix": 1754640000.0,
      "env": {"git_rev": "...", "jax_version": null,
              "torch_version": "2.11.0", "cuda_version": "12.8",
              "device_kind": "NVIDIA H100 80GB HBM3", "platform": "gpu",
              "seed": 0},
      "metrics": {
        "wire/sparse_encode": {"us_per_call": 123.4, "value": 0.51,
                               "unit": "GB/s", "count": 1}
      },
      "timers": {"serve/prefill": {"n": 8, "mean_s": ..., "p50_s": ...,
                                   "p99_s": ..., "total_s": ...}},
      "gates": [{"pattern": "wire/*", "field": "value",
                 "direction": "higher", "rtol": 0.9}]
    }

``metrics`` values: ``us_per_call`` comes from benchmark rows, ``value``
is the row's derived number (or the last scalar logged under that name),
``derived`` keeps non-numeric deriveds as strings. Repeated scalar logs
aggregate count + p50/p99. ``gates`` declares which metrics CI regression
checks (benchmarks/bench_diff.py) and with what tolerance — baselines are
self-describing. Units are whatever the field name says: ``us_per_call``
microseconds, ``*_s`` seconds, ``value`` per the ``unit`` field.

The schema is hand-validated (:func:`validate`) — no jsonschema dep.

CLI: ``python -m repro_torch.obs.bench_json BENCH_*.json`` validates files and
exits non-zero on the first invalid one.

Port of ``repro/obs/bench_json.py``: the provenance block records the torch
and CUDA versions and the card, and keeps ``jax_version`` (null), which
schema v1 requires, so a port artifact passes the reference's ``validate``.
"""
from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Any, Dict, List, Mapping, Optional

import torch

from .hist import StreamingHistogram, percentile as _percentile
from .tracker import Tracker

SCHEMA_VERSION = 1
# Exact-percentile retention cap per metric; past it the streaming
# histogram (which has seen every sample, not just the first N) takes
# over — see hist.StreamingHistogram.
_RESERVOIR = 4096


def environment(seed: Optional[int] = None) -> Dict[str, Any]:
    """git rev / torch and CUDA versions / device kind — the provenance block.
    ``platform`` is ``"gpu"`` where a CUDA card is present, else ``"cpu"``."""
    env: Dict[str, Any] = {"seed": seed}
    try:
        env["git_rev"] = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):  # not a repo / no git
        env["git_rev"] = None
    env["jax_version"] = None  # schema v1 key; the port runs without JAX
    env["torch_version"] = torch.__version__
    env["cuda_version"] = torch.version.cuda
    if torch.cuda.is_available():
        env["device_kind"] = torch.cuda.get_device_name(0)
        env["platform"] = "gpu"
    else:
        env["device_kind"] = "cpu"
        env["platform"] = "cpu"
    return env


class BenchJsonSink(Tracker):
    """Aggregates a run's events into one ``BENCH_<suite>.json`` on finish."""

    def __init__(
        self,
        suite: str,
        out_dir: str,
        *,
        seed: Optional[int] = None,
        gates: Optional[List[Dict[str, Any]]] = None,
    ) -> None:
        self.suite = suite
        self.out_dir = out_dir
        self.seed = seed
        self.gates = list(gates or [])
        self._metrics: Dict[str, Dict[str, Any]] = {}
        self._samples: Dict[str, StreamingHistogram] = {}
        self._timers: Dict[str, StreamingHistogram] = {}
        self.path = os.path.join(out_dir, f"BENCH_{suite}.json")

    # -- event aggregation ---------------------------------------------------

    def _metric_entry(self, name: str) -> Dict[str, Any]:
        return self._metrics.setdefault(name, {"count": 0})

    def _observe(self, name: str, value: Any) -> None:
        entry = self._metric_entry(name)
        entry["count"] += 1
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            entry["derived"] = str(value)
            return
        entry["value"] = float(value)
        self._samples.setdefault(
            name, StreamingHistogram(exact_cap=_RESERVOIR)
        ).add(float(value))

    def _observe_timer(self, name: str, seconds: float) -> None:
        self._timers.setdefault(
            name, StreamingHistogram(exact_cap=_RESERVOIR)
        ).add(float(seconds))

    def emit(self, event: Dict[str, Any]) -> None:
        kind = event.get("kind")
        if kind == "row":
            entry = self._metric_entry(event["name"])
            entry["us_per_call"] = float(event["us_per_call"])
            self._observe(event["name"], event["derived"])
        elif kind == "metrics":
            for k, v in event["metrics"].items():
                self._observe(k, v)
        elif kind == "timer":
            self._observe_timer(event["name"], event["seconds"])
        elif kind == "span":
            # span durations aggregate like timers, namespaced so a span
            # and a timer sharing a name cannot collide
            self._observe_timer(f"span/{event['name']}",
                                float(event["t1"]) - float(event["t0"]))

    # -- document ------------------------------------------------------------

    def document(self) -> Dict[str, Any]:
        metrics: Dict[str, Any] = {}
        for name, entry in self._metrics.items():
            out = dict(entry)
            hist = self._samples.get(name)
            if hist is not None and hist.n > 1:
                out["p50"] = hist.quantile(0.50)
                out["p99"] = hist.quantile(0.99)
            metrics[name] = out
        timers: Dict[str, Any] = {}
        for name, hist in self._timers.items():
            timers[name] = hist.summary("_s")
        return {
            "schema_version": SCHEMA_VERSION,
            "suite": self.suite,
            "created_unix": time.time(),
            "env": environment(seed=self.seed),
            "metrics": metrics,
            "timers": timers,
            "gates": self.gates,
        }

    def finish(self) -> None:
        doc = self.document()
        errors = validate(doc)
        assert not errors, f"BenchJsonSink produced an invalid document: {errors}"
        os.makedirs(self.out_dir, exist_ok=True)
        with open(self.path, "w") as fh:
            json.dump(doc, fh, indent=1, sort_keys=True)
            fh.write("\n")


# -- schema ------------------------------------------------------------------


def validate(doc: Mapping[str, Any]) -> List[str]:
    """Return a list of schema violations (empty = valid)."""
    errors: List[str] = []

    def expect(cond: bool, msg: str) -> None:
        if not cond:
            errors.append(msg)

    expect(isinstance(doc, Mapping), "document is not an object")
    if not isinstance(doc, Mapping):
        return errors
    expect(doc.get("schema_version") == SCHEMA_VERSION,
           f"schema_version != {SCHEMA_VERSION}: {doc.get('schema_version')!r}")
    expect(isinstance(doc.get("suite"), str) and doc.get("suite"),
           "suite missing or not a string")
    expect(isinstance(doc.get("created_unix"), (int, float)),
           "created_unix missing or not a number")
    env = doc.get("env")
    expect(isinstance(env, Mapping), "env missing or not an object")
    if isinstance(env, Mapping):
        for k in ("git_rev", "jax_version", "device_kind", "platform", "seed"):
            expect(k in env, f"env.{k} missing")
    metrics = doc.get("metrics")
    expect(isinstance(metrics, Mapping), "metrics missing or not an object")
    if isinstance(metrics, Mapping):
        for name, entry in metrics.items():
            if not isinstance(entry, Mapping):
                errors.append(f"metrics[{name!r}] is not an object")
                continue
            expect(isinstance(entry.get("count"), int) and entry["count"] >= 1,
                   f"metrics[{name!r}].count missing or < 1")
            for field in ("us_per_call", "value", "p50", "p99"):
                if field in entry:
                    expect(isinstance(entry[field], (int, float)),
                           f"metrics[{name!r}].{field} is not a number")
    timers = doc.get("timers")
    expect(isinstance(timers, Mapping), "timers missing or not an object")
    if isinstance(timers, Mapping):
        for name, entry in timers.items():
            if not isinstance(entry, Mapping):
                errors.append(f"timers[{name!r}] is not an object")
                continue
            for field in ("n", "total_s", "mean_s", "p50_s", "p99_s"):
                expect(isinstance(entry.get(field), (int, float)),
                       f"timers[{name!r}].{field} missing or not a number")
    gates = doc.get("gates")
    expect(isinstance(gates, list), "gates missing or not a list")
    if isinstance(gates, list):
        for i, g in enumerate(gates):
            if not isinstance(g, Mapping):
                errors.append(f"gates[{i}] is not an object")
                continue
            expect(isinstance(g.get("pattern"), str), f"gates[{i}].pattern missing")
            expect(g.get("field") in ("us_per_call", "value"),
                   f"gates[{i}].field not in (us_per_call, value)")
            expect(g.get("direction") in ("lower", "higher", "eq"),
                   f"gates[{i}].direction not in (lower, higher, eq)")
            expect(isinstance(g.get("rtol"), (int, float)) and g["rtol"] >= 0,
                   f"gates[{i}].rtol missing or negative")
    return errors


def load(path: str) -> Dict[str, Any]:
    with open(path) as fh:
        return json.load(fh)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="validate BENCH_*.json files")
    ap.add_argument("paths", nargs="+")
    args = ap.parse_args(argv)
    bad = 0
    for path in args.paths:
        errors = validate(load(path))
        if errors:
            bad += 1
            print(f"{path}: INVALID")
            for e in errors:
                print(f"  - {e}")
        else:
            print(f"{path}: ok")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
