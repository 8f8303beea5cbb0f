"""Diff fresh ``BENCH_*.json`` artifacts against committed baselines
(the port's own copy of ``benchmarks/bench_diff.py``).

The baseline documents are self-describing: each carries a ``gates`` list
({pattern, field, direction, rtol}) written by the harness that made it
(``repro_torch.run`` or the reference's ``benchmarks/run.py``). For every
baseline metric matched by a gate, the fresh artifact must contain
the same metric/field and satisfy the tolerance:

    lower   fresh <= base * (1 + rtol)        (latency-style: lower is better)
    higher  fresh >= base * (1 - rtol)        (throughput-style)
    eq      |fresh - base| <= rtol * max(|base|, eps)

Exactly-at-threshold passes. A gated metric missing from the fresh run is
a regression (a benchmark silently disappearing must not pass CI). A fresh
artifact with no committed baseline fails unless ``--ignore-missing`` —
the flag exists so brand-new suites can land before their first baseline.

Usage:
    PYTHONPATH=src python -m repro_torch.bench_diff --fresh runs/bench \
        [--baseline DIR] [--suite wire --suite kernels]

``--baseline`` defaults to :data:`DEFAULT_BASELINE`, the port's own
documents (``src/repro_torch/baselines``), made on an H100 with
``python -m repro_torch.run <suites> --device cuda``, so their
``us_per_call`` gates hold a card run against a card run. The reference's
``benchmarks/baselines`` were timed on a CPU in Pallas interpret mode: pass
that directory to hold the port to its ``value`` gates.

Exit code 0 = no regressions; 1 = regression / missing artifact.
Baseline update workflow: DESIGN.md §7.4.
"""
from __future__ import annotations

import argparse
import fnmatch
import glob
import os
import sys
from typing import Any, Dict, List, Mapping, Optional, Tuple

_EPS = 1e-12
DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "baselines")


def _check(base: float, fresh: float, direction: str, rtol: float) -> Optional[str]:
    """None if within tolerance, else a human-readable violation."""
    if direction == "lower":
        limit = base * (1.0 + rtol)
        if fresh > limit:
            return f"{fresh:.6g} > {limit:.6g} (baseline {base:.6g}, rtol {rtol})"
    elif direction == "higher":
        limit = base * (1.0 - rtol)
        if fresh < limit:
            return f"{fresh:.6g} < {limit:.6g} (baseline {base:.6g}, rtol {rtol})"
    elif direction == "eq":
        tol = rtol * max(abs(base), _EPS)
        if abs(fresh - base) > tol:
            return f"|{fresh:.6g} - {base:.6g}| > {tol:.6g} (rtol {rtol})"
    else:
        return f"unknown direction {direction!r}"
    return None


def diff_docs(baseline: Mapping[str, Any], fresh: Mapping[str, Any]) -> Tuple[List[str], List[str]]:
    """Compare one suite's fresh doc against its baseline.

    Returns (failures, checked) — ``checked`` lists every gated
    comparison that ran, for the report.
    """
    failures: List[str] = []
    checked: List[str] = []
    base_metrics: Mapping[str, Any] = baseline.get("metrics", {})
    fresh_metrics: Mapping[str, Any] = fresh.get("metrics", {})
    for gate in baseline.get("gates", []):
        pattern, field = gate["pattern"], gate["field"]
        for name, base_entry in sorted(base_metrics.items()):
            if not fnmatch.fnmatch(name, pattern) or field not in base_entry:
                continue
            label = f"{name}:{field}"
            fresh_entry = fresh_metrics.get(name)
            if fresh_entry is None or field not in fresh_entry:
                failures.append(f"{label}: missing from fresh run")
                continue
            checked.append(label)
            violation = _check(
                float(base_entry[field]), float(fresh_entry[field]),
                gate["direction"], float(gate["rtol"]),
            )
            if violation:
                failures.append(f"{label}: {violation}")
    return failures, checked


def diff_dirs(
    baseline_dir: str,
    fresh_dir: str,
    *,
    suites: Optional[List[str]] = None,
    ignore_missing: bool = False,
) -> Tuple[List[str], List[str]]:
    """Diff every BENCH_<suite>.json present in either directory."""
    from . import obs

    def suites_in(dirpath: str) -> Dict[str, str]:
        out = {}
        for path in glob.glob(os.path.join(dirpath, "BENCH_*.json")):
            out[os.path.basename(path)[len("BENCH_"):-len(".json")]] = path
        return out

    base_files, fresh_files = suites_in(baseline_dir), suites_in(fresh_dir)
    names = suites or sorted(set(base_files) | set(fresh_files))
    failures: List[str] = []
    report: List[str] = []
    for suite in names:
        bpath, fpath = base_files.get(suite), fresh_files.get(suite)
        if fpath is None:
            failures.append(f"[{suite}] fresh BENCH_{suite}.json missing from {fresh_dir}")
            continue
        if bpath is None:
            msg = f"[{suite}] no committed baseline in {baseline_dir}"
            (report if ignore_missing else failures).append(
                msg + (" (ignored)" if ignore_missing else "")
            )
            continue
        base_doc, fresh_doc = obs.load(bpath), obs.load(fpath)
        for doc, path in ((base_doc, bpath), (fresh_doc, fpath)):
            errors = obs.validate(doc)
            if errors:
                failures.append(f"[{suite}] {path} schema-invalid: {errors[0]}")
        fails, checked = diff_docs(base_doc, fresh_doc)
        failures.extend(f"[{suite}] {f}" for f in fails)
        report.append(f"[{suite}] {len(checked)} gated metrics checked, "
                      f"{len(fails)} regressions")
    return failures, report


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="directory of committed BENCH_*.json baselines (default: the port's own, "
                         "made on an H100)")
    ap.add_argument("--fresh", default="runs/bench",
                    help="directory of freshly produced BENCH_*.json")
    ap.add_argument("--suite", action="append", default=None,
                    help="restrict to these suites (repeatable)")
    ap.add_argument("--ignore-missing", action="store_true",
                    help="pass when a fresh suite has no committed baseline")
    args = ap.parse_args(argv)

    failures, report = diff_dirs(
        args.baseline, args.fresh, suites=args.suite, ignore_missing=args.ignore_missing
    )
    for line in report:
        print(line)
    if failures:
        print(f"\nREGRESSIONS ({len(failures)}):", file=sys.stderr)
        for f in failures:
            print(f"  - {f}", file=sys.stderr)
        return 1
    print("bench_diff: no regressions")
    return 0


if __name__ == "__main__":
    sys.exit(main())
