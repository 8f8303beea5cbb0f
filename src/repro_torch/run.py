"""Benchmark harness of the port (counterpart of ``benchmarks/run.py``):
one module per paper table/figure.

    PYTHONPATH=src python -m repro_torch.run [suites] [--out DIR] [--jsonl PATH] [--seed N] [--device cpu]

Each suite streams ``(name, us_per_call, derived)`` rows through a
composite tracker (repro_torch.obs): stdout CSV, an optional JSONL event
log, and a schema-v1 ``BENCH_<suite>.json`` perf artifact with provenance
(git rev, torch/CUDA versions, device kind, seed) and the reference's
regression gates, which ``repro_torch.bench_diff`` reads back against a
baseline directory: by default the port's own, ``src/repro_torch/baselines``,
made on an H100 (``benchmarks/baselines`` holds the reference's, timed on a
CPU in Pallas interpret mode). Every suite runs on ``--device`` (default the
card). Suites:

  fig1             Fig. 1/7   EF21-P vs MARINA-P (same/ind/perm), const/Polyak
  table2           Table 2    sigma_A per (n, noise scale), paper sizes
  stepsize_grid    Table 3/6  tuned Polyak factor grid
  comm_complexity  Cor. 1/2   rounds-to-eps vs closed-form complexity
  kernels          —          hand-written kernels vs their plain versions
  wire             DESIGN §3  wire codec throughput + measured-vs-analytic parity
  encode           DESIGN §11 device encode paths + byte-identity gate
  transport        DESIGN §8  frame/CRC throughput + clean-vs-degraded chaos run
  serve            DESIGN §10 decode engine prefill/decode span p50/p99 + tokens/s
  scenario         DESIGN §9  (algorithm x stepsize x client mix) fleet cells,
                              one BENCH_scenario_<cell>.json each
  roofline_report  §Roofline  H100 bound per (arch x shape) dry-run record
                              (``repro_torch.launch.dryrun``), with the measured
                              share where a record has one

With no suites named, every suite runs, ``roofline`` only where dry-run
records exist (``DRYRUN_DIR``, default ``runs/dryrun_torch``). A suite that
raises prints its traceback, emits a ``<suite>/FAILED,0,nan`` row, skips its
BENCH artifact, and the run exits 1.
"""
from __future__ import annotations

import argparse
import os
import sys
import traceback

# Regression gates baked into each suite's BENCH artifact (self-describing
# baselines — bench_diff reads them back): the reference's, unchanged.
# Timing tolerances are loose (5x) because machines vary; deterministic
# deriveds are tight.
_TIME = {"pattern": "*", "field": "us_per_call", "direction": "lower", "rtol": 4.0}
GATES = {
    "kernels": [_TIME],
    "wire": [
        _TIME,
        # derived value = codec throughput in GB/s (higher is better)
        {"pattern": "wire/*", "field": "value", "direction": "higher", "rtol": 0.9},
    ],
    "encode": [
        _TIME,
        # host-codec GB/s floor
        {"pattern": "encode/host_*", "field": "value", "direction": "higher", "rtol": 0.9},
        # fused streams must equal the host codec's bytes — a correctness
        # gate riding the perf artifact (1.0 = identical, exact match)
        {"pattern": "encode/byte_identical", "field": "value", "direction": "eq", "rtol": 0.0},
    ],
    "table2": [
        # sigma_A is deterministic for a fixed seed/platform
        {"pattern": "table2/*", "field": "value", "direction": "eq", "rtol": 0.05},
    ],
    "fig1": [_TIME],
    "stepsize_grid": [_TIME],
    "comm_complexity": [_TIME],
    "roofline": [],
    "transport": [
        _TIME,
        # chaos-run quality: payload bytes delivered / wire bytes sent
        {"pattern": "transport/goodput", "field": "value", "direction": "higher", "rtol": 0.3},
        # degraded rounds-to-target / clean rounds-to-target
        {"pattern": "transport/rounds_ratio", "field": "value", "direction": "lower", "rtol": 0.5},
    ],
    "serve": [
        _TIME,
        {"pattern": "serve/*_ms", "field": "value", "direction": "lower", "rtol": 4.0},
        {"pattern": "serve/tokens_per_s", "field": "value", "direction": "higher", "rtol": 0.8},
    ],
    "scenario": [
        _TIME,
        # convergence speed per matrix cell (deterministic for a fixed seed;
        # slack covers cross-platform float drift)
        {"pattern": "scenario/*/rounds_to_target", "field": "value", "direction": "lower", "rtol": 0.5},
        # analytic downlink cost must not creep up
        {"pattern": "scenario/*/s2w_bits", "field": "value", "direction": "lower", "rtol": 0.5},
        # delivered / sent participant messages under the mix's fault model
        {"pattern": "scenario/*/goodput", "field": "value", "direction": "higher", "rtol": 0.3},
    ],
}

DEFAULT_SUITES = ["fig1", "table2", "stepsize_grid", "comm_complexity", "kernels",
                  "wire", "encode", "transport", "serve", "scenario"]


def suites_for(args) -> dict:
    """{suite: bench(tracker=None) -> rows}, bound to ``args.device`` (and
    ``args.out`` for the per-cell scenario artifacts)."""
    from . import (comm_complexity, fig1, kernel_bench, roofline_report, scenario_matrix,
                   serve_bench, stepsize_grid, table2_sigma, transport_bench, wire_bench)

    dev = args.device
    return {
        "fig1": lambda tracker=None: fig1.bench(tracker=tracker, device=dev),
        "table2": lambda tracker=None: table2_sigma.bench(tracker=tracker, device=dev),
        "stepsize_grid": lambda tracker=None: stepsize_grid.bench(tracker=tracker, device=dev),
        "comm_complexity": lambda tracker=None: comm_complexity.bench(tracker=tracker, device=dev),
        # kernel_bench times in ms; the harness's column is µs
        "kernels": lambda tracker=None: [(name, ms * 1e3, size)
                                         for name, ms, size in kernel_bench.bench(dev)],
        "wire": lambda tracker=None: wire_bench.bench(tracker=tracker, device=dev),
        "encode": lambda tracker=None: wire_bench.bench_encode(device=dev),
        "transport": lambda tracker=None: transport_bench.bench(tracker=tracker, device=dev),
        "scenario": lambda tracker=None: scenario_matrix.bench(
            tracker=tracker, out_dir=args.out, device=dev),
        "serve": lambda tracker=None: serve_bench.bench(tracker=tracker, device=dev),
        "roofline": roofline_report.bench,
    }


def main(argv=None) -> int:
    from . import obs

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("suites", nargs="*",
                    help=f"subset of {DEFAULT_SUITES} (default: all of them)")
    ap.add_argument("--out", default=os.environ.get("REPRO_BENCH_DIR", "runs/bench"),
                    help="directory for BENCH_<suite>.json artifacts")
    ap.add_argument("--jsonl", default=None,
                    help="also append every event to this JSONL log")
    ap.add_argument("--seed", type=int, default=0,
                    help="recorded in BENCH env provenance")
    ap.add_argument("--device", default="cuda",
                    help="where every suite runs (default the card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    suites = suites_for(args)
    unknown = [s for s in args.suites if s not in suites]
    if unknown:
        ap.error(f"unknown suites {unknown}; choose from {sorted(suites)}")
    selected = list(args.suites)
    if not selected:
        from . import roofline_report

        selected = list(DEFAULT_SUITES)
        if os.path.isdir(roofline_report.DEFAULT_DIR) and os.listdir(roofline_report.DEFAULT_DIR):
            selected.append("roofline")

    jsonl = obs.JsonlTracker(args.jsonl) if args.jsonl else None
    print("name,us_per_call,derived")
    failures = []
    for key in selected:
        sink = obs.BenchJsonSink(key, args.out, seed=args.seed, gates=GATES.get(key, []))
        tracker = obs.CompositeTracker(obs.CsvStdoutTracker(), sink, jsonl)
        try:
            with tracker.time_block(f"{key}/suite"):
                rows = suites[key](tracker=tracker)
            for name, us, derived in rows:
                tracker.log_row(name, us, derived)
            sink.finish()
        except Exception:  # noqa: BLE001 - report, then fail the run
            traceback.print_exc()
            print(f"{key}/FAILED,0,nan")
            failures.append(key)
    if jsonl is not None:
        jsonl.finish()
    if failures:
        print(f"FAILED suites: {','.join(failures)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
