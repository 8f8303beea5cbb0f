"""The port's benchmark harness (repro_torch.run, bench_diff, stepsize_grid,
transport_bench.chaos_metrics, trace_smoke) against the reference's
(benchmarks/run.py, bench_diff.py, ...), as tests/test_obs.py and
tests/test_scenario_matrix.py hold the reference's.

The bench_diff and run cases are the reference's own, run on the port's
copies; the gates, suite names and row names are compared with the
reference's directly. Everything runs on the CPU at small sizes.
"""
import json
import os
import warnings

import numpy as np
import pytest

pytest.importorskip("jax")
from benchmarks import bench_diff as jbench_diff  # noqa: E402
from benchmarks import run as jrun  # noqa: E402
from repro_torch import bench_diff, fig1, obs, run, scenario_matrix, stepsize_grid  # noqa: E402
from repro_torch import table2_sigma, trace_smoke, transport_bench, wire_bench  # noqa: E402
from repro_torch.core import problems  # noqa: E402
from repro_torch.obs import analyze  # noqa: E402

BASELINES = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "baselines")


def _doc(metrics, gates):
    return {
        "schema_version": obs.SCHEMA_VERSION, "suite": "s", "created_unix": 0.0,
        "env": {"git_rev": None, "jax_version": None, "device_kind": None,
                "platform": None, "seed": 0},
        "metrics": metrics, "timers": {}, "gates": gates,
    }


GATE_LOWER = [{"pattern": "m/*", "field": "us_per_call", "direction": "lower", "rtol": 0.5}]


# -- bench_diff: the reference's cases on the port's copy ---------------------


def test_bench_diff_within_tolerance_passes():
    base = _doc({"m/a": {"count": 1, "us_per_call": 100.0}}, GATE_LOWER)
    fresh = _doc({"m/a": {"count": 1, "us_per_call": 120.0}}, GATE_LOWER)
    failures, checked = bench_diff.diff_docs(base, fresh)
    assert failures == [] and checked == ["m/a:us_per_call"]


def test_bench_diff_tolerance_boundary():
    base = _doc({"m/a": {"count": 1, "us_per_call": 100.0}}, GATE_LOWER)
    at = _doc({"m/a": {"count": 1, "us_per_call": 150.0}}, GATE_LOWER)
    over = _doc({"m/a": {"count": 1, "us_per_call": 150.0001}}, GATE_LOWER)
    assert bench_diff.diff_docs(base, at)[0] == []  # exactly at threshold passes
    assert bench_diff.diff_docs(base, over)[0] != []


def test_bench_diff_directions():
    g_hi = [{"pattern": "m", "field": "value", "direction": "higher", "rtol": 0.2}]
    base = _doc({"m": {"count": 1, "value": 1.0}}, g_hi)
    assert bench_diff.diff_docs(base, _doc({"m": {"count": 1, "value": 0.85}}, g_hi))[0] == []
    assert bench_diff.diff_docs(base, _doc({"m": {"count": 1, "value": 0.75}}, g_hi))[0] != []
    g_eq = [{"pattern": "m", "field": "value", "direction": "eq", "rtol": 0.1}]
    base = _doc({"m": {"count": 1, "value": 2.0}}, g_eq)
    assert bench_diff.diff_docs(base, _doc({"m": {"count": 1, "value": 2.19}}, g_eq))[0] == []
    assert bench_diff.diff_docs(base, _doc({"m": {"count": 1, "value": 2.21}}, g_eq))[0] != []


def test_bench_diff_missing_metric_fails():
    base = _doc({"m/a": {"count": 1, "us_per_call": 100.0}}, GATE_LOWER)
    fresh = _doc({}, GATE_LOWER)
    failures, _ = bench_diff.diff_docs(base, fresh)
    assert failures and "missing" in failures[0]


def test_bench_diff_dirs_missing_baseline(tmp_path):
    base_dir, fresh_dir = tmp_path / "base", tmp_path / "fresh"
    base_dir.mkdir(), fresh_dir.mkdir()
    with open(fresh_dir / "BENCH_s.json", "w") as fh:
        json.dump(_doc({}, []), fh)
    failures, _ = bench_diff.diff_dirs(str(base_dir), str(fresh_dir))
    assert failures and "no committed baseline" in failures[0]
    failures, report = bench_diff.diff_dirs(str(base_dir), str(fresh_dir), ignore_missing=True)
    assert failures == [] and any("ignored" in r for r in report)


def test_bench_diff_missing_fresh_fails(tmp_path):
    base_dir, fresh_dir = tmp_path / "base", tmp_path / "fresh"
    base_dir.mkdir(), fresh_dir.mkdir()
    with open(base_dir / "BENCH_s.json", "w") as fh:
        json.dump(_doc({}, []), fh)
    failures, _ = bench_diff.diff_dirs(str(base_dir), str(fresh_dir))
    assert failures and "fresh" in failures[0]


def test_bench_diff_cli_exit_codes(tmp_path):
    base_dir, fresh_dir = tmp_path / "base", tmp_path / "fresh"
    base_dir.mkdir(), fresh_dir.mkdir()
    doc = _doc({"m/a": {"count": 1, "us_per_call": 100.0}}, GATE_LOWER)
    for d in (base_dir, fresh_dir):
        with open(d / "BENCH_s.json", "w") as fh:
            json.dump(doc, fh)
    assert bench_diff.main(["--baseline", str(base_dir), "--fresh", str(fresh_dir)]) == 0
    bad = _doc({"m/a": {"count": 1, "us_per_call": 1000.0}}, GATE_LOWER)
    with open(fresh_dir / "BENCH_s.json", "w") as fh:
        json.dump(bad, fh)
    assert bench_diff.main(["--baseline", str(base_dir), "--fresh", str(fresh_dir)]) == 1


@pytest.mark.parametrize("suite", ["encode", "kernels", "scenario", "serve", "table2", "transport", "wire"])
def test_bench_diff_agrees_with_the_reference_on_committed_baselines(suite):
    """Each committed baseline against itself and against a copy with every
    metric's fields moved by 30%: the port's and the reference's diff_docs
    give the same failures and the same checked list."""
    with open(os.path.join(BASELINES, f"BENCH_{suite}.json")) as fh:
        base = json.load(fh)
    assert obs.validate(base) == []
    moved = json.loads(json.dumps(base))
    for entry in moved["metrics"].values():
        for field in ("value", "us_per_call"):
            if field in entry:
                entry[field] *= 1.3
    del moved["metrics"][sorted(moved["metrics"])[0]]
    for fresh in (base, moved):
        assert bench_diff.diff_docs(base, fresh) == jbench_diff.diff_docs(base, fresh)
    assert bench_diff.diff_docs(base, base)[0] == []


# -- the harness -------------------------------------------------------------


def test_run_gates_and_suites_are_the_references():
    assert run.GATES == jrun.GATES
    assert run.DEFAULT_SUITES == ["fig1", "table2", "stepsize_grid", "comm_complexity",
                                  "kernels", "wire", "encode", "transport", "serve", "scenario"]
    assert set(run.NOT_PORTED) == {"roofline"}


def test_run_propagates_suite_failure(tmp_path, monkeypatch, capsys):
    """A raising suite must fail the run (no FAILED,0,nan + exit 0)."""
    def boom(tracker=None, **kwargs):
        raise RuntimeError("suite exploded")

    monkeypatch.setattr(table2_sigma, "bench", boom)
    rc = run.main(["table2", "--out", str(tmp_path), "--device", "cpu"])
    assert rc == 1
    out = capsys.readouterr().out
    assert "table2/FAILED,0,nan" in out  # per-suite row preserved
    assert not os.path.exists(os.path.join(tmp_path, "BENCH_table2.json"))


def test_run_writes_schema_valid_artifact(tmp_path, monkeypatch):
    seen = {}

    def fake(tracker=None, **kwargs):
        seen.update(kwargs)
        return [("table2/x", 5.0, 1.25)]

    monkeypatch.setattr(table2_sigma, "bench", fake)
    rc = run.main(["table2", "--out", str(tmp_path), "--device", "cpu"])
    assert rc == 0 and seen == {"device": "cpu"}
    doc = obs.load(os.path.join(tmp_path, "BENCH_table2.json"))
    assert obs.validate(doc) == []
    assert doc["metrics"]["table2/x"]["value"] == 1.25
    assert doc["gates"] == jrun.GATES["table2"], "table2 artifact must carry regression gates"
    assert doc["env"]["platform"] == "cpu" and doc["env"]["jax_version"] is None


@pytest.mark.parametrize("suite", ["roofline"])
def test_run_refuses_suites_not_ported(suite, capsys):
    with pytest.raises(SystemExit) as e:
        run.main([suite, "--device", "cpu"])
    assert e.value.code == 2
    assert "not ported yet" in capsys.readouterr().err


def test_run_transport_suite_on_cpu_passes_its_baseline(tmp_path):
    """The whole path on the CPU: the transport suite's BENCH document holds
    every gate of the reference's committed baseline but the CPU-interpret
    timings, and its chaos metrics come through the tracker."""
    jsonl = tmp_path / "events.jsonl"
    assert run.main(["transport", "--out", str(tmp_path), "--device", "cpu", "--jsonl", str(jsonl)]) == 0
    doc = obs.load(os.path.join(tmp_path, "BENCH_transport.json"))
    assert obs.validate(doc) == []
    assert {"transport/goodput", "transport/rounds_ratio", "transport/crc32c"} <= set(doc["metrics"])
    with open(os.path.join(BASELINES, "BENCH_transport.json")) as fh:
        base = json.load(fh)
    base["gates"] = [g for g in base["gates"] if g["field"] == "value"]
    failures, checked = bench_diff.diff_docs(base, doc)
    assert failures == [] and checked == ["transport/goodput:value", "transport/rounds_ratio:value"]
    assert any(e.get("kind") == "metrics" for e in obs.read_jsonl(str(jsonl)))


# -- stepsize_grid shim and the scenario suite (tests/test_scenario_matrix.py) -


def test_stepsize_grid_shim_warns_and_keeps_row_names():
    prob = problems.generate_problem(n=4, d=16, noise_scale=1.0, seed=0, device="cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        rows = stepsize_grid.bench(prob=prob, T=4, factors=[1.0], methods=("perm",))
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)
    assert [r[0] for r in rows] == ["stepsize_grid/polyak/perm/best_factor",
                                    "stepsize_grid/polyak/perm/final_subopt"]
    # the folded-in API is reachable from scenario_matrix directly, no warning
    assert stepsize_grid.tune is scenario_matrix.tune


def test_run_py_registers_scenario_suite_with_gates():
    gates = run.GATES["scenario"]
    patterns = {g["pattern"] for g in gates}
    assert "scenario/*/rounds_to_target" in patterns
    assert "scenario/*/goodput" in patterns
    # legacy suite name still registered (deprecation shim target)
    assert "stepsize_grid" in run.GATES


def test_polyak_factor_grid_rows_match_reference_names():
    from benchmarks import scenario_matrix as jscenario
    from repro.core import problems as JP

    methods = ("ef21p", "same", "ind", "perm")
    prob = problems.generate_problem(n=4, d=16, noise_scale=1.0, seed=0, device="cpu")
    rows = scenario_matrix.polyak_factor_grid(prob=prob, T=6, factors=[0.5, 1.0], methods=methods)
    jprob = JP.generate_problem(n=4, d=16, noise_scale=1.0, seed=0)
    jrows = jscenario.polyak_factor_grid(prob=jprob, T=6, factors=[0.5, 1.0], methods=methods)
    assert [r[0] for r in rows] == [r[0] for r in jrows]
    for (name, _, got), (_, _, want) in zip(rows, jrows):
        assert np.isfinite(got)
        if name.endswith("final_subopt"):
            assert got > 0


# -- transport_bench: the clean run must reach its target ---------------------


def test_chaos_metrics_raises_when_clean_target_unreachable():
    """As the reference's bare next(): a clean run that never gets below
    0.25 * f_x[0] makes rounds_ratio meaningless, so it raises."""
    with pytest.raises(StopIteration, match="never reached"):
        transport_bench.chaos_metrics(T=2, device="cpu")
    assert transport_bench.chaos_metrics(T=40, device="cpu")["transport/rounds_ratio"] > 0


def test_transport_bench_adapter_logs_chaos_metrics():
    tr = obs.MemoryTracker()
    rows = transport_bench.bench(tracker=tr, device="cpu")
    assert [r[0] for r in rows] == ["transport/frame_encode", "transport/frame_decode", "transport/crc32c"]
    logged = {k for e in tr.events if e["kind"] == "metrics" for k in e["metrics"]}
    assert {"transport/goodput", "transport/rounds_ratio", "transport/retries"} <= logged


# -- trace_smoke --------------------------------------------------------------


def test_trace_smoke_spans_validate_and_are_deterministic(tmp_path):
    a = trace_smoke.run(str(tmp_path / "a.jsonl"), rounds=8, device="cpu")
    b = trace_smoke.run(str(tmp_path / "b.jsonl"), rounds=8, device="cpu")
    ea, eb = list(obs.read_jsonl(a)), list(obs.read_jsonl(b))
    spans = [e for e in ea if e.get("kind") == "span"]
    assert sum(1 for s in spans if s["name"] == "round") == 8
    assert analyze.validate_spans(ea) == []
    assert any(s["name"].startswith("link/worker") for s in spans)
    assert analyze.report(ea)[1] >= 1  # a degraded round attributed to a worker link
    assert obs.events_equal(ea, eb)
    assert trace_smoke.main(["--out", str(tmp_path / "c.jsonl"), "--rounds", "3", "--device", "cpu"]) == 0
    assert trace_smoke.CHAOS_SPEC == trace_smoke.FaultSpec(drop=0.15, straggler=0.2, straggler_ticks=3, seed=7)


# -- the harness adapters of suites ported earlier -----------------------------


def _baseline_metrics(suite):
    with open(os.path.join(BASELINES, f"BENCH_{suite}.json")) as fh:
        return json.load(fh)["metrics"]


def test_wire_bench_adapter_has_the_baselines_metrics(tmp_path):
    sink = obs.BenchJsonSink("wire", str(tmp_path), seed=0, gates=run.GATES["wire"])
    rows = wire_bench.bench(tracker=sink, device="cpu")
    for row in rows:
        sink.log_row(*row)
    sink.finish()
    doc = obs.load(sink.path)
    assert set(doc["metrics"]) == set(_baseline_metrics("wire"))
    assert [r[0] for r in rows] == ["wire/sparse_encode", "wire/sparse_decode", "wire/dense_encode"]
    assert all(r[2] > 0 for r in rows)


def test_fig1_adapter_rows_and_telemetry(monkeypatch):
    calls = []
    real = fig1.run_suite

    def small(**kw):  # the adapter's settings, cut to a few rounds
        calls.append(kw)
        return real(**dict(kw, d=20, T=3))

    monkeypatch.setattr(fig1, "run_suite", small)
    tr = obs.MemoryTracker()
    rows = fig1.bench(tracker=tr, device="cpu")
    assert calls == [dict(d=200, n=n, noise=1.0, T=400, device="cpu") for n in (10, 50)]
    methods = ["ef21p_topk_const", "marina_same_const", "marina_ind_const", "marina_perm_const",
               "ef21p_topk_polyak", "marina_same_polyak", "marina_ind_polyak", "marina_perm_polyak"]
    assert [r[0] for r in rows] == [f"fig1/n{n}/{m}" for n in (10, 50) for m in methods]
    logged = {k for e in tr.events if e["kind"] == "metrics" for k in e["metrics"]}
    assert "fig1/n10/marina_perm_polyak/bits_per_round" in logged


def test_scenario_suite_rows_have_the_baselines_gated_metrics():
    """Every scenario/* metric of the committed baseline is a row the port's
    bench makes (the cells and row kinds are the reference's)."""
    want = {m for m in _baseline_metrics("scenario") if m.startswith("scenario/")}
    got = {f"scenario/{scenario_matrix.cell_id(*c)}/{what}" for c in scenario_matrix.DEFAULT_CELLS
           for what in ("rounds_to_target", "s2w_bits", "goodput", "final_f")}
    assert got == want
