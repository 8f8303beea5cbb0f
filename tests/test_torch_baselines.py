"""The port's own baselines (``src/repro_torch/baselines``), made on an H100
with ``python -m repro_torch.run <suites> --device cuda`` (and the
``roofline`` suite over chip_smoke.py (u)'s dry-run records): the seven
suites the reference keeps baselines for, plus roofline. Each is a valid
schema-v1 document from a card, carries the harness's gates, and names the
metrics a fresh run emits, so that ``bench_diff`` (which defaults to this
directory) can hold a card run to it gate by gate.
"""
import pathlib

import pytest

from repro_torch import bench_diff, kernel_bench, obs, run

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch" / "baselines"
REFERENCE = ROOT / "benchmarks" / "baselines"
SUITES = ("encode", "kernels", "scenario", "serve", "table2", "transport", "wire")
SHARED = ("encode", "scenario", "serve", "table2", "transport", "wire")  # row names the reference's


def load(directory, suite):
    return obs.load(str(directory / f"BENCH_{suite}.json"))


def test_the_reference_suites_plus_roofline():
    """Exactly the file names of the reference's baselines, and roofline
    (the scenario suite's per-cell documents are not baselines)."""
    assert sorted(p.name for p in REFERENCE.glob("*.json")) == [f"BENCH_{s}.json" for s in SUITES]
    assert sorted(p.name for p in PORT.iterdir()) == sorted(f"BENCH_{s}.json" for s in SUITES + ("roofline",))


@pytest.mark.parametrize("suite", SUITES + ("roofline",))
def test_document_from_the_card_with_the_harness_gates(suite):
    doc = load(PORT, suite)
    assert obs.validate(doc) == []
    assert doc["suite"] == suite
    assert doc["env"]["platform"] == "gpu" and "H100" in doc["env"]["device_kind"], doc["env"]
    assert doc["env"]["jax_version"] is None and doc["env"]["cuda_version"]
    assert doc["gates"] == run.GATES[suite]
    assert all(m["us_per_call"] > 0 for m in doc["metrics"].values() if "us_per_call" in m)


@pytest.mark.parametrize("suite", SHARED)
def test_metric_names_include_the_references(suite):
    assert set(load(REFERENCE, suite)["metrics"]) <= set(load(PORT, suite)["metrics"])


def test_kernels_names_are_kernel_bench_rows():
    rows = {f"kernels/{name}/{side}" for name, *_ in kernel_bench.cases(kernel_bench.inputs("cpu"))
            for side in ("ops", "plain")}
    assert set(load(PORT, "kernels")["metrics"]) == rows


def test_bench_diff_defaults_to_the_port_baselines(capsys):
    assert pathlib.Path(bench_diff.DEFAULT_BASELINE) == PORT
    failures, report = bench_diff.diff_dirs(str(PORT), str(PORT))
    assert failures == [] and len(report) == len(SUITES) + 1
    assert bench_diff.main(["--fresh", str(PORT)]) == 0  # against itself, by default
    assert "no regressions" in capsys.readouterr().out
    # the reference's CPU-interpret kernels rows do not name the port's
    assert bench_diff.main(["--fresh", str(PORT), "--baseline", str(REFERENCE), "--suite", "kernels"]) == 1


def test_timing_gates_hold_a_card_run_to_five_times_the_baseline():
    """The us_per_call gate of every timed suite: 5x the card's time passes,
    a row just over it fails."""
    for suite in ("kernels", "wire", "encode", "transport", "scenario", "serve"):
        base = load(PORT, suite)
        name, entry = next((n, m) for n, m in sorted(base["metrics"].items()) if "us_per_call" in m)
        fresh = {"metrics": dict(base["metrics"])}
        fresh["metrics"][name] = dict(entry, us_per_call=entry["us_per_call"] * 5.0)
        assert bench_diff.diff_docs(base, fresh)[0] == [], suite
        fresh["metrics"][name] = dict(entry, us_per_call=entry["us_per_call"] * 5.001)
        failures = bench_diff.diff_docs(base, fresh)[0]
        assert len(failures) == 1 and failures[0].startswith(f"{name}:us_per_call: "), (suite, failures)
