"""Paper Table 2 on the port (repro_torch.table2_sigma) against the
reference's benchmarks/table2_sigma.py.

sigma_A at n = 10, d = 1000 for s in {0.1, 1, 10} is a numpy float64
computation on Algorithm 3's matrices, bit-equal to the reference's in one
process, and within the committed baseline's eq gate (rtol 0.05). Its last
bits follow OpenBLAS's thread count (the eigen- and singular-value routines
split their work by it), so both datagens run on one BLAS thread, which is
also what keeps them fast beside other test processes.
"""
import json
import os

import pytest

pytest.importorskip("jax")
threadpool_limits = pytest.importorskip("threadpoolctl").threadpool_limits

from repro.core import problems as JP  # noqa: E402
from repro_torch import bench_diff, obs, table2_sigma  # noqa: E402

BASELINES = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "baselines")


@pytest.mark.parametrize("s", [0.1, 1.0, 10.0])
def test_table2_sigma_bit_equal_to_reference(s):
    with threadpool_limits(limits=1, user_api="blas"):
        rows = table2_sigma.bench(d=1000, cells=[(10, s)], device="cpu")
        want = JP.generate_problem(n=10, d=1000, noise_scale=s, seed=0).sigma_A
    assert [r[0] for r in rows] == [f"table2/sigmaA/n10/s{s}"]
    assert rows[0][2] == want  # bit for bit, float64
    with open(os.path.join(BASELINES, "BENCH_table2.json")) as fh:
        base = json.load(fh)
    name = f"table2/sigmaA/n10/s{s}"
    base["metrics"] = {name: base["metrics"][name]}
    fresh = {"metrics": {name: {"count": 1, "value": rows[0][2]}}}
    failures, checked = bench_diff.diff_docs(base, fresh)
    assert failures == [] and checked == [f"{name}:value"]


def test_table2_tracker_metrics_are_the_references():
    tr = obs.MemoryTracker()
    table2_sigma.row(100, 1.0, 0.8193920777294864, 1.0, tr)
    flat = {k: v for e in tr.events if e["kind"] == "metrics" for k, v in e["metrics"].items()}
    assert flat == {"table2/n100/s1.0/sigma_A": 0.8193920777294864, "table2/n100/s1.0/paper": 0.83,
                    "table2/n100/s1.0/abs_err": abs(0.8193920777294864 - 0.83)}
    from benchmarks import table2_sigma as jt2

    assert table2_sigma.PAPER == jt2.PAPER
