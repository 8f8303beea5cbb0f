"""The port's tracing and telemetry (``repro_torch.obs``) against the JAX
reference's ``repro.obs``, and the ``tracker`` argument of its runs.

The copies (trace, hist, analyze) must give the reference's events,
percentiles and Perfetto documents; the tracker's CUDA sync and
torch.profiler hooks and the BENCH_*.json provenance are the port's own,
and a port artifact must pass the reference's own schema check. A traced
run of the port must emit the reference's span tree and metric events
(the reference's draws injected, floats within 1e-4).
"""
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from benchmarks import bench_diff  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro.core import compressors as JC  # noqa: E402
from repro.core import ef21p as JE  # noqa: E402
from repro.core import marina_p as JM  # noqa: E402
from repro.core import problems as JP  # noqa: E402
from repro.core import stepsizes as JS  # noqa: E402
from repro.obs import analyze as janalyze  # noqa: E402
from repro.obs import bench_json as jbench_json  # noqa: E402
from repro.transport import FaultSpec as JFaultSpec  # noqa: E402
from repro_torch import convert, obs  # noqa: E402
from repro_torch.core import compressors as C  # noqa: E402
from repro_torch.core import ef21p as E  # noqa: E402
from repro_torch.core import marina_p as M  # noqa: E402
from repro_torch.core import problems, stepsizes  # noqa: E402
from repro_torch.obs import analyze  # noqa: E402
from repro_torch.obs.bench_json import BenchJsonSink  # noqa: E402
from repro_torch.obs.hist import StreamingHistogram, percentile  # noqa: E402
from repro_torch.transport import FaultSpec  # noqa: E402

N, D = 4, 32
K = D // N
P = K / D
CHAOS = dict(drop=0.3, straggler=0.3, straggler_ticks=3, seed=7)  # tests/test_trace.py's


def _spans(tracker):
    """One fixed span sequence: nesting, attrs set inside and at open,
    tensors and numpy scalars among them."""
    with tracker.span("round", round=0, alg="x") as rsp:
        with tracker.span("subgrad", fused="a+b"):
            pass
        with tracker.span("broadcast", full_sync=False) as bsp:
            with tracker.span("encode", device=False):
                pass
            bsp.attrs["delivered"] = 3
        rsp.attrs["gamma"] = 0.5
    with tracker.span("round", round=1):
        pass
    tracker.log({"loss": 2.5, "nested": {"a": 1, "b": {"c": 2}}}, step=0)
    tracker.log_row("suite/metric", 12.5, 0.75)


# -- the copies against the reference ---------------------------------------


def test_same_spans_give_the_reference_events():
    t, j = obs.MemoryTracker(), jobs.MemoryTracker()
    _spans(t)
    _spans(j)
    assert obs.events_equal(t.events, j.events) and jobs.events_equal(t.events, j.events)
    assert [e["span_id"] for e in t.events if e["kind"] == "span"] == [1, 3, 2, 0, 4]


def test_scalars_of_tensors_and_numpy_coerced_like_the_reference():
    flat = obs.flatten_metrics({"x": torch.tensor(1.5), "y": torch.tensor(2, dtype=torch.int32),
                                "z": np.float32(0.25), "w": {"v": torch.tensor([3.0])}})
    assert flat == {"x": 1.5, "y": 2, "z": 0.25, "w/v": 3.0}
    assert flat == jobs.flatten_metrics({"x": jnp.float32(1.5), "y": jnp.int32(2),
                                         "z": np.float32(0.25), "w": {"v": jnp.ones(1) * 3}})
    assert isinstance(flat["x"], float) and isinstance(flat["y"], int)
    assert obs.flatten_metrics({"m": torch.ones(2, 2)})["m"].startswith("tensor(")


@pytest.mark.parametrize("cap,n", [(1000, 500), (256, 20000), (64, 5000)])
def test_streaming_histogram_equals_the_reference(cap, n):
    from repro.obs.hist import StreamingHistogram as JHist

    data = np.random.default_rng(cap).lognormal(0.0, 1.5, n) * np.where(
        np.random.default_rng(1).random(n) < 0.2, -1.0, 1.0)
    h, jh = StreamingHistogram(exact_cap=cap), JHist(exact_cap=cap)
    for v in data:
        h.add(float(v))
        jh.add(float(v))
    for q in (0.0, 0.01, 0.5, 0.9, 0.99, 1.0):
        assert h.quantile(q) == jh.quantile(q)
    assert h.summary("_s") == jh.summary("_s")


def test_perfetto_export_equals_the_reference():
    t = obs.MemoryTracker()
    _spans(t)
    doc = analyze.to_perfetto(t.events)
    assert doc == janalyze.to_perfetto(t.events)
    assert analyze.validate_perfetto(doc) == [] == janalyze.validate_perfetto(doc)
    assert analyze.report(t.events) == janalyze.report(t.events)


def test_port_bench_json_passes_the_reference_validate(tmp_path):
    sink = BenchJsonSink("port", str(tmp_path), seed=3,
                         gates=[{"pattern": "suite/*", "field": "value", "direction": "eq", "rtol": 0.1}])
    _spans(sink)
    with sink.time_block("blk") as tb:
        tb.block(torch.ones(3) * 2)
    sink.finish()
    doc = obs.load(sink.path)
    assert obs.validate(doc) == [] == jbench_json.validate(doc)
    env = doc["env"]
    assert env["jax_version"] is None and env["torch_version"] == torch.__version__
    assert env["cuda_version"] == torch.version.cuda and env["seed"] == 3
    assert env["platform"] == ("gpu" if torch.cuda.is_available() else "cpu")
    # the reference's regression gate reads port artifacts
    failures, checked = bench_diff.diff_docs(doc, doc)
    assert failures == [] and checked


def test_environment_keys():
    env = obs.environment(seed=1)
    for k in ("git_rev", "jax_version", "device_kind", "platform", "seed", "torch_version",
              "cuda_version"):
        assert k in env


# -- cases of tests/test_obs.py ---------------------------------------------


def _drive(tracker):
    tracker.log({"loss": torch.tensor(2.5), "nested": {"a": 1, "b": {"c": 2}}}, step=0)
    tracker.log_row("suite/metric", 12.5, 0.75)
    with tracker.time_block("blk", step=1) as tb:
        tb.block(torch.ones(()) * 2)


def test_memory_vs_jsonl_equivalence(tmp_path):
    mem = obs.MemoryTracker()
    path = os.path.join(tmp_path, "events.jsonl")
    jl = obs.JsonlTracker(path)
    _drive(obs.CompositeTracker(mem, jl))
    jl.finish()
    replayed = obs.read_jsonl(path)
    assert len(replayed) == len(mem.events) == 3
    assert obs.events_equal(mem.events, replayed)


def test_timer_waits_for_the_work_it_blocks_on():
    """Positive durations, nondecreasing wall clock, steps recorded; block()
    returns its argument (tensors, or dicts and lists of them)."""
    mem = obs.MemoryTracker()
    x = torch.ones((128, 128))
    for i in range(3):
        with mem.time_block("mm", step=i) as tb:
            out = tb.block({"y": [(x @ x).sum()]})
    assert torch.equal(out["y"][0], (x @ x).sum())
    timers = [e for e in mem.events if e["kind"] == "timer"]
    assert len(timers) == 3 and all(t["seconds"] > 0 for t in timers)
    walls = [t["wall_time"] for t in timers]
    assert walls == sorted(walls) and [t["step"] for t in timers] == [0, 1, 2]


def test_csv_stdout_format(capsys):
    t = obs.CsvStdoutTracker(header=True)
    t.log_row("a/b", 12.34, "0.5GB/s")
    t.log({"ignored": 1})
    assert capsys.readouterr().out.splitlines() == ["name,us_per_call,derived", "a/b,12.3,0.5GB/s"]


def _make_doc(tmp_path, gates=None, rows=(("s/m", 10.0, 2.0),)):
    sink = BenchJsonSink("t1", str(tmp_path), seed=0, gates=gates or [])
    for name, us, derived in rows:
        sink.log_row(name, us, derived)
    with sink.time_block("t1/block"):
        pass
    sink.finish()
    return sink.path


def test_bench_json_schema_roundtrip(tmp_path):
    path = _make_doc(tmp_path, gates=[{"pattern": "s/*", "field": "value", "direction": "eq",
                                       "rtol": 0.1}])
    doc = obs.load(path)
    assert obs.validate(doc) == []
    assert doc["schema_version"] == obs.SCHEMA_VERSION == jobs.SCHEMA_VERSION
    assert doc["suite"] == "t1"
    assert doc["metrics"]["s/m"] == {"count": 1, "us_per_call": 10.0, "value": 2.0}
    assert doc["timers"]["t1/block"]["n"] == 1
    assert json.loads(json.dumps(doc)) == doc


def test_bench_json_percentiles(tmp_path):
    sink = BenchJsonSink("pct", str(tmp_path), seed=0)
    for v in range(100):
        sink.log({"lat": float(v)})
    entry = sink.document()["metrics"]["lat"]
    assert entry["count"] == 100 and entry["value"] == 99.0
    assert entry["p50"] == pytest.approx(50.0, abs=1.0)
    assert entry["p99"] == pytest.approx(99.0, abs=1.0)


def test_bench_json_validate_catches_violations():
    assert obs.validate({}) != []
    doc = {
        "schema_version": obs.SCHEMA_VERSION, "suite": "x", "created_unix": 0.0,
        "env": {"git_rev": None, "jax_version": None, "device_kind": None,
                "platform": None, "seed": 0},
        "metrics": {"m": {"count": 0}},
        "timers": {}, "gates": [{"pattern": "m"}],
    }
    errors = obs.validate(doc)
    assert errors == jbench_json.validate(doc)
    assert any("count" in e for e in errors) and any("gates[0]" in e for e in errors)


def test_default_tracker_jsonl_env(tmp_path, monkeypatch):
    path = os.path.join(tmp_path, "stream.jsonl")
    monkeypatch.setenv("REPRO_OBS_JSONL", path)
    obs.reset_default_tracker()
    obs.default_tracker().log({"dryrun": {"t_compile_s": 1.5}})
    obs.reset_default_tracker()
    assert obs.read_jsonl(path)[0]["metrics"] == {"dryrun/t_compile_s": 1.5}
    monkeypatch.delenv("REPRO_OBS_JSONL")
    obs.reset_default_tracker()


def test_get_logger_is_the_ports_own():
    assert obs.get_logger().name == "repro_torch"
    assert obs.get_logger("bench").name == "repro_torch.bench"


# -- cases of tests/test_trace.py -------------------------------------------


def test_span_nesting_and_ids():
    tr = obs.MemoryTracker()
    with tr.span("round", round=0) as rsp:
        with tr.span("broadcast"):
            with tr.span("encode"):
                pass
        rsp.attrs["gamma"] = 0.5
    with tr.span("round", round=1):
        pass
    spans = analyze.span_events(tr.events)
    assert [s["name"] for s in spans] == ["encode", "broadcast", "round", "round"]
    by_name = {s["name"]: s for s in spans[:3]}
    assert by_name["broadcast"]["parent"] == by_name["round"]["span_id"]
    assert by_name["encode"]["parent"] == by_name["broadcast"]["span_id"]
    assert by_name["round"]["parent"] is None
    assert [s["span_id"] for s in spans] == [2, 1, 0, 3]
    assert by_name["round"]["attrs"] == {"round": 0, "gamma": 0.5}
    assert all(s["t1"] >= s["t0"] for s in spans)


def test_maybe_span_none_tracker_is_noop():
    with obs.maybe_span(None, "round") as sp:
        assert sp is None
        obs.maybe_attr(sp, x=1)


def test_span_composite_fanout_and_jsonl_roundtrip(tmp_path):
    log = tmp_path / "run.jsonl"
    mem, jl = obs.MemoryTracker(), obs.JsonlTracker(str(log))
    comp = obs.CompositeTracker(mem, jl)
    with comp.span("round", round=0):
        with comp.span("broadcast", full_sync=False):
            pass
    comp.finish()
    assert obs.events_equal(mem.events, obs.read_jsonl(str(log)))
    spans = analyze.span_events(obs.read_jsonl(str(log)))
    assert [s["name"] for s in spans] == ["broadcast", "round"]
    assert spans[0]["attrs"] == {"full_sync": False}


def test_validate_spans_catches_malformed_streams():
    ok = {"kind": "span", "name": "a", "span_id": 0, "parent": None,
          "t0": 1.0, "t1": 2.0, "attrs": {}}
    assert analyze.validate_spans([ok]) == []
    cases = [[ok, dict(ok, span_id=1, parent=99)], [dict(ok, span_id=2, t0=3.0, t1=1.0)],
             [ok, dict(ok)], [{"kind": "span", "name": "a", "span_id": 3}]]
    for case, word in zip(cases, ("orphan parent", "t1 < t0", "duplicate span_id", "missing t0")):
        errors = analyze.validate_spans(case)
        assert any(word in e for e in errors) and errors == janalyze.validate_spans(case)


def test_percentile_linear_interpolation():
    vals = sorted(float(v) for v in range(100))
    assert percentile(vals, 0.0) == 0.0 and percentile(vals, 1.0) == 99.0
    assert percentile(vals, 0.50) == pytest.approx(49.5)
    assert percentile(vals, 0.99) == pytest.approx(98.01)
    assert percentile([5.0], 0.75) == 5.0


def test_streaming_histogram_sees_past_cap_and_ignores_nan():
    h = StreamingHistogram(exact_cap=256)
    for _ in range(256):
        h.add(1e-3)
    for _ in range(4096):
        h.add(1.0)
    assert h.quantile(0.99) == pytest.approx(1.0, rel=0.05) and h.n == 4352
    h = StreamingHistogram()
    h.add(float("nan"))
    for v in (0.5, -2.0, 3.0):
        h.add(v)
    s = h.summary("_s")
    assert s["n"] == 3 and s["total_s"] == pytest.approx(1.5) and s["p50_s"] == pytest.approx(0.5)


def test_bench_sink_aggregates_spans_as_namespaced_timers(tmp_path):
    sink = obs.BenchJsonSink("t", str(tmp_path))
    with sink.span("round"):
        pass
    with sink.time_block("round"):
        pass
    sink.finish()
    doc = obs.load(sink.path)
    assert "span/round" in doc["timers"] and "round" in doc["timers"]
    assert jbench_json.validate(doc) == []


def test_profile_writes_a_chrome_trace_and_its_event(tmp_path):
    tr = obs.MemoryTracker()
    with tr.profile("step", trace_dir=str(tmp_path)):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    profs = [e for e in tr.events if e["kind"] == "profile"]
    assert len(profs) == 1 and profs[0]["name"] == "step"
    assert profs[0]["trace_dir"] == os.path.join(str(tmp_path), "step")
    with open(os.path.join(profs[0]["trace_dir"], "trace.json")) as fh:
        assert "traceEvents" in json.load(fh)
    tr2 = obs.MemoryTracker()
    env = os.environ.pop("REPRO_OBS_TRACE_DIR", None)
    try:
        with tr2.profile("step"):
            pass
    finally:
        if env is not None:
            os.environ["REPRO_OBS_TRACE_DIR"] = env
    assert tr2.events == []


# -- traced runs ---------------------------------------------------------------


@pytest.fixture(scope="module")
def probs():
    jp = JP.generate_problem(n=N, d=D, noise_scale=1.0, seed=0)
    tp = convert.problem_from_numpy(np.asarray(jp.A), np.asarray(jp.x0), np.asarray(jp.L0i),
                                    jp.sigma_A, device="cpu")
    return jp, tp


def inject_perm_draws(monkeypatch, seed):
    key = jax.random.PRNGKey(seed)

    def draw_round(bcast, p, d, generator, device):
        nonlocal key
        key, sub = jax.random.split(key)
        k_bern, k_comp = jax.random.split(sub)
        masks = np.asarray(JM.make_broadcast("perm", N, K)[0](k_comp, jnp.ones(D))) != 0
        idx = np.concatenate([np.flatnonzero(m) for m in masks])
        return M.MarinaPDraws(coin=bool(jax.random.bernoulli(k_bern, p)),
                              idx=torch.from_numpy(idx.astype(np.int64)))

    monkeypatch.setattr(M, "draw_round", draw_round)


def _shape(events):
    """The span forest's signature without float attrs (gamma), and the
    metric events with their floats rounded to 1e-4 relative."""
    def strip(node):
        return (node.name, tuple(sorted((k, repr(v)) for k, v in node.attrs.items()
                                        if not isinstance(v, float))),
                tuple(strip(c) for c in node.children))

    def rnd(v):
        return float(f"{v:.4g}") if isinstance(v, float) else v

    forest = [strip(r) for r in analyze.build_tree(events)]
    metrics = [(e["step"], {k: rnd(v) for k, v in e["metrics"].items()})
               for e in events if e["kind"] == "metrics"]
    return forest, metrics


@pytest.mark.parametrize("chaos", [False, True])
def test_traced_marina_p_run_emits_the_reference_trace(probs, monkeypatch, chaos):
    jp, tp = probs
    kw = dict(mode="perm", k=K, p=P, T=10, seed=1)
    jt, tt = jobs.MemoryTracker(), obs.MemoryTracker()
    JM.run(jp, stepsize=JS.Constant(0.01), tracker=jt,
           transport=JFaultSpec(**CHAOS) if chaos else None,
           **kw)
    inject_perm_draws(monkeypatch, 1)
    M.run(tp, stepsize=stepsizes.Constant(0.01), tracker=tt,
          transport=FaultSpec(**CHAOS) if chaos else None, **kw)
    got, want = _shape(tt.events), _shape(jt.events)
    assert got[0] == want[0]
    assert len(got[1]) == len(want[1]) and [s for s, _ in got[1]] == [s for s, _ in want[1]]
    for (_, g), (_, w) in zip(got[1], want[1]):
        assert g.keys() == w.keys()
        for name in g:
            np.testing.assert_allclose(g[name], w[name], rtol=2e-4)
    assert analyze.validate_spans(tt.events) == []


def test_traced_ef21p_run_emits_the_reference_trace(probs):
    jp, tp = probs
    jt, tt = jobs.MemoryTracker(), obs.MemoryTracker()
    JE.run(jp, JC.TopK(k=K), JS.Constant(0.02), T=6, tracker=jt)
    E.run(tp, C.TopK(k=K), stepsizes.Constant(0.02), T=6, tracker=tt)
    assert _shape(tt.events)[0] == _shape(jt.events)[0]
    assert [e["metrics"].keys() for e in tt.events if e["kind"] == "metrics"] == \
        [e["metrics"].keys() for e in jt.events if e["kind"] == "metrics"]


def test_tracker_changes_no_result(probs):
    """With and without a tracker: the same f_x and the same bits, bit for bit."""
    _, tp = probs
    kw = dict(mode="ind", k=K, p=P, stepsize=stepsizes.MarinaPPolyak(omega=D / K - 1, p=P),
              T=8, seed=2, measure_wire=True, transport=FaultSpec(**CHAOS))
    a, b = M.run(tp, **kw), M.run(tp, tracker=obs.MemoryTracker(), **kw)
    assert a["f_x"] == b["f_x"] and a["wire_bits"] == b["wire_bits"]
    assert a["transport"] == b["transport"]
    kw = dict(T=8, measure_wire=True, transport=FaultSpec(**CHAOS))
    a = E.run(tp, C.TopK(k=K), stepsizes.EF21PPolyak(alpha=K / D), **kw)
    b = E.run(tp, C.TopK(k=K), stepsizes.EF21PPolyak(alpha=K / D), tracker=obs.MemoryTracker(), **kw)
    assert a["f_x"] == b["f_x"] and a["wire_bits"] == b["wire_bits"]


@pytest.fixture(scope="module")
def prob():
    return problems.generate_problem(n=N, d=D, noise_scale=1.0, seed=0, device="cpu")


def _chaos_run(prob, tracker, *, seed=1, T=10):
    return M.run(prob, mode="perm", k=K, p=P, stepsize=stepsizes.Constant(gamma=0.01), T=T,
                 seed=seed, transport=FaultSpec(**CHAOS), tracker=tracker)


def test_marina_run_tracker_and_w2s_bits(prob):
    tr = obs.MemoryTracker()
    h = M.run(prob, mode="perm", k=16, p=0.25, stepsize=stepsizes.Constant(0.02), T=8, tracker=tr)
    assert h["w2s_bits"][-1] == pytest.approx(8 * 64 * prob.d)
    events = [e for e in tr.events if e["kind"] == "metrics"]
    assert len(events) == 8
    assert events[-1]["metrics"]["marina_p/w2s_bits"] == h["w2s_bits"][-1]
    assert "marina_p/s2w_bits" in events[0]["metrics"]


def test_ef21p_run_tracker_and_w2s_bits(prob):
    tr = obs.MemoryTracker()
    h = E.run(prob, C.TopK(k=8), stepsizes.Constant(0.02), T=5, tracker=tr)
    assert h["w2s_bits"][-1] == pytest.approx(5 * 64 * prob.d)
    assert len([e for e in tr.events if e["kind"] == "metrics"]) == 5


def test_chaos_span_tree_deterministic(prob):
    t1, t2, t3 = obs.MemoryTracker(), obs.MemoryTracker(), obs.MemoryTracker()
    _chaos_run(prob, t1)
    _chaos_run(prob, t2)
    _chaos_run(prob, t3, seed=2)
    assert obs.events_equal(t1.events, t2.events)
    sig = [r.signature() for r in analyze.build_tree(t1.events)]
    assert sig == [r.signature() for r in analyze.build_tree(t2.events)]
    assert sig != [r.signature() for r in analyze.build_tree(t3.events)]


def test_chaos_spans_carry_link_attribution_and_degraded_rounds(prob):
    tr = obs.MemoryTracker()
    _chaos_run(prob, tr)
    roots = analyze.build_tree(tr.events)
    assert all(r.name == "round" for r in roots)
    names = {s.name for r in roots for s in r.walk()}
    assert {"round", "subgrad", "stepsize", "broadcast", "encode"} <= names
    links = [s for r in roots for s in r.walk()
             if s.name.startswith("link/worker") and "/" not in s.name[5:]]
    assert links and all("delivered" in s.attrs and "retries" in s.attrs for s in links)
    assert sum(int(s.attrs["retries"]) for s in links) > 0
    reports = analyze.round_reports(roots)
    degraded = [r for r in reports if r.degraded]
    assert len(reports) == 10 and degraded
    assert all(r.culprit.startswith("link/worker") for r in degraded)
    text, n_degraded = analyze.report(tr.events)
    assert n_degraded == len(degraded) and "DEGRADED <- link/worker" in text


def test_perfetto_export_well_formed(prob, tmp_path):
    tr = obs.MemoryTracker()
    _chaos_run(prob, tr, T=4)
    doc = analyze.to_perfetto(tr.events)
    assert analyze.validate_perfetto(doc) == []
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert len(xs) == len(analyze.span_events(tr.events))
    assert all(e["dur"] >= 0 and e["ts"] >= 0 for e in xs)
    out = tmp_path / "trace.json"
    out.write_text(json.dumps(doc))
    assert analyze.validate_perfetto(json.loads(out.read_text())) == []


def test_analyze_cli_end_to_end(prob, tmp_path, capsys):
    log = tmp_path / "run.jsonl"
    tr = obs.JsonlTracker(str(log))
    _chaos_run(prob, tr)
    tr.finish()
    trace = tmp_path / "trace.json"
    assert analyze.main([str(log), "--perfetto", str(trace), "--require-degraded"]) == 0
    assert analyze.main(["--validate-trace", str(trace)]) == 0
    out = capsys.readouterr().out
    assert "round" in out and "DEGRADED" in out
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert analyze.main([str(empty), "--require-degraded"]) == 1
