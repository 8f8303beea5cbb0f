"""The port's client fleet (``repro_torch.fleet``), the ``participation``
argument of its runs and its scenario entry points against the JAX
reference.

Populations, samplers and fault specs are numpy in both, so they are held
bit for bit. Plan masks are held on the reference's own draws. The runs are
held with the reference's draws injected (p-coins and PermK sets as in
``test_torch_algorithms.py``, participation draws from ``fold_in(key,
PARTICIPATION_FOLD)``): MARINA-P's f_x within 1e-4; participation stats,
bits and cohort sizes equal. EF21-P's f_x is compared only where its TopK
sees no exact ties (see ROADMAP Queue 3).
"""
import dataclasses
import tracemalloc

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.fleet as JF  # noqa: E402
from benchmarks import scenario_matrix as jscenario  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro.core import compressors as JC  # noqa: E402
from repro.core import ef21p as JE  # noqa: E402
from repro.core import marina_p as JM  # noqa: E402
from repro.core import problems as JP  # noqa: E402
from repro.core import stepsizes as JS  # noqa: E402
from repro.transport import FaultInjector as JFaultInjector  # noqa: E402
from repro_torch import convert, federated_l1, obs, scenario_matrix, transport_bench  # noqa: E402
from repro_torch import fleet as F  # noqa: E402
from repro_torch.core import compressors as C  # noqa: E402
from repro_torch.core import ef21p as E  # noqa: E402
from repro_torch.core import marina_p as M  # noqa: E402
from repro_torch.core import problems, stepsizes  # noqa: E402
from repro_torch.obs import analyze  # noqa: E402
from repro_torch.transport import FaultInjector, FaultSpec  # noqa: E402

MIXES = ("uniform", "two_tier", "two_tier_diurnal", "flaky_mobile")
SAMPLERS = ("uniform", "weighted", "availability", "deadline:2.0")
TRAJ_RTOL = 1e-4


# ---------------------------------------------------------------------------
# populations, samplers, fault specs: bit-equal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mix", MIXES)
def test_population_bit_equal_to_the_reference(mix):
    js, ts = JF.make_fleet(mix, 4096, seed=3), F.make_fleet(mix, 4096, seed=3)
    ids = np.arange(4096)
    for name in ("tier_index", "noise_scale", "data_size", "phase", "drop_prob"):
        assert np.array_equal(getattr(ts, name)(ids), getattr(js, name)(ids)), name
    for t in (0, 5, 23):
        assert np.array_equal(ts.latency(ids, t), js.latency(ids, t))
        assert np.array_equal(ts.available(ids, t), js.available(ids, t))
    assert ts.size_cap == js.size_cap
    for cid, salt in ((0, 0), (17, 3), (4095, 9), (1234, 5)):
        assert dataclasses.astuple(ts.fault_spec_for(cid, round_salt=salt)) == \
            dataclasses.astuple(js.fault_spec_for(cid, round_salt=salt))
    jp, tp = JF.FleetL1Problem(js, d=24), F.FleetL1Problem(ts, d=24)
    sel = ids[::97]
    assert np.array_equal(tp.materialize(sel), jp.materialize(sel))
    assert np.array_equal(tp.client_L0(sel), jp.client_L0(sel))
    assert np.array_equal(tp.x0, jp.x0) and tp.shift == jp.shift
    assert np.array_equal(tp.eval_cohort(64), jp.eval_cohort(64))
    assert tp.lipschitz_estimates() == jp.lipschitz_estimates()


@pytest.mark.parametrize("kind", SAMPLERS)
@pytest.mark.parametrize("mix", MIXES)
def test_cohorts_bit_equal_to_the_reference(mix, kind):
    js, ts = JF.make_fleet(mix, 4096, seed=1), F.make_fleet(mix, 4096, seed=1)
    jsm, tsm = JF.make_sampler(kind, js, 16, seed=9), F.make_sampler(kind, ts, 16, seed=9)
    for t in range(6):
        a, b = tsm.cohort(t), jsm.cohort(t)
        assert np.array_equal(a.ids, b.ids) and np.array_equal(a.active, b.active)
        assert np.array_equal(a.weights, b.weights) and a.fill == b.fill


def test_fault_plans_of_client_specs_equal_the_reference():
    js, ts = JF.make_fleet("flaky_mobile", 4096, seed=2), F.make_fleet("flaky_mobile", 4096, seed=2)
    for cid in range(0, 4096, 211):
        for t in range(4):
            ji = JFaultInjector(js.fault_spec_for(cid, round_salt=t))
            ti = FaultInjector(ts.fault_spec_for(cid, round_salt=t))
            assert ti.plan(b"\x00" * 16) == ji.plan(b"\x00" * 16)


# ---------------------------------------------------------------------------
# participation plans on the reference's draws
# ---------------------------------------------------------------------------


def reference_plan_draws(key, n):
    """The two draws the reference's BernoulliStragglerPlan takes from its
    participation key."""
    k_drop, k_lat = jax.random.split(key)
    return (torch.from_numpy(np.array(jax.random.uniform(k_drop, (n,)))),
            torch.from_numpy(np.array(jax.random.exponential(k_lat, (n,)))))


@pytest.mark.parametrize("drop,cut", [(0.3, 0.0), (0.0, 1.0), (0.4, 1.5), (0.0, 0.0)])
def test_bernoulli_straggler_masks_equal_the_reference(drop, cut):
    jplan, tplan = JF.BernoulliStragglerPlan(drop, cut), F.BernoulliStragglerPlan(drop, cut)
    for i in range(20):
        key = jax.random.fold_in(jax.random.PRNGKey(i), JF.PARTICIPATION_FOLD)
        want = np.asarray(jplan.mask(key, 12, i))
        got = tplan.mask(reference_plan_draws(key, 12), 12, i)
        assert np.array_equal(got.numpy(), want)


def test_deterministic_plan_masks_equal_the_reference():
    spec = F.make_fleet("two_tier_diurnal", 100, seed=0)
    jspec = JF.make_fleet("two_tier_diurnal", 100, seed=0)
    masks = ((True, False, True), (False,) * 3, (True,) * 3)
    pairs = [(JF.FullParticipation(), F.FullParticipation(), 7),
             (JF.AvailabilityWindowPlan.for_slots(jspec, 10),
              F.AvailabilityWindowPlan.for_slots(spec, 10), 10),
             (JF.CyclingMaskPlan(masks=masks), F.CyclingMaskPlan(masks=masks), 3)]
    for jplan, tplan, n in pairs:
        assert tplan.is_full == jplan.is_full
        assert tplan.draw(n, torch.Generator(), "cpu") is None
        for t in range(30):
            want = np.asarray(jplan.mask(jax.random.PRNGKey(0), n, jnp.int32(t)))
            assert np.array_equal(tplan.mask(None, n, t).numpy(), want)


def test_plan_from_legacy_mapping():
    assert F.plan_from_legacy(0.0, 0.0).is_full
    p = F.plan_from_legacy(0.2, 1.5)
    assert isinstance(p, F.BernoulliStragglerPlan)
    assert p.drop_prob == 0.2 and p.straggler_cutoff == 1.5 and not p.is_full


# ---------------------------------------------------------------------------
# the runs' participation argument against the reference
# ---------------------------------------------------------------------------

N, D = 8, 64
K = D // N
P = K / D


@pytest.fixture(scope="module")
def probs():
    jp = JP.generate_problem(n=N, d=D, noise_scale=1.0, seed=0)
    tp = convert.problem_from_numpy(np.asarray(jp.A), np.asarray(jp.x0), np.asarray(jp.L0i),
                                    jp.sigma_A, device="cpu")
    return jp, tp


class ReferenceKeys:
    """The reference run's key stream: key = PRNGKey(seed); per round key,
    sub = split(key). ``marina_draws`` gives the round's MarinaPDraws over
    ``n`` slots; the plan's draws come from fold_in(sub, PARTICIPATION_FOLD)."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)
        self.sub = None

    def next(self):
        self.key, self.sub = jax.random.split(self.key)
        return self.sub

    def marina_draws(self, mode, n, k, d, p):
        sub = self.next()
        k_bern, k_comp = jax.random.split(sub)
        masks = np.asarray(JM.make_broadcast(mode, n, k)[0](k_comp, jnp.ones(d))) != 0
        idx = (np.flatnonzero(masks[0]) if mode == "same" else
               np.stack([np.flatnonzero(m) for m in masks]) if mode == "ind" else
               np.concatenate([np.flatnonzero(m) for m in masks]))
        return M.MarinaPDraws(coin=bool(jax.random.bernoulli(k_bern, p)),
                              idx=torch.from_numpy(idx.astype(np.int64)))

    def plan_draws(self, n):
        return reference_plan_draws(jax.random.fold_in(self.sub, JF.PARTICIPATION_FOLD), n)


def injected_plan(plan, keys, advance):
    """``plan`` whose ``draw`` returns the reference's draws of this round
    (``advance``: the plan is the first to draw in the round, so it moves
    the key stream itself, as in EF21-P, where TopK draws nothing)."""

    class Injected(type(plan)):
        def draw(self, n, generator, device):
            if advance:
                keys.next()
            return keys.plan_draws(n)

    return Injected(**dataclasses.asdict(plan))


@pytest.mark.parametrize("kind", ["const", "polyak"])
@pytest.mark.parametrize("mode", ["perm", "ind"])
def test_marina_p_participation_against_the_reference(probs, monkeypatch, mode, kind):
    jp, tp = probs
    omega = float(N - 1) if mode == "perm" else D / K - 1.0
    js, ts = ((JS.Constant(0.01), stepsizes.Constant(0.01)) if kind == "const" else
              (JS.MarinaPPolyak(omega=omega, p=P), stepsizes.MarinaPPolyak(omega=omega, p=P)))
    plan = JF.BernoulliStragglerPlan(drop_prob=0.3, straggler_cutoff=1.5)
    want = JM.run(jp, mode=mode, k=K, p=P, stepsize=js, T=30, seed=4, participation=plan)
    keys = ReferenceKeys(4)
    monkeypatch.setattr(M, "draw_round", lambda b, p, d, g, dev: keys.marina_draws(mode, N, K, D, p))
    got = M.run(tp, mode=mode, k=K, p=P, stepsize=ts, T=30, seed=4,
                participation=injected_plan(F.BernoulliStragglerPlan(0.3, 1.5), keys, False))
    assert got["participants"] == want["participants"]
    assert min(got["participants"]) < N
    np.testing.assert_allclose(got["f_x"], want["f_x"], rtol=TRAJ_RTOL)
    assert got["s2w_bits"] == want["s2w_bits"]
    assert set(got) == set(want)


@pytest.mark.parametrize("kind", ["const", "polyak"])
def test_ef21p_participation_step_from_reference_states(probs, kind):
    """30 rounds, each port step taken from the reference's state of that
    round with the reference's plan draws: equal cohorts and delta_nnz, f_x,
    f_w and gamma within 1e-5. (Free-running, the two part within a few
    rounds: all workers evaluate at one w, so the cohort's g has exact ties
    that the cohort-weighted sum breaks by its summation order and TopK
    then keeps other coordinates; ROADMAP Queue 3.)"""
    jp, tp = probs
    js, ts = ((JS.Constant(0.05), stepsizes.Constant(0.05)) if kind == "const" else
              (JS.EF21PPolyak(alpha=K / D), stepsizes.EF21PPolyak(alpha=K / D)))
    jplan = JF.BernoulliStragglerPlan(drop_prob=0.4, straggler_cutoff=1.5)
    jstep = jax.jit(JE.make_step(jp, JC.TopK(k=K), js, participation=jplan))
    tstep = E.make_step(tp, C.TopK(k=K), ts, participation=F.BernoulliStragglerPlan(0.4, 1.5))
    jstate = JE.init(jp.x0)
    sizes = set()
    for t in range(30):
        tstate = convert.ef21p_state_from_numpy(jstate.x, jstate.w, t, "cpu")
        key = jax.random.PRNGKey(t)
        jstate, jm = jstep(jstate, key)
        part = reference_plan_draws(jax.random.fold_in(key, JF.PARTICIPATION_FOLD), N)
        _, tm = tstep(tstate, None, False, part)
        assert float(tm["participants"]) == float(jm["participants"])
        sizes.add(float(tm["participants"]))
        assert float(tm["delta_nnz"]) == float(jm["delta_nnz"])
        for name in ("f_x", "f_w", "gamma"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=1e-5, atol=1e-6)
    assert len(sizes) > 1


def test_ef21p_participation_run_against_the_reference(probs):
    """The whole run with the reference's draws: equal cohort sizes and
    ledger; f_x finite and falling (see above)."""
    jp, tp = probs
    plan = JF.BernoulliStragglerPlan(drop_prob=0.4)
    want = JE.run(jp, JC.TopK(k=K), JS.Constant(0.05), T=30, seed=2, participation=plan)
    keys = ReferenceKeys(2)
    got = E.run(tp, C.TopK(k=K), stepsizes.Constant(0.05), T=30, seed=2,
                participation=injected_plan(F.BernoulliStragglerPlan(0.4), keys, True))
    assert got["participants"] == want["participants"]
    assert got["s2w_bits"] == want["s2w_bits"]
    assert np.isfinite(got["f_x"]).all() and got["f_x"][-1] < got["f_x"][0]
    assert set(got) == set(want)


@pytest.mark.parametrize("alg", ["marina_p", "ef21p"])
def test_polyak_finite_on_empty_and_singleton_cohorts(probs, alg):
    """An empty round gives gamma = 0 (the iterate holds still), a size-1
    round a finite non-negative step; the reference's values."""
    jp, tp = probs
    masks = ((False,) * N, (True,) + (False,) * (N - 1), (True,) * N)
    jplan, tplan = JF.CyclingMaskPlan(masks=masks), F.CyclingMaskPlan(masks=masks)
    if alg == "marina_p":
        kw = dict(mode="perm", k=K, p=P, T=6, seed=1)
        want = JM.run(jp, stepsize=JS.MarinaPPolyak(omega=N - 1.0, p=P), participation=jplan, **kw)
        h = M.run(tp, stepsize=stepsizes.MarinaPPolyak(omega=N - 1.0, p=P), participation=tplan, **kw)
    else:
        want = JE.run(jp, JC.TopK(k=K), JS.EF21PPolyak(alpha=K / D), T=6, participation=jplan)
        h = E.run(tp, C.TopK(k=K), stepsizes.EF21PPolyak(alpha=K / D), T=6, participation=tplan)
    assert np.isfinite(h["f_x"]).all() and np.isfinite(h["gamma"]).all()
    assert h["participants"][:3] == [0.0, 1.0, float(N)] == want["participants"][:3]
    assert h["gamma"][0] == 0.0 == want["gamma"][0]
    assert np.isclose(h["f_x"][0], float(tp.f(tp.x0)), rtol=1e-6)
    assert h["gamma"][1] >= 0.0 and np.isfinite(h["gamma"][1])


def test_full_plan_bit_identical_to_no_plan(probs):
    _, tp = probs
    kw = dict(mode="perm", k=K, p=P, stepsize=stepsizes.Constant(gamma=0.05), T=25, seed=1)
    h0 = M.run(tp, **kw)
    h1 = M.run(tp, participation=F.FullParticipation(), **kw)
    assert h0["f_x"] == h1["f_x"] and torch.equal(h0["final_state"].x, h1["final_state"].x)
    assert "participants" not in h1


def test_plan_leaves_the_downlink_draws_alone(probs):
    """The plan draws from a generator of its own: the p-coins (hence the
    ledger of a run whose rounds all sync or none) are those of the plain run."""
    _, tp = probs
    kw = dict(mode="ind", k=K, p=P, stepsize=stepsizes.Constant(gamma=0.05), T=20, seed=1)
    h0 = M.run(tp, **kw)
    h1 = M.run(tp, participation=F.BernoulliStragglerPlan(drop_prob=0.3), **kw)
    assert h0["s2w_bits"] == h1["s2w_bits"]
    assert min(h1["participants"]) >= 0 and max(h1["participants"]) <= N
    assert min(h1["participants"]) < N


# ---------------------------------------------------------------------------
# fleet_run against the reference
# ---------------------------------------------------------------------------


def _stats(h):
    return dataclasses.asdict(h["participation"])


@pytest.mark.parametrize("alg", ["marina_p", "ef21p"])
@pytest.mark.parametrize("mix", ["uniform", "flaky_mobile"])
def test_fleet_run_against_the_reference(monkeypatch, mix, alg):
    d, c = 32, 8
    js, ts = JF.make_fleet(mix, 512, seed=0), F.make_fleet(mix, 512, seed=0)
    jp, tp = JF.FleetL1Problem(js, d=d), F.FleetL1Problem(ts, d=d)
    jt, tt = jobs.MemoryTracker(), obs.MemoryTracker()
    kw = dict(algorithm=alg, T=30, seed=0, measure_wire=True)
    want = JF.fleet_run(jp, JF.make_sampler("uniform", js, c, seed=1), JS.Constant(0.05),
                        tracker=jt, **kw)
    keys = ReferenceKeys(0)
    monkeypatch.setattr(M, "draw_round", lambda b, p, d_, g, dev: keys.marina_draws("perm", c, d // c, d, p))
    got = F.fleet_run(tp, F.make_sampler("uniform", ts, c, seed=1), stepsizes.Constant(0.05),
                      tracker=tt, device="cpu", **kw)
    assert _stats(got) == _stats(want)
    for name in ("s2w_bits", "w2s_bits", "wire_bits", "participants", "fresh", "delivered"):
        assert got[name] == want[name], name
    for name in ("s2w_bits_total", "join_bits_total", "wire_bits_total",
                 "bits_per_participant_round"):
        assert got[name] == want[name], name
    if alg == "marina_p":
        np.testing.assert_allclose(got["f_x"], want["f_x"], rtol=TRAJ_RTOL)
    else:  # the cohort's sign patterns tie |delta| exactly (ROADMAP Queue 3)
        assert np.isfinite(got["f_x"]).all() and got["f_x"][-1] < got["f_x"][0]
    assert set(got) == set(want)
    # the same span tree (names, nesting, delivered/fresh attrs) but gamma
    strip = lambda r: (r.name, tuple(sorted((k, repr(v)) for k, v in r.attrs.items()  # noqa: E731
                                            if k != "gamma")), tuple(strip(x) for x in r.children))
    assert [strip(r) for r in analyze.build_tree(tt.events)] == \
        [strip(r) for r in analyze.build_tree(jt.events)]


def test_fleet_run_spans_attribute_dropped_slots():
    spec = F.make_fleet("flaky_mobile", 512, seed=0)
    prob = F.FleetL1Problem(spec, d=32)
    tr = obs.MemoryTracker()
    F.fleet_run(prob, F.make_sampler("uniform", spec, 8, seed=1), stepsizes.Constant(gamma=0.05),
                algorithm="marina_p", mode="perm", T=8, seed=0, tracker=tr, device="cpu")
    assert analyze.validate_spans(tr.events) == []
    roots = analyze.build_tree(tr.events)
    reports = analyze.round_reports(roots)
    assert len(reports) == 8
    degraded = [r for r in reports if r.degraded]
    assert degraded and all(r.culprit.startswith("link/client") for r in degraded)
    links = [s for r in roots for s in r.walk() if s.name.startswith("link/client")]
    assert links and all("delivered" in s.attrs and "fresh" in s.attrs for s in links)


# ---------------------------------------------------------------------------
# cases of tests/test_fleet.py on the port
# ---------------------------------------------------------------------------


def test_population_attributes_deterministic_and_stateless():
    spec = F.make_fleet("two_tier", 1_000_000, seed=11)
    ids = np.asarray([0, 17, 999_999, 123_456])
    one_by_one = np.concatenate([spec.data_size(np.asarray([i])) for i in ids])
    assert np.allclose(spec.data_size(ids), one_by_one)
    other = F.make_fleet("two_tier", 1_000_000, seed=12)
    assert not (spec.tier_index(np.arange(200)) == other.tier_index(np.arange(200))).all()
    assert abs(F.make_fleet("two_tier", 4096, seed=0).tier_index(np.arange(4096)).mean() - 0.3) < 0.05


def test_availability_trace_duty_cycle():
    spec = F.make_fleet("two_tier_diurnal", 2048, seed=0)
    ids = np.arange(2048)
    assert abs(np.mean([spec.available(ids, t).mean() for t in range(24)]) - 0.5) < 0.05
    avail_t = np.stack([spec.available(ids[:32], t) for t in range(24)])
    assert (avail_t.sum(axis=0) == spec.availability.open_ticks).all()


def test_fault_spec_plugs_into_transport():
    spec = F.make_fleet("flaky_mobile", 10_000, seed=2)
    fs = spec.fault_spec_for(1234, round_salt=5)
    assert isinstance(fs, FaultSpec) and fs.any_faults
    assert fs == spec.fault_spec_for(1234, round_salt=5)
    assert fs != spec.fault_spec_for(1234, round_salt=6)
    assert isinstance(FaultInjector(fs).plan(b"\x00" * 16), list)
    assert not F.make_fleet("uniform", 100, seed=0).fault_spec_for(7).any_faults


def test_fleet_problem_analytic_eigs_match_numpy():
    prob = F.FleetL1Problem(F.make_fleet("two_tier", 50_000, seed=4), d=12)
    ids = np.asarray([3, 999, 42_000])
    L_numpy = np.asarray([np.abs(np.linalg.eigvalsh(a)).max() for a in prob.materialize(ids)])
    assert np.allclose(prob.client_L0(ids), L_numpy, rtol=1e-10)
    assert prob.f_star == 0.0 and prob.R0_sq > 0


def test_samplers_deterministic_and_distinct_per_round():
    spec = F.make_fleet("uniform", 100_000, seed=0)
    for kind in SAMPLERS:
        s = F.make_sampler(kind, spec, 16, seed=9)
        a, b, c = s.cohort(3), s.cohort(3), s.cohort(4)
        assert (a.ids == b.ids).all() and (a.active == b.active).all(), kind
        assert not (a.ids == c.ids).all(), kind
        if a.n_active:
            assert np.isclose(a.weights.sum(), 1.0) and (a.weights[a.active] > 0).all()
        assert (a.weights[~a.active] == 0).all()


def test_samplers_respect_their_policies():
    spec = F.make_fleet("two_tier", 20_000, seed=1)
    s = F.make_sampler("weighted", spec, 64, seed=0)
    picked = np.concatenate([s.cohort(t).ids[s.cohort(t).active] for t in range(20)])
    assert (spec.tier_index(picked) == 1).mean() > 0.45
    spec = F.make_fleet("two_tier_diurnal", 8192, seed=3)
    s = F.make_sampler("availability", spec, 32, seed=0)
    for t in (0, 7, 13):
        co = s.cohort(t)
        assert spec.available(co.ids[co.active], t).all()
    co = F.make_sampler("deadline:1.0", spec, 64, seed=0).cohort(0)
    assert 0 < co.n_active < 64
    assert (spec.latency(co.ids, 0)[co.active] <= 1.0).all()


def test_cohort_memory_bounded_by_cohort_not_population():
    """A 100k-client population never materializes population-sized state:
    three 64-client rounds stay under 32 MB of host allocations."""
    spec = F.make_fleet("two_tier_diurnal", 100_000, seed=0)
    prob = F.FleetL1Problem(spec, d=16)
    sampler = F.make_sampler("uniform", spec, 64, seed=0)
    F.fleet_run(prob, sampler, stepsizes.Constant(gamma=0.05), T=1, seed=0, device="cpu")
    tracemalloc.start()
    F.fleet_run(prob, sampler, stepsizes.Constant(gamma=0.05), T=3, seed=0, device="cpu")
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert peak < 32 * 1024 * 1024, f"peak host alloc {peak/1e6:.1f} MB"


def test_fleet_run_marina_converges_and_is_deterministic():
    spec = F.make_fleet("two_tier", 4096, seed=0)
    prob = F.FleetL1Problem(spec, d=32)
    sampler = F.make_sampler("uniform", spec, 8, seed=1)
    kw = dict(algorithm="marina_p", mode="perm", T=60, seed=0, device="cpu")
    h1 = F.fleet_run(prob, sampler, stepsizes.Constant(gamma=0.05), **kw)
    h2 = F.fleet_run(prob, sampler, stepsizes.Constant(gamma=0.05), **kw)
    assert h1["f_x"] == h2["f_x"] and h1["f_x"][-1] < 0.5 * h1["f_x"][0]
    assert h1["s2w_bits_total"] > 0 and h1["w2s_bits_total"] > 0
    assert h1["participation"].unique_clients <= 60 * 8


def test_fleet_run_ef21p_converges_with_polyak():
    spec = F.make_fleet("uniform", 2048, seed=0)
    prob = F.FleetL1Problem(spec, d=32)
    h = F.fleet_run(prob, F.make_sampler("uniform", spec, 8, seed=1),
                    stepsizes.EF21PPolyak(alpha=4 / 32), algorithm="ef21p", k=4, T=80, seed=0,
                    device="cpu")
    assert np.isfinite(h["f_x"]).all() and h["f_x"][-1] < 0.7 * h["f_x"][0]


def test_fleet_run_rounds_to_target_ceiling():
    spec = F.make_fleet("uniform", 512, seed=0)
    prob = F.FleetL1Problem(spec, d=16)
    h = F.fleet_run(prob, F.make_sampler("uniform", spec, 4, seed=0),
                    stepsizes.Constant(gamma=1e-9), T=5, target=1e-12, device="cpu")
    assert h["rounds_to_target"] == 5


def test_fleet_run_faults_degrade_but_stay_finite_and_measure_wire():
    spec = F.make_fleet("flaky_mobile", 4096, seed=7)
    prob = F.FleetL1Problem(spec, d=64)
    h = F.fleet_run(prob, F.make_sampler("uniform", spec, 8, seed=2), stepsizes.Constant(gamma=0.05),
                    algorithm="marina_p", T=40, seed=0, measure_wire=True, device="cpu")
    stats = h["participation"]
    assert stats.goodput < 1.0 and stats.fresh_frac > 0
    assert np.isfinite(h["f_x"]).all() and h["f_x"][-1] < h["f_x"][0]
    assert 0 < h["wire_bits_total"] < h["s2w_bits_total"]


def test_fleet_run_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    spec = F.make_fleet("uniform", 64, seed=0)
    with pytest.raises(RuntimeError, match="cuda"):
        F.fleet_run(F.FleetL1Problem(spec, d=8), F.make_sampler("uniform", spec, 4),
                    stepsizes.Constant(0.05), T=1)


# ---------------------------------------------------------------------------
# entry points: scenario_matrix, transport_bench, federated_l1
# ---------------------------------------------------------------------------

TINY = dict(population=256, cohort=8, d=24, T=40, seed=0)


def test_run_cell_against_the_reference(monkeypatch):
    """One DEFAULT_CELLS entry: the reference's metrics, bit for bit but
    f (1e-4) and rounds_to_target (one round)."""
    cell = scenario_matrix.DEFAULT_CELLS[1]
    assert cell == jscenario.DEFAULT_CELLS[1] == ("marina_p", "constant", "two_tier_diurnal")
    want = jscenario.run_cell(*cell, **TINY)
    keys = ReferenceKeys(0)
    monkeypatch.setattr(M, "draw_round", lambda b, p, d, g, dev: keys.marina_draws("perm", 8, 3, 24, p))
    got = scenario_matrix.run_cell(*cell, device="cpu", **TINY)
    assert got.keys() == want.keys()
    for name in got:
        if name in ("final_f", "f0", "target"):
            np.testing.assert_allclose(got[name], want[name], rtol=TRAJ_RTOL)
        elif name == "rounds_to_target":
            assert abs(got[name] - want[name]) <= 1
        else:
            assert got[name] == want[name], name


def test_scenario_bench_cells_emit_valid_artifacts(tmp_path):
    cells = [("marina_p", "constant", "uniform"), ("ef21p", "polyak", "two_tier_diurnal")]
    rows = scenario_matrix.bench(out_dir=str(tmp_path), cells=cells, device="cpu", **TINY)
    names = [r[0] for r in rows]
    assert "scenario/marina_p-constant-uniform/rounds_to_target" in names
    assert "scenario/ef21p-polyak-two_tier_diurnal/s2w_bits" in names
    from repro.obs import bench_json as jbench_json

    for alg, scheme, mix in cells:
        doc = obs.load(str(tmp_path / f"BENCH_scenario_{scenario_matrix.cell_id(alg, scheme, mix)}.json"))
        assert obs.validate(doc) == [] == jbench_json.validate(doc)
        m = doc["metrics"]
        assert np.isfinite(m["rounds_to_target"]["value"])
        assert m["downlink_bits_analytic"]["value"] > 0 and m["downlink_bits_measured"]["value"] > 0
        assert 0 < m["goodput"]["value"] <= 1.0
        assert m["participants_mean"]["value"] <= TINY["cohort"]
    assert scenario_matrix.FULL_CELLS == jscenario.FULL_CELLS
    assert scenario_matrix.MIX_SAMPLER == jscenario.MIX_SAMPLER


def test_transport_bench_on_cpu():
    """The reference's row and metric names; counters from a seeded run."""
    assert [r[0] for r in transport_bench.framing_rows()] == [
        "transport/frame_encode", "transport/frame_decode", "transport/crc32c"]
    m = transport_bench.chaos_metrics(T=40, device="cpu")
    assert list(m) == ["transport/goodput", "transport/rounds_ratio", "transport/retries",
                       "transport/resyncs", "transport/forced_syncs",
                       "transport/recovery_ticks_mean", "transport/chaos_run_s"]
    assert 0 < m["transport/goodput"] <= 1 and m["transport/retries"] > 0
    assert m == {**transport_bench.chaos_metrics(T=40, device="cpu"),
                 "transport/chaos_run_s": m["transport/chaos_run_s"]}


def test_federated_l1_fleet_demo_on_cpu(tmp_path, capsys):
    out = tmp_path / "fleet.csv"
    hists = federated_l1.fleet_demo(str(out), population=512, cohort=8, d=16, T=6, device="cpu")
    assert set(hists) == {"marina_p_perm_const", "marina_p_perm_polyak", "ef21p_topk_polyak"}
    assert len(out.read_text().splitlines()) == 4
    assert "wrote" in capsys.readouterr().out
    out2 = tmp_path / "main.csv"
    assert federated_l1.main(["--fleet", "--device", "cpu", "--population", "512", "--cohort", "8",
                              "-T", "3", "--out", str(out2)]) == 0
    assert out2.read_text().splitlines()[0].startswith("method,final_f")
