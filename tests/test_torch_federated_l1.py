"""The paper's Figure 1/7 grid on the port (``python -m
repro_torch.federated_l1``) against the reference's
``examples/federated_l1.py``.

* With ``run_suite`` stubbed alike in both, the default and ``--paper``
  modes call the same cells in the same order and write byte-identical
  CSVs (the reference's ``main`` reads ``sys.argv``).
* One reduced cell through the real ``run_suite`` of both packages, the
  reference's draws injected into the port's MARINA-P runs (its key
  sequence restarts at each ``marina_p.run``, as the reference's does):
  every row has the reference's rounds and bits, and the constant-stepsize
  MARINA-P rows a final f within TRAJ_RTOL. EF21-P's f is the TopK tie
  lottery (ROADMAP Queue 3), and a Polyak MARINA-P trajectory follows the
  last bits of gamma just as well over a few hundred rounds (shown on the
  port alone below), so those runs are held per step from the reference's
  states of the same cell, every round up to the budget.
"""
import csv
import importlib.util
import pathlib
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from benchmarks import fig1_convergence as jfig1  # noqa: E402
from repro.core import compressors as JC  # noqa: E402
from repro.core import ef21p as JE  # noqa: E402
from repro.core import marina_p as JM  # noqa: E402
from repro.core import problems as JP  # noqa: E402
from repro.core import stepsizes as JS  # noqa: E402
from repro_torch import convert, federated_l1  # noqa: E402
from repro_torch.core import compressors as C  # noqa: E402
from repro_torch.core import comm_model, ef21p, marina_p, problems, stepsizes  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
METHODS = ("ef21p_topk_const", "marina_same_const", "marina_ind_const", "marina_perm_const",
           "ef21p_topk_polyak", "marina_same_polyak", "marina_ind_polyak", "marina_perm_polyak")
# a few hundred rounds of MARINA-P: summation orders compound through the
# Polyak stepsize and the shifts (tests/test_torch_algorithms.py's bound)
TRAJ_RTOL = 1e-4
STEP_RTOL, STEP_ATOL = 1e-5, 1e-6  # one step from identical states
CELL = (200, 10, 1.0, 2e5)  # the reduced grid's s = 1 cell at a twentieth of its budget


@pytest.fixture
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def reference_module():
    spec = importlib.util.spec_from_file_location("reference_federated_l1",
                                                  ROOT / "examples" / "federated_l1.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def stub_suite(calls):
    """A run_suite that records its cell and returns rows made from it."""
    def run_suite(*, d, n, noise, budget_bits, **_):
        calls.append((d, n, noise, budget_bits))
        return {name: {"final_subopt": d / 7 + n / 3 + noise / 11 + i / 13, "rounds": d + n + i,
                       "bits_per_worker": budget_bits + 1234.5 * i}
                for i, name in enumerate(METHODS)}
    return run_suite


@pytest.mark.parametrize("mode", [[], ["--paper"]], ids=["reduced", "paper"])
def test_cells_and_csv_equal_the_reference(tmp_path, monkeypatch, mode):
    ref, ref_calls, calls, devices = reference_module(), [], [], []
    monkeypatch.setattr(ref, "run_suite", stub_suite(ref_calls))
    monkeypatch.setattr(sys, "argv", ["federated_l1.py", *mode, "--out", str(tmp_path / "ref.csv")])
    ref.main()
    port = stub_suite(calls)
    monkeypatch.setattr(federated_l1, "run_suite",
                        lambda device, **kw: devices.append(device) or port(**kw))
    assert federated_l1.main([*mode, "--out", str(tmp_path / "port.csv"), "--device", "cpu"]) == 0
    assert calls == ref_calls == (federated_l1.PAPER_CELLS if mode else federated_l1.REDUCED_CELLS)
    assert len(calls) == (6 if mode else 3) and set(devices) == {"cpu"}
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "ref.csv").read_bytes()
    assert (tmp_path / "port.csv").read_text().splitlines()[0] == ",".join(federated_l1.CSV_HEADER)


def reference_draws(mode, n, d):
    """The reference round's draws from its round key ``sub``
    (``k_bern, k_comp = split(sub)``: the coin from k_bern, the mode's index
    sets from k_comp) as the port's MarinaPDraws."""
    k = max(1, d // n)
    bcast = JM.make_broadcast(mode, n, k)[0]

    @jax.jit
    def draw(sub):
        k_bern, k_comp = jax.random.split(sub)
        coin = jax.random.bernoulli(k_bern, k / d)
        if mode == "perm":
            return coin, jax.random.permutation(k_comp, d)
        return coin, bcast(k_comp, jnp.ones(d)) != 0

    def draws(sub):
        coin, drawn = draw(sub)
        drawn = np.asarray(drawn)
        if mode == "same":
            idx = np.flatnonzero(drawn[0])
        elif mode == "ind":
            idx = np.stack([np.flatnonzero(m) for m in drawn])
        else:
            idx = drawn
        return marina_p.MarinaPDraws(coin=bool(coin), idx=torch.from_numpy(idx.astype(np.int64)))
    return draws


def inject_reference_draws(monkeypatch, n, d):
    """Each port ``marina_p.run`` draws what the reference's run of the same
    mode and seed draws: key = PRNGKey(seed), then ``key, sub = split(key)``
    a round."""
    draws = {mode: reference_draws(mode, n, d) for mode in ("same", "ind", "perm")}
    state = {}

    def draw_round(bcast, p, d_, generator, device):
        state["key"], sub = jax.random.split(state["key"])
        return draws[state["mode"]](sub)

    run = marina_p.run

    def run_from_seed(*args, mode, seed=0, **kwargs):
        state.update(key=jax.random.PRNGKey(seed), mode=mode)
        return run(*args, mode=mode, seed=seed, **kwargs)

    monkeypatch.setattr(marina_p, "draw_round", draw_round)
    monkeypatch.setattr(marina_p, "run", run_from_seed)


def test_reduced_cell_matches_the_reference_with_its_draws(tmp_path, monkeypatch, one_thread):
    """Every row: the reference's rounds and bits, each run stopped at the
    first round at or past the budget; the constant-stepsize MARINA-P rows'
    final f within TRAJ_RTOL. The Polyak rows' f is held per step below: a
    Polyak trajectory follows the last bits of gamma
    (test_marina_p_polyak_trajectory_follows_last_bit_of_gamma)."""
    d, n, s, budget = CELL
    want = jfig1.run_suite(d=d, n=n, noise=s, budget_bits=budget)
    inject_reference_draws(monkeypatch, n, d)
    got = federated_l1.run_cells([CELL], str(tmp_path / "cell.csv"), device="cpu")[CELL]
    with open(tmp_path / "cell.csv") as f:
        rows = {r["method"]: r for r in csv.DictReader(f)}
    assert list(rows) == list(want) == list(METHODS)
    for name, w in want.items():
        r = rows[name]
        assert (r["d"], r["n"], r["noise"]) == (str(d), str(n), str(s))
        assert int(r["rounds"]) == w["rounds"] == got[name]["rounds"], name
        assert float(r["bits_per_worker"]) == w["bits_per_worker"], name
        bits = got[name]["hist"]["s2w_bits"]
        assert bits[-1] >= budget > bits[-2], name
        if name.startswith("marina") and name.endswith("const"):
            assert float(r["final_subopt"]) == pytest.approx(float(w["final_subopt"]), rel=TRAJ_RTOL), name


@pytest.fixture(scope="module")
def cell_problems():
    d, n, s, _ = CELL
    jp = JP.generate_problem(n=n, d=d, noise_scale=s, seed=0)
    tp = convert.problem_from_numpy(np.asarray(jp.A), np.asarray(jp.x0), np.asarray(jp.L0i), jp.sigma_A,
                                    device="cpu")
    return jp, tp


def close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=STEP_RTOL, atol=STEP_ATOL)


@pytest.mark.parametrize("run", ["ef21p_topk_const", "ef21p_topk_polyak", "marina_same_polyak",
                                 "marina_ind_polyak", "marina_perm_polyak"])
def test_reduced_cell_steps_from_reference_states(cell_problems, one_thread, run):
    """The cell's runs whose f is not compared free-running, every round up
    to the budget, each port step taken from the reference's state of that
    round with its draws: f_x, f_w, gamma, x and the shifts within STEP_RTOL,
    the same message size."""
    jp, tp = cell_problems
    d, n, _, budget = CELL
    k, p = d // n, (d // n) / d
    ledger = comm_model.CommLedger(model=comm_model.CommModel(d=d))
    if run.startswith("ef21p"):
        if run.endswith("const"):  # run_suite's optimal constant at its default T
            g = stepsizes.ef21p_optimal_constant(tp.R0_sq, tp.L0, k / d, 600)
            js, ts = JS.Constant(g), stepsizes.Constant(g)
        else:
            js, ts = JS.EF21PPolyak(alpha=k / d, f_star=0.0), stepsizes.EF21PPolyak(alpha=k / d, f_star=0.0)
        jstep = jax.jit(JE.make_step(jp, JC.TopK(k=k), js))
        tstep = ef21p.make_step(tp, C.TopK(k=k), ts)
        jstate = JE.init(jp.x0)
        while ledger.s2w_bits < budget:
            tstate = convert.ef21p_state_from_numpy(jstate.x, jstate.w, ledger.rounds, "cpu")
            jstate, jm = jstep(jstate, jax.random.PRNGKey(ledger.rounds))
            tnew, tm = tstep(tstate, None)
            for name in ("f_x", "f_w", "gamma"):
                close(float(tm[name]), float(jm[name]))
            close(tnew.x.numpy(), jstate.x)
            assert float(tm["delta_nnz"]) == float(jm["delta_nnz"])
            ledger.log_s2w_sparse(float(jm["delta_nnz"]))
            ledger.tick()
        return
    mode = run.split("_")[1]
    omega = float(n - 1) if mode == "perm" else d / k - 1.0
    js = JS.MarinaPPolyak(omega=omega, p=p, f_star=0.0)
    ts = stepsizes.MarinaPPolyak(omega=omega, p=p, f_star=0.0)
    jstep = jax.jit(JM.make_step(jp, mode, k, p, js))
    tstep = marina_p.make_step(tp, mode, k, p, ts)
    draws = reference_draws(mode, n, d)
    jstate, key = JM.init(jp.x0, n), jax.random.PRNGKey(0)
    while ledger.s2w_bits < budget:
        key, sub = jax.random.split(key)
        tstate = convert.marina_p_state_from_numpy(jstate.x, jstate.W, ledger.rounds, "cpu")
        jstate, jm = jstep(jstate, sub)
        tnew, tm = tstep(tstate, draws(sub))
        for name in ("f_x", "f_w", "gamma", "q_nnz_mean"):
            close(float(tm[name]), float(jm[name]))
        close(tnew.x.numpy(), jstate.x)
        close(tnew.W.numpy(), jstate.W)
        if float(jm["full_sync"]):
            ledger.log_s2w_dense()
        else:
            ledger.log_s2w_sparse(float(jm["q_nnz_mean"]))
        ledger.tick()


def test_marina_p_polyak_trajectory_follows_last_bit_of_gamma(one_thread):
    """Why the card's Polyak runs are not held to the CPU's round by round
    over a whole budget (chip_smoke.py (v1)): on the reduced grid's s = 1
    cell, in the first 700 of its 1,626 rounds, the port's own MARINA-P/ind
    run with gamma one ulp larger departs from it by more than TRAJ_RTOL in
    f_x, while the constant-stepsize run one ulp apart stays within 1e-5."""
    d, n, s = 200, 10, 1.0
    k, p = d // n, (d // n) / d
    prob = problems.generate_problem(n=n, d=d, noise_scale=s, seed=0, device="cpu")

    class OneUlpMore(stepsizes.MarinaPPolyak):
        def __call__(self, t, aux=None):
            return super().__call__(t, aux) * (1 + 2.0**-23)

    def gap(ss_a, ss_b):
        a, b = (marina_p.run(prob, mode="ind", k=k, p=p, stepsize=ss, T=700, seed=0)["f_x"]
                for ss in (ss_a, ss_b))
        return np.max(np.abs(np.subtract(a, b)) / np.abs(a))

    omega = d / k - 1.0
    g = stepsizes.marina_p_optimal_constant(prob.R0_sq, prob.L0, prob.L0_tilde, omega, p, 600)
    assert gap(stepsizes.Constant(g), stepsizes.Constant(g * (1 + 2.0**-23))) < 1e-5
    assert gap(stepsizes.MarinaPPolyak(omega=omega, p=p, f_star=0.0),
               OneUlpMore(omega=omega, p=p, f_star=0.0)) > TRAJ_RTOL
