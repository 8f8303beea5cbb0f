"""The paper's Corollaries 1-2 on the port (repro_torch.comm_complexity)
against the reference's benchmark (Table 2: tests/test_torch_table2.py).

* The theory values are the reference's formulas on the
  problem's L0, L0_tilde, R0^2 (bit-equal) and eps = 5% of f(x^0), which the
  port sums in another order (within one f32 ulp). MARINA-P/ind's rounds to
  eps are equal to the reference's when the port's run is fed the
  reference's draws (``marina_p.draw_round`` patched, the reference's key
  sequence: ``key, sub = split(key)`` a round). EF21-P's rounds are the TopK
  tie lottery (ROADMAP Queue 3: exact ties of |x - w| broken by the last bit
  of the worker sum), held within 5% of the reference's.

The Polyak factor grid (``scenario_matrix.tune`` / ``polyak_factor_grid``,
the ``stepsize_grid`` suite) picks the reference's best factor, and its
final f(x) is within TUNE_RTOL of the reference's: MARINA-P with the
reference's draws injected, EF21-P on a dense Gaussian problem, whose TopK
selections have no exact ties (Algorithm 3's tridiagonal problem has many).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from benchmarks import comm_complexity as jcc  # noqa: E402
from benchmarks import scenario_matrix as jscenario  # noqa: E402
from repro.core import comm_model as JCM  # noqa: E402
from repro.core import compressors as JC  # noqa: E402
from repro.core import ef21p as JE  # noqa: E402
from repro.core import marina_p as JM  # noqa: E402
from repro.core import problems as JP  # noqa: E402
from repro.core import stepsizes as JS  # noqa: E402
from repro_torch import comm_complexity, scenario_matrix  # noqa: E402
from repro_torch.core import comm_model, marina_p, problems  # noqa: E402

EF21P_ROUNDS_RTOL = 0.05
# f32 summation order, amplified by 30 Polyak steps: measured 1.8e-5 for
# EF21-P, < 1e-6 for MARINA-P; one factor step (4x) moves f(x) by far more
TUNE_RTOL = 1e-4


@pytest.fixture
def one_thread():
    """Small CPU ops on one thread: far faster under a parallel test run."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def setting():
    prob, eps = comm_complexity.setting("cpu")
    jprob = JP.generate_problem(n=8, d=128, noise_scale=1.0, seed=0)
    return prob, eps, jprob, 0.05 * float(jprob.f(jprob.x0))


def test_corollary_theory_values(setting):
    prob, eps, jprob, jeps = setting
    assert (prob.L0, prob.L0_tilde, prob.R0_sq) == (jprob.L0, jprob.L0_tilde, jprob.R0_sq)
    assert abs(eps - jeps) <= np.spacing(np.float32(jeps / 0.05)) * 0.05  # one f32 ulp of f(x0)
    for k in comm_complexity.KS:
        alpha, omega = k / 128, 128 / k - 1.0
        assert comm_model.ef21p_iteration_complexity(prob.L0, prob.R0_sq, alpha, jeps) == \
            JCM.ef21p_iteration_complexity(jprob.L0, jprob.R0_sq, alpha, jeps)
        assert comm_model.marina_p_iteration_complexity(prob.L0, prob.L0_tilde, prob.R0_sq, omega, 128,
                                                        float(k), jeps) == \
            JCM.marina_p_iteration_complexity(jprob.L0, jprob.L0_tilde, jprob.R0_sq, omega, 128,
                                              float(k), jeps)
    assert comm_complexity.rounds_to_eps({"t": [0, 1, 2], "f_x": [3.0, 2.0, 1.0]}, 2.0) == 2
    assert comm_complexity.rounds_to_eps({"t": [0], "f_x": [3.0]}, 2.0) is None
    assert jcc.rounds_to_eps({"t": [0, 1, 2], "f_x": [3.0, 2.0, 1.0]}, 2.0) == 2


def _inject_reference_draws(monkeypatch, k, n, d, mode="ind"):
    """The reference run's draws for each round (PRNGKey(seed), then
    ``key, sub = split(key)``; in a round ``k_bern, k_comp = split(sub)``,
    the coin from k_bern, the mode's draws from k_comp: one RandK index set
    (same), RandK index sets of k_comp's split over n workers (ind), the
    permutation (perm)). Each ``marina_p.run`` starts again from its seed."""
    bcast = JM.make_broadcast(mode, n, k)[0]

    @jax.jit
    def draw(sub):
        k_bern, k_comp = jax.random.split(sub)
        coin = jax.random.bernoulli(k_bern, k / d)
        if mode == "perm":
            return coin, jax.random.permutation(k_comp, d)
        return coin, bcast(k_comp, jnp.ones(d)) != 0

    key = None

    def draw_round(_bcast, p, d_, generator, device):
        nonlocal key
        key, sub = jax.random.split(key)
        coin, drawn = draw(sub)
        drawn = np.asarray(drawn)
        if mode == "same":
            idx = np.flatnonzero(drawn[0])
        elif mode == "ind":
            idx = np.stack([np.flatnonzero(m) for m in drawn])
        else:
            idx = drawn
        return marina_p.MarinaPDraws(coin=bool(coin), idx=torch.from_numpy(idx.astype(np.int64)))

    run = marina_p.run

    def run_from_seed(*args, seed=0, **kwargs):
        nonlocal key
        key = jax.random.PRNGKey(seed)
        return run(*args, seed=seed, **kwargs)

    monkeypatch.setattr(marina_p, "draw_round", draw_round)
    monkeypatch.setattr(marina_p, "run", run_from_seed)


@pytest.mark.parametrize("k,T", [(4, 520), (16, 160), (64, 80)])
def test_corollary2_marina_ind_rounds_equal_with_reference_draws(setting, monkeypatch, one_thread, k, T):
    """The reference's bench runs T = 4000; Polyak's stepsize does not depend
    on T, so a shorter run past the round of eps has the same prefix."""
    prob, eps, jprob, jeps = setting
    p, omega = k / 128, 128 / k - 1.0
    h = JM.run(jprob, mode="ind", k=k, p=p, stepsize=JS.MarinaPPolyak(omega=omega, p=p, f_star=0.0), T=T)
    want = jcc.rounds_to_eps(h, jeps)
    assert want is not None and want < T
    _inject_reference_draws(monkeypatch, k, 8, 128)
    got, theory = comm_complexity.marina_ind_rounds(prob, k, eps, T=T)
    assert got == want
    assert theory == pytest.approx(JCM.marina_p_iteration_complexity(
        jprob.L0, jprob.L0_tilde, jprob.R0_sq, omega, 128, float(k), jeps), rel=1e-6)


@pytest.mark.parametrize("k,T", [(4, 1700), (16, 440), (64, 120)])
def test_corollary1_ef21p_rounds_within_tolerance(setting, one_thread, k, T):
    prob, eps, jprob, jeps = setting
    alpha = k / 128
    h = JE.run(jprob, JC.TopK(k=k), JS.EF21PPolyak(alpha=alpha, f_star=0.0), T=T)
    want = jcc.rounds_to_eps(h, jeps)
    got, _ = comm_complexity.ef21p_rounds(prob, k, eps, T=T)
    assert want is not None and got > 0
    assert abs(got - want) <= EF21P_ROUNDS_RTOL * want, (got, want)


def test_comm_complexity_bench_rows():
    """The reference's row names, in its order, from the port's bench (runs
    cut to 3 rounds: eps is then out of reach and the rows read -1)."""
    rows = comm_complexity.bench(T=3, device="cpu")
    names = [f"{pre}/k{k}/{what}" for pre in ("corollary1/ef21p", "corollary2/marina_ind")
             for k in (4, 16, 64) for what in ("rounds", "theory_ratio")]
    assert [r[0] for r in rows] == names
    assert all(r[2] == -1 for r in rows)


def _dense_problems(n, d, seed=5):
    """One Gaussian problem (A [n, d, d], x0) as the port's and the
    reference's L1Problem: the worker subgradients have no exact ties."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, d, d)).astype(np.float32)
    x0 = rng.standard_normal(d).astype(np.float32)
    L0i = np.array([np.linalg.norm(a, 2) for a in A.astype(np.float64)], np.float32)
    return (problems.L1Problem(A=torch.from_numpy(A), x0=torch.from_numpy(x0),
                               L0i=torch.from_numpy(L0i), sigma_A=0.0),
            JP.L1Problem(A=jnp.asarray(A), x0=jnp.asarray(x0), L0i=jnp.asarray(L0i), sigma_A=0.0))


@pytest.mark.parametrize("method", ["ef21p", "same", "ind", "perm"])
def test_polyak_factor_grid_matches_reference(monkeypatch, one_thread, method):
    """The default grid of 7 factors, 30 rounds each: the same best factor,
    final f(x) within TUNE_RTOL (a tune that kept another factor, or a wrong
    omega, p or k for a mode, moves it by far more)."""
    n, d, T = 3, 16, 30  # k = 5: perm's omega n - 1 differs from d / k - 1, and it leaves 1 coordinate
    if method == "ef21p":
        prob, jprob = _dense_problems(n, d)
    else:
        prob = problems.generate_problem(n=n, d=d, noise_scale=1.0, seed=0, device="cpu")
        jprob = JP.generate_problem(n=n, d=d, noise_scale=1.0, seed=0)
    want = jscenario.polyak_factor_grid(prob=jprob, T=T, methods=(method,))
    if method != "ef21p":
        _inject_reference_draws(monkeypatch, d // n, n, d, mode=method)
    got = scenario_matrix.polyak_factor_grid(prob=prob, T=T, methods=(method,), device="cpu")
    (bf, _, got_f), (fs, _, got_final) = got
    (jbf, _, want_f), (jfs, _, want_final) = want
    assert (bf, fs) == (jbf, jfs)
    assert got_f == want_f
    assert got_final == pytest.approx(want_final, rel=TUNE_RTOL)
