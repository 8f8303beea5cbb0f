"""MARINA-P, EF21-P and SM of the port against the JAX reference.

The reference's problem and states are carried over with repro_torch.convert;
where the reference draws with jax.random, its own draws are injected into
the port's step (the p-coin from jax.random.bernoulli, the RandK/PermK
index sets from the reference's make_broadcast on ones(d)).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import compressors as JC  # noqa: E402
from repro.core import ef21p as JE  # noqa: E402
from repro.core import marina_p as JM  # noqa: E402
from repro.core import problems as JP  # noqa: E402
from repro.core import stepsizes as JS  # noqa: E402
from repro.core import subgradient as JSM  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import compressors as C  # noqa: E402
from repro_torch.core import ef21p as E  # noqa: E402
from repro_torch.core import marina_p as M  # noqa: E402
from repro_torch.core import stepsizes as S  # noqa: E402
from repro_torch.core import subgradient as SM  # noqa: E402

N, D = 8, 64
K = D // N
P = K / D
MODES = ("same", "ind", "perm")

# One step from identical states: the only differences are fp32 summation
# orders (subgradient, f, means), so 1e-5 relative.
STEP_RTOL, STEP_ATOL = 1e-5, 1e-6
# 30 rounds: differences compound through gamma and the shifts; a coordinate
# of A_i w that comes near 0 may also flip sign under another reduction
# order, so trajectories are compared on f_x at 1e-4 relative.
TRAJ_RTOL = 1e-4


@pytest.fixture(scope="module")
def probs():
    jp = JP.generate_problem(n=N, d=D, noise_scale=1.0, seed=0)
    tp = convert.problem_from_numpy(np.asarray(jp.A), np.asarray(jp.x0), np.asarray(jp.L0i),
                                    jp.sigma_A, device="cpu")
    return jp, tp


def stepsize_pair(kind, mode, tp):
    omega = float(N - 1) if mode == "perm" else D / K - 1.0
    if kind == "const":
        g = S.marina_p_optimal_constant(tp.R0_sq, tp.L0, tp.L0_tilde, omega, P, 30)
        return JS.Constant(g), S.Constant(g)
    return JS.MarinaPPolyak(omega=omega, p=P), S.MarinaPPolyak(omega=omega, p=P)


def reference_draws(mode, key, p=P):
    """The reference step's draws for round key ``key`` as MarinaPDraws."""
    k_bern, k_comp = jax.random.split(key)
    coin = bool(jax.random.bernoulli(k_bern, p))
    masks = np.asarray(JM.make_broadcast(mode, N, K)[0](k_comp, jnp.ones(D))) != 0
    if mode == "same":
        idx = np.flatnonzero(masks[0])
    elif mode == "ind":
        idx = np.stack([np.flatnonzero(m) for m in masks])
    else:  # d % n == 0: worker i's set is block i of a permutation
        idx = np.concatenate([np.flatnonzero(m) for m in masks])
    return M.MarinaPDraws(coin=coin, idx=torch.from_numpy(idx.astype(np.int64)))


def random_state(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(D).astype(np.float32)
    W = (x + 0.3 * rng.standard_normal((N, D))).astype(np.float32)
    return x, W


def close(got, want, rtol=STEP_RTOL, atol=STEP_ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# one step from identical states
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["const", "polyak"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("p,seed", [(P, 0), (0.9, 1)])
def test_marina_p_one_step(probs, mode, kind, p, seed):
    jp, tp = probs
    js, ts = stepsize_pair(kind, mode, tp)
    x, W = random_state(seed)
    key = jax.random.PRNGKey(100 + seed)
    jstate, jm = jax.jit(JM.make_step(jp, mode, K, p, js))(
        JM.MarinaPState(x=jnp.asarray(x), W=jnp.asarray(W), t=jnp.int32(3)), key)
    draws = reference_draws(mode, key, p)
    tstate, tm = M.make_step(tp, mode, K, p, ts)(convert.marina_p_state_from_numpy(x, W, 3, "cpu"),
                                                  draws)
    assert float(jm["full_sync"]) == float(draws.coin) == tm["full_sync"]
    close(tstate.x.numpy(), jstate.x)
    close(tstate.W.numpy(), jstate.W)
    assert tstate.t == int(jstate.t) == 4
    for name in ("f_x", "f_w", "gamma", "q_nnz_mean", "drift"):
        close(float(tm[name]), float(jm[name]))


@pytest.mark.parametrize("comp", ["topk", "block_topk"])
@pytest.mark.parametrize("kind", ["const", "polyak"])
def test_ef21p_one_step(probs, comp, kind):
    jp, tp = probs
    jc, tc = ((JC.TopK(k=K), C.TopK(k=K)) if comp == "topk" else
              (JC.BlockTopK(k_per_block=2, block=16), C.BlockTopK(k_per_block=2, block=16)))
    js, ts = ((JS.Constant(0.05), S.Constant(0.05)) if kind == "const" else
              (JS.EF21PPolyak(alpha=K / D), S.EF21PPolyak(alpha=K / D)))
    x, W = random_state(7)
    w = W[0]
    jstate, jm = jax.jit(JE.make_step(jp, jc, js))(
        JE.EF21PState(x=jnp.asarray(x), w=jnp.asarray(w), t=jnp.int32(0)), jax.random.PRNGKey(0))
    tstate, tm = E.make_step(tp, tc, ts)(convert.ef21p_state_from_numpy(x, w, 0, "cpu"), None)
    close(tstate.x.numpy(), jstate.x)
    close(tstate.w.numpy(), jstate.w)
    for name in ("f_x", "f_w", "gamma"):
        close(float(tm[name]), float(jm[name]))
    assert float(tm["delta_nnz"]) == float(jm["delta_nnz"])


def test_sm_one_step(probs):
    jp, tp = probs
    x, _ = random_state(3)
    jstate, jm = jax.jit(JSM.make_step(jp, JS.Constant(0.02)))(
        JSM.SMState(x=jnp.asarray(x), t=jnp.int32(0)), jax.random.PRNGKey(0))
    tstate, tm = SM.make_step(tp, S.Constant(0.02))(SM.SMState(x=torch.from_numpy(x), t=0))
    close(tstate.x.numpy(), jstate.x)
    close(float(tm["f_x"]), float(jm["f_x"]))


# ---------------------------------------------------------------------------
# trajectories and the ledger
# ---------------------------------------------------------------------------


def inject_reference_draws(monkeypatch, mode, seed):
    """Make the port's run draw each round exactly what the reference's run
    does: key = PRNGKey(seed), then key, sub = split(key) per round."""
    key = jax.random.PRNGKey(seed)

    def draw_round(bcast, p, d, generator, device):
        nonlocal key
        key, sub = jax.random.split(key)
        return reference_draws(mode, sub, p)

    monkeypatch.setattr(M, "draw_round", draw_round)


@pytest.mark.parametrize("kind", ["const", "polyak"])
@pytest.mark.parametrize("mode", MODES)
def test_marina_p_trajectory_30_rounds(probs, monkeypatch, mode, kind):
    jp, tp = probs
    js, ts = stepsize_pair(kind, mode, tp)
    want = JM.run(jp, mode=mode, k=K, p=P, stepsize=js, T=30, seed=4)
    inject_reference_draws(monkeypatch, mode, 4)
    got = M.run(tp, mode=mode, k=K, p=P, stepsize=ts, T=30, seed=4)
    np.testing.assert_allclose(got["f_x"], want["f_x"], rtol=TRAJ_RTOL)
    assert got["s2w_bits"] == want["s2w_bits"] and got["w2s_bits"] == want["w2s_bits"]
    assert set(want) - {"final_state", "ledger"} == set(got) - {"final_state", "ledger"}


@pytest.mark.parametrize("mode", MODES)
def test_marina_p_bit_budget_ledger(probs, monkeypatch, mode):
    jp, tp = probs
    js, ts = stepsize_pair("polyak", mode, tp)
    want = JM.run(jp, mode=mode, k=K, p=P, stepsize=js, bit_budget=2e4, seed=2)
    inject_reference_draws(monkeypatch, mode, 2)
    got = M.run(tp, mode=mode, k=K, p=P, stepsize=ts, bit_budget=2e4, seed=2)
    assert got["ledger"].rounds == want["ledger"].rounds
    assert got["ledger"].s2w_bits == want["ledger"].s2w_bits
    assert got["ledger"].w2s_bits == want["ledger"].w2s_bits


def test_ef21p_trajectory_30_rounds_constant(probs):
    """Constant stepsize: TopK draws nothing and gamma is the same float in
    both, so the two runs are compared as they are."""
    jp, tp = probs
    want = JE.run(jp, JC.TopK(k=K), JS.Constant(0.05), T=30)
    got = E.run(tp, C.TopK(k=K), S.Constant(0.05), T=30)
    np.testing.assert_allclose(got["f_x"], want["f_x"], rtol=TRAJ_RTOL)
    assert got["s2w_bits"] == want["s2w_bits"]
    assert set(want) - {"final_state", "ledger"} == set(got) - {"final_state", "ledger"}


def test_ef21p_trajectory_30_rounds_polyak_from_reference_states(probs):
    """Polyak stepsize, 30 rounds, each port step taken from the reference's
    state of that round: f_x and gamma within 1e-5, equal delta_nnz.

    A free-running comparison cannot hold here: on the paper's tridiagonal
    problem |x - w| has exact ties, which TopK breaks by the rounding of
    x - gamma*g, and gamma's last bit depends on the summation order of f_w
    (see test_ef21p_topk_tie_break_follows_last_bit_of_gamma)."""
    jp, tp = probs
    jstep = jax.jit(JE.make_step(jp, JC.TopK(k=K), JS.EF21PPolyak(alpha=K / D)))
    tstep = E.make_step(tp, C.TopK(k=K), S.EF21PPolyak(alpha=K / D))
    jstate = JE.init(jp.x0)
    for t in range(30):
        tstate = convert.ef21p_state_from_numpy(jstate.x, jstate.w, t, "cpu")
        jstate, jm = jstep(jstate, jax.random.PRNGKey(t))
        _, tm = tstep(tstate, None)
        for name in ("f_x", "f_w", "gamma"):
            close(float(tm[name]), float(jm[name]))
        assert float(tm["delta_nnz"]) == float(jm["delta_nnz"])


def test_ef21p_topk_tie_break_follows_last_bit_of_gamma(probs):
    """The mechanism behind the test above, on the port alone: the same run
    with gamma one ulp larger departs by more than 1e-4 in f_x within 30
    rounds."""
    _, tp = probs

    class OneUlpMore(S.EF21PPolyak):
        def __call__(self, t, aux=None):
            return super().__call__(t, aux) * (1 + 2.0**-23)

    a = E.run(tp, C.TopK(k=K), S.EF21PPolyak(alpha=K / D), T=30)
    b = E.run(tp, C.TopK(k=K), OneUlpMore(alpha=K / D), T=30)
    assert a["s2w_bits"] == b["s2w_bits"]
    assert np.max(np.abs(np.subtract(a["f_x"], b["f_x"])) / np.abs(a["f_x"])) > TRAJ_RTOL


@pytest.mark.parametrize("alg", ["ef21p_polyak", "ef21p_const", "sm"])
def test_ef21p_and_sm_bit_budget_ledger(probs, alg):
    """Equal rounds and bits under a budget; f_x compared where the
    trajectory is not an ulp lottery (see above)."""
    jp, tp = probs
    if alg == "sm":
        want = JSM.run(jp, JS.Constant(0.02), bit_budget=3e4)
        got = SM.run(tp, S.Constant(0.02), bit_budget=3e4)
    else:
        js, ts = ((JS.Constant(0.05), S.Constant(0.05)) if alg == "ef21p_const" else
                  (JS.EF21PPolyak(alpha=K / D), S.EF21PPolyak(alpha=K / D)))
        want = JE.run(jp, JC.TopK(k=K), js, bit_budget=3e4)
        got = E.run(tp, C.TopK(k=K), ts, bit_budget=3e4)
    assert got["ledger"].rounds == want["ledger"].rounds
    assert got["ledger"].s2w_bits == want["ledger"].s2w_bits
    assert got["s2w_bits"] == want["s2w_bits"]
    if alg != "ef21p_polyak":
        np.testing.assert_allclose(got["f_x"], want["f_x"], rtol=TRAJ_RTOL)


def test_run_needs_a_stop(probs):
    _, tp = probs
    with pytest.raises(ValueError):
        E.run(tp, C.TopK(k=K), S.Constant(0.1))


# ---------------------------------------------------------------------------
# Lyapunov functions
# ---------------------------------------------------------------------------


def test_lyapunov_parity(probs):
    """Same formula in fp32, another summation order: 1e-5 relative."""
    _, tp = probs
    x, W = random_state(9)
    x_star = np.zeros(D, np.float32)
    kw = dict(L0_bar=tp.L0, L0_tilde=tp.L0_tilde, omega=float(N - 1), p=P)
    want = JM.lyapunov(JM.MarinaPState(x=jnp.asarray(x), W=jnp.asarray(W), t=jnp.int32(0)),
                       jnp.asarray(x_star), **kw)
    got = M.lyapunov(convert.marina_p_state_from_numpy(x, W, 0, "cpu"), torch.from_numpy(x_star), **kw)
    close(float(got), float(want))
    want = JE.lyapunov(JE.EF21PState(x=jnp.asarray(x), w=jnp.asarray(W[1]), t=jnp.int32(0)),
                       jnp.asarray(x_star), 0.25)
    got = E.lyapunov(convert.ef21p_state_from_numpy(x, W[1], 0, "cpu"), torch.from_numpy(x_star), 0.25)
    close(float(got), float(want))


def test_port_run_seeded_and_cpu_reproducible(probs):
    """The port's own RNG: one seed, one trajectory; another seed, other draws."""
    _, tp = probs
    a = M.run(tp, mode="ind", k=K, p=P, stepsize=S.Constant(0.01), T=15, seed=1)
    b = M.run(tp, mode="ind", k=K, p=P, stepsize=S.Constant(0.01), T=15, seed=1)
    c = M.run(tp, mode="ind", k=K, p=P, stepsize=S.Constant(0.01), T=15, seed=2)
    assert a["f_x"] == b["f_x"] and a["f_x"] != c["f_x"]
