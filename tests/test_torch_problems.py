"""repro_torch.core.problems held against the JAX reference (repro.core.problems)."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import problems as JP  # noqa: E402
from repro_torch.core import problems as TP  # noqa: E402

KW = dict(n=6, d=40, noise_scale=1.0, seed=3)


@pytest.fixture(scope="module")
def pair():
    return JP.generate_problem(**KW), TP.generate_problem(**KW, device="cpu")


def test_datagen_bit_equal(pair):
    """Algorithm 3 is the reference's numpy code verbatim: bit-equal."""
    jp, tp = pair
    for name in ("A", "x0", "L0i"):
        want = np.asarray(getattr(jp, name))
        got = getattr(tp, name).numpy()
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert tp.sigma_A == jp.sigma_A
    assert (tp.n, tp.d) == (jp.n, jp.d)


def test_scalar_metadata(pair):
    """L0, L0_tilde, R0_sq: fp32 means/sums in another summation order, so
    within 1e-6 relative (a few ulp), not bit-equal."""
    jp, tp = pair
    for name in ("L0", "L0_tilde", "R0_sq"):
        assert getattr(tp, name) == pytest.approx(getattr(jp, name), rel=1e-6)


def _points(d, n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(d).astype(np.float32), rng.standard_normal((n, d)).astype(np.float32)


@pytest.mark.parametrize("oracle", ["f_i", "f_all", "f", "subgrad_i", "subgrad_all", "subgrad"])
def test_oracles_match_reference(pair, oracle):
    """Every oracle within 1e-5: only the fp32 summation order differs. A
    random point keeps A x away from 0 (A is tridiagonal, y has 3 terms), so
    no sign may flip."""
    jp, tp = pair
    x, xs = _points(tp.d, tp.n, seed=11)
    args = {
        "f_i": ((2, x),), "f_all": ((xs,),), "f": ((x,),),
        "subgrad_i": ((2, x),), "subgrad_all": ((xs,),), "subgrad": ((x,),),
    }[oracle][0]
    want = np.asarray(getattr(jp, oracle)(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                            for a in args)))
    got = getattr(tp, oracle)(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                                for a in args)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_paper_sign_convention():
    """sign(+0.0) = sign(-0.0) = +1 (paper eq. 32), sign(NaN) = -1, as the
    reference's jnp.where(x >= 0, 1, -1)."""
    x = np.array([-1.0, -0.0, 0.0, 2.0, np.nan, -np.inf], np.float32)
    got = TP.paper_sign(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, [-1.0, 1.0, 1.0, 1.0, -1.0, -1.0])
    np.testing.assert_array_equal(got, np.asarray(JP.paper_sign(jnp.asarray(x))))


def test_fstar_zero_and_subgradient_valid(pair):
    """f(0) = 0 and the convexity inequality of the analytic subgradient."""
    _, tp = pair
    assert float(tp.f(torch.zeros(tp.d))) == 0.0
    rng = np.random.default_rng(0)
    for _ in range(5):
        x = torch.from_numpy(rng.standard_normal(tp.d).astype(np.float32))
        y = torch.from_numpy(rng.standard_normal(tp.d).astype(np.float32))
        assert float(tp.f(y)) >= float(tp.f(x) + tp.subgrad(x) @ (y - x)) - 1e-4


def test_to_moves_problem(pair):
    _, tp = pair
    moved = tp.to("cpu")
    assert moved.device.type == "cpu" and torch.equal(moved.A, tp.A)
