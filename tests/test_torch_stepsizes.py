"""repro_torch.core.stepsizes: the cases of tests/test_stepsizes.py re-run on
the port, and each schedule against the JAX reference on the same inputs."""
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import stepsizes as JS  # noqa: E402
from repro_torch.core import stepsizes as S  # noqa: E402


def test_B_star_limits():
    assert S.ef21p_B_star(1.0) == 1.0
    for a in [0.01, 0.1, 0.5, 0.9]:
        assert S.ef21p_B_star(a) <= 4.0 / a - 1.0 + 1e-9
    vals = [S.ef21p_B_star(a) for a in [0.1, 0.3, 0.5, 0.9]]
    assert all(x > y for x, y in zip(vals, vals[1:]))


def test_marina_B_star():
    assert S.marina_p_B_star(2.0, 3.0, omega=5.0, p=1.0) == pytest.approx(4.0)
    expect = 4.0 + 2 * 2 * 3 * math.sqrt(0.9 * 9.0 / 0.1)
    assert S.marina_p_B_star(2.0, 3.0, omega=9.0, p=0.1) == pytest.approx(expect)


@pytest.mark.parametrize("name,args", [
    ("ef21p_B_star", (0.3,)), ("ef21p_lambda_star", (0.36,)), ("ef21p_lambda_star", (1.0,)),
    ("marina_p_B_star", (2.0, 3.0, 9.0, 0.1)), ("marina_p_lambda_star", (2.0, 3.0, 9.0, 0.1)),
    ("ef21p_optimal_constant", (7.0, 2.0, 0.25, 100)),
    ("ef21p_optimal_decreasing_gamma0", (7.0, 2.0, 0.25, 100)),
    ("marina_p_optimal_constant", (7.0, 2.0, 3.0, 9.0, 0.1, 100)),
    ("marina_p_optimal_decreasing_gamma0", (7.0, 2.0, 3.0, 9.0, 0.1, 100)),
])
def test_theory_formulas_equal_reference(name, args):
    """Python-float formulas, copied: exactly equal."""
    assert getattr(S, name)(*args) == getattr(JS, name)(*args)


def test_decreasing_schedule():
    sch = S.Decreasing(gamma0=2.0)
    assert float(sch(0)) == pytest.approx(2.0)
    assert float(sch(3)) == pytest.approx(1.0)


@pytest.mark.parametrize("t", [0, 1, 6, 399])
def test_constant_and_decreasing_bit_equal_reference(t):
    """Both compute in fp32 with the same operations: bit-equal."""
    assert S.Constant(0.0123)(t) == float(JS.Constant(0.0123)(t))
    assert S.Decreasing(gamma0=0.3)(t) == float(JS.Decreasing(gamma0=0.3)(jnp.int32(t)))


def _aux(seed):
    rng = np.random.default_rng(seed)
    return {k: np.float32(v) for k, v in zip(("f_w", "g_norm_sq", "g_sq_mean"),
                                             rng.uniform(0.5, 50.0, 3))}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_polyak_bit_equal_reference(seed):
    """fp32 scalars through the same operations in the same order: bit-equal."""
    aux = _aux(seed)
    ta = {k: torch.tensor(v) for k, v in aux.items()}
    ja = {k: jnp.asarray(v) for k, v in aux.items()}
    for t_sch, j_sch in (
        (S.EF21PPolyak(alpha=0.1, f_star=0.5, factor=0.7), JS.EF21PPolyak(alpha=0.1, f_star=0.5, factor=0.7)),
        (S.MarinaPPolyak(omega=9.0, p=0.1, factor=1.3), JS.MarinaPPolyak(omega=9.0, p=0.1, factor=1.3)),
    ):
        got, want = t_sch(0, ta), j_sch(0, ja)
        assert got.dtype == torch.float32
        assert got.numpy().view(np.int32) == np.asarray(want).view(np.int32)


def test_ef21p_polyak_matches_eq13():
    a = 0.5
    aux = {"f_w": torch.tensor(3.0), "g_norm_sq": torch.tensor(4.0)}
    expect = (3.0 - 1.0) / (S.ef21p_B_star(a) * 4.0)
    assert float(S.EF21PPolyak(alpha=a, f_star=1.0)(0, aux)) == pytest.approx(expect)


def test_marina_polyak_matches_eq23():
    omega, p = 9.0, 0.1
    aux = {"f_w": torch.tensor(2.0), "g_norm_sq": torch.tensor(4.0), "g_sq_mean": torch.tensor(9.0)}
    c = math.sqrt((1 - p) * omega / p)
    assert float(S.MarinaPPolyak(omega=omega, p=p)(0, aux)) == pytest.approx(
        2.0 / (4.0 + 2 * 2.0 * 3.0 * c), rel=1e-5)


def test_polyak_never_negative_and_zero_gradient_safe():
    aux = {"f_w": torch.tensor(1.0), "g_norm_sq": torch.tensor(4.0)}
    assert float(S.EF21PPolyak(alpha=0.3, f_star=10.0)(0, aux)) == 0.0
    zero = {"f_w": torch.tensor(0.0), "g_norm_sq": torch.tensor(0.0), "g_sq_mean": torch.tensor(0.0)}
    assert float(S.MarinaPPolyak(omega=3.0, p=0.5)(0, zero)) == 0.0


def test_registry():
    assert isinstance(S.make_stepsize("constant:0.5"), S.Constant)
    assert isinstance(S.make_stepsize("decreasing:0.1"), S.Decreasing)
    assert isinstance(S.make_stepsize("polyak_ef21p", alpha=0.2), S.EF21PPolyak)
    assert isinstance(S.make_stepsize("polyak_marina_p", omega=3.0, p=0.25), S.MarinaPPolyak)
    with pytest.raises(ValueError):
        S.make_stepsize("bogus")
