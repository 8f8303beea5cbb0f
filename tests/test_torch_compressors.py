"""repro_torch.core.compressors: with the reference's own draws injected,
bit-equal to repro.core.compressors; with the port's own RNG, the
Definition 2/3 properties that tests/test_compressors.py checks."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import compressors as JC  # noqa: E402
from repro_torch.core import compressors as C  # noqa: E402


def _x(d, seed):
    return np.random.default_rng(seed).standard_normal(d).astype(np.float32)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


# ---------------------------------------------------------------------------
# injected draws: bit-equal to the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d,k,seed", [(32, 8, 0), (100, 10, 1), (64, 64, 2)])
def test_randk_bit_equal_with_injected_draws(d, k, seed):
    """The index set is the reference's own choice (its mask on ones(d));
    the message is (x * mask) * (d/k) in both: bit-equal."""
    key = jax.random.PRNGKey(seed)
    x = _x(d, seed)
    want = np.asarray(JC.RandK(k=k)(key, jnp.asarray(x)))
    idx = np.flatnonzero(np.asarray(JC.RandK(k=k)(key, jnp.ones(d))))
    got = C.RandK(k=k)(torch.from_numpy(x), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("d,n,seed", [(32, 4, 0), (30, 4, 1), (64, 8, 2)])
def test_permk_bit_equal_with_injected_permutation(d, n, seed):
    """The permutation is the reference's jax.random.permutation(key, d);
    d=30, n=4 exercises the leftover block that goes to worker 0."""
    key = jax.random.PRNGKey(seed)
    x = _x(d, seed)
    perm = torch.from_numpy(np.asarray(jax.random.permutation(key, d)).astype(np.int64))
    for i in range(n):
        want = np.asarray(JC.PermK(n=n, worker=i)(key, jnp.asarray(x)))
        got = C.PermK(n=n, worker=i)(torch.from_numpy(x), perm).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("kb,block,d", [(4, 32, 128), (16, 64, 200), (1, 16, 16)])
def test_block_topk_equal_reference(kb, block, d):
    """Finite input with ties: same selection as lax.top_k. assert_array_equal
    counts -0.0 == +0.0 (reference: x*mask; kernel: +0.0 for dropped)."""
    x = np.round(_x(d, kb) * 3).astype(np.float32)
    want = np.asarray(JC.BlockTopK(k_per_block=kb, block=block)(None, jnp.asarray(x)))
    got = C.BlockTopK(k_per_block=kb, block=block)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_identity_and_constants_equal_reference():
    d, n = 40, 4
    x = torch.from_numpy(_x(d, 0))
    assert C.Identity()(x) is x
    pairs = [(C.Identity(), JC.Identity()), (C.TopK(k=5), JC.TopK(k=5)),
             (C.BlockTopK(k_per_block=3, block=16), JC.BlockTopK(k_per_block=3, block=16)),
             (C.RandK(k=5), JC.RandK(k=5)), (C.PermK(n=n), JC.PermK(n=n))]
    for t, j in pairs:
        assert t.expected_density(d) == j.expected_density(d)
        for const in ("omega", "alpha"):
            if hasattr(j, const):
                assert getattr(t, const)(d) == getattr(j, const)(d)


def test_make_compressor_registry():
    assert isinstance(C.make_compressor("identity", d=10), C.Identity)
    assert C.make_compressor("topk", d=100, n=10) == C.TopK(k=10)
    assert C.make_compressor("block_topk:4:64", d=100) == C.BlockTopK(k_per_block=4, block=64)
    assert C.make_compressor("randk:7", d=100) == C.RandK(k=7)
    assert C.make_compressor("permk", d=100, n=5, worker=2) == C.PermK(n=5, worker=2)
    with pytest.raises(ValueError):
        C.make_compressor("natural", d=10)


# ---------------------------------------------------------------------------
# the port's own RNG: Definition 2/3 properties
# ---------------------------------------------------------------------------


def _check_unbiased(comp, d, n_samples=4000, tol=0.12):
    """The tolerances of tests/test_compressors.py: mean within 12% and the
    omega bound with 10% statistical slack."""
    x = torch.from_numpy(_x(d, 0))
    gen = torch.Generator().manual_seed(1)
    qs = torch.stack([comp(x, comp.draw(d, gen, "cpu")) for _ in range(n_samples)])
    mean_err = torch.linalg.norm(qs.mean(0) - x) / torch.linalg.norm(x)
    assert float(mean_err) < tol, float(mean_err)
    var = torch.mean(torch.sum((qs - x) ** 2, dim=-1))
    assert float(var) <= 1.1 * comp.omega(d) * float(torch.sum(x**2)) + 1e-6


def test_randk_unbiased():
    _check_unbiased(C.RandK(k=8), 32)


def test_permk_unbiased():
    _check_unbiased(C.PermK(n=4, worker=1), 32)


@pytest.mark.parametrize("seed,n,d", [(0, 2, 16), (1, 4, 32), (2, 8, 64), (3, 4, 30)])
def test_permk_exact_mean(seed, n, d):
    """(1/n) sum_i Q_i(x) = x for one shared draw (Definition 5)."""
    x = torch.from_numpy(_x(d, seed))
    perm = C.PermK(n=n).draw(d, torch.Generator().manual_seed(seed), "cpu")
    total = sum(q(x, perm) for q in C.permk_family(n))
    np.testing.assert_allclose((total / n).numpy(), x.numpy(), rtol=2e-5, atol=1e-6)


def test_permk_disjoint_supports():
    n, d = 4, 32
    perm = C.PermK(n=n).draw(d, torch.Generator().manual_seed(3), "cpu")
    overlap = sum((q(torch.ones(d), perm) != 0).int() for q in C.permk_family(n))
    assert (overlap == 1).all()


@pytest.mark.parametrize("d,k,seed", [(8, 1, 0), (50, 3, 1), (200, 8, 2)])
def test_topk_contractive(d, k, seed):
    x = torch.from_numpy(_x(d, seed))
    comp = C.TopK(k=k)
    err = torch.sum((comp(x) - x) ** 2)
    assert float(err) <= (1 - comp.alpha(d)) * float(torch.sum(x**2)) + 1e-5


def test_topk_keeps_largest():
    out = C.TopK(k=2)(torch.tensor([0.1, -5.0, 2.0, 0.01, -3.0]))
    np.testing.assert_array_equal(out.numpy(), [0.0, -5.0, 0.0, 0.0, -3.0])


def test_randk_draws_are_k_distinct_indices():
    gen = torch.Generator().manual_seed(0)
    idx = C.RandK(k=10).draw(50, gen, "cpu")
    assert idx.shape == (10,) and len(set(idx.tolist())) == 10 and int(idx.max()) < 50
