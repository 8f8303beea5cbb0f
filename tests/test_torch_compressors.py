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


@pytest.mark.parametrize("d,n,seed", [(32, 4, 0), (30, 4, 1), (100, 7, 2), (64, 16, 3)])
def test_rotk_bit_equal_with_injected_rotation(d, n, seed):
    """The rotation is the reference's jax.random.randint(key, (), 0, n):
    every worker's message and mask_for are bit-equal."""
    key = jax.random.PRNGKey(seed)
    x = _x(d, seed)
    r = torch.tensor(int(jax.random.randint(key, (), 0, n)))
    for i in range(n):
        want = np.asarray(JC.RotK(n=n, worker=i)(key, jnp.asarray(x)))
        got = C.RotK(n=n, worker=i)(torch.from_numpy(x), r).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))
        np.testing.assert_array_equal(C.RotK(n=n).mask_for(r, d, i).numpy(),
                                      np.asarray(JC.RotK(n=n).mask_for(key, d, i)))


@pytest.mark.parametrize("seed,n,d", [(0, 2, 16), (1, 4, 64), (2, 8, 96), (3, 3, 30)])
def test_rotk_exact_mean(seed, n, d):
    """(1/n) sum_i Q_i(x) = x for one shared rotation (DESIGN.md §2); each
    coordinate sits in exactly one worker's support."""
    x = torch.from_numpy(_x(d, seed))
    r = C.RotK(n=n).draw(d, torch.Generator().manual_seed(seed), "cpu")
    msgs = [C.RotK(n=n, worker=i)(x, r) for i in range(n)]
    np.testing.assert_allclose((sum(msgs) / n).numpy(), x.numpy(), rtol=2e-5, atol=1e-6)
    assert (sum((m != 0).int() for m in msgs) == 1).all()


@pytest.mark.parametrize("d,k,seed", [(777, 77, 5), (777, 300, 6), (64, 8, 1)])
def test_bernk_and_scaled_unbiased_divide_like_the_reference(d, k, seed):
    """BernK with the reference's uniforms injected, and ScaledUnbiased over
    RandK with its index set injected: bit-equal to the reference called as
    its tests call it, which divides by float32(q) (resp. omega + 1). Inside
    jax.jit XLA folds that division into a multiplication by the float32
    reciprocal (and writes +0.0 for dropped negatives): the port follows
    the division, and the jitted reference differs in the last bit."""
    key = jax.random.PRNGKey(seed)
    x = _x(d, seed)
    u = torch.from_numpy(np.asarray(jax.random.uniform(key, (d,))))
    want = np.asarray(JC.BernK(k=k)(key, jnp.asarray(x)))
    got = C.BernK(k=k)(torch.from_numpy(x), u).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    jitted = np.asarray(jax.jit(JC.BernK(k=k).__call__)(key, jnp.asarray(x)))
    assert (_bits(jitted) != _bits(got)).any()
    np.testing.assert_array_equal(got != 0, jitted != 0)
    idx = torch.from_numpy(np.flatnonzero(np.asarray(JC.RandK(k=k)(key, jnp.ones(d)))))
    want = np.asarray(JC.ScaledUnbiased(inner=JC.RandK(k=k))(key, jnp.asarray(x)))
    got = C.ScaledUnbiased(inner=C.RandK(k=k))(torch.from_numpy(x), idx).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_natural_with_injected_uniforms_exact_powers_of_two():
    """NaturalCompression with the reference's uniforms: bit-equal wherever
    the reference's jnp.exp2 returns an exact power of two. Where it does
    not (XLA CPU's exp2 is off by a few ulps for many exponents: here the
    reference's own tests/test_wire.py input, keys 5/6, and magnitudes
    2**-20..2**20), the port returns the exact power of two, and its
    outputs round-trip through the NATURAL codec (which the reference's
    test_natural_roundtrip_exact_on_compressor_output fails)."""
    from repro_torch import wire as W

    cases = [(np.asarray(jax.random.normal(jax.random.PRNGKey(5), (777,))), jax.random.PRNGKey(6))]
    rng = np.random.default_rng(7)
    cases.append(((rng.standard_normal(4096) * 2.0 ** rng.integers(-20, 20, 4096)).astype(np.float32),
                  jax.random.PRNGKey(8)))
    diverged = 0
    for x, key in cases:
        x = np.asarray(x, np.float32)
        want = np.asarray(JC.NaturalCompression()(key, jnp.asarray(x)))
        u = torch.from_numpy(np.asarray(jax.random.uniform(key, x.shape)))
        got = C.NaturalCompression()(torch.from_numpy(x), u).numpy()
        assert (_bits(got) & 0x7FFFFF == 0).all()  # every output an exact power of two (or 0)
        exact = _bits(want) & 0x7FFFFF == 0
        np.testing.assert_array_equal(_bits(got)[exact], _bits(want)[exact])
        np.testing.assert_allclose(got[~exact], want[~exact], rtol=1e-5)  # the exp2 ulps
        diverged += int((~exact).sum())
        np.testing.assert_array_equal(_bits(W.decode(W.encode(got, C.NaturalCompression()))), _bits(got))
    assert diverged > 0  # the divergence occurs on these inputs


def test_tree_compress_matches_reference():
    """tree_ravel / tree_compress over a nested dict (keys in sorted order)
    and a list: the same flat vector as jax's ravel_pytree, the structure,
    shapes and dtypes rebuilt; with BernK's uniforms injected, the leaves
    equal the reference's tree_compress."""
    rng = np.random.default_rng(0)
    tree = {"b": {"c": rng.standard_normal(5).astype(np.float32)}, "a": rng.standard_normal((3, 4)).astype(np.float32)}
    ttree = {"b": {"c": torch.from_numpy(tree["b"]["c"])}, "a": torch.from_numpy(tree["a"])}
    jtree = jax.tree.map(jnp.asarray, tree)
    jflat, _ = JC.tree_ravel(jtree)
    flat, unravel = C.tree_ravel(ttree)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    back = unravel(flat)
    assert back["a"].shape == (3, 4) and back["b"]["c"].shape == (5,)
    key = jax.random.PRNGKey(3)
    u = torch.from_numpy(np.asarray(jax.random.uniform(key, (17,))))
    want = JC.tree_compress(JC.BernK(k=5), key, jtree)
    got = C.tree_compress(C.BernK(k=5), u, ttree)
    np.testing.assert_array_equal(_bits(got["a"].numpy()), _bits(np.asarray(want["a"])))
    np.testing.assert_array_equal(_bits(got["b"]["c"].numpy()), _bits(np.asarray(want["b"]["c"])))
    out = C.tree_compress(C.TopK(k=2), None, [torch.arange(4.0), (torch.ones(2),)])
    assert out[0].tolist() == [0.0, 0.0, 2.0, 3.0] and out[1][0].tolist() == [0.0, 0.0]


def test_identity_and_constants_equal_reference():
    d, n = 40, 4
    x = torch.from_numpy(_x(d, 0))
    assert C.Identity()(x) is x
    pairs = [(C.Identity(), JC.Identity()), (C.TopK(k=5), JC.TopK(k=5)),
             (C.BlockTopK(k_per_block=3, block=16), JC.BlockTopK(k_per_block=3, block=16)),
             (C.RandK(k=5), JC.RandK(k=5)), (C.PermK(n=n), JC.PermK(n=n)),
             (C.RotK(n=n), JC.RotK(n=n)), (C.BernK(k=7), JC.BernK(k=7)),
             (C.NaturalCompression(), JC.NaturalCompression()),
             (C.ScaledUnbiased(inner=C.RandK(k=5)), JC.ScaledUnbiased(inner=JC.RandK(k=5)))]
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
    assert isinstance(C.make_compressor("natural", d=100), C.NaturalCompression)
    with pytest.raises(ValueError):
        C.make_compressor("bogus", d=10)


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


def test_bernk_unbiased():
    _check_unbiased(C.BernK(k=8), 32)


def test_natural_unbiased():
    _check_unbiased(C.NaturalCompression(), 32, tol=0.05)


def test_rotk_unbiased():
    _check_unbiased(C.RotK(n=4, worker=2), 32)


def test_scaled_unbiased_is_contractive():
    """Lemma 8: E||C(x) - x||^2 <= (1 - alpha) ||x||^2, 10% statistical
    slack as in tests/test_compressors.py."""
    d = 64
    comp = C.ScaledUnbiased(inner=C.RandK(k=8))
    x = torch.from_numpy(_x(d, 5))
    gen = torch.Generator().manual_seed(2)
    errs = torch.stack([torch.sum((comp(x, comp.draw(d, gen, "cpu")) - x) ** 2) for _ in range(3000)])
    assert float(errs.mean()) <= 1.1 * (1 - comp.alpha(d)) * float(torch.sum(x**2))


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
