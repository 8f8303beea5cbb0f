"""Kernel wrappers of the port (repro_torch.kernels.ops) against the Pallas
kernels of the JAX reference, run in interpret mode on the CPU as
tests/test_kernels.py runs them, plus the kernel-vs-plain cases on the card
(all of the port's ``cuda``-marked tests live here: this file needs no JAX
for them, so they run on a card whose machine has none).

On the CPU the port's wrappers run their plain PyTorch versions, which mirror
the Pallas kernels' arithmetic; the CUDA kernels themselves are held against
the same plain versions by the ``cuda``-marked tests and by chip_smoke.py.
The wire kernels' CPU parity is in tests/test_torch_encode.py.
"""
import numpy as np
import pytest
import torch

from repro_torch import wire as W
from repro_torch.core import compressors as TC
from repro_torch.kernels import encode as K
from repro_torch.kernels import ops, ref, runtime


@pytest.fixture(scope="module")
def jx():
    """The reference side: jax.numpy, repro.kernels.ops/ref, repro.core.compressors."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import compressors as JC
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    return jnp, jops, jref, JC


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view({4: np.int32, 2: np.int16}[a.dtype.itemsize])


def _l1_inputs(n, m, d, seed):
    """A [n, m, d], X [n, d] fp32 with every |(A x)_r| >= 1e-4 ||A x||_inf
    (rows near 0 pushed away along x in float64), so that a different fp32
    summation order cannot legitimately flip a sign."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, m, d))
    X = rng.standard_normal((n, d))
    y = np.einsum("nij,nj->ni", A, X)
    scale = np.abs(y).max(axis=1, keepdims=True)
    push = np.where(y >= 0, 1.0, -1.0) * 4e-4 * scale - y
    A += np.where(np.abs(y) < 2e-4 * scale, push, 0.0)[..., None] * \
        (X / np.sum(X**2, axis=1, keepdims=True))[:, None, :]
    return A.astype(np.float32), X.astype(np.float32)


# ---------------------------------------------------------------------------
# l1_subgrad
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,d", [(128, 128), (256, 384), (100, 257)])
def test_l1_subgrad_vs_pallas(jx, m, d):
    """rtol 1e-5 / atol 1e-4: same signs, fp32 sums over m rows of O(1)
    terms taken in another order (|g| ~ sqrt(m))."""
    jnp, jops, _, _ = jx
    A, X = _l1_inputs(1, m, d, seed=m + d)
    want = np.asarray(jops.l1_subgrad(jnp.asarray(A[0]), jnp.asarray(X[0])))
    got = ops.l1_subgrad(torch.from_numpy(A[0]), torch.from_numpy(X[0])).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_l1_subgrad_batched_and_broadcast_vs_pallas(jx):
    """The port's worker axis: [n, m, d] x [n, d], and one point shared by
    all workers (row stride 0), against the reference's per-worker kernel."""
    jnp, jops, _, _ = jx
    n, m, d = 4, 96, 130
    A, X = _l1_inputs(n, m, d, seed=5)
    want = np.stack([np.asarray(jops.l1_subgrad(jnp.asarray(A[i]), jnp.asarray(X[i])))
                     for i in range(n)])
    got = ops.l1_subgrad(torch.from_numpy(A), torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    A1, X1 = _l1_inputs(1, m, d, seed=6)
    shared = torch.from_numpy(X1[0]).expand(n, d)
    got_b = ops.l1_subgrad(torch.from_numpy(np.repeat(A1, n, axis=0)), shared).numpy()
    want_b = np.asarray(jops.l1_subgrad(jnp.asarray(A1[0]), jnp.asarray(X1[0])))
    np.testing.assert_allclose(got_b, np.broadcast_to(want_b, (n, d)), rtol=1e-5, atol=1e-4)


def test_l1_subgrad_plain_sums_in_the_kernels_order():
    """The plain version adds s_r A_r row by row inside blocks of
    rows_per_block(d) rows, then the blocks in order, as csrc/l1_subgrad.cu
    does: bit-equal to the same order written out in numpy float32 (ragged
    last block included)."""
    n, m, d = 2, 100, 257
    A, X = _l1_inputs(n, m, d, seed=3)
    R = ref.rows_per_block(d)
    assert m % R and R == 32
    S = np.where(np.einsum("nij,nj->ni", A, X) >= 0, 1.0, -1.0).astype(np.float32)
    want = np.zeros((n, d), np.float32)
    for r0 in range(0, m, R):
        part = S[:, r0, None] * A[:, r0]
        for r in range(r0 + 1, min(r0 + R, m)):
            part = part + S[:, r, None] * A[:, r]
        want = want + part
    got = ops.l1_subgrad(torch.from_numpy(A), torch.from_numpy(X)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_l1_subgrad_sign_of_zero_and_checks():
    """y = 0 counts as +1: with x = 0, g = A^T 1 (column sums). Bad dtype or
    shape raises."""
    A = torch.arange(12, dtype=torch.float32).reshape(3, 4) - 5.0
    np.testing.assert_array_equal(ops.l1_subgrad(A, torch.zeros(4)).numpy(), A.sum(0).numpy())
    with pytest.raises(TypeError):
        ops.l1_subgrad(A.double(), torch.zeros(4, dtype=torch.float64))
    with pytest.raises(ValueError):
        ops.l1_subgrad(A, torch.zeros(3))


# ---------------------------------------------------------------------------
# block_topk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,block,k", [(512, 128, 8), (2048, 512, 1), (1000, 128, 4), (300, 128, 5)])
def test_block_topk_vs_pallas(jx, d, block, k, dtype):
    """Bit-exact: same selection (first index on ties), kept values copied,
    the rest +0.0; d not a multiple of block is zero-padded by both."""
    jnp, jops, _, _ = jx
    rng = np.random.default_rng(d + k)
    x32 = rng.standard_normal(d).astype(np.float32)
    x32[::7] = np.round(x32[::7])  # exact ties across the block
    xj = jnp.asarray(x32).astype(getattr(jnp, dtype))
    xt = torch.from_numpy(x32).to(getattr(torch, dtype))
    want = np.asarray(jops.block_topk(xj, k_per_block=k, block=block))
    got = ops.block_topk(xt, k_per_block=k, block=block)
    if dtype == "bfloat16":
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
    else:
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def _edge(nan: bool = False) -> np.ndarray:
    x = np.zeros(128, np.float32)
    x[:6] = [1.0, np.inf, 3.0, -2.0, 0.5, 7.0]
    x[10:13] = [-0.0, -3.0, -0.5]
    if nan:
        x[1] = np.nan
    return x


@pytest.mark.parametrize("nan,k,kept", [(False, 3, [1]), (True, 3, []), (False, 1, [1])])
def test_block_topk_inf_nan_quirk_vs_pallas(jx, nan, k, kept):
    """The Pallas kernel's arithmetic, not lax.top_k's: a selected inf
    becomes NaN (inf*0) and stops selection, a NaN keeps nothing. Bit-exact,
    -0.0 included."""
    jnp, jops, _, _ = jx
    x = _edge(nan)
    want = np.asarray(jops.block_topk(jnp.asarray(x), k_per_block=k, block=128))
    got = ops.block_topk(torch.from_numpy(x), k_per_block=k, block=128).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert np.flatnonzero(got).tolist() == kept


def test_block_topk_negative_zero_kept_bitwise(jx):
    """-0.0 ties with the zeros; when selected it is copied as -0.0."""
    jnp, jops, _, _ = jx
    x = np.zeros(128, np.float32)
    x[5] = -0.0
    x[7] = 2.0
    want = np.asarray(jops.block_topk(jnp.asarray(x), k_per_block=7, block=128))
    got = ops.block_topk(torch.from_numpy(x), k_per_block=7, block=128).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert _bits(got)[5] == _bits(np.float32(-0.0))


def test_block_topk_denormals_follow_ieee_not_xla_cpu_ftz(jx):
    """Denormals: the port compares them as IEEE numbers, as the card does
    without fast-math, and so agrees with the reference's lax.top_k oracle.
    The interpret-mode Pallas kernel runs on XLA CPU, which flushes
    denormals to zero, and there keeps zeros instead. This asserts the
    divergence where it occurs rather than widening a tolerance."""
    jnp, jops, jref, _ = jx
    x = np.zeros(128, np.float32)
    x[:6] = [1e-42, -1e-42, 0.0, -0.0, 6.1e-39, 2e-45]
    x[10] = 1.0
    got = ops.block_topk(torch.from_numpy(x), k_per_block=4, block=128).numpy()
    oracle = np.asarray(jref.block_topk_ref(jnp.asarray(x), k_per_block=4, block=128))
    np.testing.assert_array_equal(_bits(got), _bits(oracle))
    assert np.flatnonzero(got).tolist() == [0, 1, 4, 10]
    pallas = np.asarray(jops.block_topk(jnp.asarray(x), k_per_block=4, block=128))
    assert np.flatnonzero(pallas).tolist() == [0, 1, 10]  # XLA CPU: 6.1e-39 flushed, lost


@pytest.mark.parametrize("d,k", [(50, 5), (64, 64), (100, 1)])
def test_topk_vs_reference_topk(jx, d, k):
    """Port TopK (one block spanning x) == JAX C.TopK (lax.top_k) on finite
    input with ties. assert_array_equal counts -0.0 == +0.0: the reference
    writes x*mask (-0.0 for a dropped negative), the kernel +0.0."""
    jnp, _, _, JC = jx
    rng = np.random.default_rng(d)
    x = np.round(rng.standard_normal(d) * 2).astype(np.float32)  # many ties
    want = np.asarray(JC.TopK(k=k)(None, jnp.asarray(x)))
    got = TC.TopK(k=k)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_block_topk_limits():
    """A block above the 227 KB shared-memory limit raises on every device."""
    with pytest.raises(ValueError, match="227 KB"):
        ops.block_topk(torch.zeros(10), k_per_block=1, block=ops._topk.MAX_BLOCK + 1)
    with pytest.raises(TypeError):
        ops.block_topk(torch.zeros(10, dtype=torch.float64), k_per_block=1, block=8)


def test_cpu_path_counts_no_launch():
    runtime.reset_launches()
    ops.block_topk(torch.ones(16), k_per_block=2, block=8)
    ops.l1_subgrad(torch.ones(4, 4), torch.ones(4))
    assert sum(runtime.LAUNCHES.values()) == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_kernels_vs_plain():
    """Each CUDA kernel against its plain version on the card: l1_subgrad at
    rtol 1e-5 / atol 1e-4 (summation order), block_topk bit-exact."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    dev = torch.device("cuda")
    A, X = _l1_inputs(10, 1000, 1000, seed=0)
    A, X = torch.from_numpy(A).to(dev), torch.from_numpy(X).to(dev)
    runtime.reset_launches()
    got = ops.l1_subgrad(A, X)
    torch.testing.assert_close(got, ref.l1_subgrad_ref(A, X), rtol=1e-5, atol=1e-4)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(1000).astype(np.float32)).to(dev)
    for block, k in ((1000, 100), (128, 4)):
        got = ops.block_topk(x, k_per_block=k, block=block)
        xp = torch.nn.functional.pad(x, (0, (-1000) % block))
        want = ref.block_topk_ref(xp, k_per_block=k, block=block)[:1000]
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["l1_subgrad"] == 1 and runtime.LAUNCHES["block_topk"] == 2


WIDTHS = [1, 4, 7, 8, 10, 13, 16, 32]
# tests/test_encode_diff.py's WEIRD, and quiet and signalling NaNs of both signs
WEIRD = np.array([np.nan, np.inf, -np.inf, -0.0, 1e-42, -1e-42, 0.0, 6.1e-39,
                  1.0000001, -3.5, 65504.0, 2.0], dtype=np.float32)
NANS = np.array([0x7FC00000, 0xFFC00000, 0x7F812345, 0xFF800001], dtype=np.uint32).view(np.float32)


def _i32(u: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(u, np.uint32).view(np.int32))


@pytest.mark.cuda
def test_cuda_wire_kernels_vs_plain():
    """pack/unpack, sparse_streams and dense_bits on the card == their plain
    versions, and the device buffers == the host codec's, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    runtime.reset_launches()
    for width in WIDTHS:
        for n in (1, 33, 4097):
            vals = _i32(rng.integers(0, 1 << width, n, dtype=np.uint64).astype(np.uint32))
            words = ops.pack_bits(vals.to(dev), width)
            assert torch.equal(words.cpu(), ref.pack_bits_ref(vals, width))
            assert torch.equal(ops.unpack_bits(words, width, n).cpu(), vals)
    X = np.stack([np.where(rng.random(1000) < 0.1, rng.standard_normal(1000), 0.0)
                  for _ in range(10)]).astype(np.float32)
    X[0, :len(WEIRD)] = WEIRD
    X[1, :len(NANS)] = NANS
    Xd = torch.from_numpy(X).to(dev)
    for mag in ("fp32", "fp16", "bf16"):
        m = int(W.mag_dtype(mag))
        for got, want in zip(K.sparse_streams(Xd, mag), ref.sparse_streams_ref(Xd, m)):
            assert torch.equal(got, want)
        assert torch.equal(K.dense_bits(Xd[1], mag), ref.dense_bits_ref(Xd[1], m))
        assert K.encode_rows(Xd, mag=mag) == [W.encode_sparse(X[i], mag=mag) for i in range(10)]
        assert K.dense_encode(Xd[1], mag=mag) == W.encode_dense(X[1], mag=mag)
    torch.cuda.synchronize()
    for name in ("pack_bits", "unpack_bits", "sparse_streams", "dense_bits"):
        assert runtime.LAUNCHES[name] > 0, name
