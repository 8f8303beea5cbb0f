"""Kernel wrappers of the port (repro_torch.kernels.ops) against the Pallas
kernels of the JAX reference, run in interpret mode on the CPU as
tests/test_kernels.py runs them, plus the kernel-vs-plain cases on the card
(all of the port's ``cuda``-marked tests live here: this file needs no JAX
for them, so they run on a card whose machine has none). bernk and
rotk_apply are held bit for bit, with the reference's arithmetic traps
(XLA's reciprocal for a division by a constant, floor mod, no FMA, -0.0)
and its one divergence (XLA on the CPU flushes denormals) named.

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
from repro_torch.kernels import ops, randk, ref, runtime


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


@pytest.mark.parametrize("n,m,d,C,chunks", [
    (3, 257, 130, 4, 65),    # ragged last chunk (1 row)
    (1, 1024, 64, 8, 128),   # n = 1: L1_MAX_CHUNKS chunks, as kernel_bench's A 1024 x 1024
    (10, 990, 40, 40, 25),   # n = 10, the main path's C; ragged last chunk (30 rows)
])
def test_l1_subgrad_plain_sums_in_the_kernels_order(n, m, d, C, chunks):
    """The plain version adds s_r A_r from 0, row by row inside chunks of
    chunk_rows(n, m) rows, then the chunks' sums in order from 0, as
    csrc/l1_subgrad.cu does: bit-equal to the same order written out in
    numpy float32."""
    A, X = _l1_inputs(n, m, d, seed=3)
    assert ref.chunk_rows(n, m) == C and -(-m // C) == chunks
    S = np.where(np.einsum("nij,nj->ni", A, X) >= 0, 1.0, -1.0).astype(np.float32)
    want = np.zeros((n, d), np.float32)
    for r0 in range(0, m, C):
        part = np.zeros((n, d), np.float32)
        for r in range(r0, min(r0 + C, m)):
            part = part + S[:, r, None] * A[:, r]
        want = want + part
    got = ops.l1_subgrad(torch.from_numpy(A), torch.from_numpy(X)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("n", [1, 3, 10, 100, 1000])
@pytest.mark.parametrize("m", [1, 7, 257, 1000, 1024, 100_000])
def test_chunk_rows_covers_every_row_once(n, m, monkeypatch):
    """chunk_rows cuts each worker's m rows into ceil(m / C) chunks that hold
    every row exactly once (the last one the rest, never empty), as short as
    they can be with at most L1_MAX_CHUNKS a worker and about
    L1_TARGET_BLOCKS blocks a launch. It is
    a function of (n, m) alone: it asks nothing of a card (the summation
    order must be the same on every device)."""
    for name in ("is_available", "device_count", "get_device_properties", "current_device"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: pytest.fail("chunk_rows asked the card"))
    C = ref.chunk_rows(n, m)
    chunks = -(-m // C)
    owner = np.repeat(np.arange(chunks), C)[:m]  # row r -> chunk r // C
    assert np.array_equal(np.bincount(owner, minlength=chunks)[:-1], np.full(chunks - 1, C))
    assert 1 <= m - (chunks - 1) * C <= C
    per_worker = max(1, min(ref.L1_MAX_CHUNKS, ref.L1_TARGET_BLOCKS // n))
    assert chunks <= per_worker  # n * chunks <= max(n, L1_TARGET_BLOCKS) blocks
    assert C == 1 or -(-m // (C - 1)) > per_worker  # the shortest chunks that stay within it
    assert ref.chunk_rows(n, m) == C  # deterministic
    # the cuts of the main path (n = 10, 100) and of kernel_bench (n = 1)
    assert (ref.chunk_rows(10, 1000), ref.chunk_rows(100, 1000), ref.chunk_rows(1, 1024)) == (40, 500, 8)


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


# ---------------------------------------------------------------------------
# the radix select of csrc/topk_select.cuh, modelled in numpy
# ---------------------------------------------------------------------------

_INF_KEY = 0x7F800000


def _radix_keep(xb: np.ndarray, k: int) -> np.ndarray:
    """The keep mask [nblocks, b] that csrc/topk_select.cuh computes, step by
    step: key = fp32 bits of |x|; a NaN keeps nothing, else an inf keeps the
    first inf, else k >= b keeps all, else up to 4 digit passes (bits 30..24,
    23..16, 15..8, 7..0) of a histogram scanned from the top fix a threshold
    T and the count `need` still wanted at T (stopping once the chosen bin
    holds exactly `need`); kept: key > T and the first `need` keys == T."""
    keys = (np.ascontiguousarray(xb, np.float32).view(np.uint32) & 0x7FFFFFFF).astype(np.int64)
    keep = np.zeros(keys.shape, bool)
    for row, key in enumerate(keys):
        b = key.size
        if k <= 0 or (key > _INF_KEY).any():
            t, need = 0xFFFFFFFF, 0
        elif (key == _INF_KEY).any():
            t, need = _INF_KEY, 1
        elif k >= b:
            t, need = 0, b
        else:
            prefix, need = 0, k
            for p in range(4):
                shift = 24 - 8 * p
                hi_mask = 0 if p == 0 else (0xFFFFFFFF << (shift + 8)) & 0xFFFFFFFF
                hist = np.bincount((key[(key & hi_mask) == prefix] >> shift) & 0xFF, minlength=256)
                above, digit = 0, 255
                while above + hist[digit] < need:
                    above += hist[digit]
                    digit -= 1
                prefix |= digit << shift
                need -= above
                if hist[digit] == need:
                    t, need = prefix - 1, 0
                    break
            else:
                t = prefix
        eq = key == t
        keep[row] = (key > t) | (eq & (np.cumsum(eq) <= need))
    return keep


def _topk_edge_cases():
    """(name, x fp32, block, k, dtype, oracle): blocks that stress the radix
    select. ``oracle`` names the reference side: the Pallas kernel in
    interpret mode, or lax.top_k (jref.block_topk_ref) where XLA CPU would
    flush the denormals the case is about (finite input only)."""
    rng = np.random.default_rng(41)
    cases = []

    def add(name, x, block, k, dtype="float32", oracle="pallas"):
        cases.append((name, np.asarray(x, np.float32), block, k, dtype, oracle))

    ties = np.round(rng.standard_normal(256) * 2) / 2
    add("ties at the threshold", ties, 128, 20)
    add("ties bf16", ties, 128, 37, "bfloat16")
    add("all |x| equal", np.where(rng.random(128) < 0.5, -0.75, 0.75), 128, 5)
    few = np.zeros(128)
    few[[3, 50, 99]] = [2.0, -1.0, 0.5]
    few[[0, 7]] = -0.0
    add("fewer non-zeros than k, -0.0 ties +0.0", few, 128, 10)
    add("k = 1", rng.standard_normal(256), 128, 1)
    add("k = b", rng.standard_normal(256), 128, 128)
    add("k = b bf16", rng.standard_normal(256), 128, 128, "bfloat16")
    add("main path d = block = 1000, k = 100", rng.standard_normal(1000), 1000, 100)
    add("main path bf16", rng.standard_normal(1000), 1000, 100, "bfloat16")
    nan = rng.standard_normal(128)
    nan[40] = np.nan
    add("NaN", nan, 128, 5)
    inf = rng.standard_normal(128)
    inf[17] = -np.inf
    add("inf", inf, 128, 5)
    both = inf.copy()
    both[90] = np.nan
    add("inf and NaN", both, 128, 5)
    two = rng.standard_normal(128)
    two[[30, 60]] = [np.inf, -np.inf]
    add("two infs", two, 128, 3)
    den = np.zeros(128)
    den[:12] = [1e-42, -1e-42, 6.1e-39, -6.1e-39, 2e-45, 1e-40, -1e-40, 1e-41, 3e-39, 0.0, -0.0, 1e-42]
    den[[20, 21]] = [1.0, -2.0]
    add("denormals straddling the threshold", den, 128, 7, oracle="lax")
    for bits in (8, 16, 24):  # keys equal in their top `bits` bits: T is fixed in a later pass
        low = rng.integers(0, 1 << (32 - bits - 1), 128, dtype=np.int64)
        keys = ((0x3FC00000 >> (31 - bits)) << (31 - bits)) | low
        x = (keys.astype(np.uint32) | (rng.integers(0, 2, 128, dtype=np.uint32) << 31)).view(np.float32)
        add(f"keys equal in their top {bits} bits", x, 128, 9)
    return cases


_TOPK_EDGE = _topk_edge_cases()


@pytest.mark.parametrize("case", _TOPK_EDGE, ids=[c[0] for c in _TOPK_EDGE])
def test_radix_select_model_vs_plain_and_pallas(jx, case):
    """The numpy model of the radix select == the port's plain version
    (ref._topk_keep_ref's k rounds) == the reference, bit for bit, on blocks
    that stress it: ties at T, all equal, fewer non-zeros than k, k = 1,
    k = b, NaN, inf, inf + NaN, two infs, -0.0, denormals, keys that differ
    only below a digit boundary, bf16."""
    jnp, jops, jref, _ = jx
    name, x32, block, k, dtype, oracle = case
    xt = torch.from_numpy(x32).to(getattr(torch, dtype))
    xw = xt.float().numpy().reshape(-1, block)  # bf16 widens exactly
    model = np.where(_radix_keep(xw, k), xw, np.float32(0)).reshape(-1)
    got = ops.block_topk(xt, k_per_block=k, block=block)
    view = torch.int16 if dtype == "bfloat16" else torch.int32
    want = torch.from_numpy(model).to(xt.dtype).view(view)
    assert torch.equal(got.view(view), want), name
    xj = jnp.asarray(x32).astype(getattr(jnp, dtype))
    theirs = (jops.block_topk(xj, k_per_block=k, block=block) if oracle == "pallas"
              else jref.block_topk_ref(xj, k_per_block=k, block=block))
    np.testing.assert_array_equal(np.asarray(theirs).view(want.numpy().dtype), want.numpy())


def test_block_topk_limits():
    """A block above the 227 KB shared-memory limit raises on every device."""
    with pytest.raises(ValueError, match="227 KB"):
        ops.block_topk(torch.zeros(10), k_per_block=1, block=ops._topk.MAX_BLOCK + 1)
    with pytest.raises(TypeError):
        ops.block_topk(torch.zeros(10, dtype=torch.float64), k_per_block=1, block=8)


# ---------------------------------------------------------------------------
# the counter hash, bernk, rotk_apply
# ---------------------------------------------------------------------------

BIG_SEED, BIG_WORKER = 2**31 + 12345, 2**31 + 7


@pytest.mark.parametrize("seed,worker", [(0, 0), (7, 3), (2**33 + 5, 9), (BIG_SEED, BIG_WORKER)])
def test_hash_uniform_ref_bit_equal_to_numpy_and_reference(jx, seed, worker):
    """The int64 torch hash (masked to 32 bits, products split below 2**48)
    == the port's numpy hash == the reference's jnp hash, seed mod 2**32 and
    the wrap of worker * M2 included."""
    jnp = jx[0]
    from repro.kernels import randk as jrandk

    idx = np.arange(1 << 16, dtype=np.uint32)
    got = ref.hash_uniform_ref(torch.from_numpy(idx.astype(np.int64)), randk.hash_salt(seed, worker)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(randk.hash_uniform(idx, seed, worker)))
    np.testing.assert_array_equal(_bits(got), _bits(np.asarray(jrandk.hash_uniform(jnp.asarray(idx), seed, worker))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,kp,seed,worker", [(512, 0.1, 11, 2), (777, 0.03, 11, 2), (1000, 1 / 3, 5, 0),
                                              (1024, 0.9, BIG_SEED, BIG_WORKER), (300, 0.25, 3, 1)])
def test_bernk_vs_pallas(jx, d, kp, seed, worker, dtype):
    """Bit-exact against the Pallas kernel (interpret mode), at keep
    probabilities that are not powers of two: f32 multiplies by the float32
    reciprocal as XLA's folded division does, bf16 divides in f32 by
    float32(bf16(kp)). d not a multiple of the reference's tile is padded and
    trimmed by the reference, and indexed globally by the port."""
    jnp, jops, _, _ = jx
    x32 = np.random.default_rng(d).standard_normal(d).astype(np.float32)
    xj = jnp.asarray(x32).astype(getattr(jnp, dtype))
    xt = torch.from_numpy(x32).to(getattr(torch, dtype))
    want = np.asarray(jops.bernk(xj, keep_prob=kp, seed=seed, worker=worker, block=256))
    got = ops.bernk(xt, keep_prob=kp, seed=seed, worker=worker)
    assert got.dtype == xt.dtype
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
    else:
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert 0 < int((got != 0).sum()) < d


def test_bernk_reciprocal_vs_division_split(jx):
    """Both sides of the reference's split at keep_prob 0.1. Its kernel
    (ops.bernk) computes x * float32(1/0.1): the port's bernk equals it. Its
    oracle (ref.bernk_ref) and its SEED BERN decode divide by float32(0.1):
    the port's SEED decode equals that. The two differ in the last bit on
    some kept values, with the same mask."""
    jnp, jops, jref, _ = jx
    from repro import wire as JW

    x = np.random.default_rng(0).standard_normal(1 << 14).astype(np.float32)
    kernel = np.asarray(jops.bernk(jnp.asarray(x), keep_prob=0.1, seed=12, worker=2))
    oracle = np.asarray(jref.bernk_ref(jnp.asarray(x), keep_prob=0.1, seed=12, worker=2))
    port = ops.bernk(torch.from_numpy(x), keep_prob=0.1, seed=12, worker=2).numpy()
    np.testing.assert_array_equal(_bits(port), _bits(kernel))
    msg = W.SeedMessage(family=W.SeedFamily.BERN, seed=7, round=5, scale=1.0, n=4, worker=2, param=0.1)
    seed_decode = W.apply_seed(msg, x)
    np.testing.assert_array_equal(_bits(seed_decode), _bits(oracle))
    jmsg = JW.SeedMessage(family=JW.SeedFamily.BERN, seed=7, round=5, scale=1.0, n=4, worker=2, param=0.1)
    np.testing.assert_array_equal(_bits(seed_decode), _bits(JW.apply_seed(jmsg, x)))
    np.testing.assert_array_equal(port != 0, seed_decode != 0)
    differ = int((_bits(port) != _bits(seed_decode)).sum())
    assert 0 < differ < int((port != 0).sum()), differ
    np.testing.assert_array_equal(port, np.where(port != 0, x * (np.float32(1) / np.float32(0.1)), 0))


def test_bernk_denormals_follow_ieee_not_xla_cpu_ftz(jx):
    """Denormal inputs: the port (and the card, built without fast-math)
    scales them as IEEE numbers; the interpret-mode Pallas kernel runs on XLA
    CPU, which flushes them to (signed) zero. Asserted where it occurs,
    rather than hidden by a tolerance."""
    jnp, jops, _, _ = jx
    x = np.ones(64, np.float32)
    x[:4] = [1e-40, -3e-39, 1e-42, 5.0]
    kp = 0.999999
    port = ops.bernk(torch.from_numpy(x), keep_prob=kp, seed=1, worker=0).numpy()
    pallas = np.asarray(jops.bernk(jnp.asarray(x), keep_prob=kp, seed=1, worker=0))
    assert (port != 0).all()  # every value kept at this keep probability
    np.testing.assert_array_equal(_bits(port), _bits(x * (np.float32(1) / np.float32(kp))))
    assert pallas[:3].view(np.uint32).tolist() == [0, 0x80000000, 0]  # flushed
    np.testing.assert_array_equal(_bits(port[3:]), _bits(pallas[3:]))


@pytest.mark.parametrize("n", [3, 4, 10, 16])
@pytest.mark.parametrize("r", [-3, 0, "n+1"])
def test_rotk_apply_vs_pallas(jx, n, r):
    """Bit-exact against the Pallas kernel: floor mod of a negative r, the
    product delta*n rounded before the sum (an FMA would differ for n not a
    power of two), and -0.0 in w turned into +0.0 where nothing is added."""
    jnp, jops, _, _ = jx
    r = n + 1 if r == "n+1" else r
    d = 1000
    rng = np.random.default_rng(n)
    w = rng.standard_normal(d).astype(np.float32)
    w[1::7] = -0.0
    delta = rng.standard_normal(d).astype(np.float32)
    want = np.asarray(jops.rotk_apply(jnp.asarray(w), jnp.asarray(delta), jnp.int32(r), n=n, worker=2,
                                      block=256))
    got = ops.rotk_apply(torch.from_numpy(w), torch.from_numpy(delta), torch.tensor(r, dtype=torch.int32),
                         n=n, worker=2).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    keep = np.arange(d) % n == (2 + r) % n  # Python's % is a floor mod
    assert keep.sum() >= d // n
    np.testing.assert_array_equal(_bits(got[~keep]), _bits(w[~keep] + np.float32(0)))
    separate = w[keep] + (delta[keep] * np.float32(n))
    np.testing.assert_array_equal(_bits(got[keep]), _bits(separate))
    fused = (w[keep].astype(np.float64) + delta[keep].astype(np.float64) * n).astype(np.float32)
    if n in (3, 10):
        assert (_bits(fused) != _bits(separate)).any()  # so the check above can tell an FMA apart


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("n", [7, 10, 16])
def test_rotk_apply_16bit_vs_pallas(jx, dtype, n):
    """bf16 / f16 bit-exact against the Pallas kernel (XLA rounds the product
    to the dtype, then the sum), with +-0, +-inf, NaNs of both signs and
    values that overflow the dtype when scaled, in w and in kept and
    dropped coordinates of delta. Rounding once, T(w + delta*n), differs on
    hundreds of coordinates for n = 7 and 10 (at n = 16 the product is
    exact), so the check can tell the two apart."""
    jnp, jops, _, _ = jx
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    d = 2**14
    rng = np.random.default_rng(n)
    w = rng.standard_normal(d).astype(np.float32)
    delta = rng.standard_normal(d).astype(np.float32)
    corners = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 65504.0, -65504.0, 3.0e4,
                        1e-3], np.float32)
    for at in range(0, 3 * n, n // 2):
        w[at:at + corners.size] = corners[::-1] if at % 2 else corners
        delta[at + 50:at + 50 + corners.size] = corners
    for r in (-3, 5):
        wj, dj = jnp.asarray(w).astype(jdt), jnp.asarray(delta).astype(jdt)
        want = np.asarray(jops.rotk_apply(wj, dj, jnp.int32(r), n=n, worker=2, block=1024))
        wt = torch.from_numpy(np.asarray(wj).view(np.int16).copy()).view(tdt)
        dt = torch.from_numpy(np.asarray(dj).view(np.int16).copy()).view(tdt)
        got = ops.rotk_apply(wt, dt, torch.tensor([r], dtype=torch.int32), n=n, worker=2)
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
        keep = torch.arange(d) % n == (2 + r) % n
        once = (wt.float() + torch.where(keep, dt.float() * n, 0.0)).to(tdt)
        finite = torch.isfinite(got.float())
        differ = int((once.view(torch.int16) != got.view(torch.int16))[finite].sum())
        assert (differ > 100) if n != 16 else (differ == 0), differ


def test_rotk_apply_negative_rotation_and_negative_zero(jx):
    """r = -3, worker 2, n = 10: (2 - 3) mod 10 = 9, so indices 9, 19, ...
    are kept (C's truncated % would give -1 and keep none); w = -0.0
    elsewhere comes back +0.0, as in the Pallas kernel."""
    jnp, jops, _, _ = jx
    w = np.full(100, -0.0, np.float32)
    delta = np.arange(100, dtype=np.float32)
    got = ops.rotk_apply(torch.from_numpy(w), torch.from_numpy(delta), torch.tensor([-3], dtype=torch.int32),
                         n=10, worker=2).numpy()
    want = np.asarray(jops.rotk_apply(jnp.asarray(w), jnp.asarray(delta), jnp.int32(-3), n=10, worker=2,
                                      block=128))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert np.flatnonzero(got).tolist() == list(range(9, 100, 10))
    assert set(_bits(got[np.arange(100) % 10 != 9]).tolist()) == {0}


def test_bernk_rotk_checks():
    x = torch.ones(8)
    rot = torch.tensor(1, dtype=torch.int32)
    with pytest.raises(TypeError):
        ops.rotk_apply(x.bfloat16(), x, rot, n=2, worker=0)  # w and delta of two dtypes
    with pytest.raises(TypeError):
        ops.rotk_apply(x.double(), x.double(), rot, n=2, worker=0)
    for dt in (torch.float16, torch.bfloat16):  # 16-bit: same shape and dtype out
        out = ops.rotk_apply(x.to(dt), x.to(dt), rot, n=2, worker=0)
        assert out.dtype == dt and out.float().tolist() == [1.0, 3.0] * 4
    with pytest.raises(TypeError):
        ops.rotk_apply(x, x, rot.long(), n=2, worker=0)
    with pytest.raises(ValueError):
        ops.rotk_apply(x, x, rot, n=0, worker=0)
    with pytest.raises(TypeError):
        ops.bernk(x.double(), keep_prob=0.5, seed=0)
    for kp in (0.0, 1.5):
        with pytest.raises(ValueError):
            ops.bernk(x, keep_prob=kp, seed=0)
    assert ops.bernk(torch.zeros(0), keep_prob=0.5, seed=0).shape == (0,)


def test_cpu_path_counts_no_launch():
    runtime.reset_launches()
    ops.block_topk(torch.ones(16), k_per_block=2, block=8)
    ops.l1_subgrad(torch.ones(4, 4), torch.ones(4))
    ops.bernk(torch.ones(16), keep_prob=0.5, seed=1)
    ops.rotk_apply(torch.ones(16), torch.ones(16), torch.tensor(1, dtype=torch.int32), n=4, worker=0)
    assert sum(runtime.LAUNCHES.values()) == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_cuda_kernels_vs_plain():
    """Each CUDA kernel against its plain version on the card: l1_subgrad at
    rtol 1e-5 / atol 1e-4 (a sign may flip where A x is near 0), block_topk
    bit-exact, the radix select's edge blocks included."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    dev = torch.device("cuda")
    A, X = _l1_inputs(10, 1000, 1000, seed=0)
    A, X = torch.from_numpy(A).to(dev), torch.from_numpy(X).to(dev)
    runtime.reset_launches()
    got = ops.l1_subgrad(A, X)
    torch.testing.assert_close(got, ref.l1_subgrad_ref(A, X), rtol=1e-5, atol=1e-4)
    for n, m, d in ((3, 100, 257), (2, 40, 5000)):  # the cp.async path (d % 4 != 0); d > 4096
        A2, X2 = (torch.from_numpy(a).to(dev) for a in _l1_inputs(n, m, d, seed=d))
        got2 = ops.l1_subgrad(A2, X2)
        torch.testing.assert_close(got2, ref.l1_subgrad_ref(A2, X2), rtol=1e-5, atol=1e-4)
        assert torch.equal(got2, ops.l1_subgrad(A2, X2))  # no float atomics: launches repeat bit for bit
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(1000).astype(np.float32)).to(dev)
    for block, k in ((1000, 100), (128, 4)):
        got = ops.block_topk(x, k_per_block=k, block=block)
        xp = torch.nn.functional.pad(x, (0, (-1000) % block))
        want = ref.block_topk_ref(xp, k_per_block=k, block=block)[:1000]
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["l1_subgrad"] == 5 and runtime.LAUNCHES["block_topk"] == 2
    for name, x32, block, k, dtype, _ in _TOPK_EDGE:  # the radix select's edge blocks
        xt = torch.from_numpy(x32).to(getattr(torch, dtype)).to(dev)
        view = torch.int16 if dtype == "bfloat16" else torch.int32
        got = ops.block_topk(xt, k_per_block=k, block=block)
        assert torch.equal(got.view(view), ref.block_topk_ref(xt, k_per_block=k, block=block).view(view)), name


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


def _corners() -> np.ndarray:
    return np.concatenate([WEIRD, NANS, np.array([-3e-39, 1e-40, 1.1754944e-38], np.float32)])


@pytest.mark.cuda
def test_cuda_seed_kernels_vs_plain():
    """bernk (f32, bf16), rotk_apply, mask_streams and topk_streams on the
    card == their plain versions, bit for bit, IEEE corners included; the
    fused encoders' buffers == the host codec over ops.block_topk / ops.bernk."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    x = rng.standard_normal(4096).astype(np.float32)
    x[:len(_corners())] = _corners()
    xd = torch.from_numpy(x).to(dev)
    runtime.reset_launches()
    for dtype, view in ((torch.float32, torch.int32), (torch.bfloat16, torch.int16)):
        for kp in (0.03, 0.1, 1 / 3):
            xt = xd.to(dtype)
            got = ops.bernk(xt, keep_prob=kp, seed=BIG_SEED, worker=BIG_WORKER)
            want = ref.bernk_ref(xt, keep_prob=kp, seed=BIG_SEED, worker=BIG_WORKER)
            assert torch.equal(got.view(view), want.view(view)), (dtype, kp)
    for dtype, view in ((torch.float32, torch.int32), (torch.float16, torch.int16),
                        (torch.bfloat16, torch.int16)):
        w = torch.full((4096,), -0.0, device=dev, dtype=dtype)
        xt = xd.to(dtype)
        for n, r in ((3, -3), (7, 0), (10, 11), (16, 0)):
            rot = torch.tensor([r], dtype=torch.int32, device=dev)
            assert torch.equal(ops.rotk_apply(w, xt, rot, n=n, worker=2).view(view),
                               ref.rotk_apply_ref(w, xt, rot, n=n, worker=2).view(view)), (dtype, n)
            assert torch.equal(ops.rotk_apply(xt, xt.flip(0), rot, n=n, worker=1).view(view),
                               ref.rotk_apply_ref(xt, xt.flip(0), rot, n=n, worker=1).view(view)), (dtype, n)
    workers = torch.arange(10, dtype=torch.int32, device=dev)
    for mag in ("fp32", "fp16", "bf16"):
        m = int(W.mag_dtype(mag))
        for got, want in zip(K.mask_streams(xd, workers, 0.1, BIG_SEED, mag),
                             ref.mask_streams_ref(xd, workers, 0.1, BIG_SEED, m)):
            assert torch.equal(got, want)
        for block, k in ((128, 1), (1000, 64), (1024, 1030)):
            xp = torch.nn.functional.pad(xd, (0, (-4096) % block))
            for got, want in zip(K.topk_streams(xp, k, block, mag), ref.topk_streams_ref(xp, k, block, m)):
                assert torch.equal(got, want)
        assert K.topk_encode(xd, k_per_block=64, block=1024, mag=mag) == \
            W.encode_sparse(ops.block_topk(xd, k_per_block=64, block=1024), mag=mag)
        assert K.mask_encode(xd, keep_prob=0.1, seed=7, worker=3, mag=mag) == \
            W.encode_sparse(ops.bernk(xd, keep_prob=0.1, seed=7, worker=3), mag=mag)
        assert K.encode_per_worker(xd, n_workers=4, keep_prob=0.1, seed=7, mag=mag) == \
            [W.encode_sparse(ops.bernk(xd, keep_prob=0.1, seed=7, worker=i), mag=mag) for i in range(4)]
    torch.cuda.synchronize()
    for name in ("bernk", "rotk_apply", "mask_streams", "topk_streams"):
        assert runtime.LAUNCHES[name] > 0, name


@pytest.mark.cuda
def test_cuda_rotk_apply_rows_vs_plain():
    """rotk_apply_rows and rotk_apply on the card == their plain versions,
    bit for bit, in f32, fp16 and bf16: 16-byte vectors, the scalar head and
    tail of views at column offsets 1 and 3 with delta at the same offset,
    one value a thread for short leaves and where delta sits elsewhere, a
    broadcast row, odd and tiny sizes; one launch per rows call."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    runtime.reset_launches()
    calls = 0
    for dtype, view in ((torch.float32, torch.int32), (torch.float16, torch.int16),
                        (torch.bfloat16, torch.int16)):
        # one value a thread below a block of 16-byte vectors an SM; vectors (with a head and a tail) above
        for n, s in ((1, 7), (3, 1003), (16, 65536), (4, 600_000), (7, 600_003)):
            W = torch.randn(n, s + 8, generator=gen, device=dev).to(dtype)
            W[:, 3::11] = -0.0
            D = torch.randn(s + 8, generator=gen, device=dev).to(dtype)
            for c in (0, 1, 3):
                for r in (-3, n + 1):
                    rot = torch.tensor([r], dtype=torch.int32, device=dev)
                    w = W[:, c:c + s]
                    for delta in (D[c:c + s], D[c:c + s].clone()):
                        want = ref.rotk_apply_rows_ref(w, delta, rot, n=n)
                        out = torch.full_like(W, 5.0)
                        got = ops.rotk_apply_rows(w, delta, rot, n=n, out=out[:, c:c + s])
                        assert torch.equal(got.view(view), want.view(view)), (dtype, n, s, c, r)
                        assert bool((out[:, :c] == 5).all() and (out[:, c + s:] == 5).all())
                        bc = ops.rotk_apply_rows(w[0].expand(n, s), delta, rot, n=n)
                        assert torch.equal(bc.view(view), ref.rotk_apply_rows_ref(
                            w[0].expand(n, s), delta, rot, n=n).view(view)), (dtype, n, s, c, r)
                        calls += 2
                    for i in range(n):
                        assert torch.equal(ops.rotk_apply(W[i, c:c + s], D[c:c + s], rot, n=n, worker=i).view(view),
                                           ref.rotk_apply_ref(W[i, c:c + s], D[c:c + s], rot, n=n, worker=i).view(view))
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["rotk_apply_rows"] == calls
