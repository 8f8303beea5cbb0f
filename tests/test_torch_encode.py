"""The port's device encode path (``repro_torch.kernels.encode`` with the
pack kernels of ``kernels/ops.py``) and the ``measure_wire`` runs against the
JAX reference.

On the CPU the wrappers run the kernels' plain versions (``kernels/ref.py``);
the reference's Pallas kernels run in interpret mode, as its own tests run
them. Every comparison of words, bytes and bits is exact. The CUDA kernels
are held against the same plain versions by the ``cuda``-marked
``test_cuda_wire_kernels_vs_plain`` in tests/test_torch_kernels.py (which
needs no JAX) and by ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import wire as JW  # noqa: E402
from repro.core import compressors as JC  # noqa: E402
from repro.core import ef21p as JE  # noqa: E402
from repro.core import marina_p as JM  # noqa: E402
from repro.core import problems as JP  # noqa: E402
from repro.core import stepsizes as JS  # noqa: E402
from repro.kernels import encode as JK  # noqa: E402
from repro.kernels import ops as JO  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import wire as W  # noqa: E402
from repro_torch.core import compressors as C  # noqa: E402
from repro_torch.core import ef21p as E  # noqa: E402
from repro_torch.core import marina_p as M  # noqa: E402
from repro_torch.core import stepsizes as S  # noqa: E402
from repro_torch.kernels import encode as K  # noqa: E402
from repro_torch.kernels import ops, ref, runtime  # noqa: E402
from repro_torch.wire import sparse as WS  # noqa: E402

MAGS = ["fp32", "fp16", "bf16"]
WIDTHS = [1, 4, 7, 8, 10, 13, 16, 32]

# tests/test_encode_diff.py's WEIRD (its NaN is quiet)
WEIRD = np.array([np.nan, np.inf, -np.inf, -0.0, 1e-42, -1e-42, 0.0, 6.1e-39,
                  1.0000001, -3.5, 65504.0, 2.0], dtype=np.float32)
# quiet and signalling NaNs of both signs
NANS = np.array([0x7FC00000, 0xFFC00000, 0x7F812345, 0xFF800001],
                dtype=np.uint32).view(np.float32)


def _i32(u: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(u, np.uint32).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def _sparse_vec(rng, d, density):
    x = rng.standard_normal(d).astype(np.float32)
    return np.where(rng.random(d) < density, x, 0.0).astype(np.float32)


# ---------------------------------------------------------------------------
# pack / unpack
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", WIDTHS)
def test_pack_unpack_vs_pallas_and_host(width):
    """ops.pack_bits (plain version on the CPU) == the reference's Pallas
    pack_bits in interpret mode == wire.bitstream.pack_u32, with unaligned
    tails; unpack inverts all three."""
    rng = np.random.default_rng(width)
    n = 300
    vals = rng.integers(0, 1 << width, n, dtype=np.uint64).astype(np.uint32)
    host = W.pack_u32(vals, width)
    pallas = np.asarray(JO.pack_bits(jnp.asarray(vals), width=width, interpret=True))
    got = _u32(ops.pack_bits(_i32(vals), width))
    np.testing.assert_array_equal(got, host)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(_u32(ops.unpack_bits(_i32(host), width, n)), vals)
    np.testing.assert_array_equal(
        _u32(ops.unpack_bits(_i32(host), width, n)),
        np.asarray(JO.unpack_bits(jnp.asarray(host), width=width, count=n, interpret=True)))


@pytest.mark.parametrize("width", WIDTHS)
def test_pack_plain_version_edges(width):
    """Sizes around a word, empty input, batched rows with a row stride, an
    ``out`` view, and values above 2**width masked to width bits."""
    rng = np.random.default_rng(100 + width)
    for n in (0, 1, 31, 32, 33, 1000):
        vals = rng.integers(0, 1 << width, n, dtype=np.uint64).astype(np.uint32)
        np.testing.assert_array_equal(_u32(ref.pack_bits_ref(_i32(vals), width)), W.pack_u32(vals, width))
        np.testing.assert_array_equal(_u32(ref.unpack_bits_ref(_i32(W.pack_u32(vals, width)), width, n)), vals)
    rows = rng.integers(0, 1 << width, (3, 70), dtype=np.uint64).astype(np.uint32)
    wide = torch.zeros(3, 75, dtype=torch.int32)
    wide[:, :70] = _i32(rows)
    nw = W.n_words(70, width)
    out = torch.full((3, nw + 2), -1, dtype=torch.int32)
    ops.pack_bits(wide[:, :70], width, out=out[:, 1:1 + nw])
    for r in range(3):
        np.testing.assert_array_equal(_u32(out[r, 1:1 + nw]), W.pack_u32(rows[r], width))
    assert (out[:, 0] == -1).all() and (out[:, -1] == -1).all()
    if width < 32:  # high garbage bits are masked off
        noisy = rows[0] | np.uint32(0xFFFFFFFF ^ ((1 << width) - 1))
        np.testing.assert_array_equal(_u32(ops.pack_bits(_i32(noisy), width)), W.pack_u32(rows[0], width))


def test_pack_checks():
    with pytest.raises(ValueError):
        ops.pack_bits(torch.zeros(4, dtype=torch.int32), 33)
    with pytest.raises(TypeError):
        ops.pack_bits(torch.zeros(4, dtype=torch.int64), 8)
    with pytest.raises(ValueError):
        ops.pack_bits(torch.zeros(4, dtype=torch.int32), 8, out=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        ops.unpack_bits(torch.zeros(4, dtype=torch.int32), 0, 3)


# ---------------------------------------------------------------------------
# stream extraction: the plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mag", MAGS)
def test_stream_plain_versions_are_the_host_rules(mag):
    """sparse_streams_ref / dense_bits_ref (int64 torch) == the host codec's
    numpy uint32 rules on random bit patterns and the NaN corners."""
    m = W.mag_dtype(mag)
    b = np.concatenate([_bits(WEIRD), _bits(NANS),
                        np.random.default_rng(1).integers(0, 2**32, 1 << 16, dtype=np.uint64)
                        .astype(np.uint32)])
    X = _i32(b).view(torch.float32).reshape(4, -1)
    sign, magbits, valid = ref.sparse_streams_ref(X, int(m))
    bb = b.reshape(4, -1)
    np.testing.assert_array_equal(_u32(sign), bb >> 31)
    np.testing.assert_array_equal(_u32(magbits), WS.to_wire_bits(bb & 0x7FFFFFFF, m))
    np.testing.assert_array_equal(valid.numpy(), (bb & 0x7FFFFFFF) != 0)
    np.testing.assert_array_equal(_u32(ref.dense_bits_ref(X[0], int(m))), WS.to_wire_bits(bb[0], m))


# ---------------------------------------------------------------------------
# messages: the port's device path vs the reference's fused encode vs host
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("block", [128, 1024])
@pytest.mark.parametrize("mag", MAGS)
@pytest.mark.parametrize("d,density", [(1, 1.0), (100, 0.3), (257, 0.05), (1000, 0.1)])
def test_sparse_and_dense_encode_vs_reference(d, density, mag, block):
    """Port device path (plain versions on the CPU) == reference Pallas
    encode (interpret mode, at its tile ``block``) == port host codec ==
    reference host codec."""
    x = _sparse_vec(np.random.default_rng(d), d, density)
    xt = torch.from_numpy(x)
    want = JW.encode_sparse(x, mag=mag)
    assert K.sparse_encode(xt, mag=mag) == want == W.encode_sparse(x, mag=mag)
    assert JK.sparse_encode(jnp.asarray(x), mag=mag, block=block, interpret=True) == want
    want = JW.encode_dense(x, mag=mag)
    assert K.dense_encode(xt, mag=mag) == want == W.encode_dense(x, mag=mag)
    assert JK.dense_encode(jnp.asarray(x), mag=mag, block=block, interpret=True) == want


@pytest.mark.parametrize("mag", MAGS)
def test_encode_rows_vs_reference(mag):
    rng = np.random.default_rng(2)
    X = np.stack([_sparse_vec(rng, 300, dens) for dens in (0.1, 0.0, 1.0)])
    X[0, :4] = WEIRD[:4]
    got = K.encode_rows(torch.from_numpy(X), mag=mag)
    assert got == [W.encode_sparse(X[i], mag=mag) for i in range(3)]
    assert got == JK.encode_rows(jnp.asarray(X), mag=mag, block=128, interpret=True)


@pytest.mark.parametrize("mag", MAGS)
def test_weird_values_vs_reference(mag):
    """IEEE corners (quiet NaN, +-inf, -0.0, denormals): all four encoders
    agree byte for byte."""
    x = WEIRD
    for port_dev, port_host, jdev, jhost in (
        (K.sparse_encode, W.encode_sparse, JK.sparse_encode, JW.encode_sparse),
        (K.dense_encode, W.encode_dense, JK.dense_encode, JW.encode_dense),
    ):
        want = jhost(x, mag=mag)
        assert port_dev(torch.from_numpy(x), mag=mag) == port_host(x, mag=mag) == want
        assert jdev(jnp.asarray(x), mag=mag, block=128, interpret=True) == want


def test_fp16_signalling_nan_follows_host_codec_not_reference_device_encode():
    """The wire contract is the host codec (DESIGN.md §3, "byte-identical to
    the host codec" in repro/kernels/encode.py). On fp16 signalling NaNs the
    port's device path and host codec both follow it (numpy keeps the
    payload's top bits: 0x7c09, 0xfc01), while the reference's own fused
    encode quiets them through XLA's fp16 convert (0x7e09, 0xfe00): a
    reference fault (ROADMAP Queue 3), asserted here where it occurs. fp32
    and bf16 agree everywhere."""
    x = np.array([0x7F812345, 0x3F800000, 0xFF800001], dtype=np.uint32).view(np.float32)
    xt = torch.from_numpy(x)
    for port_dev, port_host, jdev, jhost, host_tail, dev_tail in (
        # SPARSE carries |x|: magnitudes 7c09 3c00 7c01 (little-endian words)
        (K.sparse_encode, W.encode_sparse, JK.sparse_encode, JW.encode_sparse,
         "097c003c017c0000", "097e003c007e0000"),
        # DENSE keeps the sign: 7c09 3c00 fc01
        (K.dense_encode, W.encode_dense, JK.dense_encode, JW.encode_dense,
         "097c003c01fc0000", "097e003c00fe0000"),
    ):
        want = jhost(x, mag="fp16")
        assert port_dev(xt, mag="fp16") == port_host(x, mag="fp16") == want
        assert want.hex().endswith(host_tail)
        theirs = jdev(jnp.asarray(x), mag="fp16", interpret=True)
        assert theirs != want and theirs.hex().endswith(dev_tail)
        for mag in ("fp32", "bf16"):
            assert port_dev(xt, mag=mag) == jdev(jnp.asarray(x), mag=mag, interpret=True) == jhost(x, mag=mag)


def test_empty_and_all_zero_messages():
    z = torch.zeros(100)
    assert K.sparse_encode(z) == JW.encode_sparse(z.numpy())
    assert K.sparse_encode(torch.zeros(0)) == JW.encode_sparse(np.zeros(0, np.float32))
    assert K.dense_encode(torch.zeros(0)) == JW.encode_dense(np.zeros(0, np.float32))
    assert K.encode_rows(torch.zeros(2, 0)) == [JW.encode_sparse(np.zeros(0, np.float32))] * 2
    for v in (2.5, 0.0, -0.0):
        x = np.array([v], np.float32)
        assert K.sparse_encode(torch.from_numpy(x)) == JW.encode_sparse(x)
        assert K.dense_encode(torch.from_numpy(x)) == JW.encode_dense(x)


def test_cpu_path_counts_no_launch():
    runtime.reset_launches()
    K.encode_rows(torch.ones(2, 40))
    K.dense_encode(torch.ones(40))
    K.topk_encode(torch.ones(40), k_per_block=4, block=16)
    K.mask_encode(torch.ones(40), keep_prob=0.5, seed=1)
    K.encode_per_worker(torch.ones(40), n_workers=3, keep_prob=0.5, seed=1)
    W.encode_rows(torch.ones(2, 40), device_encode=True)
    W.encode(torch.ones(40), C.Identity(), device_encode=True)
    assert sum(runtime.LAUNCHES.values()) == 0


def test_device_encode_policy():
    cpu = torch.zeros(3)
    assert K.device_encode_enabled(None, cpu) is False
    assert K.device_encode_enabled(True, cpu) is True
    assert K.device_encode_enabled(False, cpu) is False


@pytest.mark.parametrize("mag", MAGS)
def test_device_buffers_decode_like_reference(mag):
    """The device path's buffers (plain versions on the CPU) decode with the
    port's host codec bit-equal to the reference's decode, NaN payloads
    included, on random bit patterns and the corners."""
    x = np.concatenate([WEIRD, NANS, np.random.default_rng(3).integers(
        0, 2**32, 2000, dtype=np.uint64).astype(np.uint32).view(np.float32)])
    x[50:1500] = 0.0
    for buf in (K.sparse_encode(torch.from_numpy(x), mag=mag), K.dense_encode(torch.from_numpy(x), mag=mag)):
        np.testing.assert_array_equal(_bits(W.decode(buf)), _bits(JW.decode(buf)))


def test_wire_encode_dispatch_gives_host_codec_bytes():
    """``wire.encode`` / ``wire.encode_rows``, the one place that picks the
    encoder for both runs: device_encode True (the device path's plain
    versions on the CPU), False and None all give the reference host codec's
    bytes, for numpy input too."""
    rng = np.random.default_rng(5)
    X = np.stack([_sparse_vec(rng, 200, 0.2) for _ in range(3)])
    X[1, :len(NANS)] = NANS
    Xt = torch.from_numpy(X)
    want_rows = [JW.encode_sparse(X[i], mag="fp16") for i in range(3)]
    for dev in (True, False, None):
        assert W.encode_rows(Xt, mag="fp16", device_encode=dev) == want_rows
        assert W.encode_rows(Xt[:1].expand(3, 200), mag="fp16", device_encode=dev) == [want_rows[0]] * 3
        assert W.encode(Xt[1], C.Identity(), mag="bf16", device_encode=dev) == JW.encode_dense(X[1], mag="bf16")
        assert W.encode(Xt[2], C.TopK(k=4), device_encode=dev) == JW.encode_sparse(X[2])
    assert W.encode_rows(X, mag="fp16") == want_rows


# ---------------------------------------------------------------------------
# fused compress + encode: topk_encode, mask_encode, encode_per_worker
# (the cases of tests/test_encode_diff.py at small d)
# ---------------------------------------------------------------------------

BIG_SEED = 2**31 + 12345


@pytest.mark.parametrize("mag", MAGS)
@pytest.mark.parametrize("d,k", [(128, 1), (250, 8), (384, 128), (250, 200)])
def test_topk_encode_vs_reference(d, k, mag):
    """Port topk_encode (plain topk_streams on the CPU) == reference fused
    topk_encode (interpret mode) == the host codecs over block_topk, k >=
    block included (everything selected, zeros elided)."""
    x = np.random.default_rng(d + k).standard_normal(d).astype(np.float32)
    want = JW.encode_sparse(np.asarray(JO.block_topk(jnp.asarray(x), k_per_block=k, block=128)), mag=mag)
    xt = torch.from_numpy(x)
    assert K.topk_encode(xt, k_per_block=k, block=128, mag=mag) == want
    assert W.encode_sparse(ops.block_topk(xt, k_per_block=k, block=128), mag=mag) == want
    assert JK.topk_encode(jnp.asarray(x), k_per_block=k, block=128, mag=mag, interpret=True) == want


@pytest.mark.parametrize("mag", MAGS)
@pytest.mark.parametrize("kp,seed,worker", [(0.03, 5, 0), (0.1, BIG_SEED, 3), (0.25, 42, 7), (0.9, 11, 2**31 - 1)])
def test_mask_encode_vs_reference(kp, seed, worker, mag):
    """Port mask_encode == reference fused mask_encode (interpret mode) ==
    the host codecs over bernk, at keep probabilities that are not powers of
    two (the f32 reciprocal), a seed above 2**31 and the largest worker id the
    reference's int32 operand takes."""
    x = np.random.default_rng(seed % 1000).standard_normal(384).astype(np.float32)
    xt = torch.from_numpy(x)
    want = JW.encode_sparse(np.asarray(JO.bernk(jnp.asarray(x), keep_prob=kp, seed=seed, worker=worker)),
                            mag=mag)
    assert K.mask_encode(xt, keep_prob=kp, seed=seed, worker=worker, mag=mag) == want
    assert W.encode_sparse(ops.bernk(xt, keep_prob=kp, seed=seed, worker=worker), mag=mag) == want
    assert JK.mask_encode(jnp.asarray(x), keep_prob=kp, seed=seed, worker=worker, block=128, mag=mag,
                          interpret=True) == want


@pytest.mark.parametrize("mag", MAGS)
def test_fused_encode_weird_values_vs_reference(mag):
    """IEEE corners (tests/test_encode_diff.py's WEIRD and NaN payloads):
    topk_encode keeps nothing after a NaN and stops after a selected inf;
    mask_encode over NaN/inf/-0.0 payloads. All equal to the reference's
    fused encoders and host codec (denormal-free where XLA's flush would
    differ: see the test below)."""
    cases = [WEIRD, WEIRD[1:], np.concatenate([NANS, WEIRD[8:]])]
    for x in cases:
        xt, xj = torch.from_numpy(x), jnp.asarray(x)
        for k in (1, 4, 20):
            want = JW.encode_sparse(np.asarray(JO.block_topk(xj, k_per_block=k, block=128)), mag=mag)
            assert K.topk_encode(xt, k_per_block=k, block=128, mag=mag) == want
            assert JK.topk_encode(xj, k_per_block=k, block=128, mag=mag, interpret=True) == want
    no_denormals = np.concatenate([NANS, WEIRD[[0, 1, 2, 3, 6, 8, 9, 10, 11]]])
    want = JK.mask_encode(jnp.asarray(no_denormals), keep_prob=0.9, seed=3, block=128, mag=mag, interpret=True)
    assert K.mask_encode(torch.from_numpy(no_denormals), keep_prob=0.9, seed=3, mag=mag) == want


def test_mask_encode_denormals_follow_ieee_not_xla_cpu_ftz():
    """Denormal payloads: the port's mask_encode (and bernk) scale them as
    IEEE numbers and send them; the reference's, run on XLA CPU, flush them to
    zero and elide them. Asserted where it occurs."""
    x = np.array([1e-40, -3e-39, 1e-42, 5.0, -2.0], np.float32)
    kp = 0.999999
    port = K.mask_encode(torch.from_numpy(x), keep_prob=kp, seed=1)
    assert port == W.encode_sparse(ops.bernk(torch.from_numpy(x), keep_prob=kp, seed=1))
    np.testing.assert_array_equal(_bits(W.decode(port)), _bits(x * (np.float32(1) / np.float32(kp))))
    theirs = JK.mask_encode(jnp.asarray(x), keep_prob=kp, seed=1, interpret=True)
    assert theirs != port
    np.testing.assert_array_equal(np.flatnonzero(JW.decode(theirs)), [3, 4])


def test_topk_encode_k_ge_d_and_block_slots():
    """k >= d: every value of the one block is selected and the zeros are
    elided. The per-block slots of topk_streams hold each block's selected
    entries in ascending index order with their global index (a selected
    zero is in its slot, not valid); a NaN stops selection and leaves the
    block's slots zero."""
    x = np.random.default_rng(1).standard_normal(96).astype(np.float32)
    want = JW.encode_sparse(np.asarray(JO.block_topk(jnp.asarray(x), k_per_block=128, block=128)))
    assert K.topk_encode(torch.from_numpy(x), k_per_block=128, block=128) == want
    xs = np.zeros(384, np.float32)
    xs[[3, 100, 130, 200, 300]] = [1.0, -4.0, 2.0, np.nan, 0.5]
    idx, sign, magbits, valid = K.topk_streams(torch.from_numpy(xs), 3, 128, "fp32")
    assert idx.tolist() == [[0, 3, 100], [0, 0, 0], [256, 257, 300]]
    assert valid.tolist() == [[0, 1, 1], [0, 0, 0], [0, 0, 1]] and sign.tolist() == [[0, 0, 1], [0] * 3, [0] * 3]
    assert _u32(magbits).tolist() == [[0, 0x3F800000, 0x40800000], [0] * 3, [0, 0, 0x3F000000]]
    want = JW.encode_sparse(np.asarray(JO.block_topk(jnp.asarray(xs), k_per_block=3, block=128)))
    assert K.topk_encode(torch.from_numpy(xs), k_per_block=3, block=128) == want


def test_mask_encode_deterministic_across_paths():
    """Same (seed, worker) => the same bytes from mask_encode and row 3 of
    the per-worker batch; distinct workers give distinct masks; "same" mode
    repeats worker 0's buffer; with seed = msg.seed + msg.round the mask is
    the SEED codec's BERN mask."""
    x = np.random.default_rng(3).standard_normal(512).astype(np.float32)
    xt = torch.from_numpy(x)
    kw = dict(keep_prob=0.25, seed=42)
    b1 = K.mask_encode(xt, worker=3, **kw)
    batch = K.encode_per_worker(xt, n_workers=5, mode="ind", **kw)
    assert batch[3] == b1 and len(set(batch)) == 5
    assert K.encode_per_worker(xt, n_workers=4, mode="same", **kw) == [K.mask_encode(xt, worker=0, **kw)] * 4
    msg = W.SeedMessage(family=W.SeedFamily.BERN, seed=37, round=5, scale=1.0, n=5, worker=3, param=0.25)
    np.testing.assert_array_equal(W.decode(b1) != 0, W.apply_seed(msg, x) != 0)


@pytest.mark.parametrize("mode", ["ind", "same"])
def test_encode_per_worker_vs_reference(mode):
    x = np.random.default_rng(8).standard_normal(300).astype(np.float32)
    want = JK.encode_per_worker(jnp.asarray(x), n_workers=5, keep_prob=0.1, seed=BIG_SEED, mode=mode,
                                block=128, interpret=True)
    got = K.encode_per_worker(torch.from_numpy(x), n_workers=5, keep_prob=0.1, seed=BIG_SEED, mode=mode)
    assert got == want
    assert got == [W.encode_sparse(ops.bernk(torch.from_numpy(x), keep_prob=0.1, seed=BIG_SEED,
                                             worker=0 if mode == "same" else i)) for i in range(5)]


def test_fused_encode_edges_and_checks():
    """Empty and size-one messages; a bad mode, a block above the
    shared-memory limit and k < 1 raise."""
    for port, theirs in (
            (lambda x: K.topk_encode(x, k_per_block=4, block=128),
             lambda x: JK.topk_encode(x, k_per_block=4, block=128, interpret=True)),
            (lambda x: K.mask_encode(x, keep_prob=0.5, seed=1, worker=1),
             lambda x: JK.mask_encode(x, keep_prob=0.5, seed=1, worker=1, interpret=True))):
        assert port(torch.zeros(0)) == JW.encode_sparse(np.zeros(0, np.float32))
        for v in (2.5, 0.0, -0.0):
            x = np.array([v], np.float32)
            assert port(torch.from_numpy(x)) == theirs(jnp.asarray(x))
    assert K.encode_per_worker(torch.zeros(0), n_workers=2, keep_prob=0.5, seed=1) == \
        [JW.encode_sparse(np.zeros(0, np.float32))] * 2
    with pytest.raises(ValueError, match="ind|same"):
        K.encode_per_worker(torch.ones(8), n_workers=2, keep_prob=0.5, seed=1, mode="perm")
    with pytest.raises(ValueError, match="227 KB"):
        K.topk_encode(torch.ones(8), k_per_block=1, block=1 << 20)
    with pytest.raises(ValueError):
        K.topk_encode(torch.ones(8), k_per_block=0, block=8)


# ---------------------------------------------------------------------------
# measure_wire runs against the reference (injected draws)
# ---------------------------------------------------------------------------

N, D = 8, 64
KK = D // N
P = KK / D


@pytest.fixture(scope="module")
def probs():
    jp = JP.generate_problem(n=N, d=D, noise_scale=1.0, seed=0)
    tp = convert.problem_from_numpy(np.asarray(jp.A), np.asarray(jp.x0), np.asarray(jp.L0i),
                                    jp.sigma_A, device="cpu")
    return jp, tp


def _reference_draws(mode, key):
    """The reference step's draws for round key ``key`` (as in
    tests/test_torch_algorithms.py)."""
    k_bern, k_comp = jax.random.split(key)
    coin = bool(jax.random.bernoulli(k_bern, P))
    masks = np.asarray(JM.make_broadcast(mode, N, KK)[0](k_comp, jnp.ones(D))) != 0
    if mode == "same":
        idx = np.flatnonzero(masks[0])
    elif mode == "ind":
        idx = np.stack([np.flatnonzero(m) for m in masks])
    else:
        idx = np.concatenate([np.flatnonzero(m) for m in masks])
    return M.MarinaPDraws(coin=coin, idx=torch.from_numpy(idx.astype(np.int64)))


def _inject(monkeypatch, mode, seed):
    key = jax.random.PRNGKey(seed)
    coins = []

    def draw_round(bcast, p, d, generator, device):
        nonlocal key
        key, sub = jax.random.split(key)
        draws = _reference_draws(mode, sub)
        coins.append(draws.coin)
        return draws

    monkeypatch.setattr(M, "draw_round", draw_round)
    return coins


@pytest.mark.parametrize("mode,mag", [("same", "fp32"), ("ind", "fp32"), ("perm", "fp32"), ("ind", "bf16")])
def test_marina_p_measure_wire_vs_reference(probs, monkeypatch, mode, mag):
    """30 rounds with the reference's draws: hist["wire_bits"] equal per
    round and the wire-matched ledger equal; the port's device path (plain
    versions on the CPU) and host codec give the same bits."""
    jp, tp = probs
    omega = float(N - 1) if mode == "perm" else D / KK - 1.0
    want = JM.run(jp, mode=mode, k=KK, p=P, stepsize=JS.MarinaPPolyak(omega=omega, p=P), T=30,
                  seed=4, measure_wire=True, wire_mag=mag, device_encode=False)
    runs = {}
    for dev in (True, None):
        coins = _inject(monkeypatch, mode, 4)
        runs[dev] = M.run(tp, mode=mode, k=KK, p=P, stepsize=S.MarinaPPolyak(omega=omega, p=P), T=30,
                          seed=4, measure_wire=True, wire_mag=mag, device_encode=dev)
    assert 0 < sum(coins) < 30  # both kinds of round occur
    got = runs[True]
    assert got["wire_bits"] == want["wire_bits"]
    assert got["wire_bits_total"] == want["wire_bits_total"] == got["wire_bits"][-1]
    gl, wl = got["wire_model_ledger"], want["wire_model_ledger"]
    assert (gl.s2w_bits, gl.rounds, gl.model.value_bits) == (wl.s2w_bits, wl.rounds, wl.model.value_bits)
    assert runs[None]["wire_bits"] == got["wire_bits"]  # None on the CPU: the host codec
    assert got["s2w_bits"] == want["s2w_bits"] and got["ledger"].model.value_bits == 64
    assert set(want) - {"final_state", "ledger"} == set(got) - {"final_state", "ledger"}


@pytest.mark.parametrize("comp", ["topk", "block_topk"])
def test_ef21p_measure_wire_vs_reference(probs, comp):
    """Per step from the reference's states (EF21-P free-running is an ulp
    lottery, ROADMAP Queue 3): the port encodes the reference's delta to the
    reference's bytes on both paths; its own delta from the same state gives
    a buffer of the same length with the same index and sign streams. With a
    constant stepsize the free-running 30-round runs also agree (as in
    tests/test_torch_algorithms.py), so their measured bits are equal."""
    jp, tp = probs
    jc, tc = ((JC.TopK(k=KK), C.TopK(k=KK)) if comp == "topk"
              else (JC.BlockTopK(k_per_block=2, block=16), C.BlockTopK(k_per_block=2, block=16)))
    jstep = jax.jit(JE.make_step(jp, jc, JS.Constant(0.05), return_delta=True))
    tstep = E.make_step(tp, tc, S.Constant(0.05), return_delta=True)
    jstate = JE.init(jp.x0)
    for t in range(12):
        tstate = convert.ef21p_state_from_numpy(jstate.x, jstate.w, t, "cpu")
        jstate, jm = jstep(jstate, jax.random.PRNGKey(t))
        _, tm = tstep(tstate, None)
        jdelta = np.asarray(jm["delta"])
        want = JW.encode_sparse(jdelta)
        assert K.sparse_encode(torch.from_numpy(jdelta)) == W.encode_sparse(jdelta) == want
        mine = K.sparse_encode(tm["delta"])
        assert len(mine) == len(want)
        head = W.HEADER_BYTES + 8 + 4 * (W.n_words(int(jm["delta_nnz"]), W.index_width(D))
                                         + W.n_words(int(jm["delta_nnz"]), 1))
        assert mine[:head] == want[:head]  # header, count, index and sign streams
    want = JE.run(jp, jc, JS.Constant(0.05), T=30, measure_wire=True, device_encode=False)
    got = {dev: E.run(tp, tc, S.Constant(0.05), T=30, measure_wire=True, device_encode=dev)
           for dev in (True, False)}
    assert got[True]["wire_bits"] == got[False]["wire_bits"] == want["wire_bits"]
    assert got[True]["wire_model_ledger"].s2w_bits == want["wire_model_ledger"].s2w_bits
    assert got[True]["wire_model_ledger"].model.value_bits == 32


def test_wire_bench_rows_on_cpu():
    """``python -m repro_torch.wire_bench`` at the reference's smoke size on
    the CPU: four rows, the MARINA-P gaps below 5% (DESIGN.md §3.5)."""
    from repro_torch import wire_bench

    rows = wire_bench.parity_rows(d=256, n=4, T=20, device="cpu")
    assert [r[0] for r in rows] == ["marina_p/same", "marina_p/ind", "marina_p/perm", "ef21p/block_topk"]
    assert all(measured >= analytic > 0 for _, analytic, measured, _ in rows)  # headers cost bits
    assert wire_bench.failures(rows) == []
    assert wire_bench.failures([("marina_p/ind", 1.0, 1.05, 5.0)]) == [("marina_p/ind", 5.0)]
