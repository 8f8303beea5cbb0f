"""The port's wire codecs (``repro_torch.wire``: numpy only, no ml_dtypes)
against the reference's ``repro.wire``, byte for byte.

Every comparison is exact: buffers as bytes, decoded vectors as fp32 bit
patterns (NaN payloads included), errors by their type.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import ml_dtypes  # noqa: E402  (comes with JAX; the tests, not the port, use it)

from repro import wire as JW  # noqa: E402
from repro.core import compressors as JC  # noqa: E402
from repro.kernels import randk as JR  # noqa: E402
from repro_torch import wire as W  # noqa: E402
from repro_torch.core import compressors as C  # noqa: E402
from repro_torch.kernels import randk as R  # noqa: E402
from repro_torch.wire import sparse as S  # noqa: E402

MAGS = ["fp32", "fp16", "bf16"]

# tests/test_encode_diff.py's IEEE corners (quiet NaN, +-inf, -0.0, fp32
# denormals, a bf16-rounding victim, normals), plus quiet and signalling NaNs
# of both signs with payloads
WEIRD = np.array([np.nan, np.inf, -np.inf, -0.0, 1e-42, -1e-42, 0.0, 6.1e-39,
                  1.0000001, -3.5, 65504.0, 2.0], dtype=np.float32)
NANS = np.array([0x7FC00000, 0xFFC00000, 0x7F812345, 0xFF800001, 0xFFC00001],
                dtype=np.uint32).view(np.float32)
EDGE = np.concatenate([WEIRD, NANS])


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def _sparse_vec(d, nnz, seed=0):
    rng = np.random.default_rng(seed)
    x = np.zeros(d, np.float32)
    if nnz:
        idx = rng.choice(d, size=min(nnz, d), replace=False)
        x[idx] = rng.standard_normal(idx.size).astype(np.float32)
    return x


def _random_bits(n, seed):
    """fp32 values with uniformly random bit patterns: every NaN payload,
    denormals, infs and both zeros occur."""
    return np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint64) \
        .astype(np.uint32).view(np.float32)


CASES = {
    "sparse_1000": lambda: _sparse_vec(1000, 64, seed=1),
    "full_1024": lambda: _sparse_vec(1024, 1024, seed=2),
    "tiny_7": lambda: _sparse_vec(7, 3, seed=3),
    "empty_129": lambda: _sparse_vec(129, 0),
    "one": lambda: _sparse_vec(1, 1, seed=4),
    "edge": lambda: EDGE,
    "random_bits": lambda: _random_bits(4096, seed=5),
}


# ---------------------------------------------------------------------------
# bitstream
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", [1, 4, 7, 8, 9, 10, 13, 16, 17, 31, 32])
def test_bitstream_matches_reference(width):
    rng = np.random.default_rng(width)
    for n in (0, 1, 31, 32, 33, 777):
        vals = rng.integers(0, 2**width, n, dtype=np.uint64).astype(np.uint32)
        words = W.pack_u32(vals, width)
        assert W.to_bytes(words) == JW.to_bytes(JW.pack_u32(vals, width))
        np.testing.assert_array_equal(W.unpack_u32(words, width, n), vals)
        np.testing.assert_array_equal(W.unpack_u32(words, width, n), JW.unpack_u32(words, width, n))
        assert W.n_words(n, width) == JW.n_words(n, width) == words.size


# ---------------------------------------------------------------------------
# SPARSE and DENSE: encode bytes and decode bits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mag", MAGS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_sparse_and_dense_match_reference(case, mag):
    """Same bytes as the reference's host codec, and decodes bit-equal to
    the reference's decode of the same buffer."""
    x = CASES[case]()
    for enc_port, enc_ref in ((W.encode_sparse, JW.encode_sparse), (W.encode_dense, JW.encode_dense)):
        buf = enc_port(x, mag=mag)
        assert buf == enc_ref(x, mag=mag), enc_port.__name__
        np.testing.assert_array_equal(_bits(W.decode(buf)), _bits(JW.decode(buf)))
    if mag == "fp32":  # fp32 round-trips exactly; -0.0 is elided by SPARSE
        np.testing.assert_array_equal(_bits(W.decode(W.encode_dense(x))), _bits(x))
        want = np.where(_bits(x) == 0x80000000, np.float32(0), x)
        np.testing.assert_array_equal(_bits(W.decode(W.encode_sparse(x))), _bits(want))


def test_sparse_accepts_tensors():
    x = _sparse_vec(300, 20, seed=6)
    assert W.encode_sparse(torch.from_numpy(x)) == JW.encode_sparse(x)
    assert W.encode_dense(torch.from_numpy(x), mag="bf16") == JW.encode_dense(x, mag="bf16")


def test_wire_dtype_conversions_are_numpy_and_ml_dtypes():
    """The bitwise conversions equal numpy's fp16 and ml_dtypes' bf16 casts
    where the test runs (2**20 random patterns plus the NaN corners; every fp16
    pattern for the widening); the port itself never casts."""
    b = np.concatenate([_bits(_random_bits(1 << 20, seed=7)), _bits(EDGE)])
    f = b.view(np.float32)
    with np.errstate(all="ignore"):
        want16 = f.astype(np.float16).view(np.uint16)
        want_bf = f.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(S.f32_to_f16_bits(b), want16)
    np.testing.assert_array_equal(S.f32_to_bf16_bits(b), want_bf)
    h = np.arange(1 << 16, dtype=np.uint32)
    np.testing.assert_array_equal(
        S.f16_to_f32_bits(h), h.astype(np.uint16).view(np.float16).astype(np.float32).view(np.uint32))
    np.testing.assert_array_equal(
        S.from_wire_bits(h, W.MagDType.BF16),
        h.astype(np.uint16).view(ml_dtypes.bfloat16).astype(np.float32).view(np.uint32))
    # the NaN rules of the wire, spelled out
    assert [hex(v) for v in S.f32_to_f16_bits(_bits(NANS[:4]))] == ["0x7e00", "0xfe00", "0x7c09", "0xfc01"]
    assert [hex(v) for v in S.f32_to_bf16_bits(_bits(NANS[:4]))] == ["0x7fc0", "0xffc0", "0x7fc0", "0xffc0"]


# ---------------------------------------------------------------------------
# NATURAL and SEED
# ---------------------------------------------------------------------------


def test_natural_matches_reference():
    rng = np.random.default_rng(8)
    x = (np.sign(rng.standard_normal(777)) * 2.0 ** rng.integers(-30, 30, 777)).astype(np.float32)
    x[::11] = 0.0
    buf = W.encode_natural(x)
    assert buf == JW.encode_natural(x)
    np.testing.assert_array_equal(_bits(W.decode(buf)), _bits(JW.decode(buf)))
    np.testing.assert_array_equal(W.decode(buf), x)


@pytest.mark.parametrize("seed,worker", [(0, 0), (7, 3), (2**33 + 5, 9)])
def test_hash_uniform_bit_equal(seed, worker):
    idx = np.arange(1 << 16, dtype=np.uint32)
    want = np.asarray(JR.hash_uniform(idx, seed, worker))
    got = R.hash_uniform(idx, seed, worker)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("family,param", [("BERN", 0.25), ("BERN", 0.9), ("ROTK", 3.0), ("ROTK", 0.0)])
def test_seed_bern_rotk_match_reference(family, param):
    d, n = 96, 4
    delta = np.random.default_rng(9).standard_normal(d).astype(np.float32)
    for w in range(n):
        msg = W.SeedMessage(family=W.SeedFamily[family], seed=11, round=5, scale=0.5, n=n,
                            worker=w, param=param)
        jmsg = JW.SeedMessage(family=JW.SeedFamily[family], seed=11, round=5, scale=0.5, n=n,
                              worker=w, param=param)
        buf = W.encode_seed(msg, d)
        assert buf == JW.encode_seed(jmsg, d) and len(buf) == W.HEADER_BYTES + 28
        assert W.decode_seed(buf, W.HEADER_BYTES, d) == W.SeedMessage(
            **{k: v for k, v in vars(JW.decode_seed(buf, JW.HEADER_BYTES, d)).items()})
        np.testing.assert_array_equal(_bits(W.decode(buf, delta=delta)),
                                      _bits(JW.decode(buf, delta=delta)))


# (d, n, seed, round): every d with n in {1, 3, 10}; d = 1626 is the first
# size whose shuffle takes two sort rounds; at d = 2**16 seed 1 / round 0 and
# seed 2**32 - 1 / round 0 draw two equal 32-bit sort keys (a tie the stable
# sort must break by position); seeds from 2**31 up come off the wire as u32
PERM_CASES = [
    (d, n, seed, rnd)
    for i, (d, n) in enumerate((d, n) for d in (10, 64, 1000, 1626, 2**16) for n in (1, 3, 10))
    for seed, rnd in [((0, 0), (7, 5), (2**31 + 12345, 3), (2**32 - 1, 0), (1, 0))[i % 5]]
]


@pytest.mark.parametrize("d,n,seed,rnd", PERM_CASES)
def test_seed_perm_decode_matches_reference(d, n, seed, rnd):
    """PERM rebuilds the reference's jax.random permutation bit for bit (the
    port's numpy threefry2x32 / split / fold_in / _shuffle, JAX 0.9.0)."""
    delta = np.random.default_rng(d + n).standard_normal(d).astype(np.float32)
    for w in sorted({0, 1 % n, n - 1, n + 2}):  # n + 2: the start is clamped, as dynamic_slice does
        msg = W.SeedMessage(W.SeedFamily.PERM, seed, rnd, 0.75, n, w)
        buf = W.encode_seed(msg, d)
        assert buf == JW.encode_seed(JW.SeedMessage(JW.SeedFamily.PERM, seed, rnd, 0.75, n, w), d)
        np.testing.assert_array_equal(_bits(W.decode(buf, delta=delta)),
                                      _bits(JW.decode(buf, delta=delta)))


@pytest.mark.parametrize("seed", [0, 42, 2**31 + 5, 2**32 - 1, 2**40 + 3, -1])
def test_jax_random_port_matches_jax(seed):
    """repro_torch.core.jax_random against jax.random itself: PRNGKey, split,
    fold_in, 32-bit bits and permutation (one and two shuffle rounds)."""
    import jax

    from repro_torch.core import jax_random as JRP

    key = jax.random.PRNGKey(seed)
    mine = JRP.PRNGKey(seed)
    np.testing.assert_array_equal(mine, np.asarray(key))
    np.testing.assert_array_equal(JRP.split(mine, 7), np.asarray(jax.random.split(key, 7)))
    np.testing.assert_array_equal(JRP.split(mine), np.asarray(jax.random.split(key)))
    for data in (0, 3, 2**31 + 1, 2**32 - 1):
        np.testing.assert_array_equal(JRP.fold_in(mine, data), np.asarray(jax.random.fold_in(key, data)))
    # the partitionable scheme of JAX 0.9.0: split(key, n)[i] == fold_in(key, i)
    np.testing.assert_array_equal(JRP.split(mine, 4)[3], JRP.fold_in(mine, 3))
    np.testing.assert_array_equal(JRP.random_bits(mine, 999),
                                  np.asarray(jax.random.bits(key, (999,), np.uint32)))
    for d in (1, 2, 17, 1625, 1626, 4099):
        got, want = JRP.permutation(mine, d), np.asarray(jax.random.permutation(key, d))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert [JRP.shuffle_rounds(d) for d in (1, 1625, 1626, 2**16)] == [0, 1, 2, 2]


def test_jax_random_seed_outside_int64_raises_like_jax():
    import jax

    from repro_torch.core import jax_random as JRP

    with pytest.raises(OverflowError):
        jax.random.PRNGKey(2**64)
    with pytest.raises(OverflowError):
        JRP.PRNGKey(2**64)


def test_seed_requires_delta():
    buf = W.encode_seed(W.SeedMessage(W.SeedFamily.BERN, 0, 0, 1.0, 1, 0, 0.5), 16)
    with pytest.raises(ValueError):
        W.decode(buf)


# ---------------------------------------------------------------------------
# typed errors (the cases of tests/test_wire.py)
# ---------------------------------------------------------------------------


def _raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return type(e).__name__
    return None


MAKERS = {
    "sparse": lambda wire: wire.encode_sparse(_sparse_vec(100, 10)),
    "sparse_fp16": lambda wire: wire.encode_sparse(_sparse_vec(100, 10), mag="fp16"),
    "dense": lambda wire: wire.encode_dense(np.ones(33, np.float32)),
    "natural": lambda wire: wire.encode_natural(np.zeros(50, np.float32)),
    "seed": lambda wire: wire.encode_seed(wire.SeedMessage(wire.SeedFamily.BERN, 0, 0, 1.0, 2, 0, 0.5), 64),
}


@pytest.mark.parametrize("make", sorted(MAKERS))
def test_truncated_messages_raise_as_reference(make):
    buf = MAKERS[make](W)
    assert buf == MAKERS[make](JW)
    delta = np.ones(64, np.float32)
    for cut in (4, W.HEADER_BYTES + 2, len(buf) - 1):
        assert _raised(lambda: W.decode(buf[:cut], delta=delta)) == "TruncatedFrame"
        assert _raised(lambda: JW.decode(buf[:cut], delta=delta)) == "TruncatedFrame"


def test_corrupt_messages_raise_as_reference():
    x = np.zeros(100, np.float32)
    x[5] = 1.0
    good = W.encode_sparse(x)
    bad_index = bytearray(good)
    bad_index[W.HEADER_BYTES + 8] = 127  # first 7-bit index -> 127 >= d
    bad_mag = bytearray(good)
    bad_mag[W.HEADER_BYTES] = 9
    bad_count = bytearray(good)
    bad_count[W.HEADER_BYTES + 4] = 200  # count 200 > d
    bad_magic = bytearray(good)
    bad_magic[0] ^= 0xFF
    bad_version = bytearray(good)
    bad_version[2] = 7
    bad_codec = bytearray(good)
    bad_codec[3] = 99
    dense_mag = bytearray(W.encode_dense(x))
    dense_mag[W.HEADER_BYTES] = 5
    for buf in (bad_index, bad_mag, bad_count, bad_magic, bad_version, bad_codec, dense_mag,
                b"\x00" * 16):
        got = _raised(lambda: W.decode(bytes(buf)))
        assert got == "CorruptFrame" and got == _raised(lambda: JW.decode(bytes(buf)))
    assert issubclass(W.CorruptFrame, W.WireError) and issubclass(W.TruncatedFrame, ValueError)
    assert _raised(lambda: W.from_bytes(b"\x00" * 6)) == "TruncatedFrame"


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


PAIRS = {
    "identity": (lambda: C.Identity(), lambda: JC.Identity()),
    "topk": (lambda: C.TopK(k=32), lambda: JC.TopK(k=32)),
    "block_topk": (lambda: C.BlockTopK(8, 128), lambda: JC.BlockTopK(8, 128)),
    "randk": (lambda: C.RandK(k=50), lambda: JC.RandK(k=50)),
    "permk": (lambda: C.PermK(n=4), lambda: JC.PermK(n=4)),
    "rotk": (lambda: C.RotK(n=4), lambda: JC.RotK(n=4)),
    "bernk": (lambda: C.BernK(k=50), lambda: JC.BernK(k=50)),
    "natural": (lambda: C.NaturalCompression(), lambda: JC.NaturalCompression()),
    "scaled_unbiased": (lambda: C.ScaledUnbiased(inner=C.RandK(k=50)),
                        lambda: JC.ScaledUnbiased(inner=JC.RandK(k=50))),
}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_registry_matches_reference(name):
    """codec_for and wire.encode of every ported family: the reference's
    codec and bytes, for numpy input and CPU tensors, device path or not
    (NATURAL is encoded on the host before any device path is considered)."""
    d = 600
    port, jref = PAIRS[name][0](), PAIRS[name][1]()
    assert int(W.codec_for(port)) == int(JW.codec_for(jref))
    x = _sparse_vec(d, 40, seed=11)
    for mag in MAGS:
        buf = W.encode(x, port, mag=mag)
        assert buf == JW.encode(x, jref, mag=mag, device_encode=False)
        assert W.encode(torch.from_numpy(x), port, mag=mag) == buf  # CPU tensor: host codec
        assert W.encode(torch.from_numpy(x), port, mag=mag, device_encode=True) == buf
        assert tuple(W.peek(buf)) == tuple(JW.peek(buf))
        assert W.measured_bits(buf) == JW.measured_bits(buf) == 8 * len(buf)


def test_encode_of_a_natural_output():
    """wire.encode of a NaturalCompression output takes the NATURAL codec
    (9 bits a value) even where the device path is forced: the reference's
    order. The port's output round-trips exactly."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(777).astype(np.float32))
    comp = C.NaturalCompression()
    q = comp(x, comp.draw(777, torch.Generator().manual_seed(6), "cpu"))
    for dev in (True, False, None):
        buf = W.encode(q, comp, device_encode=dev)
        assert W.peek(buf)[0] == W.CodecID.NATURAL
        assert buf == JW.encode(q.numpy(), JC.NaturalCompression())
        np.testing.assert_array_equal(_bits(W.decode(buf)), _bits(q.numpy()))
    assert 8 * len(buf) - 9 * 777 <= 8 * W.HEADER_BYTES + 32  # header + word padding
