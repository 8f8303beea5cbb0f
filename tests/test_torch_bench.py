"""The port's encode and kernel benchmarks (``python -m
repro_torch.wire_bench``, ``python -m repro_torch.kernel_bench``) at small
sizes on the CPU, where every device path runs the kernels' plain versions.
Their rows must have the reference's names and the host codec's wire sizes,
and the byte-identity row must read 1.0; the numbers themselves mean nothing
here (a CPU time is no device time)."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import wire as JW  # noqa: E402
from repro.kernels import encode as JK  # noqa: E402
from repro_torch import kernel_bench, wire_bench  # noqa: E402
from repro_torch.kernels import runtime  # noqa: E402

D = 1 << 12


def _ref_inputs(d):
    rng = np.random.default_rng(0)
    dense = rng.standard_normal(d).astype(np.float32)
    return dense, np.where(rng.random(d) < 1 / 16, dense, 0.0).astype(np.float32)


def test_throughput_rows_on_cpu():
    """The reference's row names; the host codecs' wire sizes equal the
    reference's on the same inputs (NATURAL: 9 bits a value)."""
    rows = wire_bench.throughput_rows(d=D, device="cpu")
    width = JW.index_width(D)
    assert [r[0] for r in rows] == [
        "sparse/encode", "sparse/decode", "natural/encode", "natural/decode", "dense/encode",
        "dense/decode", f"kernels/pack_bits[w={width}]", f"kernels/unpack_bits[w={width}]"]
    dense, sparse_vec = _ref_inputs(D)
    sizes = {name: nbytes for name, _, nbytes in rows}
    assert sizes["sparse/encode"] == len(JW.encode_sparse(sparse_vec))
    assert sizes["dense/encode"] == len(JW.encode_dense(dense))
    assert sizes["natural/encode"] == len(JW.encode_natural(dense))
    nnz = int(np.count_nonzero(sparse_vec))
    assert sizes[f"kernels/pack_bits[w={width}]"] == 4 * JW.n_words(nnz, width)
    assert all(gbs > 0 for _, gbs, _ in rows)


def test_encode_roofline_rows_on_cpu():
    """host and device modes of each path; each device buffer has the
    length of the reference's fused encoder's on the same input."""
    rows = wire_bench.encode_roofline_rows(d=D, device="cpu")
    assert [r[0] for r in rows] == ["encode/host/sparse", "encode/host/dense", "encode/device/sparse",
                                    "encode/device/topk", "encode/device/mask", "encode/device/dense"]
    dense, sparse_vec = _ref_inputs(D)
    dj = jnp.asarray(dense)
    want = {
        "encode/device/sparse": JK.sparse_encode(jnp.asarray(sparse_vec), interpret=True),
        "encode/device/topk": JK.topk_encode(dj, k_per_block=wire_bench.TOPK_K, block=wire_bench.TOPK_BLOCK,
                                             interpret=True),
        "encode/device/mask": JK.mask_encode(dj, keep_prob=wire_bench.MASK_KEEP, seed=wire_bench.MASK_SEED,
                                             interpret=True),
        "encode/device/dense": JK.dense_encode(dj, interpret=True),
    }
    for name, _, nbytes in rows:
        if name in want:
            assert nbytes == len(want[name]), name


def test_bench_encode_byte_identical_on_cpu():
    rows = wire_bench.bench_encode(d=D, device="cpu")
    assert [r[0] for r in rows] == [
        "encode/host_sparse", "encode/host_dense", "encode/device_sparse", "encode/device_topk",
        "encode/device_mask", "encode/device_dense", "encode/byte_identical"]
    assert rows[-1][2] == 1.0


def test_wire_bench_main_exit_codes(monkeypatch, capsys):
    """main prints the four sections and exits 0; it exits 1 when the
    byte-identity row reads 0, or when a MARINA-P gap reaches 5%."""
    monkeypatch.setattr(wire_bench, "throughput_rows", lambda **kw: [("sparse/encode", 1.0, 10)])
    monkeypatch.setattr(wire_bench, "encode_roofline_rows", lambda **kw: [("encode/host/sparse", 1.0, 10)])
    monkeypatch.setattr(wire_bench, "parity_rows", lambda **kw: [("marina_p/ind", 100.0, 101.0, 1.0)])
    assert wire_bench.main(["--device", "cpu", "--T", "2"]) == 0
    out = capsys.readouterr().out
    for section in ("codec throughput", "fused encode roofline", "encode suite", "measured vs analytic"):
        assert section in out
    monkeypatch.setattr(wire_bench, "byte_identical", lambda *a: False)
    assert wire_bench.main(["--device", "cpu"]) == 1
    monkeypatch.setattr(wire_bench, "byte_identical", lambda *a: True)
    monkeypatch.setattr(wire_bench, "parity_rows", lambda **kw: [("marina_p/ind", 100.0, 105.0, 5.0)])
    assert wire_bench.main(["--device", "cpu"]) == 1


def test_kernel_bench_on_cpu(capsys):
    """Every kernel through its wrapper and as its plain version, at the
    reference's shapes; on the CPU both are the plain version and no kernel
    launches."""
    runtime.reset_launches()
    rows = kernel_bench.bench("cpu")
    assert [r[0] for r in rows] == [f"kernels/{k}/{how}" for k in ("block_topk", "bernk", "rotk_apply", "l1_subgrad")
                                    for how in ("ops", "plain")]
    assert [r[2] for r in rows] == [1 << 16] * 6 + [1024] * 2
    assert all(ms > 0 for _, ms, _ in rows)
    assert sum(runtime.LAUNCHES.values()) == 0
    assert kernel_bench.main(["--device", "cpu"]) == 0
    assert "kernels/rotk_apply/plain" in capsys.readouterr().out


def test_benches_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    with pytest.raises(RuntimeError, match="cuda"):
        kernel_bench.bench()
    with pytest.raises(RuntimeError, match="cuda"):
        wire_bench.bench_encode(d=64)
