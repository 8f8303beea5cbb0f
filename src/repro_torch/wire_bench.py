"""Wire benchmark of the port (counterpart of ``benchmarks/wire_bench.py``).

    PYTHONPATH=src python -m repro_torch.wire_bench [--smoke] [--device cpu] [--T 200]
    PYTHONPATH=src python -m repro_torch.run wire encode [--device cpu]   (the harness)

Four sections, at the reference's full sizes (``--smoke``: its smoke sizes),
on ``--device`` (default the card):

* **codec throughput** (:func:`throughput_rows`, d = 2**20; ``--smoke``
  2**16): encode/decode GB/s of the host codecs (SPARSE at 1/16 density,
  NATURAL over a ``NaturalCompression`` output, DENSE) and of the
  ``pack_bits`` / ``unpack_bits`` kernels, against the dense fp32 payload;
* **fused encode roofline** (:func:`encode_roofline_rows`, d = 2**16;
  ``--smoke`` 2**14): GB/s of each encode path in two modes, ``host`` (the
  numpy codec) and ``device`` (``kernels/encode.py``: the CUDA kernels on a
  card, their plain versions on ``--device cpu``): SPARSE, block-TopK (k = 64
  of 1024), BernK mask (keep 1/16, seed 7) and DENSE;
* **encode suite** (:func:`bench_encode`, d = 2**14): µs per call of the same
  paths and ``encode/byte_identical``, 1.0 iff every fused buffer equals the
  host codec's over the matching op (``ops.block_topk``, ``ops.bernk``);
* **parity** (:func:`parity_rows`): MARINA-P in ``same`` / ``ind`` /
  ``perm`` mode (k = d/n, p = 1/n) and EF21-P with ``BlockTopK(16, 128)``,
  constant stepsize 0.02, run with ``measure_wire=True``; each row is the
  wire-matched analytic ledger's bits per round (value_bits 32), the
  measured bits per round, and their gap, at the reference's setting
  (d=1024, n=4) and at the paper's (d=1000, n=10), T = 200 (``--smoke``: the
  reference's one smoke setting, d=256, n=4, T=30). DESIGN.md §3.5 requires
  a gap below 5% for the three MARINA-P modes.

Times are host-clock medians around calls that end in a device sync. Exits 1
if ``encode/byte_identical`` reads 0 or a MARINA-P gap reaches 5%.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from . import wire
from .core import compressors as C
from .core import ef21p, marina_p, problems, stepsizes
from .kernels import encode as kenc
from .kernel_bench import median_ms
from .kernels import ops, runtime

SETTINGS = ((1024, 4), (1000, 10))  # (d, n): the reference's bench, the paper's Figure 1
# ``--smoke``: the reference's smoke sizes (benchmarks/wire_bench.py: throughput_rows,
# encode_roofline_rows, parity_rows)
SMOKE = {"throughput_d": 1 << 16, "roofline_d": 1 << 14, "settings": ((256, 4),), "T": 30}
FULL = {"throughput_d": 1 << 20, "roofline_d": 1 << 16, "settings": SETTINGS, "T": 200}
GAP_LIMIT_PCT = 5.0
# the reference's fused-encode settings (benchmarks/wire_bench.py::_encode_cases)
TOPK_K, TOPK_BLOCK = 64, 1024
MASK_KEEP, MASK_SEED = 1 / 16, 7


def _seconds(fn, device: torch.device, reps: int = 5) -> float:
    """Median seconds per call, host clock, each call ended by a device sync."""
    return median_ms(fn, reps, device=device) / 1e3


def _inputs(d: int, device: torch.device):
    """The reference's inputs, made with numpy from seed 0: a dense fp32
    vector and a 1/16-dense one, on the host and on ``device``."""
    rng = np.random.default_rng(0)
    dense = rng.standard_normal(d).astype(np.float32)
    sparse_vec = np.where(rng.random(d) < 1 / 16, dense, 0.0).astype(np.float32)
    return dense, sparse_vec, torch.from_numpy(dense).to(device), torch.from_numpy(sparse_vec).to(device)


def throughput_rows(*, d: int = 1 << 20, device="cuda"):
    """[(name, dense-payload GB/s, wire bytes)]: the host codecs' encode and
    decode, then the pack/unpack kernels over the SPARSE index stream."""
    dev = runtime.resolve_device(device)
    dense, sparse_vec, dense_t, _ = _inputs(d, dev)
    u = C.NaturalCompression().draw(d, torch.Generator().manual_seed(0), dev)
    nat = C.NaturalCompression()(dense_t, u).cpu().numpy()
    payload_gb = dense.nbytes / 1e9
    rows = []
    for name, enc_fn in (
        ("sparse/encode", lambda: wire.encode_sparse(sparse_vec)),
        ("natural/encode", lambda: wire.encode_natural(nat)),
        ("dense/encode", lambda: wire.encode_dense(dense)),
    ):
        buf = enc_fn()
        rows.append((name, payload_gb / _seconds(enc_fn, dev), len(buf)))
        rows.append((name.replace("encode", "decode"),
                     payload_gb / _seconds(lambda b=buf: wire.decode(b), dev), len(buf)))
    width = wire.index_width(d)
    idx = torch.from_numpy(np.flatnonzero(sparse_vec).astype(np.int32)).to(dev)
    packed = ops.pack_bits(idx, width)
    pack_gb = idx.numel() * 4 / 1e9
    rows.append((f"kernels/pack_bits[w={width}]", pack_gb / _seconds(lambda: ops.pack_bits(idx, width), dev),
                 packed.numel() * 4))
    rows.append((f"kernels/unpack_bits[w={width}]",
                 pack_gb / _seconds(lambda: ops.unpack_bits(packed, width, idx.numel()), dev), idx.numel() * 4))
    return rows


def _encode_cases(dense_t, sparse_t):
    """(name, call) of each device encode path, at the reference's settings."""
    return (
        ("sparse", lambda: kenc.sparse_encode(sparse_t)),
        ("topk", lambda: kenc.topk_encode(dense_t, k_per_block=TOPK_K, block=TOPK_BLOCK)),
        ("mask", lambda: kenc.mask_encode(dense_t, keep_prob=MASK_KEEP, seed=MASK_SEED)),
        ("dense", lambda: kenc.dense_encode(dense_t)),
    )


def encode_roofline_rows(*, d: int = 1 << 16, device="cuda"):
    """[(name, dense-payload GB/s, wire bytes)] of each encode path in the
    ``host`` and ``device`` modes."""
    dev = runtime.resolve_device(device)
    dense, sparse_vec, dense_t, sparse_t = _inputs(d, dev)
    payload_gb = dense.nbytes / 1e9
    cases = [(f"encode/host/{name}", fn) for name, fn in (
        ("sparse", lambda: wire.encode_sparse(sparse_vec)), ("dense", lambda: wire.encode_dense(dense)))]
    cases += [(f"encode/device/{name}", fn) for name, fn in _encode_cases(dense_t, sparse_t)]
    return [(name, payload_gb / _seconds(fn, dev, reps=3), len(fn())) for name, fn in cases]


def byte_identical(dense_t, sparse_t) -> bool:
    """Every fused device buffer equals the host codec's over the matching
    op's output (the reference's ``encode/byte_identical`` row)."""
    return (
        kenc.sparse_encode(sparse_t) == wire.encode_sparse(sparse_t)
        and kenc.dense_encode(dense_t) == wire.encode_dense(dense_t)
        and kenc.topk_encode(dense_t, k_per_block=TOPK_K, block=TOPK_BLOCK)
        == wire.encode_sparse(ops.block_topk(dense_t, k_per_block=TOPK_K, block=TOPK_BLOCK))
        and kenc.mask_encode(dense_t, keep_prob=MASK_KEEP, seed=MASK_SEED)
        == wire.encode_sparse(ops.bernk(dense_t, keep_prob=MASK_KEEP, seed=MASK_SEED))
    )


def bench_encode(*, d: int = 1 << 14, device="cuda"):
    """[(name, µs per call, dense-payload GB/s)] of the host codec and each
    device encode path, then ``encode/byte_identical`` (µs of the check, 1.0
    or 0.0)."""
    dev = runtime.resolve_device(device)
    dense, sparse_vec, dense_t, sparse_t = _inputs(d, dev)
    payload_gb = dense.nbytes / 1e9
    cases = [("encode/host_sparse", lambda: wire.encode_sparse(sparse_vec)),
             ("encode/host_dense", lambda: wire.encode_dense(dense))]
    cases += [(f"encode/device_{name}", fn) for name, fn in _encode_cases(dense_t, sparse_t)]
    rows = []
    for name, fn in cases:
        dt = _seconds(fn, dev, reps=3)
        rows.append((name, dt * 1e6, payload_gb / dt))
    t0 = time.perf_counter()
    same = byte_identical(dense_t, sparse_t)
    rows.append(("encode/byte_identical", (time.perf_counter() - t0) * 1e6, 1.0 if same else 0.0))
    return rows


def parity_rows(*, d: int, n: int, T: int = 200, device="cuda"):
    """[(name, analytic bits/round, measured bits/round, gap %)] for the four runs."""
    prob = problems.generate_problem(n=n, d=d, noise_scale=1.0, seed=0, device=device)
    ss = stepsizes.Constant(gamma=0.02)
    hists = {
        f"marina_p/{mode}": marina_p.run(prob, mode=mode, k=d // n, p=1.0 / n, stepsize=ss, T=T,
                                         measure_wire=True)
        for mode in ("same", "ind", "perm")
    }
    hists["ef21p/block_topk"] = ef21p.run(prob, C.BlockTopK(k_per_block=16, block=128), ss, T=T,
                                          measure_wire=True)
    rows = []
    for name, h in hists.items():
        a, w = h["wire_model_ledger"].s2w_bits, h["wire_bits_total"]
        rows.append((name, a / T, w / T, 100.0 * (w - a) / a))
    return rows


def bench(tracker=None, *, device="cuda"):
    """``repro_torch.run`` adapter (the reference's ``wire`` suite): rows
    ``wire/{sparse_encode,sparse_decode,dense_encode}`` of the host codec at
    d = 2**16, (name, µs per call, dense-payload GB/s); with a tracker, also
    the smoke-size (d=256, n=4, T=30) measured-vs-analytic parity per run as
    ``parity/<run>/{bits_per_round_analytic,bits_per_round_wire,diff_pct}``."""
    dev = runtime.resolve_device(device)
    dense, sparse_vec, _, _ = _inputs(1 << 16, dev)
    rows = []
    for name, fn in (
        ("wire/sparse_encode", lambda: wire.encode_sparse(sparse_vec)),
        ("wire/sparse_decode", lambda b=wire.encode_sparse(sparse_vec): wire.decode(b)),
        ("wire/dense_encode", lambda: wire.encode_dense(dense)),
    ):
        dt = _seconds(fn, dev)
        rows.append((name, dt * 1e6, round(dense.nbytes / 1e9 / dt, 3)))
    if tracker is not None:
        for name, analytic, measured, pct in parity_rows(d=256, n=4, T=30, device=dev):
            tracker.log({f"parity/{name}": {
                "bits_per_round_analytic": analytic,
                "bits_per_round_wire": measured,
                "diff_pct": pct}})
    return rows


def failures(rows) -> list:
    return [(name, pct) for name, _, _, pct in rows
            if name.startswith("marina_p/") and not abs(pct) < GAP_LIMIT_PCT]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's smoke sizes: throughput at d=2**16, the encode roofline at "
                         "2**14, parity at d=256 n=4 T=30")
    ap.add_argument("--T", type=int, default=None,
                    help=f"parity rounds (default {FULL['T']}, or {SMOKE['T']} with --smoke; "
                         "--T wins over --smoke)")
    args = ap.parse_args(argv)
    sizes = SMOKE if args.smoke else FULL
    T = args.T if args.T is not None else sizes["T"]
    where = f"on {args.device}"
    d = sizes["throughput_d"]
    print(f"== codec throughput, d=2**{d.bit_length() - 1} {where} (dense-payload GB/s) ==")
    for name, gbs, nbytes in throughput_rows(d=d, device=args.device):
        print(f"{name:32s} {gbs:8.3f} GB/s   ({nbytes} wire bytes)")
    d = sizes["roofline_d"]
    print(f"\n== fused encode roofline, d=2**{d.bit_length() - 1} {where} (dense-payload GB/s) ==")
    for name, gbs, nbytes in encode_roofline_rows(d=d, device=args.device):
        print(f"{name:32s} {gbs:8.3f} GB/s   ({nbytes} wire bytes)")
    print(f"\n== encode suite, d=2**14 {where} (us per call, GB/s) ==")
    enc = bench_encode(device=args.device)
    for name, us, derived in enc:
        print(f"{name:32s} {us:10.1f} us   {derived:.4f}")
    bad = []
    if enc[-1][2] != 1.0:
        bad.append("encode/byte_identical = 0: a device buffer differs from the host codec's")
    for d, n in sizes["settings"]:
        t0 = time.perf_counter()
        rows = parity_rows(d=d, n=n, T=T, device=args.device)
        print(f"\n== d={d} n={n} T={T} {where}: measured vs analytic bits/round "
              f"({time.perf_counter() - t0:.1f} s)")
        for name, analytic, measured, pct in rows:
            print(f"{name:20s} analytic={analytic:12.1f}  wire={measured:12.1f}  gap={pct:+.3f}%")
        bad += [(d, n, name, pct) for name, pct in failures(rows)]
    if bad:
        print(f"FAILURES (byte identity, or a MARINA-P gap >= {GAP_LIMIT_PCT}%): {bad}", file=sys.stderr)
        return 1
    print(f"byte identity OK; parity OK: every MARINA-P mode within {GAP_LIMIT_PCT}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
