#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written kernels from ``src/repro_torch/csrc`` and runs:

(a) each kernel against its plain PyTorch version on the card, at the main
    path's shapes and at edge cases (l1_subgrad within rtol 1e-5 / atol 1e-4
    on inputs whose A x stays 1e-4 * ||A x||_inf away from 0, so that no sign
    may legitimately flip; block_topk bit-exact, incl. bf16 and inf/NaN/-0.0/
    denormal payloads), and two identical l1_subgrad launches bit-equal;
(b) the main path: ``repro_torch.fig1.run_suite(d=1000, n=10, T=400)`` (EF21-P/
    TopK and MARINA-P same/ind/perm, constant and Polyak stepsizes) and the
    port's quickstart at a 2e6-bit budget, with the launch counters zeroed
    just before and read just after; both kernels must have launched;
(c) the same 8 runs at T=20 on the CPU port against the card, same seeds:
    equal s2w_bits; MARINA-P's per-round f_x within rtol 1e-4; EF21-P's
    within rtol 1e-4 per step from the card's state of each round (its
    free-running TopK trajectory follows the last bits of gamma*g, see the
    note in the code, and is only reported); and the card's T=20 Polyak runs
    bit-equal to the first 20 rounds of (b) (their stepsize does not depend
    on T);
(d) each kernel's median time (CUDA events, L2 flushed between launches),
    its plain version's and the library call's, beside its lower bound;
(e) the wire kernels (pack_bits/unpack_bits, sparse_streams, dense_bits)
    against their plain versions on the card, all exact: pack/unpack at
    widths {1, 4, 7, 8, 10, 13, 16, 32} and N in {1, 31, 32, 33, 1000, 4097}
    (also against wire.bitstream.pack_u32, and unpack(pack) = identity), the
    stream kernels on random, random-bit-pattern and IEEE-corner inputs in
    fp32/fp16/bf16, and the device buffers of sparse_encode / dense_encode /
    encode_rows equal to the host codec's byte for byte, NaN payloads
    included;
(f) the wire path: ``marina_p.run(measure_wire=True)`` same/ind/perm with
    Polyak, T=400, and ``ef21p.run(measure_wire=True)`` with TopK and
    BlockTopK(16, 128), with the counters zeroed just before and read just
    after: pack_bits, sparse_streams and dense_bits must have launched
    (unpack_bits is on no run's path: nothing decodes there). Each run's
    hist["wire_bits"] must equal the same run with the host codec; then the
    first 20 rounds of each MARINA-P mode, stepped by hand, with device and
    host buffers compared byte for byte;
(g) the CPU port against the card at T=20: MARINA-P's wire_bits per round
    and wire-matched ledger equal (EF21-P's reported);
(h) ``repro_torch.wire_bench`` on the card (d=1024 n=4 and d=1000 n=10,
    T=200): every MARINA-P measured-vs-analytic gap below 5% (DESIGN §3.5);
(i) the wire kernels' times at the path's shapes and at d = 2**20, with
    bounds, launches per round, plain and library times, the host codec's
    time per message, and µs per round of MARINA-P ind with measure_wire,
    device encode against host encode.

Prints a ``{"kernels": [...]}`` JSON line, then the card's name and power
limit, then ``{"ok": true, "device": {...}}`` as the last line. Exits non-zero,
printing no result, where CUDA is unavailable or the port is missing.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet; valid at the full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

L1_RTOL, L1_ATOL = 1e-5, 1e-4
TRAJ_RTOL = 1e-4
WIDTHS = (1, 4, 7, 8, 10, 13, 16, 32)
MAGS = ("fp32", "fp16", "bf16")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def l1_inputs(np, n: int, d: int, seed: int, shared: bool = False):
    """A [n, d, d], X [n, d] (fp32) with every |(A x)_r| >= 1e-4 ||A x||_inf:
    rows too close to 0 are pushed away along x, exactly in float64.
    ``shared``: one point x for all workers (every row of X equal)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, d, d))
    X = np.repeat(rng.standard_normal((1, d)), n, axis=0) if shared else rng.standard_normal((n, d))
    y = np.einsum("nij,nj->ni", A, X)
    scale = np.abs(y).max(axis=1, keepdims=True)
    bad = np.abs(y) < 2e-4 * scale
    push = np.where(y >= 0, 1.0, -1.0) * 4e-4 * scale - y
    A += np.where(bad, push, 0.0)[..., None] * (X / np.sum(X**2, axis=1, keepdims=True))[:, None, :]
    A, X = A.astype(np.float32), X.astype(np.float32)
    y32 = np.einsum("nij,nj->ni", A.astype(np.float64), X.astype(np.float64))
    if not (np.abs(y32) >= 1e-4 * np.abs(y32).max(axis=1, keepdims=True)).all():
        fail("l1_subgrad inputs: could not keep A x away from 0")
    return A, X


def edge_vector(np, torch, d: int = 128):
    """The Pallas-quirk vector: inf, NaN-free tail; plus -0.0 and denormals."""
    x = np.zeros(d, np.float32)
    x[:6] = [1.0, np.inf, 3.0, -2.0, 0.5, 7.0]
    x[10:16] = [-0.0, 1e-42, -1e-42, 6.1e-39, 2e-45, -3.0]
    return torch.from_numpy(x)


def wire_edge(np):
    """tests/test_encode_diff.py's WEIRD plus quiet and signalling NaNs of
    both signs (0x7FC00000, 0xFFC00000, 0x7F812345, 0xFF800001)."""
    weird = np.array([np.nan, np.inf, -np.inf, -0.0, 1e-42, -1e-42, 0.0, 6.1e-39,
                      1.0000001, -3.5, 65504.0, 2.0], dtype=np.float32)
    nans = np.array([0x7FC00000, 0xFFC00000, 0x7F812345, 0xFF800001], dtype=np.uint32)
    return np.concatenate([weird, nans.view(np.float32)])


def bits_equal(torch, a, b) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16, torch.float16: torch.int16}[a.dtype]
    return torch.equal(a.view(view), b.view(view))


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def median_ms(torch, fn, reps: int = 30, flush=None) -> float:
    """Median of ``reps`` single-call times with CUDA events, after 3 warm-up
    calls; ``flush()`` (outside the timed region) evicts L2 first."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


# ---------------------------------------------------------------------------
# the wire path (phases e-i)
# ---------------------------------------------------------------------------


def int_err(ref, got, want) -> int:
    """max |got - want| over uint32 bit patterns (0 when bit-equal)."""
    if got.shape != want.shape:
        return 2**32
    return int((ref.u32(got) - ref.u32(want)).abs().max()) if got.numel() else 0


def wire_kernels_vs_plain(np, torch, dev):
    """(e): every wire kernel against its plain version on the card, and the
    device buffers against the host codec. Returns {kernel: max int error}."""
    from repro_torch import wire
    from repro_torch.kernels import encode as kenc
    from repro_torch.kernels import ops, ref

    err = dict.fromkeys(("pack_bits", "unpack_bits", "sparse_streams", "dense_bits"), 0)
    rng = np.random.default_rng(2)
    for width in WIDTHS:
        for n in (1, 31, 32, 33, 1000, 4097):
            v = rng.integers(0, 2**width, n, dtype=np.uint64).astype(np.uint32)
            v[0] = 2**width - 1  # every bit of w set once
            vals = torch.from_numpy(v.view(np.int32)).to(dev)
            words = ops.pack_bits(vals, width)
            back = ops.unpack_bits(words, width, n)
            want_w = ref.pack_bits_ref(vals, width)
            want_b = ref.unpack_bits_ref(want_w, width, n)
            torch.cuda.synchronize()
            err["pack_bits"] = max(err["pack_bits"], int_err(ref, words, want_w))
            err["unpack_bits"] = max(err["unpack_bits"], int_err(ref, back, want_b))
            if not (torch.equal(words, want_w) and torch.equal(back, want_b) and torch.equal(back, vals)):
                fail(f"(e) pack/unpack width={width} n={n}: kernel != plain or unpack(pack) != identity")
            if words.cpu().numpy().tobytes() != wire.to_bytes(wire.pack_u32(v, width)):
                fail(f"(e) pack_bits width={width} n={n}: kernel != wire.bitstream.pack_u32")
        # rows with row strides, as encode_rows packs the streams into one buffer
        rows = torch.from_numpy(rng.integers(0, 2**width, (10, 1001), dtype=np.uint64)
                                .astype(np.uint32).view(np.int32)).to(dev)[:, :1000]
        out = torch.zeros((10, 3 + wire.n_words(1000, width)), dtype=torch.int32, device=dev)
        ops.pack_bits(rows, width, out=out[:, 1:-2])
        if not (torch.equal(out[:, 1:-2], ref.pack_bits_ref(rows, width))
                and not out[:, 0].any() and not out[:, -2:].any()):
            fail(f"(e) pack_bits width={width}: batched rows with strides != plain")

    edge = wire_edge(np)
    X = np.where(rng.random((10, 1000)) < 0.1, rng.standard_normal((10, 1000)), 0.0).astype(np.float32)
    X[0, :edge.size] = edge
    X[1] = rng.integers(0, 2**32, 1000, dtype=np.uint64).astype(np.uint32).view(np.float32)
    X[2, 100:900] = 0.0
    X[2, :edge.size] = -edge
    Xd = torch.from_numpy(X).to(dev)
    for mag in MAGS:
        m = int(wire.mag_dtype(mag))
        got = kenc.sparse_streams(Xd, mag)
        want = ref.sparse_streams_ref(Xd, m)
        dbits = [kenc.dense_bits(Xd[r], mag) for r in range(3)]
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            err["sparse_streams"] = max(err["sparse_streams"], int_err(ref, g, w))
            if not torch.equal(g, w):
                fail(f"(e) sparse_streams {mag}: kernel != plain")
        for r in range(3):
            w = ref.dense_bits_ref(Xd[r], m)
            err["dense_bits"] = max(err["dense_bits"], int_err(ref, dbits[r], w))
            if not torch.equal(dbits[r], w):
                fail(f"(e) dense_bits {mag} row {r}: kernel != plain")
        bufs = kenc.encode_rows(Xd, mag=mag)
        if bufs != [wire.encode_sparse(X[r], mag=mag) for r in range(10)]:
            fail(f"(e) encode_rows {mag}: device buffers != host codec")
        for r in range(3):
            for dev_buf, host_buf in ((kenc.sparse_encode(Xd[r], mag=mag), wire.encode_sparse(X[r], mag=mag)),
                                      (kenc.dense_encode(Xd[r], mag=mag), wire.encode_dense(X[r], mag=mag))):
                if dev_buf != host_buf:
                    fail(f"(e) {mag} row {r}: device buffer != host codec")
    return err


def marina_wire_rounds(np, torch, dev, prob, mode, k, p, omega, rounds):
    """(f): the first ``rounds`` rounds of a MARINA-P run stepped by hand as
    ``run`` steps them (same seed, same draws): the server's device buffers
    equal the host codec's byte for byte. Returns the number of buffers
    checked."""
    from repro_torch import wire
    from repro_torch.core import marina_p, stepsizes
    from repro_torch.kernels import encode as kenc

    step = marina_p.make_step(prob, mode, k, p, stepsizes.MarinaPPolyak(omega=omega, p=p, f_star=0.0),
                              return_q=True)
    bcast = marina_p.make_broadcast(mode, prob.n, k)
    state, gen = marina_p.init(prob.x0, prob.n), torch.Generator().manual_seed(0)
    checked = 0
    for t in range(rounds):
        draws = marina_p.draw_round(bcast, p, prob.d, gen, dev)
        state, m = step(state, draws)
        if draws.coin:
            dev_bufs, host_bufs = [kenc.dense_encode(m["x_new"])], [wire.encode_dense(m["x_new"])]
        elif mode == "same":
            dev_bufs, host_bufs = [kenc.sparse_encode(m["Q"][0])], [wire.encode_sparse(m["Q"][0])]
        else:
            Qh = m["Q"].cpu().numpy()
            dev_bufs, host_bufs = kenc.encode_rows(m["Q"]), [wire.encode_sparse(q) for q in Qh]
        if dev_bufs != host_bufs:
            fail(f"(f) marina_p {mode} round {t}: device buffers != host codec")
        checked += len(dev_bufs)
    return checked


def wire_runs(torch, prob, k, p, T, device_encode, runtime=None):
    """The five measure_wire runs of (f); with ``runtime``, also the
    launches each run made (a diff of the counters around it)."""
    from repro_torch.core import compressors as C
    from repro_torch.core import ef21p, marina_p, stepsizes

    D, N = prob.d, prob.n
    out, launches = {}, {}

    def record(name, fn):
        before = dict(runtime.LAUNCHES) if runtime else {}
        out[name] = fn()
        if runtime:
            torch.cuda.synchronize()
            launches[name] = {kk: v - before.get(kk, 0) for kk, v in runtime.LAUNCHES.items()}

    for mode, omega in (("same", D / k - 1.0), ("ind", D / k - 1.0), ("perm", float(N - 1))):
        record(f"marina_{mode}_polyak", lambda mode=mode, omega=omega: marina_p.run(
            prob, mode=mode, k=k, p=p, stepsize=stepsizes.MarinaPPolyak(omega=omega, p=p, f_star=0.0),
            T=T, seed=0, measure_wire=True, device_encode=device_encode))
    for name, comp in (("ef21p_topk_polyak", C.TopK(k=k)),
                       ("ef21p_block_topk_polyak", C.BlockTopK(k_per_block=16, block=128))):
        record(name, lambda comp=comp: ef21p.run(
            prob, comp, stepsizes.EF21PPolyak(alpha=comp.alpha(D), f_star=0.0), T=T, seed=0,
            measure_wire=True, device_encode=device_encode))
    return out, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: no card to run on", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found: run from a checkout of the repo",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch import fig1, quickstart
    from repro_torch.core import compressors as C
    from repro_torch.core import ef21p, problems, stepsizes
    from repro_torch.kernels import l1_subgrad as k_l1
    from repro_torch.kernels import ops, ref, runtime
    from repro_torch.kernels import topk as k_topk

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0]
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")

    # --- build ------------------------------------------------------------------
    t0 = time.perf_counter()
    libs = runtime.build_all()
    log(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for stem in sorted(libs):
        logf = runtime.BUILD / f"{stem}.log"
        if logf.exists():
            for line in logf.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {stem}: {line.strip()}")

    # --- (a) kernels against their plain versions on the card -------------------
    l1_err = 0.0
    for n, d in ((10, 1000), (100, 1000), (3, 257)):
        A_np, X_np = l1_inputs(np, n, d, seed=n * 7919 + d)
        A, X = torch.from_numpy(A_np).to(dev), torch.from_numpy(X_np).to(dev)
        got = k_l1.l1_subgrad(A, X)
        again = k_l1.l1_subgrad(A, X)
        want = ref.l1_subgrad_ref(A, X)
        torch.cuda.synchronize()
        if not bits_equal(torch, got, again):
            fail(f"l1_subgrad n={n} d={d}: two identical launches differ")
        if not torch.allclose(got, want, rtol=L1_RTOL, atol=L1_ATOL):
            fail(f"l1_subgrad n={n} d={d}: max |kernel - plain| = {(got - want).abs().max().item()}")
        l1_err = max(l1_err, (got - want).abs().max().item())
        # one point shared by all workers (row stride 0), as EF21-P and SM pass it
        A_np, X_np = l1_inputs(np, n, d, seed=n * 7919 + d + 1, shared=True)
        A, xs = torch.from_numpy(A_np).to(dev), torch.from_numpy(X_np[0]).to(dev).expand(n, d)
        got_b, want_b = k_l1.l1_subgrad(A, xs), ref.l1_subgrad_ref(A, xs)
        torch.cuda.synchronize()
        if not torch.allclose(got_b, want_b, rtol=L1_RTOL, atol=L1_ATOL):
            fail(f"l1_subgrad n={n} d={d} broadcast x: max err {(got_b - want_b).abs().max().item()}")
        l1_err = max(l1_err, (got_b - want_b).abs().max().item())
        same = bits_equal(torch, got, want) and bits_equal(torch, got_b, want_b)
        del A, X, xs
        log(f"(a) l1_subgrad n={n} m=d={d}: max |kernel - plain| = {l1_err:.3e} "
            f"({'bit-equal' if same else 'not bit-equal'}: the plain version sums in the kernel's "
            "order); two launches bit-equal")

    rng = np.random.default_rng(1)
    topk_cases = []
    for d, block, k in ((1000, 1000, 100), (2048, 512, 16), (1000, 128, 4)):
        topk_cases.append((f"d={d} block={block} k={k} f32",
                           torch.from_numpy(rng.standard_normal(d).astype(np.float32)), block, k))
        ties = np.round(rng.standard_normal(d) * 2) / 2  # many exact ties
        topk_cases.append((f"d={d} block={block} k={k} f32 ties",
                           torch.from_numpy(ties.astype(np.float32)), block, k))
        topk_cases.append((f"d={d} block={block} k={k} bf16",
                           torch.from_numpy(rng.standard_normal(d).astype(np.float32)).bfloat16(),
                           block, k))
    edge = edge_vector(np, torch)
    topk_cases.append(("edge inf/-0.0/denormal k=3", edge, 128, 3))
    topk_cases.append(("edge inf/-0.0/denormal k=8", edge, 128, 8))
    nan_edge = edge.clone()
    nan_edge[1] = float("nan")
    topk_cases.append(("edge NaN k=3", nan_edge, 128, 3))
    after_inf = edge.clone()
    after_inf[1] = 0.25  # no inf: selection runs past the denormals
    topk_cases.append(("edge -0.0/denormal k=12", after_inf, 128, 12))
    topk_err = 0.0
    for name, x, block, k in topk_cases:
        x = x.to(dev)
        pad = (-x.shape[0]) % block
        xp = torch.nn.functional.pad(x, (0, pad))
        got = k_topk.block_topk_compress(xp, k_per_block=k, block=block)
        want = ref.block_topk_ref(xp, k_per_block=k, block=block)
        torch.cuda.synchronize()
        finite = torch.isfinite(got) & torch.isfinite(want)
        topk_err = max(topk_err, float((got.float() - want.float()).abs()[finite].max()))
        if not bits_equal(torch, got, want):
            diff = (got != want).nonzero().flatten()[:8].tolist()
            fail(f"block_topk {name}: kernel != plain at {diff}")
    kept = torch.nonzero(k_topk.block_topk_compress(edge.to(dev), k_per_block=3, block=128)).flatten()
    if kept.tolist() != [1]:
        fail(f"block_topk: the Pallas inf quirk should keep only index 1, kept {kept.tolist()}")
    log(f"(a) block_topk: {len(topk_cases)} cases bit-equal to the plain version "
        "(inf case keeps only index 1, as the Pallas kernel)")

    # --- (b) the main path on the card --------------------------------------------
    D, N, T = 1000, 10, 400
    runtime.reset_launches()
    suite = fig1.run_suite(d=D, n=N, T=T, device=dev)
    qs = quickstart.main(n=N, d=D, budget=2e6, device=dev)
    torch.cuda.synchronize()
    launches = dict(runtime.LAUNCHES)
    log(f"(b) launches on the main path: {launches}")
    for kname in ("l1_subgrad", "block_topk"):
        if launches.get(kname, 0) <= 0:
            fail(f"(b) the main path never launched {kname}")
    for name, r in suite.items():
        if not np.isfinite(r["final_subopt"]) or r["rounds"] != T:
            fail(f"(b) {name}: rounds={r['rounds']} final f={r['final_subopt']}")
        log(f"(b) {name:20s} rounds={r['rounds']} final f(x)={r['final_subopt']:.6g} "
            f"us/round={r['us_per_round']:.1f} bits/worker={r['bits_per_worker']:.4g}")
    f0 = suite["ef21p_topk_const"]["hist"]["f_x"][0]
    for name, h in qs.items():
        if not np.isfinite(h["f_x"][-1]) or h["ledger"].s2w_bits < 2e6:
            fail(f"(b) quickstart {name}: did not reach the bit budget with a finite f")
    if not qs["MARINA-P/PermK/Polyak"]["f_x"][-1] < f0:
        fail("(b) quickstart: MARINA-P did not decrease f")

    # --- (c) CPU port against the card, T=20, same seeds ------------------------------
    T_C = 20
    gpu20 = fig1.run_suite(d=D, n=N, T=T_C, device=dev)
    cpu20 = fig1.run_suite(d=D, n=N, T=T_C, device="cpu")
    worst, problems_c = 0.0, []
    for name in suite:
        hc, hg = cpu20[name]["hist"], gpu20[name]["hist"]
        rel = float(np.max(np.abs(np.subtract(hc["f_x"], hg["f_x"])) / np.abs(hg["f_x"])))
        log(f"(c) {name}: CPU vs card max rel f_x diff {rel:.3e}")
        if hc["s2w_bits"] != hg["s2w_bits"]:
            problems_c.append(f"{name}: CPU and card s2w_bits differ")
        if name.endswith("_polyak") and hg["f_x"] != suite[name]["hist"]["f_x"][:T_C]:
            problems_c.append(f"{name}: card T=20 run differs from (b)'s first 20 rounds")
        # EF21-P is not held free-running: TopK breaks exact ties of |x - w|
        # (the tridiagonal problem makes many) by the last bit of x - gamma*g,
        # so its trajectory follows the summation order of the worker mean
        # and of f_w. It is held per step from identical states below.
        if name.startswith("marina"):
            worst = max(worst, rel)
            if rel > TRAJ_RTOL:
                problems_c.append(f"{name}: CPU vs card f_x rel err {rel:.3e} > {TRAJ_RTOL}")
    if problems_c:
        fail("(c) " + "; ".join(problems_c))
    log(f"(c) MARINA-P, 6 runs, CPU vs card over {T_C} rounds: max rel f_x err {worst:.3e}; "
        "s2w_bits equal for all 8; card Polyak runs bit-equal to (b)")

    prob = problems.generate_problem(n=N, d=D, noise_scale=1.0, seed=0, device=dev)
    prob_cpu = prob.to("cpu")
    k, alpha = D // N, (D // N) / D
    worst = 0.0
    for name, stepsize in (
        ("ef21p_topk_const", stepsizes.Constant(stepsizes.ef21p_optimal_constant(prob.R0_sq, prob.L0, alpha, T))),
        ("ef21p_topk_polyak", stepsizes.EF21PPolyak(alpha=alpha, f_star=0.0)),
    ):
        step_g = ef21p.make_step(prob, C.TopK(k=k), stepsize)
        step_c = ef21p.make_step(prob_cpu, C.TopK(k=k), stepsize)
        state = ef21p.init(prob.x0)
        for t in range(T_C):
            here = ef21p.EF21PState(x=state.x.cpu(), w=state.w.cpu(), t=state.t)
            state, mg = step_g(state)
            _, mc = step_c(here)
            rel = abs(float(mc["f_x"]) - float(mg["f_x"])) / abs(float(mg["f_x"]))
            worst = max(worst, rel)
            if rel > TRAJ_RTOL or float(mc["delta_nnz"]) != float(mg["delta_nnz"]):
                fail(f"(c) {name} round {t}: CPU step from the card's state: rel f_x err {rel:.3e}")
    log(f"(c) EF21-P, 2 runs, CPU step from the card's state each round over {T_C} rounds: "
        f"max rel f_x err {worst:.3e}")

    # --- (d) timing at the main path's shapes -------------------------------------------
    flush_buf = torch.empty(256 * 2**20 // 4, dtype=torch.float32, device=dev)

    def flush():
        flush_buf.zero_()

    W = prob.x0.expand(N, D).contiguous() + 0.01 * torch.randn(N, D, device=dev,
                                                                 generator=torch.Generator(dev).manual_seed(0))
    l1_ms = median_ms(torch, lambda: ops.l1_subgrad(prob.A, W), flush=flush)
    l1_plain_ms = median_ms(torch, lambda: ref.l1_subgrad_ref(prob.A, W), flush=flush)
    l1_bytes = prob.A.numel() * 4 + 2 * W.numel() * 4
    l1_flops = 4 * prob.A.numel()
    l1_bound = max(l1_bytes / HBM_BYTES_PER_S, l1_flops / FP32_FLOPS_PER_S) * 1e3
    A100 = torch.randn(100, D, D, device=dev, generator=torch.Generator(dev).manual_seed(1))
    W100 = torch.randn(100, D, device=dev, generator=torch.Generator(dev).manual_seed(2))
    l1_ms_100 = median_ms(torch, lambda: ops.l1_subgrad(A100, W100), flush=flush)
    l1_bound_100 = (A100.numel() * 4 + 2 * W100.numel() * 4) / HBM_BYTES_PER_S * 1e3
    del A100

    xt = (W[0] - prob.x0).contiguous()
    tk_ms = median_ms(torch, lambda: ops.block_topk(xt, k_per_block=k, block=D), flush=flush)
    tk_plain_ms = median_ms(torch, lambda: ref.block_topk_ref(xt, k_per_block=k, block=D), flush=flush)

    def topk_library():
        idx = torch.topk(xt.abs(), k).indices
        return torch.zeros_like(xt).scatter_(0, idx, xt.gather(0, idx))

    tk_lib_ms = median_ms(torch, topk_library, flush=flush)
    if not torch.equal(topk_library(), ops.block_topk(xt, k_per_block=k, block=D)):
        log("(d) note: torch.topk yardstick selects other indices than the kernel on this input")
    tk_bytes = 2 * D * 4
    tk_ops = k * D  # k rounds of a compare over the block
    tk_bound = max(tk_bytes / HBM_BYTES_PER_S, tk_ops / FP32_FLOPS_PER_S) * 1e3
    log(f"(d) l1_subgrad n={N} m=d={D}: {l1_ms:.4f} ms (plain {l1_plain_ms:.4f}, bound {l1_bound:.4f}); "
        f"n=100: {l1_ms_100:.4f} ms (bound {l1_bound_100:.4f})")
    log(f"(d) block_topk d=block={D} k={k}: {tk_ms:.4f} ms (plain {tk_plain_ms:.4f}, "
        f"torch.topk+scatter {tk_lib_ms:.4f}, bound {tk_bound:.6f})")

    # --- (e) the wire kernels against their plain versions on the card ------------------
    from repro_torch import wire, wire_bench
    from repro_torch.core import marina_p
    from repro_torch.kernels import encode as kenc

    wire_err = wire_kernels_vs_plain(np, torch, dev)
    log(f"(e) pack_bits/unpack_bits ({len(WIDTHS)} widths x 6 sizes, batched rows), sparse_streams and "
        "dense_bits (3 dtypes, random / random-bit / IEEE-corner rows) bit-equal to their "
        "plain versions; device buffers == host codec")

    # --- (f) the wire path on the card ---------------------------------------------------
    p = k / D
    omegas = {"same": D / k - 1.0, "ind": D / k - 1.0, "perm": float(N - 1)}
    runtime.reset_launches()
    dev_runs, run_launches = wire_runs(torch, prob, k, p, T, None, runtime)
    torch.cuda.synchronize()
    wire_launches = {kname: runtime.LAUNCHES.get(kname, 0)
                     for kname in ("pack_bits", "unpack_bits", "sparse_streams", "dense_bits")}
    log(f"(f) launches on the wire path (5 runs x {T} rounds): {wire_launches}; unpack_bits decodes, "
        "which no run of the path does")
    for kname in ("pack_bits", "sparse_streams", "dense_bits"):
        if wire_launches[kname] <= 0:
            fail(f"(f) the wire path never launched {kname}")
    n_checked = sum(marina_wire_rounds(np, torch, dev, prob, mode, k, p, omega, 20)
                    for mode, omega in omegas.items())
    host_runs, _ = wire_runs(torch, prob, k, p, T, False)
    for name, h in dev_runs.items():
        if not np.isfinite(h["f_x"][-1]) or h["ledger"].rounds != T:
            fail(f"(f) {name}: rounds={h['ledger'].rounds} final f={h['f_x'][-1]}")
        if h["wire_bits"] != host_runs[name]["wire_bits"]:
            fail(f"(f) {name}: wire_bits with device encode != with the host codec")
        a = h["wire_model_ledger"].s2w_bits
        log(f"(f) {name:24s} final f(x)={h['f_x'][-1]:.6g} wire bits/round={h['wire_bits_total'] / T:.1f} "
            f"analytic (32-bit values) {a / T:.1f} gap {100 * (h['wire_bits_total'] - a) / a:+.3f}%; "
            f"launches/round {{{', '.join(f'{kk}: {v / T:g}' for kk, v in sorted(run_launches[name].items()) if v)}}}")
    log(f"(f) 5 runs x {T} rounds: wire_bits per round equal with device and host encode; first 20 rounds "
        f"of each MARINA-P mode: {n_checked} device buffers == host buffers")

    # --- (g) CPU port against the card, T=20 ---------------------------------------------
    T_G = 20
    gpu20, _ = wire_runs(torch, prob, k, p, T_G, None)
    cpu20, _ = wire_runs(torch, prob_cpu, k, p, T_G, None)
    for name in gpu20:
        hg, hc = gpu20[name], cpu20[name]
        same = (hc["wire_bits"] == hg["wire_bits"] and hc["s2w_bits"] == hg["s2w_bits"]
                and hc["wire_model_ledger"].s2w_bits == hg["wire_model_ledger"].s2w_bits)
        log(f"(g) {name:24s} CPU vs card over {T_G} rounds: wire_bits and wire ledger "
            f"{'equal' if same else 'DIFFER'} (wire bits {hc['wire_bits_total']:.0f} / {hg['wire_bits_total']:.0f})")
        if name.startswith("marina") and not same:
            fail(f"(g) {name}: CPU and card wire bits differ")

    # --- (h) DESIGN §3.5 on the card: measured vs analytic ------------------------------------
    for d_b, n_b in wire_bench.SETTINGS:
        rows = wire_bench.parity_rows(d=d_b, n=n_b, T=200, device=dev)
        for name, analytic, measured, pct in rows:
            log(f"(h) d={d_b} n={n_b} T=200 {name:18s} analytic={analytic:.1f} wire={measured:.1f} gap={pct:+.3f}%")
        if wire_bench.failures(rows):
            fail(f"(h) d={d_b} n={n_b}: MARINA-P gap >= {wire_bench.GAP_LIMIT_PCT}%: {wire_bench.failures(rows)}")

    # --- (i) timing of the wire kernels -------------------------------------------------------
    step = marina_p.make_step(prob, "ind", k, p, stepsizes.MarinaPPolyak(omega=omegas["ind"], p=p),
                              return_q=True)
    bcast = marina_p.make_broadcast("ind", N, k)
    _, mq = step(marina_p.init(prob.x0, N),
                 marina_p.draw_round(bcast, p, D, torch.Generator().manual_seed(0), dev))
    Q, x_new = mq["Q"].contiguous(), mq["x_new"].contiguous()  # a round's messages: [10, 1000], [1000]
    iw = wire.index_width(D)
    (idx_stream, _, _), _ = kenc._compact_streams(*kenc.sparse_streams(Q, "fp32"))
    idx_words = ops.pack_bits(idx_stream, iw)
    big = 2**20
    gbig = torch.Generator(dev).manual_seed(3)
    xbig = torch.randn(big, device=dev, generator=gbig)
    Xbig = torch.where(torch.rand(big, device=dev, generator=gbig) < 1 / 16, xbig, 0.0).unsqueeze(0)
    vbig = torch.randint(0, 2**20, (big,), dtype=torch.int32, device=dev, generator=gbig)
    wbig = ops.pack_bits(vbig, 20)

    def hbm_ms(nbytes):
        return nbytes / HBM_BYTES_PER_S * 1e3

    wt = {}  # name -> (ms, plain_ms, bound_ms, library_ms) at the path's shape; and at 2**20
    wt["sparse_streams"] = (median_ms(torch, lambda: kenc.sparse_streams(Q, "fp32"), flush=flush),
                            median_ms(torch, lambda: ref.sparse_streams_ref(Q, 0), flush=flush),
                            hbm_ms(Q.numel() * 16), None)
    wt["dense_bits"] = (median_ms(torch, lambda: kenc.dense_bits(x_new, "fp32"), flush=flush),
                        median_ms(torch, lambda: ref.dense_bits_ref(x_new, 0), flush=flush),
                        hbm_ms(D * 8),
                        median_ms(torch, lambda: x_new.to(torch.float16).view(torch.int16), flush=flush))
    wt["pack_bits"] = (median_ms(torch, lambda: ops.pack_bits(idx_stream, iw), flush=flush),
                       median_ms(torch, lambda: ref.pack_bits_ref(idx_stream, iw), flush=flush),
                       hbm_ms(idx_stream.numel() * 4 + idx_words.numel() * 4), None)
    wt["unpack_bits"] = (median_ms(torch, lambda: ops.unpack_bits(idx_words, iw, D), flush=flush),
                         median_ms(torch, lambda: ref.unpack_bits_ref(idx_words, iw, D), flush=flush),
                         hbm_ms(idx_words.numel() * 4 + idx_stream.numel() * 4), None)
    wt_big = {
        "sparse_streams": (median_ms(torch, lambda: kenc.sparse_streams(Xbig, "fp32"), flush=flush),
                           hbm_ms(big * 16)),
        "dense_bits": (median_ms(torch, lambda: kenc.dense_bits(xbig, "fp32"), flush=flush), hbm_ms(big * 8)),
        "pack_bits": (median_ms(torch, lambda: ops.pack_bits(vbig, 20), flush=flush),
                      hbm_ms(big * 4 + wbig.numel() * 4)),
        "unpack_bits": (median_ms(torch, lambda: ops.unpack_bits(wbig, 20, big), flush=flush),
                        hbm_ms(big * 4 + wbig.numel() * 4)),
    }
    fp16_ms = median_ms(torch, lambda: kenc.dense_bits(x_new, "fp16"), flush=flush)
    rounds_ind = T
    for name, (ms_, plain_, bound_, lib_) in wt.items():
        per_round = run_launches["marina_ind_polyak"].get(name, 0) / rounds_ind
        log(f"(i) {name:14s} path shape: {ms_:.5f} ms (plain {plain_:.5f}, bound {bound_:.2e}"
            f"{'' if lib_ is None else f', x.to(float16).view(int16) {lib_:.5f}'}); "
            f"2**20: {wt_big[name][0]:.5f} ms (bound {wt_big[name][1]:.5f}); "
            f"launches/round in MARINA-P ind {per_round:g}")
    log(f"(i) dense_bits fp16 at the path shape: {fp16_ms:.5f} ms")

    def host_ms(fn, reps=30):
        fn()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        times.sort()
        return times[len(times) // 2]

    Qh, xh, Xbig_h = Q.cpu().numpy(), x_new.cpu().numpy(), Xbig[0].cpu().numpy()
    codec = {
        "sparse 1 row": (host_ms(lambda: kenc.sparse_encode(Q[0])), host_ms(lambda: wire.encode_sparse(Qh[0]))),
        "sparse 10 rows": (host_ms(lambda: kenc.encode_rows(Q)),
                           host_ms(lambda: [wire.encode_sparse(q) for q in Qh])),
        "dense 1000": (host_ms(lambda: kenc.dense_encode(x_new)), host_ms(lambda: wire.encode_dense(xh))),
        "sparse 2**20": (host_ms(lambda: kenc.sparse_encode(Xbig[0]), reps=10),
                         host_ms(lambda: wire.encode_sparse(Xbig_h), reps=10)),
    }
    for name, (dev_ms, host_ms_) in codec.items():
        log(f"(i) encode {name:14s}: device path {dev_ms:.4f} ms (host clock, incl. the copy to the host), "
            f"host codec {host_ms_:.4f} ms")

    us_round = {"device": [], "host": []}
    for enc in ("device", "host", "host", "device", "device", "host"):
        t0 = time.perf_counter()
        h = marina_p.run(prob, mode="ind", k=k, p=p, stepsize=stepsizes.MarinaPPolyak(omega=omegas["ind"], p=p),
                         T=200, seed=0, measure_wire=True, device_encode=enc == "device")
        torch.cuda.synchronize()
        us_round[enc].append((time.perf_counter() - t0) / h["ledger"].rounds * 1e6)
    t0 = time.perf_counter()
    marina_p.run(prob, mode="ind", k=k, p=p, stepsize=stepsizes.MarinaPPolyak(omega=omegas["ind"], p=p),
                 T=200, seed=0)
    torch.cuda.synchronize()
    us_plain = (time.perf_counter() - t0) / 200 * 1e6
    log(f"(i) MARINA-P ind Polyak d={D} n={N}, T=200, us/round with measure_wire (3 runs each, in turns): "
        f"device encode {us_round['device']}, host encode {us_round['host']}; "
        f"without measure_wire {us_plain:.1f}")

    summary = {"kernels": [
        {"name": "l1_subgrad", "route": "cuda", "source": "src/repro_torch/csrc/l1_subgrad.cu",
         "replaces": "src/repro/kernels/l1_subgrad.py:46", "launches": launches["l1_subgrad"],
         "max_abs_err": l1_err, "ms": l1_ms, "plain_ms": l1_plain_ms, "bound_ms": l1_bound,
         "bound_by": "bytes" if l1_bytes / HBM_BYTES_PER_S >= l1_flops / FP32_FLOPS_PER_S else "operations",
         "library_ms": None},
        {"name": "block_topk", "route": "cuda", "source": "src/repro_torch/csrc/topk.cu",
         "replaces": "src/repro/kernels/topk.py:55", "launches": launches["block_topk"],
         "max_abs_err": topk_err, "ms": tk_ms, "plain_ms": tk_plain_ms, "bound_ms": tk_bound,
         "bound_by": "bytes" if tk_bytes / HBM_BYTES_PER_S >= tk_ops / FP32_FLOPS_PER_S else "operations",
         "library_ms": tk_lib_ms},
    ]}
    for name, src, replaces in (
        ("pack_bits", "pack.cu", "pack.py:88"), ("unpack_bits", "pack.cu", "pack.py:107"),
        ("sparse_streams", "encode.cu", "encode.py:265"), ("dense_bits", "encode.cu", "encode.py:328"),
    ):
        ms_, plain_, bound_, lib_ = wt[name]
        summary["kernels"].append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{src}",
            "replaces": f"src/repro/kernels/{replaces}", "launches": wire_launches[name],
            "max_abs_err": wire_err[name], "ms": ms_, "plain_ms": plain_, "bound_ms": bound_,
            "bound_by": "bytes", "library_ms": lib_})
    print(json.dumps(summary), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
