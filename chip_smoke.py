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
    its plain version's and the library call's, beside its lower bound.

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
    print(json.dumps(summary), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
