"""Paper Figure 1 / Figure 7 on the port: EF21-P(TopK) vs MARINA-P
(same/ind/PermK), constant vs Polyak stepsizes, under equal per-worker
downlink bit budgets.

Port of ``benchmarks/fig1_convergence.py::run_suite``. Setup follows
§5/App.A: f_i = ||A_i x||_1, K = d/n, p = K/d, Algorithm 3 datagen with noise
scales controlling sigma_A. The paper's scale is d=1000, n in {10, 100}.
Runs on ``device`` (default the card).
"""
from __future__ import annotations

import time

import torch

from .core import compressors as C
from .core import ef21p, marina_p, problems, stepsizes


def run_suite(*, d=200, n=10, noise=1.0, budget_bits=None, T=600, seed=0,
              tuned_factor=1.0, device="cuda"):
    """The 8 runs of Figure 1; returns {name: summary}. Each summary carries
    the reference's keys plus ``hist``, the run's full history."""
    prob = problems.generate_problem(n=n, d=d, noise_scale=noise, seed=seed, device=device)
    k = max(1, d // n)
    p = k / d
    alpha = k / d
    omega_rand = d / k - 1.0
    omega_perm = float(n - 1)
    results = {}

    def record(name, fn):
        t0 = time.perf_counter()
        hist = fn()
        if prob.device.type == "cuda":
            torch.cuda.synchronize(prob.device)
        dt = time.perf_counter() - t0
        rounds = max(hist["ledger"].rounds, 1)
        results[name] = {
            "final_subopt": hist["f_x"][-1],
            "rounds": rounds,
            "us_per_round": dt / rounds * 1e6,
            "bits_per_worker": hist["ledger"].s2w_bits,
            "hist": hist,
        }

    kw = dict(T=None, bit_budget=budget_bits) if budget_bits else dict(T=T)

    # --- constant stepsizes (optimal formula x tuned factor) -----------------
    g_e = stepsizes.ef21p_optimal_constant(prob.R0_sq, prob.L0, alpha, T) * tuned_factor
    record("ef21p_topk_const", lambda: ef21p.run(
        prob, C.TopK(k=k), stepsizes.Constant(g_e), seed=seed, **kw))
    for mode, omega in (("same", omega_rand), ("ind", omega_rand), ("perm", omega_perm)):
        g_m = stepsizes.marina_p_optimal_constant(
            prob.R0_sq, prob.L0, prob.L0_tilde, omega, p, T) * tuned_factor
        record(f"marina_{mode}_const", lambda g=g_m, m=mode: marina_p.run(
            prob, mode=m, k=k, p=p, stepsize=stepsizes.Constant(g), seed=seed, **kw))

    # --- Polyak stepsizes ------------------------------------------------------
    record("ef21p_topk_polyak", lambda: ef21p.run(
        prob, C.TopK(k=k),
        stepsizes.EF21PPolyak(alpha=alpha, f_star=0.0, factor=tuned_factor),
        seed=seed, **kw))
    for mode, omega in (("same", omega_rand), ("ind", omega_rand), ("perm", omega_perm)):
        record(f"marina_{mode}_polyak", lambda m=mode, o=omega: marina_p.run(
            prob, mode=m, k=k, p=p,
            stepsize=stepsizes.MarinaPPolyak(omega=o, p=p, f_star=0.0, factor=tuned_factor),
            seed=seed, **kw))
    return results
