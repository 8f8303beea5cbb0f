"""Corollaries 1 & 2 on the port (counterpart of
``benchmarks/comm_complexity.py``): measured rounds-to-epsilon vs the
closed-form predictions.

    PYTHONPATH=src python -m repro_torch.run comm_complexity [--device cpu]

For a grid of compression levels (k in {4, 16, 64} at n = 8, d = 128),
measures T_eps = rounds until f(x^t) - f* <= eps (eps = 5% of f(x^0)) for
EF21-P/TopK and MARINA-P/ind with Polyak stepsizes, T = 4000, on ``device``
(default the card), and reports the ratio to the theory complexity
(constant factors absorbed; the *scaling* in alpha / omega is the claim).
"""
from __future__ import annotations

import time

from .core import comm_model, compressors as C
from .core import ef21p, marina_p, problems, stepsizes

KS = (4, 16, 64)


def rounds_to_eps(hist, eps):
    for t, f in zip(hist["t"], hist["f_x"]):
        if f <= eps:
            return t + 1
    return None


def setting(device="cuda"):
    """(problem, eps): Algorithm 3 at n = 8, d = 128, noise 1, seed 0, and
    5% of f(x^0)."""
    prob = problems.generate_problem(n=8, d=128, noise_scale=1.0, seed=0, device=device)
    return prob, 0.05 * float(prob.f(prob.x0))


def ef21p_rounds(prob, k: int, eps: float, T: int = 4000):
    """Corollary 1: (measured T_eps or -1, theory T) of EF21-P/TopK(k), Polyak."""
    alpha = k / prob.d
    h = ef21p.run(prob, C.TopK(k=k), stepsizes.EF21PPolyak(alpha=alpha, f_star=0.0), T=T)
    return (rounds_to_eps(h, eps) or -1,
            comm_model.ef21p_iteration_complexity(prob.L0, prob.R0_sq, alpha, eps))


def marina_ind_rounds(prob, k: int, eps: float, T: int = 4000):
    """Corollary 2: (measured T_eps or -1, theory T) of MARINA-P/ind RandK(k),
    p = k/d, Polyak."""
    d = prob.d
    p, omega = k / d, d / k - 1.0
    h = marina_p.run(prob, mode="ind", k=k, p=p,
                     stepsize=stepsizes.MarinaPPolyak(omega=omega, p=p, f_star=0.0), T=T)
    return (rounds_to_eps(h, eps) or -1,
            comm_model.marina_p_iteration_complexity(
                prob.L0, prob.L0_tilde, prob.R0_sq, omega, d, float(k), eps))


def bench(tracker=None, *, T=4000, device="cuda"):
    """The reference's rows: ``corollary1/ef21p/k{k}/{rounds,theory_ratio}``
    and ``corollary2/marina_ind/k{k}/...``, µs of each run."""
    prob, eps = setting(device)
    rows = []
    for prefix, fn in (("corollary1/ef21p", ef21p_rounds), ("corollary2/marina_ind", marina_ind_rounds)):
        for k in KS:
            t0 = time.time()
            T_meas, T_theory = fn(prob, k, eps, T)
            dt = (time.time() - t0) * 1e6
            rows.append((f"{prefix}/k{k}/rounds", dt, T_meas))
            rows.append((f"{prefix}/k{k}/theory_ratio", dt, T_meas / T_theory if T_meas > 0 else -1))
    return rows
