"""Quickstart on the port, counterpart of ``examples/quickstart.py``.

1. Build the paper's synthetic non-smooth problem (Algorithm 3).
2. Run MARINA-P with PermK + Polyak stepsize (the paper's winner).
3. Compare against EF21-P(TopK) and plain SM at the same downlink budget.

Run:  PYTHONPATH=src python -m repro_torch.quickstart  (on the card; pass
``device="cpu"`` to :func:`main` for the plain PyTorch path)
"""
from __future__ import annotations

from .core import compressors as C
from .core import ef21p, marina_p, problems, stepsizes, subgradient


def main(*, n=10, d=200, budget=2e6, seed=0, device="cuda"):
    """Run the three methods to ``budget`` downlink bits per worker; print
    and return {name: history}."""
    prob = problems.generate_problem(n=n, d=d, noise_scale=1.0, seed=seed, device=device)
    print(f"problem: n={prob.n} d={prob.d} sigma_A={prob.sigma_A:.3f} "
          f"f(x0)={float(prob.f(prob.x0)):.2f} device={prob.device}")
    k = prob.d // prob.n          # K = d/n (paper §5)
    p = k / prob.d                # p = K/d
    hists = {
        # MARINA-P + PermK + Polyak (23)
        "MARINA-P/PermK/Polyak": marina_p.run(
            prob, mode="perm", k=k, p=p,
            stepsize=stepsizes.MarinaPPolyak(omega=prob.n - 1, p=p, f_star=0.0),
            bit_budget=budget, seed=seed),
        # EF21-P + TopK + Polyak (13)
        "EF21-P/TopK/Polyak": ef21p.run(
            prob, C.TopK(k=k), stepsizes.EF21PPolyak(alpha=k / prob.d, f_star=0.0),
            bit_budget=budget, seed=seed),
        # uncompressed subgradient method (eq. 5)
        "SM (dense)": subgradient.run(prob, stepsizes.Constant(5e-3), bit_budget=budget),
    }
    for name, h in hists.items():
        print(f"{name:24s} rounds={h['ledger'].rounds:5d} "
              f"bits/worker={h['ledger'].s2w_bits:.2e} final f-f*={h['f_x'][-1]:.4f}")
    return hists


if __name__ == "__main__":
    main()
