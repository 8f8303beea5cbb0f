"""Paper Table 2 on the port (counterpart of ``benchmarks/table2_sigma.py``):
data-dissimilarity sigma_A per (n, noise scale).

    PYTHONPATH=src python -m repro_torch.run table2 [--device cpu]

Runs Algorithm 3 at the paper's exact sizes (d=1000, n in {10,100}, s in
{0.1, 1, 10}) and reports sigma_A; the paper's values are 0.09/0.88/5.60
(n=10) and 0.10/0.83/5.91 (n=100). sigma_A is a host (numpy float64)
computation, bit-equal to the reference's in one process; the problem's
matrices are placed on ``device`` (default the card).
"""
from __future__ import annotations

import time

from .core import problems

PAPER = {(10, 0.1): 0.09, (10, 1.0): 0.88, (10, 10.0): 5.60,
         (100, 0.1): 0.10, (100, 1.0): 0.83, (100, 10.0): 5.91}


def row(n: int, s: float, sigma_A: float, us: float, tracker=None):
    """The reference's row ``table2/sigmaA/n{n}/s{s}`` (and, with a tracker,
    its ``table2/n{n}/s{s}/{sigma_A,paper,abs_err}`` metrics) for one cell."""
    paper_val = PAPER[(n, s)]
    if tracker is not None:
        tracker.log({"table2": {f"n{n}/s{s}": {
            "sigma_A": sigma_A, "paper": paper_val, "abs_err": abs(sigma_A - paper_val)}}})
    return (f"table2/sigmaA/n{n}/s{s}", us, sigma_A)


def bench(d=1000, tracker=None, *, cells=None, device="cuda"):
    """[(name, µs of the datagen, sigma_A)] for each (n, s) of ``cells``
    (default: all six of :data:`PAPER`)."""
    rows = []
    for n, s in (cells if cells is not None else PAPER):
        t0 = time.time()
        prob = problems.generate_problem(n=n, d=d, noise_scale=s, seed=0, device=device)
        dt = (time.time() - t0) * 1e6
        rows.append(row(n, s, prob.sigma_A, dt, tracker))
    return rows
