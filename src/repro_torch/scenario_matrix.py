"""Scenario matrix of the port (counterpart of
``benchmarks/scenario_matrix.py``): (algorithm x stepsize scheme x client
mix) cells.

    PYTHONPATH=src python -m repro_torch.scenario_matrix [--full] [--out DIR] [--device cpu]

Every cell drives :func:`repro_torch.fleet.fleet_run` over a declarative
client population on ``--device`` (default the card) and writes one
schema-versioned ``BENCH_scenario_<cell>.json`` artifact (repro_torch.obs
sink fan-out) reporting rounds-to-target, downlink bits (analytic 64-bit
model + measured wire bytes) and participation/goodput stats; :func:`bench`
returns the reference's gated row set per cell.

The paper's Table 3/6 Polyak-factor sweep is folded in as
:func:`polyak_factor_grid` (the stepsize axis of the matrix), with
``repro_torch.stepsize_grid`` as its deprecation shim, as in the reference.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import obs
from .core import compressors as C
from .core import ef21p, marina_p, problems, stepsizes
from .fleet import FleetL1Problem, fleet_run, make_fleet, make_sampler

DEFAULT_OUT = os.environ.get("REPRO_BENCH_DIR", "runs/bench")

# mix -> the sampler that exercises its heterogeneity axis
MIX_SAMPLER = {
    "uniform": "uniform",
    "two_tier": "weighted",
    "two_tier_diurnal": "availability",
    "flaky_mobile": "deadline:2.5",
}

# default 2 x 2 x 2 matrix; --full widens
DEFAULT_CELLS: List[Tuple[str, str, str]] = [
    (alg, scheme, mix)
    for alg in ("marina_p", "ef21p")
    for scheme in ("constant", "polyak")
    for mix in ("uniform", "two_tier_diurnal")
]
FULL_CELLS: List[Tuple[str, str, str]] = [
    (alg, scheme, mix)
    for alg in ("marina_p", "ef21p")
    for scheme in ("constant", "decreasing", "polyak")
    for mix in ("uniform", "two_tier", "two_tier_diurnal", "flaky_mobile")
]


def cell_id(alg: str, scheme: str, mix: str) -> str:
    return f"{alg}-{scheme}-{mix}".replace(":", "")


def _build_stepsize(alg: str, scheme: str, prob, k: int, p: float, n_eff: int, T: int):
    alpha = k / prob.d
    omega = float(n_eff - 1)  # perm-mode broadcast over the cohort slots
    if scheme == "polyak":
        if alg == "ef21p":
            return stepsizes.EF21PPolyak(alpha=alpha, f_star=0.0)
        return stepsizes.MarinaPPolyak(omega=omega, p=p, f_star=0.0)
    L0_bar, L0_tilde = prob.lipschitz_estimates()
    V0 = prob.R0_sq
    if scheme == "constant":
        if alg == "ef21p":
            return stepsizes.Constant(
                gamma=stepsizes.ef21p_optimal_constant(V0, L0_bar, alpha, T))
        return stepsizes.Constant(
            gamma=stepsizes.marina_p_optimal_constant(V0, L0_bar, L0_tilde, omega, p, T))
    if scheme == "decreasing":
        if alg == "ef21p":
            return stepsizes.Decreasing(
                gamma0=stepsizes.ef21p_optimal_decreasing_gamma0(V0, L0_bar, alpha, T))
        return stepsizes.Decreasing(
            gamma0=stepsizes.marina_p_optimal_decreasing_gamma0(
                V0, L0_bar, L0_tilde, omega, p, T))
    raise ValueError(f"unknown stepsize scheme: {scheme!r}")


def run_cell(
    alg: str,
    scheme: str,
    mix: str,
    *,
    population: int = 4096,
    cohort: int = 16,
    d: int = 64,
    T: int = 120,
    target_frac: float = 0.3,
    seed: int = 0,
    measure_wire: bool = True,
    tracker=None,
    device="cuda",
) -> Dict[str, float]:
    """One matrix cell -> flat metrics dict (the per-cell artifact body)."""
    spec = make_fleet(mix, population, seed=seed)
    prob = FleetL1Problem(spec, d=d)
    sampler = make_sampler(MIX_SAMPLER[mix], spec, cohort, seed=seed)
    k = max(1, d // cohort)
    p = k / d
    stepsize = _build_stepsize(alg, scheme, prob, k, p, cohort, T)
    # rounds-to-target on the fixed eval cohort: reach target_frac * f(x0)
    A_eval = prob.materialize(prob.eval_cohort(64)).astype(np.float32)
    f0 = float(np.mean(np.abs(A_eval @ prob.x0.astype(np.float32)).sum(axis=-1)))
    target = target_frac * f0
    hist = fleet_run(
        prob, sampler, stepsize, algorithm=alg, mode="perm", k=k, p=p,
        T=T, target=target, seed=seed, measure_wire=measure_wire,
        tracker=tracker, device=device,
    )
    stats = hist["participation"]
    out = {
        "rounds_to_target": float(hist["rounds_to_target"]),
        "target": target,
        "f0": f0,
        "final_f": hist["f_x"][-1],
        "downlink_bits_analytic": hist["s2w_bits_total"],
        "downlink_bits_per_participant_round": hist["bits_per_participant_round"],
        "uplink_bits_analytic": hist["w2s_bits_total"],
        "join_bits_analytic": hist["join_bits_total"],
        "participants_mean": stats.participant_rounds / max(stats.rounds, 1),
        "unique_clients": float(stats.unique_clients),
        "mean_fill": stats.mean_fill,
        "fresh_frac": stats.fresh_frac,
        "goodput": stats.goodput,
    }
    if measure_wire:
        out["downlink_bits_measured"] = hist["wire_bits_total"]
    return out


def bench(
    tracker=None,
    out_dir: Optional[str] = None,
    cells: Optional[Sequence[Tuple[str, str, str]]] = None,
    *,
    population: int = 4096,
    cohort: int = 16,
    d: int = 64,
    T: int = 120,
    seed: int = 0,
    measure_wire: bool = True,
    device="cuda",
):
    """Run the matrix; one BENCH_scenario_<cell>.json per cell plus the
    reference's aggregate rows (name, us_per_call, derived)."""
    out_dir = out_dir or DEFAULT_OUT
    cells = list(cells if cells is not None else DEFAULT_CELLS)
    rows = []
    for alg, scheme, mix in cells:
        cid = cell_id(alg, scheme, mix)
        sink = obs.BenchJsonSink(f"scenario_{cid}", out_dir, seed=seed, gates=[])
        cell_tracker = obs.CompositeTracker(sink, tracker)
        t0 = time.time()
        m = run_cell(alg, scheme, mix, population=population, cohort=cohort,
                     d=d, T=T, seed=seed, measure_wire=measure_wire,
                     tracker=cell_tracker, device=device)
        dt_us = (time.time() - t0) * 1e6
        sink.log(m)
        sink.finish()
        rows.append((f"scenario/{cid}/rounds_to_target", dt_us, m["rounds_to_target"]))
        rows.append((f"scenario/{cid}/s2w_bits", dt_us, m["downlink_bits_analytic"]))
        rows.append((f"scenario/{cid}/goodput", dt_us, m["goodput"]))
        rows.append((f"scenario/{cid}/final_f", dt_us, m["final_f"]))
    return rows


# ---------------------------------------------------------------------------
# Folded-in stepsize axis (benchmarks/stepsize_grid.py in the reference):
# paper Table 3/6 tuned multiplicative Polyak factors, App. A protocol. Row
# names keep the historical ``stepsize_grid/...`` prefix.
# ---------------------------------------------------------------------------


def tune(method: str, prob, T=250, factors=None, seed=0):
    """Sweep the factor grid for one method ("ef21p", "same", "ind" or
    "perm"); return (best factor, final f)."""
    d, n = prob.d, prob.n
    k = max(1, d // n)
    p, alpha = k / d, k / d
    factors = factors or [2.0**e for e in range(-7, 6, 2)]
    best = (None, float("inf"))
    for f in factors:
        if method == "ef21p":
            ss = stepsizes.EF21PPolyak(alpha=alpha, f_star=0.0, factor=f)
            h = ef21p.run(prob, C.TopK(k=k), ss, T=T, seed=seed, record_every=T - 1)
        else:
            omega = float(n - 1) if method == "perm" else d / k - 1.0
            ss = stepsizes.MarinaPPolyak(omega=omega, p=p, f_star=0.0, factor=f)
            h = marina_p.run(prob, mode=method, k=k, p=p, stepsize=ss, T=T,
                             seed=seed, record_every=T - 1)
        final = h["f_x"][-1]
        if final < best[1]:
            best = (f, final)
    return best


def polyak_factor_grid(tracker=None, *, prob=None, T=250, factors=None,
                       methods=("ef21p", "same", "ind", "perm"), seed=0, device="cuda"):
    """The legacy stepsize_grid suite body (row names unchanged); the default
    problem is Algorithm 3 at n = 10, d = 120 on ``device``."""
    rows = []
    if prob is None:
        prob = problems.generate_problem(n=10, d=120, noise_scale=1.0, seed=0, device=device)
    for method in methods:
        t0 = time.time()
        f, final = tune(method, prob, T=T, factors=factors, seed=seed)
        dt = (time.time() - t0) * 1e6
        rows.append((f"stepsize_grid/polyak/{method}/best_factor", dt, f))
        rows.append((f"stepsize_grid/polyak/{method}/final_subopt", dt, final))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--full", action="store_true",
                    help="full matrix (3 schemes x 4 mixes) instead of the 2x2x2 default")
    ap.add_argument("--population", type=int, default=4096)
    ap.add_argument("--cohort", type=int, default=16)
    ap.add_argument("-d", type=int, default=64)
    ap.add_argument("-T", type=int, default=120)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = bench(out_dir=args.out, cells=FULL_CELLS if args.full else None,
                 population=args.population, cohort=args.cohort, d=args.d,
                 T=args.T, seed=args.seed, device=args.device)
    print("name,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
