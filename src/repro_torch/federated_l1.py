"""Full paper-experiment driver (Figure 1 / Figure 7 reproduction) on the port.

Runs EF21-P(TopK) and MARINA-P(sameRandK / indRandK / PermK) under constant
and Polyak stepsizes for every (n, noise-scale) cell, with the paper's
bit-accounting, and writes a CSV of the runs (port of
``examples/federated_l1.py``; each cell is :func:`repro_torch.fig1.run_suite`).

Run (reduced):  PYTHONPATH=src python -m repro_torch.federated_l1
Paper scale:    PYTHONPATH=src python -m repro_torch.federated_l1 --paper
Client zoo:     PYTHONPATH=src python -m repro_torch.federated_l1 --fleet

The reduced grid is d = 200, n = 10, noise s in {0.1, 1, 10} at a budget of
4e6 downlink bits a worker; ``--paper`` is d = 1000, n = 10 (3.5e8 bits) and
n = 100 (3.5e7 bits) for the same s. Every run stops at the first round at or
past its budget.

``--fleet`` swaps the fixed worker list for a heterogeneous client
population (repro_torch.fleet, DESIGN.md §9): two data tiers — 70% low-noise
"edge" clients and 30% high-noise "dc" clients with 4x the data — behind
a 50%-duty diurnal availability trace. Each round an availability-window
sampler draws a small cohort from the population, so the run prices
join syncs and partial participation the way a real cross-device
deployment would.

Everything runs on ``--device`` (default the card; ``--device cpu`` runs the
plain versions).
"""
from __future__ import annotations

import argparse
import csv
import os
import time

from .core import stepsizes
from .fig1 import run_suite
from .fleet import FleetL1Problem, fleet_run, make_fleet, make_sampler

CSV_HEADER = ["d", "n", "noise", "method", "final_subopt", "rounds", "bits_per_worker"]
# (d, n, noise scale, downlink bit budget a worker)
PAPER_CELLS = [(1000, 10, s, 3.5e8) for s in (0.1, 1.0, 10.0)] + [
    (1000, 100, s, 3.5e7) for s in (0.1, 1.0, 10.0)
]
REDUCED_CELLS = [(200, 10, s, 4e6) for s in (0.1, 1.0, 10.0)]


def fleet_demo(out_path: str, *, population: int, cohort: int, d: int, T: int,
               device="cuda"):
    """Heterogeneous client mix through the fleet API (two tiers +
    availability trace), MARINA-P vs EF21-P under constant and Polyak;
    writes one CSV row per method and returns {method: history}."""
    spec = make_fleet("two_tier_diurnal", population, seed=0)
    prob = FleetL1Problem(spec, d=d)
    sampler = make_sampler("availability", spec, cohort, seed=0)
    k = max(1, d // cohort)
    runs = {
        "marina_p_perm_const": dict(
            algorithm="marina_p",
            stepsize=stepsizes.Constant(gamma=0.05)),
        "marina_p_perm_polyak": dict(
            algorithm="marina_p",
            stepsize=stepsizes.MarinaPPolyak(omega=float(cohort - 1), p=k / d)),
        "ef21p_topk_polyak": dict(
            algorithm="ef21p",
            stepsize=stepsizes.EF21PPolyak(alpha=k / d)),
    }
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    hists = {}
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["method", "final_f", "rounds", "s2w_bits", "join_bits",
                    "participants_mean", "unique_clients", "fresh_frac", "goodput"])
        for name, kw in runs.items():
            h = fleet_run(prob, sampler, kw["stepsize"], algorithm=kw["algorithm"],
                          mode="perm", k=k, T=T, seed=0, device=device)
            hists[name] = h
            st = h["participation"]
            row = [name, h["f_x"][-1], T, h["s2w_bits_total"], h["join_bits_total"],
                   st.participant_rounds / max(st.rounds, 1), st.unique_clients,
                   st.fresh_frac, st.goodput]
            w.writerow(row)
            print(f"{name:22s} f={h['f_x'][-1]:8.4f} "
                  f"s2w={h['s2w_bits_total']:.3g}b join={h['join_bits_total']:.3g}b "
                  f"cohort~{row[5]:.1f} clients={st.unique_clients} "
                  f"fresh={st.fresh_frac:.2f}")
    print(f"wrote {out_path}")
    return hists


def run_cells(cells, out_path: str, *, device="cuda"):
    """One :func:`run_suite` per (d, n, noise, budget) cell, each run's row
    written to ``out_path`` with the reference's columns and printed; returns
    {cell: run_suite's results}."""
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    results = {}
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(CSV_HEADER)
        for d, n, s, budget in cells:
            t0 = time.perf_counter()
            res = run_suite(d=d, n=n, noise=s, budget_bits=budget, device=device)
            results[d, n, s, budget] = res
            for name, r in res.items():
                w.writerow([d, n, s, name, r["final_subopt"], r["rounds"], r["bits_per_worker"]])
                print(f"d={d} n={n:3d} s={s:5.1f} {name:22s} "
                      f"f-f*={r['final_subopt']:.4f} rounds={r['rounds']}")
            print(f"cell d={d} n={n} s={s} budget={budget:g}: {time.perf_counter() - t0:.1f} s on "
                  f"{device}", flush=True)
    print(f"wrote {out_path}")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--paper", action="store_true", help="d=1000, n in {10,100}")
    ap.add_argument("--fleet", action="store_true",
                    help="heterogeneous client-zoo demo (two tiers + diurnal windows)")
    ap.add_argument("--population", type=int, default=50_000)
    ap.add_argument("--cohort", type=int, default=16)
    ap.add_argument("-T", type=int, default=200)
    ap.add_argument("--out", default=None,
                    help="CSV path (default runs/federated_l1.csv, with --fleet runs/federated_l1_fleet.csv)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.fleet:
        fleet_demo(args.out or "runs/federated_l1_fleet.csv", population=args.population,
                   cohort=args.cohort, d=128, T=args.T, device=args.device)
        return 0
    run_cells(PAPER_CELLS if args.paper else REDUCED_CELLS, args.out or "runs/federated_l1.csv",
              device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
