"""The client-zoo demo of ``examples/federated_l1.py --fleet`` on the port.

    PYTHONPATH=src python -m repro_torch.federated_l1 [--population N] [--cohort C] [-T T] [--device cpu]

:func:`fleet_demo` swaps the fixed worker list of Figure 1
(:mod:`repro_torch.fig1`) for a heterogeneous client population
(repro_torch.fleet, DESIGN.md §9): two data tiers — 70% low-noise "edge"
clients and 30% high-noise "dc" clients with 4x the data — behind a
50%-duty diurnal availability trace. Each round an
availability-window sampler draws a small cohort from the population, so the
run prices join syncs and partial participation the way a real cross-device
deployment would. Everything runs on ``--device`` (default the card).
"""
from __future__ import annotations

import argparse
import csv
import os

from .core import stepsizes
from .fleet import FleetL1Problem, fleet_run, make_fleet, make_sampler


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--population", type=int, default=50_000)
    ap.add_argument("--cohort", type=int, default=16)
    ap.add_argument("-T", type=int, default=200)
    ap.add_argument("--out", default="runs/federated_l1_fleet.csv")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    fleet_demo(args.out, population=args.population, cohort=args.cohort, d=128, T=args.T,
               device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
