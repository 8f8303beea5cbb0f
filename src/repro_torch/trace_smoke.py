"""Seeded chaos training run emitting a JSONL span trace (counterpart of
``benchmarks/trace_smoke.py``).

    PYTHONPATH=src python -m repro_torch.trace_smoke [--out runs/trace/run.jsonl] [--device cpu]
    PYTHONPATH=src python -m repro_torch.obs.analyze runs/trace/run.jsonl

Drives MARINA-P (PermK, Polyak) on the paper's L1 workload (n = 8, d = 64)
through a fault-injected fleet (drop + straggler: the acceptance chaos model
of the trace pipeline) with a :class:`repro_torch.obs.JsonlTracker`
attached, on ``--device`` (default the card), so that the log carries the
full round/subgrad/stepsize/broadcast/link span tree (DESIGN.md §10).
``repro_torch.obs.analyze`` then validates the spans, exports a Perfetto
trace and attributes degraded rounds to worker links.

Deterministic: the fault injectors, the algorithm's draws and the span ids
are seeded, so two runs produce structurally identical span trees
(timestamps aside).
"""
from __future__ import annotations

import argparse
import os

from . import obs
from .core import marina_p, problems, stepsizes
from .transport import FaultSpec

CHAOS_SPEC = FaultSpec(drop=0.15, straggler=0.2, straggler_ticks=3, seed=7)
ROUNDS = 24


def run(out: str, *, rounds: int = ROUNDS, seed: int = 1, device="cuda") -> str:
    prob = problems.generate_problem(n=8, d=64, noise_scale=1.0, seed=0, device=device)
    k = prob.d // prob.n
    p = k / prob.d
    ss = stepsizes.MarinaPPolyak(omega=prob.n - 1, p=p, f_star=prob.f_star)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    tr = obs.JsonlTracker(out)
    marina_p.run(prob, mode="perm", k=k, p=p, stepsize=ss, T=rounds,
                 seed=seed, transport=CHAOS_SPEC, tracker=tr)
    tr.finish()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="runs/trace/run.jsonl")
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    path = run(args.out, rounds=args.rounds, seed=args.seed, device=args.device)
    n_spans = sum(1 for e in obs.read_jsonl(path) if e.get("kind") == "span")
    print(f"wrote {path} ({n_spans} span events over {args.rounds} rounds)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
