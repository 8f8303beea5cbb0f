"""Measured against analytic downlink bits per round, on the port.

Counterpart of ``benchmarks/wire_bench.py::parity_rows``: MARINA-P in
``same`` / ``ind`` / ``perm`` mode (k = d/n, p = 1/n) and EF21-P with
``BlockTopK(16, 128)``, constant stepsize 0.02, run with
``measure_wire=True``; each row is the wire-matched analytic ledger's bits
per round (value_bits 32), the measured bits per round, and their gap.
DESIGN.md §3.5 requires a gap below 5% for the three MARINA-P modes.

    PYTHONPATH=src python -m repro_torch.wire_bench [--device cpu] [--T 200]

Runs at the reference's setting (d=1024, n=4) and at the paper's (d=1000,
n=10) on ``--device`` (default the card, where the messages are encoded by
the device path); exits 1 if a MARINA-P gap reaches 5%.
"""
from __future__ import annotations

import argparse
import sys
import time

from .core import compressors as C
from .core import ef21p, marina_p, problems, stepsizes

SETTINGS = ((1024, 4), (1000, 10))  # (d, n): the reference's bench, the paper's Figure 1
GAP_LIMIT_PCT = 5.0


def parity_rows(*, d: int, n: int, T: int = 200, device="cuda"):
    """[(name, analytic bits/round, measured bits/round, gap %)] for the four runs."""
    prob = problems.generate_problem(n=n, d=d, noise_scale=1.0, seed=0, device=device)
    ss = stepsizes.Constant(gamma=0.02)
    hists = {
        f"marina_p/{mode}": marina_p.run(prob, mode=mode, k=d // n, p=1.0 / n, stepsize=ss, T=T,
                                         measure_wire=True)
        for mode in ("same", "ind", "perm")
    }
    hists["ef21p/block_topk"] = ef21p.run(prob, C.BlockTopK(k_per_block=16, block=128), ss, T=T,
                                          measure_wire=True)
    rows = []
    for name, h in hists.items():
        a, w = h["wire_model_ledger"].s2w_bits, h["wire_bits_total"]
        rows.append((name, a / T, w / T, 100.0 * (w - a) / a))
    return rows


def failures(rows) -> list:
    return [(name, pct) for name, _, _, pct in rows
            if name.startswith("marina_p/") and not abs(pct) < GAP_LIMIT_PCT]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--T", type=int, default=200)
    args = ap.parse_args(argv)
    bad = []
    for d, n in SETTINGS:
        t0 = time.perf_counter()
        rows = parity_rows(d=d, n=n, T=args.T, device=args.device)
        print(f"== d={d} n={n} T={args.T} on {args.device}: measured vs analytic bits/round "
              f"({time.perf_counter() - t0:.1f} s)")
        for name, analytic, measured, pct in rows:
            print(f"{name:20s} analytic={analytic:12.1f}  wire={measured:12.1f}  gap={pct:+.3f}%")
        bad += [(d, n, name, pct) for name, pct in failures(rows)]
    if bad:
        print(f"PARITY FAILURES (gap >= {GAP_LIMIT_PCT}%): {bad}", file=sys.stderr)
        return 1
    print(f"parity OK: every MARINA-P mode within {GAP_LIMIT_PCT}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
