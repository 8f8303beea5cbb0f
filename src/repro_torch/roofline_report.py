"""Render the dry-run roofline table from the port's records
(``repro_torch.launch.dryrun``; counterpart of
``benchmarks/roofline_report.py``), with the measured columns of a record
that carries a card run (``--measure``).

    PYTHONPATH=src python -m repro_torch.roofline_report [runs/dryrun_torch]
"""
from __future__ import annotations

import glob
import json
import os

from .launch.dryrun import DEFAULT_OUT

DEFAULT_DIR = os.environ.get("DRYRUN_DIR", DEFAULT_OUT)


def load(dirpath=None, mesh="16x16"):
    """The records of ``dirpath`` (default :data:`DEFAULT_DIR`) for ``mesh``
    (None: every mesh)."""
    recs = []
    for f in sorted(glob.glob(os.path.join(dirpath or DEFAULT_DIR, "*.json"))):
        with open(f) as fh:
            r = json.load(fh)
        if mesh is None or r.get("mesh") == mesh:
            recs.append(r)
    return recs


def _fmt(x, spec=".3e"):
    return "—" if x is None else format(x, spec)


def markdown_table(recs):
    """One row a record: how its per-device count was taken (``split``:
    ``per_rank``, one rank of the port's sharded step with its collectives;
    ``even``, the whole step's count over the mesh's devices, with no
    collective term), the H100 roofline terms of that count, MODEL_FLOPS and
    the useful ratio, the arguments' bytes; then, where measured on a card,
    ms, peak memory, the bound of the same reduced step, roofline_share, mfu
    and the card."""
    hdr = ("| arch | shape | split | compute_s | memory_s | collective_s | dominant | MODEL_FLOPS | useful ratio | "
           "argument bytes | measured ms | peak GiB | bound ms | roofline share | mfu | card |\n"
           "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---|\n")
    lines = []
    for r in sorted(recs, key=lambda r: (r["arch"], r["shape"])):
        t, m = r["roofline"], r.get("measured")
        meas = ["—"] * 6
        if m:
            meas = [f"{m['ms']:.3f}", f"{m['peak_bytes'] / 2**30:.2f}",
                    f"{m['roofline']['bound_s'] * 1e3:.3f}", f"{m['roofline_share']:.4f}",
                    _fmt(m["mfu"], ".4f"), m["card"]]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r.get('split', 'even')} | {t['compute_s']:.3e} | {t['memory_s']:.3e} | "
            f"{_fmt(t['collective_s'])} | "
            f"{t['dominant'].replace('_s', '')} | {r['model_flops']:.3e} | "
            f"{_fmt(r['useful_flops_ratio'], '.3f')} | {r['argument_bytes']:.3e} | " + " | ".join(meas) + " |")
    return hdr + "\n".join(lines)


def bench(dirpath=None, tracker=None):
    """Rows (name, us_per_call, derived) for the harness: each record's
    bound in seconds (the count's time as us_per_call), and a measured
    record's roofline share; a record of another mesh than 16x16 (the
    multi-pod and hierarchical ones) or of the ``act_spec`` step names them
    after the shape. Raises where there is no record to report."""
    recs = load(dirpath, mesh=None)
    if not recs:
        raise FileNotFoundError(f"no dry-run records under {dirpath or DEFAULT_DIR}: "
                                "run python -m repro_torch.launch.dryrun first")
    rows = []
    for r in recs:
        name = (f"roofline/{r['arch']}/{r['shape']}" + ("" if r["mesh"] == "16x16" else f"/{r['mesh']}")
                + ("/act" if r.get("act_spec") else ""))
        rows.append((f"{name}/bound_s", r["t_count_s"] * 1e6, r["roofline"]["bound_s"]))
        if "measured" in r:
            rows.append((f"{name}/roofline_share", r["measured"]["ms"] * 1e3, r["measured"]["roofline_share"]))
    return rows


if __name__ == "__main__":
    import sys

    print(markdown_table(load(sys.argv[1] if len(sys.argv) > 1 else None)))
