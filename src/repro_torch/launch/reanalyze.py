"""Re-derive roofline terms from saved dry-run records without counting
again (counterpart of ``repro/launch/reanalyze.py``, which re-derives them
from saved ``.hlo.gz``): the records keep their global counts
(``flops_global``, ``bytes_global``; a ``per_rank`` record its per-device
counts and ``collective_total_per_device``; a measured step's ``flops`` /
``bytes`` / ``ms``), so new constants in :mod:`.roofline` apply to them.

Usage: PYTHONPATH=src python -m repro_torch.launch.reanalyze runs/dryrun_torch [out_dir]
"""
from __future__ import annotations

import glob
import json
import os
import sys

from .. import obs
from . import roofline
from .dryrun import derive_measured

log = obs.get_logger("reanalyze")


def reanalyze(dirpath: str, out_dir: str | None = None) -> list:
    """Rewrite every record of ``dirpath`` into ``out_dir`` (default: in
    place) with its per-device counts, roofline, useful-FLOPs ratio and
    measured share re-derived; returns the records."""
    out_dir = out_dir or dirpath
    os.makedirs(out_dir, exist_ok=True)
    recs = []
    for jf in sorted(glob.glob(os.path.join(dirpath, "*.json"))):
        with open(jf) as f:
            rec = json.load(f)
        if rec.get("split") != "per_rank":  # one count for the mesh, split evenly
            rec["flops_per_device"] = rec["flops_global"] / rec["chips"]
            rec["bytes_per_device"] = rec["bytes_global"] / rec["chips"]
        rec["roofline"] = roofline.roofline_terms(rec["flops_per_device"], rec["bytes_per_device"],
                                                  rec.get("collective_total_per_device"))
        if rec.get("model_flops") and rec["flops_global"]:
            rec["useful_flops_ratio"] = rec["model_flops"] / rec["flops_global"]
        if "measured" in rec:
            rec["measured"] = derive_measured(rec["measured"], rec["kind"])
        with open(os.path.join(out_dir, os.path.basename(jf)), "w") as f:
            json.dump(rec, f, indent=1)
        t = rec["roofline"]
        log.info(f"{rec['arch']:26s} {rec['shape']:12s} {rec['mesh']:8s} "
                 f"dom={t['dominant'][:4]} bound={t['bound_s']:.3e}")
        obs.default_tracker().log({"reanalyze": {
            "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
            "flops_per_device": rec["flops_per_device"], "bytes_per_device": rec["bytes_per_device"],
            "bound_s": t["bound_s"], "dominant": t["dominant"]}})
        recs.append(rec)
    return recs


if __name__ == "__main__":
    reanalyze(sys.argv[1], sys.argv[2] if len(sys.argv) > 2 else None)
