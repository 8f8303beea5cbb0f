"""Roofline terms of a counted step on the NVIDIA H100 (counterpart of
``repro/launch/roofline.py``).

Hardware constants: one H100 SXM at its 700 W power limit (NVIDIA H100 data
sheet; dense rates, no sparsity):
    peak bf16 tensor-core compute  989.4e12 FLOP/s per card
    HBM3 bandwidth                 3.35e12  B/s  per card
    NVLink bandwidth               450e9    B/s  per card, each direction

Terms per counted step, from PER-DEVICE totals:
    compute    = flops_per_device      / PEAK_FLOPS
    memory     = bytes_per_device      / HBM_BW
    collective = coll_bytes_per_device / LINK_BW   (None: nothing counted)

The reference parses collective bytes from its compiled HLO
(``collective_bytes``: each collective's result-shape bytes, its proxy for
the bytes moved). The port counts the same quantity where its program
calls the collectives: the sharded train step's communicator
(``train/sharded.py``) charges each ``all-gather``, ``reduce-scatter`` and
``all-reduce`` at its result bytes per device, and the dry-run's ``per_rank``
records price their sum over one card's NVLink bandwidth. A count without
collectives (the ``even`` split of a whole-mesh count, whose reference
program is tensor-parallel over "model") passes ``None``: ``collective_s``
is then ``None``, and ``dominant`` / ``bound_s`` are taken over the terms
that exist (never reading a missing term as 0).
"""
from __future__ import annotations

from typing import Optional

PEAK_FLOPS = 989.4e12
HBM_BW = 3.35e12
LINK_BW = 450e9


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   coll_bytes_per_device: Optional[float] = None) -> dict:
    """Terms in seconds (``compute_s``, ``memory_s``, ``collective_s``),
    the ``dominant`` one and ``bound_s``, its value: the least time the
    step could take on one card."""
    terms = {
        "compute_s": flops_per_device / PEAK_FLOPS,
        "memory_s": bytes_per_device / HBM_BW,
        "collective_s": None if coll_bytes_per_device is None else coll_bytes_per_device / LINK_BW,
    }
    dominant = max((k for k, v in terms.items() if v is not None), key=terms.get)
    terms["dominant"] = dominant
    terms["bound_s"] = terms[dominant]
    return terms


def model_flops(cfg, kind: str, global_batch: int, seq: int) -> float:
    """Analytic MODEL_FLOPS: 6*N*D for training, 2*N*D for inference
    (N = active params, D = tokens processed this step)."""
    n_active = cfg.active_param_count()
    if kind == "train":
        return 6.0 * n_active * global_batch * seq
    if kind == "prefill":
        return 2.0 * n_active * global_batch * seq
    # decode: one token per sequence
    return 2.0 * n_active * global_batch
