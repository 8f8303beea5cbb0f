"""Core library, ported from ``repro.core``: the paper's algorithms on tensors.

* problems    — the paper's L1 workload + Algorithm 3 datagen
* comm_model  — Definition 1/4 bit accounting + Corollary 1/2 predictions
* stepsizes   — constant / decreasing / Polyak schedules + theory constants
* compressors — Identity, TopK, BlockTopK, RandK, PermK
* subgradient — baseline distributed SM (eq. 5)
* ef21p       — distributed EF21-P (Algorithm 1)
* marina_p    — non-smooth MARINA-P (Algorithm 2), three broadcast modes
* distributed — both algorithms' rounds as SPMD steps over a torch.distributed group
* jax_random  — numpy port of the jax.random draws the SEED/PERM decode needs
"""
from . import comm_model, compressors, ef21p, marina_p, problems, stepsizes, subgradient  # noqa: F401
