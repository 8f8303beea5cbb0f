"""Deprecated: folded into ``repro_torch.scenario_matrix`` (counterpart of
``benchmarks/stepsize_grid.py``).

The Table 3/6 Polyak-factor sweep is the stepsize axis of the scenario
matrix (``scenario_matrix.polyak_factor_grid`` / ``scenario_matrix.tune``).
This shim keeps the ``stepsize_grid`` suite name in ``repro_torch.run`` and
its historical row names stable.
"""
from __future__ import annotations

import warnings

from .scenario_matrix import polyak_factor_grid, tune  # noqa: F401


def bench(tracker=None, **kwargs):
    warnings.warn(
        "repro_torch.stepsize_grid is deprecated; use "
        "repro_torch.scenario_matrix.polyak_factor_grid (the stepsize axis "
        "of the scenario matrix)",
        DeprecationWarning,
        stacklevel=2,
    )
    return polyak_factor_grid(tracker=tracker, **kwargs)
