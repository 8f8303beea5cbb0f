"""Baseline distributed subgradient method SM (paper eq. (5)), on tensors.

Port of ``repro/core/subgradient.py``.
x^{t+1} = x^t - (gamma_t/n) sum_i df_i(x^t); the server broadcasts the full
x^{t+1} (dense downlink, 64*d bits/worker/round). This is the comparison
floor of Corollaries 1 & 2.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .comm_model import CommLedger, CommModel
from .problems import L1Problem
from .stepsizes import Stepsize, descent_step


class SMState(NamedTuple):
    x: torch.Tensor
    t: int


def init(x0: torch.Tensor) -> SMState:
    return SMState(x=x0, t=0)


def make_step(problem: L1Problem, stepsize: Stepsize):
    """Round function ``step(state) -> (state, metrics)``; SM draws nothing."""

    def step(state: SMState):
        xs = state.x.expand(problem.n, problem.d)
        g_all = problem.subgrad_all(xs)
        g = torch.mean(g_all, dim=0)
        aux = {
            "f_w": problem.f(state.x),
            "g_norm_sq": torch.sum(g**2),
            "g_sq_mean": torch.mean(torch.sum(g_all**2, dim=-1)),
        }
        gamma = stepsize(state.t, aux)
        x_new = descent_step(state.x, gamma, g)
        metrics = {"f_x": problem.f(x_new), "gamma": gamma}
        return SMState(x=x_new, t=state.t + 1), metrics

    return step


def run(
    problem: L1Problem,
    stepsize: Stepsize,
    *,
    T: Optional[int] = None,
    bit_budget: Optional[float] = None,
    record_every: int = 1,
):
    """Host loop on the problem's device; stops after T rounds or when the
    per-worker downlink ``bit_budget`` is spent. SM draws nothing, so unlike
    the reference it takes no ``seed``."""
    if T is None and bit_budget is None:
        raise ValueError("run needs T or bit_budget")
    ledger = CommLedger(model=CommModel(d=problem.d))
    step = make_step(problem, stepsize)
    state = init(problem.x0)
    hist = {"t": [], "f_x": [], "gamma": [], "s2w_bits": []}
    t = 0
    while True:
        if T is not None and t >= T:
            break
        if bit_budget is not None and ledger.s2w_bits >= bit_budget:
            break
        state, m = step(state)
        ledger.log_s2w_dense()
        ledger.tick()
        if t % record_every == 0:
            hist["t"].append(t)
            hist["f_x"].append(float(m["f_x"]))
            hist["gamma"].append(float(m["gamma"]))
            hist["s2w_bits"].append(ledger.s2w_bits)
        t += 1
    hist["final_state"] = state
    hist["ledger"] = ledger
    return hist
