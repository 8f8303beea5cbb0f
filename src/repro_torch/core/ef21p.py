"""EF21-P, distributed version (Algorithm 1; single-node Algorithm 4), on tensors.

Port of ``repro/core/ef21p.py`` (main path and the measured wire bits; no
transport, participation or tracing yet). Per round t:
    workers:  g_i = df_i(w^t)            -> server        (uplink, exact)
    server:   gamma_t from schedule      (constant / decreasing / Polyak (13))
              x^{t+1} = x^t - gamma_t * mean_i g_i
              Delta = C(x^{t+1} - w^t)   -> all workers    (downlink, compressed)
              w^{t+1} = w^t + Delta      (identical on server & workers)

The Lyapunov function of Theorem 1:
V^t = ||x-x*||^2 + (1/(lambda* theta)) ||w-x||^2.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import wire
from .comm_model import CommLedger, CommModel
from .compressors import ContractiveCompressor
from .problems import L1Problem
from .stepsizes import Stepsize, descent_step, ef21p_lambda_star


class EF21PState(NamedTuple):
    x: torch.Tensor  # server iterate [d]
    w: torch.Tensor  # synchronized shift [d]
    t: int  # round counter


def init(x0: torch.Tensor) -> EF21PState:
    """w^0 = x^0 (Algorithm 1, line 1)."""
    return EF21PState(x=x0, w=x0, t=0)


def lyapunov(state: EF21PState, x_star: torch.Tensor, alpha: float) -> torch.Tensor:
    lam = ef21p_lambda_star(alpha)
    theta = 1.0 - (1.0 - alpha) ** 0.5
    return torch.sum((state.x - x_star) ** 2) + torch.sum((state.w - state.x) ** 2) / (
        lam * theta
    )


def make_step(problem: L1Problem, comp: ContractiveCompressor, stepsize: Stepsize,
              *, return_delta: bool = False):
    """Round function ``step(state, draws) -> (state, metrics)``; ``draws``
    is what ``comp.draw`` made for this round (None for TopK/BlockTopK).
    ``return_delta=True`` also returns the broadcast message ``delta``."""

    def step(state: EF21PState, draws=None):
        # --- workers: subgradients at the shared shift w^t ------------------
        w_stack = state.w.expand(problem.n, problem.d)
        g_all = problem.subgrad_all(w_stack)  # [n, d]
        f_all = problem.f_all(w_stack)
        # --- server: stepsize (Polyak needs f(w^t) and ||g||^2) -------------
        g = torch.mean(g_all, dim=0)
        aux = {"f_w": torch.mean(f_all), "g_norm_sq": torch.sum(g**2)}
        gamma = stepsize(state.t, aux)
        x_new = descent_step(state.x, gamma, g)
        # --- downlink: compressed difference ---------------------------------
        delta = comp(x_new - state.w, draws)
        w_new = state.w + delta
        metrics = {
            "f_x": problem.f(x_new),
            "f_w": aux["f_w"],
            "gamma": gamma,
            "delta_nnz": torch.sum(delta != 0).to(torch.float32),
        }
        if return_delta:
            metrics["delta"] = delta
        return EF21PState(x=x_new, w=w_new, t=state.t + 1), metrics

    return step


def run(
    problem: L1Problem,
    comp: ContractiveCompressor,
    stepsize: Stepsize,
    *,
    T: Optional[int] = None,
    bit_budget: Optional[float] = None,
    seed: int = 0,
    record_every: int = 1,
    measure_wire: bool = False,
    wire_mag: str = "fp32",
    device_encode: Optional[bool] = None,
):
    """Host loop on the problem's device; returns the history dict.

    ``measure_wire=True`` also SPARSE-encodes every round's broadcast
    ``delta`` and tracks the measured bits (hist["wire_bits"],
    hist["wire_bits_total"]) next to a second analytic ledger whose
    value_bits match ``wire_mag`` (hist["wire_model_ledger"], DESIGN.md
    §3.5); the primary ledger keeps the paper's 64-bit model.
    ``device_encode``: True the device path (``kernels/encode.py``), False
    the host numpy codec, None the device path when the problem lies on the
    card; the bytes are the same either way.

    Stops after T rounds or when the per-worker downlink ``bit_budget``
    (paper App. A communication budgets) is spent. The compressor's draws
    come from a CPU ``torch.Generator`` seeded with ``seed`` and are moved
    to the device, so a CPU run and a GPU run of one seed see the same
    draws. Uplink is exact (Algorithm 1), so the ledger also accrues one
    dense w2s message per round (hist["w2s_bits"])."""
    if T is None and bit_budget is None:
        raise ValueError("run needs T or bit_budget")
    ledger = CommLedger(model=CommModel(d=problem.d))
    step = make_step(problem, comp, stepsize, return_delta=measure_wire)
    state = init(problem.x0)
    gen = torch.Generator().manual_seed(seed)
    hist = {"t": [], "f_x": [], "f_w": [], "gamma": [], "s2w_bits": [], "w2s_bits": []}
    if measure_wire:
        wire_model_ledger = CommLedger(
            model=CommModel(d=problem.d, value_bits=wire.MAG_BITS[wire.mag_dtype(wire_mag)]))
        hist["wire_bits"] = []
    wire_total = 0.0
    t = 0
    while True:
        if T is not None and t >= T:
            break
        if bit_budget is not None and ledger.s2w_bits >= bit_budget:
            break
        state, m = step(state, comp.draw(problem.d, gen, problem.device))
        ledger.log_s2w_sparse(float(m["delta_nnz"]))
        ledger.log_w2s_dense()  # uplink: exact subgradient every round
        ledger.tick()
        if measure_wire:
            wire_model_ledger.log_s2w_sparse(float(m["delta_nnz"]))
            wire_model_ledger.tick()
            wire_total += wire.measured_bits(
                wire.encode(m["delta"], mag=wire_mag, device_encode=device_encode))
        if t % record_every == 0:
            hist["t"].append(t)
            hist["f_x"].append(float(m["f_x"]))
            hist["f_w"].append(float(m["f_w"]))
            hist["gamma"].append(float(m["gamma"]))
            hist["s2w_bits"].append(ledger.s2w_bits)
            hist["w2s_bits"].append(ledger.w2s_bits)
            if measure_wire:
                hist["wire_bits"].append(wire_total)
        t += 1
    hist["final_state"] = state
    hist["ledger"] = ledger
    if measure_wire:
        hist["wire_bits_total"] = wire_total
        hist["wire_model_ledger"] = wire_model_ledger
    return hist
