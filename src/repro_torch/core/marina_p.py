"""MARINA-P for non-smooth objectives (Algorithm 2), on tensors.

Port of ``repro/core/marina_p.py`` (main path and the measured wire bits;
no transport, participation or tracing yet). Per round t:
    workers:  g_i = df_i(w_i^t)                  -> server   (uplink, exact)
    server:   gamma_t from schedule (constant / decreasing / Polyak (23))
              x^{t+1} = x^t - gamma_t * mean_i g_i
              c^t ~ Bernoulli(p)
              c=1: send x^{t+1} to all workers          (dense broadcast)
              c=0: send Q_i^t(x^{t+1} - x^t) to worker i (per-worker message)
    workers:  w_i^{t+1} = x^{t+1}  or  w_i^t + Q_i^t(x^{t+1} - x^t)

Three broadcast modes (Section 4.1):
  * ``same``: one RandK draw, identical message to every worker;
  * ``ind``:  an independent RandK draw per worker;
  * ``perm``: PermK correlated family — (1/n) sum_i Q_i(x) = x exactly.

State is (x, W) with W = stack of worker shifts [n, d]. A round's random
draws (:class:`MarinaPDraws`) are explicit arguments of the step; ``run``
makes them with a CPU ``torch.Generator``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import wire
from .comm_model import CommLedger, CommModel
from .compressors import Identity, PermK, RandK
from .problems import L1Problem
from .stepsizes import Stepsize, descent_step, marina_p_lambda_star


class MarinaPState(NamedTuple):
    x: torch.Tensor  # server iterate [d]
    W: torch.Tensor  # worker shifts [n, d]
    t: int


class MarinaPDraws(NamedTuple):
    coin: bool  # c^t: full sync this round
    idx: torch.Tensor  # same: [k] index set; ind: [n, k] index sets; perm: [d] permutation


class Broadcast(NamedTuple):
    apply: Callable  # (idx, delta [d]) -> Q [n, d]
    draw: Callable  # (d, generator, device) -> idx


def init(x0: torch.Tensor, n: int) -> MarinaPState:
    """w_i^0 = x^0 for all i (Algorithm 2, line 1)."""
    return MarinaPState(x=x0, W=x0.expand(n, x0.shape[-1]).clone(), t=0)


def lyapunov(
    state: MarinaPState,
    x_star: torch.Tensor,
    *,
    L0_bar: float,
    L0_tilde: float,
    omega: float,
    p: float,
) -> torch.Tensor:
    lam = marina_p_lambda_star(L0_bar, L0_tilde, omega, p)
    drift = torch.mean(torch.sum((state.W - state.x) ** 2, dim=-1))
    return torch.sum((state.x - x_star) ** 2) + drift / (lam * p)


def make_broadcast(mode: str, n: int, k: int) -> Broadcast:
    """The downlink compressor family of one mode: how to draw its
    randomness and how to apply it to ``delta`` for all n workers."""
    comp = RandK(k=k)
    if mode == "same":
        def apply(idx, delta):
            return comp(delta, idx).expand(n, delta.shape[-1])

        return Broadcast(apply, comp.draw)
    if mode == "ind":
        def apply(idx, delta):
            d = delta.shape[-1]
            masks = torch.zeros((n, d), dtype=delta.dtype, device=delta.device)
            masks.scatter_(1, idx, 1.0)
            return delta * masks * (d / min(k, d))

        def draw(d, generator, device):
            return torch.stack([comp.draw(d, generator, device) for _ in range(n)])

        return Broadcast(apply, draw)
    if mode == "perm":
        def apply(perm, delta):
            d = delta.shape[-1]
            q = d // n
            masks = torch.zeros((n, d), dtype=delta.dtype, device=delta.device)
            # worker i keeps block i of the permutation, scaled by n
            masks.scatter_(1, perm[: q * n].view(n, q), 1.0)
            if d > q * n:  # leftover coordinates go to worker 0
                masks[0].index_fill_(0, perm[q * n:], 1.0)
            return masks * delta * n

        return Broadcast(apply, PermK(n=n).draw)
    raise ValueError(f"unknown broadcast mode: {mode}")


def draw_round(bcast: Broadcast, p: float, d: int, generator: torch.Generator,
               device) -> MarinaPDraws:
    """One round's draws: the p-coin, then the mode's index sets."""
    coin = bool(torch.rand((), generator=generator) < p)
    return MarinaPDraws(coin=coin, idx=bcast.draw(d, generator, device))


def make_step(problem: L1Problem, mode: str, k: int, p: float, stepsize: Stepsize,
              *, return_q: bool = False):
    """Round function ``step(state, draws) -> (state, metrics)``.

    ``return_q=True`` also returns the per-worker messages Q [n, d] and the
    new iterate x_new in the metrics, so the host can serialize them (the
    wire measurement path)."""
    n = problem.n
    bcast = make_broadcast(mode, n, k)

    def step(state: MarinaPState, draws: MarinaPDraws):
        # --- workers: subgradients at their own shifts -----------------------
        g_all = problem.subgrad_all(state.W)  # [n, d]
        f_all = problem.f_all(state.W)
        g = torch.mean(g_all, dim=0)
        aux = {
            "f_w": torch.mean(f_all),
            "g_norm_sq": torch.sum(g**2),
            "g_sq_mean": torch.mean(torch.sum(g_all**2, dim=-1)),
        }
        gamma = stepsize(state.t, aux)
        x_new = descent_step(state.x, gamma, g)
        # --- downlink ---------------------------------------------------------
        Q = bcast.apply(draws.idx, x_new - state.x)  # [n, d]
        if draws.coin:
            W_new = x_new.expand(n, problem.d).clone()
        else:
            W_new = state.W + Q
        metrics = {
            "f_x": problem.f(x_new),
            "f_w": aux["f_w"],
            "gamma": gamma,
            "full_sync": float(draws.coin),
            # the count is exact on every device; its mean over workers is
            # taken on the host in fp32, as the reference's jnp.mean rounds
            # it (on the card torch.mean multiplies by 1/n, which can land
            # one ulp away and move the bit ledger)
            "q_nnz_mean": float(np.float32(int(torch.count_nonzero(Q))) / np.float32(n)),
            "drift": torch.mean(torch.sum((W_new - x_new) ** 2, dim=-1)),
        }
        if return_q:
            metrics["Q"] = Q
            metrics["x_new"] = x_new
        return MarinaPState(x=x_new, W=W_new, t=state.t + 1), metrics

    return step


def run(
    problem: L1Problem,
    *,
    mode: str,
    k: int,
    p: float,
    stepsize: Stepsize,
    T: Optional[int] = None,
    bit_budget: Optional[float] = None,
    seed: int = 0,
    record_every: int = 1,
    measure_wire: bool = False,
    wire_mag: str = "fp32",
    device_encode: Optional[bool] = None,
):
    """Host loop on the problem's device; stops on T rounds or the
    per-worker downlink bit budget.

    ``measure_wire=True`` also serializes every round's messages with the
    wire codecs (DENSE x_new in a sync round; SPARSE Q rows otherwise: one
    encode of Q[0] in ``same`` mode, the mean over the n rows in ``ind`` /
    ``perm``) and tracks the *measured* bits per worker
    (hist["wire_bits"], hist["wire_bits_total"]) next to a second analytic
    ledger whose value_bits match ``wire_mag`` (hist["wire_model_ledger"],
    DESIGN.md §3.5). The primary ledger keeps the paper's 64-bit model, so
    ``bit_budget`` means the same with and without measurement.

    ``device_encode`` picks the encoder: True the device path
    (``kernels/encode.py``: the stream and pack kernels on the card), False
    the host numpy codec, None the device path when the problem lies on the
    card. The bytes are the same either way.

    Each round's draws come from a CPU ``torch.Generator`` seeded with
    ``seed`` and are moved to the device (a few KB per round), so a CPU run
    and a GPU run of one seed see the same draws. Uplink is exact
    (Algorithm 2: workers send raw subgradients), so the ledger also accrues
    one dense w2s message per round (hist["w2s_bits"])."""
    if T is None and bit_budget is None:
        raise ValueError("run needs T or bit_budget")
    ledger = CommLedger(model=CommModel(d=problem.d))
    step = make_step(problem, mode, k, p, stepsize, return_q=measure_wire)
    bcast = make_broadcast(mode, problem.n, k)
    state = init(problem.x0, problem.n)
    gen = torch.Generator().manual_seed(seed)
    hist = {"t": [], "f_x": [], "f_w": [], "gamma": [], "s2w_bits": [],
            "w2s_bits": [], "drift": []}
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
        draws = draw_round(bcast, p, problem.d, gen, problem.device)
        state, m = step(state, draws)
        if draws.coin:
            ledger.log_s2w_dense()
        else:
            ledger.log_s2w_sparse(float(m["q_nnz_mean"]))
        ledger.log_w2s_dense()  # uplink: exact subgradient every round
        ledger.tick()
        if measure_wire:
            if draws.coin:
                wire_model_ledger.log_s2w_dense()
                wire_total += wire.measured_bits(wire.encode(
                    m["x_new"], Identity(), mag=wire_mag, device_encode=device_encode))
            else:
                wire_model_ledger.log_s2w_sparse(float(m["q_nnz_mean"]))
                # all rows are identical in ``same`` mode: one encode suffices
                rows = m["Q"][:1] if mode == "same" else m["Q"]
                bufs = wire.encode_rows(rows, mag=wire_mag, device_encode=device_encode)
                wire_total += sum(wire.measured_bits(b) for b in bufs) / len(bufs)
            wire_model_ledger.tick()
        if t % record_every == 0:
            hist["t"].append(t)
            hist["f_x"].append(float(m["f_x"]))
            hist["f_w"].append(float(m["f_w"]))
            hist["gamma"].append(float(m["gamma"]))
            hist["drift"].append(float(m["drift"]))
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
