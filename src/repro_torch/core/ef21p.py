"""EF21-P, distributed version (Algorithm 1; single-node Algorithm 4), on tensors.

Port of ``repro/core/ef21p.py``: the main path, the measured wire bits, the
lossy transport, partial participation and tracing. Per round t:
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
from ..kernels.encode import device_encode_enabled
from ..obs.trace import maybe_attr, maybe_span
from ..obs.tracker import block_until_ready
from .comm_model import CommLedger, CommModel
from .compressors import ContractiveCompressor, Identity
from .marina_p import make_fleet
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
              *, return_delta: bool = False, participation=None):
    """Round function ``step(state, draws=None, force_sync=False, part=None)
    -> (state, metrics)``; ``draws`` is what ``comp.draw`` made for this
    round (None for TopK/BlockTopK). ``return_delta=True`` also returns the
    broadcast message ``delta``.

    ``participation`` (a :class:`repro_torch.fleet.ParticipationPlan`)
    masks the uplink aggregation to the round's cohort, from the plan's
    draws ``part``; the shift broadcast still addresses everyone (w stays
    synchronized by construction). An empty cohort gives g = 0 and
    f_w = 0, so Polyak's (13) degrades to gamma = 0, not NaN.

    ``force_sync`` re-anchors the shift with a dense ``w := x`` broadcast —
    the transport layer's degraded-mode recovery (DESIGN.md §8.4)."""
    plan = participation
    partial = plan is not None and not plan.is_full

    def step(state: EF21PState, draws=None, force_sync: bool = False, part=None):
        # --- workers: subgradients at the shared shift w^t ------------------
        w_stack = state.w.expand(problem.n, problem.d)
        g_all = problem.subgrad_all(w_stack)  # [n, d]
        f_all = problem.f_all(w_stack)
        # --- server: stepsize (Polyak needs f(w^t) and ||g||^2) -------------
        if partial:
            mask = plan.mask(part, problem.n, state.t, problem.device)
            wts = mask.to(torch.float32) / torch.clamp_min(mask.sum(), 1)
            g = torch.matmul(wts, g_all)
            aux = {"f_w": torch.sum(wts * f_all), "g_norm_sq": torch.sum(g**2)}
        else:
            g = torch.mean(g_all, dim=0)
            aux = {"f_w": torch.mean(f_all), "g_norm_sq": torch.sum(g**2)}
        gamma = stepsize(state.t, aux)
        x_new = descent_step(state.x, gamma, g)
        # --- downlink: compressed difference ---------------------------------
        delta = x_new - state.w if force_sync else comp(x_new - state.w, draws)
        w_new = state.w + delta
        metrics = {
            "f_x": problem.f(x_new),
            "f_w": aux["f_w"],
            "gamma": gamma,
            "delta_nnz": torch.sum(delta != 0).to(torch.float32),
            "full_sync": float(bool(force_sync)),
        }
        if partial:
            metrics["participants"] = mask.sum().to(torch.float32)
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
    transport=None,
    tracker=None,
    participation=None,
):
    """Host loop on the problem's device; returns the history dict.

    ``measure_wire=True`` also SPARSE-encodes every round's broadcast
    ``delta`` (DENSE in a re-anchor round) and tracks the measured bits
    (hist["wire_bits"], hist["wire_bits_total"]) next to a second analytic
    ledger whose value_bits match ``wire_mag`` (hist["wire_model_ledger"],
    DESIGN.md §3.5); the primary ledger keeps the paper's 64-bit model.
    ``device_encode``: True the device path (``kernels/encode.py``), False
    the host numpy codec, None the device path when the problem lies on the
    card; the bytes are the same either way.

    ``transport`` (a :class:`repro_torch.transport.Fleet`, or a
    :class:`~repro_torch.transport.FaultSpec` to build one) pushes each
    round's broadcast through fault-injected reliable links. EF21-P's shift
    must stay synchronized across server and workers, so the commit is
    two-phase (DESIGN.md §8.4): if any worker misses the broadcast, the
    server rolls its shift back (``w`` unchanged — the round still advances
    ``x``) and the next round re-anchors with a dense ``w := x`` SYNC
    broadcast, charged dense bits by the ledger. ``hist["transport"]``
    carries the fleet counters.

    ``participation`` (a :class:`repro_torch.fleet.ParticipationPlan`)
    restricts each round's uplink aggregation to the plan's cohort (see
    :func:`make_step`); ``hist["participants"]`` records cohort sizes.
    ``tracker`` (a :class:`repro_torch.obs.Tracker`) receives the round
    spans of :func:`repro_torch.core.marina_p.run` and the recorded rounds
    as step-indexed metric events; without one the loop adds no sync.

    Stops after T rounds or when the per-worker downlink ``bit_budget``
    (paper App. A communication budgets) is spent. The compressor's draws
    come from a CPU ``torch.Generator`` seeded with ``seed`` and are moved
    to the device, so a CPU run and a GPU run of one seed see the same
    draws. Uplink is exact (Algorithm 1), so the ledger also accrues one
    dense w2s message per round (hist["w2s_bits"])."""
    if T is None and bit_budget is None:
        raise ValueError("run needs T or bit_budget")
    need_delta = measure_wire or transport is not None
    ledger = CommLedger(model=CommModel(d=problem.d))
    step = make_step(problem, comp, stepsize, return_delta=need_delta, participation=participation)
    state = init(problem.x0)
    gen = torch.Generator().manual_seed(seed)
    partial = participation is not None and not participation.is_full
    part_gen = participation.generator(seed) if partial else None
    fleet = None
    if transport is not None:
        fleet = make_fleet(problem.n, transport)
        if tracker is not None:
            fleet.attach_tracker(tracker)
    use_dev = device_encode_enabled(device_encode, problem.x0)
    hist = {"t": [], "f_x": [], "f_w": [], "gamma": [], "s2w_bits": [], "w2s_bits": []}
    if partial:
        hist["participants"] = []
    if measure_wire:
        wire_model_ledger = CommLedger(
            model=CommModel(d=problem.d, value_bits=wire.MAG_BITS[wire.mag_dtype(wire_mag)]))
        hist["wire_bits"] = []

    def enc(v, dense):
        return wire.encode(v, Identity() if dense else None, mag=wire_mag,
                           device_encode=device_encode)

    wire_total = 0.0
    force_sync = False
    t = 0
    while True:
        if T is not None and t >= T:
            break
        if bit_budget is not None and ledger.s2w_bits >= bit_budget:
            break
        draws = comp.draw(problem.d, gen, problem.device)
        part = participation.draw(problem.n, part_gen, problem.device) if partial else None
        prev_w = state.w
        with maybe_span(tracker, "round", round=t, alg="ef21p") as rsp:
            with maybe_span(tracker, "subgrad", fused="subgrad+stepsize+compress"):
                state, m = step(state, draws, force_sync, part)
                if tracker is not None:
                    block_until_ready(m["f_x"])
            synced = force_sync
            force_sync = False
            with maybe_span(tracker, "stepsize") as ssp:
                gamma = float(m["gamma"])
                maybe_attr(ssp, gamma=gamma)
            maybe_attr(rsp, full_sync=synced, force_sync=synced, gamma=gamma)
            if fleet is not None:
                with maybe_span(tracker, "broadcast", full_sync=synced) as bsp:
                    with maybe_span(tracker, "encode", device=use_dev):
                        # a re-anchor is self-contained: the full new shift
                        payload = enc(state.w, True) if synced else enc(m["delta"], False)
                    oks = fleet.broadcast(payload, sync=synced)
                    fleet.drain()
                    if not all(oks) or fleet.resync_needed:
                        # two-phase commit: some worker is stale — keep the
                        # server shift at w^t and repair next round with a
                        # dense re-anchor
                        state = state._replace(w=prev_w)
                        force_sync = True
                    maybe_attr(bsp, delivered=int(sum(oks)), resync_next=force_sync)
        if synced:
            ledger.log_s2w_dense()
        else:
            ledger.log_s2w_sparse(float(m["delta_nnz"]))
        ledger.log_w2s_dense()  # uplink: exact subgradient every round
        ledger.tick()
        if measure_wire:
            if synced:
                wire_model_ledger.log_s2w_dense()
            else:
                wire_model_ledger.log_s2w_sparse(float(m["delta_nnz"]))
            wire_model_ledger.tick()
            wire_total += wire.measured_bits(enc(m["delta"], synced))
        if t % record_every == 0:
            hist["t"].append(t)
            hist["f_x"].append(float(m["f_x"]))
            hist["f_w"].append(float(m["f_w"]))
            hist["gamma"].append(gamma)
            hist["s2w_bits"].append(ledger.s2w_bits)
            hist["w2s_bits"].append(ledger.w2s_bits)
            if partial:
                hist["participants"].append(float(m["participants"]))
            if measure_wire:
                hist["wire_bits"].append(wire_total)
            if tracker is not None:
                rec = {
                    "ef21p/f_x": hist["f_x"][-1],
                    "ef21p/f_w": hist["f_w"][-1],
                    "ef21p/gamma": hist["gamma"][-1],
                    "ef21p/s2w_bits": ledger.s2w_bits,
                    "ef21p/w2s_bits": ledger.w2s_bits,
                }
                if partial:
                    rec["ef21p/participants"] = hist["participants"][-1]
                if measure_wire:
                    rec["ef21p/wire_bits"] = wire_total
                tracker.log(rec, step=t)
        t += 1
    hist["final_state"] = state
    hist["ledger"] = ledger
    if measure_wire:
        hist["wire_bits_total"] = wire_total
        hist["wire_model_ledger"] = wire_model_ledger
    if fleet is not None:
        stats = fleet.stats()
        hist["transport"] = stats.as_metrics()
        hist["transport_stats"] = stats
        if tracker is not None:
            fleet.log_to(tracker, step=t)
    return hist
