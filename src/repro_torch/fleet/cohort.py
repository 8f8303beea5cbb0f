"""Cohort-bounded federated rounds (DESIGN.md §9.3), on tensors.

``fleet_run`` drives MARINA-P or EF21-P over a declarative client
population: each round a :class:`~repro_torch.fleet.sampler.CohortSampler`
draws a cohort of client ids, the cohort's problem data is materialized
on demand (:meth:`FleetL1Problem.materialize`, float64 on the host, cast to
float32 on the device), and one step runs the subgradient/compressor path
over a leading cohort axis — so **cohort size, not population size, bounds
memory**.

Cross-device clients are stateless between the rounds they attend, which
changes the downlink state machine vs the fixed-worker-list runs in
``repro_torch.core``:

* a slot whose client is **fresh** (new to the cohort, or *dirty* from a
  failed delivery last time it attended) first receives the current
  server iterate dense — a *join sync*, charged dense bits;
* a **persistent** slot (same client as last round, last message
  delivered) holds valid state and receives only the compressed round
  message (MARINA-P: ``Q_i(x^{t+1}-x^t)`` or the Bernoulli full sync;
  EF21-P: the contractive shift delta);
* a slot whose round message is **dropped** (per-client
  :class:`~repro_torch.transport.FaultSpec` drawn from the population's fault
  rate, evaluated through the transport fault injector) keeps its stale
  state and is marked dirty — its *next* attendance is a join sync. There
  is no fleet-wide rollback or forced-sync promotion: with per-round
  membership churn, the join sync already is the repair primitive
  (contrast DESIGN.md §8.4's fixed-fleet two-phase commit).

The global objective is estimated on a fixed hashed evaluation cohort
(``FleetL1Problem.eval_cohort``) — evaluating the true population
objective would require materializing every client.

Port of ``repro/fleet/cohort.py``. The cohort oracle's g is
:func:`repro_torch.kernels.ops.l1_subgrad` (the Hopper kernel on the card),
f a plain ``torch.matmul`` as the reference computes it outside any kernel;
EF21-P's default TopK goes through ``ops.block_topk``. A round's draws (the
p-coin and the PermK/RandK index sets over the cohort's slots) come from a
CPU ``torch.Generator`` seeded with ``seed``
(:func:`repro_torch.core.marina_p.draw_round`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from .. import wire
from ..core import marina_p
from ..core.comm_model import CommModel
from ..core.compressors import ContractiveCompressor, Identity, TopK
from ..core.stepsizes import Stepsize, descent_step
from ..kernels import ops
from ..kernels.encode import device_encode_enabled
from ..kernels.runtime import resolve_device
from ..obs.trace import maybe_attr, maybe_span
from ..transport import FaultInjector
from .population import FleetL1Problem
from .sampler import CohortSampler


def _cohort_oracles(A: torch.Tensor, points: torch.Tensor):
    """(f_i, df_i) at per-slot points: [c,d,d] x [c,d] -> ([c], [c,d])."""
    y = torch.matmul(A, points.unsqueeze(-1)).squeeze(-1)
    f = torch.sum(torch.abs(y), dim=-1)
    return f, ops.l1_subgrad(A, points)


def _aggregate(weights: torch.Tensor, f_all: torch.Tensor, g_all: torch.Tensor):
    """Weighted cohort aggregation; weights are zero-sum on empty rounds,
    so an empty cohort yields g = 0 and the server iterate holds still."""
    g = torch.matmul(weights, g_all)
    aux = {
        "f_w": torch.sum(weights * f_all),
        "g_norm_sq": torch.sum(g**2),
        "g_sq_mean": torch.sum(weights * torch.sum(g_all**2, dim=-1)),
    }
    return g, aux


def make_marina_cohort_step(cohort_size: int, mode: str, k: int, p: float,
                            stepsize: Stepsize):
    """MARINA-P cohort round over [c] slots.

    Inputs: server x [d], slot shifts W [c,d], cohort matrices A [c,d,d],
    active/weights/fresh [c], the round's draws (a
    :class:`~repro_torch.core.marina_p.MarinaPDraws` over c slots), round t.
    Fresh slots start from x (the join sync already delivered it); the
    broadcast addresses every active slot. Returns (x_new, W_new, w_start,
    metrics) — w_start is kept so the host can roll back slots whose
    delivery failed. No input is written in place (W may be an expanded
    view)."""
    bcast = marina_p.make_broadcast(mode, cohort_size, k)

    def step(x, W, A, active, weights, fresh, draws, t):
        w_start = torch.where(fresh[:, None], x[None, :], W)
        f_all, g_all = _cohort_oracles(A, w_start)
        g, aux = _aggregate(weights, f_all, g_all)
        gamma = stepsize(t, aux)
        x_new = descent_step(x, gamma, g)
        Q = bcast.apply(draws.idx, x_new - x)  # [c, d]
        W_round = x_new.expand(W.shape) if draws.coin else w_start + Q
        W_new = torch.where(active[:, None], W_round, W)
        metrics = {
            "f_w": aux["f_w"],
            "gamma": gamma,
            "full_sync": float(draws.coin),
            "q_nnz": torch.sum(Q != 0, dim=-1).to(torch.float32),
            "x_new": x_new,
            "Q": Q,
        }
        return x_new, W_new, w_start, metrics

    return step


def make_ef21p_cohort_step(comp: ContractiveCompressor, stepsize: Stepsize):
    """EF21-P cohort round: the shift w is a single server-side vector;
    fresh slots received it dense at round start, so the whole active
    cohort computes at w (an expanded view, row stride 0) and the
    compressed delta keeps the persistent slots synchronized. ``draws`` is
    what ``comp.draw`` made (None for TopK)."""

    def step(x, w, A, active, weights, draws, t):
        points = w.expand(A.shape[0], w.shape[-1])
        f_all, g_all = _cohort_oracles(A, points)
        g, aux = _aggregate(weights, f_all, g_all)
        gamma = stepsize(t, aux)
        x_new = descent_step(x, gamma, g)
        delta = comp(x_new - w, draws)
        w_new = w + delta
        metrics = {
            "f_w": aux["f_w"],
            "gamma": gamma,
            "delta_nnz": torch.sum(delta != 0).to(torch.float32),
            "delta": delta,
        }
        return x_new, w_new, metrics

    return step


@dataclasses.dataclass
class ParticipationStats:
    """Fleet-level participation/goodput counters for one run."""

    rounds: int = 0
    participant_rounds: int = 0
    fresh_rounds: int = 0
    messages_sent: int = 0
    messages_delivered: int = 0
    unique_clients: int = 0
    mean_fill: float = 0.0

    @property
    def fresh_frac(self) -> float:
        return self.fresh_rounds / max(self.participant_rounds, 1)

    @property
    def goodput(self) -> float:
        return self.messages_delivered / max(self.messages_sent, 1)

    def as_metrics(self, prefix: str = "fleet") -> Dict[str, float]:
        return {
            f"{prefix}/rounds": float(self.rounds),
            f"{prefix}/participant_rounds": float(self.participant_rounds),
            f"{prefix}/unique_clients": float(self.unique_clients),
            f"{prefix}/mean_fill": self.mean_fill,
            f"{prefix}/fresh_frac": self.fresh_frac,
            f"{prefix}/goodput": self.goodput,
        }


def cohort_matrices(problem: FleetL1Problem, ids, dev) -> torch.Tensor:
    """``problem.materialize(ids)`` (float64, built on the host), copied to
    ``dev`` and cast to float32 there."""
    return torch.from_numpy(problem.materialize(ids)).to(dev).to(torch.float32)


def fleet_run(
    problem: FleetL1Problem,
    sampler: CohortSampler,
    stepsize: Stepsize,
    *,
    algorithm: str = "marina_p",
    mode: str = "perm",
    k: Optional[int] = None,
    p: Optional[float] = None,
    comp: Optional[ContractiveCompressor] = None,
    T: int = 200,
    target: Optional[float] = None,
    seed: int = 0,
    record_every: int = 1,
    measure_wire: bool = False,
    wire_mag: str = "fp32",
    device_encode: Optional[bool] = None,
    eval_clients: int = 64,
    tracker=None,
    device="cuda",
):
    """Host loop for one (algorithm × sampler × population) scenario, on
    ``device`` (default the card; raises where there is none).

    Downlink bits follow the paper's 64-bit CommModel: every fresh active
    slot is charged one dense join sync; MARINA-P sync rounds charge dense
    per active slot, otherwise each slot's actual message nnz; EF21-P
    charges the delta nnz per persistent slot. Uplink stays one exact
    dense message per participant per round. ``measure_wire=True``
    additionally serializes every per-slot message with the wire codecs
    (``hist["wire_bits"]``, DESIGN.md §3.5); the round's cohort encodes are
    batched before the per-slot delivery loop — one device pass over the
    active Q rows when ``device_encode`` selects the device path
    (kernels/encode.py; None: on for the card), one host pass otherwise.

    ``target`` (an f-value on the evaluation cohort) sets
    ``hist["rounds_to_target"]`` — the first recorded round at or below
    it, or T when never reached (keeps BENCH gates NaN-free).
    """
    if algorithm not in ("marina_p", "ef21p"):
        raise ValueError(f"unknown algorithm: {algorithm!r}")
    dev = resolve_device(device)
    spec = problem.spec
    c, d = sampler.cohort_size, problem.d
    k = k if k is not None else max(1, d // c)
    p = p if p is not None else k / d
    if comp is None:
        comp = TopK(k=k)
    cm = CommModel(d=d)
    x = torch.from_numpy(problem.x0).to(dev).to(torch.float32)
    use_dev = measure_wire and device_encode_enabled(device_encode, x)

    def enc_dense(v):
        return wire.encode(v, Identity(), mag=wire_mag, device_encode=device_encode)

    def enc_sparse(v):
        return wire.encode(v, mag=wire_mag, device_encode=device_encode)

    # -- evaluation cohort (fixed, hashed) --------------------------------
    A_eval = cohort_matrices(problem, problem.eval_cohort(eval_clients), dev)

    def f_eval(x):
        return torch.mean(torch.sum(torch.abs(torch.matmul(A_eval, x)), dim=-1))

    if algorithm == "marina_p":
        step = make_marina_cohort_step(c, mode, k, p, stepsize)
        bcast = marina_p.make_broadcast(mode, c, k)
    else:
        step = make_ef21p_cohort_step(comp, stepsize)

    W = x.expand(c, d)  # marina_p slot shifts
    w = x               # ef21p server shift
    gen = torch.Generator().manual_seed(seed)

    prev_ids = np.full(c, -1, dtype=np.int64)
    dirty: set = set()
    clients_seen: set = set()
    stats = ParticipationStats()
    s2w_bits = 0.0
    w2s_bits = 0.0
    join_bits = 0.0
    wire_bits = 0.0
    rounds_to_target = None
    hist = {"t": [], "f_x": [], "f_w": [], "gamma": [], "participants": [],
            "fresh": [], "delivered": [], "s2w_bits": [], "w2s_bits": []}
    if measure_wire:
        hist["wire_bits"] = []

    for t in range(T):
        co = sampler.cohort(t)
        fresh_np = co.active & (
            (co.ids != prev_ids) | np.isin(co.ids, np.asarray(sorted(dirty), dtype=np.int64))
        )
        A = cohort_matrices(problem, co.ids, dev)
        active = torch.from_numpy(co.active).to(dev)
        weights = torch.from_numpy(co.weights).to(dev).to(torch.float32)

        with maybe_span(tracker, "round", round=t,
                        alg=f"fleet/{algorithm}") as rsp:
            with maybe_span(tracker, "subgrad",
                            fused="subgrad+stepsize+compress"):
                if algorithm == "marina_p":
                    draws = marina_p.draw_round(bcast, p, d, gen, dev)
                    x, W, w_start, m = step(x, W, A, active, weights,
                                            torch.from_numpy(fresh_np).to(dev), draws, t)
                    coin = m["full_sync"] > 0
                    q_nnz = m["q_nnz"].cpu().numpy()
                else:
                    x, w, m = step(x, w, A, active, weights, comp.draw(d, gen, dev), t)
                    coin = False
                    delta_nnz = float(m["delta_nnz"])
            with maybe_span(tracker, "stepsize") as ssp:
                gamma = float(m["gamma"])
                maybe_attr(ssp, gamma=gamma)
            maybe_attr(rsp, full_sync=coin, gamma=gamma)

            # -- per-slot delivery through the transport failure model -----
            n_active = co.n_active
            delivered = co.active.copy()
            payloads = [None] * c
            with maybe_span(tracker, "broadcast", full_sync=coin) as bsp:
                if measure_wire or spec.fault_rate > 0:
                    active_idx = np.nonzero(co.active)[0]
                    if measure_wire and active_idx.size:
                        # batch the round's cohort encodes before the
                        # delivery loop: the per-slot Q rows go through one
                        # device pass (or one host sweep), the shared sync /
                        # join payloads encode exactly once
                        with maybe_span(tracker, "encode", device=use_dev):
                            if algorithm == "marina_p":
                                if coin:
                                    shared = enc_dense(m["x_new"])
                                    for i in active_idx:
                                        payloads[i] = shared
                                else:
                                    sel = torch.from_numpy(active_idx).to(dev)
                                    rows = wire.encode_rows(m["Q"][sel], mag=wire_mag,
                                                            device_encode=device_encode)
                                    for i, buf in zip(active_idx, rows):
                                        payloads[i] = buf
                            else:
                                shared = enc_sparse(m["delta"])
                                for i in active_idx:
                                    payloads[i] = shared
                            join_payload = (
                                enc_dense(x if algorithm == "marina_p" else w)
                                if fresh_np.any() else None
                            )
                    for i in active_idx:
                        cid = int(co.ids[i])
                        with maybe_span(tracker, f"link/client{cid}",
                                        fresh=bool(fresh_np[i])) as lsp:
                            if measure_wire:
                                if fresh_np[i]:
                                    wire_bits += wire.measured_bits(join_payload)
                                wire_bits += wire.measured_bits(payloads[i])
                            if spec.fault_rate > 0:
                                fspec = spec.fault_spec_for(cid, round_salt=t)
                                if fspec.any_faults:
                                    inj = FaultInjector(fspec)
                                    buf = payloads[i] if payloads[i] is not None else b"\x00" * 16
                                    delivered[i] = len(inj.plan(buf)) > 0
                            maybe_attr(lsp, delivered=bool(delivered[i]))
                maybe_attr(bsp, delivered=int(delivered.sum()),
                           fresh=int(fresh_np.sum()),
                           resync_next=not bool(delivered.all()))

            # slots whose round message was dropped keep their pre-round
            # state and resync (join dense) at their next attendance
            if algorithm == "marina_p" and not bool(delivered.all()):
                W = torch.where(torch.from_numpy(delivered).to(dev)[:, None], W, w_start)
            for i in np.nonzero(co.active)[0]:
                cid = int(co.ids[i])
                if delivered[i]:
                    dirty.discard(cid)
                else:
                    dirty.add(cid)
            prev_ids = np.where(co.active, co.ids, -1)

        # -- bit accounting (paper 64-bit model) ----------------------------
        n_fresh = int(fresh_np.sum())
        join_bits += cm.dense_bits() * n_fresh
        round_s2w = cm.dense_bits() * n_fresh
        if algorithm == "marina_p":
            if coin:
                round_s2w += cm.dense_bits() * n_active
            else:
                round_s2w += float(sum(cm.sparse_bits(float(q_nnz[i]))
                                       for i in np.nonzero(co.active)[0]))
        else:
            n_persistent = n_active - n_fresh
            round_s2w += cm.sparse_bits(delta_nnz) * n_persistent
        s2w_bits += round_s2w
        w2s_bits += cm.dense_bits() * n_active

        # -- stats / recording ---------------------------------------------
        stats.rounds += 1
        stats.participant_rounds += n_active
        stats.fresh_rounds += n_fresh
        stats.messages_sent += n_active
        stats.messages_delivered += int(delivered.sum())
        stats.mean_fill += (co.fill - stats.mean_fill) / stats.rounds
        clients_seen.update(int(i) for i in co.ids[co.active])

        fx = float(f_eval(x))
        if target is not None and rounds_to_target is None and fx <= target:
            rounds_to_target = t
        if t % record_every == 0 or t == T - 1:
            hist["t"].append(t)
            hist["f_x"].append(fx)
            hist["f_w"].append(float(m["f_w"]))
            hist["gamma"].append(gamma)
            hist["participants"].append(n_active)
            hist["fresh"].append(n_fresh)
            hist["delivered"].append(int(delivered.sum()))
            hist["s2w_bits"].append(s2w_bits)
            hist["w2s_bits"].append(w2s_bits)
            if measure_wire:
                hist["wire_bits"].append(wire_bits)
            if tracker is not None:
                pre = f"fleet/{algorithm}"
                tracker.log({f"{pre}/f_x": fx, f"{pre}/gamma": hist["gamma"][-1],
                             f"{pre}/participants": n_active,
                             f"{pre}/s2w_bits": s2w_bits}, step=t)

    stats.unique_clients = len(clients_seen)
    hist["final_x"] = x
    hist["s2w_bits_total"] = s2w_bits
    hist["w2s_bits_total"] = w2s_bits
    hist["join_bits_total"] = join_bits
    hist["bits_per_participant_round"] = s2w_bits / max(stats.participant_rounds, 1)
    if measure_wire:
        hist["wire_bits_total"] = wire_bits
    hist["participation"] = stats
    if target is not None:
        hist["rounds_to_target"] = rounds_to_target if rounds_to_target is not None else T
    if tracker is not None:
        tracker.log(stats.as_metrics(f"fleet/{algorithm}"), step=T)
    return hist
