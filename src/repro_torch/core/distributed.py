"""SPMD realization of the federated rounds on ``torch.distributed``.

Port of ``repro/core/distributed.py`` (there: ``shard_map`` over a 1-D
``workers`` mesh axis). Here the axis is a process group: rank r of W owns
``local_n = n // W`` workers, ``r * local_n ... (r + 1) * local_n - 1``, with
their slice of the A_i matrices and of the per-worker shifts W. The server
iterate x, EF21-P's shift w and the round counter t are replicated.

The downlink messages Q_i(delta) are *not* moved (DESIGN.md §2): the round's
draws (:class:`repro_torch.core.marina_p.MarinaPDraws`: the p-coin and the
compressor's index sets, the same draws ``marina_p.make_step`` takes) and
delta = x^{t+1} - x^t are the same on every rank, so each rank applies
``marina_p.make_broadcast`` to them and keeps its own workers' rows
(zero-byte correlated broadcast). The only
collective of a round's math is the uplink: one ``all_reduce`` of the packed
sums of g_i, f_i(w_i) and ||g_i||^2. MARINA-P's ``q_nnz_mean`` metric adds a
second one of a single count.

Each rank's subgradients go through :func:`repro_torch.kernels.ops.l1_subgrad`
on its [local_n, d, d] slice (the reference's ``_local_subgrads`` einsum is
this kernel, as in ``L1Problem.subgrad_all``); EF21-P's TopK goes through
``ops.block_topk`` on every rank. Both steps are numerically the single-
process steps of ``marina_p.py`` / ``ef21p.py`` up to the order of the
worker sums (tests/test_torch_distributed.py, and chip_smoke.py at n = 100).

The backend follows the device: NCCL for tensors on the card, gloo on the
CPU (:func:`backend_for`); a step refuses a group of the other backend.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..kernels import ops
from ..kernels.runtime import resolve_device
from .compressors import TopK
from .marina_p import MarinaPDraws, make_broadcast
from .stepsizes import Stepsize, descent_step


class SpmdMarinaPState(NamedTuple):
    x: torch.Tensor  # [d] replicated
    W: torch.Tensor  # [local_n, d]: this rank's workers' shifts
    t: int


class SpmdEF21PState(NamedTuple):
    x: torch.Tensor  # [d] replicated
    w: torch.Tensor  # [d] replicated (synchronized shift)
    t: int


def backend_for(device) -> str:
    """``nccl`` for the card, ``gloo`` for the CPU."""
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def init_process_group(init_method: str, *, rank: int, world_size: int, device="cuda") -> None:
    """``torch.distributed.init_process_group`` with the device's backend
    (:func:`backend_for`) and an explicit address (``tcp://127.0.0.1:<port>``
    or ``file://<path>``), world size and rank."""
    dist.init_process_group(backend_for(device), init_method=init_method, rank=rank,
                            world_size=world_size)


def rank_device(device="cuda") -> torch.device:
    """This rank's device: the CPU, or card ``rank mod device_count``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    return dev


def _layout(group, n: int, device):
    """(rank, world size, local_n, device) of ``group``, after checking that
    n splits evenly and that the group's backend is the device's."""
    world = dist.get_world_size(group)
    if n % world:
        raise ValueError(f"n={n} workers do not split over {world} ranks")
    dev = rank_device(device)
    backend = str(dist.get_backend(group)).lower()
    if backend != backend_for(dev):
        raise ValueError(f"process group backend {backend} does not serve {dev} "
                         f"(use {backend_for(dev)})")
    return dist.get_rank(group), world, n // world, dev


def shard_problem(group, A: torch.Tensor, device="cuda") -> torch.Tensor:
    """This rank's contiguous [local_n, d, d] slice of A [n, d, d], on its device."""
    rank, _, local_n, dev = _layout(group, A.shape[0], device)
    return A[rank * local_n:(rank + 1) * local_n].to(dev).contiguous()


def _uplink(group, A_local: torch.Tensor, W_local: torch.Tensor, n: int, with_sq: bool):
    """The one collective: all-reduce [sum_i g_i, sum_i f_i(w_i)(, sum_i
    ||g_i||^2)] over the group's workers; returns (g, f_w, g_sq_mean), the
    means over all n workers."""
    g_local = ops.l1_subgrad(A_local, W_local)  # [local_n, d]
    f_local = torch.sum(torch.abs(torch.matmul(A_local, W_local.unsqueeze(-1)).squeeze(-1)), dim=-1)
    parts = [torch.sum(g_local, dim=0), torch.sum(f_local).reshape(1)]
    if with_sq:
        parts.append(torch.sum(g_local**2).reshape(1))
    buf = torch.cat(parts)
    dist.all_reduce(buf, group=group)
    d = g_local.shape[-1]
    return buf[:d] / n, buf[d] / n, (buf[d + 1] / n if with_sq else None)


def make_marina_p_spmd_step(group, *, n: int, d: int, mode: str, k: int, p: float,
                            stepsize: Stepsize, device="cuda"):
    """One SPMD MARINA-P round (Algorithm 2):
    ``step(state, A_local, draws) -> (state, metrics)`` with ``state`` a
    :class:`SpmdMarinaPState` holding this rank's W rows and ``A_local``
    from :func:`shard_problem`. ``draws`` are the round's draws for all n
    workers (``marina_p.draw_round``), equal on every rank. ``p`` is the
    coin's probability, drawn into ``draws.coin``."""
    rank, _, local_n, _ = _layout(group, n, device)
    lo = rank * local_n
    bcast = make_broadcast(mode, n, k)

    def step(state: SpmdMarinaPState, A_local: torch.Tensor, draws: MarinaPDraws):
        g, f_w, g_sq_mean = _uplink(group, A_local, state.W, n, with_sq=True)
        aux = {"f_w": f_w, "g_norm_sq": torch.sum(g**2), "g_sq_mean": g_sq_mean}
        gamma = stepsize(state.t, aux)
        x_new = descent_step(state.x, gamma, g)
        # downlink: materialized locally from the shared draws, no bytes moved
        Q = bcast.apply(draws.idx, x_new - state.x)[lo:lo + local_n]
        W_new = x_new.expand(local_n, d).clone() if draws.coin else state.W + Q
        nnz = torch.count_nonzero(Q).reshape(1)
        dist.all_reduce(nnz, group=group)
        metrics = {
            "f_w": f_w,
            "gamma": gamma,
            "full_sync": float(draws.coin),
            # counted on the device, divided on the host in fp32, as make_step does
            "q_nnz_mean": float(np.float32(int(nnz)) / np.float32(n)),
        }
        return SpmdMarinaPState(x=x_new, W=W_new, t=state.t + 1), metrics

    return step


def make_ef21p_spmd_step(group, *, n: int, d: int, k: int, stepsize: Stepsize, device="cuda"):
    """One SPMD EF21-P round with the TopK downlink (Algorithm 1):
    ``step(state, A_local) -> (state, metrics)``. TopK is deterministic: every
    rank computes the same delta = TopK(x^{t+1} - w^t) from replicated
    values (``ops.block_topk``), so the downlink moves no bytes either."""
    _, _, local_n, _ = _layout(group, n, device)
    comp = TopK(k=k)

    def step(state: SpmdEF21PState, A_local: torch.Tensor):
        g, f_w, _ = _uplink(group, A_local, state.w.expand(local_n, d), n, with_sq=False)
        aux = {"f_w": f_w, "g_norm_sq": torch.sum(g**2)}
        gamma = stepsize(state.t, aux)
        x_new = descent_step(state.x, gamma, g)
        delta = comp(x_new - state.w)
        metrics = {"f_w": f_w, "gamma": gamma,
                   "delta_nnz": torch.sum(delta != 0).to(torch.float32)}
        return SpmdEF21PState(x=x_new, w=state.w + delta, t=state.t + 1), metrics

    return step


def init_marina_p(x0: torch.Tensor, local_n: int) -> SpmdMarinaPState:
    """w_i^0 = x^0 for this rank's workers."""
    return SpmdMarinaPState(x=x0, W=x0.expand(local_n, x0.shape[-1]).clone(), t=0)


def init_ef21p(x0: torch.Tensor) -> SpmdEF21PState:
    return SpmdEF21PState(x=x0, w=x0, t=0)
