"""Training loop wiring: model + optimizer + compressed downlink (port of
``repro/train/trainer.py``).

One MARINA-P round per train step (uplink exact, downlink compressed):

    workers:  g_i = grad_{w_i} loss(w_i, batch_i)      [a loop over the W replicas]
    server:   g = mean_i g_i                           [fp32]
              x_new, opt = optimizer(g, x, lr)         [fp32 master, flat]
    downlink: w_i += Q_i(x_new - x)  or full sync      [compressed broadcast]

The model lives as flat vectors in ravel order: the server's fp32 master
[d], the optimizer's moments [d], the worker replicas [W, d] (MARINA-P, in
``weight_dtype``) or the shift [d] (EF21-P). Each worker differentiates the
loss through ``params.grad_tree`` of its own replica (a fresh leaf a step),
so its ``.grad`` is its flat gradient. ``downlink=None`` is the
exact-broadcast baseline (classic data-parallel: w_i = x always).

A step's randomness is an argument: ``train_step(state, batch, draws,
force_sync)`` with ``draws`` from ``downlink.draw_round`` (plus the
participation plan's draws in ``draws.part``), so a test can hand it the
reference's. The step count, the learning rate of a schedule and the bit
counters (float32, accumulated as the reference accumulates them) live on
the host; the loss and the norms stay on the device, so a step queues its
work without a sync.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..core.comm_model import CommModel
from ..fleet.sampler import plan_from_legacy
from ..kernels.runtime import resolve_device
from ..models import lm
from ..models import params as P
from ..models.config import ModelConfig
from ..obs.trace import maybe_attr, span
from ..optim import Optimizer
from . import downlink as D
from .downlink import DownlinkDraws, EF21PDownlink

F32 = np.float32


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    n_workers: int = 4
    remat: bool = True
    attn_chunk: int = 512
    weight_dtype: Any = torch.float32     # worker replica dtype
    polyak_factor: float = 0.0            # >0: Polyak LR instead of schedule
    polyak_f_star: float = 0.0
    window_override: Optional[int] = None
    remat_policy: Optional[str] = None    # None/"full" | "dots"
    act_spec: Any = None                  # Spec("model", None, None): train/sharded.py only
    drop_prob: float = 0.0                # legacy shim over BernoulliStragglerPlan
    straggler_cutoff: float = 0.0         # legacy shim over BernoulliStragglerPlan
    participation: Any = None             # repro_torch.fleet ParticipationPlan (None = full)


def participation_plan(tcfg: TrainerConfig):
    """The round's participation hook: ``tcfg.participation``, or the legacy
    ``drop_prob`` / ``straggler_cutoff`` knobs as a BernoulliStragglerPlan."""
    plan = tcfg.participation
    if plan is not None and (tcfg.drop_prob > 0 or tcfg.straggler_cutoff > 0):
        raise ValueError(
            "TrainerConfig.participation and the legacy drop_prob/"
            "straggler_cutoff knobs are mutually exclusive; the legacy knobs "
            "are shims over BernoulliStragglerPlan — set one or the other."
        )
    return plan if plan is not None else plan_from_legacy(tcfg.drop_prob, tcfg.straggler_cutoff)


def init_state(cfg: ModelConfig, tcfg: TrainerConfig, downlink, optimizer: Optimizer, *,
               seed: int = 0, device="cuda"):
    """Random parameters from ``lm.lm_init(cfg, seed=seed)`` on ``device``,
    the optimizer's state, zero counters and the replicas (or the shift).
    ``device="meta"``: the same state as shapes alone (the dry-run's)."""
    server = lm.lm_init(cfg, device=device, seed=seed).flat.detach()
    state = {
        "server": server,
        "opt": optimizer.init(server),
        "step": 0,
        "bits_per_worker": F32(0),
        "uplink_bits_per_worker": F32(0),
    }
    if downlink is not None:
        state["workers"] = downlink.init_workers(server).to(tcfg.weight_dtype)
    return state


def worker_value_and_grad(cfg: ModelConfig, spec, fwd_kw: dict, row: torch.Tensor, shard):
    """One worker's (loss, fp32 flat gradient) at its replica ``row`` [d]:
    the loss differentiated through ``params.grad_tree`` of a fresh leaf.
    The step looks this name up at each call (the dry-run's count replaces
    it to charge W identical workers one worker's count each)."""
    leaf = row.detach().requires_grad_(True)
    loss = lm.loss_fn(cfg, P.grad_tree(spec, leaf), shard, **fwd_kw)
    loss.backward()
    return loss.detach(), leaf.grad.float()


def replica_rows(downlink, state, server, n: int) -> list:
    """The rows the round's ``n`` workers differentiate at: the master (the
    exact broadcast), EF21-P's shift, or MARINA-P's own replicas."""
    if downlink is None:
        return [server] * n
    if isinstance(downlink, EF21PDownlink):
        return [state["workers"]] * n
    return list(state["workers"])


def participation_weights(plan, draws: DownlinkDraws, W: int, step: int, device):
    """(the round's participation mask [W], each worker's weight 1/|S| or 0),
    or (None, None) under full participation. Only the uplink is masked; the
    downlink still addresses everyone."""
    if plan.is_full:
        return None, None
    participate = plan.mask(draws.part, W, step, device)
    return participate, participate.float() / torch.clamp(participate.sum(), min=1)


def worker_grad_sum(cfg: ModelConfig, spec, fwd_kw: dict, rows, batch: dict, first: int, weights):
    """(losses [n], the sum of the n workers' fp32 gradients, in worker
    order): worker ``first + i`` at ``rows[i]`` on ``batch``'s row i, its
    gradient times its participation weight where ``weights`` is given."""
    losses, grads = [], None
    for i, row in enumerate(rows):
        loss_i, g = worker_value_and_grad(cfg, spec, fwd_kw, row, {k: v[i] for k, v in batch.items()})
        if weights is not None:
            g = g * weights[first + i]
        grads = g if grads is None else grads.add_(g)
        losses.append(loss_i)
    return torch.stack(losses), grads


def server_lr(tcfg: TrainerConfig, lr_fn: Callable, loss, gnorm_sq, step: int):
    """The step's learning rate: Polyak's from the loss and ||g||^2, or the
    schedule's."""
    if tcfg.polyak_factor > 0:
        return (tcfg.polyak_factor * torch.clamp(loss - tcfg.polyak_f_star, min=0.0)
                / torch.clamp(gnorm_sq, min=1e-20))
    return lr_fn(step)


def step_outputs(state, d: int, server_new, opt_new, loss, gnorm_sq, lr, participate) -> tuple:
    """(new state, metrics) of the server's half of a step; the downlink's
    half is :func:`add_downlink`'s."""
    # ---- uplink: exact dense gradient per worker ---------------------------
    uplink_bits = F32(state["uplink_bits_per_worker"] + F32(CommModel(d=d).dense_bits()))
    new_state = {
        "server": server_new,
        "opt": opt_new,
        "step": state["step"] + 1,
        "bits_per_worker": state["bits_per_worker"],
        "uplink_bits_per_worker": uplink_bits,
    }
    metrics = {"loss": loss, "grad_norm": torch.sqrt(gnorm_sq), "lr": lr,
               "uplink_bits_per_worker": uplink_bits}
    if participate is not None:
        metrics["participants"] = participate.sum().float()
    return new_state, metrics


def add_downlink(state, new_state, metrics, workers_new, bits, drift) -> None:
    """The downlink's round into the step's new state and metrics."""
    new_state["workers"] = workers_new
    new_state["bits_per_worker"] = F32(state["bits_per_worker"] + bits)
    metrics["drift"] = drift


def make_train_step(cfg: ModelConfig, tcfg: TrainerConfig, downlink, optimizer: Optimizer,
                    lr_fn: Callable):
    """Returns ``train_step(state, batch, draws=None, force_sync=False) ->
    (state, metrics)``. batch leaves have a leading worker axis [W, B, ...]."""
    spec = lm.lm_spec(cfg)
    sizes = P.leaf_sizes(spec)
    d = sum(sizes)
    fwd_kw = dict(chunk=tcfg.attn_chunk, remat=tcfg.remat, window_override=tcfg.window_override,
                  remat_policy=tcfg.remat_policy, act_spec=tcfg.act_spec)
    plan = participation_plan(tcfg)
    W = tcfg.n_workers

    def train_step(state, batch, draws: Optional[DownlinkDraws] = None, force_sync=False):
        draws = draws if draws is not None else DownlinkDraws()
        server = state["server"]
        # ---- workers: forward/backward on their own replica -------------------
        rows = replica_rows(downlink, state, server, W)
        # ---- uplink: exact aggregation over the round's participants -----------
        participate, weights = participation_weights(plan, draws, W, state["step"], server.device)
        losses, grads = worker_grad_sum(cfg, spec, fwd_kw, rows, batch, 0, weights)
        if participate is not None:
            loss = torch.sum(weights * losses)
        else:
            grads.mul_(1.0 / W)  # jnp.mean: XLA multiplies by the reciprocal
            loss = torch.mean(losses)
        gnorm_sq = torch.sum(grads * grads)
        # ---- server master update ---------------------------------------------
        lr = server_lr(tcfg, lr_fn, loss, gnorm_sq, state["step"])
        server_new, opt_new = optimizer.update(grads, state["opt"], server, lr)
        new_state, metrics = step_outputs(state, d, server_new, opt_new, loss, gnorm_sq, lr, participate)
        # ---- downlink: compressed broadcast -------------------------------------
        if isinstance(downlink, EF21PDownlink):
            workers_new, bits = downlink.round(draws, sizes, server_new, state["workers"],
                                               force_sync)
        elif downlink is not None:
            workers_new, bits = downlink.round(draws, sizes, server_new, server,
                                               state["workers"], force_sync)
        if downlink is not None:
            add_downlink(state, new_state, metrics, workers_new, bits,
                         downlink.worker_drift(server_new, workers_new))
        metrics["bits_per_worker"] = new_state["bits_per_worker"]
        return new_state, metrics

    return train_step


def train_loop(
    cfg: ModelConfig,
    tcfg: TrainerConfig,
    downlink,
    optimizer: Optimizer,
    lr_fn: Callable,
    data,
    *,
    steps: int,
    seed: int = 0,
    device="cuda",
    tracker=None,
    log_every: int = 1,
    transport=None,
    wire_mag: str = "fp32",
):
    """Host loop around the step with per-step telemetry.

    Parameters come from ``init_state(seed=seed)``; each round's draws from
    ``downlink.draw_round`` on a CPU generator seeded with ``seed`` (the
    coin) and one on ``device`` (the masks), the participation draws from
    the plan's own generator. Each step is timed with a device-synchronised
    host timer ("train/step") and its metrics (loss, grad_norm, lr, drift,
    bits_per_worker, uplink_bits_per_worker) are logged to ``tracker`` at
    ``log_every`` cadence. Returns (final_state, last_metrics).

    ``transport`` (a :class:`repro_torch.transport.Fleet` or a
    :class:`repro_torch.transport.FaultSpec`) additionally pushes each round's
    downlink through fault-injected reliable links via the downlink's
    ``broadcast_via``; a round whose delivery degrades (undelivered worker
    or receiver resync request) promotes the *next* round's broadcast to a
    full sync, whose self-contained SYNC frame repairs every receiver
    (DESIGN.md §8.4). The last metrics dict then carries the fleet counters
    under ``"transport"``."""
    from .. import obs

    tracker = tracker or obs.NullTracker()
    dev = resolve_device(device)
    state = init_state(cfg, tcfg, downlink, optimizer, seed=seed, device=dev)
    step = make_train_step(cfg, tcfg, downlink, optimizer, lr_fn)
    sizes = P.leaf_sizes(lm.lm_spec(cfg))
    plan = participation_plan(tcfg)
    gen = torch.Generator().manual_seed(seed)
    dev_gen = torch.Generator(dev).manual_seed(seed)
    part_gen = None if plan.is_full else plan.generator(seed)
    fleet = None
    if transport is not None and downlink is not None:
        from ..transport import FaultSpec, Fleet

        fleet = (Fleet.make(tcfg.n_workers, transport, timeout=2, max_retries=2)
                 if isinstance(transport, FaultSpec) else transport)
    m = {}
    force_sync = False
    for i in range(steps):
        batch = data.batch(i)
        draws = D.draw_round(downlink, sizes, gen, dev_gen)
        if part_gen is not None:
            draws = draws._replace(part=plan.draw(tcfg.n_workers, part_gen, dev))
        prev_server = state["server"]
        prev_workers = state.get("workers")
        was_forced = force_sync
        with span(tracker, "round", round=i, alg="train") as rsp:
            with tracker.time_block("train/step", step=i) as tb:
                state, m = step(state, batch, draws, force_sync)
                tb.block(m)
            if fleet is not None:
                prev = prev_workers if isinstance(downlink, EF21PDownlink) else prev_server
                res = downlink.broadcast_via(fleet, draws, sizes, state["server"], prev,
                                             mag=wire_mag, force_sync=force_sync,
                                             tracker=tracker, step=i)
                force_sync = res["resync_needed"]
                maybe_attr(rsp, full_sync=res["full_sync"], resync_next=force_sync)
            maybe_attr(rsp, force_sync=was_forced, loss=float(m["loss"]))
        if i % log_every == 0:
            tracker.log({"train": m}, step=i)
    if fleet is not None:
        m = dict(m)
        m["transport"] = fleet.stats().as_metrics()
    return state, m
