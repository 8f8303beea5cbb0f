"""The LM train step across a process group: MARINA-P / EF21-P's W workers
over the mesh's "data" axis, the server's fp32 master and optimizer moments
in ZeRO-1 shards over every rank, and ``act_spec`` over "model" (the
counterpart of what the reference does with ``jax.jit(make_train_step(...),
in_shardings=...)`` over ``launch/specs.build``'s specs on a ("data",
"model") mesh).

:class:`Layout`: a mesh of D x M ranks, rank r at (r // M, r % M).

* Workers: W % D == 0, and data index a owns workers ``a * W/D ... (a + 1) *
  W/D - 1`` (the reference ``worker`` layout's leading W axis over "data").
  A rank holds its data index's rows of MARINA-P's replicas [W/D, d] (the M
  ranks of one data index hold the same rows), or EF21-P's shift [d] whole.
* The flat server state (``server`` and every [d] vector of
  ``optimizer.init``): D·M contiguous slices of the ravel order, padded with
  zeros to a multiple of D·M; rank r holds slice r (ZeRO-1). The reference's
  ``server`` layout shards each leaf over ("data", "model") where divisible;
  the optimizer is elementwise, so the two differ in residency only.
* The batch: rank r takes its workers' rows of the global [W, B, ...] batch.
  With ``act_spec = Spec("model", None, None)`` each worker's B rows split
  over the M ranks of its data index: the reference's sharding constraint on
  the hidden states, which it sets only where B % M == 0.

One step on every rank, with the single-process step's arithmetic (the
helpers of ``train/trainer.py`` that both steps call; this module adds the
collectives and the slicing):

1. each local worker's loss and fp32 gradient on its rows, summed in worker
   order, weighted by the participation plan's mask (every rank computes the
   whole mask from the round's draws);
2. one ``reduce-scatter`` (sum) of that [d] partial sum gives the rank's
   slice of sum_i g_i, times 1/W (and 1/M under ``act_spec``: a worker's
   loss is the mean of its M equal row blocks' means);
3. one ``all-reduce`` of W + 1 floats: the workers' losses (each rank writes
   its own, zeros elsewhere, so the sum is exact) and ||g||^2 of the slices;
4. the Polyak or schedule lr, and ``optimizer.update`` on the slice;
5. ``all-gather`` of x^{t+1}'s slices (every step: syncs, EF21-P and the
   drift read x^{t+1} whole) and, in a compressed MARINA-P round, of the fp32
   delta x^{t+1} - x^t computed on the slice; the exact broadcast
   (``downlink=None``) gathers x^t at the start of the step instead;
6. the downlink on the rank's own rows (``MarinaPDownlink.round_rows``;
   EF21-P's block-TopK on every rank, as ``core/distributed.py`` runs TopK)
   and one ``all-reduce`` of MARINA-P's drift over the local rows (each
   row counted once: by the first model rank of its data index).

At one rank the step is ``make_train_step``'s bit for bit. The collectives
go through a communicator over every rank (``launch/comm.py``): :class:`Comm`
calls the process group and tallies the result-shape bytes it hands over;
:class:`CountingComm` charges the same bytes and calls nothing, so the
dry-run counts one rank of a 256-rank mesh on ``meta`` with no group. Both
charge an open op count (:func:`repro_torch.launch.op_cost.counting`).

Refused (not ported): tensor parallelism over "model" (M > 1 without
``act_spec``: the reference then shards the replicas' inner dims), and
``act_spec`` for configs with experts (MoE capacity is computed over all
tokens of a call, ``models/moe.py``, so a split batch drops other tokens).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..launch.comm import Comm, CountingComm, device_type  # noqa: F401 (re-exported)
from ..launch.mesh import Mesh
from ..launch.sharding import Spec
from ..models import lm
from ..models import params as P
from ..models.config import ModelConfig
from ..optim import Optimizer
from . import trainer
from .downlink import DownlinkDraws, EF21PDownlink

ACT_SPEC = Spec("model", None, None)


@dataclasses.dataclass(frozen=True)
class Layout:
    """Rank ``rank`` of ``mesh`` (axes ("data", "model")), its share of
    ``n_workers`` federated workers and of a flat state of ``d`` values."""

    mesh: Mesh
    rank: int
    n_workers: int
    d: int

    def __post_init__(self):
        if tuple(self.mesh.axis_names) != ("data", "model"):
            raise ValueError(f"the sharded step runs on a ('data', 'model') mesh, not {self.mesh.axis_names}")
        if not 0 <= self.rank < self.mesh.size:
            raise ValueError(f"rank {self.rank} outside a mesh of {self.mesh.size}")
        if self.n_workers % self.data_size:
            raise ValueError(f"{self.n_workers} workers do not split over 'data' = {self.data_size}")

    @property
    def data_size(self) -> int:
        return self.mesh.shape["data"]

    @property
    def model_size(self) -> int:
        return self.mesh.shape["model"]

    @property
    def world(self) -> int:
        return self.mesh.size

    @property
    def coords(self) -> tuple:
        """(data index, model index) of this rank."""
        return divmod(self.rank, self.model_size)

    @property
    def local(self) -> int:
        """Workers a rank holds."""
        return self.n_workers // self.data_size

    @property
    def off(self) -> int:
        """Global id of this rank's first worker."""
        return self.coords[0] * self.local

    @property
    def shard_len(self) -> int:
        return -(-self.d // self.world)

    @property
    def padded(self) -> int:
        return self.shard_len * self.world

    def shard(self, flat: torch.Tensor) -> torch.Tensor:
        """This rank's slice [shard_len] of a flat [d] vector (zeros past d)."""
        c = self.shard_len
        piece = flat[self.rank * c:(self.rank + 1) * c]
        out = flat.new_zeros(c)
        out[:piece.shape[0]] = piece
        return out

    def local_batch(self, batch: dict, split: int) -> dict:
        """This rank's rows of a global batch [W, B, ...]: its workers, and
        under ``act_spec`` (``split`` = M) its model index's B/M rows of each."""
        m = self.coords[1]
        out = {}
        for k, v in batch.items():
            if v.shape[0] != self.n_workers:
                raise ValueError(f"batch[{k!r}] has {v.shape[0]} workers, the layout {self.n_workers}")
            if v.shape[1] % split:
                raise ValueError(f"{v.shape[1]} rows a worker do not split over 'model' = {split}: the "
                                 "reference drops act_spec there (launch/specs.py), which leaves tensor "
                                 "parallelism over 'model', not ported")
            b = v.shape[1] // split
            rows = v[self.off:self.off + self.local]
            out[k] = rows if split == 1 else rows[:, m * b:(m + 1) * b]
        return out


def connect(mesh: Mesh, n_workers: int, d: int) -> tuple:
    """(this rank's :class:`Layout`, a :class:`Comm` over the default process
    group), which must have ``mesh.size`` ranks: the mesh's ``DeviceMesh``
    is built to check it, and gives this rank's coordinates."""
    dm = mesh.device_mesh(device_type())
    layout = Layout(mesh, dist.get_rank(), n_workers, d)
    if tuple(dm.get_coordinate()) != layout.coords:
        raise RuntimeError(f"rank {layout.rank}: DeviceMesh coordinate {dm.get_coordinate()} "
                           f"!= {layout.coords}")
    return layout, Comm()


# ---------------------------------------------------------------------------
# the state on the ranks
# ---------------------------------------------------------------------------


def shard_state(full: dict, layout: Layout) -> dict:
    """This rank's share of a single-process train state (``trainer.init_state``'s,
    or the reference's through ``convert.train_state_from_numpy``): the
    server's and the optimizer's [d] vectors sliced, MARINA-P's replicas
    [W, d] cut to the rank's rows, EF21-P's shift and the counters as they
    are (copies: the rank's state shares no storage with ``full``)."""
    d = layout.d

    def flat(t):
        return layout.shard(t) if isinstance(t, torch.Tensor) and t.shape == (d,) else t

    out = {k: v for k, v in full.items() if k not in ("server", "opt", "workers")}
    out["server"] = layout.shard(full["server"])
    out["opt"] = {k: flat(v) for k, v in full["opt"].items()}
    if "workers" in full:
        w = full["workers"]
        out["workers"] = w[layout.off:layout.off + layout.local].clone() if w.dim() == 2 else w.clone()
    return out


def gather_state(state: dict, layout: Layout, comm: Comm) -> dict:
    """The single-process state that the ranks' states (:func:`shard_state`'s
    layout) hold, on every rank: the slices and the replicas' rows gathered
    (every rank must call it)."""
    d = layout.d

    def gather(t):
        out = t.new_empty(layout.world * t.shape[0], *t.shape[1:])
        comm.all_gather(out, t.contiguous())
        return out

    def flat(t):
        return gather(t)[:d].clone() if isinstance(t, torch.Tensor) and t.dim() == 1 else t

    out = {k: v for k, v in state.items() if k not in ("server", "opt", "workers")}
    out["server"] = flat(state["server"])
    out["opt"] = {k: flat(v) for k, v in state["opt"].items()}
    if "workers" in state:
        w = state["workers"]
        if w.dim() == 2:  # the model index 0 rank of each data index
            rows = gather(w).reshape(layout.data_size, layout.model_size, layout.local, d)
            out["workers"] = rows[:, 0].reshape(layout.n_workers, d).clone()
        else:
            out["workers"] = w.clone()
    return out


def init_state(cfg: ModelConfig, tcfg, downlink, optimizer: Optimizer, layout: Layout, *,
               seed: int = 0, device="cuda") -> dict:
    """This rank's share of ``trainer.init_state(cfg, tcfg, downlink,
    optimizer, seed=seed, device=device)``."""
    return shard_state(trainer.init_state(cfg, tcfg, downlink, optimizer, seed=seed, device=device), layout)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def row_split(cfg: ModelConfig, tcfg, layout: Layout) -> int:
    """How many row blocks each worker's batch splits into: M under
    ``act_spec = Spec("model", None, None)``, else 1. Raises where the port
    has no counterpart of the reference's program."""
    M = layout.model_size
    if tcfg.act_spec is None:
        if M > 1:
            raise ValueError(f"a mesh with 'model' = {M} and no act_spec is tensor parallelism over "
                             "'model' (the worker layout's inner dims), which the port does not run; "
                             "set act_spec = Spec('model', None, None)")
        return 1
    if tuple(tcfg.act_spec) != tuple(ACT_SPEC):
        raise ValueError(f"act_spec {tcfg.act_spec}: the sharded step realizes {ACT_SPEC} only")
    if cfg.moe is not None:
        raise ValueError("act_spec with experts is not ported: MoE capacity is computed over all B*S "
                         "tokens of a call (models/moe.py), so splitting a worker's rows over 'model' "
                         "drops other tokens than the reference's step")
    return M


def make_sharded_train_step(cfg: ModelConfig, tcfg, downlink, optimizer: Optimizer, lr_fn: Callable,
                            layout: Layout, comm: Comm):
    """``train_step(state, batch, draws=None, force_sync=False) -> (state,
    metrics)`` of one rank: ``state`` in :func:`shard_state`'s layout,
    ``batch`` the global [W, B, ...] batch (the rank takes its rows),
    ``draws`` the round's draws for all W workers, the same on every rank.
    The metrics are the single-process step's, equal on every rank."""
    spec = lm.lm_spec(cfg)
    sizes = P.leaf_sizes(spec)
    d = sum(sizes)
    W = tcfg.n_workers
    if (layout.d, layout.n_workers) != (d, W):
        raise ValueError(f"layout of {layout.n_workers} workers x d={layout.d}, model {W} x d={d}")
    split = row_split(cfg, tcfg, layout)
    fwd_kw = dict(chunk=tcfg.attn_chunk, remat=tcfg.remat, window_override=tcfg.window_override,
                  remat_policy=tcfg.remat_policy)
    plan = trainer.participation_plan(tcfg)
    lo, local = layout.off, layout.local

    def gather(shard):
        full = shard.new_empty(layout.padded)
        comm.all_gather(full, shard)
        return full[:d]

    def train_step(state, batch, draws: Optional[DownlinkDraws] = None, force_sync=False):
        draws = draws if draws is not None else DownlinkDraws()
        shard = state["server"]
        # ---- workers: forward/backward on their own replica -------------------
        rows = trainer.replica_rows(downlink, state, gather(shard) if downlink is None else None, local)
        participate, weights = trainer.participation_weights(plan, draws, W, state["step"], shard.device)
        losses, grads = trainer.worker_grad_sum(cfg, spec, fwd_kw, rows, layout.local_batch(batch, split),
                                                lo, weights)
        # ---- uplink: this rank's slice of the aggregate ----------------------------
        if layout.padded > d:
            grads = F.pad(grads, (0, layout.padded - d))
        g = comm.reduce_scatter(grads.new_empty(layout.shard_len), grads)
        if participate is None:
            g.mul_(1.0 / (W * split))  # jnp.mean: XLA multiplies by the reciprocal
        elif split > 1:
            g.mul_(1.0 / split)
        scalars = torch.zeros(W + 1, device=shard.device)
        scalars[lo:lo + local] = losses if split == 1 else losses / split
        scalars[W] = torch.sum(g * g)
        comm.all_reduce(scalars)
        losses, gnorm_sq = scalars[:W], scalars[W]
        loss = torch.mean(losses) if participate is None else torch.sum(weights * losses)
        # ---- server master update on the slice ------------------------------------
        lr = trainer.server_lr(tcfg, lr_fn, loss, gnorm_sq, state["step"])
        shard_new, opt_new = optimizer.update(g, state["opt"], shard, lr)
        new_state, metrics = trainer.step_outputs(state, d, shard_new, opt_new, loss, gnorm_sq, lr,
                                                  participate)
        # ---- downlink: the rank's rows ------------------------------------------------
        if isinstance(downlink, EF21PDownlink):
            x_new = gather(shard_new)
            workers_new, bits = downlink.round(draws, sizes, x_new, state["workers"], force_sync)
            drift = downlink.worker_drift(x_new, workers_new)
        elif downlink is not None:
            x_new = gather(shard_new)
            delta = None if (draws.coin or force_sync) else gather(shard_new - shard)
            workers_new, bits = downlink.round_rows(draws, sizes, x_new, delta, state["workers"], lo,
                                                    force_sync)
            # the M ranks of a data index hold the same rows: the first one counts them
            part = downlink.drift_sum(x_new, workers_new).reshape(1)
            drift = comm.all_reduce(part if layout.coords[1] == 0 else torch.zeros_like(part))[0] / W
        if downlink is not None:
            trainer.add_downlink(state, new_state, metrics, workers_new, bits, drift)
        metrics["bits_per_worker"] = new_state["bits_per_worker"]
        return new_state, metrics

    return train_step
