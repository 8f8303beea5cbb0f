"""The LM train step across a process group: MARINA-P / EF21-P's W workers
over the mesh's "data" axis, the server's fp32 master and optimizer moments
in ZeRO-1 shards, and the "model" axis as tensor parallelism (the
reference's ``worker`` layout) or as ``act_spec`` (the counterpart of what
the reference does with ``jax.jit(make_train_step(...), in_shardings=...)``
over ``launch/specs.build``'s specs on a ("data", "model") mesh).

:class:`Layout`: a mesh of D x M ranks, rank r at (r // M, r % M).

* Workers: W % D == 0, and data index a owns workers ``a * W/D ... (a + 1) *
  W/D - 1`` (the reference ``worker`` layout's leading W axis over "data").
* Tensor parallelism (M > 1 and no ``act_spec``; a layout with ``blocks``,
  :func:`model_blocks`): each leaf's inner dims as the reference's ``worker``
  layout puts them over "model" (``sharding._base_spec`` without FSDP, the
  ``tp`` serving layout's spec). The rank's "model-local" vector is its
  block of every leaf in ravel order, each block raveled (replicated leaves
  whole): ``d_local`` values. MARINA-P's replicas on a rank are [W/D,
  d_local] of its data index's rows; EF21-P's shift stays whole [d] on
  every rank (the forward reads its blocks). The master and the moments
  are ZeRO-1 slices of the model-local vector over "data" (the reference's
  ``server`` layout: "model" first, then the data axes), ``ceil(d_local /
  D)`` values. The layers run with the rank's
  :class:`~repro_torch.serve.sharded.ServeShard` under the ``tp`` layout
  (column-parallel products, row-parallel partials summed in fp32, the
  embedding's rows and the vocabulary split over "model", kv heads gathered
  where the split cuts one; moe's experts over "model" on E, RWKV-6's and
  Mamba2's recurrences on the rank's heads), whose collectives carry the
  gradients (``launch/comm.py``, one backward per kind of use: the
  ``ServeShard`` docstring); the loss is the vocabulary-parallel CE. Every
  family the reference trains runs so: dense, vlm, audio, moe, ssm, hybrid.
* Otherwise (data parallelism, and ``act_spec``): a rank holds its data
  index's rows of MARINA-P's replicas [W/D, d] whole (the M ranks of one
  data index hold the same rows), or EF21-P's shift [d]. The flat server
  state: D·M contiguous slices of the ravel order, padded with zeros to a
  multiple of D·M; rank r holds slice r (ZeRO-1). The reference's
  ``server`` layout shards each leaf over ("data", "model") where
  divisible; the optimizer is elementwise, so the two differ in residency
  only. With ``act_spec = Spec("model", None, None)`` each worker's B rows
  split over the M ranks of its data index: the reference's sharding
  constraint on the hidden states, which it sets only where B % M == 0.

One step on every rank, with the single-process step's arithmetic (the
helpers of ``train/trainer.py`` that both steps call; this module adds the
collectives and the slicing):

1. each local worker's loss and fp32 gradient on its rows (under tensor
   parallelism, of the rank's blocks, through ``worker_value_and_grad``),
   summed in worker order, weighted by the participation plan's mask (every
   rank computes the whole mask from the round's draws);
2. one ``reduce-scatter`` (sum) of that partial sum gives the rank's slice
   of sum_i g_i, times 1/W (and 1/M under ``act_spec``: a worker's loss is
   the mean of its M equal row blocks' means); under tensor parallelism
   over "data" only;
3. one ``all-reduce`` of W + 1 floats: the workers' losses (each worker's
   written once, zeros elsewhere, so the sum is exact) and ||g||^2 of the
   slices (under tensor parallelism a replicated leaf counted by model
   index 0 only);
4. the Polyak or schedule lr, and ``optimizer.update`` on the slice;
5. ``all-gather`` of x^{t+1}'s slices (every step: syncs, EF21-P and the
   drift read x^{t+1}) and, in a compressed MARINA-P round, of the fp32
   delta x^{t+1} - x^t computed on the slice; the exact broadcast
   (``downlink=None``) gathers x^t at the start of the step instead; under
   tensor parallelism over "data", giving the model-local vector (EF21-P
   gathers its blocks over "model" too, into ravel order);
6. the downlink on the rank's own rows (``MarinaPDownlink.round_rows``;
   under tensor parallelism on its blocks, perm through
   ``rotk_apply_rows``' block map; EF21-P's block-TopK on the whole leaves
   on every rank, since a TopK block of 1024 crosses a column block, as
   ``core/distributed.py`` runs TopK) and one ``all-reduce`` of MARINA-P's
   drift over the local rows (each coordinate of each row counted once).

At one rank the step is ``make_train_step``'s bit for bit. The collectives
go through a communicator (``launch/comm.py``): :class:`Comm` calls the
process groups and tallies the result-shape bytes it hands over (the
layers' forward, backward and recomputed collectives too);
:class:`CountingComm` charges the same bytes and calls nothing, so the
dry-run counts one rank of a 256-rank mesh on ``meta`` with no group. Both
charge an open op count (:func:`repro_torch.launch.op_cost.counting`).

Refused (not ported): tensor parallelism for a column- or row-parallel
weight "model" does not split, and ``act_spec`` for configs with experts
(MoE capacity is computed over all tokens of a call, ``models/moe.py``, so a
split batch drops other tokens).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..launch import sharding as sh
from ..launch.comm import Comm, CountingComm, device_type, mesh_groups  # noqa: F401 (re-exported)
from ..launch.mesh import Mesh
from ..launch.sharding import Spec
from ..models import lm
from ..models import params as P
from ..models.config import ModelConfig
from ..optim import Optimizer
from ..serve import sharded as SS
from . import trainer
from .downlink import DownlinkDraws, EF21PDownlink, LeafBlock

ACT_SPEC = Spec("model", None, None)


@dataclasses.dataclass(frozen=True)
class Layout:
    """Rank ``rank`` of ``mesh`` (axes ("data", "model")), its share of
    ``n_workers`` federated workers and of a flat state of ``d`` values."""

    mesh: Mesh
    rank: int
    n_workers: int
    d: int
    blocks: Optional[tuple] = None  # tensor parallelism: the rank's LeafBlock of every leaf

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
    def tp(self) -> bool:
        """Tensor parallelism over "model": the rank holds its blocks."""
        return self.blocks is not None

    @property
    def d_local(self) -> int:
        """Values of the rank's model-local vector (d without blocks)."""
        return self.d if self.blocks is None else sum(b.size for b in self.blocks)

    @property
    def slices(self) -> int:
        """Ranks the server's flat state is sliced over: the data axis under
        tensor parallelism, else every rank."""
        return self.data_size if self.tp else self.world

    @property
    def slice_index(self) -> int:
        return self.coords[0] if self.tp else self.rank

    @property
    def shard_len(self) -> int:
        return -(-self.d_local // self.slices)

    @property
    def padded(self) -> int:
        return self.shard_len * self.slices

    def shard(self, flat: torch.Tensor) -> torch.Tensor:
        """This rank's slice [shard_len] of a flat [d_local] vector (zeros past it)."""
        c = self.shard_len
        piece = flat[self.slice_index * c:(self.slice_index + 1) * c]
        out = flat.new_zeros(c)
        out[:piece.shape[0]] = piece
        return out

    def model_local(self, t: torch.Tensor) -> torch.Tensor:
        """The rank's model-local vector [..., d_local] of ``t`` [..., d]
        (a copy; ``t`` itself without blocks)."""
        if self.blocks is None:
            return t
        out, o = [], 0
        for b in self.blocks:
            s = b.size // b.chunk * b.stride  # the whole leaf's values
            out.append(b.cut(t[..., o:o + s]))
            o += s
        return torch.cat(out, -1)

    def whole(self, parts: torch.Tensor) -> torch.Tensor:
        """[..., d] from every model index's model-local vector ``parts``
        [M, ..., d_local] (a replicated leaf from model index 0)."""
        M = self.model_size
        out = []
        for b in self.blocks:
            p = parts[..., b.lo:b.lo + b.size]
            if b.chunk == b.stride:
                out.append(p[0])
                continue
            lead = p.shape[1:-1]
            p = p.reshape(M, *lead, -1, b.chunk).movedim(0, -2)  # [..., runs, M, chunk]
            out.append(p.reshape(*lead, -1))
        return torch.cat(out, -1)

    def counted_once(self, device) -> torch.Tensor:
        """[d_local] weights summing each model-local coordinate once over
        "model": 1 in a split leaf's block, in a replicated leaf 1 at model
        index 0 and 0 elsewhere."""
        w = torch.ones(self.d_local, device=device)
        if self.coords[1]:
            for b in self.blocks:
                if b.chunk == b.stride:
                    w[b.lo:b.lo + b.size] = 0
        return w

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
                                 "reference drops act_spec there (launch/specs.py) and runs tensor "
                                 "parallelism over 'model' (a layout with the rank's blocks: connect(..., "
                                 "cfg=cfg) and no act_spec)")
            b = v.shape[1] // split
            rows = v[self.off:self.off + self.local]
            out[k] = rows if split == 1 else rows[:, m * b:(m + 1) * b]
        return out


def leaf_block(shape, dim: Optional[int], M: int, m: int, lo: int = 0) -> LeafBlock:
    """Model index ``m``'s block of a leaf of ``shape`` cut in M along
    ``dim`` (None: whole), at ``lo`` in the rank's model-local vector."""
    size = math.prod(shape)
    if dim is None or M == 1:
        return LeafBlock(lo, size, size, size, 0)
    dim %= len(shape)
    inner = math.prod(shape[dim + 1:])
    chunk = shape[dim] // M * inner
    return LeafBlock(lo, size // M, chunk, shape[dim] * inner, m * chunk)


def model_blocks(cfg: ModelConfig, mesh: Mesh, rank: int) -> tuple:
    """The :class:`~.downlink.LeafBlock` of every leaf of ``cfg``'s model, in
    ravel order, that rank ``rank`` holds under tensor parallelism over
    "model": each leaf cut on the dim its ``tp`` spec (the reference
    ``worker`` layout's inner spec) puts "model" on, whole where none."""
    tree = lm.lm_spec(cfg)
    specs = sh.spec_leaves(sh.param_specs(tree, mesh, "tp"))
    M, m = mesh.shape["model"], rank % mesh.shape["model"]
    out, lo = [], 0
    for leaf, (_, spec) in zip(P.leaves(tree), specs):
        dims = [i for i, e in enumerate(spec) if e == "model"]
        out.append(leaf_block(leaf.shape, dims[0] if dims else None, M, m, lo))
        lo += out[-1].size
    return tuple(out)


def connect(mesh: Mesh, n_workers: int, d: int, cfg: Optional[ModelConfig] = None) -> tuple:
    """(this rank's :class:`Layout`, a :class:`Comm` over the default process
    group and the mesh's "data" and "model" groups), which must have
    ``mesh.size`` ranks: the mesh's ``DeviceMesh`` is built to check it, and
    gives this rank's coordinates. ``cfg`` with "model" > 1: the layout of
    tensor parallelism over "model" (the rank's :func:`model_blocks`); leave
    it out for ``act_spec``."""
    dm = mesh.device_mesh(device_type())
    rank = dist.get_rank()
    blocks = model_blocks(cfg, mesh, rank) if cfg is not None and mesh.shape["model"] > 1 else None
    layout = Layout(mesh, rank, n_workers, d, blocks)
    if tuple(dm.get_coordinate()) != layout.coords:
        raise RuntimeError(f"rank {layout.rank}: DeviceMesh coordinate {dm.get_coordinate()} "
                           f"!= {layout.coords}")
    return layout, Comm(mesh_groups(dm))


# ---------------------------------------------------------------------------
# the state on the ranks
# ---------------------------------------------------------------------------


def shard_state(full: dict, layout: Layout) -> dict:
    """This rank's share of a single-process train state (``trainer.init_state``'s,
    or the reference's through ``convert.train_state_from_numpy``): the
    server's and the optimizer's [d] vectors sliced (under tensor
    parallelism their model-local vectors), MARINA-P's replicas [W, d] cut
    to the rank's rows (and blocks), EF21-P's shift and the counters as
    they are (copies: the rank's state shares no storage with ``full``)."""
    d = layout.d

    def flat(t):
        return layout.shard(layout.model_local(t)) if isinstance(t, torch.Tensor) and t.shape == (d,) else t

    out = {k: v for k, v in full.items() if k not in ("server", "opt", "workers")}
    out["server"] = flat(full["server"])
    out["opt"] = {k: flat(v) for k, v in full["opt"].items()}
    if "workers" in full:
        w = full["workers"]
        rows = w[layout.off:layout.off + layout.local] if w.dim() == 2 else None
        out["workers"] = w.clone() if rows is None else layout.model_local(rows).clone()
    return out


def gather_state(state: dict, layout: Layout, comm: Comm) -> dict:
    """The single-process state that the ranks' states (:func:`shard_state`'s
    layout) hold, on every rank: the slices, the replicas' rows and blocks
    gathered (every rank must call it; one all-gather over every rank a
    tensor)."""
    d, D, M = layout.d, layout.data_size, layout.model_size

    def gather(t):
        out = t.new_empty(layout.world * t.shape[0], *t.shape[1:])
        comm.all_gather(out, t.contiguous())
        return out.reshape(D, M, *t.shape)

    def flat(t):
        if not (isinstance(t, torch.Tensor) and t.dim() == 1):
            return t
        g = gather(t)
        if not layout.tp:
            return g.reshape(-1)[:d].clone()
        return layout.whole(g.movedim(1, 0).reshape(M, -1)[:, :layout.d_local])

    out = {k: v for k, v in state.items() if k not in ("server", "opt", "workers")}
    out["server"] = flat(state["server"])
    out["opt"] = {k: flat(v) for k, v in state["opt"].items()}
    if "workers" in state:
        w = state["workers"]
        if w.dim() == 1:
            out["workers"] = w.clone()
        elif layout.tp:  # [D, M, local, d_local]: each data index's rows from its M blocks
            out["workers"] = layout.whole(gather(w).movedim(1, 0)).reshape(layout.n_workers, d)
        else:  # the model index 0 rank of each data index
            out["workers"] = gather(w)[:, 0].reshape(layout.n_workers, d).clone()
    return out


def init_state(cfg: ModelConfig, tcfg, downlink, optimizer: Optimizer, layout: Layout, *,
               seed: int = 0, device="cuda") -> dict:
    """This rank's share of ``trainer.init_state(cfg, tcfg, downlink,
    optimizer, seed=seed, device=device)``."""
    return shard_state(trainer.init_state(cfg, tcfg, downlink, optimizer, seed=seed, device=device), layout)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def check_tensor_parallel(cfg: ModelConfig, layout: Layout) -> None:
    """Raise ``serve/sharded.NotPorted`` unless the port runs ``cfg``'s train
    step with tensor parallelism over ``layout``'s "model" axis: every
    family whose serving step across ranks is ported, with every weight of a
    column- or row-parallel product split (a product "model" does not split
    would run whole on every rank, and its gradients are not carried)."""
    SS.check_ported(cfg, "the train step's tensor parallelism over 'model' (the reference's worker layout)")
    tree = lm.lm_spec(cfg)
    for (path, leaf), b in zip(P.leaves_with_path(tree), layout.blocks):
        name = path[-1]
        if b.chunk == b.stride and (name in sh._COL or name in sh._ROW):
            raise SS.NotPorted(f"{cfg.arch_id}: {P.path_key(path)} {tuple(leaf.shape)} does not split over "
                               f"'model' = {layout.model_size}: its product would run whole on every rank, "
                               "which the port's tensor parallelism does not carry")


def row_split(cfg: ModelConfig, tcfg, layout: Layout) -> int:
    """How many row blocks each worker's batch splits into: M under
    ``act_spec = Spec("model", None, None)``, else 1. Raises where the port
    has no counterpart of the reference's program."""
    M = layout.model_size
    if tcfg.act_spec is None:
        if M > 1 and not layout.tp:
            raise ValueError(f"a mesh with 'model' = {M} and no act_spec is tensor parallelism over 'model' "
                             "(the worker layout's inner dims): its layout holds the rank's blocks "
                             "(connect(..., cfg=cfg), model_blocks)")
        if layout.tp:
            check_tensor_parallel(cfg, layout)
        return 1
    if layout.tp:
        raise ValueError("act_spec runs on whole replicas: a layout without the rank's blocks")
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
    tp = layout.tp
    if tp:
        fwd_kw["tp"] = SS.ServeShard(cfg, SS.ServeLayout(layout.mesh, layout.rank, "tp"), comm)
    plan = trainer.participation_plan(tcfg)
    lo, local, D, m = layout.off, layout.local, layout.data_size, layout.coords[1]
    slice_axis = "data" if tp else None  # the server's slices lie over it
    once = {}  # device -> the model-local coordinates' weights (each counted once over "model")

    def gather(shard):
        """The model-local vector (the whole [d] without blocks) from the slices."""
        if tp and D == 1:
            return shard[:layout.d_local]
        full = shard.new_empty(layout.padded)
        comm.all_gather(full, shard, slice_axis)
        return full[:layout.d_local]

    def whole(x_local):
        """[d] from the model index's model-local vectors (EF21-P)."""
        parts = x_local.new_empty(layout.model_size * layout.d_local)
        comm.all_gather(parts, x_local, "model")
        return layout.whole(parts.reshape(layout.model_size, -1))

    def counted_once(device):
        if device not in once:
            once[device] = layout.counted_once(device)
        return once[device]

    def train_step(state, batch, draws: Optional[DownlinkDraws] = None, force_sync=False):
        draws = draws if draws is not None else DownlinkDraws()
        shard = state["server"]
        # ---- workers: forward/backward on their own replica -------------------
        if tp and isinstance(downlink, EF21PDownlink):
            rows = [layout.model_local(state["workers"])] * local  # the shift's blocks
        else:
            rows = trainer.replica_rows(downlink, state, gather(shard) if downlink is None else None, local)
        participate, weights = trainer.participation_weights(plan, draws, W, state["step"], shard.device)
        losses, grads = trainer.worker_grad_sum(cfg, spec, fwd_kw, rows, layout.local_batch(batch, split),
                                                lo, weights)
        # ---- uplink: this rank's slice of the aggregate ----------------------------
        if layout.padded > layout.d_local:
            grads = F.pad(grads, (0, layout.padded - layout.d_local))
        g = grads if tp and D == 1 else comm.reduce_scatter(grads.new_empty(layout.shard_len), grads, slice_axis)
        if participate is None:
            g.mul_(1.0 / (W * split))  # jnp.mean: XLA multiplies by the reciprocal
        elif split > 1:
            g.mul_(1.0 / split)
        scalars = torch.zeros(W + 1, device=shard.device)
        if not tp or m == 0:  # a worker's loss once: the M ranks of its data index hold the same
            scalars[lo:lo + local] = losses if split == 1 else losses / split
        scalars[W] = torch.sum(g * g) if not tp else torch.sum(g * g * layout.shard(counted_once(g.device)))
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
            x_new = whole(gather(shard_new)) if tp else gather(shard_new)
            workers_new, bits = downlink.round(draws, sizes, x_new, state["workers"], force_sync)
            drift = downlink.worker_drift(x_new, workers_new)
        elif downlink is not None:
            x_new = gather(shard_new)
            delta = None if (draws.coin or force_sync) else gather(shard_new - shard)
            workers_new, bits = downlink.round_rows(draws, sizes, x_new, delta, state["workers"], lo,
                                                    force_sync, layout.blocks)
            if tp:  # every rank its blocks of its rows, a replicated leaf counted by model index 0
                part = (((workers_new.float() - x_new.float()) ** 2) * counted_once(x_new.device)).sum()
            else:  # the M ranks of a data index hold the same rows: the first one counts them
                part = downlink.drift_sum(x_new, workers_new)
                part = part if m == 0 else torch.zeros_like(part)
            drift = comm.all_reduce(part.reshape(1))[0] / W
        if downlink is not None:
            trainer.add_downlink(state, new_state, metrics, workers_new, bits, drift)
        metrics["bits_per_worker"] = new_state["bits_per_worker"]
        return new_state, metrics

    return train_step
