"""The LM train step across a process group: MARINA-P / EF21-P's W workers
over the mesh's data axes, the server's fp32 master and optimizer moments
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

Under ``act_spec`` a config with experts routes each of a worker's M row
blocks at the worker's whole capacity, with each copy's global position
(``models/moe.split_rows``; the [E] counts all-gathered over "model"), so
the same copies drop as in the worker's single call.

The multi-pod mesh ("pod", "data", "model") runs the same program with the
data axes flattened, pod major (the reference's ``dp_axes_of`` /
``worker_axis_of``). The hierarchical mesh ("wk", "data", "model") puts
the workers on "wk" (W % wk == 0) and splits each worker's replica and
batch rows over its "data" ranks (the reference's ``worker`` layout there,
``_add_fsdp`` inside the group, and ``train_batch_spec``): a rank holds the
"data" block of each of its model-local blocks (:func:`fsdp_blocks`,
``d_rank`` values a row), gathers its worker's rows over "data" before the
forward (the whole model-local row at once: the reference's values, not
its leaf-by-leaf residency), scales its rows' gradient by 1/D (as
``act_spec`` does by 1/M; with experts, the capacity and copy order over
"data"), and runs the perm downlink on its own block of each leaf through
``rotk_apply_rows``' two-level block map; the server's ZeRO-1 slices lie
over the flattened ("wk", "data") group ("dp"), EF21-P's shift stays whole.

A column- or row-parallel weight that "model" does not split (the
reference's ``try_shard`` replicates it) is whole on every rank and counted
once: a layer whose output product it is runs alike on every rank, and a
product whose output only the rank's heads read sums its weight's gradient
over "model" (``serve/sharded.ServeShard``).
"""
from __future__ import annotations

import contextlib
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
from ..models import lm, moe
from ..models import params as P
from ..models.config import ModelConfig
from ..optim import Optimizer
from ..serve import sharded as SS
from . import trainer
from .downlink import DownlinkDraws, EF21PDownlink, LeafBlock

ACT_SPEC = Spec("model", None, None)


MESHES = (("data", "model"), ("pod", "data", "model"), ("wk", "data", "model"))


@dataclasses.dataclass(frozen=True)
class Layout:
    """Rank ``rank`` of ``mesh`` (:data:`MESHES`: the data axes, then
    "model"), its share of ``n_workers`` federated workers and of a flat
    state of ``d`` values. The data axes are one flattened axis of
    ``data_size`` indices (pod major); rank r is at (r // M, r % M). On the
    hierarchical mesh ("wk", "data", "model") the workers lie on "wk" and
    each worker's replica and batch rows split over "data" too (``fsdp``:
    the rank's "data" block of each leaf's model-local block)."""

    mesh: Mesh
    rank: int
    n_workers: int
    d: int
    blocks: Optional[tuple] = None  # tensor parallelism: the rank's LeafBlock of every leaf
    fsdp: Optional[tuple] = None  # hierarchical: the rank's "data" block of each of its model-local blocks
    row_blocks: Optional[tuple] = None  # hierarchical: each leaf's block of a replica row, in the leaf

    def __post_init__(self):
        if tuple(self.mesh.axis_names) not in MESHES:
            raise ValueError(f"the sharded step runs on a {' / '.join(map(str, MESHES))} mesh, not "
                             f"{self.mesh.axis_names}")
        if not 0 <= self.rank < self.mesh.size:
            raise ValueError(f"rank {self.rank} outside a mesh of {self.mesh.size}")
        if self.n_workers % self.worker_size:
            raise ValueError(f"{self.n_workers} workers do not split over "
                             f"{'wk' if self.hier else 'data'} = {self.worker_size}")
        if self.hier and (self.blocks is None or self.fsdp is None or self.row_blocks is None):
            raise ValueError("a hierarchical layout holds the rank's blocks over 'model' and 'data' "
                             "(make_layout(..., cfg=cfg))")

    @property
    def hier(self) -> bool:
        """The hierarchical mesh: workers on "wk", each replica FSDP over "data"."""
        return "wk" in self.mesh.axis_names

    @property
    def data_size(self) -> int:
        """Indices of the flattened data axes (("pod", "data") or ("wk", "data"))."""
        return self.mesh.size // self.model_size

    @property
    def fsdp_size(self) -> int:
        """Ranks a worker's replica and rows split over inside its group ("data" of the hierarchical mesh)."""
        return self.mesh.shape["data"] if self.hier else 1

    @property
    def worker_size(self) -> int:
        """Groups the workers split over: "wk", or the flattened data axes."""
        return self.data_size // self.fsdp_size

    @property
    def fsdp_index(self) -> int:
        return self.coords[0] % self.fsdp_size

    @property
    def slice_axis(self) -> str:
        """The communicator's name of the flattened data axes (:func:`connect`)."""
        return "dp" if self.hier else "data"

    @property
    def model_size(self) -> int:
        return self.mesh.shape["model"]

    @property
    def world(self) -> int:
        return self.mesh.size

    @property
    def coords(self) -> tuple:
        """(flattened data index, model index) of this rank."""
        return divmod(self.rank, self.model_size)

    @property
    def local(self) -> int:
        """Workers a rank holds."""
        return self.n_workers // self.worker_size

    @property
    def off(self) -> int:
        """Global id of this rank's first worker."""
        return self.coords[0] // self.fsdp_size * self.local

    @property
    def tp(self) -> bool:
        """The rank holds its blocks (tensor parallelism over "model", or the
        hierarchical mesh's), and the server's slices lie over the data axes."""
        return self.blocks is not None

    @property
    def d_local(self) -> int:
        """Values of the rank's model-local vector (d without blocks)."""
        return self.d if self.blocks is None else sum(b.size for b in self.blocks)

    @property
    def d_rank(self) -> int:
        """Values of a rank's replica row: d_local, or on the hierarchical mesh its "data" blocks of them."""
        return self.d_local if self.fsdp is None else sum(b.size for b in self.fsdp)

    @property
    def rank_blocks(self) -> Optional[tuple]:
        """The :class:`~.downlink.LeafBlock` of each leaf that a replica row
        holds (two levels where a leaf is cut over "data" and "model"), at
        its place in the row: the perm downlink's block map."""
        return self.blocks if self.fsdp is None else self.row_blocks

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
        return t if self.blocks is None else cut(t, self.blocks)

    def rank_local(self, t: torch.Tensor) -> torch.Tensor:
        """A replica row's values [..., d_rank] of ``t`` [..., d]."""
        return self.fsdp_local(self.model_local(t))

    def fsdp_local(self, t: torch.Tensor) -> torch.Tensor:
        """The rank's "data" blocks [..., d_rank] of a model-local ``t`` [..., d_local]."""
        return t if self.fsdp is None else cut(t, self.fsdp)

    def whole(self, parts: torch.Tensor) -> torch.Tensor:
        """[..., d] from every model index's model-local vector ``parts``
        [M, ..., d_local] (a replicated leaf from model index 0)."""
        return join(parts, self.blocks)

    def counted_once(self, device) -> torch.Tensor:
        """[d_local] weights summing each model-local coordinate once over
        "model": 1 in a split leaf's block, in a replicated leaf 1 at model
        index 0 and 0 elsewhere."""
        w = torch.ones(self.d_local, device=device)
        if self.coords[1]:
            for b in self.blocks:
                if b.whole:
                    w[b.lo:b.lo + b.size] = 0
        return w

    def row_counted_once(self, device) -> torch.Tensor:
        """[d_rank] weights summing each coordinate of a worker's replica
        once over its ranks: :meth:`counted_once`'s, and on the hierarchical
        mesh a leaf that "data" does not split counted at data index 0."""
        w = self.counted_once(device)
        if self.fsdp is None:
            return w
        w = cut(w, self.fsdp)
        if self.fsdp_index:
            for b in self.fsdp:
                if b.whole:
                    w[b.lo:b.lo + b.size] = 0
        return w

    def local_batch(self, batch: dict, split: int) -> dict:
        """This rank's rows of a global batch [W, B, ...]: its workers, and
        under ``act_spec`` (``split`` = M) its model index's B/M rows of
        each, on the hierarchical mesh (``split`` = its "data" size) its
        data index's."""
        m = self.fsdp_index if self.hier else self.coords[1]
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


def two_cut_block(shape, cuts, lo: int = 0) -> LeafBlock:
    """The block of a leaf of ``shape`` cut along each ``(dim, n, i)`` of
    ``cuts`` (dim None or n = 1: not cut) in n, index i: :func:`leaf_block`
    for one cut; for two, viewing the leaf as [P, s1, Q, s2, R] with s1 and
    s2 the cut dims, runs of s2/n2 * R values ``s2 * R`` apart, s1/n1 * Q of
    them a group, the P groups ``s1 * Q * s2 * R`` apart (the second level)."""
    cuts = sorted((dim % len(shape), n, i) for dim, n, i in cuts if dim is not None and n > 1)
    if len(cuts) < 2:
        return leaf_block(shape, *(cuts[0] if cuts else (None, 1, 0)), lo)
    (d1, n1, i1), (d2, n2, i2) = cuts
    P_, Q, R = math.prod(shape[:d1]), math.prod(shape[d1 + 1:d2]), math.prod(shape[d2 + 1:])
    s1, s2 = shape[d1], shape[d2]
    c1, c2 = s1 // n1, s2 // n2
    return LeafBlock(lo, P_ * c1 * Q * c2 * R, c2 * R, s2 * R, i1 * c1 * Q * s2 * R + i2 * c2 * R, c1 * Q,
                     s1 * Q * s2 * R)


def cut(t: torch.Tensor, blocks) -> torch.Tensor:
    """[..., sum of the blocks' sizes]: each block of ``blocks`` (in order)
    cut from its leaf of ``t`` [..., sum of the leaves' sizes]."""
    out, o = [], 0
    for b in blocks:
        s = b.leaf_size
        out.append(b.cut(t[..., o:o + s]))
        o += s
    return torch.cat(out, -1)


def join(parts: torch.Tensor, blocks) -> torch.Tensor:
    """The leaves [..., sum of their sizes] from the n ranks' blocks
    ``parts`` [n, ..., sum of the blocks' sizes], rank i holding block i of
    every leaf cut in n along one dim (a leaf not cut: from rank 0)."""
    n, out = parts.shape[0], []
    for b in blocks:
        p = parts[..., b.lo:b.lo + b.size]
        if b.whole:
            out.append(p[0])
            continue
        lead = p.shape[1:-1]
        p = p.reshape(n, *lead, -1, b.chunk).movedim(0, -2)  # [..., runs, n, chunk]
        out.append(p.reshape(*lead, -1))
    return torch.cat(out, -1)


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


def fsdp_blocks(cfg: ModelConfig, mesh: Mesh, rank: int) -> tuple:
    """(the "data" block of each of the rank's model-local blocks, each
    leaf's block of the rank's replica row in the whole leaf) on the
    hierarchical mesh ("wk", "data", "model"): the reference's ``worker``
    layout there FSDP-shards each leaf's replica over "data" on its largest
    dim that "model" leaves whole and "data" divides (``sharding._add_fsdp``
    on the ``tp`` spec), so a leaf cut on two dims has a two-level block."""
    tree = lm.lm_spec(cfg)
    specs = sh.spec_leaves(sh.param_specs(tree, mesh, "tp"))
    M, Dd = mesh.shape["model"], mesh.shape["data"]
    m, a = rank % M, rank // M % Dd
    inner, rows, lo = [], [], 0
    for leaf, (_, spec) in zip(P.leaves(tree), specs):
        shape = tuple(leaf.shape)
        fs = sh._add_fsdp(list(spec) + [None] * (len(shape) - len(spec)), shape, ("data",), Dd)
        dm = spec.index("model") if "model" in spec else None
        dd = fs.index("data") if "data" in fs else None
        local = [s // M if i == dm else s for i, s in enumerate(shape)]
        inner.append(leaf_block(local, dd, Dd, a, lo))
        rows.append(two_cut_block(shape, [(dm, M, m), (dd, Dd, a)], lo))
        lo += inner[-1].size
    return tuple(inner), tuple(rows)


def make_layout(mesh: Mesh, rank: int, n_workers: int, d: int, cfg: Optional[ModelConfig] = None) -> Layout:
    """Rank ``rank``'s :class:`Layout`: with ``cfg``, its blocks where
    "model" > 1 (tensor parallelism over "model") and on the hierarchical
    mesh (its blocks over "data" too, :func:`fsdp_blocks`); leave ``cfg``
    out for ``act_spec`` or data parallelism."""
    hier = "wk" in mesh.axis_names
    if hier and cfg is None:
        raise ValueError("the hierarchical mesh's layout holds the rank's blocks: make_layout(..., cfg=cfg)")
    tp = cfg is not None and (hier or mesh.shape["model"] > 1)
    blocks = model_blocks(cfg, mesh, rank) if tp else None
    fsdp, rows = fsdp_blocks(cfg, mesh, rank) if hier else (None, None)
    return Layout(mesh, rank, n_workers, d, blocks, fsdp, rows)


def connect(mesh: Mesh, n_workers: int, d: int, cfg: Optional[ModelConfig] = None) -> tuple:
    """(this rank's :class:`Layout` (:func:`make_layout`), a :class:`Comm`
    over the default process group and the mesh's groups), which must have
    ``mesh.size`` ranks: the ``DeviceMesh`` of the flattened data axes and
    "model" is built to check it, and gives this rank's coordinates and the
    groups "data" (the flattened data axes; on the hierarchical mesh "dp",
    and "wk" and "data" its own axes) and "model"."""
    rank = dist.get_rank()
    layout = make_layout(mesh, rank, n_workers, d, cfg)
    dm = Mesh(("data", "model"), (layout.data_size, layout.model_size)).device_mesh(device_type())
    if tuple(dm.get_coordinate()) != layout.coords:
        raise RuntimeError(f"rank {layout.rank}: DeviceMesh coordinate {dm.get_coordinate()} "
                           f"!= {layout.coords}")
    groups = mesh_groups(dm)
    if layout.hier:
        groups = dict(mesh_groups(mesh.device_mesh(device_type())), dp=groups["data"])
    return layout, Comm(groups)


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
        out["workers"] = w.clone() if rows is None else layout.rank_local(rows).clone()
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
        elif layout.hier:  # [wk, data, M, local, d_rank]: each worker's data blocks, then its model blocks
            g = gather(w).reshape(layout.worker_size, layout.fsdp_size, M, *w.shape).movedim(1, 0)
            out["workers"] = layout.whole(join(g, layout.fsdp).movedim(1, 0)).reshape(layout.n_workers, d)
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
    family whose serving step across ranks is ported. A product's weight
    that "model" does not split is whole on every rank, as the reference's
    ``try_shard`` leaves it: its product runs whole there, alike on every
    rank or entered into "model" where only the rank's heads read it
    (``serve/sharded.ServeShard``), and the leaf is counted once."""
    SS.check_ported(cfg, "the train step's tensor parallelism over 'model' (the reference's worker layout)")


def row_split(cfg: ModelConfig, tcfg, layout: Layout) -> int:
    """How many row blocks each worker's batch splits into: M under
    ``act_spec = Spec("model", None, None)``, the "data" size on the
    hierarchical mesh, else 1. Raises where the port has no counterpart of
    the reference's program."""
    M = layout.model_size
    if layout.hier:
        if tcfg.act_spec is not None:
            raise ValueError("act_spec on the hierarchical mesh is not ported: its workers' rows split over "
                             "'data' there")
        if M > 1:
            check_tensor_parallel(cfg, layout)
        return layout.fsdp_size
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
    if tp and layout.model_size > 1:
        fwd_kw["tp"] = SS.ServeShard(cfg, SS.ServeLayout(layout.mesh, layout.rank, "tp"), comm)
    plan = trainer.participation_plan(tcfg)
    lo, local, D, m = layout.off, layout.local, layout.data_size, layout.coords[1]
    slice_axis = layout.slice_axis if tp else None  # the server's slices lie over it
    # a worker's rows split over "model" (act_spec) or over "data" (the hierarchical mesh)
    row_axis, row_index = ("data", layout.fsdp_index) if layout.hier else ("model", m)
    once = {}  # (device, rows) -> the coordinates' weights (each counted once over the worker's ranks)

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

    def counted_once(device, rows=False):
        """[d_local] (a slice's coordinates), or with ``rows`` [d_rank] (a replica
        row's: the same vector but on the hierarchical mesh)."""
        key = (device, rows and layout.hier)
        if key not in once:
            once[key] = layout.row_counted_once(device) if key[1] else layout.counted_once(device)
        return once[key]

    def replicas(w):
        """[local, d_local] from the rows' "data" blocks [local, d_rank] (the
        hierarchical mesh: one all-gather over "data", bit copies)."""
        Dd = layout.fsdp_size
        if Dd == 1:
            return w
        bits = w.reshape(-1).view(torch.uint8)  # gloo moves no 16-bit integers: the bytes
        parts = bits.new_empty(Dd * bits.numel())
        comm.all_gather(parts, bits, "data")
        return join(parts.view(w.dtype).reshape(Dd, *w.shape), layout.fsdp)

    def copies_before(counts):
        """[E]: each expert's routed copies on the lower indices of the axis
        a worker's rows split over (in order): one int32 all-gather of the
        [E] counts over it."""
        every = torch.empty(split, counts.shape[0], dtype=torch.int32, device=counts.device)
        comm.all_gather(every, counts.to(torch.int32)[None].contiguous(), row_axis)
        return every[:row_index].sum(0)

    # a worker's rows split: an moe call is one of its row blocks, at the worker's capacity and copy order
    routed = (lambda: moe.split_rows(split, copies_before)) if split > 1 and cfg.moe else contextlib.nullcontext

    def train_step(state, batch, draws: Optional[DownlinkDraws] = None, force_sync=False):
        draws = draws if draws is not None else DownlinkDraws()
        shard = state["server"]
        # ---- workers: forward/backward on their own replica -------------------
        if tp and isinstance(downlink, EF21PDownlink):
            rows = [layout.model_local(state["workers"])] * local  # the shift's blocks
        elif layout.hier and downlink is not None:
            rows = list(replicas(state["workers"]))
        else:
            rows = trainer.replica_rows(downlink, state, gather(shard) if downlink is None else None, local)
        participate, weights = trainer.participation_weights(plan, draws, W, state["step"], shard.device)
        with routed():
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
            x_new = layout.fsdp_local(gather(shard_new))
            delta = None if (draws.coin or force_sync) else layout.fsdp_local(gather(shard_new - shard))
            workers_new, bits = downlink.round_rows(draws, sizes, x_new, delta, state["workers"], lo,
                                                    force_sync, layout.rank_blocks)
            if tp:  # every rank its blocks of its rows, a leaf it shares counted by one of its holders
                part = (((workers_new.float() - x_new.float()) ** 2) * counted_once(x_new.device, True)).sum()
            else:  # the M ranks of a data index hold the same rows: the first one counts them
                part = downlink.drift_sum(x_new, workers_new)
                part = part if m == 0 else torch.zeros_like(part)
            drift = comm.all_reduce(part.reshape(1))[0] / W
        if downlink is not None:
            trainer.add_downlink(state, new_state, metrics, workers_new, bits, drift)
        metrics["bits_per_worker"] = new_state["bits_per_worker"]
        return new_state, metrics

    return train_step
