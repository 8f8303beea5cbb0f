"""The serving step across a process group: prefill and decode as SPMD ranks
of a ("data", "model") mesh under the reference's ``serve``, ``tp`` and
``tp_attn_rep`` parameter layouts (the counterpart of the reference's
``jax.jit(lm.forward / lm.decode_step, in_shardings=...)`` over
``launch/specs.build``'s serving specs).

:class:`ServeLayout`: rank r of a mesh of D x M ranks sits at (r // M,
r % M); its data index runs over the mesh's data axes ("data", or ("pod",
"data") / ("wk", "data") flattened, which the count on ``meta`` takes;
:func:`connect` builds the groups of a ("data", "model") mesh).

* Parameters: :func:`shard_params` cuts every leaf to the rank's block of
  ``sharding.param_specs(lm_spec(cfg), mesh, serve_layout)``, exactly where
  the spec puts it: "model" on a column- or row-split dim, and under
  ``serve`` the data axes on the dim its FSDP picks (stacked scan segments
  included). The blocks' fp32 masters and bf16 copy form a
  :class:`ShardedParams`, whose dict nodes carry their leaves' specs.
  :func:`gather_params` undoes it.
* The batch: the rank's rows over "data" (``sharding.serve_batch_spec``;
  pixtral's patches follow their rows), all of it where B does not split.
* Caches (:func:`shard_caches`): over "data" as ``sharding.cache_specs``
  places them, the rank's batch rows or, where the batch does not split
  (long_500k at B = 1), its slice of every ring's slots (``seq_split``); over
  "model", the kv heads the rank attends with: its share where
  num_kv_heads % M == 0, else all of them.

The step (:func:`make_prefill_step`, :func:`make_decode_step`) is
``lm.forward`` / ``lm.decode_step`` with the rank's :class:`ServeShard` as
the layers' shard context (``models/layers.py``): each weight gathered over
"data" just before its product (ZeRO-3; ``tp`` and ``tp_attn_rep`` gather
nothing) and dropped after it; ``wq`` / ``wk`` / ``wv`` / ``w_in`` /
``w_gate`` column-parallel and ``wo`` / ``w_out`` row-parallel over "model",
a row-parallel partial summed over "model" in fp32 and rounded to bf16 once,
as ``params.mm`` rounds the single product; attention on the rank's q heads,
with ``wq`` / ``wk`` / ``wv`` gathered over "model" where the split cuts
through a head; the embedding's rows over "model"; the logits' vocabulary
block as the result. An axis of one rank runs no collective (at M = 1 a
product is whole and rounds once, as ``params.mm`` does; at D = 1 a weight is
read where it lies), so at one rank the step is ``lm.forward`` /
``lm.decode_step`` bit for bit, the same kernels on the same operands. Every
collective goes through a :class:`~repro_torch.launch.comm.Comm` (a
``CountingComm`` on ``meta``).

Ported: the dense, vlm and audio families. Refused: moe (experts over
"model" on E; deepseek-v2's MLA), ssm (rwkv6) and hybrid (zamba2).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from ..launch import sharding as sh
from ..launch.comm import Comm, device_type, mesh_groups
from ..launch.mesh import Mesh
from ..models import layers as L
from ..models import lm
from ..models.config import ModelConfig
from ..models.params import FlatParams, Leaf, leaves, mm, mm_f32, weight

PORTED_FAMILIES = ("dense", "vlm", "audio")
# what each family that is refused would need
NOT_PORTED = {"moe": "experts over 'model' on E, and deepseek-v2's MLA", "ssm": "rwkv6's recurrent blocks",
              "hybrid": "zamba2's state-space blocks beside its shared attention"}


class NotPorted(ValueError):
    """A serving step across ranks that the port does not have; the message
    says what is missing."""


def check_ported(cfg: ModelConfig) -> None:
    """Raise :class:`NotPorted` unless ``cfg``'s family is one the sharded
    serving step ports."""
    if (cfg.family not in PORTED_FAMILIES or cfg.mla is not None or cfg.moe is not None
            or not set(cfg.block_pattern) <= {"attn", "attn_local"}):
        raise NotPorted(f"{cfg.arch_id} ({cfg.family}): serving across a process group is not ported for the "
                        f"{cfg.family} family ({NOT_PORTED.get(cfg.family, 'blocks other than attention')}); "
                        f"it is for {', '.join(PORTED_FAMILIES)}")


@dataclasses.dataclass(frozen=True)
class ServeLayout:
    """Rank ``rank`` of ``mesh`` (data axes, then "model") serving under
    ``serve_layout``."""

    mesh: Mesh
    rank: int
    serve_layout: str = "serve"

    def __post_init__(self):
        names = tuple(self.mesh.axis_names)
        if names[-1:] != ("model",) or names[:-1] != sh.dp_axes_of(self.mesh):
            raise NotPorted(f"the sharded serving step runs on a (data axes, 'model') mesh, not {names}")
        if self.serve_layout not in ("serve", "tp", "tp_attn_rep"):
            raise ValueError(f"serve layout {self.serve_layout!r} not in serve / tp / tp_attn_rep")
        if not 0 <= self.rank < self.mesh.size:
            raise ValueError(f"rank {self.rank} outside a mesh of {self.mesh.size}")

    @property
    def model_size(self) -> int:
        return self.mesh.shape["model"]

    @property
    def data_size(self) -> int:
        return self.mesh.size // self.model_size

    @property
    def coords(self) -> tuple:
        """(data index, model index) of this rank."""
        return divmod(self.rank, self.model_size)

    def axis(self, entry) -> str:
        """"model" or "data" for a spec entry (the data axes, one or a tuple)."""
        if entry == "model":
            return "model"
        dp = sh.dp_axes_of(self.mesh)
        if entry in (dp, dp[0] if len(dp) == 1 else None):
            return "data"
        raise ValueError(f"spec entry {entry!r} is neither 'model' nor the data axes {dp}")

    def size(self, axis: str) -> int:
        return self.model_size if axis == "model" else self.data_size

    def index(self, axis: str) -> int:
        return self.coords[1] if axis == "model" else self.coords[0]

    def param_specs(self, tree):
        return sh.param_specs(tree, self.mesh, self.serve_layout)

    def block(self, t: torch.Tensor, spec) -> torch.Tensor:
        """This rank's block of ``t`` under ``spec`` (a view)."""
        for dim, entry in enumerate(spec):
            if entry is not None:
                ax = self.axis(entry)
                n = t.shape[dim] // self.size(ax)
                t = t.narrow(dim, self.index(ax) * n, n)
        return t

    def local_batch(self, batch: dict) -> dict:
        """This rank's rows of a global serving batch (``serve_batch_spec``)."""
        B = next(iter(batch.values())).shape[0]
        specs = sh.serve_batch_spec(batch, self.mesh, B)
        return {k: self.block(v, specs[k]) for k, v in batch.items()}


def gather_dim(comm: Comm, layout: ServeLayout, t: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
    """The blocks of ``t`` along ``dim`` of every rank of ``axis``, in
    order: one all-gather (of the tensor with ``dim`` moved first), laid out
    contiguous; ``t`` itself on an axis of one rank."""
    if layout.size(axis) == 1:
        return t
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((layout.size(axis) * x.shape[0],) + tuple(x.shape[1:]))
    comm.all_gather(out, x, axis)
    return out.movedim(0, dim).contiguous() if dim else out


def _map_spec(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree of tensors or ``Leaf``s and its spec tree."""
    if isinstance(tree, dict):
        return {k: _map_spec(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_spec(fn, v, specs[i]) for i, v in enumerate(tree)]
    return fn(tree, specs)


def attention_heads(cfg: ModelConfig, layout: ServeLayout) -> L.Heads:
    """The q and kv heads this rank computes (every attention layer has the
    same): its share where its "model" block of wq (wk) columns is a whole
    number of heads; all of them, the weight gathered over "model", where the
    block cuts through a head; all of them where the layout does not split
    the weight."""
    specs = layout.param_specs({"wq": Leaf((cfg.d_model, cfg.q_dim)), "wk": Leaf((cfg.d_model, cfg.kv_dim))})
    M, m = layout.model_size, layout.coords[1]

    def one(name, n):
        if specs[name][-1] != "model" or M == 1:
            return 0, n, False
        if n % M == 0:
            return m * (n // M), n // M, False
        return 0, n, True

    q0, nq, qw = one("wq", cfg.num_heads)
    kv0, nkv, kvw = one("wk", cfg.num_kv_heads)
    if nq == cfg.num_heads and nkv < cfg.num_kv_heads:
        raise ValueError(f"{cfg.arch_id}: every q head with a share of the kv heads (layout {layout.serve_layout})")
    return L.Heads(q0, nq, kv0, nkv, qw, kvw)


class ServeShard:
    """The shard context the layers take (``tp``) on one rank: the layout,
    the communicator, the rank's heads, and whether its caches hold a slice
    of every ring's slots (``seq_split``)."""

    def __init__(self, cfg: ModelConfig, layout: ServeLayout, comm: Comm, *, seq_split: bool = False):
        check_ported(cfg)
        self.layout, self.comm, self.seq_split = layout, comm, seq_split
        self.data_index, self.model_index = layout.coords
        self.data_size, self.model_size = layout.data_size, layout.model_size
        self.heads = attention_heads(cfg, layout)

    def weight(self, p, name: str, dtype, whole: bool = False) -> torch.Tensor:
        """``p[name]`` in ``dtype`` (the bf16 copy), gathered over "data"
        where the layout splits it there, and over "model" too if ``whole``."""
        w = weight(p, name, dtype)
        for dim, entry in enumerate(p.specs[name]):
            ax = None if entry is None else self.layout.axis(entry)
            if ax == "data" or (ax == "model" and whole):
                w = gather_dim(self.comm, self.layout, w, dim, ax)
        return w

    def model_block(self, p, name: str, dim: int) -> Optional[tuple]:
        """(first index, count) of the rank's block of ``p[name]`` along
        ``dim`` where it is split over "model" and M > 1, else None."""
        spec = p.specs[name]
        dim %= p[name].dim()
        if dim >= len(spec) or spec[dim] != "model" or self.model_size == 1:
            return None
        n = p[name].shape[dim]
        return self.model_index * n, n

    def row_mm(self, x: torch.Tensor, p, name: str) -> torch.Tensor:
        """``x @ p[name]``: where the weight's rows are split over "model",
        the rank's fp32 partial over its rows (of ``x``'s columns, taking
        its block of them if ``x`` is whole), summed over "model" and
        rounded to bf16 once."""
        w = self.weight(p, name, x.dtype)
        blk = self.model_block(p, name, -2)
        if blk is None:
            return mm(x, w)
        if x.shape[-1] != blk[1]:
            x = x[..., blk[0]:blk[0] + blk[1]]
        return self.all_reduce(mm_f32(x, w), "model").to(x.dtype)

    def all_reduce(self, t: torch.Tensor, axis: str, op: str = "sum") -> torch.Tensor:
        return self.comm.all_reduce(t, axis, op)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def _attach_specs(node, specs) -> None:
    if isinstance(node, dict):
        node.specs = {k: specs[k] for k, v in node.items() if not isinstance(v, (dict, list))}
        for k, v in node.items():
            _attach_specs(v, specs[k])
    elif isinstance(node, list):
        for v, s in zip(node, specs):
            _attach_specs(v, s)


class ShardedParams(FlatParams):
    """A rank's blocks of a model's parameters: a :class:`FlatParams` of the
    blocks' shapes (fp32 masters and their bf16 copy) whose dict nodes carry
    their leaves' partition specs (``specs``), with the whole model's
    shapes (``global_spec``)."""

    def __init__(self, spec, specs, global_spec, device):
        object.__setattr__(self, "specs", specs)
        object.__setattr__(self, "global_spec", global_spec)
        super().__init__(spec, device)

    def _rebuild(self) -> None:
        super()._rebuild()
        _attach_specs(self.tree, self.specs)


def shard_params(params: FlatParams, layout: ServeLayout) -> ShardedParams:
    """This rank's blocks of ``params`` under ``layout``'s parameter specs."""
    specs = layout.param_specs(params.spec)

    def local(leaf, spec):
        shape = list(leaf.shape)
        for dim, entry in enumerate(spec):
            if entry is not None:
                shape[dim] //= layout.size(layout.axis(entry))
        return Leaf(tuple(shape), leaf.init, leaf.scale)

    out = ShardedParams(_map_spec(local, params.spec, specs), specs, params.spec, params.device)
    with torch.no_grad():
        _map_spec(lambda pair, spec: pair[1].copy_(layout.block(pair[0], spec)),
                  _zip(params.tree, out.tree), specs)
    return out.refresh()


def _zip(a, b):
    if isinstance(a, dict):
        return {k: _zip(v, b[k]) for k, v in a.items()}
    if isinstance(a, list):
        return [_zip(v, b[i]) for i, v in enumerate(a)]
    return (a, b)


def gather_params(local: ShardedParams, layout: ServeLayout, comm: Comm) -> FlatParams:
    """The whole model's parameters from every rank's :func:`shard_params`
    blocks, on every rank (every rank must call it)."""
    out = FlatParams(local.global_spec, local.device)

    def one(pair, spec):
        t = pair[0]
        for dim, entry in enumerate(spec):
            if entry is not None:
                t = gather_dim(comm, layout, t, dim, layout.axis(entry))
        pair[1].copy_(t)

    with torch.no_grad():
        _map_spec(one, _zip(local.tree, out.tree), local.specs)
    return out.refresh()


def param_numel(layout: ServeLayout, spec_tree) -> int:
    """Values a device holds under the layout's specs (``local_numel``)."""
    specs = sh.spec_leaves(layout.param_specs(spec_tree))
    return sum(sh.local_numel(leaf.shape, s, layout.mesh) for leaf, (_, s) in zip(leaves(spec_tree), specs))


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def cache_layout(cfg: ModelConfig, layout: ServeLayout, batch: int, cache_len: int, *,
                 window_override=None) -> tuple:
    """:func:`cache_split` of the model's caches for ``batch`` sequences of
    ``cache_len`` positions."""
    return cache_split(lm.cache_init(cfg, batch, cache_len, window_override=window_override, device="meta"),
                       layout)


def cache_split(caches, layout: ServeLayout) -> tuple:
    """(``cache_specs`` of a tree of caches [.., B, L, KV, hd], ``seq_split``:
    whether they split the rings' slots over "data", else the batch or
    nothing). Raises where they split another dim over more than one rank
    (the head dim, where a ring is shorter than a head; a scan segment's
    repetitions, where their count equals B and ``cache_specs`` takes it for
    the batch), or the layers differently."""
    specs = sh.cache_specs(caches, layout.mesh, leaves(caches)[0].shape[-4])
    kinds = set()

    def one(t, spec):
        split = [i for i, e in enumerate(spec) if e is not None and layout.size(layout.axis(e)) > 1]
        where = {(t.dim() - 4,): "batch", (t.dim() - 3,): "seq", (): None}.get(tuple(split), "other")
        if where == "other":
            raise NotPorted(f"cache_specs splits a cache of shape {tuple(t.shape)} as {spec}: only its batch "
                             "or its sequence over the data axes is ported")
        kinds.add(where)

    _map_spec(one, caches, specs)
    if len(kinds) > 1:
        raise NotPorted(f"cache_specs splits the layers' caches differently ({sorted(map(str, kinds))})")
    return specs, kinds == {"seq"}


def shard_caches(caches, cfg: ModelConfig, layout: ServeLayout):
    """This rank's blocks (copies) of the model's caches (``lm.cache_init``'s
    tree): over "data" as ``cache_specs`` places them, over "model" the
    rank's kv heads."""
    specs, _ = cache_split(caches, layout)
    hs = attention_heads(cfg, layout)

    def one(t, spec):
        t = layout.block(t, spec)
        if hs.nkv != t.shape[-2]:
            t = t.narrow(t.dim() - 2, hs.kv0, hs.nkv)
        return t.clone()

    return _map_spec(one, caches, specs)


def cache_bytes(layout: ServeLayout, caches) -> int:
    """Bytes a device holds of a model's caches (``lm.cache_init``'s tree)
    under the reference's ``cache_specs``."""
    B = leaves(caches)[0].shape[-4]
    specs = sh.spec_leaves(sh.cache_specs(caches, layout.mesh, B))
    return sum(sh.local_numel(t.shape, s, layout.mesh) * t.element_size()
               for t, (_, s) in zip(leaves(caches), specs))


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------


def make_prefill_step(cfg: ModelConfig, layout: ServeLayout, comm: Comm, *, chunk: int = 512,
                      window_override=None):
    """``prefill(params, batch) -> logits``: ``params`` the rank's
    :func:`shard_params`, ``batch`` the global batch (the rank takes its
    rows); the logits are the rank's block ``[B_local, (K,) S, V / M]``."""
    tp = ServeShard(cfg, layout, comm)

    def prefill(params, batch):
        with torch.no_grad():
            return lm.forward(cfg, params, layout.local_batch(batch), chunk=chunk,
                              window_override=window_override, remat=False, tp=tp)

    return prefill


def make_decode_step(cfg: ModelConfig, layout: ServeLayout, comm: Comm, batch: int, cache_len: int, *,
                     window_override=None):
    """``decode(params, caches, token, pos) -> (logits, caches)``:
    ``caches`` the rank's :func:`shard_caches` of ``batch`` x ``cache_len``,
    ``token`` the global [B, 1] (or [B, K, 1]) tokens, ``pos`` an int or a
    0-d tensor; the logits are the rank's block ``[B_local, (K,) V / M]``."""
    check_ported(cfg)
    _, seq_split = cache_layout(cfg, layout, batch, cache_len, window_override=window_override)
    tp = ServeShard(cfg, layout, comm, seq_split=seq_split)

    def decode(params, caches, token, pos):
        with torch.no_grad():
            return lm.decode_step(cfg, params, caches, layout.local_batch({"t": token})["t"], pos,
                                  window_override=window_override, tp=tp)

    return decode


def greedy(logits: torch.Tensor, layout: ServeLayout, comm: Comm, vocab: int) -> torch.Tensor:
    """The global argmax token of each row of the rank's logits block
    (``[..., V / M]``, or whole): the rank's (max, index) pair, the max
    all-reduced over "model", then the least index among the ranks that
    hold it (``torch.argmax``'s first maximum)."""
    idx = logits.argmax(-1)
    if logits.shape[-1] == vocab:
        return idx
    val = logits.gather(-1, idx[..., None])[..., 0].float()
    best = comm.all_reduce(val.clone(), "model", "max")
    cand = torch.where(val == best, idx + layout.coords[1] * logits.shape[-1], vocab)
    return comm.all_reduce(cand, "model", "min")


def connect(mesh: Mesh, serve_layout: str = "serve") -> tuple:
    """(this rank's :class:`ServeLayout`, a :class:`Comm` over the mesh's
    "data" and "model" groups) inside a process group of ``mesh.size``
    ranks; ``mesh`` must be ("data", "model")."""
    if tuple(mesh.axis_names) != ("data", "model"):
        raise ValueError(f"connect builds the groups of a ('data', 'model') mesh, not {mesh.axis_names}")
    dm = mesh.device_mesh(device_type())
    layout = ServeLayout(mesh, dist.get_rank(), serve_layout)
    if tuple(dm.get_coordinate()) != layout.coords:
        raise RuntimeError(f"rank {layout.rank}: DeviceMesh coordinate {dm.get_coordinate()} != {layout.coords}")
    return layout, Comm(mesh_groups(dm))


def param_bytes(layout: ServeLayout, spec_tree) -> dict:
    """Per-device parameter bytes: the port's (its blocks' fp32 masters and
    bf16 copy) and the reference's (bf16 serving parameters) under the same
    specs; both hold ``param_numel`` values."""
    n = param_numel(layout, spec_tree)
    return {"port": 6 * n, "param_specs": 2 * n}

