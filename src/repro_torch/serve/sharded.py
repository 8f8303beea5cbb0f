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
* Caches (:func:`shard_caches`): over "data" exactly as
  ``sharding.cache_specs`` places them (:func:`cache_split` names each
  leaf's split): the rank's batch rows (``batch``); where the batch does not
  split (long_500k at B = 1), its slice of a ring's slots (``seq``); or its
  block of any other dim that ``cache_specs`` falls back to (``other``: the
  recurrent states' v / hd, a token shift's D, the conv window's C, a ring's
  head dim where the ring is shorter than a head, a scan segment's
  repetitions where their count equals B). Over "model", the kv heads the
  rank attends with: its share where num_kv_heads % M == 0, else all of
  them. MLA's caches hold the latent ([.., B, L, r] and [.., B, L, rd]),
  whole on every "model" rank. The recurrent states (RWKV-6's ``state``
  [.., B, H, k, v], Mamba2's ``ssm`` [.., B, H, N, hd]) hold the rank's heads
  (:func:`recurrent_heads`); the token shifts ``x_last`` / ``cm_x_last``
  [.., B, D] and Mamba2's ``conv`` window [.., B, W-1, C] are whole over
  "model". Each leaf's batch dim comes from its name (:data:`BATCH_DIM`):
  zamba2 mixes the kinds in one tree. The decode step all-gathers each
  ``other`` leaf over the data axes before it reads it (bit copies; the
  rank's rows of it where the batch splits too) and keeps only its block of
  what it wrote (:func:`make_decode_step`).

The step (:func:`make_prefill_step`, :func:`make_decode_step`) is
``lm.forward`` / ``lm.decode_step`` with the rank's :class:`ServeShard` as
the layers' shard context (``models/layers.py``): each weight gathered over
"data" just before its product (ZeRO-3; ``tp`` and ``tp_attn_rep`` gather
nothing) and dropped after it; ``wq`` / ``wk`` / ``wv`` / ``w_in`` /
``w_gate`` column-parallel and ``wo`` / ``w_out`` row-parallel over "model",
a row-parallel partial summed over "model" in fp32 and rounded to bf16 once,
as ``params.mm`` rounds the single product; attention on the rank's q heads,
with ``wq`` / ``wk`` / ``wv`` gathered over "model" where the split cuts
through a head (MLA: ``wq`` / ``w_uk`` / ``w_uv`` on the rank's heads where
M divides H, else whole; its latent's ``w_dkv`` / ``w_krope`` whole); the
routed experts over "model" on E at the call's global capacity, summed
exactly over "model" (``models/moe.py``); RWKV-6's and Mamba2's recurrences
on the rank's heads (``models/ssm.py``); the embedding's rows over "model";
the logits' vocabulary block as the result. An axis of one rank runs no
collective (at M = 1 a product is whole and rounds once, as ``params.mm``
does; at D = 1 a weight is read where it lies), so at one rank the step is
``lm.forward`` / ``lm.decode_step`` bit for bit, the same kernels on the
same operands. Every collective goes through a
:class:`~repro_torch.launch.comm.Comm` (a ``CountingComm`` on ``meta``).

Ported: the dense, vlm, audio, moe, ssm (rwkv6) and hybrid (zamba2)
families, with every cache split that ``cache_specs`` makes.

:func:`init_params` draws the rank's blocks of ``lm.lm_init(seed=...)``
leaf by leaf, so a rank of a model that no card holds whole needs only its
blocks and one whole leaf at a time.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from ..launch import sharding as sh
from ..launch import comm as C
from ..launch.comm import Comm, device_type, mesh_groups
from ..launch.mesh import Mesh
from ..models import layers as L
from ..models import lm
from ..models import ssm as SSM
from ..models.config import ModelConfig
from ..kernels.runtime import resolve_device
from ..models.params import (FlatParams, Leaf, draw, grad_tree, leaves, leaves_with_path, mm, mm_f32,
                             shape_tree, weight)

PORTED_FAMILIES = ("dense", "vlm", "audio", "moe", "ssm", "hybrid")
PORTED_BLOCKS = {"attn", "attn_local", "moe", "rwkv", "mamba", "shared"}
# what each family that is refused would need (none is)
NOT_PORTED: dict = {}


class NotPorted(ValueError):
    """A serving step across ranks that the port does not have; the message
    says what is missing."""


def check_ported(cfg: ModelConfig, what: str = "serving across a process group") -> None:
    """Raise :class:`NotPorted` unless ``cfg``'s family is one the sharded
    steps port (``what``: the step named in the message)."""
    if cfg.family not in PORTED_FAMILIES or not set(cfg.block_pattern) <= PORTED_BLOCKS:
        lacks = NOT_PORTED.get(cfg.family, "blocks other than " + ", ".join(sorted(PORTED_BLOCKS)))
        raise NotPorted(f"{cfg.arch_id} ({cfg.family}): {what} is not ported for the {cfg.family} family "
                        f"({lacks}); it is for {', '.join(PORTED_FAMILIES)}")


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

    def rows_split(self, batch: int) -> int:
        """How many data ranks a global batch of ``batch`` rows splits over
        (``serve_batch_spec``): all of them, or 1 (every rank all rows)."""
        D = self.data_size
        return D if batch % D == 0 and batch >= D else 1

    def local_batch(self, batch: dict) -> dict:
        """This rank's rows of a global serving batch (``serve_batch_spec``)."""
        B = next(iter(batch.values())).shape[0]
        specs = sh.serve_batch_spec(batch, self.mesh, B)
        return {k: self.block(v, specs[k]) for k, v in batch.items()}


def gather_dim(comm: Comm, layout: ServeLayout, t: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
    """The blocks of ``t`` along ``dim`` of every rank of ``axis``, in
    order: one all-gather (of the tensor with ``dim`` moved first), laid out
    contiguous, with a reduce-scatter backward under autograd
    (``launch/comm.gather``); ``t`` itself on an axis of one rank."""
    if layout.size(axis) == 1:
        return t
    return C.gather(comm, t, dim, layout.size(axis), axis)


def _map_leaves(fn, tree, specs=None, path: tuple = ()):
    """``fn(path, leaf, spec)`` over a tree (dicts and lists of tensors,
    ``Leaf``s or pairs) and its spec tree (or None: every spec None)."""
    pick = (lambda k: None) if specs is None else specs.__getitem__
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, pick(k), path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_leaves(fn, v, pick(i), path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree, specs)


def _map_spec(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree and its spec tree."""
    return _map_leaves(lambda _, leaf, spec: fn(leaf, spec), tree, specs)


def attention_heads(cfg: ModelConfig, layout: ServeLayout) -> L.Heads:
    """The q and kv heads this rank computes (every attention layer has the
    same): its share where its "model" block of wq (wk) columns is a whole
    number of heads; all of them, the weight gathered over "model", where the
    block cuts through a head; all of them where the layout does not split
    the weight. MLA (no kv heads: ``nkv`` 0, the cache holds the latent):
    the rank's H / M q heads where M divides H and the layout splits ``wq``
    (then ``w_uk``, ``w_uv`` and ``wo``'s rows split by whole heads too),
    else all H, ``wq`` / ``w_uk`` / ``w_uv`` read whole."""
    M, m = layout.model_size, layout.coords[1]
    if cfg.mla is not None:
        qd = cfg.num_heads * (cfg.mla.nope_head_dim + cfg.mla.rope_head_dim)
        split = layout.param_specs({"wq": Leaf((cfg.d_model, qd))})["wq"][-1] == "model" and M > 1
        if split and cfg.num_heads % M == 0:
            n = cfg.num_heads // M
            return L.Heads(m * n, n, 0, 0)
        return L.Heads(0, cfg.num_heads, 0, 0, split, False)
    specs = layout.param_specs({"wq": Leaf((cfg.d_model, cfg.q_dim)), "wk": Leaf((cfg.d_model, cfg.kv_dim))})

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


def recurrent_heads(cfg: ModelConfig, layout: ServeLayout) -> Optional[SSM.Heads]:
    """The recurrent heads this rank computes (RWKV-6: H = D / head_dim;
    Mamba2: H = d_inner / head_dim; None for a model with neither): its
    H / M where its "model" block of ``w_r``'s columns (RWKV-6) or of
    ``out_proj``'s rows (Mamba2) is a whole number of heads; all of them,
    the head-split weights gathered over "model", where the block cuts
    through a head; all of them where the layout does not split it."""
    D = cfg.d_model
    if cfg.rwkv is not None:
        H, name, shape, dim = D // cfg.rwkv.head_dim, "w_r", (D, D), -1
    elif cfg.mamba is not None:
        d_inner = cfg.mamba.expand * D
        H, name, shape, dim = d_inner // cfg.mamba.head_dim, "out_proj", (d_inner, D), -2
    else:
        return None
    M, m = layout.model_size, layout.coords[1]
    if layout.param_specs({name: Leaf(shape)})[name][dim] != "model" or M == 1:
        return SSM.Heads(0, H)
    if H % M == 0:
        return SSM.Heads(m * (H // M), H // M)
    return SSM.Heads(0, H, True)


class _ColMm(torch.autograd.Function):
    """``mm(x, w)`` of an fp32 ``xf`` that holds bf16 values: the rank's
    column-parallel product, whose gradient dy @ wᵀ it returns in fp32,
    unrounded, so that the rank's products' partials and then the ranks'
    are summed before the one rounding to bf16 (:meth:`ServeShard.col_mm`)."""

    @staticmethod
    def forward(ctx, xf, w):
        x = xf.to(w.dtype)
        ctx.save_for_backward(x, w)
        return mm(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dw = mm(x.reshape(-1, x.shape[-1]).t(), dy.reshape(-1, dy.shape[-1]))
        return mm_f32(dy, w.t()), dw


class _RowMm(torch.autograd.Function):
    """``mm_f32(x, w)``: the rank's fp32 row-parallel partial product, whose
    gradients are the single product's (dy rounded to bf16 as the single
    product's is; dx and dw rounded once)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return mm_f32(x, w)

    @staticmethod
    def backward(ctx, dyf):
        x, w = ctx.saved_tensors
        dy = dyf.to(x.dtype)
        return mm(dy, w.t()), mm(x.reshape(-1, x.shape[-1]).t(), dy.reshape(-1, dy.shape[-1]))


class ServeShard:
    """The shard context the layers take (``tp``) on one rank: the layout,
    the communicator, the rank's heads, and the cache length of its decode
    step (``cache_len``: a ring shorter than the layer's is the rank's slice
    of its slots, :meth:`ring_split`).

    The same context serves training (``train/sharded.py``'s tensor
    parallelism over "model", under the ``tp`` layout): under autograd its
    collectives are ``launch/comm``'s, one backward per kind of use, and
    :meth:`grad_tree` gives the rank's blocks as a tree to differentiate:

    * :meth:`col_mm` enters "model" (``enter``: the gradient summed) before
      the column-parallel products of every layer; :meth:`enter` does the
      same for moe's routed tokens, which only the rank's experts read
      (``models/moe.py``; the shared expert enters in its own ``col_mm``);
    * :meth:`weight` with ``part``: a replicated weight the rank reads in
      part (``enter``): RWKV-6's ``w0``, ``u`` and per-head ``out_norm``
      scale, Mamba2's ``A_log``, ``dt_bias``, ``D``, ``conv_b`` and gated
      norm scale (``models/ssm.py``), MLA's ``kv_norm`` scale
      (``models/layers.py``); a column-parallel product's weight that
      "model" does not split enters too (its output feeds only the rank's
      heads: MQA's ``wk`` / ``wv``, Mamba2's ``in_proj`` and ``conv_w``,
      RWKV-6's ``w_lora_a``, MLA's ``w_dkv`` / ``w_krope``);
    * :meth:`row_mm` and :meth:`all_reduce` (``exit``: the gradient as it
      is) after a row-parallel partial, the embedding's lookup and moe's
      combine; :meth:`all_reduce` with ``part`` (``exit_enter``: the
      gradient summed too) for Mamba2's gated norm's sum of squares;
    * :meth:`weight` with ``whole`` and :meth:`gather` (``gather``: a
      reduce-scatter backward) for a weight or product gathered for a use
      that differs by rank: moe's router, MLA's ``w_dkv`` / ``w_krope``,
      Mamba2's ``conv_w`` and ``in_proj`` product, RWKV-6's lora tanh;
      :meth:`gather_replicated` (the rank's block of the gradient, no sum)
      for RWKV-6's channel-mix gate, used whole on every rank.

    A layer whose output product "model" does not split (:meth:`core`: an
    MLP, attention, RWKV-6 mix or Mamba2 block whose row-parallel weight, or
    moe's experts, it leaves whole) runs alike on every rank: its alike view
    reads every weight whole, gathered over "model" where split there with
    the rank's block of the gradient kept (``gather_replicated``), and takes
    no other collective over "model", so the gradients are the single
    process's on every rank.

    Outside autograd (the serving steps run under ``torch.no_grad()``) each
    is the plain collective, as before, and a ``part`` read is the weight
    itself."""

    alike = False  # the alike view of a layer computed whole on every rank (:meth:`core`)

    def __init__(self, cfg: ModelConfig, layout: ServeLayout, comm: Comm, *, cache_len: Optional[int] = None,
                 rows: int = 1):
        check_ported(cfg)
        self.layout, self.comm, self.cache_len = layout, comm, cache_len
        # how many data ranks the call's batch rows split over (the MoE capacity's global token count)
        self.rows = rows
        self.data_index, self.model_index = layout.coords
        self.data_size, self.model_size = layout.data_size, layout.model_size
        self.heads = attention_heads(cfg, layout)
        self.ssm_heads = recurrent_heads(cfg, layout)
        self.specs = layout.param_specs(lm.lm_spec(cfg))
        self.local_spec = local_spec(lm.lm_spec(cfg), self.specs, layout)

    def grad_tree(self, flat: torch.Tensor):
        """The rank's blocks (:func:`shard_params`'s tree, ravel order) as
        views of ``flat`` [d_local] (a leaf that requires grad), their dict
        nodes carrying their leaves' specs."""
        tree = grad_tree(self.local_spec, flat)
        _attach_specs(tree, self.specs)
        return tree

    def ring_split(self, slots: int, window: Optional[int]) -> bool:
        """Whether a ring of ``slots`` slots on this rank is its slice of the
        layer's ring over "data" (``cache_specs``' ``seq`` split): shorter
        than the ring of the step's ``cache_len`` positions (``window`` its
        length where shorter). A ring split on its batch, or gathered whole
        before the step, has the layer's length."""
        if self.cache_len is None:
            return False
        return slots < (min(self.cache_len, window) if window else self.cache_len)

    def core(self, p, name: str, dim: int = -2) -> "ServeShard":
        """The context of a layer whose output is ``p[name]``'s product (its
        row-parallel weight; moe's experts on ``dim`` -3; the logits' table):
        this one where "model" splits that weight on ``dim``, else the alike
        view, in which the layer runs whole on every rank (the class
        docstring)."""
        if self.alike or self.model_size == 1 or self.model_block(p, name, dim) is not None:
            return self
        view = copy.copy(self)
        view.alike = True
        return view

    def weight(self, p, name: str, dtype, whole: bool = False, part: bool = False) -> torch.Tensor:
        """``p[name]`` in ``dtype`` (the bf16 copy), gathered over "data"
        where the layout splits it there, and over "model" too if ``whole``
        (in the alike view always, keeping the rank's block of the gradient);
        one that "model" does not split enters "model" (:meth:`enter`) where
        the rank reads it only in part (``part``) or feeds a column-parallel
        product with it (a name of ``sharding._COL``)."""
        w = weight(p, name, dtype)
        split = False
        for dim, entry in enumerate(p.specs[name]):
            ax = None if entry is None else self.layout.axis(entry)
            if ax == "data":
                w = gather_dim(self.comm, self.layout, w, dim, ax)
            elif ax == "model" and self.model_size > 1:
                split = True
                if self.alike:
                    w = self.gather_replicated(w, dim, ax)
                elif whole:
                    w = gather_dim(self.comm, self.layout, w, dim, ax)
        return self.enter(w) if not split and (part or name in sh._COL) else w

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, replicated over "model", for a use that differs by rank:
        under autograd its gradient is summed over "model" in fp32 at least
        and rounded once to ``x``'s dtype (``comm.enter``); ``x`` itself
        outside autograd or on an axis of one rank."""
        if self.alike or self.model_size == 1 or not C._grad(x):
            return x
        return C.enter(self.comm, x.to(torch.promote_types(x.dtype, torch.float32)), "model").to(x.dtype)

    def model_block(self, p, name: str, dim: int) -> Optional[tuple]:
        """(first index, count) of the rank's block of ``p[name]`` along
        ``dim`` where it is split over "model" and M > 1, else None (in the
        alike view, which reads every weight whole, None)."""
        spec = p.specs[name]
        dim %= p[name].dim()
        if self.alike or dim >= len(spec) or spec[dim] != "model" or self.model_size == 1:
            return None
        n = p[name].shape[dim]
        return self.model_index * n, n

    def col_mm(self, x: torch.Tensor, ws) -> list:
        """``[x @ w for w in ws]``, the rank's column-parallel products of a
        replicated ``x``. Under autograd ``x`` enters "model" once
        (``comm.enter``) in fp32, and each product gives its gradient in fp32
        (``_ColMm``): the partials of all the products and all the ranks are
        summed before x's gradient rounds to bf16 once, as the single
        product's does (at one rank, where the single process rounds each
        product's, this is ``train/sharded_check``'s floor). The alike view
        computes the plain products."""
        if self.alike or not C._grad(x, *ws):
            return [mm(x, w) for w in ws]
        xf = C.enter(self.comm, x.float(), "model")
        return [_ColMm.apply(xf, w) for w in ws]

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
        part = _RowMm.apply(x, w) if C._grad(x, w) else mm_f32(x, w)
        return self.all_reduce(part, "model").to(x.dtype)

    def gather(self, t: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
        """The blocks of ``t`` along ``dim`` of every rank of ``axis``
        (:func:`gather_dim`)."""
        return gather_dim(self.comm, self.layout, t, dim, axis)

    def gather_replicated(self, t: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
        """:meth:`gather` for a use that is the same on every rank: under
        autograd the gradient's block of this rank, with no sum
        (``comm.gather_replicated``)."""
        n = self.layout.size(axis)
        return t if n == 1 else C.gather_replicated(self.comm, t, dim, n, axis, self.layout.index(axis))

    def copies_before(self, counts: torch.Tensor) -> torch.Tensor:
        """[E]: each expert's routed copies on the data ranks before this one
        (the global copy order is token-major, and a data rank holds a
        contiguous range of the tokens), from this rank's [E] ``counts``: one
        all-gather of them over "data" in int32."""
        every = gather_dim(self.comm, self.layout, counts.to(torch.int32)[None].contiguous(), 0, "data")
        return every[:self.data_index].sum(0)

    def all_reduce(self, t: torch.Tensor, axis: str, op: str = "sum", part: bool = False) -> torch.Tensor:
        """The ``op`` of ``t`` over ``axis``; a sum under autograd is
        ``comm.exit`` (the gradient passes as it is), or with ``part``, for
        a sum each rank uses only in part, ``comm.exit_enter`` (the gradient
        summed over ``axis`` too)."""
        if op == "sum":
            return (C.exit_enter if part else C.exit)(self.comm, t, axis)
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


def local_spec(spec_tree, specs, layout: ServeLayout):
    """The tree of the rank's block shapes of ``spec_tree``'s leaves under ``specs``."""

    def local(leaf, spec):
        shape = list(leaf.shape)
        for dim, entry in enumerate(spec):
            if entry is not None:
                shape[dim] //= layout.size(layout.axis(entry))
        return Leaf(tuple(shape), leaf.init, leaf.scale)

    return _map_spec(local, spec_tree, specs)


def shard_params(params: FlatParams, layout: ServeLayout) -> ShardedParams:
    """This rank's blocks of ``params`` under ``layout``'s parameter specs."""
    specs = layout.param_specs(params.spec)
    out = ShardedParams(local_spec(params.spec, specs, layout), specs, params.spec, params.device)
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


@torch.no_grad()
def init_params(cfg: ModelConfig, layout: ServeLayout, *, seed: int = 0, device="cuda") -> ShardedParams:
    """This rank's blocks of ``lm.lm_init(cfg, device=device, seed=seed)``
    (:func:`shard_params` of it, bit for bit) without the whole model: each
    leaf drawn whole from the same generator in ravel order, as
    ``params.materialize`` draws it, one leaf at a time, and its block kept."""
    dev = resolve_device(device)
    spec = shape_tree(lm.lm_spec(cfg))
    specs = layout.param_specs(spec)
    out = ShardedParams(local_spec(spec, specs, layout), specs, spec, dev)
    gen = torch.Generator(dev).manual_seed(seed)
    for (_, leaf), view, (_, s) in zip(leaves_with_path(spec), leaves(out.tree), sh.spec_leaves(specs)):
        view.copy_(layout.block(draw(torch.empty(leaf.shape, device=dev), leaf, gen), s))
    return out.refresh()


def param_numel(layout: ServeLayout, spec_tree) -> int:
    """Values a device holds under the layout's specs (``local_numel``)."""
    specs = sh.spec_leaves(layout.param_specs(spec_tree))
    return sum(sh.local_numel(leaf.shape, s, layout.mesh) for leaf, (_, s) in zip(leaves(spec_tree), specs))


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def cache_layout(cfg: ModelConfig, layout: ServeLayout, batch: int, cache_len: int, *,
                 window_override=None) -> "CacheSplit":
    """:func:`cache_split` of the model's caches for ``batch`` sequences of
    ``cache_len`` positions."""
    return cache_split(lm.cache_init(cfg, batch, cache_len, window_override=window_override, device="meta"),
                       layout)


# the batch dim of a cache leaf, counted from its end, by the leaf's name: k / v [.., B, L, KV, hd]; MLA's
# latent c / k_rope [.., B, L, r]; RWKV-6's state [.., B, H, k, v] and token shifts [.., B, D]; Mamba2's ssm
# [.., B, H, N, hd] and conv window [.., B, W-1, C]
BATCH_DIM = {"k": -4, "v": -4, "c": -3, "k_rope": -3, "state": -4, "x_last": -2, "cm_x_last": -2,
             "ssm": -4, "conv": -3}
# the leaves whose dim after the batch is a ring of sequence slots
RINGS = {"k", "v", "c", "k_rope"}
# the dim of the heads that "model" narrows a cache leaf to, counted from its end
HEAD_DIM = {"k": -2, "v": -2, "state": -3, "ssm": -3}


def _batch_dim(path, t) -> int:
    """The batch dim of the cache leaf ``t`` at ``path`` (from its start)."""
    return t.dim() + BATCH_DIM[path[-1]]


def _cache_batch(caches) -> int:
    """The batch of a model's caches (its first leaf's batch dim)."""
    path, t = leaves_with_path(caches)[0]
    return t.shape[_batch_dim(path, t)]


class CacheSplit(NamedTuple):
    """``cache_specs`` of a model's caches and, in the same tree, what each
    leaf splits over the data axes: ``"batch"`` (its rows), ``"seq"`` (a
    ring's slots), ``"other"`` (any other dim: :func:`cache_split`) or None
    (whole)."""

    specs: object
    kinds: object

    @property
    def found(self) -> set:
        """The kinds of split among the leaves."""
        return {k for k in leaves(self.kinds) if k is not None}


def cache_split(caches, layout: ServeLayout) -> CacheSplit:
    """``cache_specs`` of a model's caches and each leaf's kind of split over
    the data axes (:class:`CacheSplit`): ``batch`` on its batch dim (found
    from its name, :data:`BATCH_DIM`), ``seq`` on a ring's slots (long_500k
    at B = 1), else ``other``: the recurrent states' v / hd, a token shift's
    D or the conv window's C where the batch does not split, a ring's head
    dim where the ring is shorter than a head (gemma3's smoke window of 16),
    a scan segment's repetitions where their count equals B (``cache_specs``
    takes them for the batch: gemma3-1b's 4 at B = 4). One tree may mix
    them (zamba2's rings ``seq`` and its Mamba2 states ``other``; gemma3-1b's
    global rings ``batch`` and its scanned local rings ``other``). A dim that
    "model" narrows to the rank's heads is never the one ``cache_specs``
    splits over the data axes: that would raise."""
    specs = sh.cache_specs(caches, layout.mesh, _cache_batch(caches))

    def one(path, t, spec):
        split = tuple(i for i, e in enumerate(spec) if e is not None and layout.size(layout.axis(e)) > 1)
        if not split:
            return None
        b = _batch_dim(path, t)
        if path[-1] in HEAD_DIM and split == (t.dim() + HEAD_DIM[path[-1]],):
            raise ValueError(f"cache_specs splits the heads dim of a cache of shape {tuple(t.shape)} ({spec}), "
                             "which 'model' narrows to the rank's heads")
        return "batch" if split == (b,) else "seq" if split == (b + 1,) and path[-1] in RINGS else "other"

    return CacheSplit(specs, _map_leaves(one, caches, specs))


def shard_caches(caches, cfg: ModelConfig, layout: ServeLayout):
    """This rank's blocks (copies) of the model's caches (``lm.cache_init``'s
    tree): over "data" its block of every leaf as ``cache_specs`` places it
    (rows, ring slots or another dim: :func:`cache_split`), over "model" the
    rank's kv heads and recurrent heads (MLA's latent caches, the token
    shifts and the conv window: whole). Its bytes are :func:`cache_bytes`',
    less the heads of other "model" ranks."""
    specs = cache_split(caches, layout).specs
    hs, rs = attention_heads(cfg, layout), recurrent_heads(cfg, layout)

    def one(path, t, spec):
        t = layout.block(t, spec)
        if path[-1] in ("k", "v") and hs.nkv != t.shape[-2]:
            t = t.narrow(t.dim() - 2, hs.kv0, hs.nkv)
        elif path[-1] in ("state", "ssm") and rs.n != t.shape[-3]:
            t = t.narrow(t.dim() - 3, rs.h0, rs.n)
        return t.clone()

    return _map_leaves(one, caches, specs)


def cache_rows(caches, start: int, n: int):
    """Rows ``start ... start + n - 1`` of every leaf of a model's caches
    (views, each on its own batch dim)."""
    return _map_leaves(lambda path, t, _: t.narrow(_batch_dim(path, t), start, n), caches)


def cache_bytes(layout: ServeLayout, caches) -> int:
    """Bytes a device holds of a model's caches (``lm.cache_init``'s tree)
    under the reference's ``cache_specs``."""
    specs = sh.spec_leaves(sh.cache_specs(caches, layout.mesh, _cache_batch(caches)))
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
        tp.rows = layout.rows_split(next(iter(batch.values())).shape[0])
        with torch.no_grad():
            return lm.forward(cfg, params, layout.local_batch(batch), chunk=chunk,
                              window_override=window_override, remat=False, tp=tp)

    return prefill


def make_decode_step(cfg: ModelConfig, layout: ServeLayout, comm: Comm, batch: int, cache_len: int, *,
                     window_override=None):
    """``decode(params, caches, token, pos) -> (logits, caches)``:
    ``caches`` the rank's :func:`shard_caches` of ``batch`` x ``cache_len``,
    ``token`` the global [B, 1] (or [B, K, 1]) tokens, ``pos`` an int or a
    0-d tensor; the logits are the rank's block ``[B_local, (K,) V / M]``.

    A cache leaf that ``cache_specs`` splits over the data axes on another
    dim than the batch or a ring's slots (``other``, :func:`cache_split`) is
    all-gathered over them before ``lm.decode_step`` reads it (bit copies),
    the rank's rows of it taken where the batch splits over "data" too; of
    what the step writes the rank keeps its block, after gathering the
    written rows over "data" where the batch splits, so that the holder of
    each block has every row of it. The caches at rest are the rank's blocks
    only; the step holds each ``other`` leaf whole for its duration."""
    check_ported(cfg)
    split = cache_layout(cfg, layout, batch, cache_len, window_override=window_override)
    rows = layout.rows_split(batch)
    tp = ServeShard(cfg, layout, comm, cache_len=cache_len, rows=rows)
    n, lo = batch // rows, layout.coords[0] * (batch // rows)

    def whole(path, t, spec):  # the rank's rows of the whole leaf
        t = gather_dim(comm, layout, t, _data_dim(spec, layout), "data")
        return t.narrow(_batch_dim(path, t), lo, n) if rows > 1 else t

    def block(path, t, spec):  # the rank's block of a leaf of its rows
        if rows > 1:
            t = gather_dim(comm, layout, t, _batch_dim(path, t), "data")
        return layout.block(t, spec).clone()

    def other(fn):
        return lambda path, t, sk: fn(path, t, sk[0]) if sk[1] == "other" else t

    pairs = _zip(split.specs, split.kinds)

    def decode(params, caches, token, pos):
        with torch.no_grad():
            logits, new = lm.decode_step(cfg, params, _map_leaves(other(whole), caches, pairs),
                                         layout.local_batch({"t": token})["t"], pos,
                                         window_override=window_override, tp=tp)
            return logits, _map_leaves(other(block), new, pairs)

    return decode


def _data_dim(spec, layout: ServeLayout) -> int:
    """The dim a cache leaf's spec splits over the data axes."""
    return next(i for i, e in enumerate(spec) if e is not None and layout.axis(e) == "data")


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

