"""Parameter trees of the LM and where the port keeps them.

The reference keeps parameters as plain nested dicts and lists of jax arrays,
and the wire addresses them through ``jax.flatten_util.ravel_pytree``: the
leaves in ``tree_flatten`` order (dict keys sorted, lists in order, a scan
segment's stacked ``[count, ...]`` leaf as one leaf), each raveled row-major.
A wire index means the same coordinate in both packages only under that
order, and ``nn.Module`` registration order is not it.

So the port lays ALL fp32 master parameters of a tree out in one flat
``nn.Parameter`` in exactly that order (:class:`FlatParams`), and every leaf
of its tree is a view into it: a wire delta is one fp32 add into ``flat``,
and the checkpoint keys come from the same walk of the tree.

Beside the masters sits a bf16 copy in the same layout (``flat_low``). The
reference casts each fp32 weight to bf16 (``w.astype(bfloat16)``) before
every matmul; that cast is a pure function of the masters, so a copy made
once per change of the masters gives the same bits, and the layers read it
through :func:`weight`. Whoever changes ``flat`` calls
:meth:`FlatParams.refresh` (the wire, checkpoint and conversion paths do).

Training differentiates instead (:func:`grad_tree`): a fresh tree of views
of one flat row that requires grad, with no bf16 copy, so :func:`weight`
casts inside autograd and the row's ``.grad`` is the flat gradient in ravel
order. The tree, and the repetitions :func:`index_tree` memoises on it, live
for one forward and backward.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, Optional, Tuple

import torch
from torch import nn

LOW_DTYPE = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class Leaf:
    """Shape and initialiser of one parameter (the port's counterpart of a
    leaf of the reference's ``jax.eval_shape(lm_init)``): ``normal`` is
    N(0, 1) * scale, ``uniform`` U[0, 1), ``full`` the constant ``scale``."""

    shape: Tuple[int, ...]
    init: str = "normal"
    scale: float = 1.0

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def dense(d_in: int, d_out: int, scale: Optional[float] = None) -> Leaf:
    """The reference's ``_dense_init``: N(0, 1) * d_in**-0.5 unless given."""
    return Leaf((d_in, d_out), "normal", scale if scale is not None else d_in**-0.5)


def full(shape, value: float) -> Leaf:
    return Leaf(tuple(shape), "full", float(value))


def stacked(leaf: Leaf, count: int) -> Leaf:
    return Leaf((count,) + leaf.shape, leaf.init, leaf.scale)


# ---------------------------------------------------------------------------
# trees: dicts (keys sorted, as tree_flatten does) and lists
# ---------------------------------------------------------------------------


def leaves_with_path(tree, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """(path, leaf) pairs in ``jax.tree_util.tree_flatten`` order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves_with_path(tree[k], path + (k,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += leaves_with_path(v, path + (i,))
        return out
    return [(path, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def map_tree(fn: Callable, tree, *rest):
    """``jax.tree.map`` over dicts and lists (the structure of ``tree``)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return [map_tree(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def path_key(path: Tuple) -> str:
    """The checkpoint key of a leaf: its path joined by '/' (``io.py:18``)."""
    return "/".join(str(p) for p in path)


def shape_tree(tree):
    """The tree of ``Leaf`` specs (fp32 normal) of a tree of tensors/arrays,
    or ``tree`` itself if it holds specs already."""
    return map_tree(lambda t: t if isinstance(t, Leaf) else Leaf(tuple(t.shape)), tree)


class ParamDict(dict):
    """A dict node of a parameter tree. ``low`` is its bf16 twin (the same
    keys, views into ``flat_low``), or None; ``specs`` maps the names of its
    leaves to their partition specs on a rank of a sharded model
    (``serve/sharded.py``), or is None."""

    low: Optional["ParamDict"] = None
    specs: Optional[dict] = None

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._reps: dict = {}


def weight(p, name: str, dtype: torch.dtype) -> torch.Tensor:
    """``p[name].astype(dtype)`` of the reference: the bf16 copy where ``p``
    carries one, else a cast (a no-op for an fp32 dtype)."""
    low = getattr(p, "low", None)
    if low is not None and dtype == LOW_DTYPE:
        return low[name]
    return p[name].to(dtype)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the reference computes it: a bf16 product accumulates in
    fp32 and rounds once to bf16. On the CPU it runs as an fp32 product of
    the bf16 values, rounded, which is what XLA's CPU backend does (bit for
    bit on random inputs, where torch's own CPU bf16 GEMM differs in about
    1e-4 of the outputs); on the card it is a cuBLAS bf16 GEMM with fp32
    accumulation (``layers.set_reference_precision``)."""
    if a.dtype == LOW_DTYPE and a.device.type == "cpu":
        return torch.matmul(a.float(), b.float()).to(LOW_DTYPE)
    return torch.matmul(a, b)


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """:func:`mm` before its rounding: the fp32 product of two bf16
    operands (fp32 accumulation), a partial that a row-parallel product sums
    over ranks before rounding once. On the CPU an fp32 product of the bf16
    values, as :func:`mm`; elsewhere a bf16 GEMM with an fp32 result
    (``out_dtype``). b: 2-D."""
    if a.device.type == "cpu":
        return torch.matmul(a.float(), b.float())
    out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
    return out.reshape(*a.shape[:-1], b.shape[-1])


def einsum_low(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.einsum`` of two bf16 operands with a bf16 result, as :func:`mm`."""
    if a.dtype == LOW_DTYPE and a.device.type == "cpu":
        return torch.einsum(eq, a.float(), b.float()).to(LOW_DTYPE)
    return torch.einsum(eq, a, b)


def index_tree(tree, i: int):
    """Repetition ``i`` of a scan segment's stacked tree (every leaf's first
    axis), with its bf16 twin; memoised on a :class:`ParamDict`."""
    if isinstance(tree, ParamDict) and i in tree._reps:
        return tree._reps[i]
    if isinstance(tree, dict):
        out = ParamDict({k: index_tree(v, i) for k, v in tree.items()})
        if getattr(tree, "low", None) is not None:
            out.low = index_tree(tree.low, i)
        if getattr(tree, "specs", None) is not None:  # a repetition's leaf drops the stacked dim
            out.specs = {k: s[1:] for k, s in tree.specs.items()}
        if isinstance(tree, ParamDict):
            tree._reps[i] = out
        return out
    if isinstance(tree, list):
        return [index_tree(v, i) for v in tree]
    return tree[i]


def _views(spec, flat: torch.Tensor, low: Optional[torch.Tensor], offset: List[int]):
    """(tree, bf16 twin) of views into ``flat`` / ``low`` (None: no twin) in
    flatten order."""
    if isinstance(spec, dict):
        node, twin = ParamDict(), ParamDict()
        for k in sorted(spec):
            node[k], twin[k] = _views(spec[k], flat, low, offset)
        node.low = twin if low is not None else None
        return node, twin
    if isinstance(spec, (list, tuple)):
        pairs = [_views(v, flat, low, offset) for v in spec]
        return [a for a, _ in pairs], [b for _, b in pairs]
    n = spec.size
    o = offset[0]
    offset[0] += n
    view = flat[o:o + n].view(spec.shape)
    return view, (low[o:o + n].view(spec.shape) if low is not None else None)


class FlatParams(nn.Module):
    """fp32 master parameters of a tree in one flat ``nn.Parameter``, in the
    reference's ravel order, with their bf16 copy and the tree of views.

    ``tree`` is what the model functions take; ``flat`` is the wire's vector
    (``ravel_pytree(params)[0]``). Moving the module (``.to(device)``) moves
    both buffers and rebuilds the views."""

    def __init__(self, spec, device):
        super().__init__()
        self.spec = shape_tree(spec)
        n = sum(leaf.size for leaf in leaves(self.spec))
        self.flat = nn.Parameter(torch.zeros(n, dtype=torch.float32, device=device),
                                 requires_grad=False)
        self.register_buffer("flat_low", torch.zeros(n, dtype=LOW_DTYPE, device=device),
                             persistent=False)
        self._rebuild()

    def _rebuild(self) -> None:
        self.tree, _ = _views(self.spec, self.flat.data, self.flat_low, [0])

    def _apply(self, fn, recurse=True):
        out = super()._apply(fn, recurse)
        self._rebuild()
        return out

    @property
    def device(self) -> torch.device:
        return self.flat.device

    @property
    def size(self) -> int:
        return self.flat.numel()

    @torch.no_grad()
    def refresh(self) -> "FlatParams":
        """Re-derive the bf16 copy from the masters (after any change)."""
        self.flat_low.copy_(self.flat)
        return self

    @torch.no_grad()
    def load_flat(self, flat: torch.Tensor) -> "FlatParams":
        """Overwrite the masters with ``flat`` [d] (any device) and refresh."""
        if flat.shape != self.flat.shape:
            raise ValueError(f"flat vector of shape {tuple(flat.shape)} != {tuple(self.flat.shape)}")
        self.flat.copy_(flat)
        return self.refresh()

    def clone_to(self, device) -> "FlatParams":
        """A copy of these parameters on ``device``."""
        return FlatParams(self.spec, device).load_flat(self.flat.detach())


def leaf_sizes(spec) -> Tuple[int, ...]:
    """The sizes of a tree's leaves in ravel order (the wire's segments)."""
    return tuple(leaf.size for leaf in leaves(shape_tree(spec)))


def grad_tree(spec, flat: torch.Tensor):
    """The tree of ``spec`` as views of ``flat`` [d] (any float dtype; a
    leaf that requires grad, for training) in ravel order, with no bf16
    copy: :func:`weight` casts each weight inside autograd."""
    spec = shape_tree(spec)
    if flat.dim() != 1 or flat.numel() != sum(leaf_sizes(spec)):
        raise ValueError(f"flat row of shape {tuple(flat.shape)} does not fit the tree "
                         f"({sum(leaf_sizes(spec))} values)")
    return _views(spec, flat, None, [0])[0]


def tree_of(params):
    """The parameter tree of a :class:`FlatParams`, or ``params`` itself."""
    return params.tree if isinstance(params, FlatParams) else params


@torch.no_grad()
def materialize(spec, generator: torch.Generator, device) -> FlatParams:
    """Allocate a :class:`FlatParams` for ``spec`` on ``device`` and draw
    every leaf from ``generator`` (on that device), in ravel order."""
    params = FlatParams(spec, device)
    for (_, leaf), view in zip(leaves_with_path(params.spec), leaves(params.tree)):
        draw(view, leaf, generator)
    return params.refresh()


def draw(t: torch.Tensor, leaf: Leaf, generator: torch.Generator) -> torch.Tensor:
    """Fill ``t`` (contiguous, ``leaf``'s shape) with ``leaf``'s initialiser
    from ``generator``: the draw :func:`materialize` makes for that leaf."""
    if leaf.init == "normal":
        t.normal_(generator=generator).mul_(leaf.scale)
    elif leaf.init == "uniform":
        t.uniform_(generator=generator)
    elif leaf.init == "full":
        t.fill_(leaf.scale)
    else:
        raise ValueError(leaf.init)
    return t
