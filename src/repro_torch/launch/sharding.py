"""Sharding rules: parameter / batch / cache partition specs (counterpart of
``repro/launch/sharding.py``, DESIGN.md §5).

Rules are name-based over tree paths and validated against actual leaf
shapes (an axis is only sharded if its size divides the mesh axis size;
otherwise it is left replicated, e.g. 36 q-heads never shard but the
flattened 4608 projection dim does).

The trees are the port's (``models/params.leaves_with_path`` order, which
is ``tree_flatten``'s; a leaf is anything with a ``.shape``: a tensor, a
``params.Leaf``, a ``data.TensorSpec``), and a spec is a :class:`Spec`: a
tuple of mesh axis names, tuples of names or None, one entry per leading
tensor dimension, equal to the contents of the reference's
``PartitionSpec``. :func:`placements` maps one onto DTensor placements.

Parameter layouts:
* ``worker``  — leading W axis over the worker mesh axes (= ("pod","data")
                flattened); inner dims over "model" (MARINA-P per-worker
                replicas; classic DP memory footprint).
* ``server``  — fp32 master + optimizer moments: ZeRO-1-style, sharded over
                the data axes (fsdp) AND "model" where divisible.
* ``serve``   — inference params: fsdp over (data axes, "model") jointly.
* ``tp``, ``tp_attn_rep`` — "model" placements only (no ZeRO-3 gathers);
                the second replicates the attention projections.
* ``replicated`` — every leaf whole on every device.
"""
from __future__ import annotations

from typing import Sequence, Tuple

# names whose last dim shards over "model" (column-parallel)
_COL = {
    "wq", "wk", "wv", "w_in", "w_gate", "w_r", "w_k", "w_v", "w_g",
    "cm_k", "cm_r", "in_proj", "w_dkv", "w_krope", "w_uk", "w_uv",
    "w_lora_a", "w_lora_b", "router", "conv_w", "unembed",
}
# names whose second-to-last dim shards over "model" (row-parallel)
_ROW = {"wo", "w_out", "out_proj", "cm_v", "embed"}
# always replicated (small vectors / scalars)
_REP = {"scale", "w0", "u", "A_log", "D", "dt_bias", "conv_b", "mu", "cm_mu", "count"}


class Spec(tuple):
    """A partition spec: ``Spec("data", None)`` shards dim 0 over the mesh
    axis "data" and keeps dim 1 whole; an entry may be a tuple of axes
    (the dim split over both, the first major); dims past the end are
    whole. Compares equal to the tuple of its entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def dp_axes_of(mesh) -> Tuple[str, ...]:
    if "wk" in mesh.axis_names:  # hierarchical (§Perf C4)
        return ("wk", "data")
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def worker_axis_of(mesh):
    if "wk" in mesh.axis_names:
        return "wk"
    dp = dp_axes_of(mesh)
    return dp[0] if len(dp) == 1 else dp


def worker_fsdp_axes(mesh) -> Tuple[str, ...]:
    """Axes that FSDP-shard *inside* one worker's replica (hierarchical only)."""
    return ("data",) if "wk" in mesh.axis_names else ()


def _axes_size(mesh, axes: Sequence[str]) -> int:
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def map_with_path(fn, tree, path: tuple = ()):
    """``jax.tree_util.tree_map_with_path`` over the port's trees: ``fn(path,
    leaf)`` at every leaf (anything with a ``.shape``, a ``TensorSpec`` tuple
    too), the structure kept."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        return [map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def spec_leaves(tree) -> list:
    """(path, Spec) pairs of a spec tree in ``tree_flatten`` order."""
    if isinstance(tree, Spec):
        return [((), tree)]
    if isinstance(tree, dict):
        return [((k,) + p, s) for k in sorted(tree) for p, s in spec_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [((i,) + p, s) for i, v in enumerate(tree) for p, s in spec_leaves(v)]
    raise TypeError(f"not a spec tree: {type(tree)}")


def path_str(path) -> str:
    """The reference's ``_path_str``: keys and indices joined by '/'."""
    return "/".join(str(p) for p in path)


def _base_spec(ps: str, shape: Tuple[int, ...], model_size: int) -> list:
    """Per-leaf spec (list of axis names / None), 'model' placements only."""
    name = ps.split("/")[-1]
    spec: list = [None] * len(shape)
    if name in _REP or not shape:
        return spec

    def try_shard(dim_idx):
        if shape[dim_idx] % model_size == 0 and shape[dim_idx] >= model_size:
            spec[dim_idx] = "model"

    is_expert = ("moe" in ps and "shared" not in ps
                 and name in ("w_in", "w_gate", "w_out") and len(shape) >= 3)
    if is_expert:
        try_shard(-3)  # expert-parallel on E
    elif name in _ROW:
        try_shard(-2 if len(shape) >= 2 else -1)
    elif name in _COL:
        try_shard(-1)
    return spec


def _add_fsdp(spec: list, shape, dp: Tuple[str, ...], dp_size: int) -> list:
    """Shard the largest still-replicated dim over the data axes (ZeRO/fsdp)."""
    best, best_size = None, 0
    for i, (s, sp) in enumerate(zip(shape, spec)):
        if sp is None and s % dp_size == 0 and s > best_size and s >= dp_size:
            best, best_size = i, s
    if best is not None:
        spec = list(spec)
        spec[best] = dp[0] if len(dp) == 1 else dp
    return spec


def param_specs(params_shape, mesh, layout: str):
    """Tree of :class:`Spec` matching ``params_shape`` (e.g. ``lm.lm_spec``
    or a ``FlatParams.tree``)."""
    model_size = mesh.shape["model"]
    dp = dp_axes_of(mesh)
    dp_size = _axes_size(mesh, dp)
    w_ax = worker_axis_of(mesh)
    w_fsdp = worker_fsdp_axes(mesh)
    if layout not in ("worker", "server", "serve", "tp", "tp_attn_rep", "replicated"):
        raise ValueError(f"unknown layout {layout!r}")

    def one(path, leaf):
        ps = path_str(path)
        shape = tuple(leaf.shape)
        if layout == "replicated":
            return Spec()
        if layout == "worker":
            inner = _base_spec(ps, shape[1:], model_size)
            if w_fsdp:  # hierarchical: FSDP the replica inside the group
                inner = _add_fsdp(inner, shape[1:], w_fsdp, _axes_size(mesh, w_fsdp))
            return Spec(w_ax, *inner)
        name = ps.split("/")[-1]
        if layout == "tp_attn_rep" and name in ("wq", "wk", "wv", "wo"):
            # batch-parallel attention: replicate attention projections so the
            # (head-count % model_size != 0) reshape never gathers activations
            return Spec(*([None] * len(shape)))
        spec = _base_spec(ps, shape, model_size)
        if layout not in ("tp", "tp_attn_rep"):  # "tp*": no ZeRO-3 gathers
            spec = _add_fsdp(spec, shape, dp, dp_size)
        return Spec(*spec)

    return map_with_path(one, params_shape)


def cache_specs(cache_shape, mesh, batch: int):
    """KV/SSM cache specs: batch dim over the data axes when divisible,
    else the longest divisible dim (sequence, for long_500k B=1)."""
    dp = dp_axes_of(mesh)
    dp_size = _axes_size(mesh, dp)
    ax = dp[0] if len(dp) == 1 else dp

    def one(path, leaf):
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        bdim = None
        for i, s in enumerate(shape[:2]):
            if s == batch:
                bdim = i
                break
        if bdim is not None and batch % dp_size == 0 and batch >= dp_size:
            spec[bdim] = ax
        else:
            cand = [(s, i) for i, s in enumerate(shape) if s % dp_size == 0 and s >= dp_size]
            if cand:
                _, i = max(cand)
                spec[i] = ax
        return Spec(*spec)

    return map_with_path(one, cache_shape)


def train_batch_spec(batch_shape, mesh):
    """Training batch [W, B_local, ...]: W over the worker axes; in the
    hierarchical mesh the within-worker batch also shards over 'data'."""
    ax = worker_axis_of(mesh)
    w_fsdp = worker_fsdp_axes(mesh)

    def one(path, leaf):
        shape = tuple(leaf.shape)
        spec = [None] * (len(shape) - 1)
        if w_fsdp and len(shape) >= 2 and shape[1] % _axes_size(mesh, w_fsdp) == 0:
            spec[0] = w_fsdp[0]
        return Spec(ax, *spec)

    return map_with_path(one, batch_shape)


def serve_batch_spec(batch_shape, mesh, batch: int):
    dp = dp_axes_of(mesh)
    dp_size = _axes_size(mesh, dp)
    ax = dp[0] if len(dp) == 1 else dp

    def one(path, leaf):
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        if shape and shape[0] == batch and batch % dp_size == 0 and batch >= dp_size:
            spec[0] = ax
        return Spec(*spec)

    return map_with_path(one, batch_shape)


def scalar_specs(tree_shape):
    return map_with_path(lambda path, leaf: Spec(), tree_shape)


def local_numel(shape, spec: Spec, mesh) -> int:
    """Values of a leaf of ``shape`` that one device holds under ``spec``
    (each dim cut into as many blocks as its axes have devices, rounded up)."""
    n = 1
    for i, size in enumerate(shape):
        n *= -(-size // _axes_size(mesh, _dim_axes(spec, i)))
    return n


def _dim_axes(spec: Spec, i: int) -> tuple:
    """The mesh axes ``spec`` puts dim ``i`` on (none past its end)."""
    entry = spec[i] if i < len(spec) else None
    return entry if isinstance(entry, tuple) else (entry,) if entry is not None else ()


def indivisible(tree, spec_tree, mesh) -> list:
    """(path, shape, dim, axes, devices) of every dim of ``tree``'s leaves
    that its spec in ``spec_tree`` puts on mesh axes whose devices do not
    divide it: a placement JAX refuses as an ``in_shardings`` (the reference's
    ``param_specs`` checks divisibility for "model" and the FSDP axes, not
    for the ``worker`` layout's dim 0)."""
    from ..models import params as P
    out = []
    for (path, leaf), (_, spec) in zip(P.leaves_with_path(tree), spec_leaves(spec_tree)):
        for i, size in enumerate(leaf.shape):
            axes = _dim_axes(spec, i)
            n = _axes_size(mesh, axes)
            if size % n:
                out.append((path_str(path), tuple(leaf.shape), i, axes, n))
    return out


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh`` (a :class:`~.mesh.Mesh` or
    a ``DeviceMesh``), one a mesh dimension: ``Shard(dim)`` where the spec
    puts that mesh axis on tensor dim ``dim``, else ``Replicate()``. A dim
    split over two axes gets ``Shard`` on both; its axes must be in mesh
    order (DTensor splits over the outer mesh dim first), as the
    production meshes give them."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(getattr(mesh, "axis_names", None) or mesh.mesh_dim_names)
    where = {}
    for dim, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,) if entry is not None else ()
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}, not in the mesh {names}")
            if a in where:
                raise ValueError(f"spec {spec} uses mesh axis {a!r} twice")
            where[a] = dim
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec {spec}: dim {dim}'s axes {axes} are not in mesh order {names}")
    return tuple(Shard(where[a]) if a in where else Replicate() for a in names)
