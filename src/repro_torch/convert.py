"""Carry the JAX reference's problem, states, LM parameters and decode
caches into the port, and lay LM parameters out as the wire's flat vector.

The arguments are numpy arrays (``np.asarray`` of the reference's jax
arrays), so this module needs neither JAX nor ``repro``.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.ef21p import EF21PState
from .core.marina_p import MarinaPState
from .core.problems import L1Problem
from .kernels.runtime import resolve_device


def _f32(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)  # a writable copy


def problem_from_numpy(A, x0, L0i, sigma_A: float, device="cuda") -> L1Problem:
    dev = resolve_device(device)
    return L1Problem(A=_f32(A, dev), x0=_f32(x0, dev), L0i=_f32(L0i, dev), sigma_A=float(sigma_A))


def marina_p_state_from_numpy(x, W, t, device="cuda") -> MarinaPState:
    dev = resolve_device(device)
    return MarinaPState(x=_f32(x, dev), W=_f32(W, dev), t=int(t))


def ef21p_state_from_numpy(x, w, t, device="cuda") -> EF21PState:
    dev = resolve_device(device)
    return EF21PState(x=_f32(x, dev), w=_f32(w, dev), t=int(t))


# ---------------------------------------------------------------------------
# the LM: parameters, decode caches, the wire's flat vector
# ---------------------------------------------------------------------------


def _tensor(a, dev) -> torch.Tensor:
    """A torch copy of one numpy leaf; a bfloat16 array (ml_dtypes, from
    ``np.asarray`` of a jax bf16 array) by its bit patterns."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a)).to(dev)


def lm_params_from_numpy(cfg, tree, device="cuda"):
    """The reference's ``lm_init`` tree (``jax.tree.map(np.asarray, params)``)
    as the port's :class:`~repro_torch.models.params.FlatParams`: every leaf
    must have the path and shape of ``models.lm.lm_spec(cfg)``; the bf16 copy
    is refreshed."""
    from .models import lm, params as P

    dev = resolve_device(device)
    out = P.FlatParams(lm.lm_spec(cfg), dev)
    got = P.leaves_with_path(tree)
    want = P.leaves_with_path(out.spec)
    if [p for p, _ in got] != [p for p, _ in want]:
        raise ValueError("parameter tree differs from the port's lm_spec: "
                         f"{sorted(set(p for p, _ in got) ^ set(p for p, _ in want))[:4]}")
    for (path, a), (_, leaf) in zip(got, want):
        if tuple(np.shape(a)) != leaf.shape:
            raise ValueError(f"{P.path_key(path)}: shape {np.shape(a)} != {leaf.shape}")
    flat = np.concatenate([np.asarray(a, np.float32).reshape(-1) for _, a in got])
    return out.load_flat(torch.from_numpy(flat))


def lm_caches_from_numpy(caches, device="cuda"):
    """The reference's decode caches (``lm.cache_init`` / ``decode_step``
    output, as numpy) as the port's: the same list of segments and dict
    keys, dtypes kept (bf16 by bit pattern)."""
    from .models.params import map_tree

    dev = resolve_device(device)
    return map_tree(lambda a: _tensor(a, dev), caches)


def ravel_params(params) -> torch.Tensor:
    """``jax.flatten_util.ravel_pytree(params)[0]``: the fp32 leaves in
    flatten order (dict keys sorted, lists in order), each row-major. For a
    ``FlatParams`` this is its ``flat`` master vector itself (no copy)."""
    from .models.params import FlatParams, leaves

    if isinstance(params, FlatParams):
        return params.flat.detach()
    return torch.cat([t.reshape(-1).to(torch.float32) for t in leaves(params)])


def unravel_params(flat: torch.Tensor, like):
    """Inverse of :func:`ravel_params` for the structure of ``like``: a new
    ``FlatParams`` holding a copy of ``flat`` for a ``FlatParams``, else a
    tree of views into ``flat``."""
    from .models.params import FlatParams, _views, leaves, shape_tree

    if isinstance(like, FlatParams):
        return FlatParams(like.spec, flat.device).load_flat(flat)
    spec = shape_tree(like)
    if sum(leaf.size for leaf in leaves(spec)) != flat.numel():
        raise ValueError(f"flat vector of {flat.numel()} values does not fit the tree")
    return _views(spec, flat, None, [0])[0]
