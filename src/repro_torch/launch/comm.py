"""Collectives over a mesh axis, counted: the communicator the sharded steps
(``train/sharded.py``, ``serve/sharded.py``) call for every collective.

:class:`Comm` calls ``torch.distributed`` on the process group of a mesh
axis: ``axis=None`` is every rank (the default group), a name (``"data"``,
``"model"``) the group its ``groups`` maps it to (:func:`mesh_groups`:
``Mesh.device_mesh(...).get_group(axis)``). It tallies, by kind, the
result-shape bytes of every tensor it hands over (``all-gather``: the
gathered tensor; ``reduce-scatter``: the rank's slice; ``all-reduce``: the
tensor), the reference's proxy for the bytes a collective moves
(``repro/launch/roofline.py::collective_bytes``), and charges them to an
open op count (:func:`repro_torch.kernels.runtime.collective_cost`).
:class:`CountingComm` charges and tallies the same bytes and calls nothing,
so the dry-run counts one rank of a 256-rank mesh on ``meta`` with no group.

Collectives with a backward, for tensor parallelism over one mesh axis under
autograd (Megatron's pair and a gather). A replicated activation holds its
whole gradient on every rank of the axis; what a rank computes on its own
block (its heads, its columns) gives a partial gradient, which these sum
where it meets a replicated tensor again:

* :func:`enter`: identity forward, all-reduce (sum) backward; on a
  replicated activation before the rank's column-parallel products;
* :func:`exit`: all-reduce (sum) forward, identity backward; after a
  row-parallel partial product, and after the embedding's row lookup;
* :func:`gather`: all-gather along a dim forward, reduce-scatter (sum)
  backward; a weight gathered whole where the split cuts through a head,
  whose use on every rank gives a partial gradient;
* :func:`gather_replicated`: all-gather forward, the rank's own block of the
  gradient backward (no sum); a gathered activation that every rank then
  uses whole, as a replicated tensor (RWKV-6's channel-mix gate, which
  multiplies the row-parallel product's sum), so that its gradient is whole
  on every rank already;
* :func:`exit_enter`: all-reduce (sum) forward and backward (``exit``, then
  ``enter``); a partial sum that each rank then uses only in part (Mamba2's
  gated norm's sum of squares, which scales the rank's heads alone).

:func:`enter` also carries a replicated weight that a rank reads in part
(its heads' columns of RWKV-6's ``w0`` / ``u``, of Mamba2's ``A_log`` /
``dt_bias`` / ``D`` / ``conv_b``, a per-head norm's scale, MLA's
``kv_norm`` scale, whose latent only the rank's heads read): the rank's
gradient of it is partial, and the sum over the axis gives every rank the
whole one.

Each goes through the communicator in both directions, so :class:`Comm`
hands the backward's collective to the group too and :class:`CountingComm`
counts it (under activation recomputation the forward's are issued again in
the backward, on every rank in the same order). Outside autograd (no input
requires grad) each is its plain collective, in place where that is.
``torch.distributed.nn.functional.all_reduce`` is not one of them: it sums
the gradients in its backward, which would multiply a replicated
activation's gradient by the axis' size.
"""
from __future__ import annotations

import collections
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from ..kernels import runtime

_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN"}


class Comm:
    """The collectives of a step over the process groups of ``groups``
    (axis name -> group; ``axis=None``: the default group). ``bytes``
    tallies the result-shape bytes handed over, by kind."""

    def __init__(self, groups: Optional[Dict[str, object]] = None):
        self.groups = dict(groups or {})
        self.bytes: collections.Counter = collections.Counter()

    def _group(self, axis):
        if axis is None:
            return None
        if axis not in self.groups:
            raise ValueError(f"no process group for mesh axis {axis!r} (have {sorted(self.groups)})")
        return self.groups[axis]

    def _call(self, kind: str, out: torch.Tensor, call: Callable) -> torch.Tensor:
        nbytes = out.numel() * out.element_size()
        self.bytes[kind] += nbytes
        with runtime.collective_cost(kind, nbytes):
            call()
        return out

    def reduce_scatter(self, out: torch.Tensor, inp: torch.Tensor, axis=None) -> torch.Tensor:
        """``out`` = this rank's slice of the sum over the axis' ranks of ``inp``."""
        return self._call("reduce-scatter", out,
                          lambda: dist.reduce_scatter_tensor(out, inp, group=self._group(axis)))

    def all_gather(self, out: torch.Tensor, inp: torch.Tensor, axis=None) -> torch.Tensor:
        """``out`` = every rank's ``inp`` along dim 0, in the axis' rank order."""
        return self._call("all-gather", out,
                          lambda: dist.all_gather_into_tensor(out, inp, group=self._group(axis)))

    def all_reduce(self, t: torch.Tensor, axis=None, op: str = "sum") -> torch.Tensor:
        """``t`` = the ``op`` (sum, max, min) over the axis' ranks of ``t``, in place."""
        return self._call("all-reduce", t,
                          lambda: dist.all_reduce(t, op=getattr(dist.ReduceOp, _OPS[op]),
                                                  group=self._group(axis)))


class CountingComm(Comm):
    """Charges and tallies what :class:`Comm` would and calls nothing: the
    outputs are left as allocated (the dry-run's ``meta`` tensors)."""

    def _group(self, axis):
        return None

    def _call(self, kind, out, call):
        return super()._call(kind, out, lambda: None)


# ---------------------------------------------------------------------------
# collectives with a backward
# ---------------------------------------------------------------------------


def _grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axis):
        ctx.comm, ctx.axis = comm, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g.clone(), ctx.axis), None, None


class _Exit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, axis):
        return comm.all_reduce(x.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _all_gather_dim(comm, t: torch.Tensor, dim: int, size: int, axis) -> torch.Tensor:
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
    comm.all_gather(out, x, axis)
    return out.movedim(0, dim).contiguous() if dim else out


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm, axis, dim, size):
        ctx.comm, ctx.axis, ctx.dim, ctx.size, ctx.dtype = comm, axis, dim, size, t.dtype
        return _all_gather_dim(comm, t, dim, size, axis)

    @staticmethod
    def backward(ctx, g):
        # the ranks' partial gradients of the whole tensor summed in fp32 (or wider), each rank its block
        x = g.movedim(ctx.dim, 0).to(torch.promote_types(g.dtype, torch.float32)).contiguous()
        out = x.new_empty((x.shape[0] // ctx.size,) + tuple(x.shape[1:]))
        ctx.comm.reduce_scatter(out, x, ctx.axis)
        out = out.to(ctx.dtype)
        return (out.movedim(0, ctx.dim) if ctx.dim else out), None, None, None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, comm, axis, dim, size, index):
        ctx.dim, ctx.lo, ctx.n = dim, index * t.shape[dim], t.shape[dim]
        return _all_gather_dim(comm, t, dim, size, axis)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.lo, ctx.n), None, None, None, None, None


def enter(comm: Comm, x: torch.Tensor, axis) -> torch.Tensor:
    """``x`` forward; its gradient all-reduced (sum) over ``axis`` backward."""
    return _Enter.apply(x, comm, axis) if _grad(x) else x


def exit(comm: Comm, x: torch.Tensor, axis) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis`` forward (in place outside
    autograd); the gradient as it is backward."""
    return _Exit.apply(x, comm, axis) if _grad(x) else comm.all_reduce(x, axis)


def gather(comm: Comm, t: torch.Tensor, dim: int, size: int, axis) -> torch.Tensor:
    """The ``size`` ranks' blocks of ``t`` along ``dim``, in rank order (one
    all-gather); backward, the rank's block of the gradient summed over the
    axis (one reduce-scatter in fp32 at least, rounded once to ``t``'s dtype)."""
    if _grad(t):
        return _Gather.apply(t, comm, axis, dim, size)
    return _all_gather_dim(comm, t, dim, size, axis)


def gather_replicated(comm: Comm, t: torch.Tensor, dim: int, size: int, axis, index: int) -> torch.Tensor:
    """The ``size`` ranks' blocks of ``t`` along ``dim``, in rank order (one
    all-gather), for a use that is the same on every rank; backward, the
    block of the gradient at this rank's ``index`` on the axis, which every
    rank holds whole (no collective)."""
    if _grad(t):
        return _GatherReplicated.apply(t, comm, axis, dim, size, index)
    return _all_gather_dim(comm, t, dim, size, axis)


def exit_enter(comm: Comm, x: torch.Tensor, axis) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis`` forward (in place outside
    autograd), for a use that differs by rank; backward, the gradient summed
    over the axis too (:func:`exit`, then :func:`enter`)."""
    return enter(comm, exit(comm, x, axis), axis)


def mesh_groups(device_mesh) -> Dict[str, object]:
    """Axis name -> this rank's process group along that axis of a
    ``DeviceMesh``."""
    return {name: device_mesh.get_group(name) for name in device_mesh.mesh_dim_names}


def device_type() -> str:
    """The device type of the default group's tensors: cuda for NCCL, else cpu."""
    return "cuda" if str(dist.get_backend()).lower() == "nccl" else "cpu"
