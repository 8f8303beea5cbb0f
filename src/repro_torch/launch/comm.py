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


def mesh_groups(device_mesh) -> Dict[str, object]:
    """Axis name -> this rank's process group along that axis of a
    ``DeviceMesh``."""
    return {name: device_mesh.get_group(name) for name in device_mesh.mesh_dim_names}


def device_type() -> str:
    """The device type of the default group's tensors: cuda for NCCL, else cpu."""
    return "cuda" if str(dist.get_backend()).lower() == "nccl" else "cpu"
