"""Per-step operation count of a PyTorch program: the port's counterpart of
``repro/launch/hlo_cost.py``.

A torch program has no HLO to parse, so the count is taken while the program
runs, usually on the ``meta`` device (shapes without storage: a full-width
step costs no memory and no arithmetic), by a ``TorchDispatchMode`` that sees
every ATen op:

* **flops**: dot FLOPs by the rule of ``hlo_cost.py``, 2 * |result| *
  |contracted dims|, for ``mm``, ``bmm``, ``addmm``, ``baddbmm``, the
  convolutions and attention ops (the formulas of
  ``torch.utils.flop_counter``). Elementwise work is not counted, as in the
  reference, and neither is a product over one contracted value (an outer
  product, which XLA rewrites into a multiply). Backward ops and activation
  recomputation run as ops and are counted, as XLA's program holds them.
* **bytes**: operand and result bytes of every op that materialises a tensor
  (views, ``detach``, allocations and metadata queries are free, as
  ``_FREE_OPS`` is there). This is the eager program's HBM-traffic proxy:
  each op reads its inputs from and writes its outputs to memory. It is a
  different quantity from XLA's bytes of a fused program, and is not held
  against the reference.
* **the hand kernels** are charged at their ``kernels.ops`` wrapper with
  their analytic bytes and FLOPs (:func:`repro_torch.kernels.runtime.kernel_cost`),
  on every device; the ops of their plain version (CPU, ``meta``) are hidden
  from the count, and a launch on the card is invisible to a dispatch mode.
* **collectives** (``all-gather``, ``reduce-scatter``, ``all-reduce``) are
  charged by the sharded train step's communicator
  (``train/sharded.py``, :func:`repro_torch.kernels.runtime.collective_cost`)
  at their result-shape bytes per device, the reference's proxy for the
  bytes a collective moves (``repro/launch/roofline.py::collective_bytes``).
  They go to ``coll``, not ``bytes``: the roofline prices them over the
  link, not over HBM.

:func:`one_worker_for_all` counts a train step of W identical workers with
one worker's forward and backward, charged W times.
"""
from __future__ import annotations

import collections
import contextlib
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..kernels import runtime

aten = torch.ops.aten

# ops that move no bytes: allocation without a write, aliasing, metadata
_FREE = {
    aten.detach.default, aten.alias.default, aten.lift_fresh.default,
    aten.empty.memory_format, aten.empty_like.default, aten.empty_strided.default,
    aten.new_empty.default, aten.new_empty_strided.default,
    aten._local_scalar_dense.default, aten._unsafe_view.default,
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(args):
    for a in args:
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple)):
            yield from (x for x in a if isinstance(x, torch.Tensor))


_LHS = {aten.mm: 0, aten.bmm: 0, aten.addmm: 1, aten.baddbmm: 1}  # the products: lhs position


def _outer_product(packet, args) -> bool:
    """A product over one contracted value: XLA rewrites such a dot into a
    multiply, so it is elementwise work, as in the reference's count
    (autograd's backward of a dot over one head dim is one)."""
    i = _LHS.get(packet)
    return i is not None and args[i].shape[-1] == 1


class OpCount(TorchDispatchMode):
    """FLOPs and bytes by op name (``flops``, ``bytes``, ``calls``;
    hand kernels as ``kernel:<name>``) and collective bytes by kind
    (``coll``) of what runs while it is open. Open it with :func:`counting`."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_fns = flop_registry
        self._composite: Dict = {}
        self._paused = 0
        self.flops: collections.Counter = collections.Counter()
        self.bytes: collections.Counter = collections.Counter()
        self.calls: collections.Counter = collections.Counter()
        self.coll: collections.Counter = collections.Counter()

    # -- totals -----------------------------------------------------------------
    @property
    def total_flops(self) -> float:
        return float(sum(self.flops.values()))

    @property
    def total_bytes(self) -> float:
        return float(sum(self.bytes.values()))

    @property
    def total_coll(self) -> float:
        return float(sum(self.coll.values()))

    def snapshot(self) -> tuple:
        return (self.flops.copy(), self.bytes.copy(), self.calls.copy(), self.coll.copy())

    def since(self, snap: tuple) -> tuple:
        """What was counted after ``snap`` (a :meth:`snapshot`)."""
        return tuple(now - then for now, then in zip(self.snapshot(), snap))

    def add(self, part: tuple) -> None:
        """Count ``part`` (a :meth:`since`) once more."""
        for mine, theirs in zip((self.flops, self.bytes, self.calls, self.coll), part):
            mine.update(theirs)

    def charge(self, name: str, nbytes: float, flops: float = 0.0, *, collective: bool = False) -> None:
        """Charge ``nbytes`` (and ``flops``) to ``name``; a ``collective``'s
        bytes go to ``coll`` (link traffic), every other charge's to
        ``bytes`` (memory traffic)."""
        if not self._paused:
            (self.coll if collective else self.bytes)[name] += nbytes
            self.flops[name] += flops
            self.calls[name] += 1

    def top(self, n: int = 8) -> list:
        """The ``n`` ops that move the most bytes: (name, calls, bytes, flops)."""
        return [(k, self.calls[k], float(b), float(self.flops[k]))
                for k, b in self.bytes.most_common(n)]

    @contextlib.contextmanager
    def paused(self):
        """Ops inside run but are not counted."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    # -- the dispatch -------------------------------------------------------------
    def _is_composite(self, func) -> bool:
        hit = self._composite.get(func)
        if hit is None:
            hit = torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), torch._C.DispatchKey.CompositeImplicitAutograd)
            self._composite[func] = hit
        return hit

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        if packet not in self._flop_fns and self._is_composite(func):
            # a composite op reaching the mode: count what it is made of
            # (torch.utils.flop_counter does the same)
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if self._paused:
            return out
        outs = list(_tensors(out if isinstance(out, (list, tuple)) else (out,)))
        if not outs or func in _FREE or func.is_view:
            return out
        name = packet.__name__
        fn = self._flop_fns.get(packet)
        if fn is not None and not _outer_product(packet, args):
            self.flops[name] += fn(*args, **kwargs, out_val=out)
        ins = sum(_nbytes(t) for t in _tensors(args))
        ins += sum(_nbytes(t) for k, v in kwargs.items() if k != "out" for t in _tensors((v,)))
        self.bytes[name] += ins + sum(_nbytes(t) for t in outs)
        self.calls[name] += 1
        return out


@contextlib.contextmanager
def counting():
    """``with counting() as c: step(...)``: an :class:`OpCount` of the body,
    which the ``kernels.ops`` wrappers charge too."""
    count = OpCount()
    runtime.COUNTS.append(count)
    try:
        with count:
            yield count
    finally:
        runtime.COUNTS.remove(count)


@contextlib.contextmanager
def one_worker_for_all(count: OpCount):
    """Inside, a train step (``train/trainer.py``) on ``meta`` runs its first
    worker's forward and backward and charges each later worker that
    worker's count instead of running it: the W workers' work is the same
    ops at the same shapes, so the count is exact (``tests/test_torch_launch.py``
    holds it equal to the full loop) and costs one worker's pass, not W."""
    from ..train import trainer

    real = trainer.worker_value_and_grad
    first: dict = {}

    def once(cfg, spec, fwd_kw, row, shard):
        if row.device.type != "meta":
            raise ValueError("one_worker_for_all counts steps on the meta device only")
        if not first:
            snap = count.snapshot()
            loss, g = real(cfg, spec, fwd_kw, row, shard)
            first["cost"] = count.since(snap)
            return loss, g
        count.add(first["cost"])
        with count.paused():
            return torch.empty((), device=row.device), torch.empty(row.shape, device=row.device)

    trainer.worker_value_and_grad = once
    try:
        yield
    finally:
        trainer.worker_value_and_grad = real
