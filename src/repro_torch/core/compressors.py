"""Compression operators (Definitions 2 & 3 of the paper), on tensors.

Port of ``repro/core/compressors.py``: Identity, TopK, BlockTopK, RandK and
PermK (+ :func:`permk_family`), which the paper's experiment runs, and the
jit-friendly variants RotK and BernK, NaturalCompression, ScaledUnbiased and
:func:`tree_compress`.

* Unbiased ``Q in U(omega)``:  E[Q(x)] = x,  E||Q(x)-x||^2 <= omega ||x||^2.
* Contractive ``C in B(alpha)``:  E||C(x)-x||^2 <= (1-alpha) ||x||^2.

Randomness is explicit: a random operator's :meth:`Compressor.draw` takes a
``torch.Generator`` and returns its draws (RandK: the index set; PermK: the
permutation; RotK: the rotation r; BernK and NaturalCompression: uniforms
u [d]), and ``comp(x, draws)`` applies them. The same draws give the same
message on server and worker. Messages are built in the reference's order of
operations (``(x * mask) * scale``, ``(x * mask) / q``), so that with the
reference's own draws the result is bit-equal to the reference called as its
tests call it. (Inside ``jax.jit`` XLA folds a division by a constant into a
multiplication by its float32 reciprocal; the port divides.)

TopK and BlockTopK go through :func:`repro_torch.kernels.ops.block_topk`
(TopK with one block spanning x). On finite input that is exactly
``lax.top_k``'s first-index selection.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from ..kernels import ops


@dataclasses.dataclass(frozen=True)
class Compressor:
    """A (possibly randomized) mapping R^d -> R^d: ``comp(x, draws)``."""

    def __call__(self, x: torch.Tensor, draws: Optional[torch.Tensor] = None) -> torch.Tensor:
        raise NotImplementedError  # pragma: no cover

    def draw(self, d: int, generator: torch.Generator, device) -> Optional[torch.Tensor]:
        """This operator's random draws for a [d] vector, made with
        ``generator`` and placed on ``device``; None if deterministic."""
        return None

    def expected_density(self, d: int) -> float:
        """zeta: expected number of non-zeros sent per message (Definition 4)."""
        raise NotImplementedError  # pragma: no cover


@dataclasses.dataclass(frozen=True)
class UnbiasedCompressor(Compressor):
    """Q in U(omega): E[Q(x)] = x and E||Q(x)-x||^2 <= omega ||x||^2."""

    def omega(self, d: int) -> float:
        raise NotImplementedError  # pragma: no cover


@dataclasses.dataclass(frozen=True)
class ContractiveCompressor(Compressor):
    """C in B(alpha): E||C(x)-x||^2 <= (1-alpha) ||x||^2."""

    def alpha(self, d: int) -> float:
        raise NotImplementedError  # pragma: no cover


@dataclasses.dataclass(frozen=True)
class Identity(UnbiasedCompressor, ContractiveCompressor):
    def __call__(self, x, draws=None):
        return x

    def omega(self, d):
        return 0.0

    def alpha(self, d):
        return 1.0

    def expected_density(self, d):
        return float(d)


@dataclasses.dataclass(frozen=True)
class TopK(ContractiveCompressor):
    """Global magnitude Top-K: keep the K largest-|.| coordinates (first
    index on ties). Deterministic; alpha = K/d."""

    k: int = 1

    def __call__(self, x, draws=None):
        d = x.shape[-1]
        return ops.block_topk(x, k_per_block=min(self.k, d), block=d)

    def alpha(self, d):
        return min(self.k, d) / d

    def expected_density(self, d):
        return float(min(self.k, d))


@dataclasses.dataclass(frozen=True)
class BlockTopK(ContractiveCompressor):
    """Block-local TopK: top-k_b per contiguous block of size b (the last
    block zero-padded). alpha = k_b/b; total kept = k_b * ceil(d/b)."""

    k_per_block: int = 16
    block: int = 1024

    def __call__(self, x, draws=None):
        return ops.block_topk(x, k_per_block=min(self.k_per_block, self.block), block=self.block)

    def alpha(self, d):
        return min(self.k_per_block, self.block) / self.block

    def expected_density(self, d):
        nblocks = -(-d // self.block)
        return float(min(self.k_per_block, self.block) * nblocks)


@dataclasses.dataclass(frozen=True)
class RandK(UnbiasedCompressor):
    """Uniform random-K sparsification with (d/K) rescaling; omega = d/K - 1.
    Draws: K distinct indices. One draw shared by all workers gives the
    paper's ``sameRandK``; one draw per worker gives ``indRandK``."""

    k: int = 1

    def __call__(self, x, draws):
        d = x.shape[-1]
        mask = torch.zeros_like(x).index_fill_(-1, draws, 1.0)
        return x * mask * (d / min(self.k, d))

    def draw(self, d, generator, device):
        return torch.randperm(d, generator=generator)[: min(self.k, d)].to(device)

    def omega(self, d):
        k = min(self.k, d)
        return d / k - 1.0

    def expected_density(self, d):
        return float(min(self.k, d))


@dataclasses.dataclass(frozen=True)
class PermK(UnbiasedCompressor):
    """Permutation compressor for worker ``i`` of ``n`` (Definition 5).

    Draws: a permutation of range(d), shared by all workers. Worker i keeps
    block i (q = d // n entries) scaled by n; the d - q*n leftover entries go
    to worker 0. Across workers with the same draws (1/n) sum_i Q_i(x) = x
    exactly. omega = n - 1."""

    n: int = 1
    worker: int = 0

    def __call__(self, x, draws):
        d = x.shape[-1]
        q = d // self.n
        mask = torch.zeros_like(x).index_fill_(-1, draws[self.worker * q:(self.worker + 1) * q], 1.0)
        out = x * mask * self.n
        if self.worker == 0 and d > q * self.n:
            tmask = torch.zeros_like(x).index_fill_(-1, draws[q * self.n:], 1.0)
            out = out + x * tmask * self.n
        return out

    def draw(self, d, generator, device):
        return torch.randperm(d, generator=generator).to(device)

    def omega(self, d):
        return self.n - 1.0

    def expected_density(self, d):
        return float(-(-d // self.n))


def permk_family(n: int) -> list[PermK]:
    """The n correlated compressors {Q_i} of Definition 5."""
    return [PermK(n=n, worker=i) for i in range(n)]


# ---------------------------------------------------------------------------
# LM-scale jit-friendly variants (hardware adaptation, DESIGN.md §2)
# ---------------------------------------------------------------------------


def _divide(x: torch.Tensor, q: float) -> torch.Tensor:
    """x / q rounded once, on every device: with a Python scalar divisor,
    torch on CUDA multiplies by the scalar's reciprocal instead."""
    return x / x.new_full((), q)


@dataclasses.dataclass(frozen=True)
class RotK(UnbiasedCompressor):
    """Cyclic-partition PermK: worker ``i`` of ``n`` keeps the coordinates j
    with ``j mod n == (i + r) mod n``, scaled by n; the rotation r, uniform
    in [0, n), is shared. (1/n) sum_i Q_i(x) = x exactly; omega = n - 1.
    Draws: r, a 0-d int64 tensor."""

    n: int = 1
    worker: int = 0

    def __call__(self, x, draws):
        mask = self.mask_for(draws, x.shape[-1], self.worker).to(device=x.device, dtype=x.dtype)
        return x * mask * self.n

    def mask_for(self, r: torch.Tensor, d: int, worker: Union[int, torch.Tensor]) -> torch.Tensor:
        """The bool mask [d] of ``worker`` (an int, or a tensor for a batched
        worker axis) under rotation r (floor mod, as the reference's)."""
        idx = torch.arange(d, device=r.device) % self.n
        return idx == torch.remainder(worker + r, self.n)

    def draw(self, d, generator, device):
        return torch.randint(0, self.n, (), generator=generator).to(device)

    def omega(self, d):
        return self.n - 1.0

    def expected_density(self, d):
        return float(-(-d // self.n))


@dataclasses.dataclass(frozen=True)
class BernK(UnbiasedCompressor):
    """Bernoulli sparsification: keep each coordinate w.p. q = k/d (u < q),
    scale 1/q; omega = d/k - 1, expected density k. Draws: uniforms u [d]
    in [0, 1)."""

    k: int = 1

    def __call__(self, x, draws):
        d = x.shape[-1]
        q = min(self.k, d) / d
        mask = (draws < q).to(x.dtype)
        return _divide(x * mask, q)

    def draw(self, d, generator, device):
        return torch.rand(d, generator=generator).to(device)

    def omega(self, d):
        k = min(self.k, d)
        return d / k - 1.0

    def expected_density(self, d):
        return float(min(self.k, d))


# ---------------------------------------------------------------------------
# Natural compression (unbiased, omega = 1/8)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NaturalCompression(UnbiasedCompressor):
    """Stochastic rounding of |x| to the power of two below or above it
    (Horvath et al. 2022), unbiased; omega = 1/8. Dense (zeta = d), 9 bits a
    value on the wire. Draws: uniforms u [d] in [0, 1).

    The powers of two are exact (``torch.ldexp``), so every output
    round-trips through the NATURAL codec. The reference builds them with
    ``jnp.exp2``, which on XLA's CPU is off by a few ulps for most
    exponents away from 0 (ROADMAP Queue 3)."""

    bits_per_value: int = 9

    def __call__(self, x, draws):
        ax = x.abs()
        lo_exp = torch.floor(torch.log2(torch.where(ax > 0, ax, 1.0)))
        lo = torch.ldexp(torch.ones_like(ax), lo_exp)
        hi = lo * 2.0
        # p(hi) chosen so that the expectation is exact: ax = p*hi + (1-p)*lo
        p_hi = torch.where(ax > 0, (ax - lo) / (hi - lo), 0.0)
        mag = torch.where(draws < p_hi, hi, lo)
        return torch.where(ax > 0, torch.sign(x) * mag, 0.0)

    def draw(self, d, generator, device):
        return torch.rand(d, generator=generator).to(device)

    def omega(self, d):
        return 0.125

    def expected_density(self, d):
        return float(d)


# ---------------------------------------------------------------------------
# Scaled unbiased -> contractive (Lemma 8, Richtarik et al. 2021)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ScaledUnbiased(ContractiveCompressor):
    """(omega+1)^{-1} Q in B((omega+1)^{-1}) for Q in U(omega). Draws: the
    inner compressor's."""

    inner: UnbiasedCompressor = dataclasses.field(default_factory=lambda: RandK(k=1))
    d_hint: int = 1

    def __call__(self, x, draws):
        return _divide(self.inner(x, draws), self.inner.omega(x.shape[-1]) + 1.0)

    def draw(self, d, generator, device):
        return self.inner.draw(d, generator, device)

    def alpha(self, d):
        return 1.0 / (self.inner.omega(d) + 1.0)

    def expected_density(self, d):
        return self.inner.expected_density(d)


# ---------------------------------------------------------------------------
# parameter trees: nested dicts (keys in sorted order, as jax's pytrees) and
# lists/tuples with tensors as leaves
# ---------------------------------------------------------------------------


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [leaf for t in tree for leaf in _leaves(t)]


def _rebuild(tree, parts):
    if isinstance(tree, torch.Tensor):
        return next(parts)
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], parts) for k in sorted(tree)}
    return type(tree)(_rebuild(t, parts) for t in tree)


def tree_ravel(tree):
    """(flat, unravel): every leaf flattened and concatenated in pytree order,
    and the inverse that rebuilds a tree of the same structure and dtypes."""
    leaves = _leaves(tree)
    flat = torch.cat([t.reshape(-1) for t in leaves]) if leaves else torch.zeros(0)

    def unravel(v: torch.Tensor):
        sizes = [t.numel() for t in leaves]
        parts = (p.reshape(t.shape).to(t.dtype) for p, t in zip(torch.split(v, sizes), leaves))
        return _rebuild(tree, parts)

    return flat, unravel


def tree_compress(comp: Compressor, draws, tree):
    """Apply a flat-vector compressor to a parameter tree (its draws made for
    the flattened size)."""
    flat, unravel = tree_ravel(tree)
    return unravel(comp(flat, draws))


def make_compressor(spec: str, *, d: int, n: int = 1, worker: int = 0) -> Compressor:
    """Parse a compressor spec string: ``identity``, ``topk:32``,
    ``block_topk:16:1024``, ``randk:32``, ``permk``, ``natural``."""
    parts = spec.split(":")
    kind = parts[0]
    if kind == "identity":
        return Identity()
    if kind == "topk":
        return TopK(k=int(parts[1]) if len(parts) > 1 else max(1, d // n))
    if kind == "block_topk":
        kb = int(parts[1]) if len(parts) > 1 else 16
        b = int(parts[2]) if len(parts) > 2 else 1024
        return BlockTopK(k_per_block=kb, block=b)
    if kind == "randk":
        return RandK(k=int(parts[1]) if len(parts) > 1 else max(1, d // n))
    if kind == "permk":
        return PermK(n=n, worker=worker)
    if kind == "natural":
        return NaturalCompression()
    raise ValueError(f"unknown compressor spec: {spec}")
