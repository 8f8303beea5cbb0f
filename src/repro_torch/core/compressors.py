"""Compression operators (Definitions 2 & 3 of the paper), on tensors.

Port of ``repro/core/compressors.py`` for the families the paper's experiment
runs: Identity, TopK, BlockTopK, RandK and PermK (+ :func:`permk_family`).

* Unbiased ``Q in U(omega)``:  E[Q(x)] = x,  E||Q(x)-x||^2 <= omega ||x||^2.
* Contractive ``C in B(alpha)``:  E||C(x)-x||^2 <= (1-alpha) ||x||^2.

Randomness is explicit: a random operator's :meth:`Compressor.draw` takes a
``torch.Generator`` and returns its draws (RandK: the index set; PermK: the
permutation), and ``comp(x, draws)`` applies them. The same draws give the
same message on server and worker. Messages are built as
``(x * mask) * scale``, the reference's order of operations, so that with the
reference's own draws the result is bit-equal.

TopK and BlockTopK go through :func:`repro_torch.kernels.ops.block_topk`
(TopK with one block spanning x). On finite input that is exactly
``lax.top_k``'s first-index selection.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

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


def make_compressor(spec: str, *, d: int, n: int = 1, worker: int = 0) -> Compressor:
    """Parse a compressor spec string: ``identity``, ``topk:32``,
    ``block_topk:16:1024``, ``randk:32``, ``permk``."""
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
    raise ValueError(f"unknown or not yet ported compressor spec: {spec}")
