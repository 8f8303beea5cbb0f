"""Plain PyTorch versions of the kernels (port of ``repro/kernels/ref.py``).

The wrappers in :mod:`.ops` run these for CPU tensors; ``chip_smoke.py`` holds
each CUDA kernel against them on the card.
"""
from __future__ import annotations

import torch


# Rows of A one block of the CUDA kernel stages in shared memory: as many as
# fit 48 KB (no opt-in needed), at most 32; one row needs 4*d bytes.
TILE_BYTES = 48 * 1024
MAX_ROWS = 32


def rows_per_block(d: int) -> int:
    return max(1, min(MAX_ROWS, TILE_BYTES // (4 * d)))


def l1_subgrad_ref(A: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """g = A^T sign(A x) with sign(0) = +1 and sign(NaN) = -1.

    A: [m, d] with x: [d], or batched A: [n, m, d] with X: [n, d].

    The sum over rows is taken in the CUDA kernel's order: within each block
    of R = rows_per_block(d) rows in row order, then over the blocks in
    order. Where the signs agree, the result is then bit-equal to the
    kernel's on any device, so a CPU run and a card run see the same g. (On
    the paper's problem g has many coordinates that are tiny rounding
    residues, and whether a message coordinate is exactly zero, which the
    bit ledger counts, depends on their last bits.)
    """
    if A.dim() == 2:
        return l1_subgrad_ref(A.unsqueeze(0), X.unsqueeze(0))[0]
    n, m, d = A.shape
    s = torch.where(torch.matmul(A, X.unsqueeze(-1)) >= 0, 1.0, -1.0).to(A.dtype)  # [n, m, 1]
    R = rows_per_block(d)
    G = torch.zeros((n, d), dtype=A.dtype, device=A.device)
    for r0 in range(0, m, R):
        part = s[:, r0] * A[:, r0]
        for r in range(r0 + 1, min(r0 + R, m)):
            part = part + s[:, r] * A[:, r]
        G = G + part
    return G


def block_topk_ref(x: torch.Tensor, *, k_per_block: int, block: int) -> torch.Tensor:
    """Per-block magnitude top-k with the Pallas kernel's arithmetic.

    Mirrors ``repro/kernels/topk.py::_topk_block_kernel`` operation for
    operation, not ``lax.top_k``: k rounds of a NaN-propagating block max,
    the first index among the maxima, then ``remaining*(1-sel) - sel``. On
    finite input this is ``lax.top_k``'s first-index selection. Once a NaN
    sits in ``remaining`` (a NaN input, or an inf that was selected, since
    ``inf*0`` is NaN) the max is NaN, no index equals it and no further
    coordinate is kept. ``x``: [d] with d % block == 0; output in x's dtype,
    kept coordinates bit-exact and the rest +0.0.
    """
    d = x.shape[-1]
    if d % block:
        raise ValueError(f"d={d} is not a multiple of block={block}")
    xb = x.reshape(-1, block)
    remaining = xb.abs().to(torch.float32)
    idx = torch.arange(block, device=x.device)
    keep = torch.zeros(xb.shape, dtype=torch.bool, device=x.device)
    for _ in range(min(k_per_block, block)):  # rounds past b repeat the last: no-ops
        m = remaining.amax(dim=-1, keepdim=True)
        first = torch.where(remaining == m, idx, block).amin(dim=-1, keepdim=True)
        sel = idx == first
        sel_f = sel.to(torch.float32)
        remaining = remaining * (1.0 - sel_f) - sel_f
        keep |= sel
    return torch.where(keep, xb, torch.zeros((), dtype=x.dtype, device=x.device)).reshape(d)
