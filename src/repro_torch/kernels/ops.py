"""Public wrappers of the kernels (port of ``repro/kernels/ops.py``).

Dispatch is by device (see :mod:`.runtime`): CPU tensors run the plain
PyTorch versions in :mod:`.ref`, CUDA tensors launch the Hopper kernels or
raise. The wrappers check dtype, shape and contiguity, and keep the
reference's padding rules:

* :func:`block_topk` zero-pads x to a multiple of ``block`` (the last block
  selects among its real values and the zeros) and trims the output to d;
* :func:`l1_subgrad` needs no padding: the reference pads A and x to
  (128, 128) tiles with zeros, which adds exactly zero to g, and the CUDA
  kernel handles ragged m and d itself.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import l1_subgrad as _l1
from . import ref, runtime
from . import topk as _topk


def _pad_to(x: torch.Tensor, mult: int):
    d = x.shape[-1]
    pad = (-d) % mult
    return (F.pad(x, (0, pad)), d) if pad else (x, d)


def block_topk(x: torch.Tensor, *, k_per_block: int, block: int = 1024) -> torch.Tensor:
    """Keep the ``k_per_block`` largest |x| of every contiguous block of
    ``block`` values (first index on ties, Pallas NaN/inf semantics, see
    :func:`.ref.block_topk_ref`). x: [d] f32/bf16."""
    if x.dim() != 1:
        raise ValueError(f"block_topk: x must be 1-D, got shape {tuple(x.shape)}")
    if x.dtype not in _topk.DTYPES:
        raise TypeError(f"block_topk: dtype {x.dtype} not in {list(_topk.DTYPES)}")
    if not 0 < block <= _topk.MAX_BLOCK:
        raise ValueError(
            f"block_topk: block={block} outside 1..{_topk.MAX_BLOCK}: a block's |x| and keep "
            f"flags must fit the {runtime.MAX_SMEM_BYTES}-byte (227 KB) shared-memory limit")
    if x.shape[0] > 1 and x.stride(0) != 1:
        raise ValueError("block_topk: x must be contiguous")
    xp, d = _pad_to(x, block)
    if xp.shape[0] == 0:
        return x.clone()
    if runtime.on_cuda(xp):
        out = _topk.block_topk_compress(xp, k_per_block=k_per_block, block=block)
    else:
        out = ref.block_topk_ref(xp, k_per_block=k_per_block, block=block)
    return out[:d]


def l1_subgrad(A: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """g = A^T sign(A x), sign(0) = +1. A: [m, d] with x: [d] -> [d], or
    batched A: [n, m, d] with X: [n, d] -> [n, d]. fp32 only; A contiguous,
    X with unit inner stride (a row stride of 0, from ``x.expand(n, d)``,
    is accepted)."""
    if A.dim() == 2:
        if X.dim() != 1:
            raise ValueError(f"l1_subgrad: A [m, d] needs x [d], got {tuple(X.shape)}")
        return l1_subgrad(A.unsqueeze(0), X.unsqueeze(0))[0]
    if A.dim() != 3 or X.dim() != 2 or X.shape != (A.shape[0], A.shape[2]):
        raise ValueError(
            f"l1_subgrad: shapes A {tuple(A.shape)} and X {tuple(X.shape)} are not [n, m, d], [n, d]")
    if A.dtype != torch.float32 or X.dtype != torch.float32:
        raise TypeError(f"l1_subgrad: float32 only, got {A.dtype} and {X.dtype}")
    n, m, d = A.shape
    if ref.rows_per_block(d) * (d + 1) * 4 > runtime.MAX_SMEM_BYTES:
        raise ValueError(
            f"l1_subgrad: one row of d={d} does not fit the {runtime.MAX_SMEM_BYTES}-byte "
            "(227 KB) shared-memory limit")
    if not runtime.on_cuda(A, X):
        return ref.l1_subgrad_ref(A, X)
    if not A.is_contiguous():
        raise ValueError("l1_subgrad: A must be contiguous")
    if d > 1 and X.stride(1) != 1:
        raise ValueError("l1_subgrad: X must have unit inner stride")
    if n == 0 or m == 0 or d == 0:
        return torch.zeros((n, d), dtype=torch.float32, device=A.device)
    return _l1.l1_subgrad(A, X)
