"""Public wrappers of the kernels (port of ``repro/kernels/ops.py``).

Dispatch is by device (see :mod:`.runtime`): CPU tensors run the plain
PyTorch versions in :mod:`.ref`, CUDA tensors launch the Hopper kernels or
raise. The wrappers check dtype, shape and contiguity, and keep the
reference's padding rules:

* :func:`block_topk` zero-pads x to a multiple of ``block`` (the last block
  selects among its real values and the zeros) and trims the output to d;
* :func:`l1_subgrad` needs no padding: the reference pads A and x to
  (128, 128) tiles with zeros, which adds exactly zero to g, and the CUDA
  kernel handles ragged m and d itself;
* :func:`pack_bits` / :func:`unpack_bits` need no padding either: the
  reference pads the values (words) to word-aligned blocks with zeros and
  trims, the CUDA kernels guard the ragged tail themselves; the outputs are
  the reference's, ``ceil(n*width/32)`` words and ``count`` values.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import l1_subgrad as _l1
from . import pack as _pack
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


def _bit_rows(t: torch.Tensor, what: str) -> torch.Tensor:
    """A 1-D or 2-D int32 tensor of bit patterns as [rows, n] (a view)."""
    if t.dtype != torch.int32:
        raise TypeError(f"{what}: int32 tensors of uint32 bit patterns only, got {t.dtype}")
    if t.dim() not in (1, 2):
        raise ValueError(f"{what}: 1-D or 2-D tensors only, got shape {tuple(t.shape)}")
    t2 = t.unsqueeze(0) if t.dim() == 1 else t
    if t2.shape[1] > 1 and t2.stride(1) != 1:
        raise ValueError(f"{what}: tensors must have unit inner stride")
    return t2


def pack_bits(values: torch.Tensor, width: int, *, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pack the low ``width`` bits of each value, LSB-first, into 32-bit words
    (``wire/bitstream.py``'s layout), along the last axis. values: [n] or
    [rows, n] int32 holding uint32 patterns; returns [..., ceil(n*width/32)]
    int32, written into ``out`` where given (a view with unit inner stride)."""
    if not 1 <= width <= 32:
        raise ValueError(f"pack_bits: width {width} outside 1..32")
    v = _bit_rows(values, "pack_bits")
    nw = -(-v.shape[1] * width // 32)
    shape = values.shape[:-1] + (nw,)
    if out is None:
        out = torch.empty(shape, dtype=torch.int32, device=values.device)
    elif tuple(out.shape) != tuple(shape):
        raise ValueError(f"pack_bits: out has shape {tuple(out.shape)}, needs {tuple(shape)}")
    o = _bit_rows(out, "pack_bits out")
    if not runtime.on_cuda(v, o):
        o.copy_(ref.pack_bits_ref(v, width))
    elif nw and v.shape[0]:
        _pack.pack_bits_device(v, width, o)
    return out


def unpack_bits(words: torch.Tensor, width: int, count: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: ``count`` values of ``width`` bits from
    words [nw] or [rows, nw] (words past the end read as 0); int32."""
    if not 1 <= width <= 32:
        raise ValueError(f"unpack_bits: width {width} outside 1..32")
    if count < 0:
        raise ValueError(f"unpack_bits: count {count} < 0")
    w = _bit_rows(words, "unpack_bits")
    if not runtime.on_cuda(w):
        out = ref.unpack_bits_ref(w, width, count)
    else:
        out = torch.empty((w.shape[0], count), dtype=torch.int32, device=w.device)
        if count and w.shape[0]:
            _pack.unpack_bits_device(w, width, out)
    return out[0] if words.dim() == 1 else out
