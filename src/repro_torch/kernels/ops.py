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
  the reference's, ``ceil(n*width/32)`` words and ``count`` values;
* :func:`bernk` and :func:`rotk_apply` take no ``block``: both kernels index
  globally, so the reference's output does not depend on its tile, and its
  zero padding is trimmed away; :func:`rotk_apply_rows` is the reference
  downlink's vmap of ``rotk_apply`` over the workers, one launch a leaf.

Under an open op count (the dry-run's, :mod:`repro_torch.launch.op_cost`) each
wrapper charges its kernel's analytic bytes and FLOPs once
(:func:`.runtime.kernel_cost`), on every device.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import l1_subgrad as _l1
from . import pack as _pack
from . import permk as _permk
from . import randk as _randk
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
            f"block_topk: block={block} outside 1..{_topk.MAX_BLOCK}: a block's keys "
            f"must fit the {runtime.MAX_SMEM_BYTES}-byte (227 KB) shared-memory limit")
    if x.shape[0] > 1 and x.stride(0) != 1:
        raise ValueError("block_topk: x must be contiguous")
    xp, d = _pad_to(x, block)
    if xp.shape[0] == 0:
        return x.clone()
    with runtime.kernel_cost("block_topk", 2 * xp.numel() * xp.element_size()):
        if runtime.on_cuda(xp):
            out = _topk.block_topk_compress(xp, k_per_block=k_per_block, block=block)
        else:
            out = ref.block_topk_ref(xp, k_per_block=k_per_block, block=block)
    return out[:d]


def bernk(x: torch.Tensor, *, keep_prob: float, seed: int, worker: int = 0) -> torch.Tensor:
    """Keep x[j] where the counter hash of (seed, worker, j) is below
    ``keep_prob``, scaled by 1/keep_prob as the reference kernel computes it
    (see :func:`.ref.bernk_ref`); the rest +0.0. x: [d] f32/bf16."""
    if x.dim() != 1:
        raise ValueError(f"bernk: x must be 1-D, got shape {tuple(x.shape)}")
    if x.dtype not in _randk.DTYPES:
        raise TypeError(f"bernk: dtype {x.dtype} not in {list(_randk.DTYPES)}")
    if x.shape[0] > 1 and x.stride(0) != 1:
        raise ValueError("bernk: x must be contiguous")
    _randk.keep_prob_constants(keep_prob)  # raises outside (0, 1]
    if x.shape[0] == 0:
        return x.clone()
    with runtime.kernel_cost("bernk", 2 * x.numel() * x.element_size()):
        if not runtime.on_cuda(x):
            return ref.bernk_ref(x, keep_prob=keep_prob, seed=seed, worker=worker)
        return _randk.bernk_compress(x, keep_prob=keep_prob, seed=seed, worker=worker)


def rotk_apply(w: torch.Tensor, delta: torch.Tensor, rotation: torch.Tensor, *, n: int,
               worker: int) -> torch.Tensor:
    """w + Q_worker(delta) of RotK: n * delta on the coordinates j with
    j mod n == (worker + r) mod n, w elsewhere (see :func:`.ref.rotk_apply_ref`).
    w, delta: [d] of one dtype, f32, f16 or bf16 (these round the product,
    then the sum, to their dtype); rotation: a one-element int32 tensor r on
    the same device (the card reads it there, with no host sync)."""
    if w.dim() != 1 or delta.shape != w.shape:
        raise ValueError(f"rotk_apply: w and delta must be [d], got {tuple(w.shape)} and "
                         f"{tuple(delta.shape)}")
    _check_rotk("rotk_apply", w, delta, rotation, n)
    if w.shape[0] > 1 and (w.stride(0) != 1 or delta.stride(0) != 1):
        raise ValueError("rotk_apply: w and delta must be contiguous")
    if w.shape[0] == 0:
        return w.clone()
    with runtime.kernel_cost("rotk_apply", 3 * w.numel() * w.element_size()):
        if not runtime.on_cuda(w, delta, rotation):
            return ref.rotk_apply_ref(w, delta, rotation, n=n, worker=worker)
        return _permk.rotk_apply(w, delta, rotation, n=n, worker=worker)


def _check_rotk(what: str, w: torch.Tensor, delta: torch.Tensor, rotation: torch.Tensor, n: int):
    if w.dtype not in _permk.DTYPES or delta.dtype != w.dtype:
        raise TypeError(f"{what}: w and delta must share one dtype of {list(_permk.DTYPES)}, "
                        f"got {w.dtype} and {delta.dtype}")
    if rotation.dtype != torch.int32 or rotation.numel() != 1:
        raise TypeError(f"{what}: rotation must be one int32, got {rotation.dtype} "
                        f"{tuple(rotation.shape)}")
    if n < 1:
        raise ValueError(f"{what}: n={n} < 1")


def rotk_apply_rows(w: torch.Tensor, delta: torch.Tensor, rotation: torch.Tensor, *, n: int,
                    out: Optional[torch.Tensor] = None, block: Optional[tuple] = None) -> torch.Tensor:
    """Row i of the result is ``rotk_apply(w[i], delta, rotation, n=n,
    worker=i)``: the R <= n replicas of one leaf updated in one launch, delta
    read once (see :func:`.ref.rotk_apply_rows_ref`). w: [R, s] with unit
    column stride and any row stride (0: one row broadcast); delta: [s]
    contiguous, w's dtype (f32, f16 or bf16); rotation: one int32 on the same
    device. ``out``: an [R, s] view with unit column stride, overlapping
    neither input, written in place and returned (the caller's slice of a
    larger tensor: no temporary, no copy); a new tensor if None. ``block``:
    (chunk, stride, offset) where the s columns are one rank's block of a leaf
    split over a mesh axis: column t is leaf coordinate ``offset + (t //
    chunk) * stride + t % chunk``, which the kept rule reads (1 <= chunk <=
    stride, offset + chunk <= stride, s a multiple of chunk); None, or
    (s, s, 0), is the leaf itself."""
    if w.dim() != 2 or delta.dim() != 1 or delta.shape[0] != w.shape[1]:
        raise ValueError(f"rotk_apply_rows: w must be [R, s] and delta [s], got {tuple(w.shape)} "
                         f"and {tuple(delta.shape)}")
    _check_rotk("rotk_apply_rows", w, delta, rotation, n)
    R, s = w.shape
    if R > n:
        raise ValueError(f"rotk_apply_rows: {R} rows > n={n}: row i is worker i < n")
    if s > 1 and (w.stride(1) != 1 or delta.stride(0) != 1):
        raise ValueError("rotk_apply_rows: w needs unit column stride and delta must be contiguous")
    if out is not None:
        if out.shape != w.shape or out.dtype != w.dtype or out.device != w.device:
            raise ValueError(f"rotk_apply_rows: out must be [R, s] {w.dtype} on {w.device}, got "
                             f"{tuple(out.shape)} {out.dtype} on {out.device}")
        if s > 1 and out.stride(1) != 1:
            raise ValueError("rotk_apply_rows: out needs unit column stride")
    if block is not None:
        chunk, stride, offset = (int(v) for v in block)
        if not (1 <= chunk <= stride and 0 <= offset and offset + chunk <= stride and s % chunk == 0):
            raise ValueError(f"rotk_apply_rows: block (chunk, stride, offset) = {tuple(block)} does not map "
                             f"{s} columns into a leaf")
        block = None if (chunk, stride, offset) == (s, s, 0) else (chunk, stride, offset)
    if R == 0 or s == 0:
        return torch.empty_like(w) if out is None else out
    rows_read = 1 if w.stride(0) == 0 else R  # (2R + 1) values a column; a broadcast row once
    with runtime.kernel_cost("rotk_apply_rows", (rows_read + R + 1) * s * w.element_size()):
        if not runtime.on_cuda(w, delta, rotation):
            res = ref.rotk_apply_rows_ref(w, delta, rotation, n=n, block=block)
            return res if out is None else out.copy_(res)
        return _permk.rotk_apply_rows(w, delta, rotation, n=n, out=out, block=block)


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
    with runtime.kernel_cost("l1_subgrad", 4 * (n * m * d + 2 * n * d), 4 * n * m * d):
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
    with runtime.kernel_cost("pack_bits", 4 * v.shape[0] * (v.shape[1] + nw)):
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
    with runtime.kernel_cost("unpack_bits", 4 * w.shape[0] * (w.shape[1] + count)):
        if not runtime.on_cuda(w):
            out = ref.unpack_bits_ref(w, width, count)
        else:
            out = torch.empty((w.shape[0], count), dtype=torch.int32, device=w.device)
            if count and w.shape[0]:
                _pack.unpack_bits_device(w, width, out)
    return out[0] if words.dim() == 1 else out
