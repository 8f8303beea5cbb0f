"""Launcher of the CUDA kernel ``csrc/topk.cu``: block-local magnitude top-k.

Port of ``repro/kernels/topk.py`` (the Pallas kernel ``_topk_block_kernel``).
Takes CUDA tensors only; :func:`repro_torch.kernels.ops.block_topk` is the
public, device-dispatching wrapper.
"""
from __future__ import annotations

import ctypes

import torch

from . import runtime

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# A block keeps |x| in fp32 and one keep flag per element in dynamic shared
# memory; 1 KB of the 227 KB stays for the kernel's static reduction scratch.
SMEM_BYTES_PER_ELEM = 5
MAX_BLOCK = (runtime.MAX_SMEM_BYTES - 1024) // SMEM_BYTES_PER_ELEM  # 46284 elements


def block_topk_compress(x: torch.Tensor, *, k_per_block: int, block: int) -> torch.Tensor:
    """x: [d] contiguous on the card, d % block == 0, dtype f32/bf16.
    Returns the sparsified vector in x's dtype (dense layout)."""
    d = x.shape[-1]
    out = torch.empty_like(x)
    fn = runtime.function("topk", "block_topk", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p])
    err = fn(x.data_ptr(), out.data_ptr(), DTYPES[x.dtype], d // block, block,
             min(k_per_block, block), runtime.stream_ptr(x))
    runtime.check(err, "block_topk")
    runtime.count_launch("block_topk")
    return out
