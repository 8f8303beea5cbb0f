"""Launcher of the CUDA kernel ``csrc/l1_subgrad.cu``: G = A^T sign(A x) per worker.

Port of ``repro/kernels/l1_subgrad.py`` (the Pallas kernel
``_l1_subgrad_kernel``). Takes CUDA tensors only; :func:`repro_torch.kernels.ops.l1_subgrad`
is the public, device-dispatching wrapper.
"""
from __future__ import annotations

import ctypes

import torch

from . import runtime
from .ref import rows_per_block


def l1_subgrad(A: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """A: [n, m, d] f32 contiguous on the card; X: [n, d] f32 with unit inner
    stride and any row stride (0 for one point shared by all workers).
    Returns G: [n, d] f32."""
    n, m, d = A.shape
    R = rows_per_block(d)
    nrb = -(-m // R)
    partial = torch.empty((n, nrb, d), dtype=torch.float32, device=A.device)
    G = torch.empty((n, d), dtype=torch.float32, device=A.device)
    fn = runtime.function("l1_subgrad", "l1_subgrad_f32", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    err = fn(A.data_ptr(), X.data_ptr(), X.stride(0), partial.data_ptr(), G.data_ptr(),
             n, m, d, R, runtime.stream_ptr(A))
    runtime.check(err, "l1_subgrad")
    runtime.count_launch("l1_subgrad")
    return G
