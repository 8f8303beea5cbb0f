"""Launcher of the CUDA kernel ``csrc/permk.cu``: the RotK update
``w + Q_i(delta)``.

Port of ``repro/kernels/permk.py`` (the Pallas kernel ``_rotk_apply_kernel``).
Takes CUDA tensors only; :func:`repro_torch.kernels.ops.rotk_apply` is the
public, device-dispatching wrapper.
"""
from __future__ import annotations

import ctypes

import torch

from . import runtime

# the kernel's dtype codes
DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def rotk_apply(w: torch.Tensor, delta: torch.Tensor, rotation: torch.Tensor, *, n: int,
               worker: int) -> torch.Tensor:
    """w, delta: [d] contiguous on the card, both f32, f16 or bf16; rotation:
    one int32 on the card, read by the kernel (no host sync). Returns
    w + Q_worker(delta)."""
    out = torch.empty_like(w)
    fn = runtime.function("permk", "rotk_apply", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    err = fn(w.data_ptr(), delta.data_ptr(), rotation.data_ptr(), out.data_ptr(), DTYPES[w.dtype],
             w.shape[0], n, worker, runtime.stream_ptr(w))
    runtime.check(err, "rotk_apply")
    runtime.count_launch("rotk_apply")
    return out
