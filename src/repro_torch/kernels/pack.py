"""Launchers of the CUDA kernels ``csrc/pack.cu``: wire bit packing.

Port of ``repro/kernels/pack.py`` (the Pallas kernels ``_pack_kernel`` and
``_unpack_kernel``). Takes CUDA tensors only;
:func:`repro_torch.kernels.ops.pack_bits` / :func:`~repro_torch.kernels.ops.unpack_bits`
are the public, device-dispatching wrappers.
"""
from __future__ import annotations

import ctypes

import torch

from . import runtime

_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def pack_bits_device(values: torch.Tensor, width: int, out: torch.Tensor) -> torch.Tensor:
    """values: [rows, n] int32 (uint32 patterns) on the card, unit inner
    stride; out: [rows, ceil(n*width/32)] int32, unit inner stride, written
    in place and returned."""
    rows, n = values.shape
    fn = runtime.function("pack", "pack_bits", _ARGS)
    err = fn(values.data_ptr(), values.stride(0), n, width, out.data_ptr(), out.stride(0),
             out.shape[1], rows, runtime.stream_ptr(values))
    runtime.check(err, "pack_bits")
    runtime.count_launch("pack_bits")
    return out


def unpack_bits_device(words: torch.Tensor, width: int, out: torch.Tensor) -> torch.Tensor:
    """words: [rows, nw] int32 on the card, unit inner stride; out: [rows,
    count] int32, unit inner stride, written in place and returned."""
    rows, nw = words.shape
    fn = runtime.function("pack", "unpack_bits", _ARGS)
    err = fn(words.data_ptr(), words.stride(0), nw, width, out.data_ptr(), out.stride(0),
             out.shape[1], rows, runtime.stream_ptr(words))
    runtime.check(err, "unpack_bits")
    runtime.count_launch("unpack_bits")
    return out
