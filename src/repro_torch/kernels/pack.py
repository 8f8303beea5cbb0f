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
_INT_MAX = 2**31 - 1  # the kernels take counts and word counts as C int


def _check_sizes(what: str, *sizes: int) -> None:
    """ctypes would cut a count past INT_MAX silently: refuse it instead
    (d = 999,812,736, the largest vector the serving path decodes, fits)."""
    if max(sizes) > _INT_MAX:
        raise ValueError(f"{what}: sizes {sizes} exceed the kernel's int range ({_INT_MAX})")


def pack_bits_device(values: torch.Tensor, width: int, out: torch.Tensor) -> torch.Tensor:
    """values: [rows, n] int32 (uint32 patterns) on the card, unit inner
    stride; out: [rows, ceil(n*width/32)] int32, unit inner stride, written
    in place and returned."""
    rows, n = values.shape
    _check_sizes("pack_bits", n, out.shape[1], rows)
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
    _check_sizes("unpack_bits", nw, out.shape[1], rows)
    fn = runtime.function("pack", "unpack_bits", _ARGS)
    err = fn(words.data_ptr(), words.stride(0), nw, width, out.data_ptr(), out.stride(0),
             out.shape[1], rows, runtime.stream_ptr(words))
    runtime.check(err, "unpack_bits")
    runtime.count_launch("unpack_bits")
    return out
