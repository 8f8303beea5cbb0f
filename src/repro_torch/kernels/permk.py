"""Launchers of the CUDA kernel ``csrc/permk.cu``: the RotK update
``w + Q_i(delta)``, for one replica (:func:`rotk_apply`) or for the R
replicas of a leaf in one launch (:func:`rotk_apply_rows`, row i worker i).

Port of ``repro/kernels/permk.py`` (the Pallas kernel ``_rotk_apply_kernel``)
and of the reference downlink's vmap of it over the workers. The kernel moves
16-byte vectors of w, delta and out where the three share an alignment
(single values before the first aligned column and after the last whole
vector) and the leaf holds at least a block of vectors an SM (shorter leaves
run one value a thread), carries each vector's residue j mod n by adds, and
in the rows entry reads delta once for all rows. The rows entry also takes a
block map (``block = (chunk, stride, offset)``: one rank's block of a leaf
split over a mesh axis, block column t being leaf coordinate ``offset + (t //
chunk) * stride + t % chunk``; with a second level ``(chunk, stride, offset,
inner, ostride)`` the runs u = t // chunk come ``inner`` to a group,
``ostride`` apart: ``offset + (u // inner) * ostride + (u % inner) * stride
+ t % chunk``, a block cut on two dims), for which each vector computes its
residue from its column instead. Takes CUDA tensors only;
:func:`repro_torch.kernels.ops.rotk_apply` / :func:`~repro_torch.kernels.ops.rotk_apply_rows`
are the public, device-dispatching wrappers.
"""
from __future__ import annotations

import ctypes
from typing import Optional

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


def rotk_apply_rows(w: torch.Tensor, delta: torch.Tensor, rotation: torch.Tensor, *, n: int,
                    out: Optional[torch.Tensor] = None, block: Optional[tuple] = None) -> torch.Tensor:
    """w: [R, s] on the card with unit column stride (row stride 0 allowed);
    delta: [s] contiguous, same dtype; rotation: one int32 on the card; R <= n.
    Writes w[i] + Q_i(delta) into row i of ``out`` ([R, s], unit column stride,
    overlapping neither input; allocated if None) and returns it. ``block``:
    (chunk, stride, offset) of a rank's block of a leaf, or (chunk, stride,
    offset, inner, ostride) with a second level (None: the leaf)."""
    R, s = w.shape
    if out is None:
        out = torch.empty((R, s), dtype=w.dtype, device=w.device)
    args = [w.data_ptr(), w.stride(0), delta.data_ptr(), rotation.data_ptr(), out.data_ptr(),
            out.stride(0), DTYPES[w.dtype], R, s, n]
    types = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
    if block is None:
        fn = runtime.function("permk", "rotk_apply_rows", types + [ctypes.c_void_p])
    else:
        fn = runtime.function("permk", "rotk_apply_rows_map", types + [ctypes.c_longlong] * 5 + [ctypes.c_void_p])
        args += list(block) + [0, 0] * (len(block) == 3)
    err = fn(*args, runtime.stream_ptr(w))
    runtime.check(err, "rotk_apply_rows")
    runtime.count_launch("rotk_apply_rows")
    return out
