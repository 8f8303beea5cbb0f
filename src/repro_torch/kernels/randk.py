"""Counter-hash Bernoulli sparsification (port of ``repro/kernels/randk.py``).

* :func:`hash_uniform` — the counter hash on the host in numpy: the SEED
  codec's BERN decode rematerializes its mask with it (``wire/seedonly.py``);
* :func:`keep_prob_constants` — the float32 constants the kernels and their
  plain versions share;
* :func:`bernk_compress` — the launcher of the CUDA kernel ``csrc/randk.cu``
  (the Pallas kernel ``_bernk_kernel``). It takes CUDA tensors only;
  :func:`repro_torch.kernels.ops.bernk` is the public, device-dispatching
  wrapper.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import runtime

_M1 = 2654435761
_M2 = 2246822519

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def hash_uniform(idx, seed: int, worker: int) -> np.ndarray:
    """Deterministic per-index uniform in [0, 1), float32; bit-equal to the
    reference's jnp version. 3-round xorshift-multiply of (seed, worker,
    index) in uint32 arithmetic (numpy arrays wrap mod 2**32), then
    ``float32(h) * 2**-32``."""
    h = np.asarray(idx).astype(np.uint32) * np.uint32(_M1)
    h = h ^ np.uint32(hash_salt(seed, worker))
    h = h ^ (h >> 15)
    h = h * np.uint32(_M2)
    h = h ^ (h >> 13)
    h = h * np.uint32(_M1)
    h = h ^ (h >> 16)
    return h.astype(np.float32) * np.float32(1.0 / 4294967296.0)


def hash_salt(seed: int, worker: int) -> int:
    """``seed mod 2**32 + worker * M2`` in uint32 arithmetic, as the
    reference's ``hash_uniform`` mixes them."""
    return (seed % (1 << 32) + (worker % (1 << 32)) * _M2) % (1 << 32)


def _f32(v) -> float:
    return float(np.float32(v))


def keep_prob_constants(keep_prob: float) -> tuple[float, float, float]:
    """(kp, recip, kpb) as Python floats, each exactly a float32:
    ``kp = float32(keep_prob)`` (the keep test is ``u < kp``),
    ``recip = float32(1) / kp`` (the f32 scale: XLA folds the Pallas body's
    ``x / keep_prob`` into ``x * recip``), and ``kpb = float32(bf16(kp))``
    (the bf16 path divides by it in f32; bf16 by round to nearest even)."""
    if not 0.0 < keep_prob <= 1.0:
        raise ValueError(f"keep_prob {keep_prob} outside (0, 1]")
    kp = np.float32(keep_prob)
    b = int(kp.view(np.uint32))
    kpb = np.uint32(((b + 0x7FFF + ((b >> 16) & 1)) >> 16) << 16).view(np.float32)
    return float(kp), _f32(np.float32(1.0) / kp), float(kpb)


def bernk_compress(x: torch.Tensor, *, keep_prob: float, seed: int, worker: int = 0) -> torch.Tensor:
    """x: [d] contiguous on the card, f32 or bf16. Returns the BernK message
    in x's dtype (see ``ref.bernk_ref``)."""
    kp, recip, kpb = keep_prob_constants(keep_prob)
    out = torch.empty_like(x)
    fn = runtime.function("randk", "bernk", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint,
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    err = fn(x.data_ptr(), out.data_ptr(), DTYPES[x.dtype], x.shape[0], hash_salt(seed, worker),
             kp, recip if x.dtype == torch.float32 else kpb, runtime.stream_ptr(x))
    runtime.check(err, "bernk")
    runtime.count_launch("bernk")
    return out
