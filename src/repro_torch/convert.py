"""Carry the JAX reference's problem and states into the port.

The arguments are numpy arrays (``np.asarray`` of the reference's jax
arrays), so this module needs neither JAX nor ``repro``.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.ef21p import EF21PState
from .core.marina_p import MarinaPState
from .core.problems import L1Problem
from .kernels.runtime import resolve_device


def _f32(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)  # a writable copy


def problem_from_numpy(A, x0, L0i, sigma_A: float, device="cuda") -> L1Problem:
    dev = resolve_device(device)
    return L1Problem(A=_f32(A, dev), x0=_f32(x0, dev), L0i=_f32(L0i, dev), sigma_A=float(sigma_A))


def marina_p_state_from_numpy(x, W, t, device="cuda") -> MarinaPState:
    dev = resolve_device(device)
    return MarinaPState(x=_f32(x, dev), W=_f32(W, dev), t=int(t))


def ef21p_state_from_numpy(x, w, t, device="cuda") -> EF21PState:
    dev = resolve_device(device)
    return EF21PState(x=_f32(x, dev), w=_f32(w, dev), t=int(t))
