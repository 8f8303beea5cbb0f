"""Learning-rate schedules (port of ``repro/optim/schedules.py``).

A schedule maps the host's step count to a float32 learning rate, computed
on the host (a schedule costs the card nothing and no sync) exactly as XLA
computes the reference's jitted ``fn(step)``:

* a division by a constant becomes a product with its float32 reciprocal
  (XLA's algebraic simplifier rewrites ``x / c`` so);
* ``final + a * (1 + cos)`` is one fused multiply-add (LLVM contracts it);
* ``jnp.cos`` of a float32 is the C library's ``cosf`` (:mod:`.libm`);
* ``gamma0 / jnp.sqrt(s + 1)`` becomes ``gamma0 * rsqrt(s + 1)`` under
  ``jit``, and XLA's CPU ``rsqrt`` is an approximation of its own:
  :func:`inv_sqrt` divides by the correctly rounded square root, as the
  reference computes it op by op, and lies within 2 ulp of its jitted form.
"""
from __future__ import annotations

import math

import numpy as np

from .libm import cosf

F32 = np.float32


def _fma(a, b, c) -> np.float32:
    """a * b + c rounded once to float32 (the float64 product of two
    float32 values is exact)."""
    return F32(np.float64(a) * np.float64(b) + np.float64(c))


def constant_lr(lr: float):
    return lambda step: F32(lr)


def cosine_warmup(peak_lr: float, warmup: int, total: int, final_frac: float = 0.1):
    r_warm = F32(1) / F32(max(warmup, 1))
    r_decay = F32(1) / F32(max(total - warmup, 1))
    half_span = F32((1 - final_frac) * 0.5)
    peak = F32(peak_lr)

    def fn(step):
        s = F32(step)
        if s < F32(warmup):
            return F32(min(F32(s * r_warm), F32(1.0)) * peak)
        t = min(F32(1.0), max(F32(0.0), F32((s - F32(warmup)) * r_decay)))
        cos = cosf(t * F32(math.pi))
        return F32(_fma(F32(cos + F32(1.0)), half_span, F32(final_frac)) * peak)

    return fn


def inv_sqrt(gamma0: float):
    """The paper's decreasing schedule (15)/(25) as an LR schedule."""
    def fn(step):
        return F32(F32(gamma0) / np.sqrt(F32(step) + F32(1.0)))

    return fn


def make_schedule(spec: str, **kw):
    parts = spec.split(":")
    if parts[0] == "constant":
        return constant_lr(float(parts[1]))
    if parts[0] == "cosine":
        return cosine_warmup(float(parts[1]), int(kw.get("warmup", 100)), int(kw.get("total", 10000)))
    if parts[0] == "inv_sqrt":
        return inv_sqrt(float(parts[1]))
    raise ValueError(spec)
