"""Optimizers over flat fp32 vectors (port of ``repro/optim/optimizers.py``).

Pure-functional, as the reference: ``init(params) -> state``,
``update(grads, state, params, lr) -> (new_params, new_state)``, where
``params``, ``grads`` and the moments are tensors of one shape (the trainer
passes the whole model as one [d] vector in ravel order) and ``lr`` is a
float (a schedule's) or a 0-d tensor on the params' device (Polyak's).

The arithmetic is the reference's as XLA compiles it, bit for bit:

* ``b * m + (1 - b) * g`` is one FMA over ``m`` (``torch.add(.., alpha=b)``),
  ``p - lr * (step + wd * p)`` two (``wd * p + step``, then ``-lr * (...) + p``);
* AdamW's ``(m / bc1) / (sqrt(v / bc2) + eps)`` is ``m / (bc1 * (sqrt(v /
  bc2) + eps))``, XLA's rewrite; ``v / bc2`` divides by a tensor (torch on
  the card multiplies by the reciprocal of a Python-scalar divisor), and the
  square root is taken in float64 and rounded once (torch's CPU ``sqrt`` of a
  float32 is not correctly rounded; the card's is);
* ``b ** count`` is the C library's ``powf`` on the host (:mod:`.libm`), as
  XLA computes it (numpy's float32 power differs at counts 4, 6, ...).

``torch.optim.AdamW`` orders and rounds differently and is not used.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..core.stepsizes import descent_step
from .libm import powf

F32 = np.float32


def _zeros(params: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(params, dtype=torch.float32)


# -- SGD (+ momentum) ---------------------------------------------------------


def sgd_init(params, momentum: float = 0.0):
    return {"mu": _zeros(params)} if momentum else {}


def sgd_update(grads, state, params, lr, *, momentum: float = 0.0, weight_decay: float = 0.0):
    g = grads.float()
    if momentum:
        step_dir = torch.add(g, state["mu"], alpha=momentum)
        new_state = {"mu": step_dir}
    else:
        step_dir, new_state = g, {}
    new = descent_step(params.float(), lr, torch.add(step_dir, params.float(), alpha=weight_decay))
    return new.to(params.dtype), new_state


# -- AdamW --------------------------------------------------------------------


def adamw_init(params):
    return {"m": _zeros(params), "v": _zeros(params), "count": 0}


def adamw_update(grads, state, params, lr, *, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0):
    count = state["count"] + 1
    g = grads.float()
    m = torch.add(g * (1 - b1), state["m"], alpha=b1)
    v = torch.add((g * g) * (1 - b2), state["v"], alpha=b2)
    bc1 = F32(1) - powf(b1, count)
    bc2 = F32(1) - powf(b2, count)
    root = torch.sqrt((v / v.new_full((), float(bc2))).double()).float()
    step = m / ((root + eps) * float(bc1))
    p = params.float()
    new = descent_step(p, lr, torch.add(step, p, alpha=weight_decay))
    return new.to(params.dtype), {"m": m, "v": v, "count": count}


# -- registry -----------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params, lr) -> (params, state)
    name: str


def make_optimizer(spec: str, **kw) -> Optimizer:
    """``adamw``, ``sgd``, ``sgd:0.9`` (momentum)."""
    parts = spec.split(":")
    if parts[0] == "adamw":
        return Optimizer(
            init=adamw_init,
            update=lambda g, s, p, lr: adamw_update(g, s, p, lr, **kw),
            name="adamw",
        )
    if parts[0] == "sgd":
        mom = float(parts[1]) if len(parts) > 1 else kw.pop("momentum", 0.0)
        return Optimizer(
            init=lambda p: sgd_init(p, mom),
            update=lambda g, s, p, lr: sgd_update(g, s, p, lr, momentum=mom, **kw),
            name="sgd",
        )
    raise ValueError(spec)
