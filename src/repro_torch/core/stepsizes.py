"""Stepsize schedules of Theorems 1 & 2 (constant / decreasing / Polyak).

Port of ``repro/core/stepsizes.py``. A schedule is called as
``gamma_t = schedule(t, aux)``: Constant and Decreasing return a Python float
(the fp32 value the reference computes), the Polyak schedules a 0-dim tensor
on the device of ``aux``. The Polyak stepsizes (13)/(23) consume quantities
the algorithms already communicate (Remark 1): the averaged function values
and subgradients.

Formulas (paper equation numbers in brackets):

* EF21-P constant-optimal  (11):  gamma = sqrt(V0 / (B* L0^2)) / sqrt(T)
* EF21-P Polyak            (13):  gamma_t = (f(w^t) - f*) / (B* ||df(w^t)||^2)
* decreasing               (15):  gamma_t = gamma0 / sqrt(t+1)
* EF21-P decreasing-opt    (17):  gamma0 = sqrt(V0 / (2 B* L0^2 log(T+1)))
* MARINA-P constant-opt    (21):  gamma = sqrt(V0 / Btil*) / sqrt(T)
* MARINA-P Polyak          (23):  see :func:`marina_p_polyak`
* MARINA-P decreasing-opt  (27):  gamma0 = sqrt(V0 / (2 Btil* log(T+1)))

Theory constants:

* EF21-P:   B*    = 1 + 2 sqrt(1-alpha) / (1 - sqrt(1-alpha))        (Thm 1)
* MARINA-P: Btil* = Lbar0^2 + 2 Lbar0 Ltil0 sqrt((1-p) omega / p)    (Thm 2)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


# ---------------------------------------------------------------------------
# Theory constants
# ---------------------------------------------------------------------------


def ef21p_B_star(alpha: float) -> float:
    """B* = 1 + 2 sqrt(1-alpha)/(1-sqrt(1-alpha)); B* <= 4/alpha - 1."""
    r = (1.0 - alpha) ** 0.5
    if r == 0.0:
        return 1.0
    return 1.0 + 2.0 * r / (1.0 - r)


def marina_p_B_star(L0_bar: float, L0_tilde: float, omega: float, p: float) -> float:
    """Btil* = Lbar0^2 + 2 Lbar0 Ltil0 sqrt((1-p) omega / p)."""
    return L0_bar**2 + 2.0 * L0_bar * L0_tilde * ((1.0 - p) * omega / p) ** 0.5


def ef21p_lambda_star(alpha: float) -> float:
    """lambda* = sqrt(1-alpha)/(1-sqrt(1-alpha)) — Lyapunov weight (Thm 1)."""
    r = (1.0 - alpha) ** 0.5
    if r == 0.0:
        return 1e-12  # V^t degenerates to ||x-x*||^2; weight unused
    return r / (1.0 - r)


def marina_p_lambda_star(L0_bar: float, L0_tilde: float, omega: float, p: float) -> float:
    """lambda* = (Lbar0/Ltil0) sqrt((1-p) omega / p) — Lyapunov weight (Thm 2)."""
    val = (L0_bar / L0_tilde) * ((1.0 - p) * omega / p) ** 0.5
    return max(val, 1e-12)


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Stepsize:
    """Base: __call__(t, aux) -> gamma. ``aux`` carries Polyak quantities."""

    def __call__(self, t, aux: Optional[dict] = None):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Constant(Stepsize):
    gamma: float = 1e-2

    def __call__(self, t, aux=None):
        return float(torch.tensor(self.gamma, dtype=torch.float32))


@dataclasses.dataclass(frozen=True)
class Decreasing(Stepsize):
    """gamma_t = gamma0 / sqrt(t+1)   (15)/(25)."""

    gamma0: float = 1e-2

    def __call__(self, t, aux=None):
        # torch.div, not ``gamma0 / tensor``: PyTorch computes a scalar over a
        # tensor as reciprocal-times, which rounds twice
        g0 = torch.tensor(self.gamma0, dtype=torch.float32)
        return float(torch.div(g0, torch.sqrt(torch.tensor(t + 1.0, dtype=torch.float32))))


@dataclasses.dataclass(frozen=True)
class EF21PPolyak(Stepsize):
    """(13): gamma_t = factor * (f(w^t) - f*) / (B* ||df(w^t)||^2).

    aux must provide ``f_w`` (scalar f(w^t)) and ``g_norm_sq``
    (||(1/n) sum_i df_i(w^t)||^2). ``f_star`` defaults to 0 (true for the
    paper's L1 objective).
    """

    alpha: float = 1.0
    f_star: float = 0.0
    factor: float = 1.0

    def __call__(self, t, aux=None):
        B = ef21p_B_star(self.alpha)
        gap = torch.clamp_min(aux["f_w"] - self.f_star, 0.0)
        return self.factor * gap / (B * torch.clamp_min(aux["g_norm_sq"], 1e-30))


@dataclasses.dataclass(frozen=True)
class MarinaPPolyak(Stepsize):
    """(23): gamma_t = factor * (mean_i f_i(w_i^t) - f*) / denom with

    denom = ||g||^2 + 2 ||g|| sqrt(mean_i ||g_i||^2) sqrt((1-p) omega / p),
    g = (1/n) sum_i df_i(w_i^t).
    aux provides ``f_w`` (= mean_i f_i(w_i^t)), ``g_norm_sq`` and
    ``g_sq_mean`` (= mean_i ||g_i||^2).
    """

    omega: float = 0.0
    p: float = 1.0
    f_star: float = 0.0
    factor: float = 1.0

    def __call__(self, t, aux=None):
        c = ((1.0 - self.p) * self.omega / self.p) ** 0.5
        gnorm = torch.sqrt(torch.clamp_min(aux["g_norm_sq"], 1e-30))
        denom = aux["g_norm_sq"] + 2.0 * gnorm * torch.sqrt(
            torch.clamp_min(aux["g_sq_mean"], 1e-30)
        ) * c
        gap = torch.clamp_min(aux["f_w"] - self.f_star, 0.0)
        return self.factor * gap / torch.clamp_min(denom, 1e-30)


def descent_step(x: torch.Tensor, gamma, g: torch.Tensor) -> torch.Tensor:
    """x - gamma * g rounded once, as a fused multiply-add.

    XLA fuses the reference's ``x - gamma * g`` into an FMA; rounding the
    product separately moves x by an ulp, which is enough to break the exact
    ties of |x - w| that the paper's tridiagonal problem produces and so to
    change TopK's selection. ``gamma`` is a float or a 0-dim tensor."""
    if isinstance(gamma, torch.Tensor):
        return torch.addcmul(x, g, -gamma)
    return torch.sub(x, g, alpha=gamma)


# ---------------------------------------------------------------------------
# Optimal-constant helpers (used by benchmarks to set theory stepsizes)
# ---------------------------------------------------------------------------


def ef21p_optimal_constant(V0: float, L0: float, alpha: float, T: int) -> float:
    """(11): gamma = sqrt(V0 / (B* L0^2)) / sqrt(T)."""
    B = ef21p_B_star(alpha)
    return (V0 / (B * L0**2)) ** 0.5 / T**0.5


def ef21p_optimal_decreasing_gamma0(V0: float, L0: float, alpha: float, T: int) -> float:
    """(17): gamma0 = sqrt(V0 / (2 B* L0^2 log(T+1)))."""
    B = ef21p_B_star(alpha)
    return (V0 / (2.0 * B * L0**2 * math.log(T + 1.0))) ** 0.5


def marina_p_optimal_constant(
    V0: float, L0_bar: float, L0_tilde: float, omega: float, p: float, T: int
) -> float:
    """(21): gamma = sqrt(V0 / Btil*) / sqrt(T)."""
    B = marina_p_B_star(L0_bar, L0_tilde, omega, p)
    return (V0 / B) ** 0.5 / T**0.5


def marina_p_optimal_decreasing_gamma0(
    V0: float, L0_bar: float, L0_tilde: float, omega: float, p: float, T: int
) -> float:
    """(27): gamma0 = sqrt(V0 / (2 Btil* log(T+1)))."""
    B = marina_p_B_star(L0_bar, L0_tilde, omega, p)
    return (V0 / (2.0 * B * math.log(T + 1.0))) ** 0.5


def make_stepsize(spec: str, **kw) -> Stepsize:
    """Registry: ``constant:0.01``, ``decreasing:0.1``, ``polyak_ef21p``,
    ``polyak_marina_p``."""
    parts = spec.split(":")
    kind = parts[0]
    if kind == "constant":
        return Constant(gamma=float(parts[1]) if len(parts) > 1 else kw.get("gamma", 1e-2))
    if kind == "decreasing":
        return Decreasing(gamma0=float(parts[1]) if len(parts) > 1 else kw.get("gamma0", 1e-2))
    if kind == "polyak_ef21p":
        return EF21PPolyak(
            alpha=kw.get("alpha", 1.0),
            f_star=kw.get("f_star", 0.0),
            factor=kw.get("factor", 1.0),
        )
    if kind == "polyak_marina_p":
        return MarinaPPolyak(
            omega=kw.get("omega", 0.0),
            p=kw.get("p", 1.0),
            f_star=kw.get("f_star", 0.0),
            factor=kw.get("factor", 1.0),
        )
    raise ValueError(f"unknown stepsize spec: {spec}")
