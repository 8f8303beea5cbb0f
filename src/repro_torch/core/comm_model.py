"""Communication accounting (Definitions 1 & 4 and Appendix A's bit model).

The paper measures server->worker (s2w, downlink) cost in bits per worker:

    bits_per_message(q) = (65 + log2(d)) * q

for a sparse message with q non-zeros (64 value bits + 1 sign bit +
log2(d) index bits). Dense full-precision broadcasts cost 64*d
(no index/sign overhead needed). Natural compression costs 9 bits/value.

These are *wire* costs for the federated WAN link the paper optimizes.
A copy of ``repro/core/comm_model.py`` (JAX-free there too), kept here so
that the port imports nothing of ``repro``.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class CommModel:
    d: int
    value_bits: int = 64

    def sparse_bits(self, q: float) -> float:
        """(65 + log2 d) * q  — sparse message with q non-zeros."""
        return (self.value_bits + 1 + math.log2(self.d)) * q

    def dense_bits(self) -> float:
        return float(self.value_bits * self.d)

    def natural_bits(self) -> float:
        return 9.0 * self.d


@dataclasses.dataclass
class CommLedger:
    """Per-worker running totals of s2w and w2s traffic in bits.

    s2w (downlink) is the compressed model broadcast the paper prices;
    w2s (uplink) is the worker->server gradient. Both EF21-P and MARINA-P
    send *exact* uplink gradients (Algorithms 1 & 2), so the uplink cost
    is one dense message per round — tracked here so rounds-to-eps plots
    can report total WAN traffic, not downlink only.
    """

    model: CommModel
    s2w_bits: float = 0.0
    w2s_bits: float = 0.0
    rounds: int = 0

    def log_s2w_sparse(self, q: float):
        self.s2w_bits += self.model.sparse_bits(q)

    def log_s2w_dense(self):
        self.s2w_bits += self.model.dense_bits()

    def log_w2s_sparse(self, q: float):
        self.w2s_bits += self.model.sparse_bits(q)

    def log_w2s_dense(self):
        self.w2s_bits += self.model.dense_bits()

    def tick(self):
        self.rounds += 1


# -- closed-form complexity predictions (Corollaries 1 & 2) -------------------


def ef21p_iteration_complexity(L0: float, R0_sq: float, alpha: float, eps: float) -> float:
    """T = O(L0^2 R0^2 / (alpha eps^2))   (19)."""
    return L0**2 * R0_sq / (alpha * eps**2)


def marina_p_iteration_complexity(
    L0_bar: float, L0_tilde: float, R0_sq: float, omega: float, d: int, zeta: float, eps: float
) -> float:
    """T = O(R0^2/eps^2 (Lbar^2 + Lbar Ltil sqrt(omega (d/zeta - 1))))   (29)."""
    return (
        R0_sq
        / eps**2
        * (L0_bar**2 + L0_bar * L0_tilde * (omega * (d / zeta - 1.0)) ** 0.5)
    )


def per_worker_comm_cost(d: int, zeta: float, T: float) -> float:
    """O(d + zeta T) floats per worker (Corollaries 1 & 2)."""
    return d + zeta * T
