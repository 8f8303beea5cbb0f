"""The paper's experimental workload (Section 5 / Appendix A), on tensors.

Port of ``repro/core/problems.py``. Non-smooth convex finite-sum
f(x) = (1/n) sum_i f_i(x), f_i(x) = ||A_i x||_1 with symmetric A_i in R^{dxd};
x* = 0, f(x*) = 0; df_i(x) = A_i^T sign(A_i x) with sign(0) = +1 (eq. 32).

The subgradient oracles go through :func:`repro_torch.kernels.ops.l1_subgrad`
(the hand-written kernel on the card, its plain version on the CPU). The
function values stay plain ``torch.matmul``, as the reference leaves them to
XLA outside any kernel. Algorithm 3's datagen is the reference's numpy code
verbatim, so A, x0, L0i and sigma_A are bit-equal to the JAX package's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import ops
from ..kernels.runtime import resolve_device


def paper_sign(x: torch.Tensor) -> torch.Tensor:
    """Componentwise sign with sign(0) = sign(-0.0) = +1 (paper eq. 32) and
    sign(NaN) = -1, as the reference's ``jnp.where(x >= 0, 1, -1)``."""
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class L1Problem:
    """Worker matrices A: [n, d, d] plus Lipschitz metadata, on one device."""

    A: torch.Tensor  # [n, d, d]
    x0: torch.Tensor  # [d]
    L0i: torch.Tensor  # [n] spectral norms
    sigma_A: float

    @property
    def n(self) -> int:
        return self.A.shape[0]

    @property
    def d(self) -> int:
        return self.A.shape[1]

    @property
    def device(self) -> torch.device:
        return self.A.device

    @property
    def L0(self) -> float:
        return float(torch.mean(self.L0i))

    @property
    def L0_tilde(self) -> float:
        return float(torch.sqrt(torch.mean(self.L0i**2)))

    def to(self, device) -> "L1Problem":
        dev = resolve_device(device)
        return L1Problem(A=self.A.to(dev), x0=self.x0.to(dev), L0i=self.L0i.to(dev),
                         sigma_A=self.sigma_A)

    # -- oracles --------------------------------------------------------------

    def f_i(self, i: int, x: torch.Tensor) -> torch.Tensor:
        return torch.sum(torch.abs(self.A[i] @ x))

    def f_all(self, xs: torch.Tensor) -> torch.Tensor:
        """f_i(x_i) for per-worker points xs: [n, d] -> [n]."""
        return torch.sum(torch.abs(torch.matmul(self.A, xs.unsqueeze(-1)).squeeze(-1)), dim=-1)

    def f(self, x: torch.Tensor) -> torch.Tensor:
        """Global objective at a single point x: [d]."""
        return torch.mean(torch.sum(torch.abs(self.A @ x), dim=-1))

    def subgrad_i(self, i: int, x: torch.Tensor) -> torch.Tensor:
        return ops.l1_subgrad(self.A[i], x)

    def subgrad_all(self, xs: torch.Tensor) -> torch.Tensor:
        """df_i(x_i) for per-worker points xs: [n, d] -> [n, d]."""
        return ops.l1_subgrad(self.A, xs)

    def subgrad(self, x: torch.Tensor) -> torch.Tensor:
        """df(x) = (1/n) sum_i df_i(x) at a shared point x: [d]."""
        return torch.mean(ops.l1_subgrad(self.A, x.expand(self.n, self.d)), dim=0)

    @property
    def f_star(self) -> float:
        return 0.0

    @property
    def R0_sq(self) -> float:
        return float(torch.sum(self.x0**2))


def _tridiag(d: int) -> np.ndarray:
    m = 2.0 * np.eye(d) - np.eye(d, k=1) - np.eye(d, k=-1)
    return m / 4.0


def algorithm3(
    *, n: int, d: int, noise_scale: float, seed: int = 0, mu: float = 1e-6
) -> tuple[np.ndarray, np.ndarray]:
    """Algorithm 3's A [n, d, d] and x0 [d] on the host, in float64, as
    :func:`generate_problem` draws them before placing them on its device."""
    rng = np.random.default_rng(seed)
    base = _tridiag(d)
    nus = 1.0 + noise_scale * rng.standard_normal(n)
    A = np.stack([nu * base for nu in nus])  # [n, d, d]
    Abar = A.mean(axis=0)
    lam_min = float(np.linalg.eigvalsh(Abar).min())
    A = A + (mu - lam_min) * np.eye(d)[None]
    x0 = rng.standard_normal(d)
    return A, x0


def generate_problem(
    *, n: int, d: int, noise_scale: float, seed: int = 0, mu: float = 1e-6, device="cuda"
) -> L1Problem:
    """Algorithm 3 of the paper (synthetic dataset generation), placed on
    ``device``. The default ``"cuda"`` raises where no card is present."""
    dev = resolve_device(device)
    A, x0 = algorithm3(n=n, d=d, noise_scale=noise_scale, seed=seed, mu=mu)
    # spectral norms (symmetric => max |eig|); tridiagonal Toeplitz-like but
    # after shift no longer exactly Toeplitz — compute numerically.
    L0i = np.array([np.abs(np.linalg.eigvalsh(Ai)).max() for Ai in A])
    return L1Problem(
        A=torch.as_tensor(A, dtype=torch.float32).to(dev),
        x0=torch.as_tensor(x0, dtype=torch.float32).to(dev),
        L0i=torch.as_tensor(L0i, dtype=torch.float32).to(dev),
        sigma_A=sigma_A(A),
    )


def sigma_A(A: np.ndarray) -> float:
    """Data dissimilarity measure, eq. (31)/(33): the spread of the workers'
    spectral norms, from a numpy ``[n, d, d]`` array on the host. Its last
    bits follow the BLAS library's thread count."""
    spec = np.array([np.linalg.norm(Ai, 2) for Ai in np.asarray(A)])
    return float(np.sqrt(max((spec**2).mean() - spec.mean() ** 2, 0.0)))
