"""Declarative client populations (DESIGN.md §9.1).

A :class:`FleetSpec` describes thousands-to-millions of federated clients
*without instantiating them*: every per-client attribute — data tier,
local dataset size, per-round latency, availability phase, fault
severity — is a pure function of ``(spec.seed, client_id)`` evaluated
through a counter-based hash (splitmix64). Asking for the attributes of a
64-client cohort therefore costs O(64) regardless of ``spec.size``; no
population-sized array is ever built.

Components:

* :class:`DataTier` — a data-heterogeneity stratum (Algorithm 3's noise
  scale ``nu_i = 1 + s xi_i`` becomes per-tier ``s``), with a lognormal
  local-dataset-size distribution for size-weighted sampling;
* :class:`ComputeProfile` — lognormal per-(client, round) latency, the
  input to straggler-deadline sampling;
* :class:`AvailabilityTrace` — a diurnal duty-cycle window with a
  per-client phase, so only a deterministic slice of the population is
  eligible each round;
* per-client fault severity that plugs into the existing
  :class:`repro_torch.transport.FaultSpec` (``fault_spec_for``).

:class:`FleetL1Problem` extends the paper's L1 workload (Algorithm 3) to
a fleet: client ``i``'s matrix ``A_i = nu_i * tridiag + shift*I`` is
materialized on demand for a cohort of ids — cohort size, not population
size, bounds memory. The eigenvalue shift uses the *analytic* population
mean (``E[nu] = 1`` exactly), so the problem is well-posed without ever
touching all ``N`` matrices.

A copy of ``repro/fleet/population.py`` (numpy only, on the port's
transport): hashes, tiers, cohorts' matrices and fault specs are bit-equal
to the reference's.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np

from ..transport import FaultSpec

# ---------------------------------------------------------------------------
# Stateless per-client hashing (splitmix64)
# ---------------------------------------------------------------------------

_U64 = np.uint64

# attribute salts: one stream per attribute family
SALT_TIER = 0x7469
SALT_SIZE = 0x737A
SALT_NU = 0x6E75
SALT_PHASE = 0x7068
SALT_LATENCY = 0x6C61
SALT_FAULT = 0x6661
SALT_X0 = 0x7830
SALT_EVAL = 0x6576


def _mix(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer, vectorized over uint64 arrays."""
    with np.errstate(over="ignore"):
        z = (x + _U64(0x9E3779B97F4A7C15)).astype(_U64)
        z = (z ^ (z >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> _U64(27))) * _U64(0x94D049BB133111EB)
        return z ^ (z >> _U64(31))


def hash_u64(ids, seed: int, salt: int, extra: int = 0) -> np.ndarray:
    """Deterministic 64-bit hash of (seed, salt, extra, id) per element."""
    ids = np.asarray(ids, dtype=np.uint64)
    h = _mix(_mix(np.asarray(seed, dtype=_U64)) ^ _mix(np.asarray(salt, dtype=_U64)))
    if extra:
        h = _mix(h ^ _mix(np.asarray(extra, dtype=_U64)))
    return _mix(ids ^ h)


def hash_uniform(ids, seed: int, salt: int, extra: int = 0) -> np.ndarray:
    """Uniform floats in (0, 1), one per id, deterministic."""
    h = hash_u64(ids, seed, salt, extra)
    return ((h >> _U64(11)).astype(np.float64) + 0.5) * (2.0 ** -53)


def hash_normal(ids, seed: int, salt: int, extra: int = 0) -> np.ndarray:
    """Standard normals via Box–Muller on two hashed uniform streams."""
    u1 = hash_uniform(ids, seed, salt, extra)
    u2 = hash_uniform(ids, seed, salt + 0x5A5A, extra)
    return np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)


# ---------------------------------------------------------------------------
# Spec components
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DataTier:
    """One data-heterogeneity stratum of the population.

    ``weight`` is the population fraction (normalized across tiers);
    ``noise_scale`` is Algorithm 3's per-worker scale ``s`` in
    ``nu_i = 1 + s xi_i``; local dataset sizes are lognormal with median
    ``size_median`` and log-sigma ``size_sigma`` (size-weighted sampling).
    """

    name: str
    weight: float = 1.0
    noise_scale: float = 1.0
    size_median: float = 1.0
    size_sigma: float = 0.0


@dataclasses.dataclass(frozen=True)
class ComputeProfile:
    """Lognormal per-(client, round) latency: median * exp(sigma * N(0,1))."""

    latency_median: float = 1.0
    latency_sigma: float = 0.0


@dataclasses.dataclass(frozen=True)
class AvailabilityTrace:
    """Diurnal duty-cycle: client ``i`` is available in rounds ``t`` with
    ``(t + phase_i) mod period < ceil(duty * period)``; ``phase_i`` is
    hashed per client. ``duty=1`` means always available."""

    period: int = 1
    duty: float = 1.0

    @property
    def open_ticks(self) -> int:
        return max(1, int(np.ceil(self.duty * self.period)))


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """A population of ``size`` clients, described declaratively.

    ``fault_rate`` is the population-mean per-frame drop probability; each
    client gets an Exp(1)-distributed severity multiplier (hashed), capped
    at 0.9, so a few clients are much flakier than the mean — the spec
    plugs into :class:`repro_torch.transport.FaultSpec` via
    :meth:`fault_spec_for`.
    """

    size: int
    tiers: Tuple[DataTier, ...] = (DataTier("default"),)
    compute: ComputeProfile = ComputeProfile()
    availability: AvailabilityTrace = AvailabilityTrace()
    fault_rate: float = 0.0
    seed: int = 0

    def __post_init__(self):
        assert self.size >= 1 and self.tiers, (self.size, self.tiers)

    # -- per-client attributes (all vectorized over an ids array) ----------

    @functools.cached_property
    def _tier_cum(self) -> np.ndarray:
        w = np.asarray([t.weight for t in self.tiers], dtype=np.float64)
        return np.cumsum(w / w.sum())

    def tier_index(self, ids) -> np.ndarray:
        u = hash_uniform(ids, self.seed, SALT_TIER)
        return np.minimum(
            np.searchsorted(self._tier_cum, u, side="right"), len(self.tiers) - 1
        )

    def _tier_field(self, ids, field: str) -> np.ndarray:
        vals = np.asarray([getattr(t, field) for t in self.tiers], dtype=np.float64)
        return vals[self.tier_index(ids)]

    def noise_scale(self, ids) -> np.ndarray:
        return self._tier_field(ids, "noise_scale")

    def data_size(self, ids) -> np.ndarray:
        """Relative local dataset size (lognormal per tier), > 0."""
        med = self._tier_field(ids, "size_median")
        sig = self._tier_field(ids, "size_sigma")
        return med * np.exp(sig * hash_normal(ids, self.seed, SALT_SIZE))

    @property
    def size_cap(self) -> float:
        """Clip bound for size-weighted acceptance sampling (~99.9%-ile)."""
        return max(
            t.size_median * float(np.exp(3.1 * t.size_sigma)) for t in self.tiers
        )

    def latency(self, ids, t: int) -> np.ndarray:
        """Per-(client, round) compute+link latency draw (virtual seconds)."""
        c = self.compute
        z = hash_normal(ids, self.seed, SALT_LATENCY, extra=t + 1)
        return c.latency_median * np.exp(c.latency_sigma * z)

    def phase(self, ids) -> np.ndarray:
        period = max(1, self.availability.period)
        return (hash_u64(ids, self.seed, SALT_PHASE) % _U64(period)).astype(np.int64)

    def available(self, ids, t: int) -> np.ndarray:
        a = self.availability
        if a.duty >= 1.0 or a.period <= 1:
            return np.ones(np.asarray(ids).shape, dtype=bool)
        return ((int(t) + self.phase(ids)) % a.period) < a.open_ticks

    def drop_prob(self, ids) -> np.ndarray:
        """Per-client frame drop probability: fault_rate * Exp(1), capped."""
        if self.fault_rate <= 0:
            return np.zeros(np.asarray(ids).shape, dtype=np.float64)
        sev = -np.log(hash_uniform(ids, self.seed, SALT_FAULT))
        return np.minimum(self.fault_rate * sev, 0.9)

    def fault_spec_for(self, client_id: int, *, round_salt: int = 0):
        """A :class:`repro_torch.transport.FaultSpec` for one client's link,
        seeded deterministically from (spec.seed, client_id, round)."""
        seed = int(hash_u64(np.asarray([client_id]), self.seed, SALT_FAULT,
                            extra=round_salt + 1)[0] % _U64(2**31))
        return FaultSpec(drop=float(self.drop_prob(np.asarray([client_id]))[0]),
                         seed=seed)


# ---------------------------------------------------------------------------
# Named client mixes (the scenario matrix's client-mix axis)
# ---------------------------------------------------------------------------


def make_fleet(mix: str, size: int, *, seed: int = 0) -> FleetSpec:
    """Registry of named client mixes.

    * ``uniform`` — one homogeneous tier, always available, clean links;
    * ``two_tier`` — 70% low-noise "edge" + 30% high-noise "dc" data, with
      a 4x dataset-size spread between them;
    * ``two_tier_diurnal`` — two_tier plus a 50%-duty diurnal availability
      window and lognormal latency spread;
    * ``flaky_mobile`` — two_tier_diurnal plus a 5%-mean per-frame drop
      rate with Exp(1) per-client severity.
    """
    if mix == "uniform":
        return FleetSpec(size=size, tiers=(DataTier("all", 1.0, 1.0),), seed=seed)
    two_tier = (
        DataTier("edge", weight=0.7, noise_scale=0.3, size_median=1.0, size_sigma=0.25),
        DataTier("dc", weight=0.3, noise_scale=3.0, size_median=4.0, size_sigma=0.25),
    )
    if mix == "two_tier":
        return FleetSpec(size=size, tiers=two_tier, seed=seed)
    if mix == "two_tier_diurnal":
        return FleetSpec(
            size=size, tiers=two_tier,
            compute=ComputeProfile(latency_median=1.0, latency_sigma=0.6),
            availability=AvailabilityTrace(period=24, duty=0.5), seed=seed,
        )
    if mix == "flaky_mobile":
        return FleetSpec(
            size=size, tiers=two_tier,
            compute=ComputeProfile(latency_median=1.0, latency_sigma=0.6),
            availability=AvailabilityTrace(period=24, duty=0.5),
            fault_rate=0.05, seed=seed,
        )
    raise ValueError(f"unknown client mix: {mix!r}")


# ---------------------------------------------------------------------------
# Fleet-scale L1 workload
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FleetL1Problem:
    """The paper's L1 finite-sum over a declarative client population.

    ``A_i = nu_i * tridiag(d) + shift * I`` with ``nu_i = 1 + s_tier(i) *
    xi_i`` hashed per client (Algorithm 3 per tier). The mean-eigenvalue
    shift uses the analytic population mean ``E[A] = tridiag(d)`` (because
    ``E[nu] = 1`` exactly), so the construction never touches more than a
    cohort of matrices at once.
    """

    spec: FleetSpec
    d: int
    mu: float = 1e-6

    @functools.cached_property
    def _base(self) -> np.ndarray:
        m = 2.0 * np.eye(self.d) - np.eye(self.d, k=1) - np.eye(self.d, k=-1)
        return m / 4.0

    @functools.cached_property
    def _base_eigs(self) -> np.ndarray:
        # tridiagonal Toeplitz eigenvalues: (2 - 2 cos(pi j / (d+1))) / 4
        j = np.arange(1, self.d + 1)
        return (2.0 - 2.0 * np.cos(np.pi * j / (self.d + 1))) / 4.0

    @functools.cached_property
    def shift(self) -> float:
        return self.mu - float(self._base_eigs.min())

    @functools.cached_property
    def x0(self) -> np.ndarray:
        rng = np.random.default_rng(
            int(hash_u64(np.asarray([0]), self.spec.seed, SALT_X0)[0])
        )
        return rng.standard_normal(self.d)

    @property
    def f_star(self) -> float:
        return 0.0  # f_i >= 0 and f_i(0) = 0 for every client

    @property
    def R0_sq(self) -> float:
        return float(np.sum(self.x0**2))

    def nu(self, ids) -> np.ndarray:
        """Per-client Algorithm-3 scale: nu_i = 1 + s_tier(i) * xi_i."""
        return 1.0 + self.spec.noise_scale(ids) * hash_normal(
            ids, self.spec.seed, SALT_NU
        )

    def materialize(self, ids) -> np.ndarray:
        """Cohort matrices [len(ids), d, d] — O(cohort * d^2) memory."""
        nu = self.nu(ids)
        return nu[:, None, None] * self._base[None] + self.shift * np.eye(self.d)[None]

    def client_L0(self, ids) -> np.ndarray:
        """Spectral norms ||A_i||_2 from the analytic eigenvalue formula:
        eig(nu*B + shift*I) = nu*eig(B) + shift — no per-client eigensolve."""
        nu = self.nu(ids)
        eigs = nu[:, None] * self._base_eigs[None, :] + self.shift
        return np.abs(eigs).max(axis=-1)

    def lipschitz_estimates(self, n_probe: int = 256) -> Tuple[float, float]:
        """(L0_bar, L0_tilde) estimated on a hashed probe cohort."""
        n = min(n_probe, self.spec.size)
        ids = np.unique(
            (hash_u64(np.arange(n), self.spec.seed, SALT_EVAL, extra=7)
             % _U64(self.spec.size)).astype(np.int64)
        )
        L = self.client_L0(ids)
        return float(L.mean()), float(np.sqrt((L**2).mean()))

    def eval_cohort(self, m: int = 64) -> np.ndarray:
        """A fixed hashed evaluation cohort (population-objective probe)."""
        m = min(m, self.spec.size)
        ids = (hash_u64(np.arange(m), self.spec.seed, SALT_EVAL)
               % _U64(self.spec.size)).astype(np.int64)
        return ids
