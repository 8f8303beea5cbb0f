"""Participation scheduling (DESIGN.md §9.2), on tensors.

Two layers, both deterministic from a seed:

* **Slot plans** (:class:`ParticipationPlan`) — masks over a fixed worker
  axis, the participation hook of the core ``marina_p.run`` /
  ``ef21p.run`` loops. As everywhere in the port, a plan's randomness is an
  explicit argument: ``plan.draw(n, generator, device)`` makes one round's
  draws (None for the plans that draw nothing) and ``plan.mask(draws, n, t,
  device)`` maps them to a bool mask [n]. The runs draw them from a CPU
  ``torch.Generator`` of their own (:meth:`ParticipationPlan.generator`), so
  the downlink draws are the same with and without a plan, as the
  reference's ``fold_in(key, PARTICIPATION_FOLD)`` keeps them.
  :class:`BernoulliStragglerPlan` draws a uniform [n] and an Exp(1) [n], the
  two draws the reference's plan takes from its split participation key,
  so tests inject the reference's own draws.

* **Cohort samplers** (:class:`CohortSampler`) — host-side schedulers
  that draw per-round cohorts of *client ids* from a declarative
  :class:`~repro_torch.fleet.population.FleetSpec` population. Sampling is
  rejection-based (propose a uniform id, accept per scheduler policy), so
  a round costs O(cohort), never O(population). Schedulers: uniform,
  size-weighted (importance ∝ local dataset size), availability-window,
  and straggler-deadline. A copy of the reference's numpy code: cohorts
  and weights are bit-equal.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .population import FleetSpec

# the reference's participation fold constant (DESIGN.md §8.5/§9.2); here it
# seeds the participation generator apart from the main one
PARTICIPATION_FOLD = 0x5052


# ---------------------------------------------------------------------------
# Slot plans (masks over a fixed worker axis)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ParticipationPlan:
    """Maps (round draws, n slots, round t) -> bool mask [n].

    ``is_full`` lets callers skip the masked aggregation path entirely
    (bit-identical to no plan at all)."""

    @property
    def is_full(self) -> bool:
        return False

    def generator(self, seed: int) -> torch.Generator:
        """The CPU generator of a run's participation draws, seeded apart
        from the generator of its downlink draws."""
        return torch.Generator().manual_seed((int(seed) << 16) ^ PARTICIPATION_FOLD)

    def draw(self, n: int, generator: torch.Generator, device) -> Optional[Tuple[torch.Tensor, ...]]:
        """One round's random draws for :meth:`mask`; None where the plan
        draws nothing."""
        return None

    def mask(self, draws, n: int, t: int, device="cpu") -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class FullParticipation(ParticipationPlan):
    """Every slot participates every round (the classic full-sync setting)."""

    @property
    def is_full(self) -> bool:
        return True

    def mask(self, draws, n, t, device="cpu"):
        return torch.ones((n,), dtype=torch.bool, device=device)


@dataclasses.dataclass(frozen=True)
class BernoulliStragglerPlan(ParticipationPlan):
    """The legacy ``drop_prob`` / ``straggler_cutoff`` model as a plan: a
    slot sits out when its uniform draw is below ``drop_prob`` and/or its
    Exp(1) latency draw exceeds ``straggler_cutoff`` (the reference's ops,
    on explicit draws)."""

    drop_prob: float = 0.0
    straggler_cutoff: float = 0.0

    def draw(self, n, generator, device):
        u = torch.rand((n,), generator=generator)
        e = torch.empty((n,)).exponential_(generator=generator)
        return u.to(device), e.to(device)

    def mask(self, draws, n, t, device="cpu"):
        u, e = draws
        m = torch.ones((n,), dtype=torch.bool, device=u.device)
        if self.drop_prob > 0:
            m &= u >= self.drop_prob
        if self.straggler_cutoff > 0:
            m &= e <= self.straggler_cutoff
        return m


@dataclasses.dataclass(frozen=True)
class AvailabilityWindowPlan(ParticipationPlan):
    """Deterministic diurnal windows over the slot axis: slot ``i`` is in
    its window when ``(t + phases[i]) mod period < open_ticks``."""

    phases: Tuple[int, ...] = ()
    period: int = 24
    open_ticks: int = 12

    @classmethod
    def for_slots(cls, spec: FleetSpec, n: int) -> "AvailabilityWindowPlan":
        """Phases hashed from a FleetSpec's availability trace."""
        phases = tuple(int(p) for p in spec.phase(np.arange(n)))
        a = spec.availability
        return cls(phases=phases, period=max(1, a.period), open_ticks=a.open_ticks)

    def mask(self, draws, n, t, device="cpu"):
        if len(self.phases) != n:
            raise ValueError(f"AvailabilityWindowPlan: {len(self.phases)} phases for {n} slots")
        ph = torch.tensor(self.phases, dtype=torch.int64, device=device)
        return ((int(t) + ph) % self.period) < self.open_ticks


@dataclasses.dataclass(frozen=True)
class CyclingMaskPlan(ParticipationPlan):
    """Cycle through a fixed tuple of masks by round — test/repro helper
    for exact cohort patterns (e.g. an empty or size-1 round)."""

    masks: Tuple[Tuple[bool, ...], ...] = ((True,),)

    def mask(self, draws, n, t, device="cpu"):
        table = torch.tensor(self.masks, dtype=torch.bool, device=device)
        if table.shape[1] != n:
            raise ValueError(f"CyclingMaskPlan: masks of {table.shape[1]} slots for {n} slots")
        return table[int(t) % table.shape[0]]


def plan_from_legacy(drop_prob: float = 0.0, straggler_cutoff: float = 0.0) -> ParticipationPlan:
    """The shim the legacy trainer knobs route through."""
    if drop_prob <= 0 and straggler_cutoff <= 0:
        return FullParticipation()
    return BernoulliStragglerPlan(drop_prob=drop_prob, straggler_cutoff=straggler_cutoff)


# ---------------------------------------------------------------------------
# Cohort samplers (host-side client-id scheduling)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Cohort:
    """One round's sampled cohort: fixed-width slots for jit stability.

    ``ids[i]`` is slot i's client id; ``active[i]`` marks filled slots
    that made the round (unfilled slots and deadline-missed stragglers are
    inactive); ``weights`` are aggregation weights (uniform over active —
    size-weighted samplers bias the *sampling* probability instead, the
    importance-sampling form of FedAvg weighting).
    """

    ids: np.ndarray      # int64 [c]
    active: np.ndarray   # bool [c]
    weights: np.ndarray  # float64 [c], zero where inactive

    @property
    def n_active(self) -> int:
        return int(self.active.sum())

    @property
    def fill(self) -> float:
        return self.n_active / max(len(self.ids), 1)


@dataclasses.dataclass(frozen=True)
class CohortSampler:
    """Base scheduler: uniform-without-replacement via rejection sampling.

    ``cohort(t)`` draws from ``default_rng((seed, SALT, t))`` so cohorts
    are deterministic per (sampler seed, round) and independent across
    rounds. Subclasses refine ``_accept`` (per-candidate policy) and
    ``_finalize`` (post-selection masking, e.g. deadline cuts). The draw
    budget bounds worst-case work at O(cohort * max_draw_factor).
    """

    spec: FleetSpec
    cohort_size: int
    seed: int = 0
    max_draw_factor: int = 128

    _SALT = 0x636F686F

    def rng(self, t: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, self._SALT, int(t)))

    def _accept(self, rng: np.random.Generator, cid: int, t: int) -> bool:
        return True

    def _finalize(self, rng: np.random.Generator, cohort: "Cohort", t: int) -> "Cohort":
        return cohort

    def cohort(self, t: int) -> Cohort:
        c = self.cohort_size
        rng = self.rng(t)
        picked: list = []
        seen = set()
        budget = c * self.max_draw_factor
        draws = 0
        while len(picked) < c and draws < budget:
            cand = int(rng.integers(self.spec.size))
            draws += 1
            if cand in seen:
                continue
            seen.add(cand)
            if not self._accept(rng, cand, t):
                continue
            picked.append(cand)
        ids = np.zeros(c, dtype=np.int64)
        active = np.zeros(c, dtype=bool)
        if picked:
            ids[: len(picked)] = picked
            active[: len(picked)] = True
        cohort = Cohort(ids=ids, active=active, weights=_uniform_weights(active))
        return self._finalize(rng, cohort, t)


def _uniform_weights(active: np.ndarray) -> np.ndarray:
    w = active.astype(np.float64)
    n = w.sum()
    return w / n if n > 0 else w


@dataclasses.dataclass(frozen=True)
class UniformSampler(CohortSampler):
    """Uniform without replacement over the whole population."""


@dataclasses.dataclass(frozen=True)
class SizeWeightedSampler(CohortSampler):
    """Importance sampling ∝ local dataset size (clipped at spec.size_cap):
    accept a uniform candidate with probability size/size_cap. Aggregation
    stays uniform — sampling ∝ size with uniform weights is the unbiased
    importance-sampled form of size-weighted FedAvg."""

    def _accept(self, rng, cid, t):
        size = float(self.spec.data_size(np.asarray([cid]))[0])
        return rng.random() < min(size / self.spec.size_cap, 1.0)


@dataclasses.dataclass(frozen=True)
class AvailabilitySampler(CohortSampler):
    """Uniform over the clients whose availability window is open at
    round t; a sparse window can leave slots unfilled (active=False)."""

    def _accept(self, rng, cid, t):
        return bool(self.spec.available(np.asarray([cid]), t)[0])


@dataclasses.dataclass(frozen=True)
class DeadlineSampler(CohortSampler):
    """Straggler-deadline: sample uniformly, then deactivate slots whose
    per-round latency draw exceeds ``deadline`` — they were invited but
    miss the round (counted in participation/goodput stats)."""

    deadline: float = 2.0

    def _finalize(self, rng, cohort, t):
        lat = self.spec.latency(cohort.ids, t)
        active = cohort.active & (lat <= self.deadline)
        return Cohort(ids=cohort.ids, active=active,
                      weights=_uniform_weights(active))


def make_sampler(kind: str, spec: FleetSpec, cohort_size: int, *, seed: int = 0) -> CohortSampler:
    """Registry: ``uniform``, ``weighted``, ``availability``,
    ``deadline[:cutoff]``."""
    parts = kind.split(":")
    name = parts[0]
    if name == "uniform":
        return UniformSampler(spec, cohort_size, seed=seed)
    if name == "weighted":
        return SizeWeightedSampler(spec, cohort_size, seed=seed)
    if name == "availability":
        return AvailabilitySampler(spec, cohort_size, seed=seed)
    if name == "deadline":
        cut = float(parts[1]) if len(parts) > 1 else 2.0
        return DeadlineSampler(spec, cohort_size, seed=seed, deadline=cut)
    raise ValueError(f"unknown sampler kind: {kind!r}")
