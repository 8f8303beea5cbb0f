"""repro_torch.fleet — federated client-zoo simulator (DESIGN.md §9); port of
``repro.fleet``, importing neither JAX nor ``repro``.

Simulates thousands-to-millions of heterogeneous federated clients
without instantiating them: every per-client attribute (data tier, local
dataset size, latency, availability phase, fault rate, problem data) is a
pure hash of the client id, so only each round's sampled cohort is ever
materialized.

* :mod:`~repro_torch.fleet.population` — declarative client-mix specs
  (:class:`FleetSpec`, ``make_fleet`` registry) and the hash-derived
  per-client L1 problem (:class:`FleetL1Problem`);
* :mod:`~repro_torch.fleet.sampler` — participation: slot
  :class:`ParticipationPlan` masks over explicit draws (the core runs'
  hook) and host-side :class:`CohortSampler` schedulers over client ids;
* :mod:`~repro_torch.fleet.cohort` — ``fleet_run``, the cohort-bounded
  MARINA-P / EF21-P host loop with join-sync bit accounting.
"""
from .cohort import (  # noqa: F401
    ParticipationStats,
    fleet_run,
    make_ef21p_cohort_step,
    make_marina_cohort_step,
)
from .population import (  # noqa: F401
    AvailabilityTrace,
    ComputeProfile,
    DataTier,
    FleetL1Problem,
    FleetSpec,
    make_fleet,
)
from .sampler import (  # noqa: F401
    PARTICIPATION_FOLD,
    AvailabilitySampler,
    AvailabilityWindowPlan,
    BernoulliStragglerPlan,
    Cohort,
    CohortSampler,
    CyclingMaskPlan,
    DeadlineSampler,
    FullParticipation,
    ParticipationPlan,
    SizeWeightedSampler,
    UniformSampler,
    make_sampler,
    plan_from_legacy,
)
