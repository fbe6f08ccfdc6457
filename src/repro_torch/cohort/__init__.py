"""Cross-device cohort subsystem: MOCHA over 10^5-10^6-client populations.

Everything above the round -- population storage, cohort sampling,
relationship factorization, fault tolerance -- at O(m + k^2) memory on the
host; everything at and below the round is the unchanged cross-silo
machinery of ``repro_torch.core`` on the run's device.  The port of the
JAX package's ``repro.cohort``; enter it through
``repro_torch.api.Experiment(problem=Problem(population=...))``.
"""
from repro_torch.cohort.driver import (COHORT_HISTORY_KEYS, CohortConfig,
                                       CohortRunResult)
from repro_torch.cohort.omega import ClusterOmega, StalenessBoundedMerger
from repro_torch.cohort.packing import CohortPacker, pack_cohort
from repro_torch.cohort.population import (CROSS_DEVICE_1K, CROSS_DEVICE_1M,
                                           CROSS_DEVICE_10K,
                                           CROSS_DEVICE_100K, POPULATIONS,
                                           ClientBlock, Population,
                                           PopulationSpec)
from repro_torch.cohort.resilience import (BlockFailure, CohortCheckpointer,
                                           FaultConfig, FaultPlan, FaultStats,
                                           InjectedFault)
from repro_torch.cohort.sampler import SAMPLERS, CohortSampler, CohortSchedule
