"""Streaming synthetic client population for cross-device MOCHA.

The port's copy of the JAX package's ``repro.cohort.population``: numpy
and ``SeedSequence`` only, so client blocks, sizes and clusters are the
JAX package's bit for bit.

The paper's cross-silo setting (Table 1: m <= 38 nodes, all participating
every round) materializes the whole federation up front.  The cross-device
regime (Li et al. 2019) is the opposite shape: 10^5-10^6 clients, a small
sampled cohort per round, dropout as the norm.  Storing such a population
is both impossible and unnecessary -- only the sampled cohort's data is
ever touched.

``Population`` therefore keeps O(k*d) resident state (the latent cluster
centers) and derives EVERYTHING per-client -- cluster membership, local
size n_t, ground-truth weights, feature shift, conditioning, the (X, y)
block itself -- as a pure function of ``(population seed, client id)``
through a counter-based ``np.random.SeedSequence``.  Client t's data is
bit-reproducible on demand: sampling the same client in two different
cohorts, or in two different processes, yields the same bytes, with no
per-client storage and no sequential scan to client t.

The statistical phenomena mirror ``data.synthetic.make_federation`` (the
same ``sample_client_block`` law): non-IID per-client features, latent
cluster structure in weight space, unbalanced n_t, label noise,
conditioning heterogeneity.  ``PopulationSpec`` extends ``FederationSpec``
so every calibrated knob carries over.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np

from repro_torch.data.synthetic import (FederationSpec, sample_client_block,
                                  sample_client_size)

#: domain-separation tags for the SeedSequence entropy streams, so the
#: population-level and per-client draws can never collide
_POP_STREAM = 0x706F70      # "pop"
_CLIENT_STREAM = 0x636C69   # "cli"


@dataclasses.dataclass(frozen=True)
class PopulationSpec(FederationSpec):
    """``FederationSpec`` extended with the cross-device knobs.

    ``m`` is now a population size (10^5-10^6 rather than tens of silos);
    ``n_pad`` fixes the packed cohort's point-axis width (0 = ``n_max``) so
    every cohort block of a run compiles to ONE program shape regardless of
    which clients were drawn.
    """

    n_pad: int = 0

    @property
    def pad_width(self) -> int:
        return self.n_pad or self.n_max

    @classmethod
    def from_federation(cls, spec: FederationSpec, m: int,
                        name: str = "", n_pad: int = 0) -> "PopulationSpec":
        """Scale a calibrated cross-silo spec out to an m-client population."""
        fields = {f.name: getattr(spec, f.name)
                  for f in dataclasses.fields(FederationSpec)}
        fields.update(m=m, name=name or f"{spec.name}_x{m}", n_pad=n_pad)
        return cls(**fields)


#: benchmark populations: small per-client datasets (phones, not silos)
CROSS_DEVICE_1K = PopulationSpec("cross_device_1k", m=1_000, d=32,
                                 n_min=16, n_max=64, clusters=5)
CROSS_DEVICE_10K = dataclasses.replace(CROSS_DEVICE_1K,
                                       name="cross_device_10k", m=10_000)
CROSS_DEVICE_100K = dataclasses.replace(CROSS_DEVICE_1K,
                                        name="cross_device_100k", m=100_000)
CROSS_DEVICE_1M = dataclasses.replace(CROSS_DEVICE_1K,
                                      name="cross_device_1m", m=1_000_000)

POPULATIONS = {s.name: s for s in (
    CROSS_DEVICE_1K, CROSS_DEVICE_10K, CROSS_DEVICE_100K, CROSS_DEVICE_1M)}


class ClientBlock(NamedTuple):
    """One materialized client: its local dataset and latent metadata."""

    X: np.ndarray        # (n, d) float32
    y: np.ndarray        # (n,) float32 +-1 labels
    n: int
    cluster: int         # ground-truth latent cluster (evaluation only)


class Population:
    """m synthetic clients, materializable one cohort at a time.

    Resident state is the (clusters, d) latent center matrix -- nothing
    scales with m.  ``client_block(t)`` and the metadata accessors are pure
    functions of ``(seed, t)``.
    """

    def __init__(self, spec: PopulationSpec, seed: int = 0):
        self.spec, self.seed = spec, seed
        rng = np.random.default_rng(
            np.random.SeedSequence([_POP_STREAM, seed]))
        # latent cluster structure in weight space, exactly the
        # make_federation law (centers shared, per-client offsets)
        self.centers = rng.normal(
            0.0, 1.0, (spec.clusters, spec.d)) / np.sqrt(spec.d)

    @property
    def m(self) -> int:
        return self.spec.m

    @property
    def resident_bytes(self) -> int:
        """Population memory that is NOT per-client: O(clusters * d)."""
        return self.centers.nbytes

    # -- per-client derivations (pure in (seed, t)) -------------------------

    def _client_rng(self, t: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([_CLIENT_STREAM, self.seed, int(t)]))

    def _client_meta(self, rng: np.random.Generator
                     ) -> Tuple[int, int]:
        """(cluster, n) -- the cheap draws, made FIRST on the client stream
        so metadata can be derived without materializing the block."""
        spec = self.spec
        cluster = int(rng.integers(0, spec.clusters))
        return cluster, sample_client_size(rng, spec)

    def client_meta(self, t: int) -> Tuple[int, int]:
        """(ground-truth cluster, n_t) for client t, without the data."""
        return self._client_meta(self._client_rng(t))

    def client_sizes(self, ids: np.ndarray) -> np.ndarray:
        """n_t for a batch of clients (the sampler/packer's budget input)."""
        return np.asarray([self.client_meta(int(t))[1] for t in ids],
                          np.int64)

    def true_assignments(self, ids: np.ndarray) -> np.ndarray:
        """Ground-truth cluster ids (evaluating learned assignments only)."""
        return np.asarray([self.client_meta(int(t))[0] for t in ids],
                          np.int32)

    def client_block(self, t: int) -> ClientBlock:
        """Materialize client t's local dataset (bit-reproducible)."""
        spec = self.spec
        rng = self._client_rng(t)
        cluster, n = self._client_meta(rng)
        w_true = (self.centers[cluster]
                  + spec.cluster_spread * rng.normal(0.0, 1.0, spec.d)
                  / np.sqrt(spec.d))
        mu = (spec.feature_shift * rng.normal(0.0, 1.0, spec.d)
              / np.sqrt(spec.d))
        if spec.difficulty_spread > 0:
            cond = spec.difficulty_spread * abs(float(rng.normal()))
            feat_scale = np.exp(cond * rng.normal(0.0, 1.0, spec.d))
        else:
            feat_scale = np.ones(spec.d)
        X, y = sample_client_block(rng, spec, w_true, mu, feat_scale, n)
        return ClientBlock(X=X.astype(np.float32), y=y.astype(np.float32),
                           n=n, cluster=cluster)
