"""Cluster-factored task-relationship state: O(m + k^2), never O(m^2).

MOCHA's Omega is m x m -- at m = 10^6 that is 4 TB, and even forming it is
a non-starter.  The cross-device factorization replaces it with

  * ``omega_k``    (k, k)   relationships between k latent CLUSTERS,
  * ``assign``     (m,)     each client's current cluster (int32),
  * ``centroids``  (k, d)   per-cluster model centroids = the global W
                            summary,
  * a bounded LRU cache of recently-active clients' state (their dual
    block alpha_t for warm starts, and their w_t - centroid delta for
    serving),

so a cohort of K clients sees the K x K coupling

    Omega_S[i, j] = omega_k[assign[S_i], assign[S_j]] + eta * 1[i == j]

-- clients relate through their clusters, plus ``eta`` self-affinity that
keeps per-client freedom (and the expansion full-rank).  Only cohort-sized
blocks of the m x m matrix are ever formed.

The state is host state in numpy (``omega_k`` float64, ``centroids``
float32), as in the JAX package's ``repro.cohort.omega``, so every fold
gives the JAX package's bits.  Updates are incremental from cohort
statistics only: participated clients are re-assigned to the nearest warm
centroid, centroids track a running average of their members' solved
weights, and ``omega_k`` is refreshed by the port's
``Regularizer.update_omega`` on the (k, d) centroid matrix, run on the CPU
(a k x k step) and brought back to numpy.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Tuple, Union

import numpy as np
import torch

from repro_torch.core.regularizers import Regularizer
from repro_torch.utils.device import resolve_device

class ClusterOmega:
    """Factored relationship + model state for an m-client population.

    ``device`` is where ``cohort_omega`` puts its block (the run's device;
    the card by default)."""

    def __init__(self, m: int, k: int, d: int, reg: Regularizer,
                 eta: float = 0.5, cache_clients: int = 4096, metrics=None,
                 device: Union[str, torch.device, None] = None):
        if k < 1:
            raise ValueError(f"need k >= 1 clusters, got {k}")
        self.m, self.k, self.d, self.eta = m, k, d, float(eta)
        self.device = resolve_device(device)
        # every mutable field below is fold-stage state: the overlapped
        # pipeline touches it from the MAIN thread only (see
        # repro_torch.cohort.driver._BlockLoop)
        self.omega_k = reg.init_omega(k, device="cpu").numpy().astype(
            np.float64)  # owner: main
        self.centroids = np.zeros((k, d), np.float32)  # owner: main
        self.counts = np.zeros(k, np.int64)  # owner: main  (client-round obs)
        # deterministic balanced init; re-assignment is data-driven once
        # centroids warm up
        self.assign = (np.arange(m, dtype=np.int64) % k).astype(np.int32)  # owner: main
        self.cache_clients = int(cache_clients)
        #: client id -> (alpha_t (n_t,) float32, w_delta (d,) float32)
        self._cache: "OrderedDict[int, Tuple[np.ndarray, np.ndarray]]" = (
            OrderedDict())  # owner: main
        #: LRU hit-rate instruments (repro_torch.obs registry; None =
        #: inert); warm-start reads run on the MAIN thread only
        self._cache_hits = (None if metrics is None
                            else metrics.counter("omega_cache_hits"))
        self._cache_misses = (None if metrics is None
                              else metrics.counter("omega_cache_misses"))

    # -- cohort-facing views (all cohort-sized, never population-sized) -----

    def cohort_block(self, ids: np.ndarray) -> np.ndarray:  # worker: main
        """(K, K) float32 expanded relationship block, on the host."""
        a = self.assign[np.asarray(ids, np.int64)]
        om = self.omega_k[np.ix_(a, a)] + self.eta * np.eye(len(a))
        return om.astype(np.float32)

    def cohort_omega(self, ids: np.ndarray) -> torch.Tensor:  # worker: main
        """(K, K) float32 expanded relationship block on ``device``."""
        return torch.from_numpy(self.cohort_block(ids)).to(self.device)

    def cohort_alpha(self, ids: np.ndarray, n_pad: int) -> np.ndarray:  # worker: main
        """(K, n_pad) warm-start dual blocks: cached rows, zeros for fresh
        or evicted clients (an evicted client restarts cold -- SDCA loses
        the warm start, not correctness)."""
        alpha = np.zeros((len(ids), n_pad), np.float32)
        hits = 0
        for slot, t in enumerate(np.asarray(ids, np.int64)):
            hit = self._cache.get(int(t))
            if hit is not None:
                hits += 1
                row = hit[0]
                alpha[slot, :row.shape[0]] = row
        if self._cache_hits is not None:
            self._cache_hits.inc(hits)
            self._cache_misses.inc(len(ids) - hits)
        return alpha

    def cache_entries(self):  # worker: main
        """(ids (L,) int64, deltas (L, d) float32) copies of the live LRU
        cache, least-recent first.  The read-side accessor the serve tier's
        ``ServedSnapshot.from_state`` consumes -- nobody outside this class
        touches ``_cache`` directly."""
        if not self._cache:
            return (np.zeros(0, np.int64), np.zeros((0, self.d), np.float32))
        ids = np.fromiter(self._cache.keys(), np.int64, len(self._cache))
        deltas = np.stack([hit[1] for hit in self._cache.values()])
        return ids, np.asarray(deltas, np.float32)

    def client_weights(self, ids: np.ndarray) -> np.ndarray:  # worker: main
        """(K, d) serving weights: centroid + cached personal delta.

        Defined for EVERY client -- never-sampled clients serve their
        cluster centroid, the cold-start answer cross-device systems need.
        ``resolve_weights`` on the live state and the sorted cache: the
        rule the serve tier's snapshots apply, so the bits are the same.
        The rule lives in ``repro_torch.serve.store``, one source of truth
        with the online prediction tier.
        """
        from repro_torch.serve.store import (  # runtime-lazy: serve sits
            check_ids, resolve_weights, sorted_cache)  # ABOVE cohort
        ids = check_ids(ids, self.m)
        cids, cdelta = self.cache_entries()
        cache_ids, cache_delta = sorted_cache(cids, cdelta, cids.size,
                                              self.d)
        return resolve_weights(self.centroids, self.assign, cache_ids,
                               cache_delta, ids)

    # -- incremental updates from cohort statistics -------------------------

    def update(self, ids: np.ndarray, W_cohort: np.ndarray,
               alpha_cohort: np.ndarray, sizes: np.ndarray,
               participated: np.ndarray) -> None:  # worker: main
        """Fold one solved cohort back into the factored state.

        ``W_cohort`` (K, d) are the block's solved per-client weights,
        ``alpha_cohort`` (K, n_pad) the dual blocks, ``sizes`` (K,) real
        n_t, ``participated`` (K,) bool (False = dropped: the slot ran 0
        steps, so it contributes no statistics and keeps its prior state).
        """
        ids = np.asarray(ids, np.int64)
        part = np.asarray(participated, bool)
        if not part.any():
            return
        pid, W_p = ids[part], np.asarray(W_cohort, np.float32)[part]

        # (1) re-assign to the nearest WARM centroid (cold clusters carry no
        # signal).  A client whose CURRENT cluster is still cold keeps it --
        # this block's data is what warms it; without that exception, any
        # cluster missing from the first cohort's coverage could never
        # receive an observation and k would be permanently capped by the
        # first block (at full cold start everyone keeps the balanced init).
        warm_mask = self.counts > 0
        warm = np.flatnonzero(warm_mask)
        if warm.size:
            d2 = (np.sum(W_p ** 2, axis=1, keepdims=True)
                  - 2.0 * W_p @ self.centroids[warm].T
                  + np.sum(self.centroids[warm] ** 2, axis=1))
            nearest = warm[np.argmin(d2, axis=1)].astype(np.int32)
            cur = self.assign[pid]
            self.assign[pid] = np.where(warm_mask[cur], nearest, cur)
        a_p = self.assign[pid]

        # (2) running-average centroid update per observed cluster
        for c in np.unique(a_p):
            members = W_p[a_p == c]
            self.counts[c] += members.shape[0]
            beta = members.shape[0] / self.counts[c]
            self.centroids[c] += beta * (members.mean(axis=0)
                                         - self.centroids[c])

        # (3) bounded LRU cache of the active clients' state
        alpha_np = np.asarray(alpha_cohort, np.float32)
        for slot in np.flatnonzero(part):
            t = int(ids[slot])
            n_t = int(sizes[slot])
            delta = (np.asarray(W_cohort[slot], np.float32)
                     - self.centroids[self.assign[t]])
            self._cache[t] = (alpha_np[slot, :n_t].copy(), delta)
            self._cache.move_to_end(t)
        while len(self._cache) > self.cache_clients:
            self._cache.popitem(last=False)

    def refresh_omega(self, reg: Regularizer) -> None:  # worker: main
        """The paper's central Omega step, in cluster space: k x k from the
        (k, d) centroid matrix, O(k^2 d) -- independent of m.  Runs on the
        CPU in float32, as the JAX package runs it in float32."""
        W = torch.from_numpy(self.centroids.copy())
        omega = torch.from_numpy(self.omega_k.astype(np.float32))
        self.omega_k = reg.update_omega(W, omega).numpy().astype(np.float64)

    # -- resilience snapshots (repro_torch.cohort.resilience) ---------------

    def snapshot(self, n_pad: int) -> "dict[str, np.ndarray]":  # worker: main
        """Fixed-shape host encoding of the full factored state.

        Every array's shape is a pure function of (m, k, d, cache_clients,
        n_pad), so the strict ``train.checkpoint.restore`` shape check
        applies.  The LRU cache is flattened in recency order (least-recent
        first) into fixed-capacity arrays: ``cache_ids`` slot -1 = empty,
        ``cache_n`` the true alpha row length under ``n_pad`` padding.
        """
        C = self.cache_clients
        ids = np.full(C, -1, np.int64)
        n = np.zeros(C, np.int64)
        alpha = np.zeros((C, int(n_pad)), np.float32)
        delta = np.zeros((C, self.d), np.float32)
        for slot, (t, (a, w)) in enumerate(self._cache.items()):
            ids[slot] = t
            n[slot] = a.shape[0]
            alpha[slot, :a.shape[0]] = a
            delta[slot] = w
        return {"omega_k": self.omega_k.copy(),
                "centroids": self.centroids.copy(),
                "counts": self.counts.copy(), "assign": self.assign.copy(),
                "cache_ids": ids, "cache_n": n, "cache_alpha": alpha,
                "cache_delta": delta}

    def restore_state(self, snap: "dict[str, np.ndarray]") -> None:  # worker: main
        """Install a ``snapshot`` (inverse; rebuilds the LRU order)."""
        self.omega_k = np.asarray(snap["omega_k"], np.float64).copy()
        self.centroids = np.asarray(snap["centroids"], np.float32).copy()
        self.counts = np.asarray(snap["counts"], np.int64).copy()
        self.assign = np.asarray(snap["assign"], np.int32).copy()
        self._cache.clear()
        ids, n = snap["cache_ids"], snap["cache_n"]
        for slot in range(len(ids)):
            if ids[slot] < 0:
                continue
            n_t = int(n[slot])
            self._cache[int(ids[slot])] = (
                np.asarray(snap["cache_alpha"][slot, :n_t],
                           np.float32).copy(),
                np.asarray(snap["cache_delta"][slot], np.float32).copy())

    # -- introspection ------------------------------------------------------

    @property
    def cached_clients(self) -> int:
        return len(self._cache)

    def memory_bytes(self) -> int:
        """Actual resident bytes: O(m) assignments + O(k^2 + k d) factored
        state + the bounded cache -- no O(m^2) term."""
        cache = sum(a.nbytes + w.nbytes for a, w in self._cache.values())
        return (self.omega_k.nbytes + self.centroids.nbytes
                + self.counts.nbytes + self.assign.nbytes + cache)


class StalenessBoundedMerger:
    """In-order folding of solved cohort blocks with a bounded merge lag.

    The overlapped cohort driver (repro_torch.cohort.driver) launches block
    b while earlier blocks may still be solving; their statistics fold into
    the shared ``ClusterOmega`` only when they complete.  This class is the
    ordering-and-bounding contract that keeps that pipeline deterministic:

      * folds are STRICTLY schedule-ordered (block ``merged_through + 1``
        or nothing) -- the incremental centroid/assignment updates are
        order-sensitive, so out-of-order folds would change the state;
      * block b may LAUNCH only once every block <= b - 1 - S is folded
        (``admissible``), bounding the warm-start/relationship staleness a
        launch can observe to S solved-but-unmerged blocks.

    The omega-refresh cadence lives here too: the central cluster-space
    Omega step fires on the FOLD of every ``omega_update_every``-th block,
    which is the same schedule position the sequential loop fires it at.

    With S = 0 the admissibility rule forces full drain before every
    launch, so every launch reads exactly the state the sequential loop
    would -- the pipeline is bit-identical to it.  With S >= 1 launches
    read state that is at most S blocks behind: one more bounded-inexactness
    source on top of the paper's inexact local solves (theta).
    """

    def __init__(self, state: ClusterOmega, reg: Regularizer,
                 omega_update_every: int = 0, staleness: int = 0):
        if staleness < 0:
            raise ValueError(f"need staleness >= 0, got {staleness}")
        self.state, self.reg = state, reg  # owner: main
        self.omega_update_every = int(omega_update_every)
        self.staleness = int(staleness)
        self.merged_through = -1  # owner: main  (last folded block index)

    def admissible(self, block: int) -> bool:  # worker: main
        """May ``block`` launch now?  (every block <= b - 1 - S folded)"""
        return self.merged_through >= block - 1 - self.staleness

    def fold(self, block: int, ids: np.ndarray, W_cohort: np.ndarray,
             alpha_cohort: np.ndarray, sizes: np.ndarray,
             participated: np.ndarray) -> None:  # worker: main
        """Fold block ``block``'s solved statistics into the shared state."""
        if block != self.merged_through + 1:
            raise RuntimeError(
                f"out-of-order fold: block {block} after "
                f"{self.merged_through} (folds must follow schedule order)")
        self.state.update(ids, W_cohort, alpha_cohort, sizes, participated)
        if (self.omega_update_every
                and (block + 1) % self.omega_update_every == 0):
            self.state.refresh_omega(self.reg)
        self.merged_through = block

