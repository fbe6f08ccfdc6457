"""Immutable served state: ``ServedSnapshot`` + the atomically-swapped store.

The port's copy of the JAX package's ``repro.serve.store``.  The training
stack mutates ``ClusterOmega`` in place on the fold (MAIN) thread; a
prediction tier reading those arrays directly would race every fold.  The
serving contract is instead snapshot-and-swap:

  * ``ServedSnapshot`` is an immutable, versioned host copy of exactly the
    state serving needs -- cluster centroids, per-client assignments, and
    the LRU cache's personal deltas, flattened to fixed-capacity sorted
    arrays so a lookup is a searchsorted away (and the device mirror keeps
    its shapes as the cache fills);
  * ``resolve_weights`` is THE served-weight resolution rule -- cluster
    centroid plus cached personal delta, bare centroid for never-trained
    clients.  It lives beside the state it reads (``cohort/omega.py``) and
    is shared by ``ClusterOmega.client_weights``, the held-out evaluation
    (``core/evaluate.py``), the snapshots here and the device lookup
    (``serve/predict.py``), so no caller reconstructs it inline;
  * ``SnapshotStore`` hands snapshots from the publisher (the training fold
    thread, ownership role ``main``) to readers (role ``serve``) by
    swapping one reference -- a single GIL-atomic store, so readers never
    lock against training and never observe a half-built snapshot.

Host numpy arrays, as in the JAX package: the snapshot is built on the fold
thread, which never touches the card.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch import obs
from repro_torch.cohort.omega import (SENTINEL, check_ids, resolve_weights,
                                      sorted_cache)
from repro_torch.utils.timing import tick


@dataclasses.dataclass(frozen=True)
class ServedSnapshot:
    """One immutable, versioned view of the served model state.

    Arrays are host copies -- training may keep mutating its own state
    after the snapshot is taken.  ``cache_ids`` is sorted ascending with
    ``SENTINEL`` padding to the cache capacity (stable shapes across
    versions); ``cache_delta`` rows are matched to ``cache_ids``, zeros for
    padding.  ``folded_through`` is the training merge frontier the
    snapshot reflects (-1 = the cold pre-training state).
    """

    version: int
    folded_through: int
    centroids: np.ndarray    # (k, d) float32
    assign: np.ndarray       # (m,) int32
    cache_ids: np.ndarray    # (C,) int32, sorted, SENTINEL = empty slot
    cache_delta: np.ndarray  # (C, d) float32

    @classmethod
    def from_state(cls, state, version: int = 0,
                   folded_through: int = -1) -> "ServedSnapshot":
        """Snapshot a live ``ClusterOmega``-shaped state (duck-typed: any
        object with ``centroids``/``assign``/``cache_clients`` and the
        ``cache_entries()`` accessor).  Must run on the thread that owns
        the state (the training fold thread) -- the copies below are what
        make the result safe to hand to any other thread."""
        cids, cdelta = state.cache_entries()
        return cls._build(version, folded_through,
                          np.asarray(state.centroids, np.float32).copy(),
                          np.asarray(state.assign, np.int32).copy(),
                          cids, cdelta, int(state.cache_clients),
                          int(np.shape(state.centroids)[1]))

    @classmethod
    def from_snapshot(cls, snap: dict, version: int = 0,
                      folded_through: int = -1) -> "ServedSnapshot":
        """Build from a ``ClusterOmega.snapshot`` checkpoint encoding
        (``cache_ids`` slot -1 = empty; alpha blocks are training-only and
        dropped here)."""
        raw_ids = np.asarray(snap["cache_ids"], np.int64)
        live = raw_ids >= 0
        return cls._build(version, folded_through,
                          np.asarray(snap["centroids"], np.float32).copy(),
                          np.asarray(snap["assign"], np.int32).copy(),
                          raw_ids[live],
                          np.asarray(snap["cache_delta"], np.float32)[live],
                          int(raw_ids.size),
                          int(np.shape(snap["centroids"])[1]))

    @classmethod
    def _build(cls, version, folded_through, centroids, assign, cids,
               cdelta, capacity, d) -> "ServedSnapshot":
        ids, delta = sorted_cache(cids, cdelta, capacity, d)
        return cls(version=int(version), folded_through=int(folded_through),
                   centroids=centroids, assign=assign, cache_ids=ids,
                   cache_delta=delta)

    # -- read-side API ------------------------------------------------------

    @property
    def m(self) -> int:
        return int(self.assign.shape[0])

    @property
    def n_cached(self) -> int:
        return int(np.sum(self.cache_ids != SENTINEL))

    def client_weights(self, ids) -> np.ndarray:
        """(B, d) served weights for any client ids (host path)."""
        return resolve_weights(self.centroids, self.assign, self.cache_ids,
                               self.cache_delta, check_ids(ids, self.m))

    def memory_bytes(self) -> int:
        return (self.centroids.nbytes + self.assign.nbytes
                + self.cache_ids.nbytes + self.cache_delta.nbytes)


class SnapshotStore:
    """Atomic snapshot hand-off: training publishes, serve readers read.

    ``_current`` is written only by the publisher -- the thread playing the
    training ``main`` role -- and read by serve threads through
    ``current()``.  The swap is one reference assignment (GIL-atomic) of an
    immutable object, so readers never lock, never stall, and never see a
    torn snapshot; a reader that grabbed version v keeps serving v until
    its next ``current()`` call.
    """

    def __init__(self, telemetry: Optional[obs.Telemetry] = None):
        # launch-time constants (readable from any thread)
        self.tel = telemetry if telemetry is not None else obs.NULL_TELEMETRY
        self._swap_latency = self.tel.histogram("serve_swap_latency_s")
        self._current: Optional[ServedSnapshot] = None  # owner: main
        self._swaps = 0  # owner: main

    def publish(self, snap: ServedSnapshot) -> None:  # worker: main
        """Swap the served snapshot (publisher thread only)."""
        t0 = tick()
        self._current = snap
        self._swaps += 1
        self._swap_latency.observe(tick() - t0)
        self.tel.event("serve.swap", version=snap.version,
                       folded_through=snap.folded_through,
                       cached=snap.n_cached)

    def current(self) -> ServedSnapshot:  # worker: serve
        """The latest published snapshot (any reader thread): a
        cross-owner read of one reference whose target is immutable."""
        snap = self._current
        if snap is None:
            raise RuntimeError(
                "no ServedSnapshot published yet (publish one, or let the "
                "refresh loop's prewarm do it)")
        return snap

    @property
    def version(self) -> int:
        """Latest published version (-1 before the first publish)."""
        snap = self._current
        return -1 if snap is None else snap.version

    @property
    def swap_count(self) -> int:
        return self._swaps
