"""Batched prediction lookups over a ``SnapshotStore``, on the card.

The port's copy of the JAX package's ``repro.serve.predict``.  The host
path (``ServedSnapshot.client_weights``) exists for parity and evaluation;
this module is the serving fast path.  A ``Predictor`` mirrors the current
snapshot's arrays on its device and answers ``predict(ids, X)`` with a
gather, a ``searchsorted`` over the sorted cache ids, a ``where`` and a
row-wise dot product.  The JAX package jits the same ops outside any Pallas
kernel (``_lookup`` / ``_margins``), so here they are plain torch ops on
the device, not a kernel of the port.  Snapshots carry fixed-capacity
(cache) and fixed-population (assign) shapes, so a swap costs four
host-to-device copies and nothing else.

Serve-role code under the thread-ownership contract: the per-snapshot
device mirror is ``# owner: serve`` and every entry point runs on the
serve thread.  The stale-read counter feeds the ``serve_stale_reads`` /
``serve_reads`` metrics pair (a stale read is one whose snapshot was
superseded while the answer was being computed -- legal, bounded by one
swap, and worth watching).

Readers and CUDA-graph capture.  Readers never lock against training's
state: they read an immutable snapshot through one reference.  But on the
card the cohort solve thread captures its round program as a CUDA graph
(``core.mocha.RoundProgram``, in the default ``"global"`` capture mode),
and a copy, a kernel or a blocking read issued by another thread while a
capture runs breaks that capture (or is refused).  So the predictor's
device work -- the mirror's copies, the lookup and the blocking read of the
answer -- runs under ``core.mocha.CAPTURE_LOCK``, as the cohort pack
worker's copies do.  The lock is held by training only while a capture
runs, once a run; a read then waits for that capture and never for a
block's solve.  Nothing the predictor does reaches training's state, so a
run with serving on gives the bits of a run with serving off.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.mocha import CAPTURE_LOCK
from repro_torch.serve.store import SnapshotStore, check_ids
from repro_torch.utils.device import resolve_device

Tensor = torch.Tensor


def _lookup(assign: Tensor, centroids: Tensor, cache_ids: Tensor,
            cache_delta: Tensor, ids: Tensor) -> Tensor:
    """(B, d) served weights on the device: ``store.resolve_weights``'s
    rule (a float32 gather, plus the cached delta where the id is cached)."""
    W = centroids[assign[ids]]
    capacity = cache_ids.shape[0]
    if capacity:
        pos = torch.searchsorted(cache_ids, ids).clamp_(0, capacity - 1)
        hit = cache_ids[pos] == ids
        W = W + torch.where(hit[:, None], cache_delta[pos],
                            torch.zeros((), dtype=W.dtype, device=W.device))
    return W


def _margins(assign, centroids, cache_ids, cache_delta, ids,
             X: Tensor) -> Tensor:
    W = _lookup(assign, centroids, cache_ids, cache_delta, ids)
    return torch.einsum("bd,bd->b", W, X)


class Predictor:
    """Answers batched predictions against the store's newest snapshot.

    Single-reader object: one ``Predictor`` per serve thread (the device
    mirror below is serve-owned state).  Several serve threads each get
    their own ``Predictor`` over the shared ``SnapshotStore``.  ``device``
    is where the mirror and the lookups live: the card unless asked.
    """

    def __init__(self, store: SnapshotStore,
                 telemetry: Optional[obs.Telemetry] = None,
                 device: Union[str, torch.device, None] = None):
        # launch-time constants
        self._store = store
        self.device = resolve_device(device)
        tel = telemetry if telemetry is not None else obs.NULL_TELEMETRY
        self.tel = tel.for_worker("serve")
        self._reads = self.tel.counter("serve_reads")
        self._stale = self.tel.counter("serve_stale_reads")
        self._version: int = -1        # owner: serve
        self._device: Optional[Tuple[Tensor, ...]] = None  # owner: serve
        self._max_lag: int = 0         # owner: serve

    def _arrays(self, snap) -> Tuple[Tensor, ...]:  # worker: serve
        """Device mirror of ``snap``, refreshed only on a version change
        (call under ``CAPTURE_LOCK``)."""
        if self._device is None or self._version != snap.version:
            dev = self.device
            self._device = tuple(torch.from_numpy(a).to(dev) for a in (
                snap.assign, snap.centroids, snap.cache_ids,
                snap.cache_delta))
            self._version = snap.version
        return self._device

    def _answer(self, fn, ids, *args) -> np.ndarray:  # worker: serve
        """``fn`` of the newest snapshot, taken once ``CAPTURE_LOCK`` is
        held: a read that waits for a capture answers from what was
        published meanwhile, so its lag counts only the publishes that
        finish while the answer is computed."""
        dev = self.device
        with CAPTURE_LOCK:
            snap = self._store.current()
            ids = check_ids(ids, snap.m).astype(np.int32)
            arrays = self._arrays(snap)
            out = fn(*arrays, torch.from_numpy(ids).to(dev),
                     *(torch.from_numpy(a).to(dev) for a in args))
            host = out.cpu().numpy()   # blocks until the lookup is done
        self._reads.inc()
        lag = self._store.version - snap.version
        if lag > 0:
            self._stale.inc()  # answered from a just-superseded snapshot
        if lag > self._max_lag:
            self._max_lag = lag
        return host

    def lookup(self, ids) -> np.ndarray:  # worker: serve
        """(B, d) served weights for ``ids`` under the newest snapshot."""
        return self._answer(_lookup, ids)

    def predict(self, ids, X) -> np.ndarray:  # worker: serve
        """(B,) decision margins ``<w_id, x>`` for per-client features X."""
        return self._answer(_margins, ids,
                            np.ascontiguousarray(X, np.float32))

    @property
    def snapshot_version(self) -> int:
        """Version of the snapshot currently mirrored on the device."""
        return self._version

    @property
    def max_version_lag(self) -> int:
        """Worst finish-time staleness any answered read has seen, in
        snapshot swaps (how many publishes completed while the answer was
        being computed).  Reads never stall on a swap, so this is a
        freshness stat; for a warmed predictor whose lookups are much
        shorter than the publish interval it stays ``<= 1``."""
        return self._max_lag
