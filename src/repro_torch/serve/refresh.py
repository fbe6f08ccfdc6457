"""Continual training + snapshot refresh: the serve tier's write side.

The port's copy of the JAX package's ``repro.serve.refresh``.
``ServeSession`` wraps the cohort block machinery (``_BlockLoop`` and the
sequential / pipelined runners, with the whole resilience ladder --
retries, degradation, checkpoints) and publishes a fresh
``ServedSnapshot`` to a ``SnapshotStore`` every ``publish_every`` folds
through the loop's post-fold hook.  Training is UNCHANGED by serving: the
publisher only reads main-owned host state on the fold thread and swaps an
immutable reference, so a run with serving on gives the bits of one
without (the guarantee ``Exec.telemetry`` gives).

Roles under the thread-ownership contract: training runs under the usual
``main``/``pack``/``solve`` roles (inline through ``run()``, or on a
background thread through ``start()``/``join()`` -- the spawned thread IS
the ``main`` role then; every stage names the run's device explicitly, as
torch's current device is per thread); prediction entry points are
``serve``-role and may be called from the caller's thread at any time
after construction -- ``prewarm`` publishes the cold version-0 snapshot up
front, so predictions are answerable before the first block lands.  The
predictor lives on the run's device (the card unless asked).

Observability through ``repro_torch.obs``: ``serve_snapshot_age_folds``
(gauge, set every fold), ``serve_publish_s`` (histogram: snapshot build +
swap) and the ``serve.publish`` span, plus the store's
``serve_swap_latency_s`` and the predictor's ``serve_reads`` /
``serve_stale_reads`` pair.
"""
from __future__ import annotations

import threading
from typing import Callable, Optional

from repro_torch.cohort.driver import (CohortConfig, CohortRunResult,
                                       _BlockLoop, _run_blocks_pipelined,
                                       _run_blocks_sequential)
from repro_torch.cohort.population import Population
from repro_torch.core.regularizers import Regularizer
from repro_torch.serve.predict import Predictor
from repro_torch.serve.store import ServedSnapshot, SnapshotStore
from repro_torch.utils.timing import tick


class ServeSession:
    """Online predictions over a cohort run that trains as it serves."""

    def __init__(self, pop: Population, reg: Regularizer, cfg: CohortConfig,
                 publish_every: int = 1, prewarm: bool = True,
                 telemetry=None,
                 report_builder: Optional[Callable] = None):
        if publish_every < 1:
            raise ValueError(
                f"need publish_every >= 1 folds, got {publish_every}")
        # launch-time constants
        self._loop = _BlockLoop(pop, reg, cfg, telemetry)
        self.tel = self._loop.tel
        self.publish_every = int(publish_every)
        self.store = SnapshotStore(telemetry=self.tel)
        self.predictor = Predictor(self.store, telemetry=self.tel,
                                   device=self._loop.device)
        self._report_builder = report_builder
        self._age_gauge = self.tel.gauge("serve_snapshot_age_folds")
        self._publish_s = self.tel.histogram("serve_publish_s")

        self._versions = 0  # owner: main
        self._published_fold = -2  # owner: main  (-2 = nothing published)
        self._result: Optional[CohortRunResult] = None  # owner: main
        self._exc: Optional[BaseException] = None  # owner: main
        self._thread: Optional[threading.Thread] = None

        self._loop.on_fold = self._after_fold
        if prewarm:
            # version 0 = the deterministic cold state (balanced cluster
            # assignment, zero centroids): predictions are answerable from
            # t=0, before any training block folds
            self._publish(-1)

    # -- write side (training fold thread = the `main` role) ----------------

    def _publish(self, folded_through: int) -> None:  # worker: main
        t0 = tick()
        with self.tel.span("serve.publish", version=self._versions,
                           folded_through=folded_through):
            snap = ServedSnapshot.from_state(
                self._loop.state, version=self._versions,
                folded_through=folded_through)
            self.store.publish(snap)
        self._versions += 1
        self._published_fold = folded_through
        self._publish_s.observe(tick() - t0)

    def _after_fold(self, b: int) -> None:  # worker: main
        if (b + 1) % self.publish_every == 0:
            self._publish(b)
        self._age_gauge.set(float(b - self._published_fold))

    def run(self) -> CohortRunResult:  # worker: main
        """Train to completion on the CALLING thread (which thereby plays
        the ``main`` role); serve-role reads may run concurrently."""
        cfg = self._loop.cfg
        try:
            if cfg.overlap > 1 or cfg.staleness > 0:
                _run_blocks_pipelined(self._loop, cfg.rounds, cfg.overlap,
                                      cfg.staleness)
            else:
                _run_blocks_sequential(self._loop, cfg.rounds)
            if self._published_fold != cfg.rounds - 1:
                self._publish(cfg.rounds - 1)  # final state always served
            self._result = self._loop.result()
            return self._result
        except BaseException as e:  # noqa: BLE001 -- re-raised by join()
            self._exc = e
            raise

    def start(self) -> "ServeSession":
        """Launch ``run()`` on a background thread and return immediately;
        the session keeps answering predictions while it trains."""
        if self._thread is not None:
            raise RuntimeError("ServeSession already started")
        self._thread = threading.Thread(
            target=self._run_bg, name="serve-refresh", daemon=True)
        self._thread.start()
        return self

    def _run_bg(self) -> None:  # worker: main
        try:
            self.run()
        except BaseException as e:  # noqa: BLE001 -- join() re-raises it
            # not swallowed: run() captured it for join() to re-raise; the
            # event keeps the failure visible without the thread excepthook
            # printing mid-serve
            self.tel.event("serve.refresh_failed", error=type(e).__name__)

    def join(self, timeout: Optional[float] = None) -> CohortRunResult:
        """Wait for background training; re-raise its failure, else return
        the run result.  Raises ``TimeoutError`` if ``timeout`` seconds
        pass first."""
        if self._thread is None:
            raise RuntimeError("ServeSession.join() before start()")
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError(f"training still running after {timeout} s")
        if self._exc is not None:
            raise self._exc
        if self._result is None:
            raise RuntimeError("training thread ended without a result")
        return self._result

    # -- read side (any serve-role thread) ----------------------------------

    def predict(self, ids, X):  # worker: serve
        """(B,) decision margins for clients ``ids`` with features ``X``."""
        return self.predictor.predict(ids, X)

    def client_weights(self, ids):  # worker: serve
        """(B, d) served weights under the newest snapshot (host path)."""
        return self.store.current().client_weights(ids)

    @property
    def snapshot_version(self) -> int:
        return self.store.version

    @property
    def training(self) -> bool:
        """True while ``start()``'s training thread runs (a reader loop
        ends on this, whether training finished or failed)."""
        return self._thread is not None and self._thread.is_alive()

    # -- results -------------------------------------------------------------

    def result(self) -> Optional[CohortRunResult]:
        """The finished run result (None while training is in flight)."""
        return self._result

    def report(self):
        """Full API-level ``Report`` (evaluation + provenance), when the
        session was built by ``Experiment.serve()``."""
        if self._report_builder is None:
            raise RuntimeError(
                "no report builder: construct via Experiment.serve() to "
                "get API-level reports")
        res = self._result
        if res is None:
            raise RuntimeError("report() before training finished; call "
                               "run() or join() first")
        return self._report_builder(res)
