"""The port's online prediction tier against the JAX package's.

Mirrors the serving-tier tests of ``tests/test_serve.py`` (snapshot
resolution, checkpoint snapshots, id checks, the store's swaps, the
predictor against the host rule, prewarm, publish cadence, concurrent
reads during a faulty overlapped run, evaluation through the snapshot, the
API surface, spec validation) on the port, on the CPU, and holds the port
against the JAX package:

  * a ``ServedSnapshot`` built from the same ``ClusterOmega`` state (the
    JAX run's, restored into the port's class) equals the JAX package's
    bit for bit, and so do the two ``Predictor`` lookups on it; margins
    within f32 rounding (rtol 1e-5, atol 1e-6: a d-term dot product in
    another order);
  * a small ``Experiment.serve()`` session's per-block history and final
    state within the cohort parity contract of ``tests/
    test_torch_cohort.py`` (history rtol 1e-5 / atol 1e-4; state and
    served weights rtol 1e-4 / atol 1e-5).

Inside the port the JAX package's bit-identity contracts hold: serving on
equals serving off, the lookup equals the host rule.
"""
import os
import sys
import threading

import numpy as np
import pytest

import repro.api as japi
import repro.cohort as jco
import repro.core as jc
from repro.serve import Predictor as JaxPredictor
from repro.serve import ServedSnapshot as JaxServedSnapshot
from repro.serve import SnapshotStore as JaxSnapshotStore
import repro_torch.api as api
import repro_torch.core as tc
from repro_torch import obs
from repro_torch.cohort import (BlockFailure, ClusterOmega, CohortConfig,
                                FaultConfig, Population, PopulationSpec)
from repro_torch.cohort.driver import _run_cohort
from repro_torch.core import BudgetConfig, MochaConfig, Probabilistic
from repro_torch.core.evaluate import evaluate_cohort, holdout_client_ids
from repro_torch.core.losses import get_loss
from repro_torch.serve import (Predictor, ServedSnapshot, ServeSession,
                               SnapshotStore)
from repro_torch.serve.store import SENTINEL

SPEC = dict(name="t_serve", m=240, d=10, n_min=8, n_max=20, clusters=3)
POP_SPEC = PopulationSpec(**SPEC)
REG = dict(lam=1e-2, sigma2=10.0)
HIST_TOL = dict(rtol=1e-5, atol=1e-4)
STATE_TOL = dict(rtol=1e-4, atol=1e-5)
#: the margin <w, x>: d float32 products summed in another order
MARGIN_TOL = dict(rtol=1e-5, atol=1e-6)
JOIN_S = 120


def _cfg(**kw):
    base = dict(rounds=6, cohort=12, clusters=3, dropout=0.2,
                omega_update_every=2, record_every=1, seed=1,
                inner=MochaConfig(budget=BudgetConfig(passes=1.0),
                                  device="cpu"))
    base.update(kw)
    return CohortConfig(**base)


def _reg():
    return Probabilistic(**REG)


@pytest.fixture(scope="module")
def trained():
    pop = Population(POP_SPEC, seed=0)
    return pop, _run_cohort(pop, _reg(), _cfg())


def _inline_rule(state, ids):
    """The per-slot served-weight rule, inlined: the anchor every serve
    path must match bit for bit."""
    ids = np.asarray(ids, np.int64)
    W = state.centroids[state.assign[ids]].copy()
    for slot, t in enumerate(ids):
        hit = state._cache.get(int(t))
        if hit is not None:
            W[slot] += hit[1]
    return W


def test_snapshot_resolution_matches_inline_rule(trained):
    state = trained[1].relationship
    ids = np.arange(state.m)
    snap = ServedSnapshot.from_state(state, version=3, folded_through=5)
    assert snap.version == 3 and snap.folded_through == 5
    assert snap.n_cached == state.cached_clients > 0
    np.testing.assert_array_equal(snap.client_weights(ids),
                                  _inline_rule(state, ids))
    # ClusterOmega.client_weights goes through the SAME rule
    np.testing.assert_array_equal(state.client_weights(ids),
                                  _inline_rule(state, ids))
    assert snap.memory_bytes() == (snap.centroids.nbytes + snap.assign.nbytes
                                   + snap.cache_ids.nbytes
                                   + snap.cache_delta.nbytes)


def test_snapshot_from_checkpoint_dict_matches_live(trained):
    state = trained[1].relationship
    ids = np.arange(state.m)
    snap = ServedSnapshot.from_snapshot(state.snapshot(POP_SPEC.pad_width))
    np.testing.assert_array_equal(snap.client_weights(ids),
                                  _inline_rule(state, ids))
    assert snap.cache_ids.shape == (state.cache_clients,)
    assert (snap.cache_ids[snap.n_cached:] == SENTINEL).all()


def test_snapshot_rejects_out_of_range_ids(trained):
    snap = ServedSnapshot.from_state(trained[1].relationship)
    for bad in ([0, snap.m], [-1]):
        with pytest.raises(ValueError, match="client ids"):
            snap.client_weights(bad)


def test_store_swaps_atomically_and_requires_publish(trained):
    store = SnapshotStore()
    with pytest.raises(RuntimeError, match="no ServedSnapshot"):
        store.current()
    assert store.version == -1
    state = trained[1].relationship
    a = ServedSnapshot.from_state(state, version=0)
    b = ServedSnapshot.from_state(state, version=1, folded_through=5)
    store.publish(a)
    assert store.current() is a and store.version == 0
    store.publish(b)
    assert store.current() is b and store.version == 1
    assert store.swap_count == 2


def test_predictor_matches_host_lookup(trained):
    state = trained[1].relationship
    store = SnapshotStore()
    store.publish(ServedSnapshot.from_state(state, version=0))
    pred = Predictor(store, device="cpu")
    ids = np.arange(state.m)
    W_dev = pred.lookup(ids)
    np.testing.assert_array_equal(W_dev, _inline_rule(state, ids))
    X = np.random.default_rng(0).normal(
        size=(state.m, state.d)).astype(np.float32)
    z = pred.predict(ids, X)
    np.testing.assert_allclose(z, np.einsum("bd,bd->b", W_dev, X),
                               **MARGIN_TOL)
    assert pred.snapshot_version == 0 and pred.max_version_lag == 0
    with pytest.raises(ValueError, match="client ids"):
        pred.predict([state.m], X[:1])


def test_lookup_waiting_for_capture_lock_reads_the_newest_snapshot(
        trained, monkeypatch):
    """A lookup that waits for ``CAPTURE_LOCK`` (held by a capture or the
    pack thread's copies) while two snapshots are published answers under
    the newest one: the publishes that finish before it holds the lock are
    no lag, as in the JAX predictor, which takes no lock."""
    import repro_torch.serve.predict as predict_mod

    state = trained[1].relationship
    store = SnapshotStore()
    store.publish(ServedSnapshot.from_state(state, version=0))
    pred = Predictor(store, device="cpu")
    ids = np.arange(state.m)
    pred.lookup(ids)          # warmed on version 0
    lock = predict_mod.CAPTURE_LOCK
    waiting = threading.Event()

    class Announced:
        """CAPTURE_LOCK, announcing a thread that is about to wait on it."""

        def __enter__(self):
            waiting.set()
            lock.acquire()

        def __exit__(self, *exc):
            lock.release()

    monkeypatch.setattr(predict_mod, "CAPTURE_LOCK", Announced())
    got = []
    held, release = threading.Event(), threading.Event()

    def holder():             # a capture holding the lock
        with lock:
            held.set()
            release.wait(JOIN_S)

    h = threading.Thread(target=holder)
    h.start()
    assert held.wait(JOIN_S)
    r = threading.Thread(target=lambda: got.append(pred.lookup(ids)))
    r.start()
    assert waiting.wait(JOIN_S)
    store.publish(ServedSnapshot.from_state(state, version=1))
    store.publish(ServedSnapshot.from_state(state, version=2))
    release.set()
    h.join(JOIN_S)
    r.join(JOIN_S)
    assert not h.is_alive() and not r.is_alive()
    assert pred.snapshot_version == 2 and pred.max_version_lag == 0
    np.testing.assert_array_equal(got[0], _inline_rule(state, ids))


def test_serve_session_prewarm_serves_cold_centroids():
    """Predictions are answerable BEFORE any training block folds: the
    version-0 snapshot is the deterministic cold state."""
    pop = Population(POP_SPEC, seed=0)
    sess = ServeSession(pop, _reg(), _cfg(), publish_every=2)
    assert sess.snapshot_version == 0
    ids = np.arange(16)
    np.testing.assert_array_equal(sess.client_weights(ids),
                                  np.zeros((16, POP_SPEC.d), np.float32))
    z = sess.predict(ids, np.ones((16, POP_SPEC.d), np.float32))
    np.testing.assert_array_equal(z, np.zeros(16, np.float32))
    assert sess.predictor.device.type == "cpu"


def test_serve_session_publish_cadence():
    pop = Population(POP_SPEC, seed=0)
    tel = obs.telemetry()
    sess = ServeSession(pop, _reg(), _cfg(rounds=6), publish_every=2,
                        telemetry=tel)
    res = sess.run()
    # prewarm (v0) + folds 1, 3, 5 -> versions 1, 2, 3
    assert sess.snapshot_version == 3
    assert sess.store.current().folded_through == 5
    # the served state IS the final training state
    np.testing.assert_array_equal(
        sess.client_weights(np.arange(pop.m)),
        _inline_rule(res.relationship, np.arange(pop.m)))
    summary = obs.metrics_summary(tel)
    assert summary["serve_publish_s.count"] == 4
    assert summary["serve_swap_latency_s.count"] == 4
    assert summary["serve_snapshot_age_folds.last"] == 0.0
    assert tel.tracer.count("serve.publish") == 4
    assert tel.tracer.count("serve.swap") == 4
    with pytest.raises(ValueError, match="publish_every"):
        ServeSession(pop, _reg(), _cfg(), publish_every=0)


def test_serve_bit_identity_concurrent_reads_faulty_overlapped():
    """Serving on vs off gives the same bits for every training output,
    under an overlapped, faulty, degrading run with the caller's thread
    reading predictions throughout."""
    pop = Population(POP_SPEC, seed=0)
    kw = dict(overlap=2, staleness=1, max_retries=1, degrade=True,
              faults=FaultConfig(solve_fail_prob=0.3, seed=3))
    plain = _run_cohort(pop, _reg(), _cfg(**kw))

    sess = ServeSession(pop, _reg(), _cfg(**kw), publish_every=1)
    ids = np.arange(32)
    X = np.ones((32, POP_SPEC.d), np.float32)
    sess.predict(ids, X)
    sess.start()
    reads, versions = 0, []
    while sess.training:
        versions.append(int(sess.store.current().version))
        sess.predict(ids, X)
        reads += 1
    served = sess.join(JOIN_S)
    assert not sess.training
    # every read answered, versions only move forward, and a post-join read
    # serves the final snapshot
    assert reads > 0
    assert all(a <= b for a, b in zip(versions, versions[1:]))
    np.testing.assert_array_equal(sess.client_weights(ids),
                                  _inline_rule(served.relationship, ids))
    assert sess.snapshot_version == 6

    assert plain.history == served.history
    for k in ("centroids", "omega_k", "assign", "participation"):
        np.testing.assert_array_equal(getattr(plain, k), getattr(served, k))
    assert plain.fault_stats.retries == served.fault_stats.retries
    assert (plain.fault_stats.degraded_blocks
            == served.fault_stats.degraded_blocks)


def test_serve_session_failure_is_reraised_by_join():
    """A hard fault on the training thread is not swallowed: join()
    re-raises it and the telemetry records ``serve.refresh_failed``."""
    pop = Population(POP_SPEC, seed=0)
    tel = obs.telemetry()
    sess = ServeSession(pop, _reg(), _cfg(
        faults=FaultConfig(solve_fail_blocks=(2,))), telemetry=tel)
    sess.start()
    with pytest.raises(BlockFailure):
        sess.join(JOIN_S)
    assert sess.result() is None
    assert tel.tracer.count("serve.refresh_failed") == 1
    # the last published snapshot (block 1) keeps serving
    assert sess.store.current().folded_through == 1
    with pytest.raises(RuntimeError, match="already started"):
        sess.start()


def test_evaluate_cohort_serves_through_snapshot_bit_identical(trained):
    """The held-out evaluation consumes the serve lookup; its output equals
    the inline centroid + delta rule bit for bit."""
    pop, res = trained
    state = res.relationship
    rep = evaluate_cohort(pop, state, get_loss("hinge"), 25, seed=3,
                          participation=res.participation)
    ids = holdout_client_ids(pop.m, 25, 3, res.participation)
    W = _inline_rule(state, ids)
    errs = np.empty(ids.size)
    for i, t in enumerate(ids):
        blk = pop.client_block(int(t))
        errs[i] = float(np.mean(np.sign(blk.X @ W[i]) != np.sign(blk.y)))
    np.testing.assert_array_equal(rep.per_client["client"], ids)
    np.testing.assert_array_equal(rep.per_client["error"], errs)
    np.testing.assert_array_equal(rep.per_client["cluster"],
                                  np.asarray(state.assign)[ids])


def _experiment(pkg, pop, rounds=4, **ex):
    core = jc if pkg is japi else tc
    if pkg is api:
        ex.setdefault("device", "cpu")
    return pkg.Experiment(
        problem=pkg.Problem(population=pop),
        method=pkg.Method(regularizers=(core.Probabilistic(**REG),),
                          rounds=rounds,
                          budget=core.BudgetConfig(passes=1.0)),
        exec=pkg.Exec(cohort=12, clusters=3, **ex),
        eval=pkg.Eval(record_every=1, holdout_clients=20))


def test_experiment_serve_api_surface():
    pop = Population(POP_SPEC, seed=0)
    exp = _experiment(api, pop)
    sess = exp.serve(seed=1, serve=api.Serve(publish_every=2))
    res = sess.run()
    report = sess.report()
    # the session's report is the report Experiment.run() gives
    batch = exp.run(seed=1)
    assert report.result.history == batch.result.history
    np.testing.assert_array_equal(report.evaluation.per_client["error"],
                                  batch.evaluation.per_client["error"])
    assert report.provenance["path"] == "cohort"
    assert report.provenance["device"] == "cpu"
    assert res is sess.result()

    # non-cohort problems are rejected up front
    from repro_torch.data.synthetic import tiny_problem
    train, _ = tiny_problem(m=4, n=16, d=6, seed=0, device="cpu")
    single = api.Experiment(
        problem=api.Problem(train=train),
        method=api.Method(regularizers=(_reg(),), rounds=2),
        exec=api.Exec(device="cpu"))
    with pytest.raises(ValueError, match="cohort"):
        single.serve()


def test_serve_spec_validation():
    with pytest.raises(ValueError, match="publish_every"):
        api.Serve(publish_every=0)
    assert api.Serve() == api.Serve(publish_every=1, prewarm=True)


# -- against the JAX package -------------------------------------------------

@pytest.fixture(scope="module")
def jax_trained():
    pop = jco.Population(jco.PopulationSpec(**SPEC), seed=0)
    cfg = jco.CohortConfig(rounds=6, cohort=12, clusters=3, dropout=0.2,
                           omega_update_every=2, record_every=1, seed=1,
                           inner=jc.MochaConfig(
                               budget=jc.BudgetConfig(passes=1.0)))
    from repro.cohort.driver import _run_cohort as jax_run_cohort
    return jax_run_cohort(pop, jc.Probabilistic(**REG), cfg).relationship


def _restored(jstate):
    """The port's ClusterOmega holding the JAX run's final state."""
    state = ClusterOmega(jstate.m, jstate.k, jstate.d, _reg(),
                         eta=jstate.eta, cache_clients=jstate.cache_clients,
                         device="cpu")
    state.restore_state(jstate.snapshot(POP_SPEC.pad_width))
    return state


def test_served_snapshot_equals_jax_bit_for_bit(jax_trained):
    state = _restored(jax_trained)
    ids, jids = state.cache_entries(), jax_trained.cache_entries()
    np.testing.assert_array_equal(ids[0], jids[0])
    np.testing.assert_array_equal(ids[1], np.asarray(jids[1]))
    for build in ("from_state", "from_snapshot"):
        if build == "from_state":
            mine = ServedSnapshot.from_state(state, 2, 5)
            theirs = JaxServedSnapshot.from_state(jax_trained, 2, 5)
        else:
            raw = jax_trained.snapshot(POP_SPEC.pad_width)
            mine = ServedSnapshot.from_snapshot(raw, 2, 5)
            theirs = JaxServedSnapshot.from_snapshot(raw, 2, 5)
        for k in ("centroids", "assign", "cache_ids", "cache_delta"):
            a, b = getattr(mine, k), np.asarray(getattr(theirs, k))
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b, err_msg=f"{build} {k}")
        assert (mine.version, mine.folded_through, mine.n_cached) == (
            theirs.version, theirs.folded_through, theirs.n_cached)
    ids = np.arange(state.m)
    np.testing.assert_array_equal(state.client_weights(ids),
                                  np.asarray(jax_trained.client_weights(ids)))


def test_predictions_match_the_jax_predictor(jax_trained):
    state = _restored(jax_trained)
    store, jstore = SnapshotStore(), JaxSnapshotStore()
    store.publish(ServedSnapshot.from_state(state))
    jstore.publish(JaxServedSnapshot.from_state(jax_trained))
    pred, jpred = Predictor(store, device="cpu"), JaxPredictor(jstore)
    rng = np.random.default_rng(5)
    ids = rng.integers(0, state.m, 64)
    X = rng.normal(size=(64, state.d)).astype(np.float32)
    np.testing.assert_array_equal(pred.lookup(ids),
                                  np.asarray(jpred.lookup(ids)))
    np.testing.assert_allclose(pred.predict(ids, X),
                               np.asarray(jpred.predict(ids, X)),
                               **MARGIN_TOL)


def test_experiment_serve_session_matches_jax():
    kw = dict(overlap=2)
    jpop = jco.Population(jco.PopulationSpec(**SPEC), seed=0)
    jsess = _experiment(japi, jpop, rounds=6, **kw).serve(
        seed=1, serve=japi.Serve(publish_every=2))
    sess = _experiment(api, Population(POP_SPEC, seed=0), rounds=6,
                       **kw).serve(seed=1, serve=api.Serve(publish_every=2))
    jres, res = jsess.run(), sess.run()
    assert sess.snapshot_version == jsess.snapshot_version == 3
    jh, th = jres.history, res.history
    for k in ("round", "round_max_steps", "unique_clients"):
        assert th[k] == jh[k], k
    np.testing.assert_array_equal(th["time"], jh["time"])
    for k in ("dual", "primal", "gap"):
        np.testing.assert_allclose(th[k], jh[k], err_msg=k, **HIST_TOL)
    np.testing.assert_array_equal(res.assign, jres.assign)
    np.testing.assert_allclose(res.centroids, jres.centroids, **STATE_TOL)
    np.testing.assert_allclose(res.omega_k, jres.omega_k, **STATE_TOL)
    ids = np.arange(POP_SPEC.m)
    np.testing.assert_allclose(sess.client_weights(ids),
                               np.asarray(jsess.client_weights(ids)),
                               **STATE_TOL)
    X = np.random.default_rng(2).normal(
        size=(POP_SPEC.m, POP_SPEC.d)).astype(np.float32)
    np.testing.assert_allclose(sess.predict(ids, X),
                               np.asarray(jsess.predict(ids, X)),
                               **STATE_TOL)
    rep, jrep = sess.report(), jsess.report()
    np.testing.assert_array_equal(rep.evaluation.per_client["client"],
                                  jrep.evaluation.per_client["client"])


def test_concurrent_readers_each_with_their_own_predictor():
    """More serve threads than cores, each with its own Predictor over the
    shared store, read while training publishes, with a shortened switch
    interval: every answer equals the host rule on the snapshot it was
    read under, and each reader's versions only move forward."""
    pop = Population(POP_SPEC, seed=0)
    sess = ServeSession(pop, _reg(), _cfg(overlap=2), publish_every=1)
    ids = np.arange(0, POP_SPEC.m, 7)
    errors, seen = [], []

    def reader():
        pred = Predictor(sess.store, device="cpu")
        versions = []
        while sess.training:
            snap = sess.store.current()
            got = pred.lookup(ids)
            versions.append(pred.snapshot_version)
            if pred.snapshot_version == snap.version and not np.array_equal(
                    got, snap.client_weights(ids)):
                errors.append(snap.version)
        seen.append(versions)

    threads = [threading.Thread(target=reader)
               for _ in range(2 * (os.cpu_count() or 1) + 2)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        sess.start()
        for t in threads:
            t.start()
        sess.join(JOIN_S)
        for t in threads:
            t.join(JOIN_S)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert errors == []
    assert len(seen) == len(threads)
    assert all(a <= b for v in seen for a, b in zip(v, v[1:]))
