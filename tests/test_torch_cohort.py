"""The port's cross-device cohort path against the JAX package's.

What is numpy in both packages is held bit for bit: the population (client
blocks, sizes, clusters), the pre-sampled schedules, the packed layout and
sizes, the held-out client draw.  Whole cohort runs are held to the JAX
package's ``engine="local"`` within the parity contract: the per-block
history within rtol 1e-5 / atol 1e-4 (the simulated clock, budgets and
coverage equal), the final ``ClusterOmega`` state (centroids, ``omega_k``)
and ``client_weights`` within ``STATE_TOL`` (rtol 1e-4 / atol 1e-5), the
learned assignment and participation equal.  Inside the port, the JAX
package's bit-identity contracts hold between runs: the pipeline at
staleness 0 equals the sequential loop, telemetry on equals off, and a
fully-dropped block folds as zero participation.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.cohort as jco
import repro.core as jc
from repro.cohort.driver import _run_cohort as jax_run_cohort
from repro.core.evaluate import evaluate_cohort as jax_evaluate_cohort
from repro.core.evaluate import holdout_client_ids as jax_holdout_ids
from repro.core.systems_model import population_rates as jax_rates
import repro_torch.api as ta
import repro_torch.cohort as tco
import repro_torch.core as tc
from repro_torch.cohort.driver import _BlockLoop, _run_cohort
from repro_torch.core.mocha import MochaConfig, RoundProgram, _run_mocha

SPEC = dict(name="t_pop", m=400, d=12, n_min=12, n_max=32, clusters=3)
REG = dict(lam=1e-2, sigma2=10.0)
#: objectives of a whole run (the parity contract of tests/test_torch_mocha)
HIST_TOL = dict(rtol=1e-5, atol=1e-4)
#: primal and gap of a K = 256 cohort (~10^4 hinge terms): the JAX
#: reference's own jitted in-scan sum and its eager sum of the same W differ
#: by 3.4e-5 of the primal (float32 summation order), so the port is held
#: to 1e-4 there; the dual (and W, through the centroids) keep HIST_TOL
WIDE_SUM_TOL = dict(rtol=1e-4, atol=1e-4)
#: the final factored state and the served weights: float32 sums of the
#: solved W in another order, through a few folds and Omega steps
STATE_TOL = dict(rtol=1e-4, atol=1e-5)
#: the cohort runs held against the JAX package: CohortConfig kwargs
RUNS = {
    "sequential": dict(),
    "weighted_systems": dict(
        sampler="weighted", dropout=0.1,
        systems=dict(network="lte", rate_lo=0.5, rate_hi=2.0)),
    "pipelined_stale": dict(overlap=3, staleness=2),
    "inner_rounds_gamma": dict(inner_rounds=2, inner=dict(gamma=0.5)),
    "kernel_engine": dict(inner=dict(engine="kernel")),
}


def _spec(pkg, **kw):
    return pkg.PopulationSpec(**{**SPEC, **kw})


def _cfgs(**kw):
    """(JAX CohortConfig, port CohortConfig) of the same run; the port's
    ``inner.engine`` may be "kernel", the JAX package's stays "local"."""
    inner = dict(budget=dict(passes=1.0), **kw.pop("inner", {}))
    systems = kw.pop("systems", None)
    base = dict(rounds=6, cohort=12, clusters=3, dropout=0.2,
                omega_update_every=2, record_every=1, seed=1)
    base.update(kw)
    out = []
    for pkg, core in ((jco, jc), (tco, tc)):
        i = dict(inner, budget=core.BudgetConfig(**inner["budget"]))
        if pkg is jco:
            i["engine"] = "local"
        else:
            i["device"] = "cpu"
        out.append(pkg.CohortConfig(
            **base, inner=core.MochaConfig(**i),
            systems=None if systems is None else core.SystemsConfig(
                **systems)))
    return out


def _runs(spec_kw=None, seed=0, **kw):
    jcfg, tcfg = _cfgs(**kw)
    jres = jax_run_cohort(jco.Population(_spec(jco, **(spec_kw or {})), seed),
                          jc.Probabilistic(**REG), jcfg)
    tres = _run_cohort(tco.Population(_spec(tco, **(spec_kw or {})), seed),
                       tc.Probabilistic(**REG), tcfg)
    return jres, tres


def _hold_state(jres, tres):
    js, ts = jres.relationship, tres.relationship
    np.testing.assert_array_equal(ts.assign, js.assign)
    np.testing.assert_array_equal(ts.counts, js.counts)
    np.testing.assert_allclose(ts.centroids, js.centroids, **STATE_TOL)
    np.testing.assert_allclose(ts.omega_k, js.omega_k, **STATE_TOL)
    ids = np.arange(js.m)
    np.testing.assert_allclose(tres.client_weights(ids),
                               jres.client_weights(ids), **STATE_TOL)
    np.testing.assert_array_equal(tres.participation, jres.participation)


def _hold_history(jh, th, primal_tol=HIST_TOL):
    assert set(th) == set(tco.COHORT_HISTORY_KEYS) == set(jh)
    for k in ("round", "round_max_steps", "unique_clients"):
        assert th[k] == jh[k], k
    np.testing.assert_array_equal(th["time"], jh["time"])
    np.testing.assert_allclose(th["dual"], jh["dual"], **HIST_TOL)
    for k in ("primal", "gap"):
        np.testing.assert_allclose(th[k], jh[k], err_msg=k, **primal_tol)


def _same_bits(a, b):
    assert a.history == b.history
    for k in ("centroids", "omega_k", "assign"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    np.testing.assert_array_equal(a.participation, b.participation)
    np.testing.assert_array_equal(a.relationship.counts,
                                  b.relationship.counts)


# -- population, sampler, packer: bit for bit --------------------------------

@pytest.mark.parametrize("spec_kw", [
    {}, dict(skewed=True, n_min=3, difficulty_spread=0.5),
    dict(d=32, n_min=16, n_max=64, clusters=5)])
def test_population_bit_equal(spec_kw):
    jp = jco.Population(_spec(jco, **spec_kw), seed=3)
    tp = tco.Population(_spec(tco, **spec_kw), seed=3)
    np.testing.assert_array_equal(tp.centers, jp.centers)
    assert tp.resident_bytes == jp.resident_bytes
    ids = np.asarray([0, 5, 123, 399, 7, 7])
    for t in ids:
        jb, tb = jp.client_block(int(t)), tp.client_block(int(t))
        np.testing.assert_array_equal(tb.X, jb.X)
        np.testing.assert_array_equal(tb.y, jb.y)
        assert (tb.n, tb.cluster) == (jb.n, jb.cluster)
        assert tp.client_meta(int(t)) == jp.client_meta(int(t))
    np.testing.assert_array_equal(tp.client_sizes(ids), jp.client_sizes(ids))
    np.testing.assert_array_equal(tp.true_assignments(ids),
                                  jp.true_assignments(ids))


def test_population_specs_match():
    for name, spec in jco.POPULATIONS.items():
        assert dataclasses.asdict(tco.POPULATIONS[name]) == \
            dataclasses.asdict(spec)
    assert tco.CROSS_DEVICE_1M.m == 10 ** 6
    from repro.data.synthetic import HUMAN_ACTIVITY as JHA
    from repro_torch.data.synthetic import HUMAN_ACTIVITY as THA
    a = jco.PopulationSpec.from_federation(JHA, m=5000, n_pad=320)
    b = tco.PopulationSpec.from_federation(THA, m=5000, n_pad=320)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert b.pad_width == 320


def test_sample_client_size_and_block_match():
    from repro.data import synthetic as js
    from repro_torch.data import synthetic as ts
    for spec_kw in ({}, dict(skewed=True, n_min=3)):
        jspec = js.FederationSpec(**{**SPEC, **spec_kw})
        tspec = ts.FederationSpec(**{**SPEC, **spec_kw})
        rj, rt = np.random.default_rng(9), np.random.default_rng(9)
        for _ in range(5):
            assert ts.sample_client_size(rt, tspec) == \
                js.sample_client_size(rj, jspec)
        w, mu, sc = (np.random.default_rng(1).normal(size=SPEC["d"])
                     for _ in range(3))
        xj, yj = js.sample_client_block(rj, jspec, w, mu, sc, 17)
        xt, yt = ts.sample_client_block(rt, tspec, w, mu, sc, 17)
        np.testing.assert_array_equal(xt, xj)
        np.testing.assert_array_equal(yt, yj)


@pytest.mark.parametrize("kind,dropout", [("uniform", 0.0),
                                          ("uniform", 0.25),
                                          ("weighted", 0.1)])
def test_schedule_bit_equal(kind, dropout):
    m = 5000
    cfg = dict(network="lte", rate_lo=0.5, rate_hi=2.0, seed=4)
    wj = jax_rates(m, jc.SystemsConfig(**cfg))
    wt = tc.population_rates(m, tc.SystemsConfig(**cfg))
    np.testing.assert_array_equal(wt, wj)
    kw = dict(m=m, cohort=64, kind=kind, dropout=dropout)
    sj = jco.CohortSampler(**kw, weights=wj if kind == "weighted" else None)
    st = tco.CohortSampler(**kw, weights=wt if kind == "weighted" else None)
    a, b = sj.presample(seed=7, rounds=9), st.presample(seed=7, rounds=9)
    np.testing.assert_array_equal(b.ids, a.ids)
    np.testing.assert_array_equal(b.dropped, a.dropped)
    np.testing.assert_array_equal(b.participation_counts(m),
                                  a.participation_counts(m))
    np.testing.assert_array_equal(b.with_all_dropped(3).dropped,
                                  a.with_all_dropped(3).dropped)


def test_sampler_validation():
    with pytest.raises(ValueError, match="Assumption 2"):
        tco.CohortSampler(m=10, cohort=4, dropout=1.0).validate()
    with pytest.raises(ValueError, match="cohort size"):
        tco.CohortSampler(m=10, cohort=11).validate()
    with pytest.raises(ValueError, match="weights"):
        tco.CohortSampler(m=10, cohort=4, kind="weighted").validate()


def test_packed_cohort_bit_equal_and_reused_buffers():
    jp, tp = jco.Population(_spec(jco), 0), tco.Population(_spec(tco), 0)
    ids_a, ids_b = np.asarray([5, 0, 399, 7]), np.asarray([1, 2, 3, 4])
    packer = tco.CohortPacker(tp, 4, device="cpu")
    data_a, sizes_a = packer.pack(ids_a)
    ref, ref_sizes = jco.CohortPacker(jp, 4).pack(ids_a)
    for k in ("X", "y", "mask"):
        np.testing.assert_array_equal(getattr(data_a, k).numpy(),
                                      np.asarray(getattr(ref, k)))
    np.testing.assert_allclose(data_a.xnorm2.numpy(), np.asarray(ref.xnorm2),
                               rtol=1e-6)
    np.testing.assert_array_equal(sizes_a, ref_sizes)
    np.testing.assert_array_equal(data_a.n_t.numpy(), sizes_a)
    before = data_a.X.clone()
    data_b, sizes_b = packer.pack(ids_b)         # overwrites the buffers
    torch.testing.assert_close(data_a.X, before, rtol=0, atol=0)
    torch.testing.assert_close(
        data_b.X, tco.pack_cohort(tp, ids_b, device="cpu").X, rtol=0, atol=0)
    np.testing.assert_array_equal(sizes_b, tp.client_sizes(ids_b))
    with pytest.raises(ValueError, match="static per run"):
        packer.pack(np.asarray([1, 2]))


# -- whole runs against the JAX package --------------------------------------

@pytest.mark.parametrize("name", sorted(RUNS))
def test_cohort_run_matches_jax(name):
    jres, tres = _runs(**RUNS[name])
    np.testing.assert_array_equal(tres.schedule.ids, jres.schedule.ids)
    np.testing.assert_array_equal(tres.schedule.dropped,
                                  jres.schedule.dropped)
    np.testing.assert_array_equal(tres.rate_mult, jres.rate_mult)
    _hold_history(jres.history, tres.history)
    _hold_state(jres, tres)
    assert tres.captures == 0      # no CUDA graph on the CPU


def test_cohort_path_through_the_api_matches_jax():
    """The entry point: Experiment(problem=Problem(population=...)) routes
    to the cohort path on both packages, held-out clients included."""
    import repro.api as ja
    reps = []
    for api, pkg, core, ex in ((ja, jco, jc, {}), (ta, tco, tc,
                                                   dict(device="cpu"))):
        reps.append(api.Experiment(
            problem=api.Problem(population=pkg.Population(_spec(pkg), 0)),
            method=api.Method(regularizers=(core.Probabilistic(**REG),),
                              rounds=5, omega_update_every=2,
                              budget=core.BudgetConfig(passes=1.0)),
            systems=api.Systems(dropout=0.1),
            exec=api.Exec(cohort=16, clusters=3, overlap=2, **ex),
            eval=api.Eval(holdout_clients=20)).run(seed=2))
    jrep, trep = reps
    assert (trep.provenance["path"], trep.provenance["driver"]) == (
        "cohort", "scan")
    assert trep.provenance["device"] == "cpu"
    assert (trep.provenance["retries"], trep.provenance["degraded_blocks"]) \
        == (0, 0)
    _hold_history(jrep.history, trep.history)
    _hold_state(jrep.result, trep.result)
    je, te = jrep.evaluation, trep.evaluation
    for k in ("client", "cluster", "n_holdout", "error"):
        np.testing.assert_array_equal(te.per_client[k], je.per_client[k])
    np.testing.assert_allclose(te.per_client["loss"], je.per_client["loss"],
                               rtol=1e-5, atol=1e-6)
    for k in je.per_cluster:
        np.testing.assert_allclose(te.per_cluster[k], je.per_cluster[k],
                                   rtol=1e-5, atol=1e-6)


def test_population_1m_routes_to_cohort_and_runs_on_cpu():
    """The acceptance case: CROSS_DEVICE_1M with K = 256 routes to the
    cohort path; on the CPU (two blocks) it runs and matches the JAX
    package's first blocks."""
    import repro.api as ja
    exp = ta.Experiment(
        problem=ta.Problem(population=tco.Population(tco.CROSS_DEVICE_1M)),
        exec=ta.Exec(cohort=256))
    plan = exp.route()
    assert (plan.path, plan.driver) == ("cohort", "scan")
    reps = []
    for api, pkg, core, ex in ((ja, jco, jc, {}), (ta, tco, tc,
                                                   dict(device="cpu"))):
        reps.append(api.Experiment(
            problem=api.Problem(population=pkg.Population(
                pkg.CROSS_DEVICE_1M)),
            method=api.Method(regularizers=(core.Probabilistic(**REG),),
                              rounds=2, budget=core.BudgetConfig(
                                  passes=1.0)),
            systems=api.Systems(sampler="weighted", dropout=0.1,
                                config=core.SystemsConfig(
                                    network="lte", rate_lo=0.5,
                                    rate_hi=2.0)),
            exec=api.Exec(cohort=256, clusters=5, **ex)).run(0))
    _hold_history(reps[0].history, reps[1].history, WIDE_SUM_TOL)
    np.testing.assert_array_equal(reps[1].result.schedule.ids,
                                  reps[0].result.schedule.ids)
    np.testing.assert_allclose(reps[1].result.centroids,
                               reps[0].result.centroids, **STATE_TOL)


def test_default_device_is_the_card_for_populations():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is available")
    exp = ta.Experiment(problem=ta.Problem(population=tco.Population(
        _spec(tco))), method=ta.Method(rounds=1), exec=ta.Exec(cohort=4))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        exp.run(0)


def test_evaluate_cohort_matches_jax():
    jres, tres = _runs()
    part = tres.participation
    for n in (0, 7, 40):
        np.testing.assert_array_equal(
            tc.holdout_client_ids(SPEC["m"], n, 3, part),
            jax_holdout_ids(SPEC["m"], n, 3, jres.participation))
    np.testing.assert_array_equal(tc.holdout_client_ids(50, 10, 1),
                                  jax_holdout_ids(50, 10, 1))
    je = jax_evaluate_cohort(jco.Population(_spec(jco), 0),
                             jres.relationship, jc.get_loss("hinge"), 30,
                             seed=3, participation=jres.participation)
    te = tc.evaluate_cohort(tco.Population(_spec(tco), 0),
                            tres.relationship, tc.get_loss("hinge"), 30,
                            seed=3, participation=part)
    assert set(te.per_client) == set(je.per_client)
    for k in ("client", "cluster", "n_holdout", "error"):
        np.testing.assert_array_equal(te.per_client[k], je.per_client[k])
    np.testing.assert_allclose(te.per_client["loss"], je.per_client["loss"],
                               rtol=1e-5, atol=1e-6)
    assert te.summary.keys() == je.summary.keys()
    empty = tc.evaluate_cohort(tco.Population(_spec(tco), 0),
                               tres.relationship, tc.get_loss("hinge"), 0)
    assert empty.summary == {"holdout_clients": 0.0}


# -- the JAX package's contracts, inside the port ----------------------------

def test_pipeline_staleness0_bit_identical_to_sequential():
    pop = tco.Population(_spec(tco), 0)
    _, cfg = _cfgs(rounds=8)
    seq = _run_cohort(pop, tc.Probabilistic(**REG), cfg)
    for depth in (2, 4):
        pipe = _run_cohort(pop, tc.Probabilistic(**REG),
                           dataclasses.replace(cfg, overlap=depth))
        _same_bits(seq, pipe)


def test_stale_pipeline_deterministic_and_bounded():
    pop = tco.Population(_spec(tco), 0)
    _, cfg = _cfgs(rounds=12, cohort=16, overlap=4, staleness=2)
    a = _run_cohort(pop, tc.Probabilistic(**REG), cfg)
    b = _run_cohort(pop, tc.Probabilistic(**REG), cfg)
    _same_bits(a, b)
    seq = _run_cohort(pop, tc.Probabilistic(**REG), dataclasses.replace(
        cfg, overlap=1, staleness=0))
    assert not np.array_equal(a.centroids, seq.centroids)
    np.testing.assert_array_equal(a.participation, seq.participation)
    assert a.history["primal"][-1] < a.history["primal"][0]


def test_telemetry_on_equals_off():
    from repro_torch import obs
    pop = tco.Population(_spec(tco), 0)
    _, cfg = _cfgs(overlap=2, staleness=1, max_retries=1, degrade=True,
                   faults=tco.FaultConfig(solve_fail_prob=0.3, seed=3))
    plain = _run_cohort(pop, tc.Probabilistic(**REG), cfg)
    tel = obs.telemetry()
    traced = _run_cohort(pop, tc.Probabilistic(**REG),
                         dataclasses.replace(cfg, telemetry=True),
                         telemetry=tel)
    _same_bits(plain, traced)
    assert tel.tracer.count("mocha.run") == cfg.rounds - \
        traced.fault_stats.degraded_blocks


def test_all_dropped_block_folds_zero_participation(monkeypatch):
    pop = tco.Population(_spec(tco), 0)
    dead = 2
    _, cfg = _cfgs(dropout=0.0)
    reg = tc.Probabilistic(**REG)
    loop = _BlockLoop(pop, reg, cfg)
    loop.schedule = loop.schedule.with_all_dropped(dead)
    for b in range(cfg.rounds):
        ids, dropped, alpha0, omega0 = loop.launch_args(b)
        packed = loop.pack_block(b)
        s = loop.solve_block(b, packed, ids, dropped, alpha0, omega0)
        if b == dead:
            assert not s.participated.any()
            cen, omk = loop.state.centroids.copy(), loop.state.omega_k.copy()
            seen = loop.seen.copy()
        loop.fold(b, ids, packed.sizes, s)
        if b == dead:
            np.testing.assert_array_equal(loop.state.centroids, cen)
            np.testing.assert_array_equal(loop.state.omega_k, omk)
            np.testing.assert_array_equal(loop.seen, seen)
    seq = loop.result()
    np.testing.assert_array_equal(
        seq.participation, seq.schedule.participation_counts(SPEC["m"]))
    orig = tco.CohortSampler.presample
    monkeypatch.setattr(
        tco.CohortSampler, "presample",
        lambda self, seed, rounds: orig(self, seed,
                                        rounds).with_all_dropped(dead))
    pipe = _run_cohort(pop, reg, dataclasses.replace(cfg, overlap=3))
    assert pipe.schedule.dropped[dead].all()
    _same_bits(seq, pipe)


def test_full_participation_degrades_to_run_mocha():
    """K = m, uniform, no dropout, fixed Omega: the cohort loop is plain
    MOCHA on the (permuted) population with the expanded Omega."""
    m, eta, rounds = 32, 0.5, 150
    spec = tco.PopulationSpec("parity", m=m, d=10, n_min=16, n_max=32,
                              clusters=2)
    pop = tco.Population(spec, seed=0)
    reg = tc.Probabilistic(**REG)
    cfg = tco.CohortConfig(rounds=rounds, cohort=m, clusters=1, eta=eta,
                           dropout=0.0, sampler="uniform",
                           omega_update_every=0, record_every=rounds, seed=4,
                           inner=MochaConfig(budget=tc.BudgetConfig(
                               passes=2.0), device="cpu"))
    res_c = _run_cohort(pop, reg, cfg)
    data = tco.pack_cohort(pop, np.arange(m), device="cpu")
    om0 = float(reg.init_omega(1, device="cpu")[0, 0])
    omega_full = om0 * np.ones((m, m)) + eta * np.eye(m)
    res_f = _run_mocha(data, reg, MochaConfig(
        rounds=rounds, budget=tc.BudgetConfig(passes=2.0),
        record_every=rounds, seed=4, device="cpu"), omega0=omega_full)
    pc, pf = res_c.final("primal"), res_f.final("primal")
    assert abs(pc - pf) / abs(pf) < 2e-2
    assert pc < 0.8 * float(data.mask.sum())
    assert res_c.final("unique_clients") == m


def test_one_round_program_serves_every_block():
    """The pre-sampled driver's program is built once per run and reused:
    the cache holds one program whatever the number of blocks, and a block
    replayed through it gives the loop driver's bits."""
    pop = tco.Population(_spec(tco), 0)
    reg = tc.Probabilistic(**REG)
    _, cfg = _cfgs(rounds=5, inner_rounds=2)
    loop = _BlockLoop(pop, reg, cfg)
    from repro_torch.cohort.driver import _run_blocks_sequential
    _run_blocks_sequential(loop, cfg.rounds)
    assert len(loop._programs) == 1
    scanned = loop.result()
    looped = _run_cohort(pop, reg, dataclasses.replace(
        cfg, inner=dataclasses.replace(cfg.inner, driver="loop")))
    _same_bits(scanned, looped)
    before = RoundProgram.captures
    assert scanned.captures == 0 and RoundProgram.captures == before


# -- state, schema, memory ----------------------------------------------------

def test_history_schema_and_serving_weights():
    _, tres = _runs()
    lengths = {k: len(v) for k, v in tres.history.items()}
    assert len(set(lengths.values())) == 1
    times = tres.history["time"]
    assert all(b > a for a, b in zip(times, times[1:]))
    W = tres.client_weights([0, 1, 2])
    assert W.shape == (3, SPEC["d"]) and W.dtype == np.float32
    with pytest.raises(ValueError, match="client ids"):
        tres.client_weights([SPEC["m"]])


def test_bounded_memory_structural():
    m, cache = 2000, 64
    pop = tco.Population(_spec(tco, m=m), 0)
    _, cfg = _cfgs(cache_clients=cache)
    res = _run_cohort(pop, tc.Probabilistic(**REG), cfg)
    state = res.relationship
    k, d, n_pad = cfg.clusters, SPEC["d"], SPEC["n_max"]
    assert state.omega_k.shape == (k, k) and state.assign.shape == (m,)
    assert state.cached_clients <= cache
    budget = (4 * m + 8 * m + 8 * k * k + 8 * k * d + 8 * k
              + cache * 4 * (n_pad + d) + 4096)
    assert state.memory_bytes() <= budget


def test_staleness_merger_orders_folds_and_bounds_launches():
    reg = tc.Probabilistic(**REG)
    state = tco.ClusterOmega(m=10, k=2, d=4, reg=reg, device="cpu")
    mg = tco.StalenessBoundedMerger(state, reg, staleness=1)
    assert mg.admissible(0) and mg.admissible(1) and not mg.admissible(2)
    ids = np.arange(3)
    args = (np.zeros((3, 4), np.float32), np.zeros((3, 8), np.float32),
            np.full(3, 8, np.int64), np.ones(3, bool))
    with pytest.raises(RuntimeError, match="out-of-order"):
        mg.fold(1, ids, *args)
    mg.fold(0, ids, *args)
    assert mg.merged_through == 0 and mg.admissible(2)
    with pytest.raises(ValueError, match="staleness"):
        tco.StalenessBoundedMerger(state, reg, staleness=-1)


def test_cluster_omega_updates_match_jax_and_snapshot_roundtrips():
    """The fold, the cluster-space Omega step and the LRU cache on the same
    statistics as the JAX package's ClusterOmega; snapshot / restore then
    round-trips the cache under eviction."""
    m, k, d, cap, n_pad = 60, 3, 5, 8, 7
    rng = np.random.default_rng(1)
    jreg, treg = jc.Probabilistic(**REG), tc.Probabilistic(**REG)
    a = jco.ClusterOmega(m, k, d, jreg, cache_clients=cap)
    b = tco.ClusterOmega(m, k, d, treg, cache_clients=cap, device="cpu")
    for step in range(10):
        ids = np.sort(rng.choice(m, size=6, replace=False)).astype(np.int64)
        W = rng.normal(size=(6, d)).astype(np.float32)
        alpha = rng.normal(size=(6, n_pad)).astype(np.float32)
        sizes = rng.integers(2, n_pad + 1, size=6)
        part = rng.random(6) < 0.8
        part[0] = True
        for st in (a, b):
            st.update(ids, W, alpha, sizes, part)
        if step % 3 == 2:
            a.refresh_omega(jreg)
            b.refresh_omega(treg)
        np.testing.assert_array_equal(b.cohort_alpha(ids, n_pad),
                                      a.cohort_alpha(ids, n_pad))
    sa, sb = a.snapshot(n_pad), b.snapshot(n_pad)
    for key in sa:
        if key == "omega_k":
            np.testing.assert_allclose(sb[key], sa[key], **STATE_TOL)
        else:
            np.testing.assert_array_equal(sb[key], sa[key], err_msg=key)
    np.testing.assert_allclose(b.cohort_block(ids),
                               np.asarray(a.cohort_omega(ids)), **STATE_TOL)
    assert b.cohort_omega(ids).dtype == torch.float32
    np.testing.assert_array_equal(b.client_weights(np.arange(m)),
                                  a.client_weights(np.arange(m)))
    c = tco.ClusterOmega(m, k, d, treg, cache_clients=cap, device="cpu")
    c.restore_state(sb)
    for key, val in sb.items():
        np.testing.assert_array_equal(c.snapshot(n_pad)[key], val)
