"""The port's fault-tolerant cohort runtime against the JAX package's.

The fault plan is numpy in both packages and is held bit for bit; a faulty
run degrades the same blocks and counts the same retries as the JAX
package's, with its history within the parity contract (rtol 1e-5 / atol
1e-4, the simulated clock equal).  Inside the port, a run crashed by a hard
fault and resumed from its checkpoints equals the uninterrupted run bit for
bit at every (overlap, staleness), and a checkpoint of another computation
refuses to resume.
"""
import dataclasses

import numpy as np
import pytest

import repro.cohort as jco
import repro.core as jc
from repro.cohort.driver import _run_cohort as jax_run_cohort
from repro.cohort.resilience import run_fingerprint as jax_fingerprint
import repro_torch.cohort as tco
import repro_torch.core as tc
from repro_torch.cohort.driver import _run_cohort
from repro_torch.cohort.resilience import (ASSUMPTION2_MAX_P, backoff_delay,
                                           run_fingerprint)
from repro_torch.train import checkpoint as ckpt

SPEC = dict(name="t_res", m=400, d=12, n_min=12, n_max=32, clusters=3)
REG = dict(lam=1e-2, sigma2=10.0)
HIST_TOL = dict(rtol=1e-5, atol=1e-4)


def _cfg(pkg=tco, core=tc, **kw):
    base = dict(rounds=8, cohort=16, clusters=3, dropout=0.2,
                omega_update_every=2, record_every=1, seed=1)
    base.update(kw)
    inner = dict(budget=core.BudgetConfig(passes=1.0))
    if pkg is tco:
        inner["device"] = "cpu"
    return pkg.CohortConfig(**base, inner=core.MochaConfig(**inner))


def _run(**kw):
    return _run_cohort(tco.Population(tco.PopulationSpec(**SPEC), 0),
                       tc.Probabilistic(**REG), _cfg(**kw))


def _same_bits(a, b):
    assert a.history == b.history
    for k in ("centroids", "omega_k", "assign", "participation"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    np.testing.assert_array_equal(a.relationship.counts,
                                  b.relationship.counts)


def _expected_counts(plan):
    """(retries, degraded) straight from the plan: pack attempts until
    success, then solve attempts; a seam failing every attempt degrades the
    block and skips the later seam."""
    retries = degraded = 0
    for b in range(plan.rounds):
        pf, sf = plan.pack_fail[b], plan.solve_fail[b]
        if pf.all():
            retries += plan.attempts
            degraded += 1
            continue
        retries += int(np.argmax(~pf))
        if sf.all():
            retries += plan.attempts
            degraded += 1
            continue
        retries += int(np.argmax(~sf))
    return retries, degraded


# -- the plan: bit for bit ----------------------------------------------------

@pytest.mark.parametrize("fc", [
    dict(pack_fail_prob=0.3, solve_fail_prob=0.3, fold_delay_prob=0.5,
         fold_delay_s=2.5),
    dict(solve_fail_prob=0.25, pack_fail_prob=0.125, fold_delay_prob=0.25,
         fold_delay_s=2.0, seed=4),
    dict(solve_fail_blocks=(2, 5), pack_fail_blocks=(3,), backoff_s=1.5,
         backoff_cap_s=10.0)])
def test_fault_plan_bit_equal(fc):
    a = jco.FaultPlan.presample(jco.FaultConfig(**fc), seed=7, rounds=20,
                                max_retries=2)
    b = tco.FaultPlan.presample(tco.FaultConfig(**fc), seed=7, rounds=20,
                                max_retries=2)
    for k in ("pack_fail", "solve_fail", "fold_delay_s"):
        np.testing.assert_array_equal(getattr(b, k), getattr(a, k))
    np.testing.assert_array_equal(b.degraded_blocks(), a.degraded_blocks())
    assert [b.backoff(i) for i in range(6)] == [a.backoff(i)
                                                for i in range(6)]


def test_fault_plan_hard_blocks_backoff_and_validation():
    plan = tco.FaultPlan.presample(
        tco.FaultConfig(solve_fail_blocks=(2, 5), pack_fail_blocks=(3,),
                        backoff_s=1.5, backoff_cap_s=10.0), 0, 6, 3)
    np.testing.assert_array_equal(plan.degraded_blocks(),
                                  [False, False, True, True, False, True])
    assert [plan.backoff(a) for a in range(5)] == [1.5, 3.0, 6.0, 10.0, 10.0]
    assert backoff_delay(0) == 1.0 and backoff_delay(50, cap_s=60.0) == 60.0
    with pytest.raises(ValueError, match="solve_fail_prob"):
        tco.FaultPlan.presample(tco.FaultConfig(solve_fail_prob=1.5), 0, 4, 0)
    with pytest.raises(ValueError, match="backoff_s"):
        tco.FaultPlan.presample(tco.FaultConfig(backoff_s=-1.0), 0, 4, 0)
    with pytest.raises(ValueError, match="max_retries"):
        tco.FaultPlan.presample(tco.FaultConfig(), 0, 4, -1)


def test_assumption2_guard_aborts_before_running():
    plan = tco.FaultPlan.presample(tco.FaultConfig(solve_fail_prob=1.0),
                                   0, 8, 0)
    with pytest.raises(ValueError, match="Assumption 2"):
        plan.validate_assumption2(0.0)
    half = tco.FaultPlan.presample(
        tco.FaultConfig(solve_fail_blocks=tuple(range(8))), 0, 8, 0)
    with pytest.raises(ValueError, match="Assumption 2"):
        half.validate_assumption2(ASSUMPTION2_MAX_P - 0.01)
    with pytest.raises(ValueError, match="Assumption 2"):
        _run(degrade=True, faults=tco.FaultConfig(solve_fail_prob=1.0))


# -- faulty runs against the JAX package --------------------------------------

@pytest.mark.parametrize("name,kw", [
    ("transient", dict(max_retries=2, degrade=True, faults=dict(
        solve_fail_prob=0.3, pack_fail_prob=0.2, seed=0))),
    ("degraded_overlapped", dict(max_retries=1, degrade=True, overlap=2,
                                 staleness=1, faults=dict(
                                     solve_fail_prob=0.25,
                                     solve_fail_blocks=(3,),
                                     fold_delay_prob=0.3, seed=5)))])
def test_faulty_run_matches_jax(name, kw):
    fc = kw.pop("faults")
    jres = jax_run_cohort(jco.Population(jco.PopulationSpec(**SPEC), 0),
                          jc.Probabilistic(**REG),
                          _cfg(jco, jc, faults=jco.FaultConfig(**fc), **kw))
    tres = _run(faults=tco.FaultConfig(**fc), **kw)
    assert (tres.fault_stats.retries, tres.fault_stats.degraded_blocks) == (
        jres.fault_stats.retries, jres.fault_stats.degraded_blocks)
    plan = tco.FaultPlan.presample(tco.FaultConfig(**fc), 1, 8,
                                   kw["max_retries"])
    assert (tres.fault_stats.retries,
            tres.fault_stats.degraded_blocks) == _expected_counts(plan)
    jh, th = jres.history, tres.history
    for k in ("round", "round_max_steps", "unique_clients"):
        assert th[k] == jh[k], k
    np.testing.assert_array_equal(th["time"], jh["time"])
    for k in ("dual", "primal", "gap"):
        np.testing.assert_allclose(th[k], jh[k], err_msg=k, **HIST_TOL)
    np.testing.assert_array_equal(tres.participation, jres.participation)
    np.testing.assert_array_equal(tres.assign, jres.assign)


def test_fingerprint_matches_the_rule():
    """The fingerprint covers what is computed and normalizes out the
    resilience and telemetry knobs, as the JAX package's does."""
    pop = tco.Population(tco.PopulationSpec(**SPEC), 0)
    reg = tc.Probabilistic(**REG)
    base = _cfg(rounds=4)
    fp = run_fingerprint(pop, reg, base)
    assert len(fp) == 12 and fp == run_fingerprint(pop, reg, base)
    assert fp == run_fingerprint(pop, reg, dataclasses.replace(
        base, max_retries=3, degrade=True, checkpoint_every=7,
        checkpoint_dir="elsewhere", resume=True, telemetry=True,
        trace_dir="traces", faults=tco.FaultConfig(solve_fail_prob=0.5)))
    assert fp != run_fingerprint(pop, reg, dataclasses.replace(base,
                                                               rounds=5))
    jfp = jax_fingerprint(jco.Population(jco.PopulationSpec(**SPEC), 0),
                          jc.Probabilistic(**REG), _cfg(jco, jc, rounds=4))
    assert len(jfp) == len(fp)


# -- the JAX package's contracts, inside the port -----------------------------

def test_zero_fault_path_bit_identical(tmp_path):
    plain = _run()
    armed = _run(max_retries=2, degrade=True, faults=tco.FaultConfig())
    _same_bits(plain, armed)
    assert (armed.fault_stats.retries,
            armed.fault_stats.degraded_blocks) == (0, 0)
    _same_bits(plain, _run(checkpoint_every=2,
                           checkpoint_dir=str(tmp_path / "ck")))
    _same_bits(plain, _run(overlap=3, max_retries=2, degrade=True,
                           faults=tco.FaultConfig(), checkpoint_every=2,
                           checkpoint_dir=str(tmp_path / "ck2")))


def test_retries_cost_only_simulated_time():
    res = _run(max_retries=2, degrade=True, faults=tco.FaultConfig(
        solve_fail_prob=0.3, pack_fail_prob=0.2, seed=0))
    ref = _run()
    assert res.fault_stats.retries > 0
    assert res.final("time") > ref.final("time")
    for key in ref.history:
        if key != "time":
            assert res.history[key] == ref.history[key], key
    np.testing.assert_array_equal(res.centroids, ref.centroids)


def test_degraded_block_folds_as_dropped_nodes():
    dead = 2
    res = _run(max_retries=1, degrade=True,
               faults=tco.FaultConfig(solve_fail_blocks=(dead,)))
    assert (res.fault_stats.degraded_blocks, res.fault_stats.retries) == (1,
                                                                          2)
    h = res.history
    for key in ("dual", "primal", "gap"):
        assert h[key][dead] == h[key][dead - 1], key
    assert h["time"][dead] > h["time"][dead - 1]
    assert h["unique_clients"][dead] == h["unique_clients"][dead - 1]
    assert h["round_max_steps"][dead] == 0 < h["round_max_steps"][dead + 1]


def test_block_failure_without_degradation_names_the_remedy():
    with pytest.raises(tco.BlockFailure, match="degrade") as ei:
        _run(faults=tco.FaultConfig(solve_fail_blocks=(1,)))
    assert (ei.value.block, ei.value.stage) == (1, "solve")


@pytest.mark.parametrize("overlap,staleness", [(1, 0), (4, 0), (3, 2)])
def test_checkpoint_resume_bit_identical(tmp_path, overlap, staleness):
    """Crash at block 6 with a planted hard fault, resume from the
    checkpoints without the fault: the same bits as the uninterrupted
    run."""
    kw = dict(rounds=10, overlap=overlap, staleness=staleness)
    ref = _run(**kw)
    ckdir = str(tmp_path / "ck")
    with pytest.raises(tco.BlockFailure) as ei:
        _run(**kw, checkpoint_every=2, checkpoint_dir=ckdir,
             faults=tco.FaultConfig(solve_fail_blocks=(6,)))
    assert (ei.value.block, ei.value.stage) == (6, "solve")
    res = _run(**kw, checkpoint_every=2, checkpoint_dir=ckdir, resume=True)
    assert res.resumed_from is not None and 0 <= res.resumed_from < 6
    _same_bits(res, ref)
    assert res.schedule.ids.tolist() == ref.schedule.ids.tolist()


def test_resume_refuses_a_mismatched_fingerprint(tmp_path):
    ckdir = str(tmp_path / "ck")
    _run(rounds=4, checkpoint_every=2, checkpoint_dir=ckdir)
    with pytest.raises(ValueError, match="config hash"):
        _run(rounds=4, dropout=0.3, checkpoint_every=2, checkpoint_dir=ckdir,
             resume=True)
    with pytest.raises(FileNotFoundError):
        _run(rounds=4, checkpoint_dir=str(tmp_path / "empty"), resume=True)


def test_pipelined_solve_failure_folds_predecessors_and_checkpoints(
        tmp_path):
    ckdir = str(tmp_path / "ck")
    with pytest.raises(tco.BlockFailure) as ei:
        _run(rounds=10, overlap=3, staleness=2, checkpoint_dir=ckdir,
             faults=tco.FaultConfig(solve_fail_blocks=(5,)))
    assert (ei.value.block, ei.value.stage) == (5, "solve")
    assert ckpt.latest_step(ckdir) == 4


def test_pipelined_pack_failure_respects_drain_schedule(tmp_path):
    ckdir = str(tmp_path / "ck")
    fail, staleness = 4, 2
    with pytest.raises(tco.BlockFailure) as ei:
        _run(rounds=10, overlap=3, staleness=staleness, checkpoint_dir=ckdir,
             faults=tco.FaultConfig(pack_fail_blocks=(fail,)))
    assert (ei.value.block, ei.value.stage) == (fail, "pack")
    assert ckpt.latest_step(ckdir) == fail - 1 - staleness
    ref = _run(rounds=10, overlap=3, staleness=staleness)
    res = _run(rounds=10, overlap=3, staleness=staleness,
               checkpoint_dir=ckdir, resume=True)
    assert res.resumed_from == fail - 1 - staleness
    _same_bits(res, ref)
