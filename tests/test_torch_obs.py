"""The port's telemetry layer (repro_torch.obs) against the JAX package's.

The units (tracer, metrics, Chrome export, summarize CLI) are held to the
JAX package's behaviour on the same inputs; the off path is inert; and a
faulty overlapped cohort run records the same span names, span counts and
counters as the JAX package's run of the same configuration
(``tests/test_obs.py``'s), its spans coming from the same seams.
"""
import dataclasses
import json
from collections import Counter

import numpy as np
import pytest

import repro.cohort as jco
import repro.core as jc
from repro import obs as jobs
from repro.cohort.driver import _run_cohort as jax_run_cohort
import repro_torch.api as ta
import repro_torch.cohort as tco
import repro_torch.core as tc
from repro_torch import obs
from repro_torch.cohort.driver import _run_cohort
from repro_torch.data.synthetic import tiny_problem
from repro_torch.obs import summarize as summarize_mod
from repro_torch.obs.metrics import percentile
from repro_torch.utils import timing

SPEC = dict(name="t_obs", m=240, d=10, n_min=8, n_max=20, clusters=3)
REG = dict(lam=1e-2, sigma2=10.0)


def _cfg(pkg=tco, core=tc, **kw):
    base = dict(rounds=6, cohort=12, clusters=3, dropout=0.2,
                omega_update_every=2, record_every=1, seed=1)
    base.update(kw)
    inner = dict(budget=core.BudgetConfig(passes=1.0))
    if pkg is tco:
        inner["device"] = "cpu"
    return pkg.CohortConfig(**base, inner=core.MochaConfig(**inner))


def _sample_tel(o):
    tel = o.telemetry()
    clock = {"now": 0.0}
    tel.set_sim_clock(lambda: clock["now"])
    with tel.for_worker("pack").span("pack", block=0):
        clock["now"] = 1.0
    with tel.for_worker("solve").span("solve", block=0):
        clock["now"] = 3.0
    tel.for_worker("solve").event("retry", block=0, attempt=0)
    with tel.span("fold", block=0):
        pass
    tel.counter("blocks_folded").inc()
    return tel


def _shape(doc):
    """A trace document without its wall-clock numbers."""
    out = []
    for ev in doc["traceEvents"]:
        ev = dict(ev)
        if ev.get("cat") == "wall":
            ev.pop("ts", None)
            ev.pop("dur", None)
        if ev.get("name") == "process_name":
            ev["args"] = {}
        out.append(ev)
    return out


# -- units --------------------------------------------------------------------

def test_null_telemetry_is_inert():
    tel = obs.NULL_TELEMETRY
    assert not tel.enabled
    with tel.span("anything", block=3) as sp:
        sp.set(more=1)
    tel.event("retry", block=0)
    tel.counter("c").inc(5)
    tel.gauge("g").set(2.0)
    tel.histogram("h").observe(1.0)
    assert tel.tracer.spans() == {} and tel.tracer.count("anything") == 0
    assert tel.metrics.summary() == {}
    assert tel.for_worker("pack") is tel and obs.telemetry(False) is tel


def test_tracer_spans_per_worker_and_sim_clock():
    tel = obs.telemetry()
    sim = {"now": 5.0}
    tel.set_sim_clock(lambda: sim["now"])
    with tel.span("fold", block=0) as sp:
        sp.set(degraded=False)
        sim["now"] = 7.5
    with tel.for_worker("pack").span("pack", block=0):
        pass
    tel.for_worker("solve").event("retry", seam="solve", block=0)
    spans = tel.tracer.spans()
    assert set(spans) == {"main", "pack", "solve"}
    fold, = spans["main"]
    assert fold.args == {"block": 0, "degraded": False}
    assert fold.sim_ts_s == 5.0 and fold.sim_dur_s == pytest.approx(2.5)
    assert fold.dur_s >= 0.0
    retry, = spans["solve"]
    assert retry.dur_s is None and retry.sim_ts_s == 7.5
    assert tel.tracer.count("pack") == 1 and tel.tracer.count("nope") == 0


def test_metrics_summary_matches_jax():
    summaries = []
    for o in (jobs, obs):
        tel = o.telemetry()
        tel.counter("blocks_folded").inc()
        tel.counter("blocks_folded").inc(2)
        tel.gauge("frontier").set(4.0)
        tel.gauge("frontier").set(6.0)
        for v in (1.0, 2.0, 3.0, 4.0, 10.0):
            tel.histogram("depth").observe(v)
        assert tel.counter("blocks_folded") is tel.counter("blocks_folded")
        summaries.append(o.metrics_summary(tel))
    assert summaries[1] == summaries[0]
    assert summaries[1]["depth.p99"] == 10.0
    assert percentile([10.0, 20.0, 30.0, 40.0], 50.0) == 20.0
    with pytest.raises(ValueError):
        percentile([], 50.0)


def test_chrome_trace_matches_jax_layout():
    jdoc = jobs.to_chrome_trace(_sample_tel(jobs))
    tdoc = obs.to_chrome_trace(_sample_tel(obs))
    assert obs.validate_chrome_trace(tdoc) == []
    assert _shape(tdoc) == _shape(jdoc)
    assert tdoc["otherData"] == jdoc["otherData"]
    sim_solve, = (ev for ev in tdoc["traceEvents"]
                  if ev.get("cat") == "sim" and ev["name"] == "solve")
    assert sim_solve["ts"] == pytest.approx(1e6)
    assert sim_solve["dur"] == pytest.approx(2e6)


def test_validate_and_wall_extent_match_jax():
    bad = {"traceEvents": [
        {"ph": "Z", "name": "x", "pid": 1, "tid": 1},
        {"ph": "X", "name": "x", "pid": 1, "tid": 1, "ts": 0.0, "dur": -1.0},
        {"ph": "X", "name": 3, "pid": 1, "tid": "t", "ts": "now"},
        {"ph": "M", "name": "process_name", "pid": 1, "tid": 1}]}
    for doc in ([], {}, bad):
        assert obs.validate_chrome_trace(doc) == \
            jobs.validate_chrome_trace(doc)
    assert len(obs.validate_chrome_trace(bad)) == 7

    def x(name, tid, ts, dur):
        return {"ph": "X", "name": name, "cat": "wall", "pid": 1, "tid": tid,
                "ts": ts, "dur": dur}
    doc = {"traceEvents": [
        {"ph": "M", "name": "thread_name", "pid": 1, "tid": 1,
         "args": {"name": "main"}},
        x("fold", 1, 0.0, 10.0), x("checkpoint", 1, 2.0, 4.0),
        x("fold", 1, 20.0, 10.0)]}
    for worker in ("main", "pack", None):
        assert obs.wall_extent(doc, worker) == jobs.wall_extent(doc, worker)
    assert obs.wall_extent(doc, "main")["busy_s"] == pytest.approx(20e-6)


def test_write_trace_roundtrip(tmp_path):
    path = obs.write_trace(str(tmp_path / "sub" / "t.json"),
                           _sample_tel(obs))
    with open(path) as fh:
        assert obs.validate_chrome_trace(json.load(fh)) == []
    assert not (tmp_path / "sub" / "t.json.tmp").exists()


def test_timed_returns_microseconds(monkeypatch):
    reads = iter([2.0, 2.5])
    monkeypatch.setattr(timing.time, "perf_counter", lambda: next(reads))
    out, elapsed = timing.timed(lambda a: a + 1, 41)
    assert out == 42 and elapsed == pytest.approx(0.5e6)


# -- the cohort runs: the same spans and counters as the JAX package ---------

def test_faulty_overlapped_run_records_the_jax_spans_and_counters():
    kw = dict(overlap=2, staleness=1, max_retries=1, degrade=True)
    fc = dict(solve_fail_prob=0.25, solve_fail_blocks=(3,), seed=5)
    tels = []
    for pkg, core, o, run in ((jco, jc, jobs, jax_run_cohort),
                              (tco, tc, obs, _run_cohort)):
        tel = o.telemetry()
        res = run(pkg.Population(pkg.PopulationSpec(**SPEC), 0),
                  core.Probabilistic(**REG),
                  _cfg(pkg, core, faults=pkg.FaultConfig(**fc), **kw),
                  telemetry=tel)
        tels.append((tel, res))
    (jtel, jres), (ttel, tres) = tels

    def names(tel):
        return {w: Counter(sp.name for sp in buf)
                for w, buf in tel.tracer.spans().items()}

    assert names(ttel) == names(jtel)
    js, ts = jobs.metrics_summary(jtel), obs.metrics_summary(ttel)
    counts = [k for k in js if not k.endswith((".total", ".p50", ".p99"))]
    assert {k: ts[k] for k in counts} == {k: js[k] for k in counts}
    assert set(ts) == set(js)
    stats = tres.fault_stats
    assert stats.degraded_blocks >= 1 and stats.retries >= 1
    assert ttel.tracer.count("retry") == stats.retries
    assert ts["blocks_solved"] == 6 - stats.degraded_blocks
    assert ts["launch_staleness.p99"] <= 1
    spans = ttel.tracer.spans()
    assert {sp.name for sp in spans["pack"]} <= {"pack", "retry"}
    assert {"solve", "mocha.run", "mocha.presample", "mocha.scan_dispatch",
            "mocha.host_pull"} <= {sp.name for sp in spans["solve"]}


def test_telemetry_on_equals_off():
    pop = tco.Population(tco.PopulationSpec(**SPEC), 0)
    kw = dict(overlap=2, staleness=1, max_retries=1, degrade=True,
              faults=tco.FaultConfig(solve_fail_prob=0.3, seed=3))
    plain = _run_cohort(pop, tc.Probabilistic(**REG), _cfg(**kw))
    traced = _run_cohort(pop, tc.Probabilistic(**REG),
                         _cfg(telemetry=True, **kw))
    assert plain.history == traced.history
    for k in ("centroids", "omega_k", "assign", "participation"):
        np.testing.assert_array_equal(getattr(plain, k), getattr(traced, k))


def test_degraded_metrics_carried_emits_event_and_counter():
    dead = 2
    tel = obs.telemetry()
    res = _run_cohort(tco.Population(tco.PopulationSpec(**SPEC), 0),
                      tc.Probabilistic(**REG),
                      _cfg(max_retries=1, degrade=True,
                           faults=tco.FaultConfig(solve_fail_blocks=(dead,))),
                      telemetry=tel)
    assert obs.metrics_summary(tel)["degraded_metrics_carried"] == 1
    ev, = (sp for sp in tel.tracer.spans()["main"]
           if sp.name == "degraded_metrics_carried")
    assert ev.args["block"] == dead
    assert ev.args["primal"] == res.history["primal"][dead - 1]


def test_checkpoint_spans_record_bytes(tmp_path):
    tel = obs.telemetry()
    _run_cohort(tco.Population(tco.PopulationSpec(**SPEC), 0),
                tc.Probabilistic(**REG),
                _cfg(checkpoint_every=2, checkpoint_dir=str(tmp_path)),
                telemetry=tel)
    saves = [sp for sp in tel.tracer.spans()["main"]
             if sp.name == "checkpoint"]
    assert len(saves) == 3 and all(sp.args["bytes"] > 0 for sp in saves)
    s = obs.metrics_summary(tel)
    assert s["checkpoint_saves"] == 3 and s["checkpoint_save_s.count"] == 3
    assert s["checkpoint_bytes"] == sum(sp.args["bytes"] for sp in saves)


# -- the api: every path -------------------------------------------------------

def test_experiment_trace_artifact_and_provenance(tmp_path):
    exp = ta.Experiment(
        problem=ta.Problem(population=tco.Population(
            tco.PopulationSpec(**SPEC), 0)),
        method=ta.Method(regularizers=[tc.Probabilistic(**REG)], rounds=4),
        exec=ta.Exec(cohort=12, clusters=3, overlap=2, staleness=1,
                     trace_dir=str(tmp_path), device="cpu"))
    rep = exp.run(seed=0)
    prov = rep.provenance
    assert prov["telemetry"]["blocks_folded"] == 4
    assert prov["trace_path"] == str(
        tmp_path / f"trace_{prov['config_hash']}_s0.json")
    with open(prov["trace_path"]) as fh:
        doc = json.load(fh)
    assert obs.validate_chrome_trace(doc) == []
    wall = [ev["name"] for ev in doc["traceEvents"]
            if ev.get("cat") == "wall"]
    assert wall.count("fold") == 4 and "route" in wall
    assert exp.run(seed=0).provenance["trace_path"] == prov["trace_path"]


@pytest.mark.parametrize("path", ["single", "grid"])
def test_telemetry_on_the_silo_paths(path, tmp_path):
    train = tiny_problem(m=4, n=16, d=5, seed=0, device="cpu")[0]
    regs = [tc.Probabilistic(**REG)]
    kw = {}
    if path == "grid":
        regs.append(tc.Probabilistic(lam=0.1))
        kw = dict(engine="kernel")
    off = ta.Experiment(problem=ta.Problem(train=train),
                        method=ta.Method(regularizers=regs, rounds=3),
                        exec=ta.Exec(device="cpu", **kw))
    on = dataclasses.replace(off, exec=dataclasses.replace(
        off.exec, telemetry=True))
    a, b = off.run(0), on.run(0)
    assert a.provenance["telemetry"] is None
    assert a.provenance["trace_path"] is None
    assert b.provenance["path"] == path
    assert isinstance(b.provenance["telemetry"], dict)
    np.testing.assert_array_equal(a.result.W, b.result.W)


def test_summarize_cli_renders_trace(tmp_path, capsys):
    path = obs.write_trace(str(tmp_path / "t.json"), _sample_tel(obs))
    assert summarize_mod.main([path, "--strict"]) == 0
    out = capsys.readouterr().out
    for phase in ("pack", "solve", "fold", "bubble fraction",
                  "blocks_folded = 1"):
        assert phase in out
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [{"ph": "Z"}]}))
    assert summarize_mod.main([str(bad), "--strict"]) == 1
    assert summarize_mod.main([str(bad)]) == 0


def test_summarize_cli_runs_as_a_module(tmp_path):
    import os
    import subprocess
    import sys
    from pathlib import Path
    path = obs.write_trace(str(tmp_path / "t.json"), _sample_tel(obs))
    env = dict(os.environ)
    env["PYTHONPATH"] = str(Path(__file__).resolve().parents[1] / "src")
    out = subprocess.run([sys.executable, "-m", "repro_torch.obs.summarize",
                          path], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "simulated clock extent" in out.stdout
