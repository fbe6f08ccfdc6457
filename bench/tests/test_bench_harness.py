"""The harness end to end at a tiny federation on the CPU: the result line
of the contract, and ``correct`` false under each fault a cell can have.

The chip check of ``bench/run.py``'s ``main`` is skipped: ``run_cell`` is
driven directly with ``device="cpu"``.
"""
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from bench import run

TINY = dict(m=4, d=6, n_min=20, n_max=33)
TRAFFIC = {"table1_sweep": dict(shuffles=2, lambdas=[1e-3, 1e-1, 1.0]),
           "single_scan": {}}
LIMITS = {"W_gap": 1e-4, "omega_gap": 1e-4, "objective_gap": 1e-5,
          "heldout_excess": 0}
WORST = {"W_gap_max": 1e-4, "omega_gap_max": 1e-4, "objective_gap_max": 1e-5}


def tiny_cell(traffic: str) -> dict:
    cell = run.load_cell("vs_table1_sweep", False)
    with open(f"{run.BENCH}/traffic/{traffic}.json") as f:
        cell["traffic"] = json.load(f)
    cell["config"].update(TINY)
    cell["traffic"].update(rounds=8, omega_update_every=4, record_every=8,
                           **TRAFFIC[traffic])
    cell["limits"] = dict(LIMITS)
    if cell["traffic"]["route"]["path"] == "single":
        cell["limits"]["budget_mismatch"] = 0
    else:
        cell["limits"].update(WORST)
    return cell


def run_tiny(traffic: str, seconds: float = 0.5) -> dict:
    return run.run_cell(tiny_cell(traffic), 2 ** 31 + 17, seconds, False,
                        device="cpu", t0=time.perf_counter())


DRIVE = """
import sys, time
sys.path[:0] = [{root!r}, {bench_tests!r}]
import test_bench_harness as t
from bench import run
got = t.run_tiny({traffic!r})
if got["forbidden"]:
    print("loaded:", got["forbidden"], file=sys.stderr)
    sys.exit(3)
run.emit(got, "cpu")
"""


@pytest.mark.parametrize("traffic", sorted(TRAFFIC))
def test_result_line(traffic):
    """In a process of its own, as the harness runs: no JAX loaded, the
    compared numbers last on standard error, the result last on standard
    output."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = DRIVE.format(root=run.ROOT, bench_tests=here, traffic=traffic)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=run.ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["metrics"]) == {"task_rounds_per_s", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert line["device"]["count"] == 1
    tail = proc.stderr.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") and " limit " in t for t in tail)


def _unchanged_state(engine, monkeypatch):
    monkeypatch.setattr(engine, "_local_round",
                        lambda *a, **k: a[4])      # returns ``state``


def _half_batch(engine, monkeypatch):
    solve = engine.batched_local_sdca

    def half(*a, **k):
        dalpha, u = solve(*a, **k)
        keep = (torch.arange(len(u)) < len(u) // 2).to(u.dtype)
        return dalpha * keep[:, None], u * keep[:, None]
    monkeypatch.setattr(engine, "batched_local_sdca", half)


def _altered_answer(engine, monkeypatch):
    from repro_torch.core import evaluate
    error = evaluate.per_task_error

    def altered(data, W, X, y, mask):
        err = error(data, W, X, y, mask).clone()
        err[0] += 1.0 / torch.clamp_min(mask[0].sum(), 1.0)
        return err
    monkeypatch.setattr(evaluate, "per_task_error", altered)


def _one_cell_unchanged(engine, monkeypatch):
    """The first (lambda, shuffle) cell's tasks (the solve's first m rows)
    get no update: the state of one cell of the grid stays unchanged."""
    solve = engine.batched_local_sdca

    def frozen(*a, **k):
        dalpha, u = solve(*a, **k)
        keep = (torch.arange(len(u)) >= TINY["m"]).to(u.dtype)
        return dalpha * keep[:, None], u * keep[:, None]
    monkeypatch.setattr(engine, "batched_local_sdca", frozen)


FAULTS = {"unchanged_state": _unchanged_state, "half_batch": _half_batch,
          "altered_answer": _altered_answer,
          "one_cell_unchanged": _one_cell_unchanged}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("traffic", sorted(TRAFFIC))
def test_fault_is_not_correct(traffic, fault, monkeypatch):
    from repro_torch.core import engine
    FAULTS[fault](engine, monkeypatch)
    line = run_tiny(traffic, seconds=0.0)["line"]
    assert line["correct"] is False
    assert line["failed"] == 1


def test_one_cell_fault_shows_in_the_worst_cell_only(monkeypatch):
    """A fault in one cell of six leaves the medians under their limits:
    the worst-cell numbers are what catches it."""
    from repro_torch.core import engine
    _one_cell_unchanged(engine, monkeypatch)
    checks = run_tiny("table1_sweep", seconds=0.0)["line"]["checks"]
    assert all(checks[k]["value"] <= checks[k]["limit"] for k in LIMITS)
    assert checks["W_gap_max"]["value"] > checks["W_gap_max"]["limit"]


def test_the_traffic_sets_the_driver():
    """The traffic's ``exec`` reaches ``Exec``: a single run forced onto
    the loop driver is routed there and held correct against the same
    reference."""
    cell = tiny_cell("single_scan")
    cell["traffic"]["exec"] = {"engine": "local", "driver": "loop"}
    cell["traffic"]["route"] = {"path": "single", "driver": "loop",
                                "engine": "local"}
    got = run.run_cell(cell, 2 ** 33 + 5, 0.0, False, device="cpu",
                       t0=time.perf_counter())
    assert got["line"]["correct"] is True


def test_a_run_off_the_traffic_route_is_refused():
    cell = tiny_cell("single_scan")
    cell["traffic"]["route"] = dict(cell["traffic"]["route"], driver="loop")
    with pytest.raises(RuntimeError, match="routed to"):
        run.run_cell(cell, 7, 0.0, False, device="cpu",
                     t0=time.perf_counter())
