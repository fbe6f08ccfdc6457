"""``BENCHMARK.json`` against the benchmark's contract: names and units of
the allowed characters, every cell's configuration, traffic, limits and
metric files found by name."""
import json
import os
import re

import pytest

from bench import compare

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load(path):
    with open(path) as f:
        return json.load(f)


def test_keys():
    assert set(spec()) == {"command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"}
    assert spec()["paths"] == ["bench"]


def test_names_and_units():
    s = spec()
    names = [c["name"] for c in s["configs"]] + [
        w["name"] for w in s["workloads"]] + [
        m["name"] for m in s["end_to_end"] + s["per_layer"]] + [
        w[k] for w in s["workloads"] for k in ("config", "traffic")] + [
        k for c in s["configs"] for k in c["reduced"]]
    assert all(NAME.fullmatch(n) for n in names), names
    units = [m["unit"] for m in s["end_to_end"] + s["per_layer"]]
    assert all(UNIT.fullmatch(u) for u in units), units
    for kind in ("configs", "workloads"):
        assert len({x["name"] for x in s[kind]}) == len(s[kind])
    metrics = s["end_to_end"] + s["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)


def test_one_line_texts():
    s = spec()
    texts = [x["why"] for x in s["configs"] + s["workloads"]] + [
        m["layer"] for m in s["per_layer"]] + [c["source"] for c in s[
            "configs"]] + s["command"]
    assert all(0 < len(t) <= 200 and "\n" not in t and "\t" not in t
               for t in texts)


@pytest.mark.parametrize("cell", [w["name"] for w in spec()["workloads"]])
def test_cell_files_are_found_by_name(cell):
    s = spec()
    w = next(x for x in s["workloads"] if x["name"] == cell)
    config = next(c for c in s["configs"] if c["name"] == w["config"])
    assert config["file"].startswith("bench/")
    cfg = load(os.path.join(ROOT, config["file"]))
    assert cfg["name"] == config["name"]
    traffic = load(os.path.join(BENCH, "traffic", f"{w['traffic']}.json"))
    assert traffic["name"] == w["traffic"]
    limits = load(os.path.join(BENCH, "limits", f"{cell}.json"))
    want = {"W_gap", "omega_gap", "objective_gap", "heldout_excess"}
    if traffic["route"]["path"] == "single":
        want.add("budget_mismatch")
    if traffic["shuffles"] * len(traffic["lambdas"]) > 1 and min(
            traffic["lambdas"]) <= compare.COUPLED:
        want |= {"W_gap_max", "omega_gap_max", "objective_gap_max"}
    assert set(limits) == want
    for m in s["end_to_end"] + s["per_layer"]:
        if cell in m.get("workloads", [cell]):
            assert os.path.isfile(os.path.join(BENCH, "metrics",
                                               f"{m['name']}.py"))


def test_per_layer_metrics_move_a_reported_metric():
    s = spec()
    e2e = {m["name"] for m in s["end_to_end"]}
    assert "setup_s" in e2e
    for m in s["per_layer"]:
        assert m["moves"] in e2e and m["layer"]
        assert set(m["workloads"]) <= {w["name"] for w in s["workloads"]}
