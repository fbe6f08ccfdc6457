"""CLI: read a repro_torch.obs Chrome trace without a browser.

``python -m repro_torch.obs.summarize trace.json`` prints a per-phase wall-clock
table (count, total, mean, p50, p99 per span name -- pack/solve/fold
first), the pipeline bubble fraction of the solve track (1 - busy/extent:
how much of the solve worker's wall-clock window was spent NOT solving),
and the simulated-clock extent for the two-clock comparison.

Stdlib-only and read-only: it consumes the exported JSON artifact, so it
works on traces from any run with no imports beyond the validator.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List

from repro_torch.obs.export import validate_chrome_trace, wall_extent
from repro_torch.obs.metrics import percentile
from repro_torch.obs.tracer import WORKERS

#: span names printed first (the cohort pipeline's phases), then the rest
_PHASE_ORDER = ("pack", "solve", "fold")


def _wall_durations(doc: Dict[str, Any]) -> Dict[str, List[float]]:
    """{span name -> wall durations in seconds} over complete events."""
    out: Dict[str, List[float]] = {}
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") == "X" and ev.get("cat") == "wall":
            out.setdefault(ev["name"], []).append(float(ev["dur"]) / 1e6)
    return out


def _sim_extent_s(doc: Dict[str, Any]) -> float:
    """Last simulated timestamp seen on the simulated-clock track."""
    last = 0.0
    for ev in doc.get("traceEvents", []):
        if ev.get("cat") != "sim":
            continue
        end = float(ev.get("ts", 0.0)) + float(ev.get("dur", 0.0) or 0.0)
        last = max(last, end)
    return last / 1e6


def _fmt_ms(s: float) -> str:
    return f"{s * 1e3:10.3f}"


def render(doc: Dict[str, Any]) -> str:
    """The human-readable summary of one trace document."""
    durs = _wall_durations(doc)
    names = [n for n in _PHASE_ORDER if n in durs]
    names += sorted(n for n in durs if n not in _PHASE_ORDER)
    lines = [f"{'phase':<24}{'count':>7}{'total ms':>11}{'mean ms':>11}"
             f"{'p50 ms':>11}{'p99 ms':>11}"]
    lines.append("-" * len(lines[0]))
    for name in names:
        vals = durs[name]
        total = sum(vals)
        lines.append(
            f"{name:<24}{len(vals):>7}{_fmt_ms(total)}"
            f"{_fmt_ms(total / len(vals))}"
            f"{_fmt_ms(percentile(vals, 50))}{_fmt_ms(percentile(vals, 99))}")
    lines.append("")
    for worker in _PHASE_ORDER:
        ext = wall_extent(doc, worker)
        if ext["span_s"] <= 0.0:
            continue
        bubble = 1.0 - ext["busy_s"] / ext["span_s"]
        lines.append(f"{worker} track: extent {ext['span_s'] * 1e3:.3f} ms, "
                     f"busy {ext['busy_s'] * 1e3:.3f} ms, "
                     f"bubble fraction {bubble:.3f}")
    sim = _sim_extent_s(doc)
    if sim > 0.0:
        lines.append(f"simulated clock extent: {sim:.3f} s")
    metrics = doc.get("otherData", {}).get("metrics", {})
    if metrics:
        lines.append("")
        lines.append("metrics:")
        for key in sorted(metrics):
            lines.append(f"  {key} = {metrics[key]}")
    return "\n".join(lines)


def main(argv: List[str] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.summarize",
        description="summarize a repro_torch.obs Chrome trace-event JSON")
    parser.add_argument("trace", help="path to the trace JSON artifact")
    parser.add_argument("--strict", action="store_true",
                        help="fail (exit 1) on schema validation errors")
    ns = parser.parse_args(argv)
    with open(ns.trace) as f:
        doc = json.load(f)
    errors = validate_chrome_trace(doc)
    if errors:
        for e in errors:
            print(f"schema: {e}", file=sys.stderr)
        if ns.strict:
            return 1
    print(render(doc))
    return 0


# WORKERS is re-exported context for downstream tooling that labels tracks
__all__ = ["main", "render", "WORKERS"]

if __name__ == "__main__":
    raise SystemExit(main())
