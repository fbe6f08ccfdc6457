"""Chrome trace-event export + flat metrics summary.

``to_chrome_trace`` renders a tracer's span buffers in the Chrome
trace-event JSON format (the ``traceEvents`` array of "X" complete /
"i" instant / "M" metadata events; loadable in ``chrome://tracing`` and
Perfetto).  The layout is one track per pipeline worker (main / pack /
solve, wall-clock timestamps relative to the earliest span) PLUS one
virtual "simulated clock" track replaying the same spans at their
``SystemsTrace`` timestamps -- the two clock domains side by side is the
point of recording both on every span.

``validate_chrome_trace`` is the schema check run against an emitted
artifact; it is deliberately strict about the fields the viewers actually
require (ph/name/pid/tid, numeric ts, and a
non-negative dur on complete events).

Everything here is stdlib-only and runs after the workers have joined, so
it may freely read every buffer.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

from repro_torch.obs.tracer import WORKERS

#: fixed track ids for the known pipeline roles; unknown workers get
#: ids after these, the virtual simulated-clock track sits far above
_SIM_TID = 100

#: event phases the validator accepts (complete, instant, metadata)
_PHASES = ("X", "i", "M")


def _tids(workers: List[str]) -> Dict[str, int]:
    order = [w for w in WORKERS if w in workers]
    order += sorted(w for w in workers if w not in WORKERS)
    return {w: i + 1 for i, w in enumerate(order)}


def _tracer_of(tel: Any):
    """Accept a Telemetry facade or a bare Tracer."""
    return getattr(tel, "tracer", tel)


def _metrics_of(tel: Any):
    return getattr(tel, "metrics", None)


def to_chrome_trace(tel: Any) -> Dict[str, Any]:
    """Chrome trace-event document for a Telemetry (or bare Tracer)."""
    tracer = _tracer_of(tel)
    spans = tracer.spans()
    tids = _tids(list(spans))
    events: List[Dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "pid": 1, "tid": 1,
        "args": {"name": "repro_torch"},
    }]
    for worker, tid in sorted(tids.items(), key=lambda kv: kv[1]):
        events.append({"name": "thread_name", "ph": "M", "pid": 1,
                       "tid": tid, "args": {"name": worker}})
    events.append({"name": "thread_name", "ph": "M", "pid": 1,
                   "tid": _SIM_TID, "args": {"name": "simulated-clock"}})

    flat = [sp for buf in spans.values() for sp in buf]
    t0 = min((sp.ts_s for sp in flat), default=0.0)
    for sp in flat:
        base: Dict[str, Any] = {"name": sp.name, "cat": "wall", "pid": 1,
                                "tid": tids[sp.worker],
                                "ts": (sp.ts_s - t0) * 1e6,
                                "args": dict(sp.args)}
        if sp.dur_s is None:
            events.append({**base, "ph": "i", "s": "t"})
        else:
            events.append({**base, "ph": "X", "dur": sp.dur_s * 1e6})
        if sp.sim_ts_s is not None:
            sim: Dict[str, Any] = {"name": sp.name, "cat": "sim", "pid": 1,
                                   "tid": _SIM_TID, "ts": sp.sim_ts_s * 1e6,
                                   "args": {**sp.args, "worker": sp.worker}}
            if sp.sim_dur_s is None:
                events.append({**sim, "ph": "i", "s": "t"})
            else:
                events.append({**sim, "ph": "X", "dur": sp.sim_dur_s * 1e6})
    doc: Dict[str, Any] = {"traceEvents": events, "displayTimeUnit": "ms"}
    metrics = _metrics_of(tel)
    if metrics is not None:
        doc["otherData"] = {"metrics": metrics.summary()}
    return doc


def write_trace(path: str, tel: Any) -> str:
    """Serialize ``to_chrome_trace(tel)`` to ``path``; returns ``path``."""
    doc = to_chrome_trace(tel)
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return path


def validate_chrome_trace(doc: Any) -> List[str]:
    """Schema errors of a Chrome trace-event document ([] = valid).

    Checks the structure the viewers rely on: a ``traceEvents`` list of
    dicts, each with a known ``ph``, a string ``name``, integer pid/tid;
    complete ("X") events need numeric ``ts`` and non-negative ``dur``,
    instants need ``ts``, metadata needs ``args``.
    """
    errors: List[str] = []
    if not isinstance(doc, dict):
        return [f"document is {type(doc).__name__}, expected dict"]
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not a dict")
            continue
        ph = ev.get("ph")
        if ph not in _PHASES:
            errors.append(f"{where}: ph {ph!r} not in {_PHASES}")
            continue
        if not isinstance(ev.get("name"), str):
            errors.append(f"{where}: name missing or not a string")
        for field in ("pid", "tid"):
            if not isinstance(ev.get(field), int):
                errors.append(f"{where}: {field} missing or not an int")
        if ph in ("X", "i"):
            if not isinstance(ev.get("ts"), (int, float)):
                errors.append(f"{where}: ts missing or not numeric")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)):
                errors.append(f"{where}: dur missing or not numeric")
            elif dur < 0:
                errors.append(f"{where}: negative dur {dur}")
        if ph == "M" and not isinstance(ev.get("args"), dict):
            errors.append(f"{where}: metadata event without args")
    return errors


def metrics_summary(tel: Any) -> Dict[str, Any]:
    """Flat metrics dict of a Telemetry (or bare registry)."""
    metrics = _metrics_of(tel)
    if metrics is None:
        metrics = tel
    return metrics.summary()


def wall_extent(doc: Dict[str, Any],
                worker: Optional[str] = None) -> Dict[str, float]:
    """{"span_s", "busy_s"} of a trace's wall track (one worker or all).

    ``span_s`` is last-end minus first-start over the selected complete
    events; ``busy_s`` the measure of their interval UNION (nested spans
    -- a checkpoint inside a fold, mocha phases inside a solve -- must not
    double-count) -- their ratio is the pipeline occupancy
    (1 - bubble fraction) repro_torch.obs.summarize reports.
    """
    names = _thread_names(doc)
    intervals = []
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X" or ev.get("cat") != "wall":
            continue
        if worker is not None and names.get(ev.get("tid")) != worker:
            continue
        ts, dur = float(ev["ts"]), float(ev["dur"])
        intervals.append((ts, ts + dur))
    if not intervals:
        return {"span_s": 0.0, "busy_s": 0.0}
    intervals.sort()
    busy, (cur_lo, cur_hi) = 0.0, intervals[0]
    for lo, hi in intervals[1:]:
        if lo > cur_hi:
            busy += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    busy += cur_hi - cur_lo
    span = max(hi for _, hi in intervals) - intervals[0][0]
    return {"span_s": span / 1e6, "busy_s": busy / 1e6}


def _thread_names(doc: Dict[str, Any]) -> Dict[int, str]:
    return {ev.get("tid"): ev.get("args", {}).get("name")
            for ev in doc.get("traceEvents", [])
            if ev.get("ph") == "M" and ev.get("name") == "thread_name"}
