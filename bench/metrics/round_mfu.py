"""round_mfu: the useful float32 operations of the traced window's runs
(the SDCA solves' count of ``bench/cost.py``, W(alpha) every round, the
Omega steps) over the traced window's length, less the profiler's own
stall (``devtrace.PROFILER_OWN``), times the card's float32 peak.  The
program keeps float32 products at full float32 (TF32 off), so the float32
peak is the one that applies."""


def read(run):
    t, w, peak = run.trace, run.work, run.peak
    if t is None or peak is None:
        return None
    window = t.window_s - t.profiler_stall_s
    if window <= 0:
        return None
    flops = len(run.runs) * (w["rounds"] * (w["solve_flops"] + w["round_flops"])
                             + w["omega_steps"] * w["omega_flops"])
    return 100.0 * flops / (window * peak["fp32_flops_per_s"])
