"""device_idle_share: the share of the traced window in which no kernel,
copy or fill ran on the card (the profiler's device activity, merged),
with the profiler's own stall (``devtrace.PROFILER_OWN``: the idle time
while it flushes its buffers) taken out of both the idle time and the
window: the program did not leave the card idle there."""


def read(run):
    t = run.trace
    if t is None:
        return None
    window = t.window_s - t.profiler_stall_s
    if window <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / window)
