"""capture_s: the round program's capture seconds (warm-up round, CUDA
graph capture, instantiation) that each run of the window reports, as
``RunResult.capture_s`` or ``SweepResult.capture_s``; their mean.  None
where no run captured (the CPU)."""


def read(run):
    got = [r.capture_s for r in run.runs if r.capture_s is not None]
    return sum(got) / len(got) if got else None
