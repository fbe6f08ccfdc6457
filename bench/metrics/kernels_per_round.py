"""kernels_per_round: device kernels in the traced window (the captured
rounds' replays, the eager warm-up round of each capture, the Omega
refreshes, the metrics and the evaluation) over the rounds the window's
runs played."""


def read(run):
    t = run.trace
    if t is None or not t.kernels:
        return None
    return t.kernels / (run.work["rounds"] * len(run.runs))
