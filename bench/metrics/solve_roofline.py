"""solve_roofline: the least time the card could take for the traced
window's SDCA local solves, over the device time of the kernels that the
replayed round graphs ran (each a round: W(alpha), the coordinate draw,
the chunked solve, the update).  The least time of a round is the larger
of its bytes over the HBM bandwidth and its float32 operations over the
float32 peak, both counted by ``bench/cost.py``'s ``solve_cost`` from the
shapes and the executed budgets."""


def read(run):
    t, w, peak = run.trace, run.work, run.peak
    if t is None or not t.graph_kernel_s or peak is None:
        return None
    least = max(w["solve_bytes"] / peak["hbm_bytes_per_s"],
                w["solve_flops"] / peak["fp32_flops_per_s"])
    return 100.0 * least * w["rounds"] * len(run.runs) / t.graph_kernel_s
