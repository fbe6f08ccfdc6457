"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, each of which raises (and the script exits nonzero) on failure:

1. the card's name and power limit, the torch and CUDA versions;
2. build the SDCA kernel from ``src/repro_torch/kernels/sdca/csrc`` with
   nvcc (one process per source, started together);
3. hold the kernel against its plain PyTorch version on the card at the
   main path's shapes (Vehicle Sensor: gram mode; Human Activity: carry
   mode), a forced gram mode, duplicate-heavy streams, and budget 0 and
   mask 0 (exact no-ops);
4. the main path: full-size MOCHA experiments through
   ``repro_torch.api.Experiment.run`` with ``engine="kernel"``, the launch
   counter set to 0 just before each and read just after, then the same
   experiments with ``engine="local"`` (the plain solver) on the card, and
   a small problem held against a CPU run;
5. time the kernel (CUDA events over many launches), its plain version and
   the wall time per round of both engines;
6. profile three kernel-engine rounds (``torch.profiler``): device busy
   share and the kernels that take the device's time.

It prints the kernel table as JSON, the card line, and last
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.  Exits nonzero,
printing no result, where CUDA is absent or the package is not beside it.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

#: kernel vs plain version, relative to max(1, max |plain output|): the two
#: take their reductions in another order, nothing else
KERNEL_TOL = 2e-5
#: kernel-engine vs local-engine histories on the card (relative); ten
#: rounds of the same draws, solves differing at rounding level
HISTORY_RTOL = 1e-4
#: H100 SXM peaks (NVIDIA data sheet, 700 W): HBM bytes/s, fp32 FLOP/s
#: outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
ROUNDS = 10


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_case(spec, *, seed=0, gram=None, dup=False, zero_budget=False,
                zero_mask=False, device="cuda"):
    """Kernel inputs at a federation's shapes as a MOCHA round makes them:
    the federation's X/y/mask and row norms, a feasible alpha, a small W,
    one-pass budgets, coordinate streams drawn from the port's PRNG."""
    from repro_torch.core.dual import with_xnorm2
    from repro_torch.data.synthetic import make_federation
    from repro_torch.kernels.sdca import draw_coordinates
    from repro_torch.utils import prng
    data = with_xnorm2(make_federation(spec, seed=0, device=device)[0])
    m, n, d = data.X.shape
    rng = np.random.default_rng(seed)
    dev = data.X.device

    def on(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    alpha = (data.y * data.mask * on(rng.uniform(0, 1, (m, n)))).contiguous()
    W = on(0.1 * rng.normal(size=(m, d)))
    q = on(rng.uniform(0.5, 2.0, m))
    budgets = torch.round(data.n_t).to(torch.int32)
    keys = prng.split(prng.PRNGKey(seed, device=dev), m)
    idx = draw_coordinates(keys, data.n_t, n, n)
    mask = data.mask
    if dup:
        idx = idx % 4
    if zero_budget:
        budgets = torch.zeros_like(budgets)
    if zero_mask:
        mask = torch.zeros_like(mask)
    return dict(X=data.X, y=data.y, mask=mask, alpha=alpha, W=W, q_t=q,
                budgets=budgets, idx=idx, max_steps=n, gram=gram,
                xnorm2=data.xnorm2)


def _plain_args(case):
    return {k: v for k, v in case.items() if k != "max_steps"}


def check_kernel(label, case, tol):
    from repro_torch.kernels.sdca import sdca_local_solve, sdca_ref
    da, u = sdca_local_solve(**case)
    dr, ur = sdca_ref(**_plain_args(case))
    torch.cuda.synchronize()
    if not (torch.isfinite(da).all() and torch.isfinite(u).all()):
        raise AssertionError(f"kernel output not finite: {label}")
    err = max(float((da - dr).abs().max()), float((u - ur).abs().max()))
    scale = max(float(dr.abs().max()), float(ur.abs().max()), 1.0)
    ok = err <= tol * scale
    print(f"kernel vs plain [{label}]: max_abs_err={err:.3e} "
          f"(tolerance {tol:g} x {scale:.3g}) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError(f"kernel disagrees with plain version: {label}")
    return err


def phase_build():
    from repro_torch.kernels.sdca import build
    t0 = time.perf_counter()
    build.build()
    build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s, nvcc "
          f"{' '.join(build.NVCC_FLAGS)}")
    print(build.LAST_BUILD.get("log", "").strip(), flush=True)


def phase_kernels():
    from repro_torch.data.synthetic import HUMAN_ACTIVITY, VEHICLE_SENSOR
    errs = {
        "gram": check_kernel("vehicle_sensor, gram",
                             kernel_case(VEHICLE_SENSOR), KERNEL_TOL),
        "carry": check_kernel("human_activity, carry",
                              kernel_case(HUMAN_ACTIVITY), KERNEL_TOL),
    }
    d120 = dataclasses.replace(VEHICLE_SENSOR, name="vs_d120", d=120)
    errs["forced"] = max(
        check_kernel("d=120, forced gram", kernel_case(d120, gram=True),
                     KERNEL_TOL),
        check_kernel("human_activity, forced gram (72 KB shared memory)",
                     kernel_case(HUMAN_ACTIVITY, gram=True), KERNEL_TOL),
        check_kernel("vehicle_sensor, forced carry",
                     kernel_case(VEHICLE_SENSOR, gram=False), KERNEL_TOL))
    errs["duplicates"] = max(
        check_kernel(f"{spec.name}, duplicate-heavy idx",
                     kernel_case(spec, dup=True), KERNEL_TOL)
        for spec in (VEHICLE_SENSOR, HUMAN_ACTIVITY))
    for spec in (VEHICLE_SENSOR, HUMAN_ACTIVITY):
        for kw in ("zero_budget", "zero_mask"):
            check_kernel(f"{spec.name}, {kw} (exact no-op)",
                         kernel_case(spec, **{kw: True}), 0.0)
    return errs


def _experiment(spec, reg, engine, every):
    from repro_torch.api import Eval, Exec, Experiment, Method, Problem
    from repro_torch.data.synthetic import make_federation
    train, test = make_federation(spec, seed=0)   # on the card
    return Experiment(
        problem=Problem(train=train),
        method=Method(loss="hinge", regularizers=(reg,), rounds=ROUNDS,
                      omega_update_every=every),
        exec=Exec(engine=engine), eval=Eval(record_every=1)), test


def _run_timed(exp):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = exp.run(seed=0)
    torch.cuda.synchronize()
    return rep, time.perf_counter() - t0


def _compare_histories(label, a, b):
    worst = 0.0
    for k in ("dual", "primal", "gap"):
        x, y = np.asarray(a[k]), np.asarray(b[k])
        scale = np.maximum(np.abs(np.asarray(a["primal"])), 1.0)
        rel = float(np.max(np.abs(x - y) / scale))
        worst = max(worst, rel)
        if not np.all(np.isfinite(x)) or rel > HISTORY_RTOL:
            raise AssertionError(f"{label}: {k} differs by {rel:.3e} of "
                                 f"|primal| (tolerance {HISTORY_RTOL:g})")
    return worst


def phase_main_path():
    """The main path: full-size experiments, kernel engine then local."""
    from repro_torch.core import Clustered, MeanRegularized, per_task_error
    from repro_torch.data.synthetic import HUMAN_ACTIVITY, VEHICLE_SENSOR
    from repro_torch.kernels import sdca as K
    cases = [("vehicle_sensor", VEHICLE_SENSOR, Clustered(lam=1.0, k=3), 5),
             ("human_activity", HUMAN_ACTIVITY, MeanRegularized(), 0)]
    out = {}
    for label, spec, reg, every in cases:
        exp_k, test = _experiment(spec, reg, "kernel", every)
        K.reset_counts()
        rep_k, wall_k = _run_timed(exp_k)
        launches = K.COUNTS["sdca_local_solve"]
        if launches != ROUNDS:
            raise AssertionError(f"{label}: the kernel ran {launches} times "
                                 f"in {ROUNDS} rounds")
        exp_l, _ = _experiment(spec, reg, "local", every)
        rep_l, wall_l = _run_timed(exp_l)
        rel = _compare_histories(label, rep_k.history, rep_l.history)
        W = torch.from_numpy(rep_k.result.W).to(test.X.device)
        err = float(per_task_error(test, W, test.X, test.y,
                                   test.mask).mean())
        prov = rep_k.provenance
        print(f"main path [{label}] m={test.m} d={test.d} "
              f"{prov['gram_mode']} mode, {ROUNDS} rounds, "
              f"omega_update_every={every}: launches={launches}, final gap "
              f"kernel {rep_k.final('gap'):.6g} local {rep_l.final('gap'):.6g}"
              f", history max rel diff {rel:.3e}, mean test error "
              f"{err:.4f}, wall/round kernel {1e3 * wall_k / ROUNDS:.2f} ms "
              f"local {1e3 * wall_l / ROUNDS:.2f} ms", flush=True)
        out[label] = dict(launches=launches, exp_k=exp_k, exp_l=exp_l,
                          wall_ms=[1e3 * wall_k / ROUNDS,
                                   1e3 * wall_l / ROUNDS])
    return out


def phase_small_reference():
    """A tiny problem through the kernel engine on the card, held against
    the same experiment run on the CPU (plain solver)."""
    from repro_torch.api import Exec, Experiment, Method, Problem
    from repro_torch.core import Clustered
    from repro_torch.data.synthetic import tiny_problem
    train = tiny_problem(m=4, n=24, d=6, seed=0, device="cpu")[0]
    reps = [Experiment(problem=Problem(train=train),
                       method=Method(regularizers=(Clustered(),), rounds=8,
                                     omega_update_every=3),
                       exec=Exec(engine="kernel", device=dev)).run(0)
            for dev in ("cuda", "cpu")]
    rel = _compare_histories("tiny cuda vs cpu", reps[0].history,
                             reps[1].history)
    print(f"small reference [tiny, cuda kernel vs cpu plain]: history max "
          f"rel diff {rel:.3e}", flush=True)


def _events_ms(fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(case):
    """The least time the card could take for one call: bytes moved once
    over HBM bandwidth, or fp32 operations over the fp32 peak, whichever is
    larger; operations counted for this input's live chunks."""
    from repro_torch.core.subproblem import _solver_plan
    X, budgets = case["X"], case["budgets"]
    m, n, d = X.shape
    steps = case["max_steps"]
    gram, C = _solver_plan(d, steps, case["gram"])
    n_chunks = -(-steps // C)
    nbytes = 4 * (m * n * d + 4 * m * n + m * d + m * n_chunks * C + 2 * m
                  + m * n + m * d)
    live = torch.clamp(budgets.to(torch.int64), max=steps).add(C - 1) // C
    if gram:   # G_c, p_c, C steps of O(C), column sum, r and u updates
        per_chunk = 2 * C * C * d + 2 * C * d + C * (2 * C + 12) + 2 * C * d \
            + 3 * d
    else:      # C steps of dot + axpy, column sum, u update
        per_chunk = C * (4 * d + 12) + 2 * C * d + d
    flops = int(live.sum()) * per_chunk
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FP32
    chain = int(live.max()) * C
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops, chain_steps=chain,
                mode="gram" if gram else "carry")


def phase_timing(main, errs):
    from repro_torch.data.synthetic import HUMAN_ACTIVITY, VEHICLE_SENSOR
    from repro_torch.kernels import sdca as K
    card = card_line()
    shapes = {}
    for label, spec, err in (("vehicle_sensor", VEHICLE_SENSOR, errs["gram"]),
                             ("human_activity", HUMAN_ACTIVITY,
                              errs["carry"])):
        case = kernel_case(spec)
        kernel = lambda: K.sdca_local_solve(**case)   # noqa: E731
        plain = lambda: K.sdca_ref(**_plain_args(case))   # noqa: E731
        for _ in range(3):
            kernel()
        ms = _events_ms(kernel, 50)
        plain()
        plain_ms = _events_ms(plain, 3)
        b = bound(case)
        m, n, d = case["X"].shape
        row = dict(shape=f"m={m} n={n} d={d}", mode=b["mode"], ms=ms,
                   plain_ms=plain_ms, bound_ms=b["bound_ms"],
                   bound_by=b["bound_by"], bytes=b["bytes"],
                   flops=b["flops"], chain_steps=b["chain_steps"],
                   ns_per_chain_step=1e6 * ms / b["chain_steps"],
                   max_abs_err=err, wall_ms_per_round_kernel=main[label][
                       "wall_ms"][0],
                   wall_ms_per_round_local=main[label]["wall_ms"][1])
        # the engines once more, in the other order (local, then kernel)
        for i, key in ((1, "exp_l"), (0, "exp_k")):
            _, wall = _run_timed(main[label][key])
            row.setdefault("wall_ms_per_round_repeat", [None, None])[i] = (
                1e3 * wall / ROUNDS)
        shapes[label] = row
        print(f"timing [{label}] {row['shape']} {row['mode']}: kernel "
              f"{ms:.4f} ms/call, plain {plain_ms:.2f} ms/call, bound "
              f"{b['bound_ms']:.5f} ms ({b['bound_by']}), chain "
              f"{b['chain_steps']} steps -> {row['ns_per_chain_step']:.1f} "
              f"ns/step; wall/round kernel engine "
              f"{row['wall_ms_per_round_kernel']:.2f} / "
              f"{row['wall_ms_per_round_repeat'][0]:.2f} ms, local engine "
              f"{row['wall_ms_per_round_local']:.2f} / "
              f"{row['wall_ms_per_round_repeat'][1]:.2f} ms [{card}]",
              flush=True)
    return shapes


def phase_profile(main_runs):
    """Where a kernel-engine round's time goes: ``torch.profiler`` over a
    3-round Vehicle Sensor run (after the runs above warmed it up)."""
    from torch.profiler import ProfilerActivity, profile
    exp = dataclasses.replace(
        main_runs["vehicle_sensor"]["exp_k"],
        method=dataclasses.replace(
            main_runs["vehicle_sensor"]["exp_k"].method, rounds=3))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = _run_timed(exp)
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and "CUDA" in str(e.device_type)]
    dev_us = sum(getattr(e, "self_device_time_total", 0) for e in events)
    launches = sum(e.count for e in events)
    top = sorted(events, key=lambda e: -getattr(e, "self_device_time_total",
                                                0))[:6]
    print(f"profile [vehicle_sensor kernel engine, 3 rounds]: wall "
          f"{1e3 * wall / 3:.2f} ms/round, device busy "
          f"{dev_us / 3e3:.3f} ms/round ({100 * dev_us / 1e6 / wall:.1f}% "
          f"of wall), {launches / 3:.0f} device kernels/round; top by device "
          f"time: " + "; ".join(
              f"{e.key[:60]} x{e.count} "
              f"{getattr(e, 'self_device_time_total', 0) / 3e3:.3f} ms/round"
              for e in top), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    phase_build()
    errs = phase_kernels()
    main_runs = phase_main_path()
    launches = sum(r["launches"] for r in main_runs.values())
    phase_small_reference()
    shapes = phase_timing(main_runs, errs)
    phase_profile(main_runs)
    head = shapes["vehicle_sensor"]
    kernels = [dict(
        name="sdca_local_solve", route="cuda",
        source="src/repro_torch/kernels/sdca/csrc/sdca.cu",
        replaces="src/repro/kernels/sdca/sdca.py:45",
        launches=launches,
        max_abs_err=max(errs.values()),
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=None,
        shapes=shapes)]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
