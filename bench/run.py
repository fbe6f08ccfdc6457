"""Run one cell of the benchmark of ``repro_torch`` on the card.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``'s
``workloads``) names a configuration (its file under ``bench/configs``)
and a traffic mix (``bench/traffic/<traffic>.json``); its limits are in
``bench/limits/<workload>.json`` and each metric is read by
``bench/metrics/<metric>.py``.  A run:

  1. makes the cell's federations on the device from ``--seed``
     (``bench/generator.py``);
  2. warms the cell's own shapes: one short ``Experiment.run`` of the same
     experiment (two rounds, an Omega refresh after each), which captures
     the round program once;
  3. runs the whole experiment (``repro_torch.api.Experiment.run``) again
     and again, each run with its own driver seeds, until ``--seconds``
     have passed; the run that straddles the close is finished and
     counted.  With ``--trace 1`` the window is one run under the
     profiler;
  4. checks one run of the window, drawn from the seed, against the plain
     reference (``bench/reference.py``, ``bench/compare.py``), after the
     window's memory peak has been read and the program's state freed;
  5. prints the numbers compared beside their limits as the last lines of
     standard error, and one JSON line as the last line of standard output.

It exits with 2 and prints no result where CUDA is missing or has fewer
cards than the cell asks for, and with 3 where ``jax``, ``jaxlib``,
``flax`` or the JAX package ``repro`` is loaded once the window has closed.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import List, Optional  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "bench")
for _p in (os.path.join(ROOT, "src"), ROOT):
    if _p not in sys.path:
        sys.path.insert(0, _p)

#: modules whose presence after the window refuses the run, by the whole
#: top-level name (``repro_torch`` is not ``repro``)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
_SEED_BITS = 2 ** 63 - 1


@dataclasses.dataclass
class RunRecord:
    elapsed_s: float
    capture_s: Optional[float]
    task_rounds: int


@dataclasses.dataclass
class Run:
    """What a metric's reader reads (``bench/metrics/<name>.py``)."""
    cell: dict
    setup_s: float
    window_s: float
    runs: List[RunRecord]
    work: dict
    peak: Optional[dict]
    trace: object = None


def _json(path):
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, trace: bool) -> dict:
    """The cell's configuration, traffic, limits and metrics, found by name
    from ``BENCHMARK.json``."""
    spec = _json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    config = next(c for c in spec["configs"] if c["name"] == cell["config"])
    metrics = [m for m in spec["per_layer" if trace else "end_to_end"]
               if workload in m.get("workloads", [workload])]
    return dict(
        workload=workload, chips=int(cell["chips"]),
        config=_json(os.path.join(ROOT, config["file"])),
        traffic=_json(os.path.join(BENCH, "traffic",
                                   f"{cell['traffic']}.json")),
        limits=_json(os.path.join(BENCH, "limits", f"{workload}.json")),
        metrics=[(m["name"], m["unit"]) for m in metrics])


def _reader(name: str):
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver_seeds(seed: int, j: int, shuffles: int) -> List[int]:
    """The driver seed of each shuffle in the window's j-th run (j = -1:
    the warm-up), uint32 as the program's key takes them."""
    import numpy as np
    state = np.random.SeedSequence([int(seed) & _SEED_BITS, j + 1])
    return [int(s) for s in state.generate_state(shuffles)]


def build_experiment(cell: dict, train, test, device: str,
                     rounds: Optional[int] = None,
                     omega_every: Optional[int] = None):
    """The cell's ``repro_torch.api.Experiment`` over the benchmark's
    federations (``rounds``/``omega_every`` shorten it for the warm-up).
    The traffic's ``exec`` holds the ``Exec`` fields it sets (the engine,
    the driver), and ``route`` the path that ``Experiment.run`` has to
    take with them (``call`` in ``run_cell`` holds every run to it)."""
    from repro_torch.api import Eval, Exec, Experiment, Method, Problem
    from repro_torch.core import BudgetConfig, Probabilistic
    from repro_torch.core.dual import FederatedData
    tr = cell["traffic"]
    if tr["regularizer"] != "probabilistic" or tr["loss"] != "hinge":
        raise ValueError("the reference solves the probabilistic "
                         "regularizer with hinge loss only")

    def fed(split):
        if split.X.shape[0] == 1:
            return FederatedData(split.X[0], split.y[0], split.mask[0])
        return FederatedData(split.X, split.y, split.mask)

    regs = tuple(Probabilistic(lam=lam, sigma2=tr["sigma2"])
                 for lam in tr["lambdas"])
    return Experiment(
        problem=Problem(train=fed(train)),
        method=Method(loss=tr["loss"], regularizers=regs,
                      rounds=rounds or tr["rounds"],
                      omega_update_every=(tr["omega_update_every"]
                                          if omega_every is None
                                          else omega_every),
                      budget=BudgetConfig(passes=tr["passes"])),
        exec=Exec(**tr["exec"], device=device),
        eval=Eval(record_every=tr["record_every"], holdout=fed(test)))


def outputs(report) -> dict:
    """A run's answers as numpy arrays on the host, grid-shaped
    (R, S, ...), whichever path served it."""
    import numpy as np
    res = report.result
    err = np.asarray(report.evaluation.per_client["error"], np.float64)
    if report.provenance["path"] == "sweep":
        return dict(W=res.W, omega=res.omega, primal=res.primal,
                    dual=res.dual, error=err, budgets=None,
                    capture_s=res.capture_s)
    return dict(W=res.W[None, None], omega=res.omega[None, None],
                primal=np.array([[res.final("primal")]]),
                dual=np.array([[res.final("dual")]]), error=err[None, None],
                budgets=res.round_budgets[None], capture_s=res.capture_s)


def work_of(cell: dict, train) -> dict:
    """A run's counted work (``bench/cost.py``): every round solves the
    same budgets, so one round's count serves them all."""
    import numpy as np
    import torch
    from bench import cost
    tr = cell["traffic"]
    S, m, n, d = train.X.shape
    R, rounds, every = len(tr["lambdas"]), tr["rounds"], tr["omega_update_every"]
    max_steps = max(1, int(round(tr["passes"] * n)))
    budgets = torch.clamp(torch.round(tr["passes"] * train.mask.sum(-1)), 1,
                          max_steps).reshape(-1)
    budgets = np.tile(budgets.cpu().numpy(), R)     # cells in (R, S) order
    solve = cost.solve_cost(R * S * m, n, d, max_steps, budgets)
    return dict(rounds=rounds, cells=R * S, m=m,
                task_rounds=R * S * m * rounds,
                solve_bytes=solve["bytes"], solve_flops=solve["flops"],
                solve_mode=solve["mode"],
                round_flops=cost.round_flops(R * S, m, d),
                omega_steps=rounds // every if every else 0,
                omega_flops=cost.omega_flops(R * S, m, d))


def peak_of(device_name: str) -> Optional[dict]:
    peaks = _json(os.path.join(BENCH, "peaks.json"))
    return next((v for k, v in peaks.items()
                 if not k.startswith("_") and k in device_name), None)


def bound_by(run: Run) -> str:
    """Which of the card's two peaks bounds the solve's least time."""
    w, p = run.work, run.peak
    if p is None:
        return "unknown (no peak for this card)"
    return ("bytes" if w["solve_bytes"] / p["hbm_bytes_per_s"]
            >= w["solve_flops"] / p["fp32_flops_per_s"] else "operations")


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float = T0) -> dict:
    """Run the cell (steps 1-4 of the module's docstring); returns the
    result's fields, ``checks`` last, and the trace summary."""
    import numpy as np
    import torch
    from bench import compare, devtrace, generator, reference
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    tr = cell["traffic"]
    S = int(tr["shuffles"])

    def call(exp, j):
        seeds = driver_seeds(seed, j, S)
        rep = exp.run(seeds if S > 1 else seeds[0])
        sync()
        took = {k: rep.provenance[k] for k in tr["route"]}
        if took != tr["route"]:
            raise RuntimeError(f"routed to {took}, the traffic asks for "
                               f"{tr['route']}")
        return rep

    train, test = generator.make_shuffles(cell["config"], S, seed, device)
    exp = build_experiment(cell, train, test, device)
    call(build_experiment(cell, train, test, device, rounds=2,
                          omega_every=1), -1)
    work = work_of(cell, train)
    setup_s = time.perf_counter() - t0

    runs, outs, prof = [], [], None
    w0 = time.perf_counter()
    while True:
        r0 = time.perf_counter()
        if trace:
            rep, prof = devtrace.traced(lambda: call(exp, len(runs)))
        else:
            rep = call(exp, len(runs))
        out = outputs(rep)
        runs.append(RunRecord(time.perf_counter() - r0, out.pop("capture_s"),
                              work["task_rounds"]))
        outs.append(out)
        if trace or time.perf_counter() - w0 >= seconds:
            break
    window_s = time.perf_counter() - w0
    peak_bytes = torch.cuda.max_memory_allocated() if cuda else 0
    t_reduce = time.perf_counter()
    summary = devtrace.reduce(prof) if prof is not None else None
    t_reduce = time.perf_counter() - t_reduce
    del exp, rep, prof, train, test
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    name = torch.cuda.get_device_name(0) if cuda else "cpu"
    run = Run(cell=cell, setup_s=setup_s, window_s=window_s, runs=runs,
              work=work, peak=peak_of(name), trace=summary)
    metrics = {}
    for metric, unit in cell["metrics"]:
        value = _reader(metric)(run)
        if value is not None:
            metrics[metric] = {"value": float(value), "unit": unit}

    # the check: one run of the window, drawn from the seed
    j = int(np.random.default_rng(int(seed) & _SEED_BITS).integers(len(runs)))
    t_ref = time.perf_counter()
    ref_train, ref_test = generator.make_shuffles(cell["config"], S, seed,
                                                  device)
    ref = reference.solve(ref_train, tr["lambdas"], tr["sigma2"],
                          tr["rounds"], tr["omega_update_every"],
                          tr["passes"], driver_seeds(seed, j, S))
    correct, checks = compare.judge(
        compare.numbers(outs[j], ref, ref_test, tr["lambdas"]),
        cell["limits"])
    t_ref = time.perf_counter() - t_ref
    dev = {"platform": "gpu" if cuda else "cpu", "kind": name,
           "count": cell["chips"], "memory_peak_bytes": int(peak_bytes)}
    line = {"correct": correct, "attempted": len(runs),
            "failed": 0 if correct else 1, "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        line["breakdown"] = {"device_ops": summary.device_ops,
                             "idle_gaps": summary.idle_gaps}
    line["checks"] = checks
    return dict(line=line, forbidden=forbidden_modules(), run=run,
                checked_run=j, reduce_s=t_reduce, reference_s=t_ref)


def _environment() -> None:
    """Every build and kernel cache at a fixed directory of the checkout;
    one host thread for the numerical libraries, so that the run's host
    work is one thread's and does not spread with the machine's load."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    base = os.path.join(ROOT, ".bench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


def _card_line() -> str:
    with contextlib.suppress(OSError, subprocess.SubprocessError):
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    return "nvidia-smi unreadable"


def emit(got: dict, card: str) -> None:
    """Print a run: its times and the numbers compared beside their limits
    as the last lines of standard error, then the result as the last line
    of standard output."""
    line, run = got["line"], got["run"]
    print(f"card: {card}", file=sys.stderr)
    print(f"setup {run.setup_s:.3f} s, window {run.window_s:.3f} s, runs "
          + ", ".join(f"{r.elapsed_s:.3f}" for r in run.runs)
          + f" s; trace read in {got['reduce_s']:.3f} s; checked run "
          f"{got['checked_run']} in {got['reference_s']:.3f} s",
          file=sys.stderr)
    if run.trace is not None:
        t = run.trace
        print(f"trace: {t.kernels} kernels ({t.graph_kernels} from graph "
              f"replays, {t.graph_kernel_s:.4f} s), busy {t.busy_s:.4f} of "
              f"{t.window_s:.4f} s, of it the profiler's own stall "
              f"{t.profiler_stall_s:.4f} s; solve {run.work['solve_mode']}, "
              f"{run.work['solve_bytes']} B and {run.work['solve_flops']} "
              f"FLOP a round, bound by {bound_by(run)}", file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    cell = load_cell(args.workload, bool(args.trace))
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell["chips"]):
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    got = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    if got["forbidden"]:
        print("loaded after the window: " + ", ".join(got["forbidden"]),
              file=sys.stderr)
        return 3
    emit(got, _card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
