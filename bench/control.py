"""The readings that a cell's limits are set from, on the card.

    python3 bench/control.py --workload <name> --seeds 1,2,... \
        --control-seeds 101,102,103 [--out <file.json>]

For each of ``--seeds``: the cell's federations from that seed, one whole
``Experiment.run`` of the cell (the timed path's entry, at the timed
sizes, with the window's first driver seeds), and the numbers that
``bench/compare.py`` compares against the float64 reference.  The largest
of each over the seeds is its lower reading.

For each of ``--control-seeds``: the control, the reference itself put in
the program's place and computed in the precision below the configuration's
float32 with TF32 off, that is in TF32 (``reference.solve(...,
precision="tf32")``), and the same numbers against the float64 reference.
The smallest of each is its upper reading.  A limit lies between the two.

For each of ``--witness-seeds``: the reference in float32 (TF32 off), the
program's own precision, put in the program's place: where the program's
gaps are large, it tells whether float32 alone makes them so.

Prints one JSON line per seed and a summary line; ``--out`` also writes
them to a file.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path[:0] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]

from bench import run as harness  # noqa: E402


def control_outputs(ref: dict, test, single: bool) -> dict:
    """The control's answers in the program's form: its W, Omega and
    objectives, and its held-out error table counted in TF32."""
    import torch
    from bench.reference import _tf32
    W = torch.as_tensor(ref["W"], dtype=torch.float32, device=test.X.device)
    z = torch.einsum("smnd,rsmd->rsmn", _tf32(test.X), _tf32(W))
    wrong = ((torch.sign(z) != torch.sign(test.y[None])) & (test.mask[None] > 0))
    count = torch.clamp_min(test.mask.sum(-1), 1.0)[None]
    return dict(W=ref["W"], omega=ref["omega"], primal=ref["primal"],
                dual=ref["dual"],
                error=(wrong.sum(-1) / count).double().cpu().numpy(),
                budgets=ref["budgets"] if single else None)


def readings(cell: dict, seed: int, control, device: str = "cuda"):
    """The compared numbers of one seed: the program's (``control``
    False), or the reference's in the precision ``control`` names."""
    import torch
    from bench import compare, generator, reference
    tr = cell["traffic"]
    S = int(tr["shuffles"])
    seeds = harness.driver_seeds(seed, 0, S)
    t0 = time.perf_counter()
    train, test = generator.make_shuffles(cell["config"], S, seed, device)
    ref = reference.solve(train, tr["lambdas"], tr["sigma2"], tr["rounds"],
                          tr["omega_update_every"], tr["passes"], seeds)
    t_ref = time.perf_counter() - t0
    if control:
        got = reference.solve(train, tr["lambdas"], tr["sigma2"],
                              tr["rounds"], tr["omega_update_every"],
                              tr["passes"], seeds, precision=control)
        out = control_outputs(got, test, tr["route"]["path"] == "single")
    else:
        exp = harness.build_experiment(cell, train, test, device)
        rep = exp.run(seeds if S > 1 else seeds[0])
        out = harness.outputs(rep)
        out.pop("capture_s")
        del exp, rep
    if device == "cuda":
        torch.cuda.synchronize()
    nums = compare.numbers(out, ref, test, tr["lambdas"])
    cells = {k: v.tolist() for k, v in compare.per_cell(out, ref).items()}
    return dict(seed=seed, control=control, numbers=nums, per_cell=cells,
                reference_s=t_ref, total_s=time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--witness-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    harness._environment()
    cell = harness.load_cell(args.workload, False)
    rows = []
    for seeds, control in ((args.seeds, False), (args.control_seeds, "tf32"),
                           (args.witness_seeds, "float32")):
        for s in filter(None, seeds.split(",")):
            rows.append(readings(cell, int(s), control))
            print(json.dumps({k: v for k, v in rows[-1].items()
                              if k != "per_cell"}), flush=True)
    summary = {"workload": args.workload, "lower": {}, "upper": {},
               "witness": {}}
    for row in rows:
        side = {False: "lower", "tf32": "upper",
                "float32": "witness"}[row["control"]]
        pick = min if side == "upper" else max
        for k, v in row["numbers"].items():
            have = summary[side].get(k)
            summary[side][k] = v if have is None else pick(have, v)
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(rows=rows, summary=summary), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
