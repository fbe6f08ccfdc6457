"""``repro_torch.examples.sharded_lm_floor``, the rounding-floor probe of
the sharded LM step, on four gloo ranks on the CPU under
``torch.distributed.run`` with ``--local`` (the reduced rwkv6 config at 1
and 2 layers, two perturbation seeds): its JSON line holds a row a run
with the mesh's errors a step and each seed's floor; at this size the
mesh meets the sharded example's limits and every floor is under them.
The perturbation itself: a model built under ``perturbed`` differs from
the unperturbed one by about ``PERTURB``, and the builder is restored.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.examples import sharded_lm_floor as F

from test_torch_sharded_lm import _launch


@pytest.fixture(scope="module")
def report(tmp_path_factory):
    rc, text, _ = _launch(tmp_path_factory.mktemp("floor"),
                          "repro_torch.examples.sharded_lm_floor",
                          ["--device", "cpu", "--local"])
    assert rc == 0, text[-4000:]
    lines = [line for line in text.splitlines()
             if line.startswith('{"sharded_lm_floor"')]
    assert len(lines) == 1, text[-4000:]
    return json.loads(lines[0])["sharded_lm_floor"]


def test_probe_reports_every_run_beside_its_floors(report):
    assert report["ranks"] == 4 and report["gloo_collectives"] is True
    assert report["arch"] == "rwkv6-7b-reduced"
    assert report["seeds"] == list(F.LOCAL_SEEDS)
    kinds = [(r["kind"], r["layers"], r["dtype"]) for r in report["runs"]]
    want = ([("train", d, "bfloat16") for d in F.LOCAL_DEPTHS]
            + [("generate", d, dt) for d in F.LOCAL_DEPTHS
               for dt in ("float32", "bfloat16")])
    assert kinds == want


@pytest.mark.parametrize("kind", ["train", "generate"])
def test_probe_at_the_reduced_size_meets_the_limits(report, kind):
    for r in (r for r in report["runs"] if r["kind"] == kind):
        assert r["meets_limit"] and r["floor_under_limit"], r
        floors = (r["rel_err_floor"] if kind == "train"
                  else r["logit_err_floor"])
        assert sorted(floors) == [str(s) for s in F.LOCAL_SEEDS]
        for f in floors.values():
            errs = f["ce"] + f["grad_norm"] if kind == "train" else f
            assert all(np.isfinite(errs)) and len(errs) >= 2
        if kind == "generate" and r["dtype"] == "float32":
            assert r["tokens_equal"]


def test_perturbed_scales_each_weight_by_about_perturb():
    from repro_torch import models
    from repro_torch.examples.sharded_lm import local_cfg
    cfg = local_cfg("rwkv6-7b")
    build = models.build_model
    base = build(cfg, device="cpu", seed=0)
    with F.perturbed(1):
        moved = models.build_model(cfg, device="cpu", seed=0)
    again = models.build_model(cfg, device="cpu", seed=0)
    assert models.build_model is build
    rel = []
    for a, b, c in zip(base.parameters(), moved.parameters(),
                       again.parameters()):
        assert torch.equal(a, c)
        nz = a != 0
        rel.append(((b - a)[nz] / a[nz]).abs().flatten())
    rel = torch.cat(rel)
    assert 0 < float(rel.max()) < 10 * F.PERTURB
    assert 0.5 * F.PERTURB < float(rel.std()) < 2 * F.PERTURB
