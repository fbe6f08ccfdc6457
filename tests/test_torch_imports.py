"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points default to the card, and ``chip_smoke.py`` refuses to run
(printing no result) where there is no card or no package beside it."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any import of jax or repro now fails
sys.modules["repro"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
assert not any(k == "jax" or k.startswith(("jax.", "repro."))
               for k, v in sys.modules.items() if v is not None)
for sub in ("configs.smollm_360m", "models.layers", "models.transformer",
            "serve.engine", "launch.serve", "kernels.build",
            "kernels.flash_attention.ops", "kernels.decode_attention.ops",
            "cohort", "cohort.driver", "cohort.packing", "cohort.resilience",
            "obs", "obs.summarize", "train.checkpoint", "utils.timing",
            "serve.store", "serve.predict", "serve.refresh",
            "core.personalization", "data.tokens", "train.losses",
            "train.optimizer", "train.loop", "launch.train",
            "examples.personalize", "examples.serve_cohort",
            "examples.train_lm", "examples.sharded", "examples.quickstart",
            "examples.mocha_federated", "federated",
            "federated.runtime", "federated.sharding", "utils.dist",
            "configs.shapes", "launch.mesh", "launch.sharding",
            "launch.specs", "launch.roofline", "launch.dryrun",
            "utils.pjit_utils", "launch.hlo_stats", "launch.probe",
            "launch.mocha_dryrun"):
    assert "repro_torch." + sub in names, sub
print(len(names))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_port_imports_without_jax_or_repro():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 40


def test_chip_smoke_imports_no_jax():
    src = (ROOT / "chip_smoke.py").read_text()
    assert "import jax" not in src and "from jax" not in src
    assert "from repro." not in src and "import repro\n" not in src


@pytest.mark.parametrize("entry", ["federation", "experiment", "convert",
                                   "model", "serve", "serve_session",
                                   "predictor", "personalize", "train",
                                   "quickstart", "mocha_federated"])
def test_default_device_is_the_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is available")
    from repro_torch.api import Exec, Experiment, Problem
    from repro_torch.cohort import Population, PopulationSpec
    from repro_torch.configs import get_config
    from repro_torch.convert import state_from_numpy
    from repro_torch.data.synthetic import tiny_problem
    from repro_torch.examples.mocha_federated import main as mocha_main
    from repro_torch.examples.personalize import main as personalize_main
    from repro_torch.examples.quickstart import main as quickstart_main
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import main as train_main
    from repro_torch.models import build_model
    from repro_torch.serve import Predictor, SnapshotStore
    pop = Population(PopulationSpec("p", m=50, d=4, n_min=4, n_max=8), 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "serve_session":
            Experiment(problem=Problem(population=pop),
                       exec=Exec(cohort=8)).serve()
        elif entry == "predictor":
            Predictor(SnapshotStore())
        elif entry == "personalize":
            personalize_main(["--tasks", "2", "--per-task", "4"])
        elif entry == "quickstart":
            quickstart_main([])
        elif entry == "mocha_federated":
            mocha_main([])
        elif entry == "train":
            train_main(["--arch", "smollm-360m", "--local", "--steps", "1"])
        elif entry == "federation":
            tiny_problem()
        elif entry == "experiment":
            train = tiny_problem(device="cpu")[0]
            Experiment(problem=Problem(train=train), exec=Exec()).run(0)
        elif entry == "convert":
            state_from_numpy([[0.0]], [[0.0]])
        elif entry == "model":
            build_model(get_config("smollm-360m").reduced())
        else:
            serve_main(["--arch", "smollm-360m", "--local"])


def test_unported_paths_name_their_roadmap_item():
    """The sharded engine (item 13), the cohort path's fields (item 11),
    telemetry and serving (item 12) route and run, as in the JAX package:
    ``engine="sharded"`` with its wire dtype runs the single path on the
    loop driver; on a silo problem the population-only fields are
    ignored, the resilience fields raise, and ``serve()`` raises the JAX
    package's ``ValueError``; on a population ``serve()`` routes to the
    cohort path and runs."""
    from repro_torch.api import Eval, Exec, Experiment, Problem, Systems
    from repro_torch.cohort import FaultConfig, Population, PopulationSpec
    from repro_torch.data.synthetic import tiny_problem
    train = tiny_problem(device="cpu")[0]
    rep = Experiment(problem=Problem(train=train),
                     exec=Exec(engine="sharded", comm_dtype="bfloat16",
                               device="cpu")).run(0)
    assert (rep.provenance["path"], rep.provenance["driver"],
            rep.provenance["engine"]) == ("single", "loop", "sharded")
    assert np.isfinite(rep.result.W).all()
    with pytest.raises(ValueError, match="needs a population-scale "
                                         "problem"):
        Experiment(problem=Problem(train=train),
                   exec=Exec(device="cpu")).serve()
    for kw in (dict(exec=Exec(telemetry=True, device="cpu")),
               dict(exec=Exec(cohort=8, device="cpu")),
               dict(systems=Systems(dropout=0.1)),
               dict(eval=Eval(holdout_clients=8))):
        kw.setdefault("exec", Exec(device="cpu"))
        rep = Experiment(problem=Problem(train=train), **kw).run(0)
        assert rep.provenance["path"] == "single"
        assert (rep.provenance["telemetry"] is not None) == \
            kw["exec"].telemetry
    with pytest.raises(ValueError, match="only apply to population"):
        Experiment(problem=Problem(train=train),
                   systems=Systems(faults=FaultConfig()),
                   exec=Exec(device="cpu")).run(0)
    pop = Population(PopulationSpec("p", m=50, d=4, n_min=4, n_max=8), 0)
    plan = Experiment(problem=Problem(population=pop)).route()
    assert (plan.path, plan.driver, plan.engine) == ("cohort", "scan",
                                                    "local")
    rep = Experiment(problem=Problem(population=pop),
                     systems=Systems(dropout=0.1),
                     exec=Exec(cohort=8, device="cpu"),
                     eval=Eval(holdout_clients=8)).run(0)
    assert rep.provenance["path"] == "cohort"
    assert rep.evaluation.summary["holdout_clients"] == 8.0
    sess = Experiment(problem=Problem(population=pop),
                      systems=Systems(dropout=0.1),
                      exec=Exec(cohort=8, device="cpu"),
                      eval=Eval(holdout_clients=8)).serve(0)
    served = sess.run()
    assert served.history == rep.result.history
    assert sess.report().provenance["path"] == "cohort"


def test_serve_launcher_runs_on_the_cpu(capsys, tmp_path):
    from repro_torch.launch.serve import main as serve_main
    serve_main(["--arch", "smollm-360m", "--local", "--device", "cpu",
                "--batch", "2", "--prompt-len", "5", "--new-tokens", "3"])
    assert "generated: (2, 3)" in capsys.readouterr().out
    with pytest.raises(SystemExit) as exc:   # the plan, written on the CPU
        serve_main(["--arch", "smollm-360m", "--dry-run", "--device", "cpu",
                    "--out", str(tmp_path)])
    assert exc.value.code == 0
    assert [p.name for p in tmp_path.iterdir()] == [
        "smollm-360m__decode_32k__pod16x16.json"]


def test_chip_smoke_refuses_without_card_or_package(tmp_path):
    env = _env()
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, lone)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
