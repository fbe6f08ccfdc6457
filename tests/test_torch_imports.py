"""The port stands alone: it imports neither JAX nor the JAX package, its
entry points default to the card, and ``chip_smoke.py`` refuses to run
(printing no result) where there is no card or no package beside it."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

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
    assert int(out.stdout.split()[-1]) >= 20


def test_chip_smoke_imports_no_jax():
    src = (ROOT / "chip_smoke.py").read_text()
    assert "import jax" not in src and "from jax" not in src
    assert "from repro." not in src and "import repro\n" not in src


@pytest.mark.parametrize("entry", ["federation", "experiment", "convert"])
def test_default_device_is_the_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is available")
    from repro_torch.api import Exec, Experiment, Problem
    from repro_torch.convert import state_from_numpy
    from repro_torch.data.synthetic import tiny_problem
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "federation":
            tiny_problem()
        elif entry == "experiment":
            train = tiny_problem(device="cpu")[0]
            Experiment(problem=Problem(train=train), exec=Exec()).run(0)
        else:
            state_from_numpy([[0.0]], [[0.0]])


def test_unported_paths_name_their_roadmap_item():
    from repro_torch.api import (Eval, Exec, Experiment, Method, Problem,
                                 Systems)
    from repro_torch.core import MeanRegularized
    from repro_torch.data.synthetic import tiny_problem
    train = tiny_problem(device="cpu")[0]
    cases = [dict(eval=Eval(holdout=train)), dict(exec=Exec(telemetry=True,
                                                            device="cpu")),
             dict(exec=Exec(cohort=8, device="cpu")),
             dict(systems=Systems(dropout=0.1)),
             dict(exec=Exec(engine="sharded", device="cpu")),
             dict(exec=Exec(driver="scan", device="cpu")),
             dict(method=Method(regularizers=(MeanRegularized(),
                                              MeanRegularized(0.5))))]
    for kw in cases:
        kw.setdefault("exec", Exec(device="cpu"))
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            Experiment(problem=Problem(train=train), **kw).run(0)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Experiment(problem=Problem(train=[train, train])).route()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        Experiment(problem=Problem(train=train)).serve()


def test_chip_smoke_refuses_without_card_or_package(tmp_path):
    env = _env()
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, lone)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
