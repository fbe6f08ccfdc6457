"""The port's examples on the CPU: the quickstart held against the JAX
package's, ``mocha_federated``'s four sections at a few rounds with each
engine within its limit, ``serve_cohort`` small, each under the port's
W401 gate (no ``DeprecationWarning`` raised from the repo's own files);
and the one-rank process group that ``engine="sharded"`` makes, ended at
exit.
"""
import contextlib
import os
import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_lint import recorded, w401_split

ROOT = Path(__file__).resolve().parents[1]
#: the whole-run contract (ROADMAP, parity contract)
RTOL, ATOL = 1e-5, 1e-4
#: mocha_federated's sections at a few rounds: (section, rounds)
SECTIONS = (("methods", 4), ("robustness", 3), ("engines", 5),
            ("semi_sync", 4))


@contextlib.contextmanager
def one_thread():
    """The port's runs on one intra-op thread: torch's default (every core)
    in each of the suite's xdist workers oversubscribes the host and slows
    these runs tenfold; one thread also makes their bits independent of
    the host's core count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _no_first_party_deprecation(caught):
    findings, _ = w401_split(caught)
    assert findings == [], "\n".join(f.render() for f in findings)


@pytest.fixture(scope="module")
def port_quickstart():
    from repro_torch.examples.quickstart import main
    with one_thread():
        return recorded(main, ["--device", "cpu"])


@pytest.fixture(scope="module")
def jax_quickstart():
    return runpy.run_path(str(ROOT / "examples" / "quickstart.py"))["report"]


def test_quickstart_raises_no_first_party_deprecation(port_quickstart):
    report, caught = port_quickstart
    _no_first_party_deprecation(caught)
    assert (report.provenance["path"], report.provenance["device"]) == (
        "single", "cpu")


def test_quickstart_matches_the_jax_quickstart(port_quickstart,
                                               jax_quickstart):
    ours, ref = port_quickstart[0], jax_quickstart
    for key in ("gap", "primal", "dual"):
        np.testing.assert_allclose(ours.final(key), ref.final(key),
                                   rtol=RTOL, atol=ATOL, err_msg=key)
    np.testing.assert_allclose(ours.evaluation.summary["mean_error"],
                               ref.evaluation.summary["mean_error"],
                               rtol=RTOL, atol=ATOL)
    assert ours.history["round"] == ref.history["round"]


@pytest.fixture(scope="module")
def mocha_sections():
    from repro_torch.examples import mocha_federated as mf

    def run():
        train, test, reg = mf.federation("cpu")
        return {name: getattr(mf, name)(train, test, reg, "cpu",
                                        rounds=rounds)
                for name, rounds in SECTIONS}
    with one_thread():
        return recorded(run)


def test_mocha_federated_raises_no_first_party_deprecation(mocha_sections):
    out, caught = mocha_sections
    _no_first_party_deprecation(caught)
    assert set(out["methods"]) == {"MOCHA", "CoCoA", "Mb-SGD", "Mb-SDCA"}
    assert len(out["robustness"]) == 3
    assert out["semi_sync"].trace.summary()["rounds"] == 4
    for res in [*out["methods"].values(), *out["robustness"].values(),
                out["semi_sync"]]:
        assert np.isfinite(res.final("primal"))


def test_mocha_federated_engines_within_their_limits(mocha_sections):
    from repro_torch.examples.mocha_federated import KERNEL_RTOL
    runs, ok = mocha_sections[0]["engines"]
    assert ok
    local = runs["local"]
    assert [r.provenance["engine"] for r in runs.values()] == [
        "local", "kernel", "sharded"]
    # one-rank sharded: the local engine's bits
    np.testing.assert_array_equal(runs["sharded"].result.W, local.result.W)
    assert runs["sharded"].history == local.history
    # the kernel's plain version on the CPU: within 1e-4 x |primal|
    p, p_ref = (np.asarray(r.history["primal"]) for r in (runs["kernel"],
                                                           local))
    assert np.all(np.abs(p - p_ref) <= KERNEL_RTOL * np.abs(p_ref))


def test_serve_cohort_raises_no_first_party_deprecation(capsys):
    from repro_torch.examples.serve_cohort import main
    with one_thread():
        _, caught = recorded(main, ["--clients", "200", "--rounds", "2",
                                    "--device", "cpu"])
    _no_first_party_deprecation(caught)
    assert "executed as: cohort/" in capsys.readouterr().out


#: a one-rank ``engine="sharded"`` run; an exit hook registered before it
#: (so it runs after the port's own) prints whether a group is left.
#: ``destroy`` ends the group first; ``replace`` puts the caller's own
#: one-rank group in its place, which the port must leave alone.
GROUP_EXIT = """
import atexit, sys
import torch.distributed as dist
atexit.register(lambda: print("initialized at exit:", dist.is_initialized()))
from repro_torch.api import Exec, Experiment, Problem
from repro_torch.data.synthetic import tiny_problem
device, mode = sys.argv[1:]
train = tiny_problem(device=device)[0]
rep = Experiment(problem=Problem(train=train),
                 exec=Exec(engine="sharded", device=device)).run(0)
assert dist.is_initialized() and rep.provenance["engine"] == "sharded"
if mode in ("destroy", "replace"):
    dist.destroy_process_group()
if mode == "replace":
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
"""


def run_group_exit(device: str, mode: str, card: bool = False):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    if not card:
        env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "-c", GROUP_EXIT, device, mode],
                          env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("mode,left", [("keep", False), ("destroy", False),
                                       ("replace", True)])
def test_the_ports_one_rank_group_ends_at_exit(mode, left):
    out = run_group_exit("cpu", mode)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1] == f"initialized at exit: {left}"
    assert "Traceback" not in out.stderr and "atexit" not in out.stderr
