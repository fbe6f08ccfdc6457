"""The port's sharded MOCHA runtime against the JAX package's, on the CPU.

One rank (a gloo group on a ``HashStore``, the counterpart of JAX's
one-device mesh) gives the local engine's bits, as in the JAX package.
Against JAX a round is held as JAX's own test holds its round (alpha atol
1e-6, v atol 1e-5) and whole runs within the run contract (objectives rtol
1e-5 / atol 1e-4, W atol 1e-5).  Two and four gloo ranks run in spawned
processes on a ``FileStore``; every rank must hold the same bits, and the
result the local engines' within the run contract.
"""
import contextlib
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.api as ja
import repro.core as jc
from repro.core.engine import ShardedEngine as JShardedEngine
from repro.core.mocha import _run_mocha as jax_run_mocha
from repro.data.synthetic import tiny_problem as jax_tiny
from repro.federated import runtime as jrt
from repro.federated import sharding as jsh
import repro_torch.api as ta
import repro_torch.core as tc
from repro_torch.core.mocha import _run_mocha
from repro_torch.data.synthetic import tiny_problem
from repro_torch.federated import runtime as trt
from repro_torch.federated import sharding as tsh
from repro_torch.utils import prng
from repro_torch.utils.dist import counted_collectives

ROOT = Path(__file__).resolve().parents[1]
REG = dict(lambda1=0.5, lambda2=0.5)
#: the run contract against the JAX package and across rank counts
OBJ_TOL = dict(rtol=1e-5, atol=1e-4)
W_TOL = dict(rtol=0, atol=1e-5)

#: tests/test_runtime.py's ``engine_runs`` config and ``_ENGINE_CASES``
CASES = {
    "engine_runs": (dict(m=5, n=24, d=6, seed=2), dict(
        rounds=12, record_every=4, seed=3,
        budget=dict(passes=1.0, systems_lo=0.5, drop_prob=0.3))),
    "gamma_half": (dict(m=4, n=20, d=6, seed=4), dict(
        rounds=10, gamma=0.5, budget=dict(passes=1.0), record_every=4,
        seed=1)),
    "omega_refresh": (dict(m=4, n=20, d=6, seed=0), dict(
        rounds=12, omega_update_every=4, record_every=4, seed=0)),
    "semi_sync": (dict(m=4, n=20, d=6, seed=5), dict(
        rounds=8, record_every=2, seed=5, systems=dict(
            network="3g", policy="semi_sync", clock_cycle_s=0.001,
            rate_lo=0.5, rate_hi=1.5, straggler_prob=0.3,
            comm_jitter=0.2))),
    "carry_mode": (dict(m=3, n=18, d=160, seed=2), dict(
        rounds=8, record_every=3, seed=7,
        budget=dict(passes=1.0, systems_lo=0.5, drop_prob=0.3))),
}


def _cfg(core, case, **extra):
    kw = dict(CASES[case][1], loss="hinge", **extra)
    kw["budget"] = core.BudgetConfig(**kw.get("budget", {}))
    if "systems" in kw:
        kw["systems"] = core.SystemsConfig(**kw["systems"])
    return core.MochaConfig(**kw)


def _problem(case):
    p = CASES[case][0]
    return jax_tiny(**p)[0], tiny_problem(**p, device="cpu")[0]


def _same_bits(a, b):
    assert torch.equal(a.state.alpha, b.state.alpha)
    assert torch.equal(a.state.v, b.state.v)
    np.testing.assert_array_equal(a.W, b.W)
    np.testing.assert_array_equal(a.omega, b.omega)
    assert a.history == b.history
    np.testing.assert_array_equal(a.round_budgets, b.round_budgets)


def _hold_to_jax(jres, tres):
    """Whole runs within the run contract; the clock and budgets equal."""
    jh, th = jres.history, tres.history
    assert set(th) == set(jh) == set(tc.HISTORY_KEYS)
    for k in ("round", "round_max_steps", "time"):
        assert th[k] == jh[k], k
    for k in ("dual", "primal", "gap"):
        np.testing.assert_allclose(th[k], jh[k], err_msg=k, **OBJ_TOL)
    np.testing.assert_allclose(tres.W, np.asarray(jres.W), **W_TOL)
    np.testing.assert_array_equal(tres.round_budgets,
                                  np.asarray(jres.round_budgets))


# -- padding ------------------------------------------------------------------

@pytest.mark.parametrize("shards", [1, 2, 4])
def test_padding_matches_jax_bitwise(shards):
    jdata, tdata = jax_tiny(m=5, n=20, d=6)[0], tiny_problem(
        m=5, n=20, d=6, device="cpu")[0]
    for jd, td in ((jdata, tdata), (jdata._replace(xnorm2=jdata.X[..., 0]),
                                    tdata._replace(xnorm2=tdata.X[..., 0]))):
        jp, jm = jsh.pad_tasks(jd, shards)
        tp, tm = tsh.pad_tasks(td, shards)
        assert tm == jm == 5 and tp.m == jp.m
        for a, b in zip(jp, tp):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    m_pad = tp.m
    K = np.random.default_rng(0).normal(size=(5, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        tsh.pad_task_matrix(torch.from_numpy(K), m_pad).numpy(),
        np.asarray(jsh.pad_task_matrix(jnp.asarray(K), m_pad)))
    q = np.linspace(0.5, 2.0, 5, dtype=np.float32)
    b = np.array([16, 8, 0, 4, 3], np.int32)
    for x, fill in ((q, 1.0), (b, 0.0)):
        np.testing.assert_array_equal(
            tsh.pad_vector(torch.from_numpy(x), m_pad, fill).numpy(),
            np.asarray(jsh.pad_vector(jnp.asarray(x), m_pad, fill)))


# -- one round ----------------------------------------------------------------

def _round_inputs():
    """tests/test_runtime.py::test_distributed_round_matches_local's."""
    jtrain, ttrain = jax_tiny(m=4, n=16, d=5, seed=1)[0], tiny_problem(
        m=4, n=16, d=5, seed=1, device="cpu")[0]
    jreg, treg = jc.MeanRegularized(**REG), tc.MeanRegularized(**REG)
    jK = jreg.K(jreg.init_omega(4))
    tK = treg.K(treg.init_omega(4, device="cpu"))
    jq = jc.sigma_prime(jK) * jnp.diagonal(jK) / 2.0
    tq = tc.sigma_prime(tK) * torch.diagonal(tK) / 2.0
    budgets = np.array([16, 8, 16, 4], np.int32)
    jkeys = jax.random.split(jax.random.PRNGKey(3), 4)
    tkeys = prng.split(prng.PRNGKey(3), 4)
    return (jtrain, jK, jq, jnp.asarray(budgets), jkeys), (
        ttrain, tK, tq, torch.from_numpy(budgets), tkeys)


def _jax_round(args, comm_dtype=None):
    train, K, q, budgets, keys = args
    alpha0 = jnp.zeros_like(train.y)
    v0 = jnp.zeros((train.m, train.d))
    return jrt.distributed_round(jrt.make_federated_mesh(),
                                 jc.get_loss("hinge"), 16, train, alpha0, v0,
                                 K, q, budgets, 1.0, keys,
                                 comm_dtype=comm_dtype)


def _port_round(args, comm_dtype=None):
    train, K, q, budgets, keys = args
    alpha0 = torch.zeros_like(train.y)
    v0 = torch.zeros((train.m, train.d))
    return trt.distributed_round(trt.make_federated_mesh(device="cpu"),
                                 tc.get_loss("hinge"), 16, train, alpha0, v0,
                                 K, q, budgets, 1.0, keys,
                                 comm_dtype=comm_dtype)


def test_distributed_round_matches_jax_and_the_local_solve():
    jargs, targs = _round_inputs()
    ja_, jv = _jax_round(jargs)
    ta_, tv = _port_round(targs)
    np.testing.assert_allclose(ta_.numpy(), np.asarray(ja_), atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    # one rank: the port's own local batched solve, bit for bit
    train, K, q, budgets, keys = targs
    W = tc.primal_weights(K, torch.zeros((4, 5)))
    dalpha, u = tc.batched_local_sdca(
        tc.get_loss("hinge"), train.X, train.y, train.mask,
        torch.zeros_like(train.y), W, q, budgets, keys, 16)
    assert torch.equal(ta_, dalpha) and torch.equal(tv, u)


def test_padded_tasks_stay_exactly_zero():
    """m = 5 padded to 8 in one rank's block: the padded rows come out
    exactly 0 and the real rows are the unpadded round's."""
    train = tiny_problem(m=5, n=16, d=5, seed=1, device="cpu")[0]
    reg = tc.MeanRegularized(**REG)
    K = reg.K(reg.init_omega(5, device="cpu"))
    q = tc.sigma_prime(K) * torch.diagonal(K) / 2.0
    budgets = torch.tensor([16, 8, 16, 4, 9], dtype=torch.int32)
    keys = prng.split(prng.PRNGKey(3), 5)
    alpha = torch.rand_like(train.y) * 0.1 * train.mask
    v = tc.compute_v(train, alpha)
    mesh = trt.make_federated_mesh(device="cpu")
    args = (mesh, tc.get_loss("hinge"), 16)
    ref_a, ref_v = trt.distributed_round(*args, train, alpha, v, K, q,
                                         budgets, 1.0, keys)
    data_p, _ = tsh.pad_tasks(train, 4)
    got_a, got_v = trt.distributed_round(
        *args, data_p, tsh.pad_vector(alpha, 8), tsh.pad_vector(v, 8),
        tsh.pad_task_matrix(K, 8), tsh.pad_vector(q, 8, 1.0),
        tsh.pad_vector(budgets, 8), 1.0, tsh.pad_vector(keys, 8))
    assert got_a.shape == (8, train.n_max) and got_v.shape == (8, 5)
    assert torch.count_nonzero(got_a[5:]) == 0
    assert torch.count_nonzero(got_v[5:]) == 0
    torch.testing.assert_close(got_a[:5], ref_a, rtol=0, atol=1e-6)
    torch.testing.assert_close(got_v[:5], ref_v, rtol=0, atol=1e-5)


@pytest.mark.parametrize("wire", [None, torch.bfloat16])
def test_one_round_makes_one_all_gather(wire):
    """The round's only collective: one all-gather of m_pad x d wire
    elements; the engine's round adds the alpha gather (m_pad x n_max,
    v's dtype), which the driver reads."""
    _, targs = _round_inputs()
    with counted_collectives() as calls:
        _port_round(targs, comm_dtype=wire)
    assert len(calls) == 1
    name, shape, dtype = calls[0]
    assert "all_gather" in name and shape == (4, 5)
    assert dtype == (wire or torch.float32)
    train = tiny_problem(m=5, n=24, d=6, seed=2, device="cpu")[0]
    eng = tc.ShardedEngine(comm_dtype=wire)
    state = eng.setup(train, tc.get_loss("hinge"), 24)
    K = torch.eye(5)
    with counted_collectives() as calls:
        eng.round(state, K, torch.ones(5), torch.full((5,), 10), 1.0,
                  prng.PRNGKey(0))
    assert [(s, d) for _, s, d in calls] == [
        ((5, 6), wire or torch.float32), ((5, train.n_max), torch.float32)]


# -- the bf16 wire ------------------------------------------------------------

def test_bf16_wire_cast_matches_jax_bitwise():
    """``Tensor.to(torch.bfloat16)`` and ``astype(jnp.bfloat16)`` both round
    to nearest even, ties included."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.normal(0, 1, 4096), rng.normal(0, 1e-3, 1024),
        rng.normal(0, 1e4, 1024),
        # exact ties between two bf16 values, both parities
        (1.0 + np.arange(64) * 2.0 ** -7 + 2.0 ** -8) * np.where(
            np.arange(64) % 2, 1, -1)]).astype(np.float32)
    t = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    j = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).view(np.int16)
    np.testing.assert_array_equal(t, j)


def test_bf16_wire_matches_jax():
    """One round, then engine_runs' 12 rounds, with the Delta v wire in
    bf16 in both packages: within the run contract."""
    jargs, targs = _round_inputs()
    ja_, jv = _jax_round(jargs, comm_dtype=jnp.bfloat16)
    ta_, tv = _port_round(targs, comm_dtype=torch.bfloat16)
    np.testing.assert_allclose(ta_.numpy(), np.asarray(ja_), atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **OBJ_TOL)
    # the wire rounded: v is the bf16 image of the f32 round's
    _, tv32 = _port_round(targs)
    assert torch.equal(tv, tv32.to(torch.bfloat16).float())
    assert not torch.equal(tv, tv32)
    jdata, tdata = _problem("engine_runs")
    jres = jax_run_mocha(jdata, jc.MeanRegularized(**REG),
                         _cfg(jc, "engine_runs"),
                         engine=JShardedEngine(comm_dtype=jnp.bfloat16))
    tres = _run_mocha(tdata, tc.MeanRegularized(**REG),
                      _cfg(tc, "engine_runs", device="cpu"),
                      engine=tc.ShardedEngine(comm_dtype="bfloat16"))
    _hold_to_jax(jres, tres)
    f32 = _run_mocha(tdata, tc.MeanRegularized(**REG),
                     _cfg(tc, "engine_runs", device="cpu"), engine="sharded")
    assert f32.history["gap"] != tres.history["gap"]


# -- whole runs, one rank -----------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_engine_equals_local_bitwise(case):
    """One rank: alpha, v, W, Omega, the history and the budgets of the
    local engine, bit for bit; the history schema on the record cadence."""
    _, tdata = _problem(case)
    cfg = _cfg(tc, case, device="cpu")
    reg = tc.MeanRegularized(**REG)
    local = _run_mocha(tdata, reg, cfg, engine="local")
    sharded = _run_mocha(tdata, reg, cfg, engine="sharded")
    _same_bits(local, sharded)
    rounds, every = cfg.rounds, cfg.record_every
    want = sorted(set(range(0, rounds, every)) | {rounds - 1})
    assert set(sharded.history) == set(tc.HISTORY_KEYS)
    assert all(len(v) == len(want) for v in sharded.history.values())
    assert sharded.history["round"] == want


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_engine_matches_jax_sharded_engine(case):
    """The same runs against the JAX package's sharded engine on its
    one-device mesh: within the run contract."""
    jdata, tdata = _problem(case)
    jres = jax_run_mocha(jdata, jc.MeanRegularized(**REG), _cfg(jc, case),
                         engine="sharded")
    tres = _run_mocha(tdata, tc.MeanRegularized(**REG),
                      _cfg(tc, case, device="cpu"), engine="sharded")
    _hold_to_jax(jres, tres)


# -- several ranks ------------------------------------------------------------

_WORKER = r'''
import sys
from datetime import timedelta
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, k, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", store=dist.FileStore(store, k), rank=rank,
                        world_size=k, timeout=timedelta(seconds=60))
from repro_torch.core import BudgetConfig, MeanRegularized, MochaConfig
from repro_torch.core.mocha import _run_mocha
from repro_torch.data.synthetic import tiny_problem
from repro_torch.utils.dist import counted_collectives
train = tiny_problem(m=5, n=24, d=6, seed=2, device="cpu")[0]
cfg = MochaConfig(loss="hinge", rounds=12, record_every=4, seed=3,
                  budget=BudgetConfig(passes=1.0, systems_lo=0.5,
                                      drop_prob=0.3), device="cpu")
with counted_collectives() as calls:
    res = _run_mocha(train, MeanRegularized(0.5, 0.5), cfg, engine="sharded")
hist = {f"h_{key}": np.asarray(val) for key, val in res.history.items()}
np.savez(f"{out}.{rank}.npz", alpha=res.state.alpha.numpy(),
         v=res.state.v.numpy(), W=res.W, omega=res.omega,
         budgets=res.round_budgets,
         gathers=np.array([c.shape for c in calls]),
         names=np.array([c.name for c in calls]), **hist)
dist.destroy_process_group()
'''

#: the spawned ranks' wall limit: a rank that dies leaves the others in a
#: collective until their 60 s group timeout; the test fails before that
SPAWN_TIMEOUT_S = 90


def _spawn(k, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(k),
         str(tmp_path / "store"), str(tmp_path / "out")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(k)]
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pytest.fail(f"{k} ranks did not finish in {SPAWN_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}: {p.stderr.read()[-2000:]}"
    return [dict(np.load(tmp_path / f"out.{r}.npz")) for r in range(k)]


@pytest.mark.parametrize("k", [2, 4])
def test_ranks_agree_and_hold_the_local_engines(k, tmp_path):
    """m = 5 over k gloo ranks (padded to 6 and 8): every rank holds the
    same bits, two gathers a round (Delta v, m_pad x d; alpha, m_pad x
    n_max), and the result is the port's and JAX's local engines' within
    the run contract."""
    ranks = _spawn(k, tmp_path)
    for r in ranks[1:]:
        for key, val in ranks[0].items():
            np.testing.assert_array_equal(r[key], val, err_msg=key)
    m_pad = 6 if k == 2 else 8
    got = ranks[0]
    jdata, tdata = _problem("engine_runs")
    np.testing.assert_array_equal(got["gathers"],
                                  [(m_pad, 6), (m_pad, tdata.n_max)] * 12)
    assert all(n.startswith("all_gather") for n in got["names"])
    jres = jax_run_mocha(jdata, jc.MeanRegularized(**REG),
                         _cfg(jc, "engine_runs"), engine="local")
    tres = _run_mocha(tdata, tc.MeanRegularized(**REG),
                      _cfg(tc, "engine_runs", device="cpu"), engine="local")
    worst = {}
    for name, ref in (("port local", tres), ("jax local", jres)):
        for key in ("dual", "primal", "gap"):
            np.testing.assert_allclose(got[f"h_{key}"], ref.history[key],
                                       err_msg=f"{name} {key}", **OBJ_TOL)
        np.testing.assert_allclose(got["W"], np.asarray(ref.W), **W_TOL)
        np.testing.assert_array_equal(got["budgets"],
                                      np.asarray(ref.round_budgets))
        assert list(got["h_time"]) == ref.history["time"]
        worst[name] = float(np.max(np.abs(got["W"] - np.asarray(ref.W))))
    # the largest difference measured in W, at k 2 and 4 alike: 0 against
    # the port's local engine, 2.4e-7 against JAX's (the packages' float32
    # association); JAX's own 4-device run sits 2.4e-7 off its local engine
    print(f"k={k}: max |W - W_local| {worst}")
    assert max(worst.values()) <= 1e-6


# -- the experiment surface ---------------------------------------------------

def test_exec_fields_build_the_sharded_engine():
    mesh = trt.make_federated_mesh(device="cpu")
    eng = ta.Exec(engine="sharded", comm_dtype="bfloat16",
                  device="cpu").resolve_engine()
    assert isinstance(eng, tc.ShardedEngine)
    assert eng.comm_dtype is torch.bfloat16
    assert ta.Exec(engine="sharded", mesh=mesh).resolve_engine()._mesh_arg \
        is mesh
    assert type(ta.Exec(engine="sharded").resolve_engine()) is \
        tc.ShardedEngine
    with pytest.raises(ValueError, match="not a torch dtype"):
        tc.ShardedEngine(comm_dtype="float8")
    # a wire dtype is part of the experiment's fingerprint
    train = tiny_problem(device="cpu")[0]
    hashes = {ta.config_fingerprint(ta.Experiment(
        problem=ta.Problem(train=train),
        exec=ta.Exec(engine="sharded", comm_dtype=dt)))
        for dt in (None, torch.bfloat16, torch.float16)}
    assert len(hashes) == 3
    rep = ta.Experiment(problem=ta.Problem(train=train),
                        method=ta.Method(regularizers=(
                            tc.MeanRegularized(**REG),), rounds=3),
                        exec=ta.Exec(engine="sharded", mesh=mesh,
                                     comm_dtype=torch.bfloat16,
                                     device="cpu")).run(0)
    assert (rep.provenance["path"], rep.provenance["driver"],
            rep.provenance["engine"]) == ("single", "loop", "sharded")


def test_mesh_checks_raise_and_never_fall_back(monkeypatch):
    with pytest.raises(ValueError, match="n_shards=2"):
        trt.make_federated_mesh(n_shards=2, device="cpu")
    assert trt.make_federated_mesh(n_shards=1, device="cpu").size() == 1
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    for config, dev, ok in (("cuda:nccl", cpu, False),
                            ("cpu:gloo", cuda, False),
                            ("cpu:gloo,cuda:gloo", cuda, True),
                            ("cpu:gloo,cuda:nccl", cpu, True),
                            ("cpu:gloo,cuda:nccl", cuda, True)):
        monkeypatch.setattr(dist, "get_backend_config",
                            lambda group=None, _c=config: _c)
        with (contextlib.nullcontext() if ok
              else pytest.raises(RuntimeError, match="cannot run under")):
            trt.check_group(None, dev)


def test_rank0_alone_writes_the_trace(tmp_path, monkeypatch):
    """Under a process group, rank 0 writes a run's files; another rank
    reports the same path and writes nothing."""
    train = tiny_problem(device="cpu")[0]

    def run(rank):
        monkeypatch.setattr(dist, "get_rank", lambda group=None: rank)
        return ta.Experiment(
            problem=ta.Problem(train=train),
            method=ta.Method(regularizers=(tc.MeanRegularized(**REG),),
                             rounds=2),
            exec=ta.Exec(device="cpu",
                         trace_dir=str(tmp_path / "traces"))).run(0)

    trt.make_federated_mesh(device="cpu")   # a group exists
    other = run(1)
    assert not (tmp_path / "traces").exists()
    first = run(0)
    assert Path(first.provenance["trace_path"]).is_file()
    assert other.provenance["trace_path"] == first.provenance["trace_path"]


def test_rank0_alone_writes_checkpoints_every_rank_records_them(
        tmp_path, monkeypatch):
    """A cohort run's checkpoints: rank 0 writes them; another rank writes
    nothing and records the same checkpoint span and metrics."""
    from repro_torch.cohort import Population, PopulationSpec
    pop = Population(PopulationSpec("t_ck", m=60, d=6, n_min=8, n_max=16,
                                    clusters=2), seed=0)

    def run(rank):
        monkeypatch.setattr(dist, "get_rank", lambda group=None: rank)
        return ta.Experiment(
            problem=ta.Problem(population=pop),
            method=ta.Method(regularizers=(tc.Probabilistic(
                lam=1e-2, sigma2=10.0),), rounds=4),
            exec=ta.Exec(cohort=8, checkpoint_every=2, telemetry=True,
                         checkpoint_dir=str(tmp_path / f"ck{rank}"),
                         device="cpu")).run(0)

    trt.make_federated_mesh(device="cpu")   # a group exists
    other, first = run(1), run(0)
    assert not (tmp_path / "ck1").exists()
    assert sorted(os.listdir(tmp_path / "ck0")) == ["step_1.ckpt",
                                                    "step_3.ckpt"]
    tel = [r.provenance["telemetry"] for r in (other, first)]
    for key in ("checkpoint_saves", "checkpoint_bytes",
                "checkpoint_save_s.count"):
        assert tel[0][key] == tel[1][key], key
    assert tel[1]["checkpoint_bytes"] == sum(
        os.path.getsize(tmp_path / "ck0" / f) for f in os.listdir(
            tmp_path / "ck0"))
    assert other.history == first.history


def test_sharded_example_on_one_cpu_rank():
    """``repro_torch.examples.sharded`` on one rank: the local engine's
    bits, two gathers a round."""
    from repro_torch.examples.sharded import main
    rep = main(["--device", "cpu", "--spec", "tiny", "--rounds", "4"])
    assert rep["ranks"] == 1 and rep["ranks_equal"] and rep["clock_equal"]
    assert rep["W_err"] == 0 and set(rep["rel_vs_local"].values()) == {0.0}
    assert [list(g[:2]) for g in rep["gathers_per_round"]] == [
        [[5, 6], "torch.float32"], [[5, 18], "torch.float32"]]


# -- the grid and cohort paths ------------------------------------------------

def test_grid_fallback_runs_cells_through_the_sharded_round():
    """A lambda grid over two shuffles on the sharded engine: the ``grid``
    path naming ``sharded``; each cell's W and Omega are its single
    local-engine run's bits."""
    trains = [tiny_problem(m=4, n=20, d=6, seed=s, device="cpu")[0]
              for s in (0, 1)]
    regs = tuple(tc.MeanRegularized(lambda1=0.0, lambda2=lam)
                 for lam in (0.01, 0.1))
    method = dict(loss="hinge", rounds=6,
                  budget=tc.BudgetConfig(passes=1.0, drop_prob=0.2))
    rep = ta.Experiment(problem=ta.Problem(train=trains),
                        method=ta.Method(regularizers=regs, **method),
                        exec=ta.Exec(engine="sharded", device="cpu")).run(0)
    assert rep.provenance["path"] == "grid"
    assert "sharded" in rep.provenance["fallback_reason"]
    jplan = ja.route(ja.Experiment(
        problem=ja.Problem(train=[jax_tiny(m=4, n=20, d=6, seed=s)[0]
                                  for s in (0, 1)]),
        method=ja.Method(regularizers=tuple(
            jc.MeanRegularized(lambda1=0.0, lambda2=lam)
            for lam in (0.01, 0.1))),
        exec=ja.Exec(engine="sharded")))
    assert rep.provenance["fallback_reason"] == jplan.reason
    for ri, reg in enumerate(regs):
        for si, train in enumerate(trains):
            one = ta.Experiment(problem=ta.Problem(train=train),
                                method=ta.Method(regularizers=(reg,),
                                                 **method),
                                exec=ta.Exec(device="cpu")).run(0)
            np.testing.assert_array_equal(rep.result.W[ri, si], one.result.W)
            np.testing.assert_array_equal(rep.result.omega[ri, si],
                                          one.result.omega)


def test_cohort_inner_sharded_engine_equals_local():
    """The cohort shards its K-task cohort, never the population: on one
    rank the history and the factored state are the local engine's."""
    from repro_torch.cohort import Population, PopulationSpec
    pop = Population(PopulationSpec("t_obs", m=240, d=10, n_min=8,
                                    n_max=20, clusters=3), seed=0)

    def run(engine):
        exp = ta.Experiment(
            problem=ta.Problem(population=pop),
            method=ta.Method(regularizers=(tc.Probabilistic(
                lam=1e-2, sigma2=10.0),), rounds=6, omega_update_every=2,
                budget=tc.BudgetConfig(passes=1.0)),
            systems=ta.Systems(dropout=0.2),
            exec=ta.Exec(engine=engine, cohort=12, clusters=3,
                         device="cpu"))
        return exp.route(), exp.run(1)

    (lplan, loc), (splan, sh) = run("local"), run("sharded")
    assert (splan.path, splan.driver, splan.engine) == ("cohort", "loop",
                                                        "sharded")
    assert lplan.driver == "scan"
    assert loc.history == sh.history
    for k in ("centroids", "omega_k", "assign", "participation"):
        np.testing.assert_array_equal(getattr(sh.result, k),
                                      getattr(loc.result, k))


# -- the sweep's device rule -------------------------------------------------

@pytest.mark.parametrize("n_regs,n_shuffles,n_devices", [
    (9, 10, 1), (9, 10, 4), (9, 10, 3), (3, 2, 2), (2, 2, 4), (5, 7, 4),
    (8, 4, 8), (6, 4, 4), (1, 10, 8)])
def test_shard_grid_rule_matches_jax(n_regs, n_shuffles, n_devices,
                                     monkeypatch):
    """JAX's ``_shard_grid`` read with stand-ins for ``jax.devices()`` and
    the shardings: which axis it splits over how many devices."""
    from repro.core import sweep as jsweep
    from repro_torch.core.sweep import _shard_grid
    devs = [object() for _ in range(n_devices)]
    seen = {}

    class Mesh:
        def __init__(self, devices, names):
            seen["k"] = len(devices)

    def named(mesh, spec):
        return "split" if tuple(spec) == ("cells",) else "replicate"

    monkeypatch.setattr(jax, "devices", lambda: devs)
    monkeypatch.setattr(jax.sharding, "Mesh", Mesh)
    monkeypatch.setattr(jax.sharding, "NamedSharding", named)
    monkeypatch.setattr(jax, "device_put", lambda x, s: s)
    data, params, keys = jsweep._shard_grid("data", "params", "keys",
                                            n_regs, n_shuffles)
    if data == "data":
        want = (None, 1)
    else:
        want = ("shuffles" if data == "split" else "regs", seen["k"])
    assert _shard_grid(n_regs, n_shuffles, n_devices) == want
