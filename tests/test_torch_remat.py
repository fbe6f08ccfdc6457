"""Remat in the port's train step, on the CPU: ``cfg.remat`` block
checkpoints (``Model.forward(train=True)``, ``pjit_utils.checkpoint``),
rwkv6's wkv chunk checkpoint, and MoE's expert products without a G-fold
copy of the expert stack.

The JAX package wraps each block in ``jax.checkpoint`` where ``cfg.remat
and train`` (zamba2's whole periods under ``scan_layers``) and checkpoints
the wkv chunk body whatever ``remat`` says; its values are the same with
or without, and so are the port's.  Cases, reduced configs:
  * one device, f32 and bf16 (bf16 with f32 masters), dense (smollm), MoE
    (granite-moe), rwkv6, zamba2 on its loop path and on its period path
    (``scan_layers``, one period and a tail block): loss, ce, grad_norm
    and every gradient leaf with ``remat`` equal to those of
    ``dataclasses.replace(cfg, remat=False)`` bit for bit (the recompute
    runs the forward's operations on the same values, and the backward's
    graph is the same);
  * what the forward leaves alive for the backward (every storage an
    operation made in it that is still referenced after it, the model's
    parameters left out): with remat it grows by one (B, S, D) block input
    per checkpointed call, within 5% (a layer; zamba2's loop path: 7 a
    period, its six mamba blocks and its shared call; its period path: 1
    a period); without remat by at least ten times as much;
  * the wkv scan alone: no (B, H, q, q, N) pairwise-decay tensor left alive
    after its forward (with the chunk body run plainly, every chunk's
    are), gradients equal to the plain body's bit for bit;
  * the recompute on another thread: on the card autograd runs the
    backward of CUDA tensors on its own device thread, where the mesh
    context (a ``ContextVar``) is unset.  MoE under a 2 x 2 stand-in
    context (4 routing groups, as ``test_torch_moe_groups.py`` runs it)
    with its backward run on a new thread: gradients equal to the step
    without remat bit for bit; without the context captured the recompute
    routes in one group, and ``checkpoint``'s check of the recomputed
    shapes raises;
  * MoE's expert products at G 4 groups: no operation, forward or
    backward, makes a tensor holding two or more copies of an expert stack
    (``@`` broadcast the (E, D, F) stack over G, a copy of G stacks, and
    formed its gradient as G stacks too);
  * four gloo ranks on a 2 x 2 mesh (``test_torch_mesh_step._spawn``): the
    same four families, f32 and bf16, batch over ``('data', 'model')``
    (MoE's 4 groups) and over ``('data',)`` (weights over ``model``): the
    gradients with remat equal to those without bit for bit on every
    rank's shards, the loss too; MoE's backward once more on a new thread;
    and on a warm step no rank's own operation (DTensor's local work) makes
    a tensor of two or more of MoE's expert stacks (at the parent, each
    rank expanded the replicated stack to the global G).
"""
import dataclasses
import gc
import threading

import numpy as np
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import moe as MOE
from repro_torch.models import rwkv6 as R6
from repro_torch.models.transformer import Model
from repro_torch.train.loop import TrainConfig, init_train_state, make_grad_fn
from repro_torch.train.losses import next_token_loss
from repro_torch.utils import pjit_utils as pj
from test_torch_mesh_step import _spawn

B, S = 2, 128
#: name -> (arch, config changes, (depth a, depth b), checkpointed calls
#: the second depth adds)
CASES = {
    "smollm-360m": ("smollm-360m", {}, (2, 3), 1),
    "granite-moe-1b-a400m": ("granite-moe-1b-a400m", {}, (2, 3), 1),
    "rwkv6-7b": ("rwkv6-7b", {}, (2, 3), 1),
    "zamba2-7b": ("zamba2-7b", {}, (6, 12), 7),
    "zamba2-7b-scan": ("zamba2-7b", dict(scan_layers=True), (6, 12), 1),
}
DTYPES = (torch.float32, torch.bfloat16)


def _config(name, **kw):
    arch, changes, _, _ = CASES[name]
    return dataclasses.replace(get_config(arch).reduced(), **changes, **kw)


def _tokens(cfg, b=B, s=S, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s),
                                         dtype=np.int64).astype(np.int32))


def _grads(cfg, dtype):
    model = Model(cfg, device="cpu", seed=0)
    tc = TrainConfig(compute_dtype=dtype,
                     master_weights=dtype != torch.float32)
    params, _ = init_train_state(model, tc)
    grads, metrics = make_grad_fn(model, tc)(params,
                                             {"tokens": _tokens(cfg)})
    return tree_leaves(grads), metrics


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(CASES))
def test_gradients_with_remat_equal_without(name, dtype):
    """One device: the step with remat against the step without, bit for
    bit (zamba2-7b-scan: one period and a tail block)."""
    cfg = (_config(name, n_layers=7) if name == "zamba2-7b-scan"
           else _config(name))
    assert cfg.remat
    g1, m1 = _grads(cfg, dtype)
    g0, m0 = _grads(dataclasses.replace(cfg, remat=False), dtype)
    for k in ("loss", "ce", "grad_norm"):
        assert torch.equal(m1[k], m0[k]), k
    assert len(g1) == len(g0)
    for a, b in zip(g1, g0):
        assert torch.equal(a, b)


class _Kept(TorchDispatchMode):
    """Every storage an operation makes inside, held weakly (the storages
    of ``skip``'s tensors left out); ``alive()``: the bytes of each still
    referenced."""

    def __init__(self, skip=()):
        super().__init__()
        self.skip = {t.untyped_storage()._cdata for t in skip}
        self.refs = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if torch.is_tensor(t):
                st = t.untyped_storage()
                if st._cdata not in self.skip:
                    self.refs.setdefault(st._cdata, (StorageWeakRef(st),
                                                     st.nbytes()))
        return out

    def alive(self):
        gc.collect()
        return [n for ref, n in self.refs.values() if not ref.expired()]


def _kept_bytes(cfg, dtype=torch.float32):
    """Bytes the training forward leaves alive for the backward."""
    model = Model(cfg, device="cpu", seed=0)
    for p in model.parameters():
        p.requires_grad_(True)
    with _Kept(model.parameters()) as kept:
        out = model.forward(model.tree(), {"tokens": _tokens(cfg)},
                            dtype=dtype, train=True)
    total = sum(kept.alive())
    del out
    return total


@pytest.mark.parametrize("name", list(CASES))
def test_remat_keeps_one_block_input_a_call(name):
    _, _, (da, db), calls = CASES[name]
    block = B * S * _config(name).d_model * 4
    grown = {}
    for remat in (True, False):
        a, b = (_kept_bytes(_config(name, n_layers=d, remat=remat))
                for d in (da, db))
        grown[remat] = b - a
    assert calls * block <= grown[True] <= 1.05 * calls * block, grown
    assert grown[False] >= 10 * grown[True], grown


def test_remat_keeps_one_block_input_a_layer_in_bf16():
    cfg = _config("smollm-360m")
    a, b = (_kept_bytes(dataclasses.replace(cfg, n_layers=d), torch.bfloat16)
            for d in (2, 3))
    assert b - a == B * S * cfg.d_model * 2


def _wkv_inputs(seed=3):
    rng = np.random.default_rng(seed)
    b, s, h, n = 1, 256, 4, 32
    r, k, v = (torch.tensor(0.3 * rng.standard_normal((b, s, h, n)),
                            dtype=torch.float32, requires_grad=True)
               for _ in range(3))
    w = torch.tensor(rng.uniform(0.5, 0.99, (b, s, h, n)),
                     dtype=torch.float32, requires_grad=True)
    u = torch.tensor(0.1 * rng.standard_normal((h, n)), dtype=torch.float32,
                     requires_grad=True)
    state = torch.zeros((b, h, n, n), requires_grad=True)
    return r, k, v, w, u, state


def _wkv_run(monkeypatch, plain: bool):
    """(largest storage alive after the forward, gradients)."""
    if plain:
        monkeypatch.setattr(pj, "checkpoint", lambda fn, *a: fn(*a))
    leaves = _wkv_inputs()
    with _Kept() as kept:
        y, st = R6._wkv_chunked(*leaves, R6.WKV_CHUNK)
    largest = max(kept.alive())
    loss = (y * torch.linspace(-1, 1, y.shape[-1])).sum() + st.square().sum()
    grads = torch.autograd.grad(loss, leaves)
    monkeypatch.undo()
    return largest, grads


def test_wkv_chunk_body_is_recomputed(monkeypatch):
    b, s, h, n = _wkv_inputs()[0].shape
    pairwise = b * R6.WKV_CHUNK ** 2 * h * n * 4
    largest, grads = _wkv_run(monkeypatch, plain=False)
    plain_largest, plain_grads = _wkv_run(monkeypatch, plain=True)
    assert plain_largest >= pairwise
    assert largest < pairwise
    for a, p in zip(grads, plain_grads):
        assert torch.equal(a, p)


def _moe_context():
    return pj.activation_sharding(make_test_mesh(2, 2), ("data", "model"))


def test_recompute_sees_the_mesh_context_on_another_thread():
    """MoE in 4 groups: the forward under the context here, the backward
    on a new thread (where the context is unset), as autograd's device
    thread runs it on the card."""
    cfg = _config("granite-moe-1b-a400m")
    batch = {"tokens": _tokens(cfg, b=4, s=64)}
    tc = TrainConfig()

    def step(remat, threaded):
        model = Model(dataclasses.replace(cfg, remat=remat), device="cpu",
                      seed=0)
        params, _ = init_train_state(model, tc)
        leaves = tree_leaves(params)
        with _moe_context():
            assert MOE.groups_for(4 * 64, cfg.n_experts) == 4
            logits, aux = model.forward(params, batch)
            loss, _ = next_token_loss(cfg, logits, batch, aux)
            if not threaded:
                return torch.autograd.grad(loss, leaves)
        got = {}

        def backward():
            try:
                got["grads"] = torch.autograd.grad(loss, leaves)
            except Exception as e:      # re-raised on the test's thread
                got["error"] = e

        t = threading.Thread(target=backward)
        t.start()
        t.join(timeout=120)
        assert not t.is_alive()
        if "error" in got:
            raise got["error"]
        return got["grads"]

    want = step(remat=False, threaded=False)
    got = step(remat=True, threaded=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


class _Shapes(TorchDispatchMode):
    """The storage bytes of every operation's outputs inside."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.seen += [(str(func), tuple(t.shape), t.untyped_storage().nbytes())
                      for t in tree_leaves(out) if torch.is_tensor(t)]
        return out


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "mixtral-8x7b"])
def test_expert_products_make_no_copy_of_the_stack(arch):
    cfg = get_config(arch).reduced()
    gen = torch.Generator().manual_seed(1)
    params = {k: v.requires_grad_(True)
              for k, v in MOE.moe_init(gen, cfg).items()}
    x = (0.5 * torch.randn((4, 64, cfg.d_model), generator=gen)
         ).requires_grad_(True)
    stack = params["w_gate"].numel() * 4
    with _moe_context(), _Shapes() as ops:
        assert MOE.groups_for(4 * 64, cfg.n_experts) == 4
        y, aux = MOE.moe_apply(params, x, cfg)
        (y.square().sum() + aux["moe_lb"]).backward()
    big = [op for op in ops.seen if op[2] >= 2 * stack]
    assert not big, big
    assert all(p.grad is not None for p in params.values())


# -- four gloo ranks ---------------------------------------------------------

_RANK = r'''
import contextlib, dataclasses, json, sys, threading
from datetime import timedelta
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(store, 4), rank=rank,
                        world_size=4, timeout=timedelta(seconds=60))
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from repro_torch.configs import get_config
from repro_torch.launch import mesh as M, sharding as sh, specs
from repro_torch.models.transformer import Model
from repro_torch.train.loop import (TrainConfig, _cast_weights,
                                    init_train_state, make_grad_fn)
from repro_torch.train.losses import next_token_loss
from repro_torch.utils.dist import gloo_collectives
from repro_torch.utils.pjit_utils import activation_sharding

CASES = {"smollm-360m": ("smollm-360m", {}),
         "granite-moe-1b-a400m": ("granite-moe-1b-a400m", {}),
         "rwkv6-7b": ("rwkv6-7b", {}),
         "zamba2-7b": ("zamba2-7b", dict(shared_attn_period=2, n_layers=5))}
SEQ = {"rwkv6-7b": 128}
mesh = M.make_test_mesh(2, 2)
dm = M.device_mesh(mesh, device="cpu")


class Local(TorchDispatchMode):
    """The largest storage a rank's own operation makes (DTensor's local
    work: a DTensor operation is passed on to DTensor, and DTensor's shape
    propagation on FakeTensors is left out)."""
    def __init__(self):
        super().__init__()
        self.largest = [0, ""]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if torch.is_tensor(t) and not isinstance(t, FakeTensor):
                self.largest = max(self.largest, [
                    t.untyped_storage().nbytes(), str(func)])
        return out


def config(name, remat):
    arch, kw = CASES[name]
    return dataclasses.replace(get_config(arch).reduced(), scan_layers=True,
                               remat=remat, **kw)


def run(name, b, dtype, remat, threaded=False, local=None):
    """(every gradient's local shard in its parameter's placements, the
    loss, the batch axes).  ``local``: a ``Local`` around a warm call;
    ``threaded``: the backward on a new thread, outside the context."""
    cfg = config(name, remat)
    rng = np.random.default_rng(b)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (b, SEQ.get(name, 32)),
        dtype=np.int64).astype(np.int32))}
    tc = TrainConfig(compute_dtype=dtype,
                     master_weights=dtype != torch.float32)
    axes = sh.pick_batch_axes(mesh, b, allow_model=True)
    p_sh = specs.build_case_from_cfg(cfg, "train_4k", mesh,
                                     compute_dtype=dtype)["in_specs"][0]
    model = Model(cfg, device="cpu", seed=0)
    init_train_state(model, tc)
    model.load_tree(sh.distribute(model.tree(), p_sh, mesh, dm))
    params = model.tree()
    leaves = tree_leaves(params)
    dbatch = sh.distribute(batch, sh.batch_shardings(batch, mesh, axes),
                           mesh, dm)
    grad_fn = make_grad_fn(model, tc, param_specs=p_sh)
    with activation_sharding(mesh, axes, dm):
        if not threaded:
            if local is not None:
                grad_fn(params, dbatch)
            with local or contextlib.nullcontext():
                grads, metrics = grad_fn(params, dbatch)
            return ([g.to_local() for g in tree_leaves(grads)],
                    float(metrics["loss"]), list(axes))
        logits, aux = model.forward(_cast_weights(params, dtype, p_sh),
                                    dbatch, dtype=dtype)
        loss, _ = next_token_loss(cfg, logits, dbatch, aux)
    got = {}

    def backward():
        try:
            got["grads"] = torch.autograd.grad(loss, leaves)
        except Exception as e:
            got["error"] = repr(e)

    t = threading.Thread(target=backward)
    t.start()
    t.join(timeout=120)
    if "error" in got or t.is_alive():
        raise RuntimeError(got.get("error", "the backward did not end"))
    return ([g.redistribute(p.device_mesh, p.placements).to_local()
             for g, p in zip(got["grads"], leaves)],
            float(loss.full_tensor()), list(axes))


def same(a, b):
    return [bool(torch.equal(x, y)) for x, y in zip(a, b)]


results = {}
with gloo_collectives():
    for name in sys.argv[4].split(","):
        moe = config(name, True).is_moe
        for b in (4, 2):
            for dtype in (torch.float32, torch.bfloat16):
                local = Local() if moe else None
                g1, l1, axes = run(name, b, dtype, True, local=local)
                g0, l0, _ = run(name, b, dtype, False)
                res = dict(axes=axes, loss=[l1, l0], equal=same(g1, g0))
                if moe:
                    cfg = config(name, True)
                    res["stack_bytes"] = (cfg.n_experts * cfg.d_model
                                          * cfg.d_ff * dtype.itemsize)
                    res["largest"] = local.largest
                    gt, lt, _ = run(name, b, dtype, True, threaded=True)
                    res["threaded"] = dict(loss=lt, equal=same(gt, g0))
                results[f"{name}/b{b}/{str(dtype)[6:]}"] = res
if rank == 0:
    with open(out, "w") as f:
        json.dump(results, f)
dist.destroy_process_group()
'''


MESH_ARCHS = ("smollm-360m", "granite-moe-1b-a400m", "rwkv6-7b", "zamba2-7b")


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("remat"), MESH_ARCHS,
                  script=_RANK)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [4, 2])
@pytest.mark.parametrize("arch", MESH_ARCHS)
def test_mesh_gradients_with_remat_equal_without(mesh_runs, arch, batch,
                                                 dtype):
    r = mesh_runs[f"{arch}/b{batch}/{dtype}"]
    assert r["axes"] == (["data", "model"] if batch == 4 else ["data"])
    assert r["loss"][0] == r["loss"][1]
    assert r["equal"] and all(r["equal"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [4, 2])
def test_mesh_moe_recompute_on_another_thread(mesh_runs, batch, dtype):
    r = mesh_runs[f"granite-moe-1b-a400m/b{batch}/{dtype}"]
    assert r["threaded"]["loss"] == r["loss"][1]
    assert all(r["threaded"]["equal"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("batch", [4, 2])
def test_mesh_expert_products_make_no_copy_of_the_stack(mesh_runs, batch,
                                                        dtype):
    r = mesh_runs[f"granite-moe-1b-a400m/b{batch}/{dtype}"]
    assert r["largest"][0] < 2 * r["stack_bytes"], r["largest"]
