"""Mesh-aware activation sharding constraints: the JAX package's
``utils/pjit_utils.py`` on ``torch.distributed.tensor``.

Model code calls ``constrain(x, BATCH, None, 'model')`` unconditionally;
the constraint applies only to a DTensor inside an ``activation_sharding``
context (entered by whoever runs a step on a mesh).  The context carries
the *batch axes* chosen for the case (full-FSDP ``('data','model')`` for
train_4k on one pod, ``('pod','data')`` multi-pod): the BATCH sentinel
resolves to exactly those axes, and any named axis already consumed is
dropped from later dims (an axis may appear only once in a spec).  Where
JAX's ``with_sharding_constraint`` asks the compiler for a layout, the
port redistributes the DTensor to it, eagerly.  The single-device path
never enters the context and holds no DTensor, so constraints return their
argument itself there.

``local`` runs a function on each rank's local shards (``local_map``): the
model's attention core, its RoPE, its masked embedding lookup, its cache
writes, MoE's routing, the wkv and SSD scans and the causal conv, which
DTensor's own operators do not cover.

``checkpoint`` recomputes a function in the backward (the blocks under
``cfg.remat``, the wkv chunks) inside the context it was called in.
"""
from __future__ import annotations

import contextlib
from contextvars import ContextVar
from typing import Callable, Mapping, Optional, Sequence, Tuple, Union

import torch

from repro_torch.launch.mesh import MeshSpec
from repro_torch.launch.sharding import Spec, placements


class _BatchSentinel:
    def __repr__(self):
        return "BATCH"


#: placeholder resolved to the context's batch axes
BATCH = _BatchSentinel()

AxisName = Union[str, Sequence[str], None, _BatchSentinel]

# (mesh, batch axes, batch shard product, device mesh or None)
_CTX: ContextVar[Optional[tuple]] = ContextVar("repro_torch_mesh_ctx",
                                               default=None)


@contextlib.contextmanager
def activation_sharding(mesh: MeshSpec, batch_axes: Sequence[str],
                        device_mesh=None):
    """Enable activation constraints on ``mesh`` (a ``launch.mesh.MeshSpec``)
    with the chosen batch axes; ``device_mesh`` is the ``DeviceMesh`` built
    from it (``launch.mesh.device_mesh``), or None where only the
    resolution is asked for (``resolve_spec``'s callers)."""
    sizes = mesh.axis_sizes
    batch = tuple(a for a in batch_axes if a in sizes)
    prod = 1
    for a in batch:
        prod *= sizes[a]
    token = _CTX.set((mesh, batch, prod, device_mesh))
    try:
        yield
    finally:
        _CTX.reset(token)


def checkpoint(fn: Callable, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant): what
    it saves for the backward is dropped after the forward and recomputed
    when the backward first needs it, as the JAX package's
    ``jax.checkpoint``.  The recompute runs inside the backward, on the
    card on autograd's own device thread, where this module's context
    variable is unset: the context of the call is captured here and set
    again around the recompute, so that ``constrain`` pins and MoE's
    ``batch_shard_count`` resolve as they did in the forward.  The blocks
    draw no random numbers, so no RNG state is stashed; the recompute's
    tensors are checked against the forward's (shapes, dtypes, devices)."""
    from torch.utils.checkpoint import checkpoint as torch_checkpoint
    ctx = _CTX.get()

    def run(*a):
        token = _CTX.set(ctx)
        try:
            return fn(*a)
        finally:
            _CTX.reset(token)

    return torch_checkpoint(run, *args, use_reentrant=False,
                            preserve_rng_state=False)


def current_batch_axes() -> Optional[Tuple[str, ...]]:
    ctx = _CTX.get()
    return ctx[1] if ctx else None


def batch_shard_count() -> int:
    """Number of batch-parallel shards (GShard 'groups' for MoE routing);
    1 outside a mesh context."""
    ctx = _CTX.get()
    return ctx[2] if ctx else 1


def resolve_spec(shape: Sequence[int], spec: Sequence[AxisName],
                 axis_names: Sequence[str], sizes: Mapping[str, int],
                 batch_axes: Sequence[str]) -> Spec:
    """The spec ``constrain`` pins a tensor of ``shape`` to, one entry per
    dim of ``spec`` (None, or the tuple of axes the dim is split over,
    outermost first): BATCH stands for ``batch_axes``, an axis already used
    is dropped from later dims, and only the prefix of a dim's candidate
    axes whose product divides the dim is kept."""
    axes = frozenset(axis_names)
    batch = tuple(a for a in batch_axes if a in axes)
    used: set = set()
    resolved = []
    for dim, s in enumerate(spec):
        size = shape[dim]
        if s is None:
            resolved.append(None)
            continue
        if isinstance(s, _BatchSentinel):
            cands = tuple(a for a in batch if a not in used)
        elif isinstance(s, str):
            cands = (s,) if s in axes and s not in used else ()
        else:
            cands = tuple(a for a in s if a in axes and a not in used)
        keep = []
        prod = 1
        for a in cands:
            if size % (prod * sizes[a]) == 0:
                keep.append(a)
                prod *= sizes[a]
        used.update(keep)
        resolved.append(tuple(keep) if keep else None)
    return tuple(resolved)


def on_mesh(x) -> bool:
    """Whether ``x`` is a DTensor (a tensor placed on a mesh)."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def spec_placements(shape: Sequence[int], *spec: AxisName) -> tuple:
    """The placements ``constrain`` gives a tensor of ``shape`` under
    ``spec`` in the current context (which must be entered)."""
    mesh, batch = _CTX.get()[:2]
    full = tuple(spec) + (None,) * (len(shape) - len(spec))
    return placements(resolve_spec(tuple(shape), full, mesh.axis_names,
                                   mesh.axis_sizes, batch), mesh)


def constrain(x: torch.Tensor, *spec: AxisName) -> torch.Tensor:
    """``x`` redistributed to ``spec`` as ``resolve_spec`` resolves it on
    the context's mesh; ``x`` itself outside a context or for a plain
    tensor.  Trailing dims ``spec`` leaves out are not sharded."""
    ctx = _CTX.get()
    if ctx is None or not on_mesh(x):
        return x
    device_mesh = ctx[3]
    dm = device_mesh if device_mesh is not None else x.device_mesh
    return x.redistribute(dm, spec_placements(x.shape, *spec))


# ---------------------------------------------------------------------------
# local shards
# ---------------------------------------------------------------------------

def mesh_spec(device_mesh) -> MeshSpec:
    """The ``MeshSpec`` of a ``DeviceMesh`` built by ``device_mesh``."""
    return MeshSpec(tuple(device_mesh.mesh_dim_names),
                    tuple(device_mesh.mesh.shape))


def shard_index(x, dim: int) -> Tuple[int, int]:
    """(this rank's index, count) of the slices of dim ``dim`` that the
    DTensor ``x`` splits over its mesh, outermost mesh dim first."""
    from torch.distributed.tensor import Shard
    coord = x.device_mesh.get_coordinate()
    r, n = 0, 1
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            size = x.device_mesh.size(i)
            r, n = r * size + coord[i], n * size
    return r, n


def replicate(x: torch.Tensor, device_mesh) -> torch.Tensor:
    """A tensor every rank holds whole, as a replicated DTensor (no
    communication: each rank must hold the same values)."""
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(x, device_mesh,
                              [Replicate()] * device_mesh.ndim,
                              run_check=False)


def local(fn: Callable, out_placements, *args):
    """``fn`` on each rank's local shards of ``args`` (DTensors, or other
    values passed as they are), through ``local_map``; its outputs become
    DTensors of ``out_placements`` (one placements tuple, or a tuple of them
    for a tuple of outputs; None for a function that returns nothing and
    writes into its arguments' shards).  The inputs' gradients flow back in their own
    placements, but Partial on each mesh dim where an input is replicated
    and the first output is not: there each rank's computation reads the
    input for its own slice of the output, so each holds a part of the
    gradient (a function with several outputs to differentiate through
    needs them all in the first one's layout)."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    first = outs = out_placements
    if out_placements is not None:
        if isinstance(out_placements[0], (tuple, list)):
            first = out_placements[0]
            outs = tuple(list(p) for p in out_placements)
        else:    # local_map reads a list as one output's placements
            outs = list(out_placements)
    mesh = next(a.device_mesh for a in args if on_mesh(a))
    ins, grads = [], []
    for a in args:
        if not on_mesh(a):
            ins.append(None)
            grads.append(None)
            continue
        ins.append(tuple(a.placements))
        grads.append(tuple(
            Partial() if first is not None and isinstance(p, Replicate)
            and not isinstance(o, Replicate) else p
            for p, o in zip(a.placements, first or a.placements)))
    return local_map(fn, out_placements=outs,
                     in_placements=tuple(ins),
                     in_grad_placements=tuple(grads),
                     device_mesh=mesh)(*args)


def whole(x: torch.Tensor) -> torch.Tensor:
    """A DTensor replicated on every mesh dim (partial sums reduced); a
    plain tensor as it is."""
    if not on_mesh(x):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)


def align(v: torch.Tensor, dim: int, ref: torch.Tensor,
          ref_dim: int) -> torch.Tensor:
    """The DTensor ``v`` with its dim ``dim`` split over the mesh dims that
    split ``ref``'s dim ``ref_dim`` and whole on the others: a per-head
    parameter (or a per-channel one, split at head boundaries) beside the
    heads of an activation, for ``local``."""
    from torch.distributed.tensor import Replicate, Shard
    return v.redistribute(v.device_mesh, tuple(
        Shard(dim) if isinstance(p, Shard) and p.dim == ref_dim
        else Replicate() for p in ref.placements))


def like(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """``new`` in ``old``'s placements where both are DTensors (a state
    kept where its plan puts it: a slice of what each rank holds, or a
    no-op), else ``new`` itself."""
    if on_mesh(new) and on_mesh(old):
        return new.redistribute(old.device_mesh, old.placements)
    return new


def pin_grad(x: torch.Tensor) -> torch.Tensor:
    """The DTensor ``x`` as it is, with its gradient brought back to ``x``'s
    placements in the backward pass, whatever layout the ops after it
    chose: the reshape that made ``x`` then undoes on the layout it made
    (a split of H * hd that H does not divide cannot be viewed as heads).
    A plain tensor as it is."""
    if not on_mesh(x):
        return x
    return local(lambda t: t, x.placements, x)
