"""Sharding resolver: params / optimizer / batch / cache -> specs.

The JAX package's ``launch/sharding.py``, with its policy (2-D "FSDP x
tensor" with divisibility fallback, DESIGN.md §5):
  * every tensor with >= 2 non-stacked dims shards its largest dim divisible
    by |model| on the ``model`` axis and the largest remaining dim divisible
    by |data| on the ``data`` axis; anything else replicates;
  * leading *stacking* axes (scan-over-layers / zamba period grouping /
    per-application caches) are never sharded;
  * vectors / scalars replicate;
  * batch arrays shard their leading dim over ('pod','data') when divisible;
  * KV caches shard batch over data and the *sequence* axis over model;
  * optimizer state inherits parameter specs leaf-by-leaf;
  * the ``pod`` axis is pure data parallelism: parameters replicate across
    pods.

A spec is a tuple with one entry per dim: an axis name, a tuple of two or
more names (the dim split over several axes, the first outermost) or
``None``, as ``jax.sharding.PartitionSpec`` normalises its entries.

The port's trees hold one entry per layer (``blocks`` is a list), where
the JAX package's hold each block leaf stacked: on a leading layer axis,
on (periods, period) for zamba2's grouped mamba blocks with the leftover
layers in ``tail_blocks``, and per shared-attention call for the hybrid's
caches.  The policy reads the stacked rank (a per-layer vector is a
stacked matrix there, and shards over ``model``), so each per-layer leaf's
spec is the spec of the stacked leaf JAX would hold, with the stack
entries dropped.  ``shared_proj`` is stacked in both packages.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import MeshSpec, data_axes

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]


def _n_stack_dims(path: str, cfg: ArchConfig) -> int:
    """Leading axes that scan slices (never shard them)."""
    if "tail_blocks" in path:
        return 1
    if "blocks" in path:
        # zamba grouped stacks are (periods, period, ...)
        if cfg.shared_attn_period and cfg.scan_layers:
            return 2
        return 1 if cfg.scan_layers else 0
    if "shared_proj" in path:
        return 1
    return 0


def param_spec(path: str, shape: Tuple[int, ...], cfg: ArchConfig,
               data: int, model: int, use_data: bool = True) -> Spec:
    skip = _n_stack_dims(path, cfg)
    dims = list(range(skip, len(shape)))
    assign: Dict[int, Optional[str]] = {}
    # largest divisible dim -> model
    for d in sorted(dims, key=lambda d: -shape[d]):
        if shape[d] % model == 0 and shape[d] >= model:
            assign[d] = "model"
            dims.remove(d)
            break
    if use_data:
        for d in sorted(dims, key=lambda d: -shape[d]):
            if shape[d] % data == 0 and shape[d] >= data:
                assign[d] = "data"
                break
    spec = [assign.get(i) for i in range(len(shape))]
    # vectors / tiny tensors: replicate
    if len(shape) <= 1:
        spec = [None] * len(shape)
    return tuple(spec)


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def map_with_path(fn, tree, path: Tuple = ()):
    """``fn(path, leaf)`` over a tree of dicts and lists; ``None`` stays
    ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def leaves_with_specs(tree, specs, path: str = ""
                      ) -> Iterator[Tuple[str, torch.Tensor, Spec]]:
    """(path, leaf, spec) for every tensor leaf of ``tree`` beside its spec
    in ``specs`` (a tree of the same structure)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves_with_specs(v, specs[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        names = getattr(tree, "_fields", range(len(tree)))
        for k, v, s in zip(names, tree, specs):
            yield from leaves_with_specs(v, s, f"{path}/{k}")
    elif torch.is_tensor(tree):
        yield path.lstrip("/"), tree, specs


def jax_stacking(cfg: ArchConfig, path: Tuple, cache: bool
              ) -> Tuple[str, Tuple[int, ...]]:
    """(the JAX package's path, the stack axes it prepends) of the port's
    per-layer leaf at ``path`` of a parameter (or cache) tree."""
    names = [str(k) for k in path]
    if not cfg.scan_layers or names[0] != "blocks":
        return "/".join(names), ()
    period = cfg.shared_attn_period
    if not period:                                # blocks/<i>/...
        return "/".join(["blocks"] + names[2:]), (cfg.n_layers,)
    n_periods = cfg.n_layers // period
    n_scan = n_periods * period
    if cache and names[1] == "shared":            # blocks/shared/<j>/...
        return "/".join(["blocks", "shared"] + names[3:]), (n_periods,)
    i, rest = (int(path[2]), names[3:]) if cache else (int(path[1]),
                                                       names[2:])
    if i < n_scan:
        head = ["blocks", "mamba"] if cache else ["blocks"]
        return "/".join(head + rest), (n_periods, period)
    head = ["blocks", "tail"] if cache else ["tail_blocks"]
    return "/".join(head + rest), (cfg.n_layers - n_scan,)


# ---------------------------------------------------------------------------
# the plan's specs
# ---------------------------------------------------------------------------

def params_shardings(params: Any, cfg: ArchConfig, mesh: MeshSpec,
                     mode: str = "train") -> Any:
    """The spec tree of a parameter tree of the port's layout (leaves:
    tensors, on ``meta`` for a plan).

    mode="train": 2-D FSDP x tensor sharding (optimizer state dominates).
    mode="serve": weight-stationary -- shard on ``model`` only, replicate
    over the data axes (inference holds no optimizer state).
    """
    axis = mesh.axis_sizes
    data, model = axis.get("data", 1), axis.get("model", 1)
    use_data = mode != "serve"

    def one(path, leaf):
        jax_path, stack = jax_stacking(cfg, path, cache=False)
        shape = stack + tuple(leaf.shape)
        if len(shape) <= 1:
            return (None,) * leaf.dim()
        spec = param_spec(jax_path, shape, cfg, data, model,
                          use_data=use_data)
        return spec[len(stack):]

    return map_with_path(one, params)


def opt_shardings(opt_state: Any, param_specs: Any) -> Any:
    """AdamWState(step, mu, nu, master): moments and masters mirror the
    parameter specs, step replicates."""
    from repro_torch.train.optimizer import AdamWState
    if not isinstance(opt_state, AdamWState):
        raise TypeError(type(opt_state))
    master = param_specs if opt_state.master is not None else None
    return AdamWState(step=(), mu=param_specs, nu=param_specs, master=master)


def pick_batch_axes(mesh: MeshSpec, global_batch: int,
                    allow_model: bool) -> Tuple[str, ...]:
    """Greedy batch-parallel axes: ('pod','data'[,'model']) while the product
    still divides the global batch. Including 'model' gives full-FSDP
    sharding (ZeRO-3) -- right for train_4k's 256-sample batch; serving
    shapes keep 'model' for tensor/sequence sharding."""
    axis = mesh.axis_sizes
    order = ["pod", "data"] + (["model"] if allow_model else [])
    chosen: list = []
    prod = 1
    for a in order:
        if a not in axis:
            continue
        if global_batch % (prod * axis[a]) == 0:
            chosen.append(a)
            prod *= axis[a]
    return tuple(chosen)


def batch_shardings(batch: Dict[str, Any], mesh: MeshSpec,
                    batch_axes: Optional[Tuple[str, ...]] = None
                    ) -> Dict[str, Spec]:
    dp = tuple(batch_axes) if batch_axes is not None else data_axes(mesh)
    axis = mesh.axis_sizes
    dp_size = math.prod(axis[a] for a in dp)

    def one(_, leaf):
        shape = tuple(leaf.shape)
        if (len(shape) >= 1 and dp and shape[0] % dp_size == 0
                and shape[0] >= dp_size):
            return (_entry(dp),) + (None,) * (len(shape) - 1)
        return (None,) * len(shape)

    return map_with_path(one, batch)


def cache_shardings(cache: Any, cfg: ArchConfig, mesh: MeshSpec) -> Any:
    """KV caches: (B, T, Hkv, hd) -> (data, model, None, None); ring buffers
    and zamba per-application stacks keep their stacking dim replicated;
    SSM states: (B, H, ...) -> (data, model, ...).  Computed on the JAX
    package's stacked leaf (offset 1 for stacked attention and tail caches,
    2 for zamba2's grouped mamba states), the stack entries then dropped."""
    axis = mesh.axis_sizes
    model = axis.get("model", 1)
    dp = data_axes(mesh)
    dp_size = math.prod(axis[a] for a in dp)

    def one(path, leaf):
        jax_path, stack = jax_stacking(cfg, path, cache=True)
        shape = stack + tuple(leaf.shape)
        spec: list = [None] * len(shape)
        # stacked layer dim(s) first (scan-over-layers / shared apps)
        offset = 0
        if "blocks" in jax_path and cfg.scan_layers:
            offset = 2 if (cfg.shared_attn_period
                           and "mamba" in jax_path) else 1
        if offset != len(stack):
            raise AssertionError(f"{jax_path}: offset {offset}, stack "
                                 f"{stack}")
        if len(shape) > offset:
            # batch dim
            if shape[offset] % dp_size == 0 and shape[offset] >= dp_size:
                spec[offset] = _entry(dp)
            # next dim: sequence (attn cache) or heads (ssm states)
            if len(shape) > offset + 1:
                d = offset + 1
                if shape[d] % model == 0 and shape[d] >= model:
                    spec[d] = "model"
        return tuple(spec[offset:])

    return map_with_path(one, cache)


def replicated(ndim: int = 0) -> Spec:
    return (None,) * ndim


# ---------------------------------------------------------------------------
# what one device holds
# ---------------------------------------------------------------------------

def _entry(axes: Tuple[str, ...]) -> Entry:
    """An entry over ``axes``, as a ``PartitionSpec`` normalises it."""
    return (axes[0] if len(axes) == 1 else tuple(axes)) if axes else None


def _axes(entry: Entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shape(shape, spec: Spec, mesh: MeshSpec) -> Tuple[int, ...]:
    """The shard of a ``shape`` tensor that one device of ``mesh`` holds
    under ``spec`` (every device holds one of this shape: the policy
    shards only dims that divide)."""
    shape = tuple(shape)
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} for shape {shape}")
    sizes = mesh.axis_sizes
    out = []
    for n, entry in zip(shape, spec):
        k = math.prod(sizes[a] for a in _axes(entry))
        if n % k:
            raise ValueError(f"dim {n} of {shape} does not divide over "
                             f"{entry} ({k})")
        out.append(n // k)
    return tuple(out)


def shard_bytes(tree, specs, mesh: MeshSpec) -> int:
    """Bytes of ``tree``'s shards on one device of ``mesh``."""
    return sum(math.prod(local_shape(t.shape, s, mesh)) * t.element_size()
               for _, t, s in leaves_with_specs(tree, specs))


def placements(spec: Spec, mesh: MeshSpec) -> tuple:
    """``spec`` as ``torch.distributed.tensor`` placements, one per mesh
    dim: ``Shard(d)`` on each axis that dim ``d`` is split over,
    ``Replicate()`` elsewhere.  A dim over several axes is split over them
    in mesh order, outermost first, as the JAX package splits it."""
    from torch.distributed.tensor import Replicate, Shard
    out: List[Any] = [Replicate()] * len(mesh.axis_names)
    for d, entry in enumerate(spec):
        idx = [mesh.axis_names.index(a) for a in _axes(entry)]
        if idx != sorted(idx) or any(isinstance(out[i], Shard) for i in idx):
            raise ValueError(f"spec {spec} against mesh axes "
                             f"{mesh.axis_names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def distribute(tree, specs, mesh: MeshSpec, device_mesh):
    """``tree`` with every tensor leaf a DTensor on ``device_mesh`` (built
    from ``mesh`` by ``launch.mesh.device_mesh``), placed by its spec in
    ``specs`` (a tree of the same structure) through ``placements``.
    Every rank holds the same whole tree (the seeded initialisation gives
    it), so each cuts its own shard and nothing is sent
    (``distribute_tensor`` with no source rank).  Other leaves (the
    optimizer's host step, None) stay as they are.  Raises, before it
    places anything, on a tensor leaf without a spec."""
    from torch.distributed.tensor import distribute_tensor

    def walk(t, s, path, place):
        if isinstance(t, dict):
            if not isinstance(s, dict) or set(s) != set(t):
                raise ValueError(f"{path or '/'}: no spec tree for keys "
                                 f"{sorted(t)}")
            return {k: walk(v, s[k], f"{path}/{k}", place)
                    for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            if not isinstance(s, (list, tuple)) or len(s) != len(t):
                raise ValueError(f"{path or '/'}: no spec list for "
                                 f"{len(t)} entries")
            items = [walk(v, sv, f"{path}/{i}", place)
                     for i, (v, sv) in enumerate(zip(t, s))]
            return type(t)(*items) if hasattr(t, "_fields") else \
                type(t)(items)
        if not torch.is_tensor(t):
            return t
        if not (isinstance(s, tuple) and len(s) == t.dim()
                and not any(isinstance(e, (list, dict)) for e in s)):
            raise ValueError(f"{path}: no spec for a {tuple(t.shape)} "
                             f"leaf (got {s!r})")
        if not place:
            return t
        out = distribute_tensor(t.detach(), device_mesh,
                                placements(s, mesh), src_data_rank=None)
        return out.requires_grad_(t.requires_grad)

    walk(tree, specs, "", False)
    return walk(tree, specs, "", True)
