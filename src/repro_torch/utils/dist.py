"""What every layer asks of ``torch.distributed``: whether this process
writes a run's files, a count of the collectives it calls (through
``torch.distributed``'s functions, or DTensor's functional collectives),
and, for the launch plan's cost probe, a fake process group and a count of
what each rank's own operations compute and move."""
from __future__ import annotations

import contextlib
import threading
from typing import Iterator, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

#: every ``torch.distributed`` collective a run could call
COLLECTIVES = (
    "all_gather", "all_gather_into_tensor", "all_gather_single",
    "all_gather_object", "all_reduce", "all_to_all", "all_to_all_single",
    "barrier", "batch_isend_irecv", "broadcast", "broadcast_object_list",
    "gather", "irecv", "isend", "recv", "reduce", "reduce_scatter",
    "reduce_scatter_tensor", "scatter", "send")


def writes_files() -> bool:
    """True where a run writes its files (checkpoints, traces): rank 0 of
    the process group, or a process with no group.  Every rank holds the
    same state, so the others skip the write alone; a run resumed on
    another rank's host needs the directory on a shared file system."""
    return not dist.is_initialized() or dist.get_rank() == 0


class Collective(NamedTuple):
    """One collective call: its name, and its first argument's (the output
    tensor's) shape and dtype; where that argument is a list of output
    tensors, the tuple of their shapes and the first one's dtype."""
    name: str
    shape: Tuple[int, ...]
    dtype: Optional[torch.dtype]


class DTensorCollective(NamedTuple):
    """One of DTensor's collectives: its name, its input's shape and dtype,
    the address of its input's storage (a tensor sent as it is, or a view
    of it, shows its own; ``None`` for a tensor without storage, a
    FakeTensor's), and its result's shape (the tuple of the results'
    shapes where it returns several)."""
    name: str
    shape: Tuple[int, ...]
    dtype: Optional[torch.dtype]
    storage: Optional[int]
    result: Tuple = ()


def _shapes(x) -> Tuple:
    """A tensor's shape, or the tuple of the shapes of a list of them."""
    if isinstance(x, (list, tuple)):
        return tuple(tuple(t.shape) for t in x if torch.is_tensor(t))
    return tuple(getattr(x, "shape", ()))


def _dtype(x) -> Optional[torch.dtype]:
    if isinstance(x, (list, tuple)):
        return next((t.dtype for t in x if torch.is_tensor(t)), None)
    return getattr(x, "dtype", None)


def _storage(x) -> Optional[int]:
    """The address of a tensor's storage; ``None`` where it has none (not a
    tensor, or a FakeTensor, whose address torch refuses to read)."""
    from torch._subclasses.fake_tensor import FakeTensor
    if not torch.is_tensor(x) or isinstance(x, FakeTensor):
        return None
    return x.untyped_storage().data_ptr()


@contextlib.contextmanager
def counted_collectives() -> Iterator[List[Collective]]:
    """Every outermost ``torch.distributed`` collective called inside, in
    call order (a collective that calls another counts once)."""
    calls: List[Collective] = []
    local = threading.local()

    def wrap(name, fn):
        def counted(*args, **kwargs):
            depth = getattr(local, "depth", 0)
            if depth == 0:
                out = args[0] if args else None
                calls.append(Collective(name, _shapes(out), _dtype(out)))
            local.depth = depth + 1
            try:
                return fn(*args, **kwargs)
            finally:
                local.depth = depth
        return counted

    saved = {n: getattr(dist, n) for n in COLLECTIVES if hasattr(dist, n)}
    for n, fn in saved.items():
        setattr(dist, n, wrap(n, fn))
    try:
        yield calls
    finally:
        for n, fn in saved.items():
            setattr(dist, n, fn)


def _is_collective(func) -> bool:
    """A collective of ``torch.distributed``'s ops (not the functional
    collectives' waits and autograd wrappers), or DTensor's all-to-all
    between two shard dims (``_dtensor.shard_dim_alltoall``, which it calls
    on a CUDA mesh)."""
    name = func._overloadpacket.__name__
    namespace = getattr(func, "namespace", "")
    if namespace == "_dtensor":
        return name == "shard_dim_alltoall"
    return (namespace in ("_c10d_functional", "c10d_functional", "c10d")
            and name != "wait_tensor" and not name.startswith("_"))


@contextlib.contextmanager
def dtensor_collectives() -> Iterator[Tuple[object,
                                            List[DTensorCollective]]]:
    """DTensor's collectives inside (they bypass ``counted_collectives``'
    wrappers): ``torch.distributed.tensor.debug.CommDebugMode``, whose
    ``get_comm_counts`` counts them by kind, and the list of each call's
    name, input shape and dtype, the address of the input's storage and
    the result's shape, in call order."""
    from torch.distributed.tensor.debug import CommDebugMode
    calls: List[DTensorCollective] = []

    class Mode(CommDebugMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is not NotImplemented and _is_collective(func):
                x = args[0] if args else None
                calls.append(DTensorCollective(
                    func._overloadpacket.__name__, _shapes(x), _dtype(x),
                    _storage(x), _shapes(out)))
            return out

    with Mode() as mode:
        yield mode, calls


@contextlib.contextmanager
def fake_group(world_size: int) -> Iterator[None]:
    """This process as rank 0 of a fake default process group of
    ``world_size`` ranks (``torch.testing._internal.distributed.fake_pg``):
    every collective returns at once with a result of the right shape and
    nothing written in it, so one process runs rank 0's part of a program
    meant for ``world_size`` ranks.  Raises where a group exists already
    (a fake group must never carry a real run's collectives, nor a real
    group a probe's); the group is destroyed on the way out."""
    if dist.is_initialized():
        raise RuntimeError(
            "a process group is initialized already; a cost probe runs in a "
            "process of its own")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


#: operations that move no data: storage made and left unwritten, a
#: tensor's metadata, a scalar read to the host
_NO_DATA = frozenset(("empty", "empty_like", "empty_strided", "new_empty",
                      "new_empty_strided", "lift_fresh", "_local_scalar_dense",
                      "sym_size", "sym_stride", "sym_numel", "sym_storage_offset"))
#: namespaces of operations that are not a rank's own work: collectives
#: (the collective term counts them), and ``prim``'s metadata queries
_NOT_LOCAL = frozenset(("_c10d_functional", "c10d_functional", "c10d",
                        "_dtensor", "prim"))


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if torch.is_tensor(t))


class DeviceCost(TorchDispatchMode):
    """What one rank's own operations compute and move, counted while the
    mode is on: ``flops`` through ``torch.utils.flop_counter``'s
    ``flop_registry`` (matrix products, convolutions and the library's
    attention; elementwise work adds none), ``bytes`` as the sum of every
    operation's input and output bytes, and ``ops``.

    The mode returns ``NotImplemented`` for an operation on DTensors, so
    DTensor's dispatch runs it and the mode sees the rank's local
    operations on its shards, not the global shapes.  ``bytes`` is what an
    eager, unfused step moves: it stands for XLA's ``bytes accessed`` of
    the JAX package's compiled step, which fusion makes smaller.  Views,
    operations that move no data (``_NO_DATA``) and collectives (counted
    on their own, ``dtensor_collectives``) add no bytes.

    Count a warm call only: the first call of an operation on DTensors of
    a new layout runs DTensor's sharding propagation, which runs the
    operation once more at the global shapes, under the mode; later calls
    find the propagation in DTensor's cache.  A kernel called through
    ``ctypes`` is invisible to dispatch: count a step on the CPU, where the
    attention wrappers run their plain versions."""

    def __init__(self):
        super().__init__()
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry
        self._dtensor, self._flops = DTensor, flop_registry
        self.flops = 0
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if getattr(func, "namespace", "") in _NOT_LOCAL:
            return out
        self.ops += 1
        count = self._flops.get(packet)
        if count is not None:
            self.flops += int(count(*args, **kwargs, out_val=out))
        if not func.is_view and packet.__name__ not in _NO_DATA:
            self.bytes += _tensor_bytes((args, kwargs)) + _tensor_bytes(out)
        return out


def _group(group_name):
    from torch.distributed.distributed_c10d import _resolve_process_group
    return (_resolve_process_group(group_name)
            if isinstance(group_name, str) else group_name)


def _all_gather(input, group_size, group_name):
    out = input.new_empty((input.shape[0] * group_size, *input.shape[1:]))
    dist.all_gather_into_tensor(out, input.contiguous(),
                                group=_group(group_name))
    return out


def _reduce_scatter(input, reduce_op, group_size, group_name):
    out = input.new_empty((input.shape[0] // group_size, *input.shape[1:]))
    avg = reduce_op.lower() == "avg"
    op = dist.ReduceOp.SUM if avg else getattr(dist.ReduceOp,
                                               reduce_op.upper())
    dist.reduce_scatter_tensor(out, input.contiguous(), op=op,
                               group=_group(group_name))
    return out.div_(group_size) if avg else out


def _all_to_all(input, output_split_sizes, input_split_sizes, group_name):
    out = input.new_empty((sum(output_split_sizes), *input.shape[1:]))
    dist.all_to_all_single(out, input.contiguous(), list(output_split_sizes),
                           list(input_split_sizes), group=_group(group_name))
    return out


@contextlib.contextmanager
def gloo_collectives() -> Iterator[None]:
    """DTensor's all-gathers, reduce-scatters and all-to-alls through
    ``torch.distributed``'s own calls on a gloo group, inside: the
    installed torch's functional all-gather
    (``_c10d_functional.all_gather_into_tensor``, the one DTensor calls)
    crashes in its wait on a gloo group with CUDA tensors (a segmentation
    fault, on any group; its all-reduce works), while
    ``all_gather_into_tensor`` and the others carry CUDA tensors; on CPU
    tensors it once aborted a rank (heap corruption).  Each routed call
    completes before it returns.  For gloo ranks (several sharing one
    card, or on the CPU); NCCL needs none of it."""
    lib = torch.library.Library("_c10d_functional", "IMPL")
    for key in ("CPU", "CUDA"):
        for name, fn in (("all_gather_into_tensor", _all_gather),
                         ("reduce_scatter_tensor", _reduce_scatter),
                         ("all_to_all_single", _all_to_all)):
            lib.impl(name, fn, key)
    try:
        yield
    finally:
        lib._destroy()
