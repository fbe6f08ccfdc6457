"""What every layer asks of ``torch.distributed``: whether this process
writes a run's files, and a count of the collectives it calls (through
``torch.distributed``'s functions, or DTensor's functional collectives)."""
from __future__ import annotations

import contextlib
import threading
from typing import Iterator, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

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
    tensor's) shape and dtype."""
    name: str
    shape: Tuple[int, ...]
    dtype: Optional[torch.dtype]


class DTensorCollective(NamedTuple):
    """One of DTensor's collectives: its name, its input's shape and dtype,
    and the address of its input's storage (a tensor sent as it is, or a
    view of it, shows its own)."""
    name: str
    shape: Tuple[int, ...]
    dtype: Optional[torch.dtype]
    storage: Optional[int]


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
                calls.append(Collective(
                    name, tuple(getattr(out, "shape", ())),
                    getattr(out, "dtype", None)))
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
    collectives' waits and autograd wrappers)."""
    name = func._overloadpacket.__name__
    return (getattr(func, "namespace", "") in ("_c10d_functional",
                                               "c10d_functional", "c10d")
            and name != "wait_tensor" and not name.startswith("_"))


@contextlib.contextmanager
def dtensor_collectives() -> Iterator[Tuple[object,
                                            List[DTensorCollective]]]:
    """DTensor's collectives inside (they bypass ``counted_collectives``'
    wrappers): ``torch.distributed.tensor.debug.CommDebugMode``, whose
    ``get_comm_counts`` counts them by kind, and the list of each call's
    name, input shape and dtype and the address of the input's storage,
    in call order."""
    from torch.distributed.tensor.debug import CommDebugMode
    calls: List[DTensorCollective] = []

    class Mode(CommDebugMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is not NotImplemented and _is_collective(func):
                x = args[0] if args else None
                calls.append(DTensorCollective(
                    func._overloadpacket.__name__,
                    tuple(getattr(x, "shape", ())),
                    getattr(x, "dtype", None),
                    x.untyped_storage().data_ptr()
                    if torch.is_tensor(x) else None))
            return out

    with Mode() as mode:
        yield mode, calls


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
