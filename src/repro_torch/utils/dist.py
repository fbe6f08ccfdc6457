"""What every layer asks of ``torch.distributed``: whether this process
writes a run's files, and a count of the collectives it calls."""
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
