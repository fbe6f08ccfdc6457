"""Collective bytes of a step: the JAX package's ``launch/hlo_stats.py``.

The JAX package sums the result-tensor sizes of every collective in XLA's
optimized HLO text (all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute, their -start forms included).  The port has no HLO: it
records the collectives a step calls as it runs them,
``utils.dist.counted_collectives`` (``torch.distributed``'s functions: the
MOCHA round) and ``utils.dist.dtensor_collectives`` (DTensor's functional
collectives: the sharded LM step), and sums the same thing, each call's
result bytes, under the same kinds and keys.

Every call of the recorded program counts: a layer loop runs in Python, so
nothing is counted once for many iterations as a while-body is in HLO.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple, Union

import torch

from repro_torch.utils.dist import Collective, DTensorCollective

#: the JAX package's table, element bytes by XLA's dtype name
_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "s32": 4, "s16": 2, "s8": 1,
    "u64": 8, "u32": 4, "u16": 2, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}
#: XLA's name of each torch dtype that has one
DTYPE_NAMES = {
    torch.float64: "f64", torch.float32: "f32", torch.float16: "f16",
    torch.bfloat16: "bf16", torch.float8_e4m3fn: "f8e4m3fn",
    torch.float8_e5m2: "f8e5m2", torch.int64: "s64", torch.int32: "s32",
    torch.int16: "s16", torch.int8: "s8", torch.uint64: "u64",
    torch.uint32: "u32", torch.uint16: "u16", torch.uint8: "u8",
    torch.bool: "pred", torch.complex64: "c64", torch.complex128: "c128",
}

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

#: HLO's kind of each recorded name: ``torch.distributed``'s functions and
#: the functional collectives' ops (``_coalesced`` forms included)
_KINDS = {
    "all_reduce": "all-reduce",
    "all_gather": "all-gather", "all_gather_into_tensor": "all-gather",
    "all_gather_single": "all-gather",
    "reduce_scatter": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all": "all-to-all", "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "send": "collective-permute", "recv": "collective-permute",
    "isend": "collective-permute", "irecv": "collective-permute",
    "batch_isend_irecv": "collective-permute",
}
#: recorded names that XLA's HLO has no collective for (a barrier, the
#: object collectives, the rooted ones): not counted, as JAX's parser
#: counts no other op
_UNCOUNTED = frozenset((
    "barrier", "broadcast", "broadcast_object_list", "all_gather_object",
    "gather", "scatter", "reduce"))

Call = Union[Collective, DTensorCollective]


def _kind(name: str):
    base = name[:-len("_coalesced")] if name.endswith("_coalesced") else name
    if base in _UNCOUNTED:
        return None
    if base not in _KINDS:
        raise ValueError(f"collective {name!r} has no HLO kind")
    return _KINDS[base]


def _numel(shape: Tuple[int, ...]) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def result_bytes(call: Call) -> int:
    """The bytes of a call's result: ``Collective.shape`` (the output
    argument) or ``DTensorCollective.result``, one shape or a tuple of
    shapes, in the call's dtype."""
    shape = call.result if isinstance(call, DTensorCollective) else \
        call.shape
    shapes = shape if shape and isinstance(shape[0], tuple) else (shape,)
    return sum(_numel(s) for s in shapes) * _DTYPE_BYTES[
        DTYPE_NAMES[call.dtype]]


def collective_bytes(calls: Iterable[Call]) -> Dict[str, float]:
    """Sum result bytes per collective kind over the recorded calls, with
    the JAX package's keys: the five kinds, ``count``, ``total`` and
    ``total_bf16_equiv``.

    ``total_bf16_equiv`` equals ``total`` here.  In the JAX package it
    corrects XLA's CPU pipeline, which legalizes bf16 arithmetic to f32 so
    that collectives that move bf16 on the TPU show as f32 in the CPU's
    HLO; eager torch sends each tensor in its own dtype, the wire's, on
    every device, so there is nothing to correct."""
    out: Dict[str, float] = {c: 0.0 for c in _COLLECTIVES}
    out["count"] = 0
    for call in calls:
        kind = _kind(call.name)
        if kind is None:
            continue
        out[kind] += result_bytes(call)
        out["count"] += 1
    out["total"] = sum(out[c] for c in _COLLECTIVES)
    out["total_bf16_equiv"] = out["total"]
    return out
