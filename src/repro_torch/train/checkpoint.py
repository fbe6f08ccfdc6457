"""Checkpointing: trees of arrays as one numpy archive with a json manifest.

The layout of the JAX package's ``repro.train.checkpoint``: one file
``step_<n>.ckpt`` per saved step, written to a temporary name and moved
into place with ``os.replace`` (a reader never sees a half-written file),
``latest_step`` discovery, and a strict leaf-count / shape check on
restore.  The encoding differs: the leaves go into an ``np.savez`` archive
(``leaf_<i>``) beside a json manifest of the tree and each leaf's dtype and
shape, so numpy is the only dependency.  A checkpoint of the JAX package
does not load here.

Trees are dicts (flattened in sorted-key order, as ``jax.tree_util``
does), tuples and lists of leaves; a leaf is a numpy array, a torch tensor
or a Python / numpy scalar.
"""
from __future__ import annotations

import io
import json
import os
import re
from typing import Any, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.utils.device import resolve_device

_STEP_RE = re.compile(r"^step_(\d+)\.ckpt$")
_MANIFEST = "__manifest__"


def _flatten(tree: Any, leaves: List[np.ndarray]) -> Any:
    """The tree's structure as json, its leaves appended to ``leaves``."""
    if isinstance(tree, dict):
        return {"dict": [[str(k), _flatten(tree[k], leaves)]
                         for k in sorted(tree)]}
    if isinstance(tree, (tuple, list)):
        return {"tuple" if isinstance(tree, tuple) else "list":
                [_flatten(v, leaves) for v in tree]}
    if isinstance(tree, torch.Tensor):
        tree = tree.detach().cpu().numpy()
    leaves.append(np.asarray(tree))
    return None


def _unflatten(node: Any, leaves: List[Any], pos: List[int]) -> Any:
    if node is None:
        leaf = leaves[pos[0]]
        pos[0] += 1
        return leaf
    (kind, body), = node.items()
    if kind == "dict":
        return {k: _unflatten(v, leaves, pos) for k, v in body}
    items = [_unflatten(v, leaves, pos) for v in body]
    return tuple(items) if kind == "tuple" else items


def encode(step: int, tree: Any) -> bytes:
    """A tree's checkpoint file, as bytes."""
    leaves: List[np.ndarray] = []
    structure = _flatten(tree, leaves)
    manifest = json.dumps({
        "step": int(step), "tree": structure,
        "leaves": [{"dtype": a.dtype.str, "shape": list(a.shape)}
                   for a in leaves]})
    buf = io.BytesIO()
    np.savez(buf, **{_MANIFEST: np.frombuffer(manifest.encode(), np.uint8)},
             **{f"leaf_{i}": a for i, a in enumerate(leaves)})
    return buf.getvalue()


def step_path(path: str, step: int) -> str:
    """The file of checkpoint ``step`` under ``path``."""
    return os.path.join(path, f"step_{step}.ckpt")


def write(path: str, step: int, data: bytes) -> str:
    """Atomically write ``encode``'s bytes.  Returns the file path."""
    os.makedirs(path, exist_ok=True)
    fname = step_path(path, step)
    tmp = fname + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, fname)
    return fname


def save(path: str, step: int, tree: Any) -> str:
    """Atomically save a tree.  Returns the checkpoint file path."""
    return write(path, step, encode(step, tree))


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [int(m.group(1)) for f in os.listdir(path)
             if (m := _STEP_RE.match(f))]
    return max(steps) if steps else None


def restore(path: str, like: Any, step: Optional[int] = None,
            as_numpy: bool = False,
            device: Union[str, torch.device, None] = None
            ) -> Tuple[Any, int]:
    """Restore into the structure of ``like`` (strict leaf-count and shape
    check; each leaf cast to ``like``'s dtype).

    ``as_numpy=True`` returns writable host ``np.ndarray`` leaves, for host
    state that is mutated in place after restore (the cohort checkpoints);
    otherwise the leaves are tensors on ``device`` (the card by default).
    """
    step = step if step is not None else latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {path}")
    fname = step_path(path, step)
    with open(fname, "rb") as f:
        archive = np.load(io.BytesIO(f.read()), allow_pickle=False)
    manifest = json.loads(bytes(archive[_MANIFEST]).decode())
    want_leaves: List[np.ndarray] = []
    structure = _flatten(like, want_leaves)
    n = len(manifest["leaves"])
    if n != len(want_leaves):
        raise ValueError(f"leaf count mismatch: ckpt {n} vs "
                         f"expected {len(want_leaves)}")
    dev = None if as_numpy else resolve_device(device)
    out = []
    for i, want in enumerate(want_leaves):
        arr = archive[f"leaf_{i}"]
        if arr.shape != want.shape:
            raise ValueError(f"shape mismatch {arr.shape} vs {want.shape}")
        cast = arr.astype(want.dtype)
        out.append(cast if as_numpy else torch.from_numpy(cast).to(dev))
    return _unflatten(structure, out, [0]), manifest["step"]
