"""The port's checkpoints (``repro_torch.train.checkpoint``): the JAX
package's layout and contract (``step_<n>.ckpt`` written to a temporary
name and moved into place, ``latest_step``, a strict leaf-count / shape
check, writable host leaves under ``as_numpy``) with a numpy + json
encoding; and the port never imports ``msgpack``."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.train import checkpoint as jax_ckpt
from repro_torch.train import checkpoint as ckpt

ROOT = Path(__file__).resolve().parents[1]

TREE = {"a": np.arange(12, dtype=np.float32).reshape(3, 4),
        "b": {"c": np.asarray([1, 2, 3], np.int32),
              "d": (np.float64(2.5), np.zeros((), np.int64))},
        "e": [np.ones((2, 0), np.float32), np.asarray([True, False])],
        "rng": np.asarray([2 ** 64 - 1, 3], np.uint64),
        "t": torch.arange(5, dtype=torch.float32)}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree.numpy() if isinstance(tree, torch.Tensor)
                       else tree)]


def test_roundtrip_keeps_structure_dtypes_and_values(tmp_path):
    path = ckpt.save(str(tmp_path), 7, TREE)
    assert path == str(tmp_path / "step_7.ckpt")
    assert ckpt.latest_step(str(tmp_path)) == 7
    host, step = ckpt.restore(str(tmp_path), TREE, as_numpy=True)
    assert step == 7
    assert isinstance(host["b"]["d"], tuple) and isinstance(host["e"], list)
    for got, want in zip(_leaves(host), _leaves(TREE)):
        assert isinstance(got, np.ndarray)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    dev, _ = ckpt.restore(str(tmp_path), TREE, device="cpu")
    assert isinstance(dev["a"], torch.Tensor)
    np.testing.assert_array_equal(dev["a"].numpy(), TREE["a"])


def test_same_leaves_as_the_jax_checkpoint(tmp_path):
    """The port's flattening order is the JAX package's (dict keys
    sorted), so a tree restores to the same leaves in both."""
    tree = {"z": np.arange(3, dtype=np.float32), "a": {"y": np.eye(2),
                                                       "b": np.int64(4)}}
    jax_ckpt.save(str(tmp_path / "j"), 1, tree)
    ckpt.save(str(tmp_path / "t"), 1, tree)
    j, _ = jax_ckpt.restore(str(tmp_path / "j"), tree, as_numpy=True)
    t, _ = ckpt.restore(str(tmp_path / "t"), tree, as_numpy=True)
    for got, want in zip(_leaves(t), _leaves(j)):
        np.testing.assert_array_equal(got, want)


def test_restored_numpy_leaves_are_writable(tmp_path):
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}
    ckpt.save(str(tmp_path), 0, tree)
    host, _ = ckpt.restore(str(tmp_path), tree, as_numpy=True)
    assert host["w"].flags.writeable
    host["w"][0, 0] = 99.0
    assert host["w"][0, 0] == 99.0


def test_latest_step_and_strict_checks(tmp_path):
    d = str(tmp_path)
    assert ckpt.latest_step(d + "/missing") is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(d, {"w": np.zeros(1)}, as_numpy=True)
    tree = {"w": np.zeros((2, 2), np.float32)}
    ckpt.save(d, 1, tree)
    ckpt.save(d, 5, tree)
    (tmp_path / "step_x.ckpt").write_bytes(b"not a step")
    assert ckpt.latest_step(d) == 5
    _, step = ckpt.restore(d, tree, step=1, as_numpy=True)
    assert step == 1
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.restore(d, {"w": np.zeros((3, 3), np.float32)}, as_numpy=True)
    with pytest.raises(ValueError, match="leaf count"):
        ckpt.restore(d, {"w": tree["w"], "v": np.zeros(1)}, as_numpy=True)


def test_save_is_atomic(tmp_path, monkeypatch):
    """A save that dies mid-write leaves the last complete checkpoint as
    the latest one and no partial ``step_<n>.ckpt``."""
    d = str(tmp_path)
    ckpt.save(d, 2, {"w": np.ones(3)})

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt.np, "savez", broken)
    with pytest.raises(OSError):
        ckpt.save(d, 4, {"w": np.ones(3)})
    monkeypatch.undo()
    assert ckpt.latest_step(d) == 2
    assert not os.path.exists(os.path.join(d, "step_4.ckpt"))
    host, _ = ckpt.restore(d, {"w": np.zeros(3)}, as_numpy=True)
    np.testing.assert_array_equal(host["w"], np.ones(3))


def test_port_never_imports_msgpack():
    src = ROOT / "src" / "repro_torch"
    for f in list(src.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        text = f.read_text()
        assert "msgpack" not in text, f
    code = ("import sys; sys.modules['msgpack'] = None\n"
            "import importlib, pkgutil, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "from repro_torch.train import checkpoint as c\n"
            "import tempfile, numpy as np\n"
            "d = tempfile.mkdtemp()\n"
            "c.save(d, 3, {'x': np.ones(2)})\n"
            "print(c.restore(d, {'x': np.zeros(2)}, as_numpy=True)[1])\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "3"
