"""Repo-wide pytest setup, loaded before ``tests/conftest.py``.

1. ``repro.utils.jax_compat`` registers a batching rule with
   ``batching.primitive_batchers.setdefault``.  From JAX 0.9 that registry
   is a ``PrimitiveBatchersProxy`` without ``setdefault`` (JAX already ships
   the rule there), so the import of ``repro`` fails.  Give the proxy a
   no-op ``setdefault`` before any test imports ``repro``; do nothing where
   the method exists or JAX is absent.
2. Mark the two sharded-runtime tests that take minutes each as ``slow``
   (``pyproject.toml`` deselects ``slow`` by default; ``-m slow`` runs them).
"""
import pytest

try:
    from jax._src.interpreters import batching as _batching
except ImportError:
    _batching = None

if _batching is not None:
    _proxy = type(_batching.primitive_batchers)
    if not hasattr(_proxy, "setdefault"):
        _proxy.setdefault = lambda self, key, value: value

_SLOW = {
    "tests/test_runtime.py::test_distributed_driver_converges",
    "tests/test_runtime.py::test_distributed_matches_serial_driver",
}


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.nodeid in _SLOW:
            item.add_marker(pytest.mark.slow)
