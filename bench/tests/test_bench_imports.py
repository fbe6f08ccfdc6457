"""What the benchmark's files import, read from their source: no module
whose top-level name is ``jax``, ``jaxlib``, ``flax`` or ``repro`` (the
JAX package; ``repro_torch``, the program, is another name), and nothing
of the program in the yardstick (the reference and what it uses)."""
import ast
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
#: the yardstick: the reference, the generator both sides are fed from,
#: the comparison, the operation counts and the metric readers
YARDSTICK = ["reference.py", "generator.py", "compare.py", "cost.py",
             "devtrace.py"] + [os.path.join("metrics", f) for f in sorted(
                 os.listdir(os.path.join(BENCH, "metrics")))]


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def bench_sources():
    for root, _, files in os.walk(BENCH):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(root, f), BENCH)


@pytest.mark.parametrize("rel", sorted(bench_sources()))
def test_no_jax_and_no_jax_package(rel):
    assert not top_level_imports(os.path.join(BENCH, rel)) & FORBIDDEN


@pytest.mark.parametrize("rel", [r for r in YARDSTICK if r.endswith(".py")])
def test_yardstick_imports_nothing_of_the_program(rel):
    assert "repro_torch" not in top_level_imports(os.path.join(BENCH, rel))


def test_whole_names_are_compared():
    from bench import run
    assert "repro_torch" not in run.FORBIDDEN
    assert {"jax", "jaxlib", "flax", "repro"} == set(run.FORBIDDEN)
