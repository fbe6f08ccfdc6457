"""reprolint's contracts over the port: every rule of ``tools/reprolint``
applied to ``src/repro_torch/``, a planted violation and a clean twin for
each, and the gate that the port's tree lints to zero findings (no
baseline; a suppression only where the JAX package has the same one).

The rules are the JAX package's own classes (``tools.reprolint.rules``),
subclassed with port scopes; ``tools/`` is not edited, and nothing of the
port lives there.  AST only: nothing here imports the port.

| JAX rule | Port scope | What changes in the port |
| --- | --- | --- |
| D101 wall clock | `src/repro_torch/*`, exempt `utils/timing.py` | nothing |
| D102 stdlib `random` | `src/repro_torch/*` | nothing |
| D103 unseeded RNG | `src/repro_torch/*` | numpy's legacy API stays banned; torch's global RNG is added: its seeding (`torch.manual_seed`, `torch.seed`, `torch.cuda.manual_seed(_all)`) always, its draws (`torch.rand`, `randn`, `randint`, `randperm`, `normal`, `bernoulli`, `multinomial`, `poisson`, `*_like`, in-place `uniform_`, `normal_`, `random_`, `bernoulli_`, `exponential_`, ...) made without `generator=` |
| D104 calendar time | `api/report.py`, `api/execute.py` | nothing |
| D105 silent swallow | `src/repro_torch/*` | nothing |
| D106 telemetry | `src/repro_torch/*` | the internals are `repro_torch.obs.tracer`, `.metrics`, `.export`; "inside obs" is `src/repro_torch/obs/` |
| D107 serve read-only | `serve/*`, exempt `serve/engine.py` | the banned module is `repro_torch.cohort.omega`; every torch draw and seeding is banned, with or without a generator, as every `jax.random.` call is |
| P201 self-Gram | `kernels/*`, `core/engine.py`, `federated/runtime.py`, `cohort/*` | `torch.matmul`, `torch.mm` beside numpy's; the transpose may be `.T`, `.mT`, `.t()` or `.transpose(...)` |
| P202 row folds | `kernels/sdca/*`, `core/engine.py`, `federated/runtime.py` | `torch.sum(a * b)` and `(a * b).sum()` beside numpy's; the primitives are `core/subproblem.py`'s |
| P203 host read in a round | `src/repro_torch/*` | a `scan_round_fn`'s round is captured in a CUDA graph: `.item()`, `.tolist()`, `.cpu()`, `.numpy()`, `float()` and `int()` break capture |
| P204 legacy entry | `src/repro_torch/*` | the same names; the port has no shims |
| T301 / T302 ownership | `cohort/*`, `serve/*` | nothing: the port carries the `# owner:` and `# worker:` tags |
| U501 unreachable | `repro_torch.configs`, `repro_torch.models` | roots `repro_torch`, `repro_torch.api`; this file's own graph walk, since `graph.py` reads `src/repro` |
| W401 quickstart | the port's examples | `w401_split` here, applied in `tests/test_torch_examples.py` around `main([..., "--device", "cpu"])`: `check_quickstart` sets a bare `sys.argv`, so it cannot ask for the CPU |

Paths in the table are under `src/repro_torch/`.
"""
import ast
import pathlib
import sys
import textwrap
import warnings

import pytest

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

from tools.reprolint import graph  # noqa: E402
from tools.reprolint import rules as R  # noqa: E402
from tools.reprolint.findings import Finding  # noqa: E402

PORT = "src/repro_torch"

#: torch's process-global RNG: seeding it
TORCH_SEEDS = {"torch.manual_seed", "torch.seed", "torch.random.manual_seed",
               "torch.random.seed", "torch.cuda.manual_seed",
               "torch.cuda.manual_seed_all", "torch.cuda.seed",
               "torch.cuda.seed_all"}
#: torch's draws, global unless given ``generator=``
TORCH_DRAWS = {f"torch.{n}" for n in (
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial", "poisson", "rand_like", "randn_like", "randint_like")}
#: in-place draws on a tensor (or ``torch.nn.init``'s), global unless given
#: ``generator=``
DRAW_METHODS = {"uniform_", "normal_", "random_", "bernoulli_",
                "exponential_", "geometric_", "cauchy_", "log_normal_"}


def _has_generator(node: ast.Call) -> bool:
    return any(k.arg == "generator" for k in node.keywords)


def _torch_draws(ctx, rule, any_draw: bool):
    """Findings for torch RNG use: seeding always; draws without a
    generator, or every draw when ``any_draw``."""
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = ctx.resolve(node.func)
        if name in TORCH_SEEDS:
            yield ctx.finding(rule, node, f"global torch RNG seeding `{name}`")
        elif name in TORCH_DRAWS or (isinstance(node.func, ast.Attribute)
                                     and node.func.attr in DRAW_METHODS):
            what = name or f".{node.func.attr}(...)"
            if any_draw:
                yield ctx.finding(rule, node, f"RNG draw `{what}` in serve "
                                  "code; served answers must be pure in "
                                  "(snapshot, ids, X)")
            elif not _has_generator(node):
                yield ctx.finding(rule, node, f"torch draw `{what}` from the "
                                  "global RNG (no generator=)")


class D101(R.D101WallClockRead):
    scope = (f"{PORT}/*",)
    exempt = (f"{PORT}/utils/timing.py",)


class D102(R.D102StdlibRandom):
    scope = (f"{PORT}/*",)


class D103(R.D103UnseededNumpyRng):
    scope = (f"{PORT}/*",)

    def check(self, ctx):
        yield from super().check(ctx)
        yield from _torch_draws(ctx, self, any_draw=False)


class D104(R.D104BenchProvenanceTime):
    scope = (f"{PORT}/api/report.py", f"{PORT}/api/execute.py")


class D105(R.D105SilentFaultSwallow):
    scope = (f"{PORT}/*",)


class D106(R.D106TelemetryDiscipline):
    scope = (f"{PORT}/*",)
    exempt = ()
    OBS = "repro_torch.obs"
    INTERNAL_MODULES = ("repro_torch.obs.tracer", "repro_torch.obs.metrics",
                        "repro_torch.obs.export")

    @staticmethod
    def _inside_obs(rel):
        return rel.startswith(f"{PORT}/obs/")

    def _check_outside(self, ctx):
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name in self.INTERNAL_MODULES:
                        yield ctx.finding(
                            self, node,
                            f"import of obs internal module `{a.name}`")
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mod = node.module or ""
                if mod in self.INTERNAL_MODULES:
                    yield ctx.finding(
                        self, node, f"import from obs internal module `{mod}`")
                elif mod == self.OBS:
                    for a in node.names:
                        if a.name in self.INTERNAL_NAMES:
                            yield ctx.finding(
                                self, node, f"import of obs internal "
                                f"`{a.name}`; instrument through the "
                                "Telemetry facade")
        for node, name in self._calls(ctx):
            if not name.startswith(self.OBS + "."):
                continue
            tail = name[len(self.OBS) + 1:]
            if (tail.split(".")[0] in ("tracer", "metrics", "export")
                    or tail in self.INTERNAL_NAMES):
                yield ctx.finding(self, node, f"ad-hoc obs internal call "
                                  f"`{name}`; construct spans/metrics only "
                                  "through a Telemetry view")


class D107(R.D107ServeReadOnly):
    scope = (f"{PORT}/serve/*",)
    exempt = (f"{PORT}/serve/engine.py",)
    BANNED_MODULE = "repro_torch.cohort.omega"

    def check(self, ctx):
        yield from super().check(ctx)
        yield from _torch_draws(ctx, self, any_draw=True)


def _is_self_transpose(left, right) -> bool:
    """``right`` is ``left`` transposed: ``.T``, ``.mT``, ``.t()``,
    ``.transpose(...)`` or ``torch.transpose(left, ...)``."""
    if isinstance(right, ast.Attribute) and right.attr in ("T", "mT"):
        return R._same_expr(right.value, left)
    if isinstance(right, ast.Call) and isinstance(right.func, ast.Attribute):
        if right.func.attr in ("t", "transpose"):
            if R._same_expr(right.func.value, left):
                return True
            return (right.func.attr == "transpose" and right.args
                    and isinstance(right.func.value, ast.Name)
                    and right.func.value.id == "torch"
                    and R._same_expr(right.args[0], left))
    return False


class P201(R.P201RawSelfGram):
    scope = (f"{PORT}/kernels/*", f"{PORT}/core/engine.py",
             f"{PORT}/federated/runtime.py", f"{PORT}/cohort/*")
    MATMULS = R.P201RawSelfGram.MATMULS | {"torch.matmul", "torch.mm"}
    _is_self_transpose = staticmethod(_is_self_transpose)

    def check(self, ctx):
        yield from super().check(ctx)
        for node in ast.walk(ctx.tree):        # X.matmul(X.T), X.mm(X.t())
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("matmul", "mm") and node.args
                    and ctx.resolve(node.func) not in self.MATMULS
                    and _is_self_transpose(node.func.value, node.args[0])):
                yield ctx.finding(self, node, f"raw self-Gram via "
                                  f"`X.{node.func.attr}(X.T)`")


class P202(R.P202ManualRowReduction):
    scope = (f"{PORT}/kernels/sdca/*", f"{PORT}/core/engine.py",
             f"{PORT}/federated/runtime.py")
    SUMS = R.P202ManualRowReduction.SUMS | {"torch.sum"}

    def check(self, ctx):
        yield from super().check(ctx)
        for node in ast.walk(ctx.tree):        # (a * b).sum(...)
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "sum"
                    and isinstance(node.func.value, ast.BinOp)
                    and isinstance(node.func.value.op, ast.Mult)):
                yield ctx.finding(self, node, "manual reduction "
                                  "`(a * b).sum()`")


class P203(R.P203ScanHostMaterialization):
    scope = (f"{PORT}/*",)
    HOST_METHODS = ("item", "tolist", "cpu", "numpy")

    def check(self, ctx):
        registered = self._registered_round_fns(ctx.tree)
        for top in ctx.tree.body:
            if not (isinstance(top, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and top.name in registered):
                continue
            for node in ast.walk(top):
                if not isinstance(node, ast.Call):
                    continue
                if (isinstance(node.func, ast.Name)
                        and node.func.id in ("float", "int")):
                    yield ctx.finding(self, node, f"`{node.func.id}(...)` "
                                      "on a captured value")
                elif (isinstance(node.func, ast.Attribute)
                        and node.func.attr in self.HOST_METHODS):
                    yield ctx.finding(self, node, f"`.{node.func.attr}()` "
                                      "on a captured value")
                elif ctx.resolve(node.func) in self.NP_MATERIALIZE:
                    yield ctx.finding(self, node, f"`{ctx.resolve(node.func)}`"
                                      " materializes a captured value")


class P204(R.P204LegacyEntryCall):
    scope = (f"{PORT}/*",)
    exempt = ()


class T301(R.T301WrongWorkerAccess):
    scope = (f"{PORT}/cohort/*", f"{PORT}/serve/*")


class T302(R.T302UntaggedOwnedWrite):
    scope = (f"{PORT}/cohort/*", f"{PORT}/serve/*")


PORT_RULES = (D101(), D102(), D103(), D104(), D105(), D106(), D107(),
              P201(), P202(), P203(), P204(), T301(), T302())

# -- U501: the port's import graph ------------------------------------------

U501_ROOTS = ("repro_torch", "repro_torch.api")
U501_PREFIXES = ("repro_torch.configs", "repro_torch.models")


def port_modules(src: pathlib.Path):
    """Dotted module name -> file, for every module under src/repro_torch."""
    out = {}
    for p in sorted((src / "repro_torch").rglob("*.py")):
        parts = list(p.relative_to(src).with_suffix("").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out[".".join(parts)] = p
    return out


def check_unreachable(root: pathlib.Path):
    """U501 findings over ``root/src/repro_torch``: ``graph.py``'s edges
    (every import, lazy ones too, each dotted prefix) and walk."""
    src = root / "src"
    modules = port_modules(src)
    edges = {name: set() for name in modules}
    for name, path in modules.items():
        pkg = name if path.name == "__init__.py" else name.rsplit(".", 1)[0]
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                for a in node.names:
                    graph._add_edges(edges[name], a.name, modules)
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    anchor = pkg.split(".")[:len(pkg.split(".")) - node.level
                                            + 1]
                    base = ".".join(anchor + ([node.module] if node.module
                                              else []))
                else:
                    base = node.module or ""
                if not base:
                    continue
                graph._add_edges(edges[name], base, modules)
                for a in node.names:
                    if f"{base}.{a.name}" in modules:
                        graph._add_edges(edges[name], f"{base}.{a.name}",
                                         modules)
    seen = graph.reachable_from(edges, U501_ROOTS)
    return [Finding(rule=graph.RULE_ID,
                    path=modules[n].relative_to(root).as_posix(), line=1,
                    message=f"module `{n}` is unreachable from "
                            "repro_torch.api", context="<module>",
                    snippet=n, hint=graph.HINT)
            for n in sorted(modules) if n not in seen
            and any(n == p or n.startswith(p + ".") for p in U501_PREFIXES)]


# -- W401: first-party DeprecationWarnings ----------------------------------

def w401_split(caught, root: pathlib.Path = REPO_ROOT):
    """(findings, notes) of recorded warnings, as W401 classifies them: a
    ``DeprecationWarning`` raised from a file under ``root`` and outside
    ``site-packages`` is a finding; any other DeprecationWarning a note."""
    findings, notes = [], []
    for w in caught:
        if not issubclass(w.category, DeprecationWarning):
            continue
        resolved = pathlib.Path(w.filename).resolve()
        vendored = ("site-packages" in str(resolved)
                    or "dist-packages" in str(resolved))
        try:
            rel = resolved.relative_to(root.resolve()).as_posix()
        except ValueError:
            rel = None
        if rel is not None and not vendored:
            findings.append(Finding(
                rule="W401", path=rel, line=w.lineno,
                message="first-party DeprecationWarning from an example",
                context="<example>", snippet=str(w.message),
                hint="route through repro_torch.api.Experiment"))
        else:
            notes.append(f"{w.filename}:{w.lineno}: {w.message}")
    return findings, notes


def recorded(fn, *args, **kw):
    """``(fn(*args, **kw), caught warnings)`` under an "always" filter."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn(*args, **kw)
    return out, list(caught)


# -- planted cases ------------------------------------------------------------


def _lint(tmp_path, rel, source):
    f = tmp_path / rel
    f.parent.mkdir(parents=True, exist_ok=True)
    f.write_text(textwrap.dedent(source))
    return R.lint_file(tmp_path, f, rules=PORT_RULES)


def _rules(findings):
    return sorted({f.rule for f in findings})


_T_CLASS = """\
    class Loop:
        def __init__(self):
            self.sched = []  # owner: main
            self.buf = {}  # owner: pack

        def pack(self, b):  # worker: pack
            self.buf[b] = b
            return %s

        def fold(self, b):%s
            self.sched.append(b)
    """

#: (rule, path under src/repro_torch, violation, clean twin, findings)
PLANTED = [
    ("D101", "core/foo.py",
     "import time\ndef f():\n    return time.perf_counter()\n",
     "from repro_torch.utils.timing import tick\ndef f():\n"
     "    return tick()\n", 1),
    ("D102", "data/foo.py",
     "import random\ndef f():\n    return random.random()\n",
     "import numpy as np\ndef f(seed):\n"
     "    return np.random.default_rng(seed).random()\n", 2),
    ("D103", "data/foo.py",
     "import numpy as np\ndef f():\n    np.random.seed(0)\n"
     "    return np.random.default_rng()\n",
     "import numpy as np\ndef f(seed, tid):\n    return np.random.default_rng("
     "np.random.SeedSequence(seed, spawn_key=(tid,)))\n", 2),
    ("D103", "models/foo.py",
     "import torch\ndef f(w):\n    torch.manual_seed(0)\n"
     "    torch.cuda.manual_seed_all(0)\n    a = torch.randn(3)\n"
     "    b = torch.randint_like(a, 4)\n    w.uniform_(-1, 1)\n"
     "    torch.nn.init.normal_(w)\n    return a + b\n",
     "import torch\ndef f(w, seed):\n"
     "    g = torch.Generator().manual_seed(seed)\n"
     "    w.uniform_(-1, 1, generator=g)\n"
     "    return torch.randn(3, generator=g) + torch.zeros(3)\n", 6),
    ("D104", "api/report.py",
     "from datetime import datetime\ndef provenance():\n"
     "    return {'when': datetime.now().isoformat()}\n",
     "from datetime import timedelta\ndef provenance():\n"
     "    return {'timeout': timedelta(seconds=300).total_seconds()}\n", 1),
    ("D105", "cohort/foo.py",
     "def f(block):\n    try:\n        return block()\n"
     "    except Exception:\n        pass\n"
     "def g(block):\n    try:\n        return block()\n    except:\n"
     "        return None\n",
     "def f(block, attempts):\n    err = None\n"
     "    for _ in range(attempts):\n        try:\n"
     "            return block()\n        except Exception as e:\n"
     "            err = e\n    raise err\n", 2),
    ("D106", "obs/tracer.py",
     "import time\nfrom time import perf_counter\n",
     "from repro_torch.utils.timing import tick\ndef now():\n"
     "    return tick()\n", 2),
    ("D106", "cohort/foo.py",
     "from repro_torch.obs.tracer import Tracer\n"
     "from repro_torch.obs import MetricsRegistry\nfrom repro_torch import obs\n"
     "def f():\n    return obs.tracer.Span('x', 'main')\n",
     "from repro_torch import obs\ndef f(enabled):\n"
     "    tel = obs.telemetry(enabled)\n    with tel.span('pack', block=0):\n"
     "        tel.counter('blocks_packed').inc()\n"
     "    return obs.metrics_summary(tel)\n", 3),
    ("D107", "serve/hot.py",
     "import torch\nfrom repro_torch.cohort.omega import ClusterOmega\n"
     "def f(trace, ids, g):\n    trace.begin_round(ids)\n"
     "    return torch.rand(4, generator=g)\n",
     "import numpy as np\nfrom repro_torch.serve.store import ServedSnapshot\n"
     "def weights(snap, ids):\n"
     "    return snap.client_weights(np.asarray(ids))\n", 3),
    ("P201", "kernels/sdca/foo.py",
     "import torch\ndef gram(Xc):\n    a = Xc @ Xc.T\n"
     "    b = torch.matmul(Xc, Xc.mT)\n    c = torch.mm(Xc, Xc.t())\n"
     "    d = Xc.matmul(Xc.transpose(-1, -2))\n    return a + b + c + d\n",
     "import torch\ndef f(W_p, centroids):\n"
     "    return torch.matmul(W_p, centroids.T) + W_p @ centroids.mT\n", 4),
    ("P202", "core/engine.py",
     "import torch\ndef rowdots(A, B):\n"
     "    return torch.sum(A * B, dim=1) + (A * B).sum(-1)\n",
     "import torch\ndef total(A):\n"
     "    return torch.sum(A, dim=1) + A.sum(-1)\n", 2),
    ("P203", "core/foo.py",
     "import numpy as np\ndef _round(carry, x):\n"
     "    a = float(x) + int(x) + x.item()\n"
     "    b = x.tolist(), x.cpu(), x.numpy(), np.asarray(x)\n"
     "    return carry, a, b\n"
     "class Engine:\n    def scan_round_fn(self):\n        return _round\n",
     "def _round(carry, x):\n    return carry, x * 2\n"
     "def after(x):\n    return float(x), x.item()\n"
     "class Engine:\n    def scan_round_fn(self):\n        return _round\n", 7),
    ("P204", "examples/foo.py",
     "from repro_torch.core import run_mocha\ndef f(data, cfg):\n"
     "    return run_mocha(data, cfg)\n",
     "from repro_torch.api import Experiment\ndef f(exp):\n"
     "    return exp.run(0)\n", 1),
    ("T301", "cohort/driver.py",
     textwrap.dedent(_T_CLASS % ("self.sched[b]", "  # worker: main")),
     textwrap.dedent(_T_CLASS % ("self.buf[b]", "  # worker: main")), 1),
    ("T301", "serve/store.py",
     "class Store:\n    def __init__(self):\n"
     "        self._current = None  # owner: main\n"
     "    def current(self):  # worker: serve\n"
     "        return self._current\n",
     "class Store:\n    def __init__(self):\n"
     "        self._current = None  # owner: main\n"
     "    def current(self):  # worker: serve\n"
     "        return self._current  # reprolint: ok T301 (atomic read)\n", 1),
    ("T302", "cohort/driver.py",
     textwrap.dedent(_T_CLASS % ("self.buf[b]", "")),
     textwrap.dedent(_T_CLASS % ("self.buf[b]", "  # worker: main")), 1),
]


@pytest.mark.parametrize("rule,rel,bad,good,count", PLANTED,
                         ids=[f"{p[0]}-{p[1]}" for p in PLANTED])
def test_port_rule_flags_planted_violation(tmp_path, rule, rel, bad, good,
                                           count):
    out = _lint(tmp_path / "bad", f"{PORT}/{rel}", bad)
    assert _rules(out) == [rule], [f.render() for f in out]
    assert len(out) == count, [f.render() for f in out]
    assert _lint(tmp_path / "good", f"{PORT}/{rel}", good) == []


@pytest.mark.parametrize("rel,source", [
    # the sanctioned clock module; the LM engine's seeded sampling;
    # attention kernels are not SDCA engine code; the JAX package's own
    # tree is the JAX rules' business
    ("utils/timing.py", "import time\ndef tick():\n"
                        "    return time.perf_counter()\n"),
    ("serve/engine.py", "import torch\ndef sample(logits, g):\n"
                        "    return torch.multinomial(logits, 1, "
                        "generator=g)\n"),
    ("kernels/flash_attention/ref.py",
     "import torch\ndef scores(q, k):\n    return torch.sum(q * k, -1)\n"),
    ("cohort/foo.py", "from repro_torch.cohort.omega import ClusterOmega\n"),
])
def test_port_rule_scopes_and_exemptions(tmp_path, rel, source):
    assert _lint(tmp_path, f"{PORT}/{rel}", source) == []


def test_port_rules_leave_the_jax_tree_alone(tmp_path):
    assert _lint(tmp_path, "src/repro/core/foo.py",
                 "import time\nimport torch\ndef f():\n"
                 "    return time.time(), torch.randn(3)\n") == []


def _mini_port(tmp_path, wire: bool):
    files = {
        "repro_torch/__init__.py": "",
        "repro_torch/api/__init__.py":
            "from repro_torch.core import run\n"
            + ("from .specs import CFG\n" if wire else ""),
        "repro_torch/api/specs.py":
            "def CFG():\n    from repro_torch.configs.used import C\n"
            "    return C\n",
        "repro_torch/core/__init__.py": "def run():\n    return 1\n",
        "repro_torch/configs/__init__.py": "",
        "repro_torch/configs/used.py": "C = {}\n",
        "repro_torch/models/__init__.py": "",
        "repro_torch/models/dead.py": "DEAD = {}\n",
    }
    for rel, text in files.items():
        p = tmp_path / "src" / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text)
    return tmp_path


@pytest.mark.parametrize("wire,expected", [
    (False, ["repro_torch.configs", "repro_torch.configs.used",
             "repro_torch.models", "repro_torch.models.dead"]),
    # a relative import and a lazy one reach `used` and its package init
    (True, ["repro_torch.models", "repro_torch.models.dead"]),
])
def test_u501_planted(tmp_path, wire, expected):
    root = _mini_port(tmp_path, wire)
    assert [f.snippet for f in check_unreachable(root)] == expected


def test_w401_planted(tmp_path):
    """A DeprecationWarning raised from a file under the root is a
    finding; one from outside it, or from site-packages, is a note."""
    def module(path, text):
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text)
        ns = {}
        exec(compile(path.read_text(), str(path), "exec"), ns)
        return ns["f"]

    body = "import warnings\ndef f():\n    warnings.warn('{}', {})\n"
    root = tmp_path / "repo"
    first = module(root / PORT / "examples" / "foo.py",
                   body.format("legacy entry point", "DeprecationWarning"))
    other = module(root / PORT / "examples" / "bar.py",
                   body.format("not deprecated", "UserWarning"))
    vendor = module(root / "venv" / "site-packages" / "dep.py",
                    body.format("vendor churn", "DeprecationWarning"))
    outside = module(tmp_path / "elsewhere" / "dep.py",
                     body.format("vendor churn", "DeprecationWarning"))
    _, caught = recorded(lambda: [first(), other(), vendor(), outside()])
    findings, notes = w401_split(caught, root)
    assert [(f.rule, f.path, f.snippet) for f in findings] == [
        ("W401", f"{PORT}/examples/foo.py", "legacy entry point")]
    assert len(notes) == 2 and all("vendor churn" in n for n in notes)
    _, caught = recorded(lambda: [other(), outside()])
    assert w401_split(caught, root)[0] == []


# -- the port's tree -----------------------------------------------------------


def test_every_jax_rule_has_a_port_counterpart():
    assert [r.id for r in PORT_RULES] == [r.id for r in R.ALL_RULES]
    for port, jax in zip(PORT_RULES, R.ALL_RULES):
        assert isinstance(port, type(jax))
        assert all(s.startswith(f"{PORT}/") for s in port.scope)
    assert {p[0] for p in PLANTED} == {r.id for r in R.ALL_RULES}


def _port_files():
    return sorted(p for p in (REPO_ROOT / PORT).rglob("*.py")
                  if "__pycache__" not in p.parts)


def test_port_tree_is_clean():
    """Zero findings over src/repro_torch, with no baseline."""
    findings = [f for p in _port_files()
                for f in R.lint_file(REPO_ROOT, p, rules=PORT_RULES)]
    findings += check_unreachable(REPO_ROOT)
    assert findings == [], "\n".join(f.render() for f in findings)


def _suppressions(path):
    return [line.split("#", 1)[1].strip() for line in
            path.read_text().splitlines() if R.SUPPRESS_RE.search(line)]


def test_port_suppressions_are_the_jax_packages():
    """A ``# reprolint: ok`` in the port only where the JAX package has the
    same one in the counterpart file."""
    for p in _port_files():
        ours = _suppressions(p)
        if not ours:
            continue
        twin = REPO_ROOT / "src" / "repro" / p.relative_to(REPO_ROOT / PORT)
        theirs = _suppressions(twin) if twin.exists() else []
        for s in ours:
            assert s in theirs, f"{p.relative_to(REPO_ROOT)}: `# {s}`"
            theirs.remove(s)
