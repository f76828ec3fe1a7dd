"""Nothing a run imports is JAX or the JAX package, compared by whole
top-level names (the port's name begins with the JAX package's)."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from port_bench import run

from .conftest import BENCH, ROOT


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    for dirpath, _, names in os.walk(BENCH):
        if "tests" in dirpath.split(os.sep):
            continue
        for n in names:
            if n.endswith(".py"):
                found = set(_imports(os.path.join(dirpath, n))) & set(run.FORBIDDEN)
                assert not found, (n, found)


def test_whole_names_are_compared(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in run.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    mod = sys.modules[__name__]
    for name in ("win32_raytracer_tpu_torch.render", "jaxtyping", "jax_like"):
        monkeypatch.setitem(sys.modules, name, mod)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "win32_raytracer_tpu.render", mod)
    monkeypatch.setitem(sys.modules, "jaxlib", mod)
    assert run.forbidden_modules() == ["jaxlib", "win32_raytracer_tpu"]


def test_a_run_loads_no_forbidden_module():
    code = ("import sys; from port_bench import run, control, segments, compare;"
            "from port_bench.reference import render;"
            "import win32_raytracer_tpu_torch.api, win32_raytracer_tpu_torch.animation;"
            "import win32_raytracer_tpu_torch.parallel.persistent_shard;"
            "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
