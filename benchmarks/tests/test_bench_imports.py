"""No module of the benchmark imports JAX or the JAX package, and the
plain reference imports nothing of the program: top-level module names
compared whole (``vlp_tpu_torch`` is not ``vlp_tpu``)."""

import ast
import os
import subprocess
import sys

import pytest

from benchmarks import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "vlp_tpu"}


def _sources(root):
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _tops(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_sources(harness.BENCH)))
def test_no_jax_import(path):
    assert not set(_tops(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources(
    os.path.join(harness.BENCH, "reference"))))
def test_reference_imports_no_program(path):
    tops = set(_tops(path))
    assert "vlp_tpu_torch" not in tops
    assert not tops & FORBIDDEN


def test_forbidden_modules_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "vlp_tpu_torch_fake", sys)
    assert harness.forbidden_modules() == [] or \
        "vlp_tpu_torch_fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "optax", sys)
    assert "optax" in harness.forbidden_modules()


def test_a_run_holds_no_jax_module():
    """A run's process, driver and reference imported, holds no forbidden
    module (the check that run.py makes once its window has closed)."""
    code = ("import sys; sys.path.insert(0, %r); "
            "from benchmarks import harness, training; "
            "from benchmarks.drivers import train, decode; "
            "import vlp_tpu_torch.cli.decode, vlp_tpu_torch.train_step; "
            "print(harness.forbidden_modules())" % harness.ROOT)
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=harness.ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
