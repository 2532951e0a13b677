"""The benchmark keeps JAX and the JAX package out of every process it runs,
and its reference out of the program: the module scan compares whole
top-level names, and no file of the reference imports the program."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.harness import spec as S
from benchmark.harness.cli import forbidden_modules

BENCH = S.BENCH_DIR


@pytest.mark.parametrize("names, found", [
    (["jax", "numpy"], ["jax"]),
    (["jax.numpy", "torch"], ["jax.numpy"]),
    (["jaxlib.xla_client"], ["jaxlib.xla_client"]),
    (["flax.linen"], ["flax.linen"]),
    (["ava256_tpu", "ava256_tpu.ops"], ["ava256_tpu", "ava256_tpu.ops"]),
    (["ava256_tpu_torch", "ava256_tpu_torch.ops.raymarch_cuda", "jaxtyping"], []),
])
def test_module_scan(names, found):
    assert forbidden_modules(names) == found


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"ava256_tpu_torch", "ava256_tpu", "jax", "jaxlib", "flax"}


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_file_imports_jax(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"ava256_tpu", "jax", "jaxlib", "flax"}


def test_reference_loads_without_the_program():
    code = ("import sys; import benchmark.reference.steps, benchmark.reference.uv; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'ava256_tpu_torch', 'ava256_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=S.ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"
