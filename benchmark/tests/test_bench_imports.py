"""What the benchmark may import, by top-level module name compared
whole: nothing of JAX, of the JAX package, or of the repository's older
benchmarks anywhere; nothing of the program in the reference."""

import ast
import os

import pytest

from benchmark.harness import cells

NEVER = {"jax", "jaxlib", "flax", "pngloss_tpu", "chip_smoke",
         "bench_torch", "bench"}
REFERENCE_NEVER = NEVER | {"pngloss_tpu_torch", "torch"}


def imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.ImportFrom) and node.level
              and node.module):
            yield "benchmark"


def sources(top, skip=("tests",)):
    for d, dirs, names in os.walk(top):
        dirs[:] = [x for x in dirs if x not in skip and x != "__pycache__"]
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(d, n)


@pytest.mark.parametrize("path", sorted(sources(cells.BENCH_DIR)),
                         ids=lambda p: os.path.relpath(p, cells.BENCH_DIR))
def test_no_forbidden_import(path):
    found = set(imports(path)) & NEVER
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize(
    "path", sorted(sources(os.path.join(cells.BENCH_DIR, "reference"))),
    ids=os.path.basename)
def test_reference_imports_nothing_of_the_program(path):
    names = set(imports(path))
    assert not names & REFERENCE_NEVER, names
    # and of the benchmark only the reference itself
    with open(path) as fh:
        for node in ast.walk(ast.parse(fh.read())):
            if isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.startswith("benchmark"):
                assert node.module.startswith("benchmark.reference"), (
                    path, node.module)


def test_names_compare_whole():
    assert "pngloss_tpu_torch" not in NEVER
    assert "benchmark" not in NEVER
