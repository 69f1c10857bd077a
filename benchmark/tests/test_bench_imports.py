"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the measured package: every module's
imports, walked by AST, top-level names compared whole."""

import ast
import json
import os

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "webp_tpu"}
PROGRAM = "webp_tpu_torch"


def modules():
    for d, _, files in os.walk(BENCH):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(d, f), BENCH)


def top_level_imports(path):
    with open(os.path.join(BENCH, path)) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module.split(".", 1)[0]


def test_the_walk_finds_the_benchmark():
    found = list(modules())
    assert "run.py" in found
    assert os.path.join("reference", "vp8ref", "ops", "fastpath.py") in found
    assert any(p.startswith("metrics" + os.sep) for p in found)


@pytest.mark.parametrize("path", sorted(modules()))
def test_no_jax(path):
    bad = set(top_level_imports(path)) & FORBIDDEN
    assert not bad, f"{path} imports {sorted(bad)}"


@pytest.mark.parametrize("path", sorted(
    p for p in modules() if p.startswith("reference" + os.sep)))
def test_reference_imports_nothing_of_the_program(path):
    names = set(top_level_imports(path))
    assert PROGRAM not in names, f"{path} imports {PROGRAM}"
    assert "benchmark" not in names or path.endswith("__init__.py"), \
        f"{path} reaches outside the reference"


def test_each_reference_a_configuration_names_is_walked():
    from benchmark.harness.check import reference_modules

    root = os.path.dirname(BENCH)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        configs = json.load(f)["configs"]
    walked = set(modules())
    for c in configs:
        with open(os.path.join(root, c["file"])) as f:
            names = reference_modules(json.load(f)).values()
        for name in names:
            assert os.path.join("reference", name + ".py") in walked


def test_the_comparison_is_by_whole_names():
    # webp_tpu_torch begins with webp_tpu's name and is allowed.
    assert "webp_tpu_torch".split(".", 1)[0] not in FORBIDDEN
    assert "webp_tpu.encoder".split(".", 1)[0] in FORBIDDEN
