"""The module check compares top-level names whole: `humanrf_torch` begins
with the JAX package's name and is not it."""
import sys
import types

import pytest

from hrfbench import harness


@pytest.mark.parametrize("name,flagged", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("humanrf_tpu", True), ("humanrf_tpu.models.humanrf", True),
    ("humanrf_torch", False), ("humanrf_torch.train.trainer", False), ("jaxtyping", False),
    ("humanrf_tpux", False), ("hrfbench.jax", False),
])
def test_forbidden_modules_by_whole_top_level_name(monkeypatch, name, flagged):
    for m in [m for m in sys.modules if m.split(".")[0] in harness.FORBIDDEN_MODULES]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (name in harness.forbidden_modules()) == flagged


def test_the_harness_and_reference_import_no_forbidden_module():
    import ast

    for path in harness.BENCH_DIR.rglob("*.py"):
        if "tests" in path.parts:
            continue
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) else []
            for n in names:
                assert n.split(".")[0] not in harness.FORBIDDEN_MODULES, (path, n)
                if path.parts[-2] in ("reference", "scene", "counts"):
                    assert n.split(".")[0] != "humanrf_torch", (path, n)
