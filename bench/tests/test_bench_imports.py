"""No module of the benchmark imports JAX or the JAX package: each import's
top-level name, the part before the first dot, compared whole (so
``repro_torch`` passes and ``repro`` does not)."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "ml_dtypes"}


def top_level_imports(source: str) -> set:
    names = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, str):
            names.add(node.args[0].value.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    bad = top_level_imports(path.read_text()) & FORBIDDEN
    assert not bad, f"{path} imports {sorted(bad)}"


def test_the_check_compares_whole_names():
    src = "import repro_torch.x\nfrom repro_torch import y\nimport jax_like\n"
    assert not top_level_imports(src) & FORBIDDEN
    for bad in ("import repro\n", "from repro.core import x\n",
                "import jax.numpy as jnp\n", "import ml_dtypes\n",
                "importlib.import_module('repro.train')\n"):
        assert top_level_imports(bad) & FORBIDDEN, bad
