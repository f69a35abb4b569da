"""The port stands on its own: no module of `dqo_map_tpu_torch/`, and not
`chip_smoke.py`, imports `jax`, `jaxlib`, the JAX package `dqo_map_tpu`
or `PIL`, not even lazily inside a function: the card's machine has no
PIL, and the port reads and writes its PNG and JPEG files itself.
Checked on the source, by AST scan."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
SOURCES = sorted((ROOT / "dqo_map_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "dqo_map_tpu", "PIL")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_sources_found():
    names = {p.name for p in SOURCES}
    assert {"chip_smoke.py", "blend_cuda.py", "system.py"} <= names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"
