"""The port, its chip smoke script and its card-only tests import nothing of
JAX, of the JAX package, or of the HF tokenizer stack (the machine with the
card has none of them)."""

from __future__ import annotations

import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "chex", "parler_tts_tpu", "transformers", "tokenizers"}
# chip_smoke.py and the card-only tests run on a machine without JAX
SOURCES = sorted((REPO / "parler_tts_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tests" / "test_torch_cuda.py"]


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax_and_no_jax_package(path):
    assert not _imported_roots(path) & FORBIDDEN


def test_the_walk_sees_the_whole_port():
    assert len(SOURCES) > 15 and (REPO / "chip_smoke.py").exists()
    assert _imported_roots(REPO / "tests" / "test_torch_blocks.py") >= {"jax", "parler_tts_tpu", "torch"}
