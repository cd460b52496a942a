"""The port, its chip smoke script, its card-only tests, its multi-process
test worker, its reference checkpoint converter and its examples import
nothing of JAX, of the JAX package, of the HF stack or of ``safetensors``
(the machine with the card has none of them); ``datasets`` only inside
``load_multiple_datasets``."""

from __future__ import annotations

import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "chex", "parler_tts_tpu", "transformers", "tokenizers",
             "safetensors"}
# chip_smoke.py, the card-only tests, the reference converter and the port's
# examples run on a machine without JAX, transformers or safetensors
SOURCES = sorted((REPO / "parler_tts_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tests" / "test_torch_cuda.py", REPO / "tests" / "torch_multiprocess_worker.py",
    REPO / "helpers" / "convert_reference_checkpoint_torch.py"] + sorted((REPO / "examples").glob("*_torch.py"))


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
    port = REPO / "parler_tts_tpu_torch"
    assert {port / "serving" / "batcher.py", port / "generation" / "streaming.py", port / "models" / "encodec.py",
            port / "core" / "from_reference.py", port / "utils" / "tokenizer.py", port / "utils" / "profiling.py",
            port / "parallel" / "distributed.py", port / "parallel" / "mesh.py", port / "parallel" / "tensor_parallel.py",
            REPO / "examples" / "generate_speech_torch.py", REPO / "examples" / "stream_speech_torch.py",
            REPO / "examples" / "finetune_torch.py"} <= set(SOURCES)
    assert _imported_roots(REPO / "tests" / "test_torch_blocks.py") >= {"jax", "parler_tts_tpu", "torch"}


def test_datasets_is_imported_only_inside_load_multiple_datasets():
    """The card's machine has no ``datasets``: no module imports it at its
    top; the one function that needs it imports it."""
    def imports_datasets(node) -> bool:
        return ((isinstance(node, ast.Import) and any(a.name.split(".")[0] == "datasets" for a in node.names))
                or (isinstance(node, ast.ImportFrom) and (node.module or "").split(".")[0] == "datasets"))

    inside, everywhere = [], 0
    for path in SOURCES:
        tree = ast.parse(path.read_text(), filename=str(path))
        everywhere += sum(imports_datasets(node) for node in ast.walk(tree))
        for fn in ast.walk(tree):
            if isinstance(fn, ast.FunctionDef):
                inside += [(path.name, fn.name) for node in ast.walk(fn) if imports_datasets(node)]
    assert inside == [("data.py", "load_multiple_datasets")] and everywhere == 1
