"""The port, its chip smoke script, its card-only tests, its multi-process
test worker, its reference checkpoint converter, its model-init scripts,
its demo server, its push scripts and its examples import nothing of JAX,
of the JAX package, of the HF stack or of ``safetensors`` (the machine with
the card has none of them), but for the optional packages that one named
function each imports inside itself: ``datasets`` in
``load_multiple_datasets``, ``transformers`` in the WER and CLAP hooks'
constructors, ``gradio`` in the demo's ``run_gradio`` and
``huggingface_hub`` in the push scripts' ``main``.  The port's quality gate
imports nothing of JAX or the JAX package (``transformers`` only where it
runs the torch reference, which is built on it)."""

from __future__ import annotations

import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "chex", "parler_tts_tpu", "transformers", "tokenizers",
             "safetensors", "gradio", "huggingface_hub"}
# optional packages, each imported inside these functions (file, qualified name) and nowhere else
ADMITTED = {
    "transformers": {("eval_metrics.py", "WerMetric.__init__"), ("eval_metrics.py", "ClapMetric.__init__")},
    "gradio": {("app_torch.py", "run_gradio")},
    "huggingface_hub": {("push_trained_parler_tts_to_hub_torch.py", "main"), ("push_dac_to_hub_torch.py", "main")},
}
# chip_smoke.py, the card-only tests, the reference converter and the port's
# examples run on a machine without JAX, transformers or safetensors
SOURCES = sorted((REPO / "parler_tts_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tests" / "test_torch_cuda.py", REPO / "tests" / "test_torch_norm.py",
    REPO / "tests" / "torch_multiprocess_worker.py",
    REPO / "helpers" / "convert_reference_checkpoint_torch.py", REPO / "helpers" / "gradio_demo" / "app_torch.py",
] + [path for folder in ("examples", "helpers/model_init_scripts", "helpers/push_to_hub_scripts")
     for path in sorted((REPO / folder).glob("*_torch.py"))]
JAX = {"jax", "jaxlib", "flax", "optax", "orbax", "chex", "parler_tts_tpu"}


def _roots(node) -> list[str]:
    if isinstance(node, ast.Import):
        return [alias.name.split(".")[0] for alias in node.names]
    if isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
        return [node.module.split(".")[0]]
    return []


def _imported_roots(path: pathlib.Path) -> set[str]:
    return {root for node in ast.walk(ast.parse(path.read_text(), filename=str(path))) for root in _roots(node)}


def _imports_by_function(path: pathlib.Path) -> list[tuple[str, str | None]]:
    """(root, qualified name of the innermost enclosing function or None) of
    every import in ``path``."""
    found = []

    def visit(node, scope: tuple[str, ...], function: str | None):
        found.extend((root, function) for root in _roots(node))
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                inner = scope + (child.name,)
                visit(child, inner, ".".join(inner) if not isinstance(child, ast.ClassDef) else function)
            else:
                visit(child, scope, function)

    visit(ast.parse(path.read_text(), filename=str(path)), (), None)
    return found


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax_and_no_jax_package(path):
    """Nothing forbidden, outside the functions ``ADMITTED`` names."""
    roots = {root for root, function in _imports_by_function(path)
             if (path.name, function) not in ADMITTED.get(root, ())}
    assert not roots & FORBIDDEN


def test_the_quality_gate_imports_no_jax_and_no_jax_package():
    path = REPO / "helpers" / "quality_gate_torch.py"
    assert not _imported_roots(path) & JAX and "parler_tts_tpu_torch" in _imported_roots(path)


def test_the_walk_sees_the_whole_port():
    assert len(SOURCES) > 15 and (REPO / "chip_smoke.py").exists()
    port = REPO / "parler_tts_tpu_torch"
    assert {port / "serving" / "batcher.py", port / "generation" / "streaming.py", port / "models" / "encodec.py",
            port / "core" / "from_reference.py", port / "utils" / "tokenizer.py", port / "utils" / "profiling.py",
            port / "parallel" / "distributed.py", port / "parallel" / "mesh.py", port / "parallel" / "tensor_parallel.py",
            REPO / "examples" / "generate_speech_torch.py", REPO / "examples" / "stream_speech_torch.py",
            REPO / "examples" / "finetune_torch.py", port / "utils" / "mel.py", port / "training" / "eval_metrics.py",
            REPO / "helpers" / "gradio_demo" / "app_torch.py"} <= set(SOURCES)
    assert {f"{name}_torch.py" for name in ("init_model_600M", "init_dummy_model", "init_dummy_model_with_encodec")} \
        <= {p.name for p in SOURCES}
    assert {f"{name}_torch.py" for name in ("push_trained_parler_tts_to_hub", "push_dac_to_hub")} \
        <= {p.name for p in SOURCES}
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


@pytest.mark.parametrize("package", sorted(ADMITTED))
def test_optional_packages_are_imported_only_inside_their_functions(package):
    """The card's machine has no ``transformers``, ``gradio`` or
    ``huggingface_hub``: each is imported by exactly the functions that
    need it (a hook's constructor, the gradio front end, a push), inside
    them, and nowhere else in the port."""
    where = [(path.name, function) for path in SOURCES for root, function in _imports_by_function(path)
             if root == package]
    assert sorted(where) == sorted(ADMITTED[package])
