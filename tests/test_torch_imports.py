"""The port stands alone: no file of ``src/repro_torch/`` nor
``chip_smoke.py`` imports ``jax`` or the JAX package ``repro``."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_file_imports_no_jax_and_no_reference(path):
    assert path.exists(), path
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_tree_is_nonempty():
    assert len(PORT_FILES) > 10


def test_moe_slice_modules_are_checked():
    """The MoE slice's modules are among the files checked above."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("models/moe.py", "kernels/sr_cast.py",
                "configs/qwen3_moe_30b_a3b.py"):
        assert f"src/repro_torch/{mod}" in names, mod


def test_qadam_slice_modules_are_checked():
    """The QAdam / TrainLoop slice's modules are among the files checked
    above."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("checkpoint/manager.py", "train/loop.py", "health/inject.py",
                "optim/adam.py", "data/pipeline.py"):
        assert f"src/repro_torch/{mod}" in names, mod


def test_oracle_slice_modules_are_checked():
    """The oracle / packed slice's modules are among the files checked
    above."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("kernels/ops.py", "kernels/ref.py",
                "launch/split_agreement.py"):
        assert f"src/repro_torch/{mod}" in names, mod


def test_serving_slice_modules_are_checked():
    """The serving-engine slice's modules are among the files checked
    above."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("serving/__init__.py", "serving/paged_cache.py",
                "serving/engine.py", "launch/time_attention.py",
                "launch/compare_failed_sets.py"):
        assert f"src/repro_torch/{mod}" in names, mod


def test_paper_slice_modules_are_checked():
    """The paper-experiments slice's modules are among the files checked
    above."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("paper/convergence.py", "paper/paper_models.py",
                "paper/run.py", "core/qarith.py", "core/theory.py",
                "core/xla_math.py"):
        assert f"src/repro_torch/{mod}" in names, mod
