"""The port imports neither JAX nor the JAX package, anywhere: an AST scan
of ``brdf_tpu_torch/**/*.py`` and ``chip_smoke.py``."""

import ast
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "brdf_tpu")


def _port_files():
    return sorted((ROOT / "brdf_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    """``jax``, ``jax.numpy``, ``brdf_tpu``, ``brdf_tpu.ops`` … but not
    ``brdf_tpu_torch``."""
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)):
            yield node.lineno, node.args[0].value


def test_port_files_exist():
    files = _port_files()
    assert (ROOT / "chip_smoke.py").exists()
    assert len(files) > 10
    names = {str(f.relative_to(ROOT)) for f in files}
    # the modules of the LM path are scanned with the rest
    assert {"brdf_tpu_torch/ops/lm.py", "brdf_tpu_torch/models/normalmap.py",
            "brdf_tpu_torch/utils/checkpoint.py", "brdf_tpu_torch/utils/__init__.py"} <= names


def test_new_modules_import_without_a_gpu_toolchain():
    """Importing the port builds nothing and needs neither nvcc nor triton."""
    import importlib
    import sys

    for mod in ("ops.lm", "ops.shading", "ops._build", "models.normalmap", "utils.checkpoint",
                "parallel.fit", "pipeline.fit", "convert"):
        importlib.import_module("brdf_tpu_torch." + mod)
    from brdf_tpu_torch.ops import _build, lm

    assert "triton" not in sys.modules
    assert set(_build.SOURCES) >= {"varpro", "lm"} and lm.LAUNCHES == 0
    assert not _build.BUILD_LOGS


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_jax_package(path):
    bad = [f"{path.name}:{line} imports {name}" for line, name in _imports(path) if _forbidden(name)]
    assert not bad, bad


def test_the_scan_tells_the_packages_apart():
    assert _forbidden("brdf_tpu") and _forbidden("brdf_tpu.models.brdf")
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert not _forbidden("brdf_tpu_torch") and not _forbidden("brdf_tpu_torch.ops")
    assert not _forbidden("jaxtyping")
