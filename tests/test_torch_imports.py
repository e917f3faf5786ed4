"""The port imports neither JAX nor the JAX package, anywhere: an AST scan
of ``brdf_tpu_torch/**/*.py``, ``chip_smoke.py`` and ``tools/*.py``."""

import ast
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "brdf_tpu")


def _port_files():
    return (sorted((ROOT / "brdf_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "tools").glob("*.py")))


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
    # ... and those of the render path and its host modules
    assert {"brdf_tpu_torch/io/obj.py", "brdf_tpu_torch/io/cal.py", "brdf_tpu_torch/io/images.py",
            "brdf_tpu_torch/geometry/mesh.py", "brdf_tpu_torch/geometry/camera.py",
            "brdf_tpu_torch/geometry/rasterize.py", "brdf_tpu_torch/geometry/texel.py",
            "brdf_tpu_torch/native.py", "brdf_tpu_torch/pipeline/scene.py",
            "brdf_tpu_torch/pipeline/render.py"} <= names
    # ... and those of the chunked LM tier and the joint normal-map tier
    assert {"brdf_tpu_torch/ops/ne.py", "brdf_tpu_torch/pipeline/diagnostics.py",
            "brdf_tpu_torch/solver/varpro_joint.py"} <= names
    assert {"ne.cu", "joint_ne.cu"} <= {f.name for f in (ROOT / "brdf_tpu_torch/csrc").iterdir()}


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


def test_render_path_modules_import_without_building_or_loading():
    """A fresh interpreter imports every module of the render path: no
    ``jax``, no JAX package, no PIL (the image reader imports it when it
    reads), no shared library loaded, nothing compiled, no launch counted."""
    import subprocess
    import sys

    code = """
import sys
import brdf_tpu_torch
for mod in ("io", "io.obj", "io.cal", "io.images", "geometry", "geometry.mesh", "geometry.camera",
            "geometry.rasterize", "geometry.texel", "native", "pipeline", "pipeline.scene",
            "pipeline.render", "pipeline.fit", "ops.shading", "convert"):
    __import__("brdf_tpu_torch." + mod)
from brdf_tpu_torch import native
from brdf_tpu_torch.ops import _build, shading
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "brdf_tpu", "PIL", "triton")]
assert not bad, bad
assert "shade" in _build.SOURCES and not _build.BUILD_LOGS
assert _build.load.cache_info().currsize == 0 and native.load.cache_info().currsize == 0
assert shading.SHADE_LAUNCHES == {"fwd": 0, "bwd_params": 0, "bwd_angles": 0}
print("clean")
"""
    env = {k: v for k, v in __import__("os").environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("clean"), out.stderr[-2000:]


def test_joint_tier_modules_import_without_building_or_loading():
    """A fresh interpreter imports the chunked LM tier and the joint
    normal-map tier, and the names their packages export: no ``jax``, no JAX
    package, no ``triton``, no shared library loaded, nothing compiled, no
    launch and no loop pass counted."""
    import subprocess
    import sys

    code = """
import sys
import brdf_tpu_torch
for mod in ("ops", "ops.ne", "ops.lm", "models", "models.normalmap", "solver", "solver.varpro_joint",
            "pipeline", "pipeline.diagnostics", "pipeline.fit", "parallel.fit", "convert"):
    __import__("brdf_tpu_torch." + mod)
from brdf_tpu_torch import native
from brdf_tpu_torch.models import MODELS, ShadingGeometry, shading_geometry
from brdf_tpu_torch.ops import (PALLAS_MODELS, SHADING_KERNELS, _build, joint_value_and_grad,
                                lm_fit_chunked, lm_fit_fused, lm_fit_joint_chunked, ne, shade,
                                shading_value_and_grad)
from brdf_tpu_torch.pipeline import fit_joint_normalmap, fit_per_texel
from brdf_tpu_torch.solver import (JointVarProResult, LMOptions, VarProResult, levmar_bc, varpro_fit,
                                   varpro_fit_joint)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "brdf_tpu", "PIL", "triton")]
assert not bad, bad
assert {"ne", "joint_ne"} <= set(_build.SOURCES) and not _build.BUILD_LOGS
assert _build.load.cache_info().currsize == 0 and native.load.cache_info().currsize == 0
assert _build.lookup.cache_info().currsize == 0
assert ne.LAUNCHES == {"ne": 0, "joint_ne": 0, "lm_step": 0} and ne.LOOP_SYNCS == 0
assert "lm_step" in _build.SOURCES
print("clean")
"""
    env = {k: v for k, v in __import__("os").environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("clean"), out.stderr[-2000:]


def test_varpro_nd_modules_import_without_building_or_loading():
    """A fresh interpreter imports the fused d-D VarPro tier (kernel K8) and
    the eager d-D tiers: no ``jax``, no JAX package, no ``triton``, no shared
    library loaded, nothing compiled, no launch counted; ``varpro_nd`` is
    among the sources that ``_build`` compiles."""
    import subprocess
    import sys

    assert (ROOT / "brdf_tpu_torch/csrc/varpro_nd.cu").exists()
    code = """
import sys
import brdf_tpu_torch
for mod in ("ops.varpro_nd", "solver.varpro", "parallel.fit", "pipeline.fit"):
    __import__("brdf_tpu_torch." + mod)
from brdf_tpu_torch.ops import _build, varpro_nd
from brdf_tpu_torch.solver import varpro_fit_fresnel
from brdf_tpu_torch.solver.varpro import (_SEPARABLE_ND, _nnls3, _solve_damped_sym, varpro_fit_fresnel_lin,
                                          varpro_fit_nd)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "brdf_tpu", "PIL", "triton")]
assert not bad, bad
assert "varpro_nd" in _build.SOURCES and not _build.BUILD_LOGS
assert _build.load.cache_info().currsize == 0 and _build.lookup.cache_info().currsize == 0
assert varpro_nd.LAUNCHES == 0
assert set(_SEPARABLE_ND) == {"cook_torrance_fresnel", "ward_aniso", "cook_torrance_aniso"}
print("clean")
"""
    env = {k: v for k, v in __import__("os").environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("clean"), out.stderr[-2000:]


def test_entry_points_of_the_joint_tier_need_a_device_or_say_so():
    """``fit_joint_normalmap`` and ``fit_joint_normalmap_with_gains`` go through
    ``resolve_device``: with no card and no ``device=`` they raise. The
    wrappers of K6 and K7 refuse a CPU tensor when asked for the kernel."""
    import numpy as np
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device would run")
    from brdf_tpu_torch.models.brdf import ShadingGeometry
    from brdf_tpu_torch.ops import ne
    from brdf_tpu_torch.pipeline import fit

    geom = ShadingGeometry(n=np.zeros((2, 3), np.float32), l=np.zeros((2, 4, 3), np.float32),
                           v=np.zeros((2, 4, 3), np.float32))
    prob = fit.TexelProblem(angles=None, intensity=np.zeros((2, 4, 3), np.float32),
                            weights=np.ones((2, 4), np.float32), face_ids=np.arange(2), geometry=geom)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit.fit_joint_normalmap(prob)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit.fit_joint_normalmap_with_gains(prob, rounds=0)
    z = torch.zeros(1, 4, 2)
    with pytest.raises(ValueError, match="CUDA"):
        ne.ne_rows_cuda("lambert", "chi2", z, z[0], None, torch.zeros(1, 2))
    assert ne.LAUNCHES == {"ne": 0, "joint_ne": 0, "lm_step": 0}


def test_entry_points_of_the_render_path_need_a_device_or_say_so():
    """Every entry point added with the render path goes through
    ``resolve_device``: with no card and no ``device=`` it raises."""
    import numpy as np
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device would run")
    from brdf_tpu_torch.pipeline import fit, render

    z = np.zeros((2, 3), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render.render_pixels("lambert", np.zeros((2, 3, 1), np.float32), z, z, z[0], z)
    prob = fit.TexelProblem(angles=None, intensity=np.zeros((2, 4, 3)), weights=np.ones((2, 4)),
                            face_ids=np.arange(2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit.fit_quality_metrics(prob, np.zeros((2, 3, 1)), "lambert")


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_jax_package(path):
    bad = [f"{path.name}:{line} imports {name}" for line, name in _imports(path) if _forbidden(name)]
    assert not bad, bad


def test_the_scan_tells_the_packages_apart():
    assert _forbidden("brdf_tpu") and _forbidden("brdf_tpu.models.brdf")
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert not _forbidden("brdf_tpu_torch") and not _forbidden("brdf_tpu_torch.ops")
    assert not _forbidden("jaxtyping")
