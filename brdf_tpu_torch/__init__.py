"""brdf_tpu_torch — the BRDF-fitting system in PyTorch for one NVIDIA H100.

A second package beside ``brdf_tpu`` (JAX/Pallas on a TPU), held against it
by the ``tests/test_torch_*.py`` suite. It mirrors ``brdf_tpu``'s layout so
that every module's counterpart is found by the same path:

- ``models``   — shading angles and the ten analytic lobes (torch autograd).
- ``solver``   — the levmar family (box, equality and inequality constrained
  LM, the Ax=b suite, fit statistics, golden problems), grid init, robust
  IRLS weights and the unfused VarPro tiers (per channel and joint).
- ``ops``      — hand-written CUDA kernels for Hopper (``csrc/``), each with
  its plain PyTorch version beside it and a launch counter, and the eager LM
  loop around the normal-equation kernels.
- ``parallel`` — :func:`fit_texels`, the single-GPU fit program
  (init → fit → IRLS rounds).
- ``geometry`` — meshes, cameras, rasterization, texelization and
  cast-shadow visibility (host NumPy).
- ``pipeline`` — :func:`fit_per_texel`, the per-texel × channel fit,
  ``fit_joint_normalmap``, ``fit_single_material``, the scene → problem
  builders, the renderers and environment-map relighting.
- ``utils``    — checkpoint / resume (the JAX package's format), structured
  event logs and timers.
- ``cli``      — ``python -m brdf_tpu_torch``, the JAX package's command line
  over ``configs``' presets, with ``--device``.
- ``convert``  — numpy ↔ port state, so both packages start from one state.

It never imports ``jax`` or ``brdf_tpu``. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``, and raise when no GPU is present.
"""

__version__ = "0.1.0"

from brdf_tpu_torch.models.brdf import (  # noqa: F401
    MODELS,
    ShadingAngles,
    brdf_eval,
    shading_angles,
)
from brdf_tpu_torch.parallel.fit import fit_texels  # noqa: F401
from brdf_tpu_torch.pipeline.fit import FitReport, TexelProblem, fit_per_texel  # noqa: F401
from brdf_tpu_torch.solver.lm import (  # noqa: F401
    LMOptions,
    LMResult,
    StopReason,
    levmar,
    levmar_bc,
)
