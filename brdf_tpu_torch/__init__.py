"""brdf_tpu_torch — the BRDF-fitting system in PyTorch for one NVIDIA H100.

A second package beside ``brdf_tpu`` (JAX/Pallas on a TPU), held against it
by the ``tests/test_torch_*.py`` suite. It mirrors ``brdf_tpu``'s layout so
that every module's counterpart is found by the same path:

- ``models``   — shading angles and the ten analytic lobes (torch autograd).
- ``solver``   — grid init, robust IRLS weights, the unfused VarPro tiers
  (per channel and joint) and the eager box-constrained LM (:func:`levmar_bc`).
- ``ops``      — hand-written CUDA kernels for Hopper (``csrc/``), each with
  its plain PyTorch version beside it and a launch counter, and the eager LM
  loop around the normal-equation kernels.
- ``parallel`` — :func:`fit_texels`, the single-GPU fit program
  (init → fit → IRLS rounds).
- ``pipeline`` — :func:`fit_per_texel`, the per-texel × channel fit,
  ``fit_joint_normalmap``, the scene → problem builders and the renderers.
- ``utils``    — checkpoint / resume of a chunked fit (the JAX package's format).
- ``convert``  — numpy ↔ port state, so both packages start from one state.

It never imports ``jax`` or ``brdf_tpu``. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``, and raise when no GPU is present.
"""

__version__ = "0.1.0"

from brdf_tpu_torch.models.brdf import MODELS, ShadingAngles, shading_angles  # noqa: F401
from brdf_tpu_torch.parallel.fit import fit_texels  # noqa: F401
from brdf_tpu_torch.pipeline.fit import FitReport, TexelProblem, fit_per_texel  # noqa: F401
from brdf_tpu_torch.solver.lm import LMOptions, LMResult, StopReason, levmar_bc  # noqa: F401
