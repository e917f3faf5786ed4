"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version."""

from brdf_tpu_torch.ops.lm import PALLAS_MODELS, lm_fit_fused  # noqa: F401
from brdf_tpu_torch.ops.ne import (  # noqa: F401
    joint_value_and_grad,
    lm_fit_chunked,
    lm_fit_joint_chunked,
    shading_value_and_grad,
)
from brdf_tpu_torch.ops.shading import SHADING_KERNELS, shade  # noqa: F401
