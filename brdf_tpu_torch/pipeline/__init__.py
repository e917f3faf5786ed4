"""Scene → problem → fit → image: the entry points a user calls."""

from brdf_tpu_torch.pipeline.scene import Scene, load_reference_scene  # noqa: F401
from brdf_tpu_torch.pipeline.fit import (  # noqa: F401
    FitReport,
    build_face_problem,
    build_pixel_problem,
    fit_joint_normalmap,
    fit_per_texel,
)
from brdf_tpu_torch.pipeline.render import render_image, render_pixels, relight  # noqa: F401
