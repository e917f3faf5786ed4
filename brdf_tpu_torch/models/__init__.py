"""Shading models: angle channels, the ten lobes, the MODELS registry and
the joint normal-map model."""

from brdf_tpu_torch.models.brdf import (  # noqa: F401
    MODELS,
    ModelSpec,
    ShadingAngles,
    ShadingGeometry,
    shading_angles,
    shading_geometry,
)
