"""Tangent frames, and joint normal + BRDF fitting: per-texel normal offsets
fitted together with the material parameters.

Port of ``brdf_tpu/models/normalmap.py``. :func:`tangent_basis` is the
canonical per-normal orthonormal frame in which ``ward_aniso`` and
``cook_torrance_aniso`` measure their tangent-frame angle channels. In the
joint model each texel carries a 2-DOF tangent-space offset ``(nu, nv)``; the
shading normal is ``normalize(N + nu·T + nv·B)``, differentiable, so the LM
solver fits geometry and material together. The three channels share the
normal and the shape, so the parameter vector is

    [kd_r, kd_g, kd_b, ks_r, ks_g, ks_b, shape…, nu, nv]      (m = 8 + k)

with k = 1 shape parameter for the isotropic (kd, ks, shape) lobes (m = 9)
and k = 3 for the anisotropic ones (m = 11), and the residual stacks 3·V
measurements. The offset parameterisation keeps the normal unit-length by
construction, so the box on ``(nu, nv)`` only bounds the tilt angle.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from brdf_tpu_torch.models.brdf import (
    MODELS,
    ShadingAngles,
    ShadingGeometry,
    _max,
    angles_from_geometry,
)


def tangent_basis(n: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Orthonormal (T, B) frame for unit normals ``n`` (..., 3), branchless
    (Duff et al. construction)."""
    # components keep a last axis of one: a Python scalar combined with a
    # per-sample scalar under vmap + forward-mode AD gives a float64 tangent
    nx, ny, nz = n[..., 0:1], n[..., 1:2], n[..., 2:3]
    one = torch.ones_like(nz)
    sign = torch.where(nz >= 0, one, -one)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = torch.cat([1.0 + sign * nx ** 2 * a, sign * b, -sign * nx], dim=-1)
    bt = torch.cat([b, sign + ny ** 2 * a, -ny], dim=-1)
    return t, bt


# copied from brdf_tpu/models/normalmap.py (host numpy)
def tangent_basis_np(n):
    """Numpy twin of :func:`tangent_basis` for host-side problem building."""
    n = np.asarray(n)
    sign = np.where(n[..., 2] >= 0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = np.stack([1.0 + sign * n[..., 0] ** 2 * a, sign * b, -sign * n[..., 0]], axis=-1)
    bt = np.stack([b, sign + n[..., 1] ** 2 * a, -n[..., 1]], axis=-1)
    return t, bt


class JointSpec(NamedTuple):
    base_model: str
    n_params: int
    lower: tuple
    upper: tuple
    n_shape: int = 1


def joint_spec(base_model: str = "cook_torrance", max_tilt: float = 0.6) -> JointSpec:
    """Joint parameter layout ``[kd_rgb (3), ks_rgb (3), shape (k), nu, nv]``
    with k the base lobe's shape-parameter count: m = 9 for the m=3 isotropic
    lobes (shape at column 6, offsets at 7/8) and m = 11 for the m=5
    anisotropic lobes (rough_x/rough_y/phi at columns 6-8, offsets at 9/10)."""
    base = MODELS[base_model]
    if base.linear != 2:
        raise ValueError(
            "joint fit needs a (kd, ks, shape...) base lobe; "
            f"{base_model!r} has linear={base.linear}"
        )
    k = base.n_params - 2
    lo = ((base.lower[0],) * 3 + (base.lower[1],) * 3 + tuple(base.lower[2:])
          + (-max_tilt, -max_tilt))
    hi = ((base.upper[0],) * 3 + (base.upper[1],) * 3 + tuple(base.upper[2:])
          + (max_tilt, max_tilt))
    return JointSpec(base_model, 8 + k, lo, hi, n_shape=k)


def perturbed_angles(
    geom: ShadingGeometry, nu: torch.Tensor, nv: torch.Tensor, tangent_frame: bool = False,
) -> ShadingAngles:
    """Recompute the cosine terms with the tangent-space-perturbed normal.
    ``nu``/``nv`` broadcast against the batch dims of ``geom.n``.
    ``tangent_frame=True`` also fills the tangent channels the anisotropic
    lobes need; the frame is re-derived from the perturbed normal, so the
    fitted ``phi`` orients the material axes in the fitted surface frame."""
    t, b = tangent_basis(geom.n)
    n_new = geom.n + nu[..., None] * t + nv[..., None] * b
    n_new = n_new / _max(torch.linalg.vector_norm(n_new, dim=-1, keepdim=True), 1e-12)
    return angles_from_geometry(geom._replace(n=n_new), tangent_frame=tangent_frame)


def joint_eval(spec: JointSpec, params: torch.Tensor, geom: ShadingGeometry) -> torch.Tensor:
    """Evaluate the joint model: params (..., 8+k) → intensities (..., V, 3)."""
    base = MODELS[spec.base_model]
    k = spec.n_shape
    ang = perturbed_angles(geom, params[..., 6 + k], params[..., 7 + k],
                           tangent_frame=base.tangent)
    outs = []
    for c in range(3):
        p_c = torch.cat([params[..., c:c + 1], params[..., 3 + c:4 + c], params[..., 6:6 + k]],
                        dim=-1)
        outs.append(base.fn(p_c, ang))
    return torch.stack(outs, dim=-1)   # (..., V, 3)


def joint_residual(spec: JointSpec):
    """Residual closure for the LM solver: data = (geom, target (V, 3), w).

    ``w`` is (V,) shared across channels, or (V, 3) per channel: the channels
    are independent measurements, so per-channel saturation masks and IRLS
    weights reach the joint fit per channel."""

    def residual(p, data):
        geom, target, w = data
        pred = joint_eval(spec, p, geom)
        wb = w if w.ndim == target.ndim else w[..., None]
        return ((pred - target) * wb).reshape(-1)

    return residual


def joint_p0_from_channelwise(
    channel_params: torch.Tensor,  # (..., 3, m_base): per-channel (kd, ks, shape…)
) -> torch.Tensor:
    """A joint start from independent per-channel fits: kd/ks carry over, the
    shape parameter(s) average over the channels, the normal offset starts at
    0. Works for any base-lobe shape count (m=3 → 9 joint params, m=5 → 11)."""
    kd = channel_params[..., :, 0]
    ks = channel_params[..., :, 1]
    shape = torch.mean(channel_params[..., :, 2:], dim=-2)   # (..., k)
    zeros = torch.zeros_like(shape[..., :1])
    return torch.cat([kd, ks, shape, zeros, zeros], dim=-1)
