"""Tangent frames for the anisotropic lobes.

Port of ``brdf_tpu/models/normalmap.py::tangent_basis`` and its numpy twin:
the canonical per-normal orthonormal frame in which ``ward_aniso`` and
``cook_torrance_aniso`` measure their tangent-frame angle channels. The rest
of that module (the joint normal-map model) waits for ROADMAP.md Queue A
item 8.
"""

from __future__ import annotations

import numpy as np
import torch


def tangent_basis(n: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Orthonormal (T, B) frame for unit normals ``n`` (..., 3), branchless
    (Duff et al. construction)."""
    one = torch.ones_like(n[..., 2])
    sign = torch.where(n[..., 2] >= 0, one, -one)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + sign * n[..., 0] ** 2 * a, sign * b, -sign * n[..., 0]], dim=-1)
    bt = torch.stack([b, sign + n[..., 1] ** 2 * a, -n[..., 1]], dim=-1)
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
