"""The lobes the benchmark's configurations state, in plain torch, in any
float dtype: the cosines of a (point, normal, eye, light) and the two
lobes, with the program's documented clamps (the specular term masked
below the horizon). Also the joint model's tilted normal. Imports nothing
of the program; the scan generator renders with these, never with the
program's renderer.
"""

from __future__ import annotations

import math

import torch

EPS = 1e-12


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=EPS)


def directions(points, eye, lights):
    """Unit vectors to the lights and to the eye, each (..., V, 3)."""
    l = _unit(lights - points[..., None, :])
    return l, _unit(eye - points)[..., None, :].expand(l.shape)


def cosines(points, normals, eye, lights) -> dict:
    """points, normals (..., 3), eye (3,), lights (V, 3) → the four cosines
    (N·L, N·H, R·V, N·V), each (..., V)."""
    return cosines_of(normals, *directions(points, eye, lights))


def cosines_of(normals, l, v) -> dict:
    """The cosines of unit normals (..., 3) with unit l, v (..., V, 3)."""
    n = normals[..., None, :]
    h = _unit(l + v)
    ln = (n * l).sum(-1)
    r = 2.0 * ln[..., None] * n - l
    return dict(ln=ln, nh=(n * h).sum(-1), rv=(r * v).sum(-1), vn=(n * v).sum(-1))


def blinn_phong(kd, ks, shape, c: dict) -> torch.Tensor:
    """kd·max(N·L, 0) + ks·max(N·H, 0)^n, the specular term where N·L > 0;
    parameters broadcast against the (..., V) cosines."""
    nh = c["nh"]
    spec = torch.where(nh > 0, torch.pow(torch.clamp(nh, min=EPS), shape), torch.zeros_like(nh))
    return kd * torch.clamp(c["ln"], min=0.0) + ks * spec * (c["ln"] > 0)


def cook_torrance(kd, ks, rough, c: dict) -> torch.Tensor:
    """kd/π·⟨N·L⟩ + ks·D·Vis·⟨N·L⟩: GGX D with α = roughness² (roughness
    floored at 1e-3), height-correlated Smith visibility."""
    r = torch.clamp(rough, min=1e-3)
    a2 = (r * r) ** 2
    nl = torch.clamp(c["ln"], min=0.0)
    nv = torch.clamp(c["vn"], min=EPS)
    nh = torch.clamp(c["nh"], min=0.0)
    den = nh * nh * (a2 - 1.0) + 1.0
    d = a2 / torch.clamp(math.pi * den * den, min=EPS)
    lam_v = nl * torch.sqrt(nv * nv * (1.0 - a2) + a2)
    lam_l = nv * torch.sqrt(nl * nl * (1.0 - a2) + a2)
    vis = 0.5 / torch.clamp(lam_v + lam_l, min=EPS)
    return kd / math.pi * nl + ks * d * vis * nl * (nl > 0)


LOBES = {"blinn_phong": blinn_phong, "cook_torrance": cook_torrance}


def tangent_frame(n: torch.Tensor):
    """The branchless orthonormal frame (Duff et al.) of unit normals (..., 3)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(nz >= 0, torch.ones_like(nz), -torch.ones_like(nz))
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    t = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], -1)
    bt = torch.stack([b, sign + ny * ny * a, -ny], -1)
    return t, bt


def tilted(n: torch.Tensor, nu: torch.Tensor, nv: torch.Tensor) -> torch.Tensor:
    """normalize(N + nu·T + nv·B) in N's tangent frame."""
    t, b = tangent_frame(n)
    return _unit(n + nu[..., None] * t + nv[..., None] * b)
