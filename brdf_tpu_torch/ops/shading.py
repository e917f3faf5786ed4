"""Analytic lobe library (value, ∂I/∂params, ∂I/∂angles in one pass).

Port of ``brdf_tpu/ops/shading_pallas.py::SHADING_KERNELS`` for the four
separable lobes (``_blinn_phong_full``, ``_phong_full``,
``_ct_core``/``_cook_torrance_full``, ``_ward_full``). Two forms, kept
operation for operation alike:

- the plain PyTorch functions below, on ``(V, T)`` tensors (the CPU path,
  and the version the CUDA kernels are held against);
- ``csrc/lobes.cuh``, scalar ``__device__`` functions that every kernel of
  the port includes. They launch nothing by themselves; the fused VarPro
  kernel (``ops/varpro.py``) calls them per (view, texel).

Each partial matches ``models/brdf.py`` including its clamp and mask
subgradient conventions. Masks select (``torch.where``) wherever the
masked branch could hold an ``inf`` that a multiply would turn into NaN.

Every operation is one whose float32 rounding is the same in PyTorch's CUDA
kernels and in ``lobes.cuh`` (built without FMA contraction): a division by
a constant is a multiply by its float32 reciprocal, and ``c / x`` is
``reciprocal(x) * c``, which is what PyTorch computes for it. The fused
solve is chaotic at the last bit (a one-ulp change of the input moves a few
percent of lanes by more than 1e-4), so the kernel is held against this
version on the card lane for lane only because the two round alike.
The other six lobes come with the kernels that use them (ROADMAP.md).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

_EPS = 1e-12
_INV_PI = 1.0 / math.pi
_INV_TWO_PI = 1.0 / (2.0 * math.pi)


class ShadingKernelSpec(NamedTuple):
    name: str
    n_params: int
    angle_names: tuple[str, ...]
    # eval(angles: tuple[(V,T)], params: tuple[(1,T)])
    #   -> (I (V,T), d_params tuple[(V,T)], d_angles tuple[(V,T)])
    eval: Callable
    lobe_id: int          # the LOBE_* selector of csrc/lobes.cuh


def _f(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.to(like.dtype)


def _blinn_phong_full(angles, params):
    cl, cnh = angles
    kd, ks, n = params
    lit = cl > 0
    diff_b = torch.clamp(cl, min=0.0)
    ln_s = torch.log(torch.clamp(cnh, min=_EPS))
    m = lit & (cnh > 0)
    zero = torch.zeros_like(ln_s)
    pw = torch.where(m, torch.exp(n * ln_s), zero)
    pw_m1 = torch.where(m, torch.exp((n - 1.0) * ln_s), zero)
    i_val = kd * diff_b + ks * pw
    return i_val, (diff_b, pw, ks * ln_s * pw), (kd * _f(lit, cl), ks * n * pw_m1)


def _phong_full(angles, params):
    cl, crv = angles
    kd, ks, n = params
    lit = cl > 0
    diff_b = torch.clamp(cl, min=0.0)
    ln_s = torch.log(torch.clamp(crv, min=_EPS))
    m = lit & (crv > 0)
    zero = torch.zeros_like(ln_s)
    pw = torch.where(m, torch.exp(n * ln_s), zero)
    pw_m1 = torch.where(m, torch.exp((n - 1.0) * ln_s), zero)
    norm = (n + 2.0) * _INV_TWO_PI
    i_val = kd * diff_b + ks * norm * pw
    d_n = ks * (pw * _INV_TWO_PI + norm * ln_s * pw)
    return i_val, (diff_b, norm * pw, d_n), (kd * _f(lit, cl), ks * norm * n * pw_m1)


def _ct_core(cl, cnh, cvn, ks, rough):
    """Cook-Torrance specular core ``S = ks·D·vis·nl·[nl>0]`` and its partials
    w.r.t. (rough, cl, cnh, cvn); clamp for clamp like ``models/brdf.py``."""
    nl = torch.clamp(cl, min=0.0)
    nv = torch.clamp(cvn, min=_EPS)
    nh = torch.clamp(cnh, min=0.0)
    r = torch.clamp(rough, min=1e-3)
    r2 = r * r
    a2 = r2 * r2

    u = nh * nh * (a2 - 1.0) + 1.0
    du = math.pi * u * u
    d_clamped = du <= _EPS
    du_s = torch.clamp(du, min=_EPS)
    d = a2 / du_s
    # guarded so the dead branch cannot make inf·0 NaNs at grazing nh
    inv_u = torch.where(d_clamped, torch.zeros_like(u), torch.reciprocal(torch.clamp(u, min=_EPS)))
    dd_da2 = torch.reciprocal(du_s) - 2.0 * a2 * nh * nh * inv_u / du_s
    dd_dnh = -(2.0 * a2 * inv_u / du_s) * 2.0 * nh * (a2 - 1.0)

    sv = torch.sqrt(nv * nv * (1.0 - a2) + a2)
    sl = torch.sqrt(nl * nl * (1.0 - a2) + a2)
    den_raw = nl * sv + nv * sl
    den = torch.clamp(den_raw, min=_EPS)
    vis = torch.reciprocal(den) * 0.5
    dden = torch.reciprocal(den * den) * -0.5 * (1.0 - _f(den_raw <= _EPS, cl))
    sv_s = torch.clamp(sv, min=_EPS)
    sl_s = torch.clamp(sl, min=_EPS)
    dvis_dnl = dden * (sv + nv * nl * (1.0 - a2) / sl_s)
    dvis_dnv = dden * (nl * nv * (1.0 - a2) / sv_s + sl)
    dvis_da2 = dden * (nl * (1.0 - nv * nv) / (2.0 * sv_s) + nv * (1.0 - nl * nl) / (2.0 * sl_s))

    lit = _f(nl > 0, cl)
    core = d * vis * nl * lit
    s_val = ks * core
    da2_dr = 4.0 * r2 * r
    live_r = _f(rough > 1e-3, cl)
    ds_drough = ks * (dd_da2 * vis + d * dvis_da2) * nl * lit * da2_dr * live_r
    ds_dcl = ks * (d * (vis + nl * dvis_dnl)) * lit * _f(cl > 0, cl)
    ds_dcnh = ks * dd_dnh * vis * nl * lit * _f(cnh > 0, cl)
    ds_dcvn = ks * d * nl * dvis_dnv * lit * _f(cvn > _EPS, cl)
    return s_val, core, nl, ds_drough, ds_dcl, ds_dcnh, ds_dcvn


def _cook_torrance_full(angles, params):
    cl, cnh, cvn = angles
    kd, ks, rough = params
    s_val, core, nl, ds_dr, ds_dcl, ds_dcnh, ds_dcvn = _ct_core(cl, cnh, cvn, ks, rough)
    i_val = kd * _INV_PI * nl + s_val
    d_cl = kd * _INV_PI * _f(cl > 0, cl) + ds_dcl
    return i_val, (_INV_PI * nl, core, ds_dr), (d_cl, ds_dcnh, ds_dcvn)


def _ward_full(angles, params):
    cl, cnh, cvn = angles
    kd, ks, alpha = params
    nl = torch.clamp(cl, min=0.0)
    nv = torch.clamp(cvn, min=_EPS)
    nh = torch.clamp(cnh, min=1e-4)
    a = torch.clamp(alpha, min=1e-3)
    a2 = a * a
    tan2 = (1.0 - nh * nh) / (nh * nh)
    lobe = torch.exp(-tan2 / a2) / (4.0 * math.pi * a2)
    lit = _f((cl > 0) & (cnh > 0) & (cvn > 0), cl)
    rt = torch.sqrt(nl / nv)
    spec_b = rt * lobe * lit
    i_val = kd * _INV_PI * nl + ks * spec_b
    d_a = ks * spec_b * 2.0 * (tan2 - a2) / (a2 * a) * _f(alpha > 1e-3, cl)
    d_cl = kd * _INV_PI * _f(cl > 0, cl) \
        + ks * lobe * lit / (2.0 * torch.sqrt(torch.clamp(nl * nv, min=_EPS))) * _f(cl > 0, cl)
    d_cnh = ks * rt * lobe * lit * (torch.reciprocal(nh * nh * nh * a2) * 2.0) * _f(cnh > 1e-4, cl)
    d_cvn = ks * lobe * lit * (-0.5) * rt / nv * _f(cvn > _EPS, cl)
    return i_val, (_INV_PI * nl, spec_b, d_a), (d_cl, d_cnh, d_cvn)


SHADING_KERNELS: dict[str, ShadingKernelSpec] = {
    "blinn_phong": ShadingKernelSpec("blinn_phong", 3, ("cos_ln", "cos_nh"), _blinn_phong_full, 0),
    "phong": ShadingKernelSpec("phong", 3, ("cos_ln", "cos_rv"), _phong_full, 1),
    "cook_torrance": ShadingKernelSpec(
        "cook_torrance", 3, ("cos_ln", "cos_nh", "cos_vn"), _cook_torrance_full, 2),
    "ward": ShadingKernelSpec("ward", 3, ("cos_ln", "cos_nh", "cos_vn"), _ward_full, 3),
}
