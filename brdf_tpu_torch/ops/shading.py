"""Analytic lobe library (value, ∂I/∂params, ∂I/∂angles in one pass).

Port of ``brdf_tpu/ops/shading_pallas.py::SHADING_KERNELS``, all ten lobes
(``_blinn_phong_full``, ``_phong_full``, ``_ct_core``/``_cook_torrance_full``,
``_cook_torrance_fresnel_full``, ``_lambert_full``, ``_minnaert_full``,
``_ward_full``, ``_oren_nayar_full``, ``_ward_aniso_full``,
``_cook_torrance_aniso_full``). Two forms, kept operation for operation
alike:

- the plain PyTorch functions below, on ``(V, T)`` tensors (the CPU path,
  and the version the CUDA kernels are held against);
- ``csrc/lobes.cuh``, scalar ``__device__`` functions that every kernel of
  the port includes. They launch nothing by themselves; the fused VarPro
  kernel (``ops/varpro.py``) and the fused LM kernel (``ops/lm.py``) call
  them per (view, texel) and read the value and ∂I/∂params, and the shading
  kernels below read one output each (∂I/∂angles in ``shade_bwd_angles``).
  ``csrc/lobes_eval.cu`` wraps them in a kernel of their own
  (:func:`shading_eval`) so that all three outputs of every lobe can be held
  against this file on the card at once.

On top of the library sit the forward shading kernel and its analytic
backward (``csrc/shade.cu``; K2, K3, K4 of ``brdf_tpu/ops/shading_pallas.py``):
:func:`shade` is ``shade_pallas``'s public contract, differentiable through
``torch.autograd`` to the parameters and to every angle channel the lobe
reads, with a plain PyTorch version of each kernel beside it.

Each partial matches ``models/brdf.py`` including its clamp and mask
subgradient conventions. Masks select (``torch.where``) wherever the
masked branch could hold an ``inf`` that a multiply would turn into NaN.

Every operation is one whose float32 rounding is the same in PyTorch's CUDA
kernels and in ``lobes.cuh`` (built without FMA contraction): a division by
a constant is a multiply by its float32 reciprocal, ``c / x`` is
``reciprocal(x) * c`` (which is what PyTorch computes for it), and an
integer power is written out as multiplies. The fused solves are chaotic at
the last bit (a one-ulp change of the input moves a few percent of lanes by
more than 1e-4), so the kernels are held against this version on the card
lane for lane only because the two round alike.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
from torch.autograd.function import once_differentiable

from brdf_tpu_torch.models.brdf import ShadingAngles
from brdf_tpu_torch.ops import _build

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


def _cook_torrance_fresnel_full(angles, params):
    cl, cnh, cvn, crv = angles
    kd, ks, rough, f0 = params
    s_val, core, nl, ds_dr, ds_dcl, ds_dcnh, ds_dcvn = _ct_core(cl, cnh, cvn, ks, rough)

    # Schlick Fresnel on the half-angle: L·V = 2(N·L)(N·V) − R·V (raw angles),
    # vh = √max((1+L·V)/2, eps); (1−vh)⁵ is written out as multiplies
    lv = 2.0 * cl * cvn - crv
    half_raw = (1.0 + lv) * 0.5
    vh = torch.sqrt(torch.clamp(half_raw, min=_EPS))
    b = 1.0 - vh
    mb = b > 0
    b_s = torch.clamp(b, min=_EPS)
    b2 = b_s * b_s
    b4 = b2 * b2
    zero = torch.zeros_like(b)
    u5 = torch.where(mb, b4 * b_s, zero)
    u4 = torch.where(mb, b4, zero)
    fres = f0 + (1.0 - f0) * u5
    live_h = _f(half_raw > _EPS, cl)
    df_dlv = -(1.0 - f0) * 5.0 * u4 / (4.0 * vh) * live_h

    i_val = kd * _INV_PI * nl + fres * s_val
    d_f0 = s_val * (1.0 - u5)
    d_cl = kd * _INV_PI * _f(cl > 0, cl) + fres * ds_dcl + s_val * df_dlv * 2.0 * cvn
    d_cvn = fres * ds_dcvn + s_val * df_dlv * 2.0 * cl
    d_crv = s_val * df_dlv * -1.0
    return (i_val, (_INV_PI * nl, fres * core, fres * ds_dr, d_f0),
            (d_cl, fres * ds_dcnh, d_cvn, d_crv))


def _lambert_full(angles, params):
    (cl,) = angles
    (kd,) = params
    nl = torch.clamp(cl, min=0.0)
    return kd * _INV_PI * nl, (_INV_PI * nl,), (kd * _INV_PI * _f(cl > 0, cl),)


def _minnaert_full(angles, params):
    cl, cvn = angles
    kd, k = params
    nl = torch.clamp(cl, min=0.0)
    nv = torch.clamp(cvn, min=_EPS)
    lit = _f((cl > 0) & (cvn > 0), cl)
    ln_l = torch.log(torch.clamp(nl, min=_EPS))
    ln_v = torch.log(nv)
    ml = cl > 0
    zero = torch.zeros_like(ln_l)
    pl = torch.where(ml, torch.exp(k * ln_l), zero)              # nl^k
    pl_m1 = torch.where(ml, torch.exp((k - 1.0) * ln_l), zero)
    pv = torch.exp((k - 1.0) * ln_v)                             # nv^(k−1), nv > 0 always
    pv_m1 = torch.exp((k - 2.0) * ln_v)
    base = pl * pv * lit
    d_k = kd * base * (ln_l + ln_v)
    d_cl = kd * k * pl_m1 * pv * lit
    d_cvn = kd * pl * (k - 1.0) * pv_m1 * lit * _f(cvn > _EPS, cl)
    return kd * base, (base, d_k), (d_cl, d_cvn)


def _oren_nayar_full(angles, params):
    cl, cvn, crv = angles
    kd, sigma = params
    s2 = sigma * sigma
    sa = s2 + 0.33
    sb = s2 + 0.09
    a_coef = 1.0 - 0.5 * s2 / sa
    b_coef = 0.45 * s2 / sb
    da_ds = -0.33 * sigma / (sa * sa)
    db_ds = 0.081 * sigma / (sb * sb)

    live_l = _f((cl > -1.0) & (cl < 1.0), cl)       # clip subgradients
    live_v = _f((cvn > -1.0) & (cvn < 1.0), cl)
    nl = torch.clamp(cl, -1.0, 1.0)
    nv = torch.clamp(cvn, -1.0, 1.0)
    sin_i = torch.sqrt(torch.clamp(1.0 - nl * nl, min=0.0))
    sin_r = torch.sqrt(torch.clamp(1.0 - nv * nv, min=0.0))
    dsin_i = -nl / torch.clamp(sin_i, min=_EPS) * _f(sin_i > 0, cl)
    dsin_r = -nv / torch.clamp(sin_r, min=_EPS) * _f(sin_r > 0, cl)

    lv = 2.0 * cl * cvn - crv
    den_raw = sin_i * sin_r
    den = torch.clamp(den_raw, min=_EPS)
    live_den = _f(den_raw > _EPS, cl)
    num = lv - nl * nv
    cp_raw = num / den
    live_cp = _f((cp_raw > -1.0) & (cp_raw < 1.0), cl)
    cp = torch.clamp(cp_raw, -1.0, 1.0)
    cpp = torch.clamp(cp, min=0.0)
    live_pos = _f(cp > 0, cl)
    # ∂cp/∂(lv, nl, nv): quotient rule, den's own nl/nv dependence included
    dcp_dlv = live_cp / den * live_den
    dcp_dnl = live_cp * (-nv * den - num * dsin_i * sin_r) / (den * den) * live_den
    dcp_dnv = live_cp * (-nl * den - num * sin_i * dsin_r) / (den * den) * live_den

    cos_a = torch.minimum(nl, nv)
    cos_b = torch.maximum(nl, nv)
    pick_l = nl <= nv                               # nl is the larger-angle branch
    sin_a = torch.sqrt(torch.clamp(1.0 - cos_a * cos_a, min=0.0))
    cos_b_s = torch.clamp(cos_b, min=_EPS)
    sin_b = torch.sqrt(torch.clamp(1.0 - cos_b * cos_b, min=0.0))
    tan_b = sin_b / cos_b_s
    s_geo = sin_a * tan_b
    ds_dca = -cos_a / torch.clamp(sin_a, min=_EPS) * _f(sin_a > 0, cl) * tan_b
    ds_dcb = -sin_a / torch.clamp(sin_b * cos_b_s * cos_b_s, min=_EPS) * _f(sin_b > 0, cl) \
        * _f(cos_b > _EPS, cl)
    ds_dnl = torch.where(pick_l, ds_dca, ds_dcb)
    ds_dnv = torch.where(pick_l, ds_dcb, ds_dca)

    nlp = torch.clamp(nl, min=0.0)
    live_nlp = _f(nl > 0, cl) * live_l
    term = a_coef + b_coef * cpp * s_geo
    base = _INV_PI * nlp * term

    dterm_dnl = b_coef * (live_pos * dcp_dnl * s_geo + cpp * ds_dnl)
    dterm_dnv = b_coef * (live_pos * dcp_dnv * s_geo + cpp * ds_dnv)
    dterm_dlv = b_coef * live_pos * dcp_dlv * s_geo
    # ∂I/∂cl: through nlp, through nl in (cp, S), and through lv = 2·cl·cvn − crv
    d_cl = kd * _INV_PI * (live_nlp * term + nlp * (dterm_dnl * live_l + dterm_dlv * 2.0 * cvn))
    d_cvn = kd * _INV_PI * nlp * (dterm_dnv * live_v + dterm_dlv * 2.0 * cl)
    d_crv = kd * _INV_PI * nlp * dterm_dlv * -1.0
    d_sigma = kd * _INV_PI * nlp * (da_ds + db_ds * cpp * s_geo)
    return kd * base, (base, d_sigma), (d_cl, d_cvn, d_crv)


def _ward_aniso_full(angles, params):
    """Anisotropic Ward; φ rotates the tangent-frame half-vector components
    (dht/dφ = hb, dhb/dφ = −ht)."""
    cl, cnh, cvn, cth, cbh = angles
    kd, ks, p_ax, p_ay, phi = params
    ax = torch.clamp(p_ax, min=1e-3)
    ay = torch.clamp(p_ay, min=1e-3)
    live_ax = _f(p_ax > 1e-3, cl)
    live_ay = _f(p_ay > 1e-3, cl)

    nl = torch.clamp(cl, min=0.0)
    nv = torch.clamp(cvn, min=_EPS)
    litb = (cl > 0) & (cnh > 0) & (cvn > 0)
    lit = _f(litb, cl)
    one = torch.ones_like(cl)
    zero = torch.zeros_like(cl)
    nh = torch.clamp(torch.where(litb, cnh, one), min=1e-4)

    c = torch.cos(phi)
    s = torch.sin(phi)
    ht = torch.where(litb, c * cth + s * cbh, zero)
    hb = torch.where(litb, -s * cth + c * cbh, zero)

    nh2 = nh * nh
    ax2 = ax * ax
    ay2 = ay * ay
    expo = ((ht * ht) / ax2 + (hb * hb) / ay2) / nh2
    lobe = torch.exp(-expo) / (4.0 * math.pi * ax * ay)
    rt = torch.sqrt(torch.where(litb, nl, one) / nv)
    spec_b = rt * lobe * lit
    i_val = kd * _INV_PI * nl + ks * spec_b

    common = ks * rt * lobe * lit
    d_ax = common * (2.0 * ht * ht / (ax2 * ax * nh2) - torch.reciprocal(ax)) * live_ax
    d_ay = common * (2.0 * hb * hb / (ay2 * ay * nh2) - torch.reciprocal(ay)) * live_ay
    dexpo_dphi = 2.0 * ht * hb * (torch.reciprocal(ax2) - torch.reciprocal(ay2)) / nh2
    d_phi = -ks * rt * lobe * lit * dexpo_dphi

    d_cl = kd * _INV_PI * _f(cl > 0, cl) \
        + ks * lobe * lit / (2.0 * torch.sqrt(torch.clamp(nl * nv, min=_EPS))) * _f(cl > 0, cl)
    # expo = K/nh² with K nh-independent ⇒ dexpo/dnh = −2·expo/nh
    d_cnh = common * (2.0 * expo / nh) * _f(cnh > 1e-4, cl)
    d_cvn = ks * lobe * lit * (-0.5) * rt / nv * _f(cvn > _EPS, cl)
    d_cth = -ks * rt * lobe * lit * (2.0 * ht * c / ax2 - 2.0 * hb * s / ay2) / nh2
    d_cbh = -ks * rt * lobe * lit * (2.0 * ht * s / ax2 + 2.0 * hb * c / ay2) / nh2
    return (i_val, (_INV_PI * nl, spec_b, d_ax, d_ay, d_phi),
            (d_cl, d_cnh, d_cvn, d_cth, d_cbh))


def _cook_torrance_aniso_full(angles, params):
    """Anisotropic GGX Cook-Torrance: Disney remap α = r², NDF
    ``D = 1/(π αₓ α_y u²)`` with ``u = (hₜ/αₓ)² + (h_b/α_y)² + h_n²``, and
    height-correlated anisotropic Smith visibility. Every tangent-frame
    component is rotated by φ (dX_t/dφ = X_b, dX_b/dφ = −X_t for H, L, V)."""
    cl, cnh, cvn, cth, cbh, ctl, cbl, ctv, cbv = angles
    kd, ks, p_rx, p_ry, phi = params
    rx = torch.clamp(p_rx, min=1e-3)
    ry = torch.clamp(p_ry, min=1e-3)
    a = rx * rx
    b = ry * ry
    live_rx = _f(p_rx > 1e-3, cl)
    live_ry = _f(p_ry > 1e-3, cl)

    litb = (cl > 0) & (cvn > 0) & (cnh > 0)
    lit = _f(litb, cl)
    one = torch.ones_like(cl)
    zero = torch.zeros_like(cl)
    nl = torch.clamp(cl, min=0.0)
    nv = torch.where(litb, torch.clamp(cvn, min=_EPS), one)
    nh = torch.where(litb, cnh, one)
    nl_s = torch.where(litb, nl, one)

    c = torch.cos(phi)
    s = torch.sin(phi)

    def rot(t_c, b_c):
        return (torch.where(litb, c * t_c + s * b_c, zero),
                torch.where(litb, -s * t_c + c * b_c, zero))

    ht, hb = rot(cth, cbh)
    lt, lb = rot(ctl, cbl)
    vt, vb = rot(ctv, cbv)

    # anisotropic GGX NDF  D = 1/max(π a b u², eps)
    hta = ht / a
    hbb = hb / b
    u = hta * hta + hbb * hbb + nh * nh
    du_raw = math.pi * a * b * u * u
    live_d = _f(du_raw > _EPS, cl)
    d = torch.reciprocal(torch.clamp(du_raw, min=_EPS))
    u_s = torch.clamp(u, min=_EPS)
    dd_da = d * (torch.reciprocal(a) * -1.0 + 4.0 * ht * ht / (u_s * a * a * a)) * live_d
    dd_db = d * (torch.reciprocal(b) * -1.0 + 4.0 * hb * hb / (u_s * b * b * b)) * live_d
    dd_dht = -4.0 * d * ht / (u_s * a * a) * live_d
    dd_dhb = -4.0 * d * hb / (u_s * b * b) * live_d
    dd_dnh = -4.0 * d * nh / u_s * live_d

    # height-correlated anisotropic Smith visibility
    avt, bvb = a * vt, b * vb
    alt, blb = a * lt, b * lb
    sv = torch.sqrt(avt * avt + bvb * bvb + nv * nv)
    sl = torch.sqrt(alt * alt + blb * blb + nl_s * nl_s)
    den_raw = nl * sv + nv * sl
    live_v = _f(den_raw > _EPS, cl)
    den = torch.clamp(den_raw, min=_EPS)
    vis = torch.reciprocal(den) * 0.5
    dvis = torch.reciprocal(den * den) * -0.5 * live_v     # × dden/dX
    sv_s = torch.clamp(sv, min=_EPS)
    sl_s = torch.clamp(sl, min=_EPS)
    dden_da = nl * a * vt * vt / sv_s + nv * a * lt * lt / sl_s
    dden_db = nl * b * vb * vb / sv_s + nv * b * lb * lb / sl_s
    dden_dnl = sv + nv * nl_s / sl_s
    dden_dnv = nl * nv / sv_s + sl
    dden_dvt = nl * a * a * vt / sv_s
    dden_dvb = nl * b * b * vb / sv_s
    dden_dlt = nv * a * a * lt / sl_s
    dden_dlb = nv * b * b * lb / sl_s

    s_core = d * vis * nl                         # spec / ks
    i_val = kd * _INV_PI * nl + ks * s_core * lit

    d_rx = ks * nl * (dd_da * vis + d * dvis * dden_da) * lit * 2.0 * rx * live_rx
    d_ry = ks * nl * (dd_db * vis + d * dvis * dden_db) * lit * 2.0 * ry * live_ry
    dden_dphi = dden_dvt * vb - dden_dvb * vt + dden_dlt * lb - dden_dlb * lt
    d_phi = ks * nl * ((dd_dht * hb - dd_dhb * ht) * vis + d * dvis * dden_dphi) * lit

    pos_l = _f(cl > 0, cl)
    d_cl = kd * _INV_PI * pos_l + ks * lit * pos_l * (d * vis + d * nl * dvis * dden_dnl)
    d_cnh = ks * lit * dd_dnh * vis * nl
    d_cvn = ks * lit * d * nl * dvis * dden_dnv * _f(cvn > _EPS, cl)
    d_cth = ks * lit * nl * vis * (dd_dht * c - dd_dhb * s)
    d_cbh = ks * lit * nl * vis * (dd_dht * s + dd_dhb * c)
    d_ctl = ks * lit * nl * d * dvis * (dden_dlt * c - dden_dlb * s)
    d_cbl = ks * lit * nl * d * dvis * (dden_dlt * s + dden_dlb * c)
    d_ctv = ks * lit * nl * d * dvis * (dden_dvt * c - dden_dvb * s)
    d_cbv = ks * lit * nl * d * dvis * (dden_dvt * s + dden_dvb * c)
    return (i_val, (_INV_PI * nl, s_core * lit, d_rx, d_ry, d_phi),
            (d_cl, d_cnh, d_cvn, d_cth, d_cbh, d_ctl, d_cbl, d_ctv, d_cbv))


_ISO3 = ("cos_ln", "cos_nh", "cos_vn")
SHADING_KERNELS: dict[str, ShadingKernelSpec] = {
    "blinn_phong": ShadingKernelSpec("blinn_phong", 3, ("cos_ln", "cos_nh"), _blinn_phong_full, 0),
    "phong": ShadingKernelSpec("phong", 3, ("cos_ln", "cos_rv"), _phong_full, 1),
    "cook_torrance": ShadingKernelSpec("cook_torrance", 3, _ISO3, _cook_torrance_full, 2),
    "ward": ShadingKernelSpec("ward", 3, _ISO3, _ward_full, 3),
    "cook_torrance_fresnel": ShadingKernelSpec(
        "cook_torrance_fresnel", 4, _ISO3 + ("cos_rv",), _cook_torrance_fresnel_full, 4),
    "lambert": ShadingKernelSpec("lambert", 1, ("cos_ln",), _lambert_full, 5),
    "minnaert": ShadingKernelSpec("minnaert", 2, ("cos_ln", "cos_vn"), _minnaert_full, 6),
    "oren_nayar": ShadingKernelSpec(
        "oren_nayar", 2, ("cos_ln", "cos_vn", "cos_rv"), _oren_nayar_full, 7),
    "ward_aniso": ShadingKernelSpec(
        "ward_aniso", 5, _ISO3 + ("cos_th", "cos_bh"), _ward_aniso_full, 8),
    "cook_torrance_aniso": ShadingKernelSpec(
        "cook_torrance_aniso", 5,
        _ISO3 + ("cos_th", "cos_bh", "cos_tl", "cos_bl", "cos_tv", "cos_bv"),
        _cook_torrance_aniso_full, 9),
}

# Launches of csrc/lobes_eval.cu made by shading_eval_cuda since the count was
# last reset.
LAUNCHES = 0
# Launches of each kernel of csrc/shade.cu (K2 "fwd", K3 "bwd_params",
# K4 "bwd_angles") since the counts were last reset.
SHADE_LAUNCHES = {"fwd": 0, "bwd_params": 0, "bwd_angles": 0}


def shading_eval_plain(model: str, ang: torch.Tensor, params: torch.Tensor):
    """The plain twin on stacked inputs: ``ang (A, V, T)``, ``params (m, T)``
    → ``(I (V, T), ∂I/∂params (m, V, T), ∂I/∂angles (A, V, T))``."""
    spec = SHADING_KERNELS[model]
    i_val, d_p, d_a = spec.eval(tuple(ang), tuple(params[j:j + 1] for j in range(spec.n_params)))
    return i_val, torch.stack(d_p), torch.stack(d_a)


_P, _I = _build.P, _build.I
_LOBES_EVAL = _build.Entry("the lobe kernel", "lobes_eval", "brdf_lobes_eval",
                           (_I, _P, _P, _P, _P, _P, _I, _I, _P))


def shading_eval_cuda(model: str, ang: torch.Tensor, params: torch.Tensor):
    """Launch ``csrc/lobes_eval.cu``: every lobe function of ``lobes.cuh``
    once per (view, texel), all three outputs written out."""
    global LAUNCHES
    spec = SHADING_KERNELS[model]
    _build.check_operands("the lobe kernel", ang, params)
    _, v, t = ang.shape
    if v * t >= 2**31:
        raise ValueError(f"the lobe kernel indexes with 32-bit ints; V·T={v * t} is too large")
    i_val = torch.empty((v, t), dtype=torch.float32, device=ang.device)
    d_p = torch.empty((spec.n_params, v, t), dtype=torch.float32, device=ang.device)
    d_a = torch.empty_like(ang)
    if v * t == 0:
        return i_val, d_p, d_a
    _build.launch(_LOBES_EVAL, ang.device, spec.lobe_id, ang.data_ptr(), params.data_ptr(),
                  i_val.data_ptr(), d_p.data_ptr(), d_a.data_ptr(), t, v)
    LAUNCHES += 1
    return i_val, d_p, d_a


def shading_eval(model: str, ang: torch.Tensor, params: torch.Tensor):
    """Value and both derivative sets of one lobe on views-major inputs
    (what calling ``SHADING_KERNELS[model].eval`` gives in the JAX package):
    the CUDA kernel for CUDA tensors, the plain twin for CPU tensors."""
    spec = SHADING_KERNELS[model]
    if ang.ndim != 3 or ang.shape[0] != len(spec.angle_names):
        raise ValueError(f"{model} reads {len(spec.angle_names)} angle channels (A, V, T), "
                         f"got {tuple(ang.shape)}")
    if params.shape != (spec.n_params, ang.shape[2]):
        raise ValueError(f"{model} takes {spec.n_params} parameter rows (m, T), "
                         f"got {tuple(params.shape)}")
    if _build.on_cuda(ang, "the lobe library runs"):
        return shading_eval_cuda(model, ang, params)
    return shading_eval_plain(model, ang, params)


# ---------------------------------------------------------------------------
# Forward shading and its analytic backward (csrc/shade.cu: K2, K3, K4)
# ---------------------------------------------------------------------------


def _param_rows(spec: ShadingKernelSpec, params: torch.Tensor):
    return tuple(params[j:j + 1] for j in range(spec.n_params))


def shade_fwd_plain(model: str, ang: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """K2's plain version: ``ang (A, V, T)``, ``params (m, T)`` → ``I (V, T)``."""
    spec = SHADING_KERNELS[model]
    return spec.eval(tuple(ang), _param_rows(spec, params))[0]


def shade_bwd_params_plain(model: str, ang: torch.Tensor, params: torch.Tensor,
                           ct: torch.Tensor) -> torch.Tensor:
    """K3's plain version: ``Σ_v ∂I/∂p_j · ct`` → ``(m, T)``. The views are
    summed left to right from zero, in the kernel's order."""
    spec = SHADING_KERNELS[model]
    _, d_p, _ = spec.eval(tuple(ang), _param_rows(spec, params))
    rows = []
    for d_j in d_p:
        x = d_j * ct
        acc = torch.zeros_like(x[0])
        for v in range(x.shape[0]):
            acc = acc + x[v]
        rows.append(acc)
    return torch.stack(rows)


def shade_bwd_angles_plain(model: str, ang: torch.Tensor, params: torch.Tensor,
                           ct: torch.Tensor) -> torch.Tensor:
    """K4's plain version: ``∂I/∂angle_a · ct`` → ``(A, V, T)``."""
    spec = SHADING_KERNELS[model]
    _, _, d_a = spec.eval(tuple(ang), _param_rows(spec, params))
    return torch.stack([d * ct for d in d_a])


_SHADE = {
    "fwd": _build.Entry("K2", "shade", "brdf_shade_fwd", (_I, _P, _P, _P, _I, _I, _P)),
    "bwd_params": _build.Entry("K3", "shade", "brdf_shade_bwd_params",
                               (_I, _P, _P, _P, _P, _I, _I, _P)),
    "bwd_angles": _build.Entry("K4", "shade", "brdf_shade_bwd_angles",
                               (_I, _P, _P, _P, _P, _I, _I, _P)),
}
_K3_OCCUPANCY = _build.Entry("K3", "shade", "brdf_shade_bwd_params_occupancy", (_I, _P))


def shade_bwd_params_occupancy(model: str) -> dict:
    """What K3 gets for ``model`` on the current card: resident blocks and
    warps an SM, registers and local-memory bytes a thread (the CUDA
    runtime's own figures)."""
    res = _build.query(_K3_OCCUPANCY, 4, SHADING_KERNELS[model].lobe_id)
    return dict(blocks_per_sm=res[0], warps_per_sm=res[0] * res[3] // 32, registers=res[1],
                local_bytes=res[2])


def _shade_launch(kernel: str, model: str, out_shape, ang: torch.Tensor, *rest: torch.Tensor):
    """Check the inputs, allocate the output and launch one kernel of
    ``csrc/shade.cu`` on the current stream."""
    spec = SHADING_KERNELS[model]
    entry = _SHADE[kernel]
    _build.check_operands(entry.kernel, ang, *rest)
    _, v, t = ang.shape
    if v * t >= 2**31:
        raise ValueError(f"one shading launch covers fewer than 2^31 (view, texel) pairs, "
                         f"got V·T={v * t}")
    out = torch.empty(out_shape, dtype=torch.float32, device=ang.device)
    if v * t == 0:
        return out.zero_()
    _build.launch(entry, ang.device, spec.lobe_id, ang.data_ptr(), *(x.data_ptr() for x in rest),
                  out.data_ptr(), t, v)
    SHADE_LAUNCHES[kernel] += 1
    return out


def shade_fwd_cuda(model: str, ang: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """Launch K2: ``I (V, T)`` and nothing else written."""
    return _shade_launch("fwd", model, ang.shape[1:], ang, params)


def shade_bwd_params_cuda(model: str, ang: torch.Tensor, params: torch.Tensor,
                          ct: torch.Tensor) -> torch.Tensor:
    """Launch K3: the parameter cotangents ``(m, T)``, summed over views."""
    return _shade_launch("bwd_params", model, params.shape, ang, params, ct)


def shade_bwd_angles_cuda(model: str, ang: torch.Tensor, params: torch.Tensor,
                          ct: torch.Tensor) -> torch.Tensor:
    """Launch K4: the angle cotangents ``(A, V, T)``."""
    return _shade_launch("bwd_angles", model, ang.shape, ang, params, ct)


_SHADE_PLAIN = {"fwd": shade_fwd_plain, "bwd_params": shade_bwd_params_plain,
                "bwd_angles": shade_bwd_angles_plain}


def _shade_run(kernel: str, model: str, ang: torch.Tensor, *rest: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel for CUDA tensors, its plain version for CPU tensors;
    neither stands in for the other."""
    if _build.on_cuda(ang, "the shading kernels run"):
        cuda = {"fwd": shade_fwd_cuda, "bwd_params": shade_bwd_params_cuda,
                "bwd_angles": shade_bwd_angles_cuda}[kernel]
        return cuda(model, ang, *rest)
    return _SHADE_PLAIN[kernel](model, ang, *rest)


class _ShadeVT(torch.autograd.Function):
    """Views-major core: angles ``(A, V, T)``, parameters ``(m, T)`` →
    ``I (V, T)``. The backward recomputes the lobe from the saved inputs and
    launches K3 only when the parameters need a gradient and K4 only when the
    angles do."""

    @staticmethod
    def forward(ctx, model: str, ang_stack: torch.Tensor, p_rows: torch.Tensor):
        ctx.model = model
        ctx.save_for_backward(ang_stack, p_rows)
        return _shade_run("fwd", model, ang_stack, p_rows)

    @staticmethod
    @once_differentiable
    def backward(ctx, ct: torch.Tensor):
        ang_stack, p_rows = ctx.saved_tensors
        ct = ct.contiguous()
        d_ang = d_p = None
        if ctx.needs_input_grad[1]:
            d_ang = _shade_run("bwd_angles", ctx.model, ang_stack, p_rows, ct)
        if ctx.needs_input_grad[2]:
            d_p = _shade_run("bwd_params", ctx.model, ang_stack, p_rows, ct)
        return None, d_ang, d_p


def shade(model: str, params: torch.Tensor, angles: ShadingAngles) -> torch.Tensor:
    """Shade T texels under V lights: ``params (T, m)``, every channel of
    ``angles`` ``(T, V)`` → ``(T, V)`` float32, with the analytic forward and
    backward of ``csrc/shade.cu`` (no autodiff inside the lobe).

    The contract of ``brdf_tpu/ops/shading_pallas.py::shade_pallas`` without
    its ``block_t``/``interpret`` arguments: the public layout is texel-major,
    the kernels' is views-major, and the wrapper stacks the channels the lobe
    reads and transposes. Differentiable to ``params`` and to every channel
    the lobe reads; a channel it does not read takes no part in the graph and
    gets no gradient. CUDA tensors launch the kernels, CPU tensors run their
    plain versions.
    """
    spec = SHADING_KERNELS[model]
    chans = [getattr(angles, name) for name in spec.angle_names]
    missing = [name for name, c in zip(spec.angle_names, chans) if c is None]
    if missing:
        raise ValueError(f"{model} reads the angle channels {missing}, which are not filled "
                         "(build the angles with tangent_frame=True)")
    t, v = chans[0].shape
    if params.shape != (t, spec.n_params):
        raise ValueError(f"{model} takes params of shape (T, {spec.n_params}) = "
                         f"({t}, {spec.n_params}), got {tuple(params.shape)}")
    ang_stack = torch.stack([c.to(torch.float32).T for c in chans])     # (A, V, T), contiguous
    p_rows = params.to(torch.float32).T.contiguous()                    # (m, T)
    return _ShadeVT.apply(model, ang_stack, p_rows).T
