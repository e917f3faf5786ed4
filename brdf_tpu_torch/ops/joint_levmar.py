"""The m = 11 joint normal-map solve in one launch: ``levmar_bc``'s outer and
inner loops for the anisotropic joint fit as the CUDA kernel of
``csrc/joint_levmar.cu``, the model's analytic Jacobian and the plain version.

The joint fit around an anisotropic base lobe (``ward_aniso``,
``cook_torrance_aniso``: m = 11, RGB kd, RGB ks, three shape parameters and
the normal offset (nu, nv)) runs ``solver/lm.py::levmar_bc``, whose eager
form issues some 5700 launches and 11 host tests an outer iteration. The
kernel runs that solver's state machine for every face where the data is:
the box projection of the start, the projected-gradient test, the active-set
freeze, the Kanzow μ at iteration 0, up to ``max_inner`` damped Cholesky
solves of ``(JᵀJ_f + μI) δ = −g_f`` an iteration (a pivot that is not
positive fails the try), the projected step and its ``small_dp`` test, the
predicted reduction on the unfrozen system, Nielsen's μ/ν, the stop codes in
``levmar_bc``'s order and its counters.

The Jacobian is analytic (:func:`joint_jacobian`): K0's ``lobe_full`` gives
∂I/∂params and ∂I/∂angles of each channel, and the two offset columns chain
∂I/∂angles with the angles' partials in (nu, nv). Those come through the
tilted normal ``normalize(N + nu·T + nv·B)`` and through the tangent frame
that ``models/normalmap.py::perturbed_angles`` rebuilds from it
(:func:`frame_partials`).

- :func:`joint_levmar_plain` is the plain version: ``levmar_bc`` over
  ``joint_residual`` with :func:`joint_jacobian`, the kernel's arithmetic in
  eager PyTorch (what the kernel is held against on the card by
  ``tools/joint_levmar_agreement.py`` and the tests; the fit itself runs
  eager forward-mode ``levmar_bc`` wherever the kernel does not take it).
- :func:`joint_levmar_cuda` launches the kernel (counted in
  :data:`LAUNCHES` and the profiling counter ``levmar.kernel_solves``).
- :func:`kernel_takes` says whether a joint solve can run on it, from what
  the call's tensors and options show; ``pipeline/fit.py::_joint_solve``
  asks it.

The kernel sums a face's views in its lane group's order and solves in its
own unrolled Cholesky, so it agrees with the plain version to float32's
rounding, not bit for bit: the solves are chaotic at the last bit, so a face
may end on another iteration or stop code (the agreement tool's bars).
"""

from __future__ import annotations

import ctypes

import torch

from brdf_tpu_torch.models.brdf import _max, _normalize
from brdf_tpu_torch.models.normalmap import JointSpec, joint_residual, tangent_basis
from brdf_tpu_torch.ops import _build
from brdf_tpu_torch.ops.lanegroup import group_lanes
from brdf_tpu_torch.ops.ne import _joint_prep
from brdf_tpu_torch.ops.shading import SHADING_KERNELS
from brdf_tpu_torch.solver.lm import LMOptions, LMResult, levmar_bc
from brdf_tpu_torch.utils import profiling
from brdf_tpu_torch.utils.profiling import span

# the base lobes the kernel is built for, and the parameter count they give
KERNEL_MODELS = ("ward_aniso", "cook_torrance_aniso")
M = 11
# their roughness floor (models/brdf.py: max(p, 1e-3)), the box's lower bound
ROUGH_FLOOR = 1e-3
# the kernel's block (csrc/joint_levmar.cu kThreads)
THREADS = 128
# views a lane walks at most: S = the fewest lanes (a power of two up to 32)
# that give a lane this many of a face's views, so S = 8 at 16 views, the
# fastest layout on an H100 at the timber cell's 8203 faces × 16 views
# (4.26 ms a solve against 4.49–8.87 at S = 1, 2, 4, 16, 32, 2 blocks of 128
# threads an SM at every S; 4.74 ms since the geometry divides as joint_eval
# does). Every S takes the same steps a face, the sums' order aside
VIEWS_PER_LANE = 2
# Kernel launches made by joint_levmar_cuda since the count was last reset.
LAUNCHES = 0

# the angle channels a tilted normal's frame gives: (frame vector, direction)
_CHANNELS = {"cos_ln": ("n", "l"), "cos_nh": ("n", "h"), "cos_vn": ("n", "v"),
             "cos_th": ("t", "h"), "cos_bh": ("b", "h"), "cos_tl": ("t", "l"),
             "cos_bl": ("b", "l"), "cos_tv": ("t", "v"), "cos_bv": ("b", "v")}


def lane_layout(v: int) -> int:
    """S, the lanes that solve a face of ``v`` views (lane l walks views l,
    l + S, …): the fewest that give a lane at most :data:`VIEWS_PER_LANE`,
    or 32. The views are read from device memory at every pass, so any
    ``v`` runs at any S."""
    if v < 1:
        raise ValueError(f"a face has at least one view, got V={v}")
    return group_lanes(v, VIEWS_PER_LANE)


# ---------------------------------------------------------------------------
# The analytic Jacobian and the plain version
# ---------------------------------------------------------------------------


def frame_partials(n: torch.Tensor, d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The derivative of ``models/normalmap.py::tangent_basis`` at unit normals
    ``n`` (..., 3) along ``d`` (..., 3): ``(dT, dB)``. The sign of the Duff
    frame is constant away from n_z = 0, so it has no derivative."""
    nx, ny, nz = n[..., 0:1], n[..., 1:2], n[..., 2:3]
    dx, dy, dz = d[..., 0:1], d[..., 1:2], d[..., 2:3]
    one = torch.ones_like(nz)
    sign = torch.where(nz >= 0, one, -one)
    a = -1.0 / (sign + nz)
    da = a * a * dz
    db = (dx * ny + nx * dy) * a + nx * ny * da
    dt = torch.cat([sign * (2.0 * nx * dx * a + nx * nx * da), sign * db, -sign * dx], dim=-1)
    dbt = torch.cat([db, 2.0 * ny * dy * a + ny * ny * da, -dy], dim=-1)
    return dt, dbt


def joint_jacobian(spec: JointSpec):
    """The analytic Jacobian of ``joint_residual(spec)`` for one face,
    ``jac(p (11,), (geom, target (V, 3), w)) → (3·V, 11)`` in the residual's
    order (view-major, the channels within a view), for ``levmar_bc``'s
    ``jac_fn``. K0's plain lobe (``ops/shading.py``) gives each channel's
    ∂I/∂params and ∂I/∂angles; the offsets' columns chain ∂I/∂angles with
    the angles' partials through the tilted normal and its rebuilt frame. A
    roughness at its floor takes half the derivative just above it, as
    forward mode through ``torch.maximum`` does at the tie."""
    if spec.base_model not in KERNEL_MODELS:
        raise ValueError(f"the analytic m = 11 Jacobian takes {KERNEL_MODELS}, "
                         f"got {spec.base_model!r}")
    lobe = SHADING_KERNELS[spec.base_model]
    k = spec.n_shape

    def dot(x, z):
        return torch.sum(x * z, dim=-1)

    def jac(p, data):
        geom, target, w = data
        n0 = geom.n
        t0, b0 = tangent_basis(n0)
        u = n0 + p[6 + k] * t0 + p[7 + k] * b0
        ell = _max(torch.linalg.vector_norm(u, dim=-1, keepdim=True), 1e-12)
        nn = u / ell
        frame = {"n": nn}
        frame["t"], frame["b"] = tangent_basis(nn)
        du = {"n": (t0 - nn * dot(nn, t0)[..., None]) / ell}
        dv = {"n": (b0 - nn * dot(nn, b0)[..., None]) / ell}
        du["t"], du["b"] = frame_partials(nn, du["n"])
        dv["t"], dv["b"] = frame_partials(nn, dv["n"])
        dirs = {"l": geom.l, "v": geom.v, "h": _normalize(geom.l + geom.v)}

        vals, ang_u, ang_v = [], [], []
        for name in lobe.angle_names:
            f, g = _CHANNELS[name]
            vals.append(dot(frame[f][..., None, :], dirs[g]))
            ang_u.append(dot(du[f][..., None, :], dirs[g]))
            ang_v.append(dot(dv[f][..., None, :], dirs[g]))
        shape = tuple(p[6 + i:7 + i] for i in range(k))
        # a roughness at the lobe's floor takes half its derivative just above
        # it: forward mode's torch.maximum at the tie, where K0 gives 0
        tie = [x == ROUGH_FLOOR for x in shape[:2]]
        above = tuple(torch.where(t, torch.nextafter(x, torch.ones_like(x)), x)
                      for t, x in zip(tie, shape[:2])) + shape[2:]
        zero = torch.zeros_like(vals[0])
        rows = []
        for c in range(3):
            linear = (p[c:c + 1], p[3 + c:4 + c])
            _, d_par, d_ang = lobe.eval(tuple(vals), linear + shape)
            _, d_above, _ = lobe.eval(tuple(vals), linear + above)
            d_par = (d_par[:2] + tuple(torch.where(t, 0.5 * a, d) for t, a, d
                                       in zip(tie, d_above[2:4], d_par[2:4])) + d_par[4:])
            d_nu = d_ang[0] * ang_u[0]
            d_nv = d_ang[0] * ang_v[0]
            for a in range(1, len(d_ang)):
                d_nu = d_nu + d_ang[a] * ang_u[a]
                d_nv = d_nv + d_ang[a] * ang_v[a]
            cols = [zero] * spec.n_params
            cols[c], cols[3 + c] = d_par[0], d_par[1]
            cols[6:6 + k] = d_par[2:]
            cols[6 + k], cols[7 + k] = d_nu, d_nv
            rows.append(torch.stack(cols, dim=-1))                 # (V, 11)
        wb = w if w.ndim == target.ndim else w[..., None].expand(target.shape)
        return (torch.stack(rows, dim=-2) * wb[..., None]).reshape(-1, spec.n_params)

    return jac


def joint_levmar_plain(spec: JointSpec, geometry, target, p0, weights, opts: LMOptions) -> LMResult:
    """The plain version: ``levmar_bc`` over ``joint_residual(spec)`` with the
    analytic :func:`joint_jacobian`, on the inputs of
    ``pipeline/fit.py::_joint_solve`` (geometry with l, v (T, V, 3), target
    (T, V, 3), p0 (T, 11), weights (T, V, 3))."""
    return levmar_bc(joint_residual(spec), p0, spec.lower, spec.upper,
                     data=(geometry, target, weights), opts=opts, jac_fn=joint_jacobian(spec))


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------


def kernel_takes(spec: JointSpec, opts: LMOptions, *tensors: torch.Tensor) -> bool:
    """Whether a joint solve of ``spec`` under ``opts`` on ``tensors`` runs on
    the kernel: float32 CUDA tensors, an m = 11 base lobe the kernel is built
    for, and ``levmar_bc``'s Cholesky solve with additive damping on an
    unsharded residual axis."""
    return (all(x.is_cuda and x.dtype == torch.float32 for x in tensors)
            and spec.base_model in KERNEL_MODELS and spec.n_params == M
            and opts.linsolver == "cholesky" and opts.damping == "add"
            and opts.axis_name is None)


_P, _I, _F = _build.P, _build.I, _build.F
_SOLVE = _build.Entry("the joint LM kernel", "joint_levmar", "brdf_joint_levmar",
                      (_I,) + (_P,) * 9 + (_I, _I, _I, _P, _P) + (_F,) * 6 + (_I, _I, _P))
_OCCUPANCY = _build.Entry("the joint LM kernel", "joint_levmar", "brdf_joint_levmar_occupancy",
                          (_I, _I, _P))


def _check_model(base_model: str) -> None:
    if base_model not in KERNEL_MODELS:
        raise ValueError(f"the joint LM kernel takes the m = {M} bases {KERNEL_MODELS}, "
                         f"got {base_model!r}")


def occupancy(model: str, v: int) -> dict:
    """What the instantiation for ``model`` at ``v`` views gets on the current
    card: lanes a face, resident blocks and warps an SM, registers and
    local-memory bytes a thread, and the persistent grid's blocks (the CUDA
    runtime's own figures)."""
    _check_model(model)
    lanes = lane_layout(v)
    res = _build.query(_OCCUPANCY, 5, SHADING_KERNELS[model].lobe_id, lanes)
    return dict(lanes=lanes, blocks_per_sm=res[0], warps_per_sm=res[0] * res[3] // 32,
                registers=res[1], local_bytes=res[2], persistent_blocks=res[0] * res[4])


def joint_levmar_cuda(base_model: str, lv, y, w, frame, p0_rows, lower, upper,
                      opts: LMOptions, counters=None) -> LMResult:
    """Launch the kernel on ``ops/ne.py::_joint_prep``'s views-major stacks
    (``lv (6, V, T)``, ``y``/``w (3, V, T)``, ``frame (9, T)``) from the start
    ``p0_rows (11, T)`` in the box ``lower``/``upper`` (11 values each) →
    every field of ``levmar_bc``'s ``LMResult`` (float32, the counts int32).
    ``counters``, an int32 CUDA tensor of 2 the caller may pass to read them
    afterwards, is zeroed here: [0] the work counter, [1] the warps' trips."""
    global LAUNCHES
    _check_model(base_model)
    _build.check_operands("the joint LM kernel", lv, y, w, frame, p0_rows)
    if lv.ndim != 3 or lv.shape[0] != 6:
        raise ValueError(f"the joint LM kernel: lv is (6, V, T), got {tuple(lv.shape)}")
    _, v, t = lv.shape
    if (y.shape != (3, v, t) or w.shape != (3, v, t) or frame.shape != (9, t)
            or p0_rows.shape != (M, t)):
        raise ValueError(f"the joint LM kernel's shapes: lv {tuple(lv.shape)}, y {tuple(y.shape)}, "
                         f"w {tuple(w.shape)}, frame {tuple(frame.shape)}, "
                         f"p0 {tuple(p0_rows.shape)} (11, T)")
    if len(lower) != M or len(upper) != M:
        raise ValueError(f"the joint LM kernel takes {M} bounds a side, got {lower}/{upper}")
    if opts.linsolver != "cholesky" or opts.damping != "add" or opts.axis_name is not None:
        raise ValueError("the joint LM kernel solves by Cholesky with additive damping on an "
                         "unsharded residual axis")
    if v < 1 or t >= 2**31 or v >= 2**31:
        raise ValueError(f"the joint LM kernel takes 1 to 2^31 − 1 views and fewer than 2^31 "
                         f"faces, got V={v}, T={t}")
    dev = lv.device
    p = torch.empty((t, M), dtype=torch.float32, device=dev)
    f = torch.empty((5, t), dtype=torch.float32, device=dev)
    n = torch.empty((5, t), dtype=torch.int32, device=dev)
    if counters is None:
        counters = torch.zeros(2, dtype=torch.int32, device=dev)
    else:
        counters.zero_()
    if t:
        lo = (ctypes.c_float * M)(*lower)
        hi = (ctypes.c_float * M)(*upper)
        f32 = torch.tensor([opts.tau, opts.eps1, opts.eps2 * opts.eps2, opts.eps3, opts.mu_max,
                            opts.mu_max / 2], dtype=torch.float32).tolist()
        _build.launch(_SOLVE, dev, SHADING_KERNELS[base_model].lobe_id, lv.data_ptr(),
                      y.data_ptr(), w.data_ptr(), frame.data_ptr(), p0_rows.data_ptr(),
                      p.data_ptr(), f.data_ptr(), n.data_ptr(), counters.data_ptr(), t, v,
                      lane_layout(v), lo, hi, *f32, int(opts.itmax), int(opts.max_inner))
        LAUNCHES += 1
        profiling.count("levmar.kernel_solves")
    return LMResult(p=p, chi2=f[0], chi2_init=f[1], g_inf=f[2], iters=n[0], stop=n[1],
                    nfev=n[2], njev=n[3], mu=f[3], nu=f[4], nlss=n[4],
                    constraint_violation=torch.zeros(t, dtype=torch.float32, device=dev))


def joint_levmar(spec: JointSpec, geometry, target, p0, weights, opts: LMOptions) -> LMResult:
    """One m = 11 joint solve on the kernel, on the CUDA inputs of
    ``pipeline/fit.py::_joint_solve`` (geometry n (T, 3), l/v (T, V, 3);
    target (T, V, 3); p0 (T, 11); weights (T, V) or (T, V, 3)), where
    :func:`kernel_takes` holds. The call is a ``levmar.solve`` span (path
    "kernel"); at its end, while recording, ``levmar.lanes`` (T × the most
    iterations of a face) and ``levmar.active_lanes`` (the faces' iterations
    summed) are added from one read of the device."""
    t, v = target.shape[:2]
    with span("levmar.solve", lanes=t, m=spec.n_params, n=3 * v, path="kernel"):
        lv, y, w, frame = _joint_prep(geometry, target, weights)
        res = joint_levmar_cuda(spec.base_model, lv, y, w, frame, p0.T.contiguous(), spec.lower,
                                spec.upper, opts)
        if profiling.enabled() and t:
            most, total = torch.stack([res.iters.max().long(), res.iters.sum()]).tolist()
            profiling.count("levmar.lanes", t * most)
            profiling.count("levmar.active_lanes", total)
    return res
