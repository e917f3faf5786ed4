# Adapted from brdf_tpu/pipeline/render.py (the port imports nothing of brdf_tpu).
"""Batched image synthesis from fitted BRDF parameters ("serve" path).

Replaces the reference's interactive GLUT preview (``DrawMesh``'s per-triangle
CPU shading, ``glutcallbacks.cpp:344-446``) with batched rendering: all
covered pixels of a view are gathered, shaded in one call and written into
the image — usable both as the product output (relighting from arbitrary
lights/cameras) and as the round-trip test generator.

On a CUDA device the gather and the image fill run on the card too, over
the view's compact raster map and the mesh held there
(``pipeline/scene.py::DeviceRasterMap``, ``DeviceMesh``), and one copy of
the finished image comes back. On the CPU the NumPy gather (:func:`gather_covered_pixels`) and
the host fill run: the plain version the device path is tested against.
"""

from __future__ import annotations

import numpy as np
import torch

from brdf_tpu_torch.device import resolve_device
from brdf_tpu_torch.geometry.camera import Camera, project_np
from brdf_tpu_torch.geometry.rasterize import rasterize_mesh
from brdf_tpu_torch.models.brdf import MODELS, ShadingAngles, shading_angles
from brdf_tpu_torch.models.normalmap import tangent_basis, tangent_basis_np
from brdf_tpu_torch.ops.shading import shade
from brdf_tpu_torch.pipeline.scene import DeviceRasterMap, Scene, device_mesh, device_raster_map
from brdf_tpu_torch.utils.profiling import count, span


def render_pixels(
    model: str,
    params,                 # (N, C, m) per-pixel per-channel parameters
    points,                 # (N, 3) surface points
    normals,                # (N, 3) unit normals
    eye,                    # (3,) camera position
    lights,                 # (L, 3) active point lights
    engine: str = "pallas",  # "pallas" (hand kernel K2) | "xla" (eager lobe)
    device=None,
) -> torch.Tensor:
    """Shade N surface samples under L lights; returns (N, C) on ``device``
    with light contributions summed — the hot serve function. Inputs are
    tensors or NumPy arrays and keep their dtype; ``device`` is ``cuda``
    unless the caller passes another.

    ``engine="pallas"`` (the default) routes through the hand-written shading
    kernel (``ops/shading.py::shade``, K2 of ``csrc/shade.cu``; on the CPU its
    plain version). ``engine="xla"`` evaluates the lobe of ``models/brdf.py``
    eagerly on ``(N, C, L)`` broadcasts. The JAX package keeps these names and
    defaults to ``"xla"`` because XLA fuses the lobe into one program; eager
    PyTorch runs it as dozens of elementwise launches, so here the kernel is
    the default and every entry point below renders through it. Both are
    close to float32 rounding (tests assert it).
    """
    dev = resolve_device(device)
    params, points, normals, eye, lights = (
        torch.as_tensor(x).to(dev) for x in (params, points, normals, eye, lights))
    ang = shading_angles(
        points, normals, eye, lights, tangent_frame=MODELS[model].tangent
    )   # cosines (N, L)
    if engine == "pallas":
        n, c, m = params.shape
        l = ang.cos_ln.shape[-1]
        # every pixel's angles repeat for its C channels: the kernel takes one
        # parameter row per texel
        ang_flat = ShadingAngles(*(
            None if a is None else a.repeat_interleave(c, dim=0) for a in ang))
        vals = shade(model, params.reshape(n * c, m), ang_flat)
        return vals.reshape(n, c, l).sum(dim=-1)
    if engine != "xla":
        raise ValueError(f"unknown shading engine {engine!r} (xla | pallas)")
    fn = MODELS[model].fn
    # params (N, C, m) × angles (N, 1, L) broadcast to (N, C, L); sum lights
    vals = fn(params, ShadingAngles(*(None if a is None else a[:, None, :] for a in ang)))
    return vals.sum(dim=-1)


def render_image(
    model: str,
    scene: Scene,
    params: np.ndarray,          # (T, C, m) per-texel parameters
    face_ids: np.ndarray,        # (T,) faces backing the texels
    view: int = 0,
    lights: np.ndarray | None = None,
    background: float = 0.0,
    use_vertex_normals: bool = True,
    normal_offsets: np.ndarray | None = None,  # (T, 2) fitted (nu, nv)
    device=None,
) -> np.ndarray:
    """Render the scene's mesh with fitted parameters from a view's camera.

    ``lights`` defaults to the view's own LED (reproducing the measurement
    condition — the round-trip case); pass any (L, 3) array to relight.
    ``normal_offsets`` applies joint-fit tangent-space normal perturbations
    (forces flat shading, since the offsets refine per-texel face normals).

    On a CUDA device the image the caller gets is page-locked host memory
    from PyTorch's caching host allocator (:func:`_to_host`): a block of
    the image's size rounded up to a power of two, pinned for as long as
    the caller keeps the array.
    """
    if lights is None:
        lights = scene.lights[view : view + 1]
    dev = resolve_device(device)
    kw = dict(background=background, use_vertex_normals=use_vertex_normals,
              normal_offsets=normal_offsets)
    if _on_card(dev):
        return shade_device_map(model, scene.device_map(view, dev), scene.cameras[view],
                                params, face_ids, lights, **kw)
    return shade_raster_map(model, scene.mesh, scene.raster_map(view), scene.cameras[view],
                            params, face_ids, lights, device=dev, **kw)


def _on_card(dev: torch.device) -> bool:
    """Whether a render on ``dev`` gathers and fills the image on the device."""
    return dev.type == "cuda"


def gather_covered_pixels(
    mesh,
    rm,
    params: np.ndarray,
    face_ids: np.ndarray,
    use_vertex_normals: bool = True,
    normal_offsets: np.ndarray | None = None,
):
    """Host-side gather of the per-covered-pixel shading inputs of a raster
    map: returns ``(cov (H, W) bool, pts (N, 3), nrm (N, 3), p_px (N, ...),
    valid (N,))``. Shared by point-light and environment relighting."""
    with span("render.gather", path="host") as sp:
        out = _gather(mesh, rm, params, face_ids, use_vertex_normals, normal_offsets)
        sp.set(pixels=len(out[1]))
    return out


def _gather(mesh, rm, params, face_ids, use_vertex_normals, normal_offsets):
    if normal_offsets is not None:
        use_vertex_normals = False

    cov = rm.coverage
    fids = rm.face_id[cov]                            # faces per covered pixel
    bary = rm.bary[cov]                               # (N, 3)

    tri = np.asarray(mesh.vertices)[np.asarray(mesh.faces)[fids]]   # (N, 3, 3)
    pts = np.einsum("nk,nkd->nd", bary, tri)
    if use_vertex_normals:
        vn = np.asarray(mesh.vertex_normals)[np.asarray(mesh.faces)[fids]]
        nrm = np.einsum("nk,nkd->nd", bary, vn)
        nrm /= np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
    else:
        nrm = np.asarray(mesh.face_normals)[fids]

    # texel lookup: map face id → texel row (faces without a texel render black)
    t = len(face_ids)
    lut = np.full(mesh.num_faces, -1, np.int64)
    lut[face_ids] = np.arange(t)
    rows = lut[fids]
    valid = rows >= 0
    p_px = np.zeros((len(fids),) + params.shape[1:], params.dtype)
    p_px[valid] = params[rows[valid]]

    if normal_offsets is not None:
        tb, bb = tangent_basis_np(np.asarray(nrm, np.float32))
        off = np.zeros((len(fids), 2), np.float32)
        off[valid] = normal_offsets[rows[valid]]
        n_new = (
            nrm
            + off[:, 0:1] * tb
            + off[:, 1:2] * bb
        )
        nrm = n_new / np.maximum(np.linalg.norm(n_new, axis=-1, keepdims=True), 1e-12)
    return cov, pts, nrm, p_px, valid


def _unit(x: torch.Tensor) -> torch.Tensor:
    """``x / max(|x|, 1e-12)`` over the last axis of 3, the squares summed
    left to right as NumPy's ``linalg.norm`` sums them."""
    sq = x * x
    norm = torch.sqrt(sq[:, 0:1] + sq[:, 1:2] + sq[:, 2:3])
    return x / torch.clamp(norm, min=1e-12)


def gather_on_device(
    dmap: DeviceRasterMap,
    params,
    face_ids,
    use_vertex_normals: bool = True,
    normal_offsets=None,
):
    """:func:`_gather` on ``dmap``'s device, with no host sync: returns
    ``(pts (N, 3), nrm (N, 3), p_px (N, ...), valid (N,))`` there, geometry
    in float32 (elementwise, so no TF32 matmul), ``p_px`` in the dtype of
    ``params`` and zero where a pixel's face has no texel."""
    if normal_offsets is not None:
        use_vertex_normals = False
    dev = dmap.bary.device
    mesh = dmap.mesh
    face_ids = np.asarray(face_ids, np.int64)
    n_faces = mesh.faces.shape[0]
    if face_ids.size and (face_ids.min() < 0 or face_ids.max() >= n_faces):
        raise ValueError(f"face_ids must lie in [0, {n_faces})")
    params = torch.as_tensor(params).to(dev)
    fids = dmap.face_id
    corners = mesh.faces.index_select(0, fids)                       # (N, 3)
    b = dmap.bary

    def interpolate(table):
        t = table[corners]                                           # (N, 3, 3)
        return b[:, 0:1] * t[:, 0] + b[:, 1:2] * t[:, 1] + b[:, 2:3] * t[:, 2]

    pts = interpolate(mesh.vertices)
    if use_vertex_normals:
        nrm = _unit(interpolate(mesh.vertex_normals))
    else:
        nrm = mesh.face_normals.index_select(0, fids)

    # texel lookup: face id → texel row, the last texel of a face as in
    # NumPy's fancy assignment; a face without one reads the zero row at t
    t = len(face_ids)
    lut = torch.full((n_faces,), -1, dtype=torch.int64, device=dev)
    lut.scatter_reduce_(0, torch.from_numpy(face_ids).to(dev),
                        torch.arange(t, device=dev), reduce="amax")
    rows = lut.index_select(0, fids)
    valid = rows >= 0
    take = torch.where(valid, rows, t)

    def per_pixel(x):
        x = torch.cat([x, x.new_zeros((1,) + x.shape[1:])])
        return x.index_select(0, take)

    p_px = per_pixel(params)
    if normal_offsets is not None:
        off = per_pixel(torch.as_tensor(normal_offsets, dtype=torch.float32).to(dev))
        tb, bb = tangent_basis(nrm)
        nrm = _unit(nrm + off[:, 0:1] * tb + off[:, 1:2] * bb)
    return pts, nrm, p_px, valid


def scatter_on_device(dmap: DeviceRasterMap, shaded: torch.Tensor, valid: torch.Tensor,
                      background: float = 0.0) -> torch.Tensor:
    """The host fill of :func:`shade_raster_map` on ``dmap``'s device: an
    (H, W, C) float32 image of ``background`` with ``shaded · valid`` at the
    covered pixels."""
    img = torch.full((dmap.height * dmap.width, shaded.shape[-1]), background,
                     dtype=torch.float32, device=shaded.device)
    img.index_copy_(0, dmap.pixels, shaded * valid[:, None])
    return img.view(dmap.height, dmap.width, -1)


def shade_device_map(
    model: str,
    dmap: DeviceRasterMap,
    cam,
    params: np.ndarray,
    face_ids: np.ndarray,
    lights: np.ndarray,
    background: float = 0.0,
    use_vertex_normals: bool = True,
    normal_offsets: np.ndarray | None = None,
) -> np.ndarray:
    """:func:`shade_raster_map` on ``dmap``'s device: gather, shade
    (:func:`_shade_on_device`, as the host path) and fill the image there,
    then one copy of the image to the host (a fresh array, :func:`_to_host`).
    Nothing derived from the parameters, face ids, offsets or lights is
    kept. On the card the three spans time the host's launching of the
    work; the last one holds the copy back, so it holds the wait for the
    device."""
    dev = dmap.bary.device
    with torch.no_grad():
        with span("render.gather", path="device", pixels=len(dmap.pixels)):
            count("render.device_gathers")
            pts, nrm, p_px, valid = gather_on_device(
                dmap, params, face_ids, use_vertex_normals=use_vertex_normals,
                normal_offsets=normal_offsets)
        shaded = _shade_on_device(model, p_px, pts, nrm, cam, lights, dev)
        with span("render.scatter"):
            return _to_host(scatter_on_device(dmap, shaded, valid, background))


def _to_host(img: torch.Tensor) -> np.ndarray:
    """One copy of a fresh device image to a host array the caller owns. On
    the card the copy lands in page-locked memory from PyTorch's caching host
    allocator: on an H100 a third of the pageable copy's time, and without
    its tail (with the pageable copy the relight's p95 doubled in two runs
    of four, with this in none). The block goes back to the allocator when
    the array is dropped."""
    if not img.is_cuda:
        return img.numpy()
    out = torch.empty(img.shape, dtype=img.dtype, pin_memory=True)
    out.copy_(img, non_blocking=True)
    torch.cuda.current_stream(img.device).synchronize()
    return out.numpy()


def shade_raster_map(
    model: str,
    mesh,
    rm,
    cam,
    params: np.ndarray,
    face_ids: np.ndarray,
    lights: np.ndarray,
    background: float = 0.0,
    use_vertex_normals: bool = True,
    normal_offsets: np.ndarray | None = None,
    device=None,
) -> np.ndarray:
    """Shade one rasterized camera view of ``mesh`` with per-texel parameters
    — the core of :func:`render_image`, usable with any camera/raster map
    (novel viewpoints included, see :func:`render_turntable`). On a CUDA
    device the map and the mesh are uploaded for this call alone and shaded
    by :func:`shade_device_map`."""
    dev = resolve_device(device)
    if _on_card(dev):
        dmap = device_raster_map(device_mesh(mesh, dev), rm)
        return shade_device_map(model, dmap, cam, params, face_ids, lights, background=background,
                                use_vertex_normals=use_vertex_normals,
                                normal_offsets=normal_offsets)
    cov, pts, nrm, p_px, valid = gather_covered_pixels(
        mesh, rm, params, face_ids,
        use_vertex_normals=use_vertex_normals, normal_offsets=normal_offsets,
    )
    shaded = _shade_on_device(model, p_px, pts, nrm, cam, lights, dev).cpu().numpy()
    with span("render.scatter"):
        img = np.full((cam.height, cam.width, params.shape[1]), background, np.float32)
        img[cov] = shaded * valid[:, None]
    return img


def _shade_on_device(model, params, points, normals, cam, lights, device) -> torch.Tensor:
    """``render_pixels`` (geometry as float32, default engine) on host arrays
    or on the device gather's tensors, under the ``render.shade`` span: the
    one shading step of both paths, (N, C) on ``device``."""
    def f32(x):
        return x.float() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)

    with span("render.shade", pixels=len(points), lights=len(lights)), torch.no_grad():
        return render_pixels(
            model,
            params if isinstance(params, torch.Tensor) else np.asarray(params),
            f32(points),
            f32(normals),
            np.asarray(cam.position),
            np.asarray(lights, np.float32),
            device=device,
        )


def render_pixel_fit(
    model: str,
    scene: Scene,
    params: np.ndarray,          # (T, C, m) per-pixel-texel parameters
    pixels: np.ndarray,          # (T, 2) [x, y] reference-view pixels
    points: np.ndarray,          # (T, 3)
    normals: np.ndarray,         # (T, 3)
    view: int = 0,
    lights: np.ndarray | None = None,
    background: float = 0.0,
    device=None,
) -> np.ndarray:
    """Render a pixel-granularity fit: each texel shades its own pixel of the
    reference view (use :func:`render_image` for face-granularity maps)."""
    cam = scene.cameras[view]
    if lights is None:
        lights = scene.lights[view : view + 1]
    shaded = _shade_on_device(model, params, points, normals, cam, lights, device).cpu().numpy()
    img = np.full((cam.height, cam.width, params.shape[1]), background, np.float32)
    img[pixels[:, 1], pixels[:, 0]] = shaded
    return img


def relight(
    model: str,
    scene: Scene,
    params: np.ndarray,
    face_ids: np.ndarray,
    lights: np.ndarray,
    view: int = 0,
    device=None,
) -> np.ndarray:
    """Re-render under novel lighting — the capability the reference's `m`
    keypress preview approximated with a headlight at the eye
    (``glutcallbacks.cpp:346-445``). On a CUDA device the image is
    page-locked host memory, as :func:`render_image` says."""
    with span("relight"):
        return render_image(model, scene, params, face_ids, view=view, lights=lights,
                            device=device)


def orbit_cameras(
    mesh,
    frames: int = 12,
    elevation_deg: float = 20.0,
    distance: float | None = None,
    size: tuple[int, int] = (512, 512),
    f: float | None = None,
    up=(0.0, 1.0, 0.0),
):
    """Synthetic cameras orbiting the mesh — the batch replacement for the
    reference's interactive mouse-orbit camera (``glutcallbacks.cpp:764-879``,
    ``ResetCamera``)."""
    verts = np.asarray(mesh.vertices, np.float64)
    center = verts.mean(axis=0)
    radius = float(np.linalg.norm(verts - center, axis=-1).max())
    if distance is None:
        distance = 2.5 * max(radius, 1e-6)
    if f is None:
        # fit the bounding sphere comfortably in frame
        f = 0.45 * min(size) * distance / max(radius, 1e-6)
    el = np.deg2rad(elevation_deg)
    up = np.asarray(up, np.float64)
    up = up / np.linalg.norm(up)
    # orthonormal frame around `up` for the orbit plane
    ref = np.array([1.0, 0.0, 0.0]) if abs(up[0]) < 0.9 else np.array([0.0, 0.0, 1.0])
    e1 = np.cross(up, ref); e1 /= np.linalg.norm(e1)
    e2 = np.cross(up, e1)
    cams = []
    for k in range(frames):
        az = 2.0 * np.pi * k / frames
        d = (np.cos(el) * (np.cos(az) * e1 + np.sin(az) * e2) + np.sin(el) * up)
        eye = center + distance * d
        cams.append(
            Camera.look_at(eye, center, up=up, f=f, width=size[0], height=size[1])
        )
    return cams


def render_turntable(
    model: str,
    scene: Scene,
    params: np.ndarray,
    face_ids: np.ndarray,
    frames: int = 12,
    elevation_deg: float = 20.0,
    distance: float | None = None,
    size: tuple[int, int] = (512, 512),
    lights: np.ndarray | None = None,
    headlight: bool = True,
    normal_offsets: np.ndarray | None = None,
    up=(0.0, 1.0, 0.0),
    device=None,
) -> np.ndarray:
    """Render an orbit around the fitted object — the offline equivalent of
    the reference's interactive preview loop (``Display_`` + mouse orbit +
    ``m``-key BRDF shading, ``glutcallbacks.cpp:344-446``, ``:764-879``).

    ``headlight=True`` places the light at the eye each frame, exactly the
    preview's GL_LIGHT1-at-eye setup (``glutcallbacks.cpp:460-478``);
    otherwise ``lights`` (default: the scene's LEDs) stays fixed while the
    camera orbits. Returns (frames, H, W, C) in [0, 1]-ish linear intensity.
    """
    mesh = scene.mesh
    cams = orbit_cameras(
        mesh, frames=frames, elevation_deg=elevation_deg, distance=distance,
        size=size, up=up,
    )
    if lights is None and not headlight:
        lights = scene.lights
    out = np.empty((frames, size[1], size[0], params.shape[1]), np.float32)
    for k, cam in enumerate(cams):
        rm = rasterize_mesh(cam, mesh.vertices, mesh.faces)
        l_frame = (
            np.asarray(cam.position, np.float32)[None] if headlight else lights
        )
        # each frame is written into the stack at once, so a single frame's
        # host image is alive at a time
        out[k] = shade_raster_map(
            model, mesh, rm, cam, params, face_ids, l_frame,
            normal_offsets=normal_offsets, device=device,
        )
    return out


def splat_points(
    camera,
    points: np.ndarray,     # (N, 3)
    values: np.ndarray,     # (N, C)
    background: float = 0.0,
) -> np.ndarray:
    """Painter's-algorithm point splat: project shaded surface samples into a
    camera and keep the nearest per pixel. Used to preview pixel-granularity
    fits from novel viewpoints (their texels are reference-view pixels, so
    there is no raster map to look up)."""
    uv, z = project_np(camera, np.asarray(points, np.float64))
    h, w = camera.height, camera.width
    px = np.round(uv[:, 0]).astype(np.int64)
    py = np.round(uv[:, 1]).astype(np.int64)
    ok = (z > 0) & (px >= 0) & (px < w) & (py >= 0) & (py < h)
    idx = np.nonzero(ok)[0]
    order = idx[np.argsort(-z[idx])]         # far → near; near painted last
    img = np.full((h, w, values.shape[-1]), background, np.float32)
    img[py[order], px[order]] = values[order]
    return img
