"""What the entries hand the program (``brdf_tpu_torch``, the system under
test): a scan as the program's ``Scene``, and the program's problem and
solver options from a configuration. Only the entries import this."""

from __future__ import annotations

import numpy as np


def build_kernels(device) -> None:
    """Build (or find built) every CUDA source of the program, in parallel,
    into its own build directory inside the checkout (on a CUDA device; the
    CPU runs the kernels' plain versions)."""
    if device.type != "cuda":
        return
    from brdf_tpu_torch.ops import _build

    _build.build_all()


def scene(scan):
    """The program's Scene of a scan: its mesh, one camera for every view,
    the rig and the images (an empty stack where the scan has none)."""
    from brdf_tpu_torch.geometry import Camera, TriangleMesh
    from brdf_tpu_torch.pipeline.scene import Scene

    g = scan.geometry
    c = g.camera
    f32 = np.float32
    cam = Camera(rotation=c.rotation, position=c.position, f=f32(c.f), cx=f32(c.cx),
                 cy=f32(c.cy), sx=f32(c.sx), kappa1=f32(c.kappa1), width=c.width,
                 height=c.height)
    views = len(g.lights)
    images = scan.images if scan.images is not None else np.zeros((views, 0, 0, 3), np.float32)
    return Scene(mesh=TriangleMesh.from_arrays(g.vertices, g.faces), cameras=[cam] * views,
                 lights=g.lights, images=images, name="scan")


def problem(config: dict, scn):
    """The program's problem of a scene, as its command line builds it."""
    from brdf_tpu_torch.pipeline.fit import build_face_problem, build_pixel_problem

    solver = config["solver"]
    if config["granularity"] == "pixel":
        return build_pixel_problem(scn, reference_view=config.get("reference_view", 0),
                                   stride=config.get("pixel_stride", 1),
                                   with_geometry=config.get("joint_normalmap", False),
                                   shadow_weights=solver.get("shadow_weights", False))
    return build_face_problem(scn, with_geometry=config.get("joint_normalmap", False),
                              shadow_weights=solver.get("shadow_weights", False))


def texel_keys(config: dict, prob, width: int) -> np.ndarray:
    """The program's texels as the reference keys them: y·W + x of a pixel
    texel, the face id of a face texel."""
    if config["granularity"] == "pixel":
        return prob.pixels[:, 1].astype(np.int64) * width + prob.pixels[:, 0]
    return np.asarray(prob.face_ids, np.int64)


def lm_options(config: dict):
    from brdf_tpu_torch.solver.lm import LMOptions

    s = config["solver"]
    return LMOptions(tau=s["tau"], eps1=s["eps1"], eps2=s["eps2"], eps3=s["eps3"],
                     itmax=s["itmax"])
