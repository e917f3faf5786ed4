"""Write a synthetic scan in the layout of the reference datasets.

    python3 tools/synthetic_scene.py OUT_DIR [--subdiv 5] [--size 800x600]
        [--model cook_torrance] [--seed 0] [--device cuda]

The directory gets what ``pipeline/scene.py::load_reference_scene`` reads
from a real scan: ``scene.obj`` (a sphere with smooth bumps, so that the face
normals vary and some faces shadow others), ``scene.cal`` (a Tsai camera that
``io/cal.py`` reads back), the 16 LED images ``1.png`` … ``16.png`` rendered
under ``io/rig.py``'s rig from known per-face parameters, and the ambient
frame ``dark.png`` added to every image (8-bit RGB, as the scans are). It
also gets ``truth.npz``: the per-face parameters (T, 3, m) the images were
rendered from, the model and the seed.

The images are rendered with the port's own renderer (``render_image`` with
flat shading, so that a per-face fit can reproduce them), from the mesh and
camera as read back from the written files, on ``--device`` (``cuda``
unless another is given). Nothing is random but what ``--seed`` draws.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from brdf_tpu_torch.geometry import Camera, TriangleMesh  # noqa: E402
from brdf_tpu_torch.geometry.primitives import icosphere  # noqa: E402
from brdf_tpu_torch.io import led_rig_positions, load_cal  # noqa: E402
from brdf_tpu_torch.pipeline.render import render_image  # noqa: E402
from brdf_tpu_torch.pipeline.scene import Scene  # noqa: E402

# the object in front of the rig: the closed-loop scene of tests/test_pipeline.py
CENTER = (0.0, 150.0, 120.0)
RADIUS = 30.0
EYE = (0.0, 150.0, 320.0)
DARK = 6          # the ambient frame's 8-bit level
VIEWS = 16


def bumped_sphere(subdiv: int, radius: float = RADIUS, center=CENTER, amplitude: float = 0.06):
    """An icosphere (20·4^subdiv faces) whose radius varies smoothly with the
    direction by up to ``amplitude``."""
    v, f = icosphere(subdiv, radius=1.0)
    d = v / np.linalg.norm(v, axis=-1, keepdims=True)
    bump = np.sin(5.0 * d[:, 0]) * np.sin(4.0 * d[:, 1] + 0.5) * np.cos(3.0 * d[:, 2])
    verts = d * (radius * (1.0 + amplitude * bump))[:, None] + np.asarray(center)
    return verts, f


def face_params(model: str, t: int, rng: np.random.Generator) -> np.ndarray:
    """Per-face, per-channel parameters (T, 3, m) inside the box of every
    preset that fits ``model``, bright enough to fit and mostly below the
    sensor's ceiling."""
    kd = rng.uniform(0.1, 0.6, (t, 3))
    ks = rng.uniform(0.1, 0.5, (t, 3))
    shapes = {
        "blinn_phong": [rng.uniform(3.0, 20.0, (t, 3))],
        "phong": [rng.uniform(3.0, 20.0, (t, 3))],
        "cook_torrance": [rng.uniform(0.2, 0.6, (t, 3))],
        "ward": [rng.uniform(0.2, 0.6, (t, 3))],
    }
    if model not in shapes:
        raise ValueError(f"the synthetic scene renders {tuple(shapes)}, not {model!r}")
    return np.stack([kd, ks, *shapes[model]], axis=-1).astype(np.float32)


def write_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "w") as fh:
        fh.writelines(f"v {x:.6f} {y:.6f} {z:.6f}\n" for x, y, z in verts)
        fh.writelines(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in faces)


def write_cal(path: str, cam: Camera) -> None:
    """The camera as a Tsai ``.cal``: the rotation's rows are the camera
    axes n, o, a in world coordinates, p its position."""
    rot = np.asarray(cam.rotation, np.float64)
    tags = {"camera_model": "CameraTsai", "cx": float(cam.cx), "cy": float(cam.cy),
            "f": float(cam.f), "sx": float(cam.sx), "kappa1": float(cam.kappa1)}
    for name, vec in zip("noap", (rot[0], rot[1], rot[2], np.asarray(cam.position))):
        tags.update({f"{name}{axis}": float(x) for axis, x in zip("xyz", vec)})
    with open(path, "w") as fh:
        fh.writelines(f"<{k}>{v}</{k}>\n" for k, v in tags.items())


def _write_png(path: str, img: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(img).save(path)


def write_scene(out_dir: str, subdiv: int = 5, width: int = 800, height: int = 600,
                model: str = "cook_torrance", seed: int = 0, device=None) -> dict:
    """Write the scene into ``out_dir`` (created); returns ``truth.npz``'s
    contents."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    verts, faces = bumped_sphere(subdiv)
    obj = os.path.join(out_dir, "scene.obj")
    cal = os.path.join(out_dir, "scene.cal")
    write_obj(obj, verts, faces)
    # the focal length that puts the sphere's diameter over 60% of the height
    f = 0.3 * height * (EYE[2] - CENTER[2]) / RADIUS
    write_cal(cal, Camera.look_at(EYE, CENTER, up=(0.0, 1.0, 0.0), f=f, width=width,
                                  height=height, dtype=np.float64))

    # render from the files as a reader gets them back
    mesh = TriangleMesh.from_obj(obj, dtype=np.float32)
    cam = Camera.from_calibration(load_cal(cal), width=width, height=height, dtype=np.float32)
    t = mesh.num_faces
    params = face_params(model, t, rng)
    scene = Scene(mesh=mesh, cameras=[cam] * VIEWS, lights=led_rig_positions()[:VIEWS],
                  images=np.zeros((VIEWS, height, width, 3), np.float32), name="synthetic")
    dark = np.full((height, width, 3), DARK, np.uint8)
    _write_png(os.path.join(out_dir, "dark.png"), dark)
    for vi in range(VIEWS):
        img = render_image(model, scene, params, np.arange(t), view=vi, use_vertex_normals=False,
                           device=device)
        lit = np.clip(np.round(np.clip(img, 0.0, 1.0) * 255.0) + DARK, 0, 255).astype(np.uint8)
        _write_png(os.path.join(out_dir, f"{vi + 1}.png"), lit)
    truth = {"params": params, "model": model, "seed": seed}
    np.savez(os.path.join(out_dir, "truth.npz"), **truth)
    return truth


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("out_dir")
    p.add_argument("--subdiv", type=int, default=5, help="20·4^subdiv faces (5: 20480)")
    p.add_argument("--size", default="800x600", help="WIDTHxHEIGHT of the images")
    p.add_argument("--model", default="cook_torrance")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="where the images render (default cuda)")
    args = p.parse_args(argv)
    width, height = (int(x) for x in args.size.split("x"))
    write_scene(args.out_dir, subdiv=args.subdiv, width=width, height=height, model=args.model,
                seed=args.seed, device=args.device)
    print(args.out_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
