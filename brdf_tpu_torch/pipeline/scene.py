# Adapted from brdf_tpu/pipeline/scene.py (the port imports nothing of brdf_tpu).
"""Scene container: mesh + calibrated cameras + light rig + image stacks.

The analogue of ``CBRDFdata``'s data half (``brdfdata.h:54-105``),
generalized: a scene holds V *views*, each (camera, light, image). The
reference's datasets have one fixed camera and 16 LED positions; multi-camera
rigs just vary the camera per view.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import tempfile
import zipfile
from typing import NamedTuple

import numpy as np
import torch

from brdf_tpu_torch.geometry.camera import Camera
from brdf_tpu_torch.geometry.mesh import TriangleMesh
from brdf_tpu_torch.geometry.rasterize import RasterMap, rasterize_mesh
from brdf_tpu_torch.io import load_cal, load_scene_images, led_rig_positions
from brdf_tpu_torch.utils.profiling import count, span

# the disk tier of Scene.raster_map: a directory of this package's own
CACHE_DIR_ENV = "BRDF_TPU_TORCH_CACHE_DIR"


def _default_cache_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "brdf_tpu_torch_cache")


class DeviceMesh(NamedTuple):
    """The mesh on one device, as the device relight reads it
    (``pipeline/render.py::gather_on_device``)."""

    vertices: torch.Tensor        # (V, 3) float32
    faces: torch.Tensor           # (F, 3) int64
    vertex_normals: torch.Tensor  # (V, 3) float32
    face_normals: torch.Tensor    # (F, 3) float32


def device_mesh(mesh: TriangleMesh, device) -> DeviceMesh:
    """Upload ``mesh`` to ``device``."""
    def up(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(device)

    return DeviceMesh(vertices=up(mesh.vertices, np.float32), faces=up(mesh.faces, np.int64),
                      vertex_normals=up(mesh.vertex_normals, np.float32),
                      face_normals=up(mesh.face_normals, np.float32))


class DeviceRasterMap(NamedTuple):
    """A view's raster map on the device of its mesh, in the compact form the
    device relight reads (``pipeline/render.py::shade_device_map``): the
    covered pixels alone, in the raster map's row-major order."""

    height: int
    width: int
    pixels: torch.Tensor          # (N,) int64 flat index y·W + x of each covered pixel
    face_id: torch.Tensor         # (N,) int32 its face
    bary: torch.Tensor            # (N, 3) float32 its barycentrics
    mesh: DeviceMesh              # the mesh it was rasterized from, shared by every view


def device_raster_map(dmesh: DeviceMesh, rm: RasterMap) -> DeviceRasterMap:
    """Upload the covered pixels of ``rm`` to the device of ``dmesh``
    (counted in ``render.device_map_uploads``)."""
    count("render.device_map_uploads")
    h, w = rm.face_id.shape
    cov = rm.coverage.reshape(-1)

    def up(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(dmesh.vertices.device)

    return DeviceRasterMap(
        height=h, width=w,
        pixels=up(np.flatnonzero(cov), np.int64),
        face_id=up(rm.face_id.reshape(-1)[cov], np.int32),
        bary=up(rm.bary.reshape(-1, 3)[cov], np.float32),
        mesh=dmesh,
    )


@dataclasses.dataclass
class Scene:
    mesh: TriangleMesh
    cameras: list[Camera]          # length V (may be the same camera repeated)
    lights: np.ndarray             # (V, 3) light position per view
    images: np.ndarray             # (V, H, W, 3) float32 in [0, 1]
    name: str = "scene"
    _raster_cache: dict = dataclasses.field(default_factory=dict, repr=False)
    _device_maps: dict = dataclasses.field(default_factory=dict, repr=False)
    _device_meshes: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def num_views(self) -> int:
        return len(self.cameras)

    def raster_map(self, view: int = 0) -> RasterMap:
        """Pixel↔surface map for a view (cached in memory per camera object
        and — keyed by a (mesh, camera) content hash — on disk, so repeated
        runs over the same scene skip rasterization entirely; set
        ``BRDF_TPU_TORCH_CACHE_DIR=`` empty to disable the disk tier)."""
        cam = self.cameras[view]
        key = id(cam)
        with span("render.raster_map") as sp:
            hit = "memory"
            if key not in self._raster_cache:
                self._raster_cache[key], hit = self._raster_cached(cam)
            sp.set(hit=hit)
        return self._raster_cache[key]

    def device_map(self, view: int, device) -> DeviceRasterMap:
        """The view's raster map on ``device``, compact
        (:func:`device_raster_map`), kept per (camera object, device) beside
        the raster map it was made from: a raster map made anew (its cache
        cleared) is uploaded anew. The mesh it reads is held once per device."""
        rm = self.raster_map(view)
        dev = torch.device(device)
        mesh = self._device_meshes.get(dev)
        if mesh is None or mesh[0] is not self.mesh:
            mesh = self._device_meshes[dev] = (self.mesh, device_mesh(self.mesh, dev))
        key = (id(self.cameras[view]), dev)
        held = self._device_maps.get(key)
        if held is None or held[0] is not rm or held[1].mesh is not mesh[1]:
            held = self._device_maps[key] = (rm, device_raster_map(mesh[1], rm))
        return held[1]

    def _raster_cached(self, cam: Camera) -> tuple[RasterMap, str]:
        """The map and where it came from: ``"disk"`` or ``"miss"`` (rasterized)."""
        cache_dir = os.environ.get(CACHE_DIR_ENV, _default_cache_dir())
        if not cache_dir:
            return rasterize_mesh(
                cam, np.asarray(self.mesh.vertices), np.asarray(self.mesh.faces)
            ), "miss"
        verts = np.ascontiguousarray(np.asarray(self.mesh.vertices, np.float64))
        faces = np.ascontiguousarray(np.asarray(self.mesh.faces, np.int64))
        hsh = hashlib.sha1()
        hsh.update(verts.tobytes())
        hsh.update(faces.tobytes())
        for field in ("rotation", "position", "f", "cx", "cy", "sx", "kappa1"):
            hsh.update(np.asarray(getattr(cam, field), np.float64).tobytes())
        hsh.update(np.asarray([cam.width, cam.height]).tobytes())
        path = os.path.join(cache_dir, f"raster_{hsh.hexdigest()}.npz")
        if os.path.exists(path):
            try:
                with np.load(path) as z:
                    return RasterMap(
                        face_id=z["face_id"], bary=z["bary"], depth=z["depth"]
                    ), "disk"
            except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile):
                pass  # corrupt/partial cache entry: fall through and rebuild
        rm = rasterize_mesh(cam, verts, faces)
        try:
            os.makedirs(cache_dir, exist_ok=True)
            tmp = path + f".tmp{os.getpid()}.npz"
            np.savez(tmp, face_id=rm.face_id, bary=rm.bary, depth=rm.depth)
            os.replace(tmp, path)
        except OSError:
            pass  # cache dir unwritable: still return the fresh map
        return rm, "miss"

    def eyes(self) -> np.ndarray:
        """(V, 3) camera position per view."""
        return np.stack([np.asarray(c.position) for c in self.cameras])


def load_reference_scene(
    scene_dir: str,
    cal_name: str | None = None,
    num_images: int = 16,
    dtype=np.float32,
) -> Scene:
    """Load a dataset laid out as the reference's (``img/{cup,bunny,timber,complexScene}``):
    16 LED-lit PNGs + dark frame + scanned OBJ + Tsai ``.cal``
    (``main.cpp:26-60`` equivalent, minus the double dark-subtraction bug)."""
    name = os.path.basename(scene_dir.rstrip("/"))
    obj = None
    cal_path = None
    for fn in sorted(os.listdir(scene_dir)):
        if fn.endswith(".obj"):
            obj = os.path.join(scene_dir, fn)
        if fn.endswith(".cal") and (cal_name is None or fn == cal_name):
            cal_path = os.path.join(scene_dir, fn)
    if cal_path is None:
        raise FileNotFoundError(f"no .cal in {scene_dir}")

    images = load_scene_images(scene_dir, num_images)
    v, h, wdt = images.shape[0], images.shape[1], images.shape[2]
    cal = load_cal(cal_path)
    camera = Camera.from_calibration(cal, width=wdt, height=h, dtype=dtype)
    lights = led_rig_positions()[:v]

    if obj is None:
        raise FileNotFoundError(f"no .obj in {scene_dir}")
    mesh = TriangleMesh.from_obj(obj, dtype=dtype)
    return Scene(
        mesh=mesh,
        cameras=[camera] * v,
        lights=lights,
        images=images,
        name=name,
    )
