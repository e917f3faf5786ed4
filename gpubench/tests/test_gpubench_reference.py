"""The plain reference against the program, at tiny sizes on the CPU: the
raster map, the problems, the lobes, the joint model and the relit image,
and the reference fit on its own synthetic scan."""

import copy

import numpy as np
import pytest
import torch

from gpubench import core, program
from gpubench.reference import fit as ref_fit
from gpubench.reference import geometry as geo
from gpubench.reference import judge, lobes
from gpubench.reference import problem as ref_problem
from gpubench.reference import render as ref_render
from gpubench.traffic.scan import make_scan

CPU = torch.device("cpu")


def tiny(cell_name: str, subdiv: int = 2, size=(80, 60)):
    """A cell at a tiny size; a cell with files but no line in the manifest
    yet is named ``<config>.<traffic>``."""
    manifest = core.load_manifest()
    if all(w["name"] != cell_name for w in manifest["workloads"]):
        config, traffic = cell_name.rsplit(".", 1)
        manifest["workloads"].append({"name": cell_name, "config": config, "traffic": traffic,
                                      "chips": 1})
    cell = core.find_cell(manifest, cell_name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["scan"].update(subdiv=subdiv, width=size[0], height=size[1])
    # "auto" is the hand-written tier on a CUDA device, the eager one on the
    # CPU: take the hand-written tier's plain version, as the card runs it
    cell.traffic = copy.deepcopy(cell.traffic)
    if cell.traffic.get("engine") == "auto":
        cell.traffic["engine"] = "pallas"
    if cell.config["solver"].get("engine") == "auto":
        cell.config["solver"]["engine"] = "pallas"
    return cell


@pytest.mark.parametrize("subdiv,size", [(2, (80, 60)), (3, (160, 120))])
@pytest.mark.parametrize("native", [True, False])
def test_raster_map_equals_the_program(subdiv, size, native):
    from brdf_tpu_torch.geometry.rasterize import rasterize_mesh

    cfg = tiny("blinn-pixel-16led.varpro", subdiv, size).config
    scan = make_scan(cfg, 5, 0, device=CPU, images=False)
    scn = program.scene(scan)
    rm = rasterize_mesh(scn.cameras[0], scn.mesh.vertices, scn.mesh.faces, native=native)
    g = scan.geometry
    assert np.array_equal(rm.face_id, g.raster.face_id)
    assert np.array_equal(rm.bary, g.raster.bary)
    assert np.array_equal(rm.depth, g.raster.depth)


@pytest.mark.parametrize("cell_name", ["blinn-pixel-16led.varpro", "ct-joint-face-16led.fit"])
def test_problem_equals_the_program(cell_name):
    cfg = tiny(cell_name).config
    scan = make_scan(cfg, 17, 1, device=CPU)
    prob = program.problem(cfg, program.scene(scan))
    ref = ref_problem.build(scan, cfg)
    assert np.array_equal(program.texel_keys(cfg, prob, cfg["scan"]["width"]), ref.keys)
    assert np.array_equal(np.asarray(prob.intensity), ref.intensity)
    assert np.array_equal(np.asarray(prob.weights), ref.seen)
    pts, nrm, eye, lights, *_ = ref_problem.tensors(ref, CPU)
    c = lobes.cosines(pts, nrm, eye, lights)
    for name, key in (("cos_ln", "ln"), ("cos_nh", "nh"), ("cos_rv", "rv"), ("cos_vn", "vn")):
        got = torch.as_tensor(np.asarray(getattr(prob.angles, name)), dtype=torch.float64)
        assert torch.allclose(got, c[key], atol=1e-6), name


@pytest.mark.parametrize("model", ["blinn_phong", "cook_torrance"])
def test_lobes_equal_the_program(model):
    from brdf_tpu_torch.models.brdf import MODELS, ShadingAngles

    g = torch.Generator().manual_seed(3)
    c = {k: torch.rand(64, 16, generator=g, dtype=torch.float64) * 2 - 1
         for k in ("ln", "nh", "rv", "vn")}
    p = torch.rand(64, 3, generator=g, dtype=torch.float64) + 0.1
    ang = ShadingAngles(cos_ln=c["ln"], cos_nh=c["nh"], cos_rv=c["rv"], cos_vn=c["vn"])
    want = MODELS[model].fn(p, ang)
    got = lobes.LOBES[model](p[:, 0:1], p[:, 1:2], p[:, 2:3], c)
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-12)


def test_joint_model_equals_the_program():
    from brdf_tpu_torch.models.brdf import ShadingGeometry
    from brdf_tpu_torch.models.normalmap import joint_eval, joint_spec

    g = torch.Generator().manual_seed(4)
    n = torch.nn.functional.normalize(torch.randn(32, 3, generator=g, dtype=torch.float64), dim=-1)
    pts = torch.randn(32, 3, generator=g, dtype=torch.float64)
    eye = torch.tensor([0.0, 0.0, 10.0], dtype=torch.float64)
    lights = torch.randn(16, 3, generator=g, dtype=torch.float64) * 5
    l, v = lobes.directions(pts, eye, lights)
    p = torch.rand(32, 9, generator=g, dtype=torch.float64)
    p[:, 7:] = (p[:, 7:] - 0.5) * 0.8
    want = joint_eval(joint_spec("cook_torrance"), p, ShadingGeometry(n=n, l=l, v=v))
    got = ref_fit.joint_model("cook_torrance", n, l, v, p).permute(0, 2, 1)
    assert torch.allclose(got, want, rtol=1e-12, atol=1e-12)


def test_relit_image_equals_the_program():
    from brdf_tpu_torch.pipeline.render import relight

    cfg = tiny("ct-joint-face-16led.relight").config
    scan = make_scan(cfg, 23, 0, device=CPU, images=False)
    light = np.array([150.0, 100.0, 250.0])
    img = relight(cfg["model"], program.scene(scan), scan.params,
                  np.arange(len(scan.geometry.faces)), light[None], device=CPU)
    ref = ref_render.relight(scan.geometry, cfg["model"], scan.params, light[None], CPU)
    assert (ref > 0).sum() > 500
    assert judge.image_gap(img, ref, 0.01) < 1e-4


def test_reference_fit_reproduces_its_scan():
    cfg = tiny("blinn-pixel-16led.varpro").config
    scan = make_scan(cfg, 29, 0, device=CPU)
    prob = ref_problem.build(scan, cfg)
    pts, nrm, eye, lights, y, w = ref_problem.tensors(prob, CPU)
    c = lobes.cosines(pts, nrm, eye, lights)
    p, chi2 = ref_fit.fit_texels(cfg["model"], c, y.permute(0, 2, 1), w.permute(0, 2, 1),
                                 cfg["box"]["lower"], cfg["box"]["upper"], rounds=2)
    pred = ref_fit.texel_model(cfg["model"], c, p)
    wp, yp = w.permute(0, 2, 1), y.permute(0, 2, 1)
    rms = torch.sqrt(((wp * (pred - yp)) ** 2).sum(-1) / (wp > 0).sum(-1).clamp(min=1))
    assert float(rms.median()) < 2e-4
    assert torch.isfinite(chi2).all()


def test_box_ls2_is_exact():
    g = torch.Generator().manual_seed(5)
    a, b = torch.rand(200, 8, generator=g, dtype=torch.float64), torch.rand(200, 8, generator=g,
                                                                          dtype=torch.float64)
    y = torch.rand(200, 8, generator=g, dtype=torch.float64) * 2 - 0.5
    w = torch.ones_like(y)
    kd, ks, obj = ref_fit.box_ls2(a, b, y, w, [0.0, 0.0], [1.0, 1.0])
    grid = torch.linspace(0, 1, 201, dtype=torch.float64)
    kk, ss = torch.meshgrid(grid, grid, indexing="ij")
    brute = ((kk.reshape(1, -1, 1) * a[:, None] + ss.reshape(1, -1, 1) * b[:, None]
              - y[:, None]) ** 2).sum(-1).amin(-1)
    assert (obj <= brute + 1e-12).all()
    assert torch.allclose(obj, ((kd[:, None] * a + ks[:, None] * b - y) ** 2).sum(-1))


def test_scan_sizes_do_not_depend_on_the_seed():
    cfg = tiny("ct-joint-face-16led.fit").config
    a, b = make_scan(cfg, 1, 0, device=CPU), make_scan(cfg, 2**31 + 7, 3, device=CPU)
    assert a.images.shape == b.images.shape and a.params.shape == b.params.shape
    assert np.array_equal(a.geometry.raster.face_id, b.geometry.raster.face_id)
    assert not np.array_equal(a.params, b.params)


def test_pixel_cosines_match_the_texels():
    cfg = tiny("blinn-pixel-16led.varpro").config
    g = make_scan(cfg, 1, 0, device=CPU, images=False).geometry
    tex = geo.pixel_texels(g.vertices, g.faces, g.vertex_normals, g.raster)
    uv, _ = geo.project(g.camera, tex.points)
    assert np.abs(uv - (tex.pixels + 0.5)).max() < 0.5
