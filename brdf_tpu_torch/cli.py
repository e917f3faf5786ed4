# Adapted from brdf_tpu/cli.py (the port imports nothing of brdf_tpu).
"""Command-line interface of the port: ``python -m brdf_tpu_torch``.

The JAX package's subcommands over the batch pipeline, with the same options
and the same run directory (``events.jsonl``, ``config.json`` and the fit
state of ``utils/checkpoint.py``), so a run written by either package
renders, exports and relights in the other:

    python -m brdf_tpu_torch fit --preset bunny-ct --out runs/bunny
    python -m brdf_tpu_torch fit --scene <scene dir> --model blinn_phong --out runs/cup
    python -m brdf_tpu_torch render --run runs/bunny --view 0
    python -m brdf_tpu_torch relight --run runs/bunny --light 300,150,300
    python -m brdf_tpu_torch presets

Every command takes ``--device`` (default ``cuda``; ``cpu`` runs the kernels'
plain versions). Without a CUDA device a command that computes raises
unless it is given ``--device cpu``: nothing falls back to the CPU quietly.

``--multihost`` runs a command on every rank of a ``torch.distributed``
world (``parallel/mesh.py::initialize_multihost``): from ``torchrun``'s
environment, or ``--coordinator host:port --num-processes N --process-id
I``; alone on one process it changes nothing. ``fit`` then lays the ranks
out as the config's ``sharding`` says (``data`` × ``view`` for a per-texel
fit, ``data`` × 1 for the joint fit, as the JAX CLI does), every rank fits
its block, and rank 0 alone writes the run directory.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np


def _build_scene(cfg):
    from brdf_tpu_torch.io.rig import led_rig_positions
    from brdf_tpu_torch.pipeline.scene import load_reference_scene

    scene = load_reference_scene(
        cfg.scene.scene_dir,
        cal_name=cfg.scene.cal_name,
        num_images=cfg.scene.num_images,
    )
    scene.lights = led_rig_positions(cfg.scene.rig)[: scene.num_views]
    if cfg.scene.views is not None:
        idx = list(cfg.scene.views)
        scene.cameras = [scene.cameras[i] for i in idx]
        scene.lights = scene.lights[idx]
        scene.images = scene.images[idx]
    return scene


def _host(x) -> np.ndarray:
    from brdf_tpu_torch.pipeline.fit import _to_numpy

    return _to_numpy(x)


def _device(args):
    """This rank's device of ``--device`` (a bare ``cuda`` is the rank's own card)."""
    from brdf_tpu_torch.device import rank_device

    return rank_device(args.device)


def cmd_fit(args) -> int:
    from brdf_tpu_torch.configs import PRESETS, FitConfig, ModelConfig, SceneConfig, SolverConfig
    from brdf_tpu_torch.parallel.mesh import process_index
    from brdf_tpu_torch.utils.logging import EventLog
    from brdf_tpu_torch.utils.profiling import profiler_trace

    dev = _device(args)
    if args.preset:
        cfg = PRESETS[args.preset]
    elif args.config:
        with open(args.config) as fh:
            cfg = FitConfig.from_json(fh.read())
    else:
        if not args.scene:
            print("need --preset, --config, or --scene", file=sys.stderr)
            return 2
        cfg = FitConfig(
            scene=SceneConfig(scene_dir=args.scene),
            model=ModelConfig(model=args.model),
            solver=SolverConfig(
                engine=args.engine,
                robust=args.robust if args.robust != "none" else None,
            ),
        )
    out = args.out or f"runs/{cfg.name}"
    if process_index() == 0:
        os.makedirs(out, exist_ok=True)
    log = EventLog(os.path.join(out, "events.jsonl"))
    profile = getattr(args, "profile", None) if process_index() == 0 else None
    try:
        with profiler_trace(profile):
            _fit(args, cfg, dev, out, log)
    finally:
        log.close()
    return 0


def _fit(args, cfg, dev, out, log) -> None:
    import torch

    from brdf_tpu_torch.models.brdf import MODELS
    from brdf_tpu_torch.parallel.mesh import make_mesh, process_index
    from brdf_tpu_torch.pipeline.fit import (
        build_face_problem,
        fit_joint_normalmap,
        fit_per_texel,
        fit_single_material,
    )
    from brdf_tpu_torch.utils.checkpoint import save_fit_state
    from brdf_tpu_torch.utils.logging import fit_summary_event

    def synced_secs(t0):
        # the fit's device work is asynchronous: its time ends when the device is done
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return round(time.time() - t0, 2)

    t0 = time.time()
    scene = _build_scene(cfg)
    log("scene_loaded", name=scene.name, views=scene.num_views,
        faces=scene.mesh.num_faces, secs=round(time.time() - t0, 2))

    # the device's first use (CUDA context creation) apart from real work
    t0 = time.time()
    torch.zeros((1,), device=dev).cpu()
    log("device_ready", backend=dev.type,
        device=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        secs=round(time.time() - t0, 2))

    t0 = time.time()
    shadow = cfg.solver.shadow_weights or getattr(args, "shadow_weights", False)
    tangent = MODELS[cfg.model.model].tangent   # aniso lobes need the frame
    if cfg.model.granularity == "pixel":
        from brdf_tpu_torch.pipeline.fit import build_pixel_problem

        problem = build_pixel_problem(
            scene,
            reference_view=cfg.model.reference_view,
            stride=cfg.model.pixel_stride,
            with_geometry=cfg.model.joint_normalmap,
            tangent_frame=tangent,
            shadow_weights=shadow,
            shadow_resolution=cfg.solver.shadow_resolution,
        )
    else:
        problem = build_face_problem(
            scene, with_geometry=cfg.model.joint_normalmap,
            tangent_frame=tangent,
            shadow_weights=shadow,
            shadow_resolution=cfg.solver.shadow_resolution,
        )
    extra = {}
    if shadow:
        w = _host(problem.weights)
        extra["zero_weight_frac"] = round(float((w == 0).mean()), 4)
    log("problem_built", texels=len(problem.face_ids),
        granularity=cfg.model.granularity, secs=round(time.time() - t0, 2),
        shadow_weights=shadow, **extra)

    t0 = time.time()
    opts = cfg.solver.lm_options()
    if not cfg.model.per_texel:
        params = _host(fit_single_material(problem, cfg.model.model, opts=opts, device=dev))
        log("fit_done", mode="single_material", secs=synced_secs(t0),
            params=params.tolist())
        arrays = {"params": params, "face_ids": problem.face_ids}
    elif cfg.model.joint_normalmap:
        joint_kw = dict(
            opts=opts, max_tilt=cfg.model.max_tilt,
            engine=cfg.solver.engine,
            mesh=make_mesh(data=cfg.sharding.data, view=1, device=dev),
            robust=cfg.solver.robust,
            robust_iters=cfg.solver.robust_iters,
        )
        gains = None
        if cfg.solver.fit_view_gains:
            from brdf_tpu_torch.pipeline.fit import fit_joint_normalmap_with_gains

            res, jspec, gains = fit_joint_normalmap_with_gains(
                problem, cfg.model.model,
                rounds=cfg.solver.view_gain_rounds,
                mask_saturation=cfg.solver.mask_saturation,
                **joint_kw,
            )
        else:
            res, jspec = fit_joint_normalmap(
                problem, cfg.model.model,
                mask_saturation=cfg.solver.mask_saturation,
                **joint_kw,
            )
        log("fit_done", mode="joint_normalmap", secs=synced_secs(t0),
            mask_saturation=cfg.solver.mask_saturation,
            robust=cfg.solver.robust,
            view_gains=None if gains is None
            else [round(float(g), 4) for g in gains])
        fit_summary_event(res)
        arrays = {"joint_params": _host(res.p), "face_ids": problem.face_ids,
                  "chi2": _host(res.chi2)}
        if gains is not None:
            arrays["view_gains"] = np.asarray(gains, np.float32)
    else:
        checkpointer = None
        if getattr(args, "chunk_iters", 0):
            from brdf_tpu_torch.utils.checkpoint import FitCheckpointer

            checkpointer = FitCheckpointer(os.path.join(out, "solver_ckpt"))
        report = fit_per_texel(
            problem, cfg.model.model, opts=opts,
            mesh=make_mesh(data=cfg.sharding.data, view=cfg.sharding.view, device=dev),
            engine=cfg.solver.engine,
            mask_saturation=cfg.solver.mask_saturation,
            robust=cfg.solver.robust,
            robust_iters=cfg.solver.robust_iters,
            checkpointer=checkpointer,
            chunk_iters=getattr(args, "chunk_iters", 0) or 0,
            resume=not getattr(args, "no_resume", False),
            lower=cfg.solver.lower, upper=cfg.solver.upper,
        )
        log("fit_done", mode="per_texel", secs=synced_secs(t0),
            converged=report.converged_fraction(), chi2=report.chi2_summary())
        fit_summary_event(report.result)
        arrays = {"params": _host(report.params), "face_ids": report.face_ids,
                  "chi2": _host(report.result.chi2)}
        if getattr(args, "stats", False):
            # levmar-style post-fit analytics (dlevmar_covar/stddev/R2),
            # opt-in
            stats = report.statistics(problem)
            arrays["stddev"] = stats["stddev"]
            arrays["r2"] = stats["r2"]
            log("fit_statistics",
                r2_median=float(np.nanmedian(stats["r2"])),
                stddev_median=float(np.nanmedian(stats["stddev"])))
        if problem.pixels is not None:
            arrays["pixels"] = problem.pixels
            arrays["points"] = problem.points
            arrays["normals"] = problem.normals

    if process_index() != 0:
        return          # every rank holds the whole result: rank 0 writes it
    save_fit_state(out, 0, arrays, metadata={
        "config": dataclasses.asdict(cfg), "model": cfg.model.model,
        "mode": ("single" if not cfg.model.per_texel else
                 "joint" if cfg.model.joint_normalmap else "per_texel"),
    }, process=(0, 1))
    with open(os.path.join(out, "config.json"), "w") as fh:
        fh.write(cfg.to_json())
    log("saved", out=out)


def _load_run(run: str):
    from brdf_tpu_torch.configs import FitConfig
    from brdf_tpu_torch.utils.checkpoint import load_fit_state

    arrays, meta = load_fit_state(run)
    with open(os.path.join(run, "config.json")) as fh:
        cfg = FitConfig.from_json(fh.read())
    return arrays, meta, cfg


def _expand_params(arrays: dict, meta: dict, scene):
    """(params (T,C,m), face_ids (T,), normal_offsets | None) from a saved run
    of any fit mode (per-texel / single-material / joint normal-map)."""
    if meta["mode"] == "per_texel":
        return arrays["params"], arrays["face_ids"], None
    if meta["mode"] == "single":
        t = scene.mesh.num_faces
        params = np.broadcast_to(
            arrays["params"][None], (t,) + arrays["params"].shape
        ).copy()
        return params, np.arange(t), None
    # joint run: (T, 8+k) — expand to per-channel (T, 3, m_base); offsets
    # live after the k shape columns (k=1 isotropic → cols 7:9, k=3 aniso
    # → cols 9:11)
    from brdf_tpu_torch.models.brdf import MODELS

    jp = arrays["joint_params"]
    k = MODELS[meta["model"]].n_params - 2
    params = np.stack(
        [np.concatenate(
            [jp[:, c : c + 1], jp[:, 3 + c : 4 + c], jp[:, 6 : 6 + k]], -1
        ) for c in range(3)], 1
    )
    return params, arrays["face_ids"], jp[:, 6 + k : 8 + k].astype(np.float32)


def _save_png(img: np.ndarray, out: str) -> None:
    from PIL import Image

    Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(out)


def _parse_env(spec: str) -> np.ndarray:
    """``constant:V`` or a path to a lat-long ``.npy``/``.npz`` radiance map
    (H, W, 3), linear units."""
    if spec.startswith("constant:"):
        return np.full((64, 128, 3), float(spec.split(":", 1)[1]), np.float64)
    if spec.endswith(".npz"):
        data = np.load(spec)
        return np.asarray(data[list(data.keys())[0]], np.float64)
    return np.asarray(np.load(spec), np.float64)


def _parse_lights(args):
    if not args.light:
        return None
    return np.asarray([[float(x) for x in spec.split(",")] for spec in args.light])


def cmd_export(args) -> int:
    """Write fitted-parameter maps and summary statistics.

    The reference's only inspection of the fit was printing kd/ks/n averages
    to stdout (``brdfdata.cpp:1224-1226``); this exports each parameter as a
    min-max-normalized image laid out by a view's raster map, the raw arrays
    (npz), and per-channel mean/median/min/max stats (summary.json). Host
    NumPy, but for ``--residual`` (a render) and ``--stats`` (the
    reprojection audit), which run on ``--device``."""
    from brdf_tpu_torch.models.brdf import MODELS

    dev = _device(args)
    arrays, meta, cfg = _load_run(args.run)
    scene = _build_scene(cfg)
    params, face_ids, _ = _expand_params(arrays, meta, scene)   # (T, C, m)
    spec = MODELS[cfg.model.model]
    out = args.out or os.path.join(args.run, "maps")
    os.makedirs(out, exist_ok=True)

    t, c, m = params.shape
    view = args.view
    if arrays.get("pixels") is not None and view != cfg.model.reference_view:
        # pixel-granularity texels ARE pixels of the fit's reference view:
        # laying them out by another view's camera would tint the wrong
        # pixels, so the export pins itself to the reference view
        print(
            f"WARNING: pixel-granularity run was fit against view "
            f"{cfg.model.reference_view}; exporting by that view instead "
            f"of --view {view}",
            file=sys.stderr,
        )
        view = cfg.model.reference_view
    cam = scene.cameras[view]
    if arrays.get("pixels") is not None:
        px = np.asarray(arrays["pixels"])
        cov_mask = np.zeros((cam.height, cam.width), bool)
        cov_mask[px[:, 1], px[:, 0]] = True

        def to_image(vals):                     # (T, C) → (H, W, C)
            img = np.zeros((cam.height, cam.width, c), np.float32)
            img[px[:, 1], px[:, 0]] = vals
            return img
    else:
        rm = scene.raster_map(view)
        lut = np.full(scene.mesh.num_faces, -1, np.int64)
        lut[np.asarray(face_ids)] = np.arange(t)
        fid = rm.face_id
        cov = (fid >= 0) & (lut[np.maximum(fid, 0)] >= 0)
        cov_mask = cov

        def to_image(vals):
            img = np.zeros((*fid.shape, c), np.float32)
            img[cov] = vals[lut[fid[cov]]]
            return img

    summary_residual = None
    if getattr(args, "residual", False):
        # signed photo-minus-render residual for --view (red = photo
        # brighter than the model, blue = darker)
        from brdf_tpu_torch.pipeline.diagnostics import residual_view_image

        if arrays.get("pixels") is not None:
            from brdf_tpu_torch.pipeline.render import render_pixel_fit

            render = render_pixel_fit(
                cfg.model.model, scene, arrays["params"], arrays["pixels"],
                arrays["points"], arrays["normals"], view=view, device=dev,
            )
        else:
            from brdf_tpu_torch.pipeline.render import render_image

            p_exp, fids_exp, offs = _expand_params(arrays, meta, scene)
            render = render_image(
                cfg.model.model, scene, p_exp, fids_exp, view=view,
                normal_offsets=offs, device=dev,
            )
        if arrays.get("view_gains") is not None:
            # a gains run's forward model of the SCAN is g_v · model(params)
            render = np.asarray(render) * float(arrays["view_gains"][view])
        rgb, summary_residual = residual_view_image(scene, view, render)
        res_path = os.path.join(out, f"residual_view{view}.png")
        _save_png(rgb, res_path)
        print(res_path)

    if getattr(args, "coverage", False):
        # pixel↔surface-map overlay over the photo (the reference's
        # DrawMapping diagnostic, glutcallbacks.cpp:645-661): fitted-texel
        # coverage tinted green at full brightness, the rest dimmed
        photo = np.asarray(scene.images[view], np.float32)
        overlay = photo * 0.35
        overlay[cov_mask] = np.clip(
            photo[cov_mask] * 0.65 + np.float32([0.05, 0.35, 0.05]), 0, 1
        )
        cov_path = os.path.join(out, f"coverage_view{view}.png")
        _save_png(overlay, cov_path)
        print(cov_path)

    summary = {"model": cfg.model.model, "texels": int(t)}
    if summary_residual is not None:
        summary["residual"] = summary_residual
    if meta["mode"] == "joint":
        # fitted normal map: tangent offsets (ou, ov) → an RG=offset / B=z
        # normal-map visualization + raw offsets in the npz
        jp = np.asarray(arrays["joint_params"])
        k_sh = spec.n_params - 2
        off = jp[:, 6 + k_sh : 8 + k_sh]                  # (T, 2)
        z = np.sqrt(np.clip(1.0 - (off ** 2).sum(-1), 0.0, 1.0))
        rgb = np.stack([off[:, 0] * 0.5 + 0.5,
                        off[:, 1] * 0.5 + 0.5, z], -1)    # (T, 3)
        _save_png(to_image(rgb.astype(np.float32)),
                  os.path.join(out, "param_normalmap.png"))
        summary["normal_offset"] = {
            "median_abs": [float(np.median(np.abs(off[:, 0]))),
                           float(np.median(np.abs(off[:, 1])))],
            "max_abs": float(np.abs(off).max()),
        }
    for j, pname in enumerate(spec.param_names[:m]):
        vals = np.asarray(params[:, :, j])      # (T, C)
        lo, hi = float(vals.min()), float(vals.max())
        norm = (vals - lo) / max(hi - lo, 1e-12)
        _save_png(to_image(norm.astype(np.float32)),
                  os.path.join(out, f"param_{pname}.png"))
        summary[pname] = {
            "min": lo, "max": hi,
            "mean": [float(x) for x in vals.mean(0)],
            "median": [float(x) for x in np.median(vals, 0)],
        }
    np.savez_compressed(os.path.join(out, "params.npz"),
                        params=params, face_ids=face_ids)
    if getattr(args, "stats", False):
        metrics = _run_quality_metrics(arrays, meta, cfg, scene, params, face_ids, dev)
        with open(os.path.join(out, "metrics.json"), "w") as fh:
            json.dump(metrics, fh, indent=1)
        summary["quality"] = {
            "reprojection_mae": metrics["reprojection_mae"],
            "warnings": metrics["warnings"],
        }
        for w in metrics["warnings"]:
            print(f"WARNING: {w}", file=sys.stderr)
    with open(os.path.join(out, "summary.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    print(json.dumps(summary))
    return 0


def _run_quality_metrics(arrays, meta, cfg, scene, params, face_ids, dev):
    """Rebuild the fit problem for a saved run and audit the fit against the
    measured photos (``pipeline.fit.fit_quality_metrics``). For joint
    normal-map runs the reprojection uses the FITTED per-texel normals."""
    import torch

    from brdf_tpu_torch.models.brdf import MODELS, ShadingAngles, ShadingGeometry
    from brdf_tpu_torch.pipeline.fit import (
        build_face_problem,
        build_pixel_problem,
        fit_quality_metrics,
    )

    joint = meta["mode"] == "joint"
    tangent = MODELS[cfg.model.model].tangent
    if cfg.model.granularity == "pixel":
        problem = build_pixel_problem(
            scene, reference_view=cfg.model.reference_view,
            stride=cfg.model.pixel_stride, with_geometry=joint,
            tangent_frame=tangent,
        )
    else:
        problem = build_face_problem(
            scene, with_geometry=joint, tangent_frame=tangent
        )
    if len(problem.face_ids) != len(face_ids) or not np.array_equal(
        np.asarray(problem.face_ids), np.asarray(face_ids)
    ):
        # The rebuilt problem keeps only *visible* faces, which can differ
        # from the saved run's texel set (e.g. single-material runs expand
        # params to every mesh face): align params to the problem's texels.
        lut = np.full(scene.mesh.num_faces, -1, np.int64)
        lut[np.asarray(face_ids)] = np.arange(len(face_ids))
        sel = lut[np.asarray(problem.face_ids)]
        if (sel < 0).any():    # texels the saved run never fit: drop them
            keep = sel >= 0
            problem = problem._replace(
                angles=ShadingAngles(*(None if a is None else a[keep] for a in problem.angles)),
                intensity=np.asarray(problem.intensity)[keep],
                weights=np.asarray(problem.weights)[keep],
                face_ids=np.asarray(problem.face_ids)[keep],
                geometry=None if problem.geometry is None else
                ShadingGeometry(*(a[keep] for a in problem.geometry)),
            )
            sel = sel[keep]
        params = np.asarray(params)[sel]
    else:
        sel = None
    if joint:
        from brdf_tpu_torch.models.normalmap import perturbed_angles

        jp = arrays["joint_params"]
        if sel is not None:
            jp = jp[sel]
        k_sh = MODELS[cfg.model.model].n_params - 2
        geom = ShadingGeometry(*(torch.as_tensor(np.asarray(a)) for a in problem.geometry))
        with torch.no_grad():
            ang = perturbed_angles(
                geom,
                torch.as_tensor(np.asarray(jp[:, 6 + k_sh], np.float32)),
                torch.as_tensor(np.asarray(jp[:, 7 + k_sh], np.float32)),
                tangent_frame=tangent,
            )
        problem = problem._replace(angles=ang)
    return fit_quality_metrics(
        problem, params, cfg.model.model,
        lower=cfg.solver.lower, upper=cfg.solver.upper,
        chi2=arrays.get("chi2"),
        joint_normals=joint,
        view_gains=arrays.get("view_gains"),
        device=dev,
    )


def cmd_render(args) -> int:
    dev = _device(args)
    out = _render_run(args, dev)
    print(out)
    if not getattr(args, "watch", False):
        return 0
    # `--watch`: re-render whenever the run's fit state advances (a chunked/
    # checkpointed fit writing new steps, or a refit into the same run dir) —
    # the offline counterpart of the reference's keypress-triggered
    # re-shading loop (`m` after `c`, glutcallbacks.cpp:815-828, :344-446)
    import itertools

    from brdf_tpu_torch.utils.checkpoint import latest_step

    def sig():
        step = latest_step(args.run)
        manifest = os.path.join(args.run, f"step_{step}", "manifest.json")
        try:
            return (step, os.path.getmtime(manifest))
        except OSError:
            return (step, None)

    seen = sig()
    polls = getattr(args, "watch_count", 0)
    for _ in range(polls) if polls else itertools.count():
        time.sleep(args.watch_interval)
        cur = sig()
        if cur != seen:
            seen = cur
            print(_render_run(args, dev), flush=True)
    return 0


def _render_run(args, dev) -> str:
    from brdf_tpu_torch.pipeline.render import render_image

    arrays, meta, cfg = _load_run(args.run)
    scene = _build_scene(cfg)
    lights = _parse_lights(args)
    env = _parse_env(args.env) if getattr(args, "env", None) else None
    out = args.out or os.path.join(args.run, f"render_view{args.view}.png")
    if meta["mode"] == "per_texel" and "pixels" in arrays:
        if env is not None:
            from brdf_tpu_torch.pipeline.envlight import env_to_lights, shade_env_samples

            dirs, rad = env_to_lights(env, n=args.env_samples, method=args.env_method)
            cam = scene.cameras[args.view]
            c = arrays["params"].shape[1]
            shaded = shade_env_samples(
                cfg.model.model,
                arrays["params"],
                np.asarray(arrays["points"], np.float32),
                np.asarray(arrays["normals"], np.float32),
                np.asarray(cam.position),
                dirs, rad[:, :c], device=dev,
            )
            img = np.zeros((cam.height, cam.width, c), np.float32)
            px = arrays["pixels"]
            img[px[:, 1], px[:, 0]] = _host(shaded)
        else:
            from brdf_tpu_torch.pipeline.render import render_pixel_fit

            img = render_pixel_fit(
                cfg.model.model, scene, arrays["params"], arrays["pixels"],
                arrays["points"], arrays["normals"],
                view=args.view, lights=lights, device=dev,
            )
    else:
        params, face_ids, offsets = _expand_params(arrays, meta, scene)
        if env is not None:
            from brdf_tpu_torch.pipeline.envlight import relight_env

            img = relight_env(
                cfg.model.model, scene, params, face_ids, env,
                view=args.view, n_samples=args.env_samples,
                method=args.env_method, device=dev,
            )
        else:
            img = render_image(
                cfg.model.model, scene, params, face_ids, view=args.view,
                lights=lights, normal_offsets=offsets, device=dev,
            )
            if lights is None and arrays.get("view_gains") is not None:
                # rendering a SCAN view under its own LED: a gains run's
                # forward model of the scan is g_v · model(params). Custom
                # lights, environments and turntables are material-space
                # and ignore the gains (they are the rig's, not the material's)
                img = np.asarray(img) * float(arrays["view_gains"][args.view])
    _save_png(img, out)
    return out


def cmd_turntable(args) -> int:
    """Offline orbit preview — the replacement for the reference's interactive
    GLUT window (mouse orbit + headlight BRDF preview)."""
    from brdf_tpu_torch.pipeline.render import (
        orbit_cameras,
        render_pixels,
        render_turntable,
        splat_points,
    )

    dev = _device(args)
    arrays, meta, cfg = _load_run(args.run)
    scene = _build_scene(cfg)
    size = tuple(int(x) for x in args.size.split("x"))
    lights = _parse_lights(args)
    headlight = lights is None and not args.scene_lights

    if meta["mode"] == "per_texel" and "pixels" in arrays:
        import torch

        cams = orbit_cameras(
            scene.mesh, frames=args.frames, elevation_deg=args.elevation,
            size=size,
        )
        frames = []
        for cam in cams:
            l_frame = (
                np.asarray(cam.position, np.float32)[None]
                if headlight else (lights if lights is not None else scene.lights)
            )
            with torch.no_grad():
                shaded = render_pixels(
                    cfg.model.model, arrays["params"],
                    np.asarray(arrays["points"], np.float32),
                    np.asarray(arrays["normals"], np.float32),
                    np.asarray(cam.position), np.asarray(l_frame, np.float32), device=dev,
                )
            frames.append(splat_points(cam, arrays["points"], _host(shaded)))
        frames = np.stack(frames)
    else:
        params, face_ids, offsets = _expand_params(arrays, meta, scene)
        frames = render_turntable(
            cfg.model.model, scene, params, face_ids, frames=args.frames,
            elevation_deg=args.elevation, size=size, lights=lights,
            headlight=headlight, normal_offsets=offsets, device=dev,
        )

    outdir = args.out or args.run
    os.makedirs(outdir, exist_ok=True)
    paths = []
    for i, img in enumerate(frames):
        p = os.path.join(outdir, f"turntable_{i:03d}.png")
        _save_png(img, p)
        paths.append(p)
    if args.gif:
        from PIL import Image

        ims = [Image.open(p).convert("RGB") for p in paths]
        gif = os.path.join(outdir, "turntable.gif")
        ims[0].save(gif, save_all=True, append_images=ims[1:],
                    duration=args.gif_ms, loop=0)
        print(gif)
    else:
        print("\n".join(paths))
    return 0


def cmd_presets(args) -> int:
    from brdf_tpu_torch.configs import PRESETS

    for name, cfg in PRESETS.items():
        print(f"{name:18s} {cfg.model.model:22s} "
              f"{'single' if not cfg.model.per_texel else 'per-texel':9s} "
              f"{cfg.scene.scene_dir}")
    return 0


def cmd_info(args) -> int:
    import torch

    from brdf_tpu_torch.parallel.mesh import process_count, process_index

    cuda = torch.cuda.is_available()
    print(json.dumps({
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "cuda_available": cuda,
        "device_count": torch.cuda.device_count() if cuda else 0,
        "devices": [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
        if cuda else [],
        "process_count": process_count(),
        "process_index": process_index(),
    }, indent=2))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="brdf_tpu_torch")
    p.add_argument("--multihost", action="store_true",
                   help="run on every rank of a torch.distributed world (torchrun's "
                        "environment, or --coordinator/--num-processes/--process-id)")
    p.add_argument("--coordinator", default=None,
                   help="coordinator address host:port, or an init-method URL (multihost)")
    p.add_argument("--num-processes", type=int, default=None,
                   dest="num_processes")
    p.add_argument("--process-id", type=int, default=None, dest="process_id")
    sub = p.add_subparsers(dest="cmd", required=True)

    def device_arg(sp):
        sp.add_argument("--device", default="cuda",
                        help="where the command computes: cuda (default) or cpu")

    f = sub.add_parser("fit", help="fit BRDF parameters for a scene")
    f.add_argument("--preset")
    f.add_argument("--config")
    f.add_argument("--scene")
    f.add_argument("--model", default="blinn_phong")
    f.add_argument("--engine", default="auto",
                   choices=["auto", "pallas", "xla", "varpro"],
                   help="solver tier for ad-hoc --scene fits (presets carry "
                        "their own); varpro = profiled variable projection")
    f.add_argument("--robust", default="none",
                   choices=["none", "huber", "cauchy", "tukey"],
                   help="IRLS robust reweighting for ad-hoc --scene fits")
    f.add_argument("--out")
    f.add_argument("--stats", action="store_true",
                   help="save per-texel stddev/R² (levmar dlevmar_covar-style)")
    f.add_argument("--shadow-weights", action="store_true",
                   dest="shadow_weights",
                   help="zero-weight (texel, light) pairs in cast shadow "
                        "(shadow maps from each LED; the reference fit "
                        "shadowed pixels as if lit)")
    f.add_argument("--chunk-iters", type=int, default=0, dest="chunk_iters",
                   help="checkpoint solver state every N outer iterations "
                        "(per-texel fits; a killed run resumes automatically)")
    f.add_argument("--no-resume", action="store_true", dest="no_resume",
                   help="ignore existing solver checkpoints and refit")
    f.add_argument("--profile", metavar="DIR",
                   help="write where the fit's time goes into DIR: a Chrome trace of the "
                        "host and the device with the program's spans (trace.json) and "
                        "each span's count, total and self time (spans.json)")
    device_arg(f)
    f.set_defaults(fn=cmd_fit)

    def _env_args(sp):
        sp.add_argument(
            "--env",
            help="environment relight: lat-long .npy/.npz radiance map or "
                 "constant:VALUE (image-based lighting; overrides --light)",
        )
        sp.add_argument("--env-samples", type=int, default=256,
                        dest="env_samples")
        sp.add_argument("--env-method", default="importance",
                        choices=["importance", "uniform"], dest="env_method")

    r = sub.add_parser("render", help="render from a fitted run")
    r.add_argument("--run", required=True)
    r.add_argument("--view", type=int, default=0)
    r.add_argument("--light", action="append",
                   help="x,y,z world position (repeatable); default = the view's LED")
    r.add_argument("--out")
    r.add_argument("--watch", action="store_true",
                   help="keep running: re-render --out whenever the run's "
                        "fit state advances (live preview via a file viewer)")
    r.add_argument("--watch-interval", type=float, default=2.0,
                   dest="watch_interval")
    r.add_argument("--watch-count", type=int, default=0, dest="watch_count",
                   help="stop after N polls (0 = forever)")
    _env_args(r)
    device_arg(r)
    r.set_defaults(fn=cmd_render)

    rl = sub.add_parser("relight",
                        help="alias of render with explicit lights or --env")
    rl.add_argument("--run", required=True)
    rl.add_argument("--view", type=int, default=0)
    rl.add_argument("--light", action="append")
    rl.add_argument("--out")
    _env_args(rl)
    device_arg(rl)
    rl.set_defaults(fn=cmd_render)

    ex = sub.add_parser(
        "export",
        help="fitted-parameter maps (one PNG per parameter) + summary stats",
    )
    ex.add_argument("--run", required=True)
    ex.add_argument("--view", type=int, default=0,
                    help="view whose raster map lays out the images")
    ex.add_argument("--out", help="default: <run>/maps")
    ex.add_argument("--stats", action="store_true",
                    help="also compute the fit-quality audit (reprojection "
                         "error, fraction-at-bounds, warnings) → metrics.json")
    ex.add_argument("--coverage", action="store_true",
                    help="write a pixel↔surface-map overlay PNG for --view "
                         "(fitted coverage tinted over the photo)")
    ex.add_argument("--residual", action="store_true",
                    help="write a signed photo-minus-render residual PNG "
                         "for --view (red = photo brighter than the model "
                         "— interreflections; blue = darker — shadows)")
    device_arg(ex)
    ex.set_defaults(fn=cmd_export)

    tt = sub.add_parser(
        "turntable",
        help="render an orbit around the fitted object (the interactive-"
             "preview replacement); headlight at the eye by default",
    )
    tt.add_argument("--run", required=True)
    tt.add_argument("--frames", type=int, default=12)
    tt.add_argument("--elevation", type=float, default=20.0)
    tt.add_argument("--size", default="512x512")
    tt.add_argument("--light", action="append",
                    help="fixed x,y,z light (repeatable; disables headlight)")
    tt.add_argument("--scene-lights", action="store_true", dest="scene_lights",
                    help="use the scene's LED rig instead of a headlight")
    tt.add_argument("--gif", action="store_true",
                    help="also write turntable.gif")
    tt.add_argument("--gif-ms", type=int, default=120, dest="gif_ms")
    tt.add_argument("--out")
    device_arg(tt)
    tt.set_defaults(fn=cmd_turntable)

    sub.add_parser("presets", help="list named presets").set_defaults(fn=cmd_presets)
    info = sub.add_parser("info", help="torch, CUDA device and process info")
    device_arg(info)
    info.set_defaults(fn=cmd_info)

    args = p.parse_args(argv)
    started = False
    if args.multihost:
        import torch.distributed as dist

        from brdf_tpu_torch.parallel.mesh import initialize_multihost

        started = not dist.is_initialized() and initialize_multihost(
            coordinator=args.coordinator, num_processes=args.num_processes,
            process_id=args.process_id, device=getattr(args, "device", None))
    try:
        return args.fn(args)
    finally:
        if started:
            dist.destroy_process_group()


if __name__ == "__main__":
    raise SystemExit(main())
