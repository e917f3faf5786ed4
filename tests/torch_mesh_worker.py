"""One rank of the port's multi-rank CPU tests (``test_torch_mesh.py``,
``test_torch_sharding.py``): the counterpart of ``tests/mp_fit_worker.py``.

    python tests/torch_mesh_worker.py RANK WORLD STORE INPUTS OUT JOB

Starts a gloo world of ``WORLD`` ranks through the file store ``STORE``
(``parallel/mesh.py::initialize_multihost``), reads the inputs the test
wrote with numpy to ``INPUTS`` (an ``.npz``), runs job ``JOB`` on meshes of
every shape and writes what this rank got to ``OUT`` (an ``.npz`` keyed by
case). It imports only torch, numpy and the port: never JAX, the JAX package
or a test module.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from brdf_tpu_torch import cli  # noqa: E402
from brdf_tpu_torch.models.brdf import ShadingAngles, ShadingGeometry  # noqa: E402
from brdf_tpu_torch.parallel import fit_texels_sharded, make_mesh  # noqa: E402
from brdf_tpu_torch.parallel.mesh import (  # noqa: E402
    ALL_AXES,
    DATA_AXIS,
    VIEW_AXIS,
    axis_gather,
    axis_sum,
    block_of,
    initialize_multihost,
    use_mesh,
)
from brdf_tpu_torch.pipeline.fit import (  # noqa: E402
    TexelProblem,
    fit_joint_normalmap,
    fit_per_texel,
)
from brdf_tpu_torch.solver.init import linear_grid_init  # noqa: E402
from brdf_tpu_torch.solver.lm import LMOptions  # noqa: E402
from brdf_tpu_torch.solver.robust import robust_weights  # noqa: E402
from brdf_tpu_torch.utils.checkpoint import FitCheckpointer, save_fit_state  # noqa: E402
from brdf_tpu_torch.utils.logging import EventLog  # noqa: E402

SHAPES = ((4, 1), (2, 2), (1, 4))
ANGLE_KEYS = ShadingAngles._fields


def angles_of(inp, prefix, rows=slice(None), cols=slice(None)):
    return ShadingAngles(*(
        torch.tensor(inp[f"{prefix}{k}"][rows, cols]) if f"{prefix}{k}" in inp else None
        for k in ANGLE_KEYS))


def result_arrays(res, key: str) -> dict:
    return {f"{key}/{f}": getattr(res, f).detach().cpu().numpy()
            for f in ("p", "chi2", "stop", "iters")}


def problem_of(inp, prefix) -> TexelProblem:
    geom = None
    if f"{prefix}n" in inp:
        geom = ShadingGeometry(*(torch.tensor(inp[f"{prefix}{k}"]) for k in ("n", "l", "v")))
    return TexelProblem(angles=angles_of(inp, prefix), intensity=torch.tensor(inp[f"{prefix}y"]),
                        weights=torch.tensor(inp[f"{prefix}w"]),
                        face_ids=np.arange(inp[f"{prefix}y"].shape[0]), geometry=geom)


def job_mesh(rank: int, world: int, inp, work: str) -> dict:
    """axis_sum / axis_gather against the rank-order sums, the grid init and
    robust weights over a sharded view axis, the checkpoint protocol over
    real ranks, rank-0 logging and the CLI's ``info``."""
    out = {}
    x = torch.tensor(inp["sum_x"][rank])
    for shape in SHAPES:
        mesh = make_mesh(*shape, device="cpu")
        key = f"{shape[0]}x{shape[1]}"
        out[f"coords/{key}"] = np.array(mesh.coords)
        with use_mesh(mesh):
            for axis in (DATA_AXIS, VIEW_AXIS, ALL_AXES):
                name = "all" if axis == ALL_AXES else axis
                out[f"sum/{key}/{name}"] = axis_sum(x, axis).numpy()
                out[f"gather/{key}/{name}"] = axis_gather(x[:, None], axis, dim=-1).numpy()
            out[f"sum/{key}/none"] = axis_sum(x, None).numpy()
            # the grid init and the robust scale see every view of a texel
            _, v = mesh.coords
            cols = block_of(inp["g_y"].shape[1], mesh.view, v)
            ang = angles_of(inp, "g_", cols=cols)
            y, w = torch.tensor(inp["g_y"][:, cols]), torch.tensor(inp["g_w"][:, cols])
            out[f"init/{key}"] = linear_grid_init("blinn_phong", ang, y, weights=w,
                                                  axis_name=VIEW_AXIS).numpy()
            r = torch.tensor(inp["g_r"][:, cols])
            out[f"robust/{key}"] = robust_weights(r, w, kind="huber", axis_name=VIEW_AXIS).numpy()
    for bad in (dict(data=3), dict(view=3)):
        try:
            make_mesh(**bad, device="cpu")
        except ValueError as err:
            out[f"error/{'/'.join(bad)}"] = np.array(str(err))
    # every rank its shard through the checkpointer; rank 0 commits
    ck = FitCheckpointer(os.path.join(work, "ckpt"), keep=1)
    for step in (1, 2):
        ck.maybe_save(step, {"p": np.full((2, 3), 10 * step + rank, np.float32)}, {"step": step})
    # rank 0 writing alone what every rank holds
    if rank == 0:
        save_fit_state(os.path.join(work, "alone"), 0, {"x": np.arange(3)}, process=(0, 1))
    log = EventLog(os.path.join(work, f"events_{rank}", "events.jsonl"))
    log("ranked", rank=rank)
    log.close()
    info, fit = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(info):
        rc = cli.main(["--multihost", "info", "--device", "cpu"])
    # a fit through the command line: the config's sharding lays the ranks
    # out, rank 0 alone writes the run and prints its events
    with contextlib.redirect_stdout(fit):
        rc_fit = cli.main(["--multihost", "fit", "--config", str(inp["cli_config"]),
                           "--out", os.path.join(work, "cli_run"), "--device", "cpu"])
    out["info"] = np.array(json.dumps(dict(json.loads(info.getvalue()), rc=rc, rc_fit=rc_fit)))
    out["fit_stdout_lines"] = np.array(len(fit.getvalue().splitlines()))
    return out


def job_fits(rank: int, world: int, inp, work: str) -> dict:
    """The fits of ``test_torch_sharding.py`` on every mesh shape, each rank
    keeping its own block (``fit_texels_sharded``) or the whole gathered
    result (the pipeline's fits)."""
    out = {}
    opts64 = LMOptions(eps1=1e-10, eps2=1e-10, eps3=1e-22, itmax=50)
    opts8 = LMOptions(eps1=1e-7, eps2=1e-8, eps3=1e-14, itmax=8)
    opts = LMOptions(eps1=1e-7, eps2=1e-8, eps3=1e-14, itmax=30)
    for shape in SHAPES:
        mesh = make_mesh(*shape, device="cpu")
        key = f"{shape[0]}x{shape[1]}"
        d, v = mesh.coords

        def block(prefix):
            t, n_v = inp[f"{prefix}y"].shape
            rows, cols = block_of(t, mesh.data, d), block_of(n_v, mesh.view, v)
            return (angles_of(inp, prefix, rows, cols), torch.tensor(inp[f"{prefix}y"][rows, cols]),
                    rows)

        ang, y, rows = block("x64_")
        res = fit_texels_sharded("blinn_phong", ang, y, mesh, opts=opts64, engine="xla",
                                 p0=torch.tensor(inp["x64_p0"][rows]))
        out.update(result_arrays(res, f"xla64/{key}"))
        ang, y, _ = block("k6_")
        res = fit_texels_sharded("blinn_phong", ang, y, mesh, opts=opts8, engine="pallas")
        out.update(result_arrays(res, f"pallas/{key}"))
        ang, y, _ = block("vp_")
        res = fit_texels_sharded("blinn_phong", ang, y, mesh, opts=opts8, engine="varpro")
        out.update(result_arrays(res, f"varpro/{key}"))

        # the pipeline: every rank gets the whole report
        problem = problem_of(inp, "pt_")
        for engine in ("xla", "pallas", "varpro"):
            rep = fit_per_texel(problem, "blinn_phong", opts=opts, engine=engine, mesh=mesh,
                                robust="huber", robust_iters=1)
            out.update(result_arrays(rep.result, f"per_texel/{engine}/{key}"))
        ck = FitCheckpointer(os.path.join(work, f"ckpt_{key}"))
        rep = fit_per_texel(problem, "blinn_phong", opts=opts, engine="pallas", mesh=mesh,
                            checkpointer=ck, chunk_iters=4, robust=None)
        out.update(result_arrays(rep.result, f"chunked/{key}"))
        # stopped after two chunks, then resumed from the ranks' shards
        ck = FitCheckpointer(os.path.join(work, f"resumed_{key}"))
        for itmax in (8, opts.itmax):
            rep = fit_per_texel(problem, "blinn_phong", opts=opts._replace(itmax=itmax),
                                engine="pallas", mesh=mesh, checkpointer=ck, chunk_iters=4)
        out.update(result_arrays(rep.result, f"resumed/{key}"))
        joint = problem_of(inp, "jt_")
        for engine in ("pallas", "xla"):
            res, _ = fit_joint_normalmap(joint, "cook_torrance", engine=engine, mesh=mesh,
                                         opts=LMOptions(eps1=1e-7, eps2=1e-8, eps3=1e-14,
                                                        itmax=12),
                                         robust="huber", robust_iters=1)
            out.update(result_arrays(res, f"joint/{engine}/{key}"))
    return out


def main() -> int:
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    store, inputs, out_path, job = sys.argv[3:7]
    torch.set_num_threads(1)
    if not initialize_multihost(f"file://{store}", world, rank, device="cpu"):
        raise RuntimeError("initialize_multihost started no process group")
    if dist.get_backend() != "gloo":
        raise RuntimeError(f"a CPU rank got the {dist.get_backend()} backend, not gloo")
    with np.load(inputs) as npz:
        inp = dict(npz)
    work = os.path.dirname(out_path)
    out = {"mesh": job_mesh, "fits": job_fits}[job](rank, world, inp, work)
    np.savez(out_path + ".tmp.npz", **out)
    os.replace(out_path + ".tmp.npz", out_path)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
