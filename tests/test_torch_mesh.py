"""The port's mesh, its cross-rank sums and the multi-process protocols
around it (``brdf_tpu_torch/parallel/mesh.py``, ``utils/checkpoint.py``,
``utils/logging.py``, ``cli.py --multihost``).

Four gloo ranks, one spawn for the module (``torch_mesh_worker.py``'s
``mesh`` job, a few seconds), hold ``axis_sum`` to the numpy sum of the
ranks' values added in rank order, bit for bit, on the meshes (4, 1),
(2, 2) and (1, 4); the checkpoint protocol has the counterparts of
``tests/test_multihost.py:29-100`` with the process identities passed in.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402

from brdf_tpu.parallel.mesh import pad_to_multiple as j_pad_to_multiple  # noqa: E402
from brdf_tpu_torch import cli  # noqa: E402
from brdf_tpu_torch.configs import PRESETS  # noqa: E402
from brdf_tpu_torch.models.brdf import MODELS, ShadingAngles  # noqa: E402
from brdf_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from brdf_tpu_torch.solver.init import linear_grid_init  # noqa: E402
from brdf_tpu_torch.solver.robust import robust_weights  # noqa: E402
from brdf_tpu_torch.utils import checkpoint as ck  # noqa: E402
from tools.synthetic_scene import write_scene  # noqa: E402
from torch_port_inputs import agreement, angle_columns, run_ranks, true_params  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((4, 1), (2, 2), (1, 4))


def _key(shape):
    return f"{shape[0]}x{shape[1]}"


def _cli_config(work) -> str:
    """A small scan from ``tools/synthetic_scene.py`` (126 visible faces, 16
    views of 80 × 60) under the timber-blinn preset, its sharding the
    default: every rank on the data axis."""
    scene = work / "scene"
    write_scene(str(scene), subdiv=2, width=80, height=60, model="blinn_phong", device="cpu")
    cfg = PRESETS["timber-blinn"]
    cfg = dataclasses.replace(cfg, scene=dataclasses.replace(cfg.scene, scene_dir=str(scene)))
    path = work / "cli.json"
    path.write_text(cfg.to_json())
    return str(path)


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    # values over many binades, so that the order of the additions shows
    x = (rng.normal(size=(4, 64)) * 10.0 ** rng.integers(-6, 7, (4, 64))).astype(np.float32)
    cols = angle_columns(rng, 40, 16, np.float64)
    p = true_params("blinn_phong", rng, 40, np.float64)
    y = MODELS["blinn_phong"].fn(torch.tensor(p), ShadingAngles(
        **{k: torch.tensor(v) for k, v in cols.items()})).numpy()
    w = (rng.uniform(size=y.shape) > 0.2).astype(np.float64)
    r = rng.normal(size=y.shape) * rng.uniform(0.01, 1.0, (40, 1))
    return dict(sum_x=x, g_y=y, g_w=w, g_r=r, **{f"g_{k}": v for k, v in cols.items()})


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh")
    inp = dict(_inputs(), cli_config=np.array(_cli_config(work)))
    return inp, run_ranks("mesh", inp, work), work


def _members(shape, rank, axis):
    """The ranks of ``axis``'s group of ``rank`` in rank order."""
    d, v = divmod(rank, shape[1])
    if axis == "data":
        return [e * shape[1] + v for e in range(shape[0])]
    if axis == "view":
        return [d * shape[1] + e for e in range(shape[1])]
    return list(range(4))


@pytest.mark.parametrize("shape", SHAPES, ids=_key)
def test_axis_sum_is_the_rank_order_sum(ranks, shape):
    """``axis_sum`` over each axis equals ``((x₀ + x₁) + x₂) + …`` of the
    group's ranks in numpy float32, bit for bit, on every rank; ``None`` is
    the identity, and ``axis_gather`` concatenates in the same order."""
    inp, outs, _ = ranks
    x = inp["sum_x"]
    for rank, out in enumerate(outs):
        np.testing.assert_array_equal(out[f"coords/{_key(shape)}"], divmod(rank, shape[1]))
        np.testing.assert_array_equal(out[f"sum/{_key(shape)}/none"], x[rank])
        for axis in ("data", "view", "all"):
            members = _members(shape, rank, axis)
            want = x[members[0]].copy()
            for m in members[1:]:
                want = want + x[m]
            assert want.dtype == np.float32
            np.testing.assert_array_equal(out[f"sum/{_key(shape)}/{axis}"], want)
            np.testing.assert_array_equal(out[f"gather/{_key(shape)}/{axis}"],
                                          np.stack([x[m] for m in members], -1))


@pytest.mark.parametrize("shape", SHAPES, ids=_key)
def test_grid_init_and_robust_scale_see_every_view(ranks, shape):
    """Over a sharded view axis each rank's grid init starts where the
    unsharded one does (``tests/test_torch_solver.py::
    test_linear_grid_init_matches_jax``'s bar: 0.9 of the lanes within 1e-8,
    the sums being added in another order), and its robust weights are the
    unsharded weights of its views, bit for bit (the median sorts the same
    views)."""
    inp, outs, _ = ranks
    ang = ShadingAngles(**{k: torch.tensor(inp[f"g_{k}"]) for k in
                           ("cos_ln", "cos_nh", "cos_rv", "cos_vn")})
    y, w = torch.tensor(inp["g_y"]), torch.tensor(inp["g_w"])
    init = linear_grid_init("blinn_phong", ang, y, weights=w).numpy()
    robust = robust_weights(torch.tensor(inp["g_r"]), w, kind="huber").numpy()
    for rank, out in enumerate(outs):
        v = rank % shape[1]
        cols = tmesh.block_of(16, shape[1], v)
        got = out[f"init/{_key(shape)}"]
        if shape[1] == 1:
            np.testing.assert_array_equal(got, init)
        assert agreement(got, init, 1e-8) >= 0.9
        np.testing.assert_array_equal(out[f"robust/{_key(shape)}"], robust[:, cols])


def test_mesh_shapes_are_checked(ranks):
    """``make_mesh`` raises the JAX package's messages, over four ranks and
    in a process with no process group (the 1 × 1 mesh)."""
    _, outs, _ = ranks
    assert str(outs[0]["error/data"]) == "mesh 3x1 != 4 devices"
    assert str(outs[0]["error/view"]) == "4 devices not divisible by view=3"
    assert not torch.distributed.is_initialized()
    one = tmesh.make_mesh(device="cpu")
    assert (one.data, one.view, one.rank, one.world, one.coords) == (1, 1, 0, 1, (0, 0))
    assert one.device == torch.device("cpu") and one.groups == {}
    with pytest.raises(ValueError, match="1 devices not divisible by view=2"):
        tmesh.make_mesh(view=2, device="cpu")
    with pytest.raises(ValueError, match="mesh 2x1 != 1 devices"):
        tmesh.make_mesh(data=2, device="cpu")


def test_axis_names_need_a_current_mesh():
    """An axis name outside ``use_mesh`` raises, as an unbound axis does in
    JAX; inside the 1 × 1 mesh every collective is the identity."""
    x = torch.arange(6.0).reshape(2, 3)
    with pytest.raises(ValueError, match="use_mesh"):
        tmesh.axis_sum(x, "view")
    with pytest.raises(ValueError, match="unknown mesh axis"):
        with tmesh.use_mesh(tmesh.make_mesh(device="cpu")):
            tmesh.axis_sum(x, "texel")
    with tmesh.use_mesh(tmesh.make_mesh(device="cpu")):
        for axis in ("data", "view", tmesh.ALL_AXES, None):
            assert tmesh.axis_sum(x, axis) is x and tmesh.axis_gather(x, axis, -1) is x
    assert tmesh.axis_sum(x, None) is x
    with pytest.raises(ValueError, match="use_mesh"):     # the block left no mesh behind
        tmesh.axis_gather(x, "data")


def test_pad_local_block_and_blocks_match_jax():
    x = np.arange(10.0).reshape(5, 2)
    for mult, axis in ((4, 0), (3, 1), (5, 0)):
        got, n = tmesh.pad_to_multiple(x, mult, axis=axis, value=-1.0)
        want, m = j_pad_to_multiple(x, mult, axis=axis, value=-1.0)
        np.testing.assert_array_equal(got, want)
        assert n == m
    t = torch.arange(4.0)
    np.testing.assert_array_equal(tmesh.local_block(t), t.numpy())
    np.testing.assert_array_equal(tmesh.local_block([1, 2]), [1, 2])
    assert tmesh.block_of(12, 4, 2) == slice(6, 9)
    with pytest.raises(ValueError, match="equal blocks"):
        tmesh.block_of(10, 4, 0)


def test_initialize_multihost_without_a_cluster_is_a_noop(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(key, raising=False)
    assert tmesh.initialize_multihost(device="cpu") is False
    assert not torch.distributed.is_initialized()
    assert (tmesh.process_index(), tmesh.process_count()) == (0, 1)


def test_checkpoint_protocol_over_ranks(ranks):
    """Four real ranks through ``FitCheckpointer``: every rank its shard,
    rank 0 the manifest once all four are in and the pruning (keep=1); the
    load concatenates the shards in rank order. A rank writing alone passes
    ``process=(0, 1)``."""
    _, _, work = ranks
    assert ck.latest_step(str(work / "ckpt")) == 2
    assert sorted(p.name for p in (work / "ckpt").iterdir()) == ["step_00000002"]
    arrays, meta = ck.load_fit_state(str(work / "ckpt"))
    assert meta == {"step": 2}
    np.testing.assert_array_equal(arrays["p"], np.repeat(np.arange(20, 24), 2)[:, None]
                                  * np.ones((1, 3), np.float32))
    alone, _ = ck.load_fit_state(str(work / "alone"))
    np.testing.assert_array_equal(alone["x"], np.arange(3))


def _arrays(fill):
    return {"p": np.full((4, 3), fill, np.float32), "stop": np.full((4,), fill, np.int32)}


def test_multi_shard_assembly(tmp_path):
    """``tests/test_multihost.py::test_multi_shard_assembly``: three writers,
    the non-zero ones first and out of order; the step is invisible until
    process 0 has written the manifest; the load keeps process order."""
    path = str(tmp_path)
    for i in (2, 1):
        ck.save_fit_state(path, 5, _arrays(i), process=(i, 3))
    assert ck.latest_step(path) is None
    ck.save_fit_state(path, 5, _arrays(0), metadata={"model": "m"}, process=(0, 3))
    assert ck.latest_step(path) == 5
    arrays, meta = ck.load_fit_state(path)
    assert meta == {"model": "m"} and arrays["p"].shape == (12, 3)
    for i in range(3):
        np.testing.assert_array_equal(arrays["p"][4 * i:4 * (i + 1)], i)
        np.testing.assert_array_equal(arrays["stop"][4 * i:4 * (i + 1)], i)


def test_missing_shard_detected(tmp_path):
    """A manifest recording more shards than exist fails the load loudly."""
    path = str(tmp_path)
    d = ck.save_fit_state(path, 1, _arrays(7))
    with open(os.path.join(d, "manifest.json")) as fh:
        manifest = json.load(fh)
    manifest["num_shards"] = 2
    with open(os.path.join(d, "manifest.json"), "w") as fh:
        json.dump(manifest, fh)
    with pytest.raises(FileNotFoundError, match="manifest records 2"):
        ck.load_fit_state(path)


def test_rank_zero_times_out_without_its_peers(tmp_path):
    """Process 0 waits ``shard_timeout`` for the others, then raises, and
    commits nothing."""
    path = str(tmp_path)
    with pytest.raises(TimeoutError, match="1/2 shards"):
        ck.save_fit_state(path, 3, _arrays(0), shard_timeout=0.2, process=(0, 2))
    assert ck.latest_step(path) is None


def test_event_log_and_info_over_ranks(ranks):
    """Rank 0 alone writes the events log; ``--multihost info`` on a rank of
    a started world reports the world and the rank."""
    _, outs, work = ranks
    assert (work / "events_0" / "events.jsonl").exists()
    assert not any((work / f"events_{r}").exists() for r in (1, 2, 3))
    for rank, out in enumerate(outs):
        info = json.loads(str(out["info"]))
        assert (info["process_count"], info["process_index"], info["rc"]) == (4, rank, 0)


def test_cli_fit_over_ranks_is_the_one_process_fit(ranks, tmp_path):
    """``--multihost fit`` on four ranks: the default sharding puts them on
    the data axis, rank 0 alone writes the run (one shard, one events log,
    the events on its stdout only), and the saved arrays equal a
    one-process run's."""
    inp, outs, work = ranks
    assert all(json.loads(str(out["info"]))["rc_fit"] == 0 for out in outs)
    assert [int(out["fit_stdout_lines"]) > 0 for out in outs] == [True, False, False, False]
    step = work / "cli_run" / "step_00000000"
    assert sorted(p.name for p in step.iterdir()) == ["manifest.json", "shard_0000.npz"]
    one = tmp_path / "one"
    assert cli.main(["fit", "--config", str(inp["cli_config"]), "--out", str(one),
                     "--device", "cpu"]) == 0
    got, meta = ck.load_fit_state(str(work / "cli_run"))
    want, want_meta = ck.load_fit_state(str(one))
    assert meta == want_meta and sorted(got) == sorted(want)
    for key in got:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    kinds = [json.loads(line)["kind"] for line in open(work / "cli_run" / "events.jsonl")]
    assert kinds.count("fit_done") == 1 and kinds[-1] == "saved"


def test_single_process_multihost_info_is_a_noop():
    """``python -m brdf_tpu_torch --multihost info --device cpu`` outside a
    cluster starts no process group and reports a world of one."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "RANK", "WORLD_SIZE", "MASTER_ADDR")}
    out = subprocess.run([sys.executable, "-m", "brdf_tpu_torch", "--multihost", "info",
                          "--device", "cpu"], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    info = json.loads(out.stdout)
    assert (info["process_count"], info["process_index"]) == (1, 0)
