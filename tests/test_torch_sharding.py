"""The port's sharded fits on four gloo ranks against the JAX package's
``fit_texels_sharded`` on four virtual CPU devices of the same mesh shape,
and against the port's own unsharded fits.

The ranks are one spawn for the module (``torch_mesh_worker.py``'s ``fits``
job, about 20 s): each fits its block on the meshes (4, 1), (2, 2) and
(1, 4) and the tests read what every rank got. The bars are the JAX
package's own: ``tests/test_sharding.py:36-66`` for the eager LM tier in
float64 from a pinned start, ``tests/test_multihost.py:276-330`` for the
chunked tier over sharded views, ``tests/test_torch_solver.py::
test_varpro_fit_matches_jax``'s float64 bar for VarPro over sharded views.
A data-sharded fit must equal the unsharded one bit for bit: a texel's
result does not depend on the batch it is fitted in.
"""

import tempfile

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from brdf_tpu.models.brdf import ShadingAngles as JAngles  # noqa: E402
from brdf_tpu.parallel import fit_texels_sharded as j_fit_sharded, make_mesh as j_make_mesh  # noqa: E402
from brdf_tpu.solver.lm import LMOptions as JOptions  # noqa: E402
from brdf_tpu_torch.models.brdf import (  # noqa: E402
    MODELS,
    ShadingAngles,
    ShadingGeometry,
    angles_from_geometry,
)
from brdf_tpu_torch.models.normalmap import joint_eval, joint_spec  # noqa: E402
from brdf_tpu_torch.parallel.fit import fit_texels  # noqa: E402
from brdf_tpu_torch.pipeline.fit import TexelProblem, fit_joint_normalmap, fit_per_texel  # noqa: E402
from brdf_tpu_torch.solver.lm import LMOptions  # noqa: E402
from brdf_tpu_torch.utils.checkpoint import FitCheckpointer, load_fit_state  # noqa: E402
from torch_port_inputs import (  # noqa: E402
    agreement,
    angle_columns,
    joint_problem,
    run_ranks,
    true_params,
)

SHAPES = ((4, 1), (2, 2), (1, 4))
VIEW_SHARDED = ((2, 2), (1, 4))
FIELDS = ("p", "chi2", "stop", "iters")
# the options of torch_mesh_worker.py's fits
OPTS64 = dict(eps1=1e-10, eps2=1e-10, eps3=1e-22, itmax=50)
OPTS8 = dict(eps1=1e-7, eps2=1e-8, eps3=1e-14, itmax=8)
OPTS = dict(eps1=1e-7, eps2=1e-8, eps3=1e-14, itmax=30)
JOINT_OPTS = LMOptions(eps1=1e-7, eps2=1e-8, eps3=1e-14, itmax=12)
PIPELINE = ("per_texel/xla", "per_texel/pallas", "per_texel/varpro", "chunked", "resumed",
            "joint/pallas", "joint/xla")


def _key(shape):
    return f"{shape[0]}x{shape[1]}"


def _lobe(prefix, t, v, seed, dtype):
    """blinn_phong on ``bench.py``'s angle distribution, the target by the
    port's lobe (both packages get the same bits)."""
    rng = np.random.default_rng(seed)
    cols = angle_columns(rng, t, v, dtype)
    p = true_params("blinn_phong", rng, t, dtype)
    ang = ShadingAngles(**{k: torch.tensor(x) for k, x in cols.items()})
    out = {f"{prefix}{k}": x for k, x in cols.items()}
    out[f"{prefix}y"] = MODELS["blinn_phong"].fn(torch.tensor(p), ang).numpy()
    out[f"{prefix}true"] = p
    return out


def _inputs() -> dict:
    inp = {}
    inp.update(_lobe("x64_", 256, 16, 0, np.float64))
    inp["x64_p0"] = inp["x64_true"] * 1.05
    inp.update(_lobe("k6_", 64, 16, 1, np.float32))
    inp.update(_lobe("vp_", 64, 16, 2, np.float64))
    # the pipeline's problem: 50 texels × 3 channels (150 lanes: the data
    # axis pads them), 16 views
    rng = np.random.default_rng(3)
    cols = angle_columns(rng, 50, 16)
    ang = ShadingAngles(**{k: torch.tensor(x) for k, x in cols.items()})
    inp.update({f"pt_{k}": x for k, x in cols.items()})
    inp["pt_y"] = np.stack([
        MODELS["blinn_phong"].fn(torch.tensor(true_params("blinn_phong", rng, 50)), ang).numpy()
        for _ in range(3)], -1)
    inp["pt_w"] = np.ones((50, 16), np.float32)
    # the joint fit's: 37 texels (padded to 40 over four ranks)
    geom, true_p, _ = joint_problem(37, 16, seed=4)
    g = ShadingGeometry(*(torch.tensor(geom[k]) for k in ("n", "l", "v")))
    jang = angles_from_geometry(g)
    inp.update({f"jt_{k}": getattr(jang, k).numpy() for k in ShadingAngles._fields
                if getattr(jang, k) is not None})
    inp.update({f"jt_{k}": geom[k] for k in ("n", "l", "v")})
    inp["jt_y"] = joint_eval(joint_spec("cook_torrance"), torch.tensor(true_p), g).numpy()
    inp["jt_w"] = np.ones((37, 16), np.float32)
    return inp


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    work = tmp_path_factory.mktemp("sharding")
    inp = _inputs()
    return inp, run_ranks("fits", inp, work), work


def _angles(inp, prefix):
    return ShadingAngles(*(torch.tensor(inp[f"{prefix}{k}"]) if f"{prefix}{k}" in inp else None
                           for k in ShadingAngles._fields))


def _jax(inp, prefix, shape, opts, engine, p0=None):
    cols = {k: jnp.asarray(inp[f"{prefix}{k}"]) for k in JAngles._fields if f"{prefix}{k}" in inp}
    mesh = j_make_mesh(data=shape[0], view=shape[1], devices=jax.devices()[:4])
    res = j_fit_sharded("blinn_phong", JAngles(**cols), jnp.asarray(inp[f"{prefix}y"]), mesh,
                        opts=JOptions(**opts), engine=engine,
                        p0=None if p0 is None else jnp.asarray(p0))
    return {f: np.asarray(getattr(res, f)) for f in FIELDS}


def _blocks(outs, case, shape) -> dict:
    """The texel blocks of ``fit_texels_sharded`` in data order, each from
    the view-0 rank of its data row."""
    return {f: np.concatenate([outs[d * shape[1]][f"{case}/{_key(shape)}/{f}"]
                               for d in range(shape[0])]) for f in FIELDS}


def _same(got: dict, ref) -> bool:
    return all(np.array_equal(got[f], getattr(ref, f).numpy(), equal_nan=True) for f in FIELDS)


@pytest.mark.parametrize("shape", SHAPES, ids=_key)
def test_eager_lm_in_float64_matches_jax(ranks, shape):
    """``tests/test_sharding.py:36-66``: engine "xla", blinn_phong, float64,
    a pinned start, T=256, V=16 — p at rtol 1e-6, atol 1e-8."""
    inp, outs, _ = ranks
    got = _blocks(outs, "xla64", shape)
    ref = _jax(inp, "x64_", shape, OPTS64, "xla", p0=inp["x64_p0"])
    assert got["p"].dtype == np.float64 and float(np.median(got["chi2"])) < 1e-22
    np.testing.assert_allclose(got["p"], ref["p"], rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("shape", VIEW_SHARDED, ids=_key)
def test_chunked_tier_over_sharded_views_matches_jax(ranks, shape):
    """``tests/test_multihost.py:276-330``: engine "pallas" with its views
    sharded (the port's plain K6 with rank-order sums; the JAX chunked kernel
    in interpret mode with psums), itmax 8 — more than 0.9 of the lanes
    within 1e-2 relative."""
    inp, outs, _ = ranks
    got = _blocks(outs, "pallas", shape)
    ref = _jax(inp, "k6_", shape, OPTS8, "pallas")
    assert agreement(got["p"], ref["p"], 1e-2) > 0.9


@pytest.mark.parametrize("shape", VIEW_SHARDED, ids=_key)
def test_varpro_over_sharded_views_matches_jax(ranks, shape):
    """engine "varpro" with its views sharded: the eager tier with its view
    sums across the ranks against the JAX package's XLA tier with its psums,
    both from the grid init over every view, float64, in that test's
    setting of 8 steps (itmax 8). The bar is
    ``tests/test_torch_solver.py::test_varpro_fit_matches_jax``'s: 0.9 of
    the lanes within 1e-6, χ² within 1e-3 (or both below 1e-10) on 0.97 of
    them, the same stop codes."""
    inp, outs, _ = ranks
    got = _blocks(outs, "varpro", shape)
    ref = _jax(inp, "vp_", shape, OPTS8, "varpro")
    assert got["p"].dtype == np.float64
    assert agreement(got["p"], ref["p"], 1e-6) >= 0.9
    c_t, c_j = got["chi2"], ref["chi2"]
    same = np.isclose(c_t, c_j, rtol=1e-3, atol=1e-12) | ((c_t < 1e-10) & (c_j < 1e-10))
    assert same.mean() >= 0.97
    np.testing.assert_array_equal(got["stop"], ref["stop"])


@pytest.mark.parametrize("case", ("xla64", "pallas", "varpro"))
def test_view_replicas_hold_the_same_bits(ranks, case):
    """Every rank of a view group returns the same block, stop codes and
    all: the rank-order sums leave one state on every replica."""
    _, outs, _ = ranks
    for shape in SHAPES:
        for r in range(4):
            first = (r // shape[1]) * shape[1]
            for f in FIELDS:
                key = f"{case}/{_key(shape)}/{f}"
                np.testing.assert_array_equal(outs[r][key], outs[first][key], err_msg=key)


@pytest.mark.parametrize("case", ("xla64", "pallas", "varpro"))
def test_data_sharded_fit_texels_is_the_unsharded_fit(ranks, case):
    """``fit_texels_sharded`` over (4, 1): the blocks put together equal
    ``fit_texels`` on every lane, bit for bit (the fused K5 and K1's plain
    versions for "pallas" and "varpro")."""
    inp, outs, _ = ranks
    prefix, opts, kw = {"xla64": ("x64_", OPTS64, dict(p0=torch.tensor(inp["x64_p0"]))),
                        "pallas": ("k6_", OPTS8, {}), "varpro": ("vp_", OPTS8, {})}[case]
    ref = fit_texels("blinn_phong", _angles(inp, prefix), torch.tensor(inp[f"{prefix}y"]),
                     opts=LMOptions(**opts), engine="pallas" if case == "pallas" else
                     "xla" if case == "xla64" else "varpro", device="cpu", **kw)
    assert _same(_blocks(outs, case, (4, 1)), ref)


def _pipeline_ref(inp, case):
    problem = TexelProblem(angles=_angles(inp, "pt_"), intensity=torch.tensor(inp["pt_y"]),
                           weights=torch.tensor(inp["pt_w"]), face_ids=np.arange(50))
    opts = LMOptions(**OPTS)
    if case in ("chunked", "resumed"):
        with tempfile.TemporaryDirectory() as d:
            return fit_per_texel(problem, "blinn_phong", opts=opts, engine="pallas", device="cpu",
                                 checkpointer=FitCheckpointer(d), chunk_iters=4).result
    if case.startswith("per_texel/"):
        return fit_per_texel(problem, "blinn_phong", opts=opts, engine=case.split("/")[1],
                             device="cpu", robust="huber", robust_iters=1).result
    geom = ShadingGeometry(*(torch.tensor(inp[f"jt_{k}"]) for k in ("n", "l", "v")))
    joint = TexelProblem(angles=_angles(inp, "jt_"), intensity=torch.tensor(inp["jt_y"]),
                         weights=torch.tensor(inp["jt_w"]), face_ids=np.arange(37), geometry=geom)
    return fit_joint_normalmap(joint, "cook_torrance", engine=case.split("/")[1], device="cpu",
                               opts=JOINT_OPTS, robust="huber", robust_iters=1)[0]


@pytest.mark.parametrize("case", PIPELINE)
def test_data_sharded_pipeline_is_the_unsharded_fit(ranks, case):
    """``fit_per_texel(mesh=)`` over (4, 1) — each engine with a huber round,
    in checkpointed chunks, and stopped after two chunks and resumed from
    the ranks' checkpoint shards — and ``fit_joint_normalmap(mesh=)`` over
    every shape (it shards texels over every rank): every rank returns the
    whole result, equal to the unsharded fit on every lane, bit for bit."""
    inp, outs, _ = ranks
    ref = _pipeline_ref(inp, case)
    shapes = SHAPES if case.startswith("joint/") else ((4, 1),)
    for shape in shapes:
        for r in range(4):
            got = {f: outs[r][f"{case}/{_key(shape)}/{f}"] for f in FIELDS}
            assert _same(got, ref), (case, shape, r)


@pytest.mark.parametrize("case", PIPELINE[:5])
def test_view_sharded_pipeline_returns_one_report(ranks, case):
    """Over (2, 2) and (1, 4) every rank returns the same whole report of
    150 lanes; against the unsharded fit the lanes that are identified (χ²
    at its floor in both) mostly agree."""
    inp, outs, _ = ranks
    ref = _pipeline_ref(inp, case)
    for shape in VIEW_SHARDED:
        got = {f: outs[0][f"{case}/{_key(shape)}/{f}"] for f in FIELDS}
        assert got["p"].shape == (150, 3)
        for r in range(1, 4):
            for f in FIELDS:
                np.testing.assert_array_equal(outs[r][f"{case}/{_key(shape)}/{f}"], got[f])
        assert agreement(got["p"], ref.p.numpy(), 1e-2) >= 0.9


def test_chunked_checkpoint_has_one_shard_per_rank(ranks):
    """The checkpointed chunks wrote one shard per rank (the rows of the
    padded batch split four ways) and rank 0 the manifest: loading them
    gives the whole padded batch, whose first 150 rows are the result."""
    _, outs, work = ranks
    for shape in SHAPES:
        arrays, meta = load_fit_state(str(work / f"ckpt_{_key(shape)}"))
        assert meta["model"] == "blinn_phong"
        pad = 150 + (-150) % shape[0]
        assert arrays["p"].shape == (pad, 3)
        np.testing.assert_array_equal(arrays["p"][:150], outs[0][f"chunked/{_key(shape)}/p"])
        steps = sorted((work / f"ckpt_{_key(shape)}").iterdir())
        assert len(list(steps[-1].glob("shard_*.npz"))) == 4
