"""Synthetic inputs shared by the ``test_torch_*`` files.

Everything is made with numpy from a seed and handed to both packages, so
the JAX package and the PyTorch port see the same bits. The angle
distribution is ``bench.py::make_problem``'s.
"""

from __future__ import annotations

import numpy as np

SEPARABLE = ("blinn_phong", "phong", "cook_torrance", "ward")
ALL_LOBES = (
    "phong", "blinn_phong", "cook_torrance", "cook_torrance_fresnel", "lambert",
    "oren_nayar", "ward", "minnaert", "ward_aniso", "cook_torrance_aniso",
)
TANGENT = ("cos_th", "cos_bh", "cos_tl", "cos_bl", "cos_tv", "cos_bv")


def angle_columns(rng, t, v, dtype=np.float32, tangent=False) -> dict:
    """(T, V) cosine channels as in ``bench.py::make_problem``; with
    ``tangent`` also six tangent-frame channels drawn in [-1, 1]."""
    cols = dict(
        cos_ln=rng.uniform(0.0, 1.0, (t, v)),
        cos_nh=rng.uniform(0.0, 1.0, (t, v)),
        cos_rv=rng.uniform(-1.0, 1.0, (t, v)),
        cos_vn=rng.uniform(0.1, 1.0, (t, v)),
    )
    if tangent:
        cols.update({k: rng.uniform(-1.0, 1.0, (t, v)) for k in TANGENT})
    return {k: x.astype(dtype) for k, x in cols.items()}


def true_params(model, rng, t, dtype=np.float32) -> np.ndarray:
    """Per-texel parameters inside each lobe's box (``tests/test_varpro.py``'s
    distribution for the separable lobes)."""
    kd = rng.uniform(0.1, 0.9, t)
    ks = rng.uniform(0.2, 1.0, t)
    cols = {
        "phong": [kd, ks, rng.uniform(2.0, 30.0, t)],
        "blinn_phong": [kd, ks, rng.uniform(2.0, 30.0, t)],
        "cook_torrance": [kd, ks, rng.uniform(0.15, 0.9, t)],
        "ward": [kd, ks, rng.uniform(0.15, 0.9, t)],
        "cook_torrance_fresnel": [kd, ks, rng.uniform(0.15, 0.9, t), rng.uniform(0.2, 0.9, t)],
        "lambert": [kd],
        "oren_nayar": [kd, rng.uniform(0.05, 1.2, t)],
        "minnaert": [kd, rng.uniform(0.4, 2.5, t)],
        "ward_aniso": [kd, ks, rng.uniform(0.15, 0.9, t), rng.uniform(0.15, 0.9, t),
                       rng.uniform(-1.2, 1.2, t)],
        "cook_torrance_aniso": [kd, ks, rng.uniform(0.15, 0.9, t), rng.uniform(0.15, 0.9, t),
                                rng.uniform(-1.2, 1.2, t)],
    }[model]
    return np.stack(cols, -1).astype(dtype)


def recovery(p, true_p) -> float:
    rel = (np.abs(np.asarray(p) - true_p) / np.maximum(np.abs(true_p), 1e-3)).max(-1)
    return float((rel < 1e-2).mean())


def agreement(p, ref, rtol) -> float:
    """Share of lanes whose every parameter is within ``rtol`` of ``ref``
    (relative, with a 1e-3 floor on |ref|)."""
    rel = np.abs(np.asarray(p) - np.asarray(ref)) / np.maximum(np.abs(np.asarray(ref)), 1e-3)
    return float((rel.max(-1) < rtol).mean())


def joint_problem(t, v, seed=0, base="cook_torrance", dtype=np.float32):
    """``tests/test_joint_pallas.py::_problem`` in numpy: unit vectors to ``v``
    lights and to the eye for ``t`` random surface points and normals
    (``n (T, 3)``, ``l``/``v (T, V, 3)``), and true joint parameters
    ``[kd_rgb, ks_rgb, shape, nu, nv]`` with offsets within ±0.3 (the shape
    is a roughness in [0.2, 0.7], or an exponent in [3, 20] for the
    power-law lobes). Returns ``(geom dict, true_p, rng)``."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(t, 3))
    n = rng.normal(size=(t, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    eye = np.array([0.0, 0.0, 10.0])
    lights = rng.normal(size=(v, 3)) * 4 + np.array([0, 0, 8.0])

    def unit(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    l = unit(lights[None] - pts[:, None])
    e = np.broadcast_to(unit(eye - pts)[:, None], l.shape)
    true_p = np.zeros((t, 9))
    true_p[:, 0:3] = rng.uniform(0.2, 0.8, (t, 3))
    true_p[:, 3:6] = rng.uniform(0.3, 0.9, (t, 3))
    true_p[:, 6] = rng.uniform(3.0, 20.0, t) if "phong" in base else rng.uniform(0.2, 0.7, t)
    true_p[:, 7:9] = rng.uniform(-0.3, 0.3, (t, 2))
    geom = dict(n=n.astype(dtype), l=l.astype(dtype), v=np.ascontiguousarray(e).astype(dtype))
    return geom, true_p.astype(dtype), rng


def aniso_geometry(rng, t, v):
    """``tests/test_varpro.py::_aniso_problem``'s scene in numpy: ``t``
    surface points and unit normals, the eye on the z axis and ``v`` lights
    on a sphere of radius 8 (physically consistent tangent-frame angles)."""
    pts = rng.normal(size=(t, 3)).astype(np.float32) * 0.1
    nrm = rng.normal(size=(t, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    d = rng.normal(size=(v, 3))
    lights = (d / np.linalg.norm(d, axis=-1, keepdims=True) * 8.0).astype(np.float32)
    return pts, nrm.astype(np.float32), np.array([0.0, 0.0, 10.0], np.float32), lights


def canon_aniso(q):
    """Canonicalise the exact (ax, ay, φ) ↔ (ay, ax, φ ± π/2) symmetry of the
    anisotropic lobes (φ has period π), as ``tests/test_varpro.py`` does."""
    q = np.asarray(q).copy()
    swap = q[:, 2] < q[:, 3]
    q[swap, 2], q[swap, 3] = q[swap, 3].copy(), q[swap, 2].copy()
    q[swap, 4] = q[swap, 4] + np.pi / 2
    q[:, 4] = (q[:, 4] + np.pi / 2) % np.pi - np.pi / 2
    return q


def aniso_recovery(p, true_p) -> float:
    """``tests/test_varpro.py::_aniso_recovery``: share of lanes within 1e-2
    after canonicalisation, φ by absolute error and ignored where ax ≈ ay."""
    pc, tc = canon_aniso(p), canon_aniso(true_p)
    rel = np.abs(pc - tc) / np.maximum(np.abs(tc), 1e-3)
    rel[:, 4] = np.abs(pc[:, 4] - tc[:, 4])
    iso = np.abs(tc[:, 2] - tc[:, 3]) < 0.05 * np.maximum(tc[:, 2], tc[:, 3])
    rel[iso, 4] = 0.0
    return float((rel.max(-1) < 1e-2).mean())


def ulp_bump(rng, x):
    """``x`` with a third of its entries moved one float32 ulp up and a third
    one ulp down."""
    x = np.asarray(x, np.float32)
    bump = rng.choice([-1.0, 0.0, 1.0], x.shape).astype(np.float32)
    return np.where(bump == 0, x, np.nextafter(x, np.copysign(np.float32(np.inf), bump)))


def run_ranks(job: str, inputs: dict, work, world: int = 4, timeout: float = 300.0) -> list[dict]:
    """Run ``tests/torch_mesh_worker.py``'s ``job`` on ``world`` gloo ranks,
    one process each, on ``inputs`` (numpy arrays by name): each rank's
    outputs, in rank order. The ranks start from a clean environment (no
    ``PYTHONPATH``, one thread) and are killed if one fails or the timeout
    passes."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    work = Path(work)
    np.savez(work / "inputs.npz", **inputs)
    worker = Path(__file__).with_name("torch_mesh_worker.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    outs = [work / f"out_{r}.npz" for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(worker), str(r), str(world), str(work / "store"),
                               str(work / "inputs.npz"), str(outs[r]), job],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=timeout)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    failed = [(r, proc.returncode, logs[r][-3000:] if r < len(logs) else "")
              for r, proc in enumerate(procs) if proc.returncode != 0]
    if failed:
        raise RuntimeError(f"ranks failed: {failed}")
    result = []
    for path in outs:
        with np.load(path) as npz:
            result.append(dict(npz))
    return result
