"""K1 (``varpro_kernel``, the fused 1-D VarPro solve): fixed work, no lane
stops early. Copied from ``chip_smoke.py::k1_operations`` / ``k1_bytes``."""

LOBE_OPS = {"blinn_phong": 10, "phong": 16, "cook_torrance": 48, "ward": 24}
GRID_ACC_OPS, NEWTON_ACC_OPS, RESID_OPS = 7, 15, 8
PER_TEXEL_SOLVE_OPS = 80


def operations(model: str, t: int, v: int, n_grid: int, iters: int, with_p0: bool) -> float:
    lobe = LOBE_OPS[model]
    grid = 0 if with_p0 else n_grid * (lobe + GRID_ACC_OPS)
    newton = (iters + 1) * (lobe + NEWTON_ACC_OPS + RESID_OPS)
    staging = lobe + 4
    solves = (0 if with_p0 else n_grid) + iters + 1
    return float(t) * (v * (staging + grid + newton) + PER_TEXEL_SOLVE_OPS * solves)


def nbytes(n_angles: int, t: int, v: int, with_p0: bool) -> float:
    """Each input read once, each output written once."""
    return 4.0 * t * ((n_angles + 2) * v + (1 if with_p0 else 0) + 8)
