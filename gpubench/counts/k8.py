"""K8 (``varpro_nd_kernel``, the fused d-D VarPro solve): fixed work, no
lane stops early. Copied from ``chip_smoke.py::k8_operations`` /
``k8_bytes``."""

from gpubench.counts.peaks import ANGLES, LM_LOBE_OPS, PARAMS

# per (view, texel) outside the lobe: the staging pass, a grid point's
# accumulation; per texel: the grid point's solve, a Newton step's scalar work
STAGE_OPS, GRID_ACC_OPS = 6, 7
GRID_SOLVE_OPS, STEP_OPS = 70, 160


def newton_acc_ops(d: int) -> int:
    """A Newton evaluation's three passes a (view, texel)."""
    return 7 + 6 + 8 * d + 6 * d + d * (d + 1)


def operations(model: str, t: int, v: int, n_grid: int, iters: int, with_p0: bool) -> float:
    """The staging evaluation, the grid's value-only evaluations, (iters + 1)
    evaluations with the shape partials and the three passes."""
    value, full = LM_LOBE_OPS[model]
    d = PARAMS[model] - 2
    grid = 0 if with_p0 else n_grid
    per_view = (full + STAGE_OPS + grid * (value + GRID_ACC_OPS)
                + (iters + 1) * (full + newton_acc_ops(d)))
    return float(t) * (v * per_view + grid * GRID_SOLVE_OPS + (iters + 1) * STEP_OPS)


def nbytes(model: str, t: int, v: int, with_p0: bool) -> float:
    """Each input read once (angles, y, w, the start rows), 16 rows written."""
    return 4.0 * t * ((ANGLES[model] + 2) * v + (PARAMS[model] if with_p0 else 0) + 16)
