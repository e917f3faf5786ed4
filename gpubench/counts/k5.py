"""K5 (``lm_kernel``, the fused LM solve): the work these inputs needed,
from the iterations each lane took. Copied from
``chip_smoke.py::k5_operations`` / ``k5_bytes``."""

from gpubench.counts.peaks import ANGLES, LM_LOBE_OPS, PARAMS

LM_SOLVE_OPS = {1: 40, 2: 70, 3: 120, 4: 190, 5: 270}


def operations(model: str, v: int, lanes: int, iters_sum: float) -> float:
    """Every lane evaluates χ² once, then per iteration one Jacobian pass
    with the normal-equation sums, one trial χ² pass and one solve."""
    value, full = LM_LOBE_OPS[model]
    m = PARAMS[model]
    acc = 3 + 3 * (m * (m + 1) // 2) + 3 * m
    per_iter = v * (full + acc) + v * (value + 4) + LM_SOLVE_OPS[m]
    return float(lanes) * v * (value + 4) + float(iters_sum) * per_iter


def nbytes(model: str, t: int, v: int) -> float:
    """Each input read once (angles, y, w, the 8 start rows), 16 rows written."""
    return 4.0 * t * ((ANGLES[model] + 2) * v + 8 + 16)
