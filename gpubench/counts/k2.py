"""K2 (``shade_fwd_kernel``, the forward shading of the serve path).
Copied from ``chip_smoke.py::shade_bytes`` / ``shade_operations``
(the ``fwd`` entries)."""

from gpubench.counts.peaks import ANGLES, LM_LOBE_OPS, PARAMS


def nbytes(model: str, t: int, v: int) -> float:
    """Angles and parameters read once, the (V, T) values written once."""
    return 4.0 * t * (ANGLES[model] * v + PARAMS[model] + v)


def operations(model: str, t: int, v: int) -> float:
    return float(t) * v * LM_LOBE_OPS[model][0]
