"""K7 (``joint_ne_kernel``, the joint normal-map normal equations), per
launch and mode. Copied from ``chip_smoke.py::joint_ne_operations`` /
``joint_ne_bytes``."""

from gpubench.counts.peaks import LM_LOBE_OPS

JOINT_M = 9
# angle channels of the joint kernel's base lobes
BASE_ANGLES = {"blinn_phong": ("cos_ln", "cos_nh"), "phong": ("cos_ln", "cos_rv"),
               "cook_torrance": ("cos_ln", "cos_nh", "cos_vn"),
               "ward": ("cos_ln", "cos_nh", "cos_vn")}


def rows(m: int, mode: str) -> int:
    return {"chi2": 1, "grad": 1 + m, "full": 1 + m * (m + 1) // 2 + m}[mode]


def nbytes(t: int, v: int, mode: str) -> float:
    """12 floats a (view, texel) pair (L, V, y, w), 18 a texel, R rows out."""
    return 4.0 * t * (12 * v + 18 + rows(JOINT_M, mode))


def operations(base: str, t: int, v: int, mode: str) -> float:
    value, full = LM_LOBE_OPS[base]
    names = BASE_ANGLES[base]
    a = len(names)
    pairs = float(t) * v
    half = 14 if "cos_nh" in names else 0
    dots = a + (1 if "cos_rv" in names else 0)
    if mode == "chi2":
        return pairs * (half + 5 * dots + (8 if "cos_rv" in names else 0) + 3 * (value + 4))
    geo = half + 15 * dots + (18 if "cos_rv" in names else 0)
    per_channel = 1.5 * full + 2 * (2 * a - 1) + 5 + 10
    if mode == "full":
        per_channel += 15 * 3 + 1
    return pairs * (geo + 3 * per_channel)
