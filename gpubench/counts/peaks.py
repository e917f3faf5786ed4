"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at the full
700 W power limit): FP32 outside the tensor cores, and HBM3 bandwidth."""

FP32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12

# angle channels and parameters of each lobe, as the kernels take them
ANGLES = {"blinn_phong": 2, "phong": 2, "cook_torrance": 3, "ward": 3, "cook_torrance_fresnel": 4,
          "lambert": 1, "minnaert": 2, "oren_nayar": 3, "ward_aniso": 5, "cook_torrance_aniso": 9}
PARAMS = {"blinn_phong": 3, "phong": 3, "cook_torrance": 3, "ward": 3, "cook_torrance_fresnel": 4,
          "lambert": 1, "minnaert": 2, "oren_nayar": 2, "ward_aniso": 5, "cook_torrance_aniso": 5}
# FP32 operations of one lobe evaluation (the value alone, the value with
# its parameter partials), counted from the kernels' lobe library
LM_LOBE_OPS = {
    "blinn_phong": (11, 13), "phong": (14, 19), "cook_torrance": (40, 80), "ward": (26, 34),
    "cook_torrance_fresnel": (57, 102), "lambert": (3, 3), "minnaert": (17, 20),
    "oren_nayar": (51, 65), "ward_aniso": (46, 81), "cook_torrance_aniso": (85, 207),
}


def bound_seconds(nbytes: float, ops: float) -> float:
    """The least time the card could take: the larger of the byte and the
    operation bound."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)
