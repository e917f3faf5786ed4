"""The frozen counts equal chip_smoke.py's, three shapes a kernel."""

import pytest
import torch

chip_smoke = pytest.importorskip("chip_smoke")

from gpubench.counts import k1, k2, k5, k7, peaks  # noqa: E402

SHAPES = [(131072, 16), (313353, 16), (8187, 48)]


@pytest.mark.parametrize("t,v", SHAPES)
@pytest.mark.parametrize("model", ["blinn_phong", "cook_torrance", "phong", "ward"])
def test_k1(model, t, v):
    for grid, iters, with_p0 in ((8, 16, False), (8, 6, True), (16, 0, False)):
        assert k1.operations(model, t, v, grid, iters, with_p0) == \
            chip_smoke.k1_operations(model, t, v, grid, iters, with_p0)
    for a in (2, 3):
        for with_p0 in (False, True):
            assert k1.nbytes(a, t, v, with_p0) == chip_smoke.k1_bytes(a, t, v, with_p0)


@pytest.mark.parametrize("t,v", SHAPES)
@pytest.mark.parametrize("model", ["blinn_phong", "cook_torrance", "ward_aniso"])
def test_k5(model, t, v):
    iters = torch.arange(t, dtype=torch.float32) % 13
    assert k5.operations(model, v, t, float(iters.double().sum())) == \
        chip_smoke.k5_operations(model, v, iters)
    assert k5.nbytes(model, t, v) == chip_smoke.k5_bytes(model, t, v)


@pytest.mark.parametrize("t,v", SHAPES)
@pytest.mark.parametrize("mode", ["chi2", "grad", "full"])
@pytest.mark.parametrize("base", ["cook_torrance", "blinn_phong", "phong"])
def test_k7(base, mode, t, v):
    assert k7.operations(base, t, v, mode) == chip_smoke.joint_ne_operations(base, t, v, mode)
    assert k7.nbytes(t, v, mode) == chip_smoke.joint_ne_bytes(t, v, mode)


@pytest.mark.parametrize("t,v", SHAPES)
@pytest.mark.parametrize("model", ["cook_torrance", "blinn_phong", "ward_aniso"])
def test_k2(model, t, v):
    assert k2.nbytes(model, t, v) == chip_smoke.shade_bytes(model, t, v)["fwd"]
    assert k2.operations(model, t, v) == chip_smoke.shade_operations(model, t, v)["fwd"]


def test_peaks_and_tables():
    from brdf_tpu_torch.ops.shading import SHADING_KERNELS

    assert (peaks.FP32_OPS_PER_S, peaks.HBM_BYTES_PER_S) == \
        (chip_smoke.FP32_OPS_PER_S, chip_smoke.HBM_BYTES_PER_S)
    assert peaks.LM_LOBE_OPS == chip_smoke.LM_LOBE_OPS
    for name, spec in SHADING_KERNELS.items():
        assert peaks.ANGLES[name] == len(spec.angle_names)
        assert peaks.PARAMS[name] == spec.n_params
    for base, names in k7.BASE_ANGLES.items():
        assert names == SHADING_KERNELS[base].angle_names
    assert peaks.bound_seconds(3.35e12, 1.0) == 1.0
