"""The ``timber-aniso-16led.varpro`` cell, driven as a run drives it but on
the CPU at a tiny size: the sound program is correct; the control and each
planted fault (``faults._texel_fault``, the per-texel fit's) are not. Also
K8's frozen counts against ``chip_smoke.py``'s, and the aniso reference,
generator and counts loading nothing of the program."""

import numpy as np
import pytest
import torch

from gpubench import core, faults
from gpubench.counts import k8
from gpubench.tests.test_gpubench_guard import _loaded
from gpubench.tests.test_gpubench_reference import tiny

CPU = torch.device("cpu")
CELL = "timber-aniso-16led.varpro"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small operations: torch's thread pool gains nothing on them, and
    beside other test workers on the same cores its waiting threads slow the
    file many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def correct(cell, numbers) -> bool:
    limits = cell.traffic["check"]["limits"]
    return all(numbers[k] <= limits[k] for k in limits)


@pytest.fixture(scope="module")
def driven():
    cell = tiny(CELL)
    entry = core.entry_module(cell).Entry(cell, 2**31 + 99, CPU)
    entry.traffic = dict(entry.traffic, warm_calls=1)
    entry.setup()
    window = core.closed_loop(entry.request, 0.0, int(cell.traffic["check"]["sample"]),
                              np.random.default_rng(0))
    return cell, entry, window


def test_sound_run_is_correct(driven):
    cell, entry, window = driven
    assert correct(cell, entry.judge(window.samples))


def test_control_is_not_correct(driven):
    cell, entry, window = driven
    assert not correct(cell, entry.judge(window.samples, answers=entry.control))


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_fault_is_not_correct(driven, fault):
    cell, entry, _ = driven
    with faults._texel_fault(fault):
        records = [entry.request(1000 + i)[1] for i in range(2)]
    assert not correct(cell, entry.judge(records[-1:]))


@pytest.mark.parametrize("t,v", [(131072, 16), (313356, 16), (8187, 48), (517, 37)])
@pytest.mark.parametrize("model", ["ward_aniso", "cook_torrance_aniso", "cook_torrance_fresnel"])
def test_k8_counts_equal_chip_smoke(model, t, v):
    chip_smoke = pytest.importorskip("chip_smoke")
    for grid, iters, with_p0 in ((18, 16, False), (18, 16, True), (32, 0, False), (8, 6, True)):
        assert k8.operations(model, t, v, grid, iters, with_p0) == \
            chip_smoke.k8_operations(model, t, v, grid, iters, with_p0)
    for with_p0 in (False, True):
        assert k8.nbytes(model, t, v, with_p0) == chip_smoke.k8_bytes(model, t, v, with_p0)


def test_aniso_reference_and_generator_load_nothing_of_the_program():
    top = _loaded("import gpubench.reference.ward_aniso, gpubench.traffic.scan_aniso, "
                  "gpubench.counts.k8")
    assert not top & {"jax", "jaxlib", "flax", "brdf_tpu", "brdf_tpu_torch"}
