"""The check, driven as a run drives it but on the CPU at a tiny size: the
sound program is correct; the control (the reference in the program's
place, in bfloat16) and every planted fault are not."""

import numpy as np
import pytest
import torch

from gpubench import core, faults
from gpubench.tests.test_gpubench_reference import tiny

CPU = torch.device("cpu")
CELLS = ["blinn-pixel-16led.varpro", "ct-joint-face-16led.relight", "blinn-pixel-16led.lm",
         "ct-joint-face-16led.fit"]


def correct(cell, numbers) -> bool:
    limits = cell.traffic["check"]["limits"]
    return all(numbers[k] <= limits[k] for k in limits)


@pytest.fixture(scope="module", params=CELLS)
def driven(request):
    """A cell at a tiny size after its set-up and a few requests."""
    cell = tiny(request.param)
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
    with faults.planted(cell.traffic["entry"], fault):
        records = [entry.request(1000 + i)[1] for i in range(2)]
    assert not correct(cell, entry.judge(records[-1:]))
