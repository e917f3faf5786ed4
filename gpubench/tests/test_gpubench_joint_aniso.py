"""The two cells of the timber default and the timber-aniso preset as
shipped, at a tiny size on the CPU.

``timber-joint-aniso-16led.fit``: the scan is what the program's joint
model gives for the truth and the rig's gains; the check passes the
reference's own answers and fails the control and answers with their gains
altered. (At 80 × 60 the 124 faces leave the gains too loosely tied for the
program's alternation to meet the card's limits: the sound run is judged on
the card, ``PERF.md`` §2.) ``timber-aniso-16led.lm``, driven as a run
drives it: the sound program (K5's plain version) is correct; the control
and each planted fault (``faults._texel_fault``) are not. Also the
generator and the reference load nothing of the program."""

import numpy as np
import pytest
import torch

from gpubench import core, faults, program
from gpubench.tests.test_gpubench_guard import _loaded
from gpubench.tests.test_gpubench_reference import tiny
from gpubench.traffic.scan_joint_aniso import make_scan, truth_params

CPU = torch.device("cpu")
JOINT, LM = "timber-joint-aniso-16led.fit", "timber-aniso-16led.lm"


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


def test_scan_is_the_program_joint_model_of_the_truth():
    from brdf_tpu_torch.models.brdf import ShadingGeometry
    from brdf_tpu_torch.models.normalmap import joint_eval, joint_spec

    cfg = tiny(JOINT).config
    scan = make_scan(cfg, 2**31 + 3, 1, device=CPU)
    assert scan.gains.shape == (16,) and abs(scan.gains.mean() - 1.0) < 1e-12
    lo, hi = cfg["truth"]["gains"]
    assert (scan.gains >= lo / hi).all() and (scan.gains <= hi / lo).all()
    cell = tiny(JOINT)
    prob = core.entry_module(cell).Entry(cell, 0, CPU).problem(program.scene(scan))
    geom = ShadingGeometry(*(torch.as_tensor(np.asarray(x), dtype=torch.float64)
                             for x in prob.geometry))
    p = torch.as_tensor(truth_params(scan)[prob.face_ids], dtype=torch.float64)
    want = joint_eval(joint_spec(cfg["model"], cfg["max_tilt"]), p, geom) \
        * torch.as_tensor(scan.gains)[:, None]
    got = torch.as_tensor(prob.intensity, dtype=torch.float64)
    seen = (torch.as_tensor(prob.weights) > 0)[..., None] & (want < 0.98)
    assert seen.sum() > 1000
    # one value a face, quantised to 16 bits; the face's geometry rounded to float32
    assert float((got - want).abs()[seen.expand_as(got)].max()) < 2e-4


@pytest.fixture(scope="module")
def joint():
    """The cell's entry after its set-up, and the reference's answers for
    its scan (kept where the check looks for them)."""
    cell = tiny(JOINT)
    entry = core.entry_module(cell).Entry(cell, 2**31 + 99, CPU)
    entry.traffic = dict(entry.traffic, warm_calls=0)
    entry.pool = 1
    entry.setup()
    p, chi2 = entry.reference(entry.reference_problem(0), torch.float64)
    entry.ref_cache["fit", 0] = p
    return cell, entry, p.cpu().numpy(), chi2.cpu().numpy()


def test_reference_answers_pass_and_the_control_fails(joint):
    cell, entry, p, chi2 = joint
    own = entry.judge([(0, None, None)], answers=lambda k: (p, chi2))
    assert own == {"worse_share": 0.0, "chi2_mismatch_share": 0.0, "texels_unmatched": 0.0,
                   "gain_gap": 0.0}
    assert not correct(cell, entry.judge([(0, None, None)], answers=entry.control))


@pytest.mark.parametrize("scale", [1.03, 0.97])
def test_altered_gains_fail(joint, scale):
    cell, entry, p, chi2 = joint
    q = p.copy()
    q[:, entry.m + 3] *= scale                          # view 3's gain, the rest as they were
    numbers = entry.judge([(0, None, None)], answers=lambda k: (q, chi2))
    assert abs(numbers["gain_gap"] - abs(scale - 1.0)) < 1e-12 and not correct(cell, numbers)


@pytest.fixture(scope="module")
def lm_driven():
    cell = tiny(LM)
    entry = core.entry_module(cell).Entry(cell, 2**31 + 99, CPU)
    entry.traffic = dict(entry.traffic, warm_calls=1)
    entry.setup()
    window = core.closed_loop(entry.request, 0.0, int(cell.traffic["check"]["sample"]),
                              np.random.default_rng(0))
    return cell, entry, window


def test_lm_sound_run_is_correct(lm_driven):
    cell, entry, window = lm_driven
    assert correct(cell, entry.judge(window.samples))


def test_lm_control_is_not_correct(lm_driven):
    cell, entry, window = lm_driven
    assert not correct(cell, entry.judge(window.samples, answers=entry.control))


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_lm_fault_is_not_correct(lm_driven, fault):
    cell, entry, _ = lm_driven
    with faults._texel_fault(fault):
        records = [entry.request(1000 + i)[1] for i in range(2)]
    assert not correct(cell, entry.judge(records[-1:]))


def test_joint_aniso_reference_and_generator_load_nothing_of_the_program():
    top = _loaded("import gpubench.reference.joint_aniso, gpubench.traffic.scan_joint_aniso")
    assert not top & {"jax", "jaxlib", "flax", "brdf_tpu", "brdf_tpu_torch"}
