"""The closed loop, its statistics, the trace's reduction, and one run on
the card."""

import json
import subprocess
import sys

import numpy as np
import pytest

from gpubench import core
from gpubench.trace import Event, _short, summarize


def test_percentile_is_nearest_rank():
    vals = list(range(1, 101))
    assert core.percentile(vals, 95) == 95
    assert core.percentile([3.0], 95) == 3.0
    assert core.percentile([1, 2, 3, 4], 50) == 2


def test_closed_loop_samples_from_the_seed():
    def request(i):
        return 2, i

    runs = [core.closed_loop(request, 0.05, 3, np.random.default_rng(7)) for _ in range(2)]
    for w in runs:
        assert w.units == 2 * len(w.times) and len(w.samples) == 3
        assert all(t > 0 for t in w.times) and w.seconds >= 0.05
    one = core.closed_loop(request, 0.0, 3, np.random.default_rng(7))
    assert len(one.times) == 1 and one.samples == [0]


def test_summarize_a_trace():
    ev = [Event("gpubench.request", False, 0.0, 1.0, 1), Event("gpubench.request", False, 1.0, 2.0, 1),
          Event("aten::mul", False, 0.1, 0.3, 1), Event("cudaLaunchKernel", False, 0.15, 0.2, 1),
          Event("void (anonymous namespace)::varpro_kernel<0, 2, 8>(float const*)", True, 0.2, 0.6, 0),
          Event("Memcpy HtoD (Pageable -> Device)", True, 0.5, 0.8, 0),
          Event("void at::native::foo<1>(int)", True, 1.5, 1.6, 0),
          Event("gpubench.request", True, 0.0, 2.0, 0),
          Event("aten::copy_", False, 1.7, 1.9, 1), Event("void late()", True, 2.5, 2.6, 0)]
    tr = summarize(ev, 2, {}, {})
    assert tr.span_s == 2.0 and abs(tr.busy_s - 0.7) < 1e-12
    assert [n for n, _, _ in tr.kernels][:1] == [ev[4].name] and len(tr.kernels) == 2
    assert abs(tr.kernel_seconds(r"\bvarpro_kernel\b") - 0.4) < 1e-12
    assert tr.device_ops[0][0] == "varpro_kernel<0, 2, 8>"
    idle = dict(tr.idle_gaps)
    assert abs(idle["aten::mul"] - 0.2) < 1e-12            # 0.0–0.2: the host in aten::mul at 0.1
    assert abs(idle["gpubench.request"] - 0.7) < 1e-12     # 0.8–1.5: in no operator
    assert abs(idle["aten::copy_"] - 0.4) < 1e-12          # 1.6–2.0
    assert abs(sum(idle.values()) - 1.3) < 1e-12


def test_short_names():
    assert _short("void (anonymous namespace)::lm_kernel<2>(float const*, int)") == "lm_kernel<2>"
    assert _short("aten::mul") == "aten::mul"


def test_run_refuses_without_enough_devices(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run([sys.executable, "gpubench/run.py", "--workload",
                          "blinn-pixel-16led.varpro", "--seed", "1", "--seconds", "1"],
                         cwd=core.ROOT, capture_output=True, text=True)
    assert out.returncode == 3 and out.stdout == ""


@pytest.mark.card
def test_one_run_on_the_card(card):
    out = subprocess.run([sys.executable, "gpubench/run.py", "--workload",
                          "ct-joint-face-16led.relight", "--seed", str(2**31 + 5), "--seconds", "2",
                          "--trace", "1"], cwd=core.ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) == {"idle_share.relight", "k2_roofline"}
