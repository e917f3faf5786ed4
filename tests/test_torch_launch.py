"""The launch path of the hand-written kernels (brdf_tpu_torch/ops/_build.py):
every CUDA wrapper holds its operands to ``check_operands`` before it
launches, so a CPU tensor, another dtype, a strided operand and operands on
two devices are each refused with the kernel's name; ``launch`` and
``query`` turn a ``cudaError`` into ``RuntimeError``; ``on_cuda`` picks the
kernel or its plain version; every ``Entry`` types each parameter of its C
function, the stream included (an argument past ``argtypes`` would go as a
C int, and a pointer's upper half would be whatever the stack held). Nothing here needs a card: where a check must
get past "is this a CUDA tensor", the test makes every tensor say so."""

import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from brdf_tpu_torch.ops import _build, grid_init, joint_levmar, lm as k5, ne, shading  # noqa: E402
from brdf_tpu_torch.ops import varpro as k1, varpro_nd as k8  # noqa: E402
from brdf_tpu_torch.solver.init import default_shape_grid  # noqa: E402
from brdf_tpu_torch.solver.lm import LMOptions  # noqa: E402

T, V = 5, 4
OPTS = LMOptions(eps1=1e-6, eps2=1e-7, eps3=1e-12, itmax=10)
# every CUDA wrapper, by the kernel name its messages give
WRAPPERS = ("K1", "K8", "K5", "K6", "K7", "lm_step_propose", "lm_step_accept",
            "the lobe kernel", "K2", "K3", "K4", "the grid init kernel", "the joint LM kernel")


def _wrapper(kernel: str):
    """``(call, operands)``: the wrapper of ``kernel`` on valid-shaped CPU
    float32 operands, called as ``call(operands)``."""
    z = torch.zeros
    if kernel == "K1":
        cfg = k1.config("blinn_phong")
        return lambda a: k1.varpro_rows_cuda(cfg, *a, None, 2), [z(2, V, T), z(V, T), z(V, T)]
    if kernel == "K8":
        cfg = k8.config("ward_aniso")
        return lambda a: k8.varpro_nd_rows_cuda(cfg, *a, None, 2), [z(5, V, T), z(V, T), z(V, T)]
    if kernel == "K5":
        cfg = k5.config("blinn_phong", OPTS, (0.0,) * 3, (100.0,) * 3)
        return lambda a: k5.lm_rows_cuda(cfg, *a), [z(2, V, T), z(V, T), z(V, T), z(8, T)]
    if kernel == "K6":
        return (lambda a: ne.ne_rows_cuda("cook_torrance", "full", *a),
                [z(3, V, T), z(V, T), z(V, T), z(3, T)])
    if kernel == "K7":
        return (lambda a: ne.joint_ne_rows_cuda("cook_torrance", "full", *a),
                [z(6, V, T), z(3, V, T), z(3, V, T), z(9, T), z(9, T)])
    if kernel.startswith("lm_step"):
        m = 3
        cfg = k5.solve_config("cook_torrance", OPTS, (0.0,) * m, (100.0,) * m)
        active = z(1, dtype=torch.int32)
        if kernel == "lm_step_propose":
            return (lambda a: ne.lm_step_propose_cuda(cfg, *a, active),
                    [z(ne.ne_rows_count(m, "full"), T), z(m, T), z(6, T), z(m, T), z(6, T)])
        return (lambda a: ne.lm_step_accept_cuda(cfg, *a, active),
                [z(T), z(6, T), z(m, T), z(m, T), z(6, T)])
    if kernel == "the lobe kernel":
        return lambda a: shading.shading_eval_cuda("ward", *a), [z(3, V, T), z(3, T)]
    if kernel == "K2":
        return lambda a: shading.shade_fwd_cuda("ward", *a), [z(3, V, T), z(3, T)]
    if kernel in ("K3", "K4"):
        fn = shading.shade_bwd_params_cuda if kernel == "K3" else shading.shade_bwd_angles_cuda
        return lambda a: fn("ward", *a), [z(3, V, T), z(3, T), z(V, T)]
    if kernel == "the joint LM kernel":
        lo, hi = (0.0,) * 11, (1.0,) * 11
        return (lambda a: joint_levmar.joint_levmar_cuda("ward_aniso", *a, lo, hi, OPTS),
                [z(6, V, T), z(3, V, T), z(3, V, T), z(9, T), z(11, T)])
    grid = default_shape_grid("blinn_phong")
    return (lambda a: grid_init.grid_init_cuda("blinn_phong", *a, grid),
            [z(2, T, V), z(T, V), z(T, V)])


def _strided(x: torch.Tensor) -> torch.Tensor:
    """``x``'s shape and values, not contiguous."""
    out = torch.empty(x.shape + (2,), dtype=x.dtype)[..., 0]
    out.copy_(x)
    return out


@pytest.mark.parametrize("fault", ["cpu", "float64", "strided", "two_devices"])
@pytest.mark.parametrize("kernel", WRAPPERS)
def test_every_wrapper_refuses_what_no_kernel_takes(monkeypatch, kernel, fault):
    call, operands = _wrapper(kernel)
    counts = (k1.LAUNCHES, k8.LAUNCHES, k5.LAUNCHES, dict(ne.LAUNCHES), shading.LAUNCHES,
              dict(shading.SHADE_LAUNCHES), grid_init.LAUNCHES, joint_levmar.LAUNCHES)
    if fault != "cpu":
        # every tensor says it is a CUDA tensor, so the check reaches its next test
        monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True), raising=False)
    if fault == "float64":
        operands[1] = operands[1].double()
        match = f"{kernel} takes contiguous float32 CUDA tensors"
    elif fault == "strided":
        operands[0] = _strided(operands[0])
        match = f"{kernel} takes contiguous float32 CUDA tensors"
    elif fault == "two_devices":
        operands[1] = operands[1].to("meta")
        match = f"{kernel}'s inputs must lie on one device"
    else:
        match = f"{kernel} takes contiguous float32 CUDA tensors"
    with pytest.raises(ValueError, match=match):
        call(operands)
    assert counts == (k1.LAUNCHES, k8.LAUNCHES, k5.LAUNCHES, dict(ne.LAUNCHES), shading.LAUNCHES,
                      dict(shading.SHADE_LAUNCHES), grid_init.LAUNCHES, joint_levmar.LAUNCHES)


class _Fake:
    """Stands in for a C entry: records its arguments, returns ``err`` and
    fills a query's int array with 1, 2, 3, …"""

    def __init__(self, err: int):
        self.err, self.calls = err, []

    def __call__(self, *args):
        self.calls.append(args)
        if not isinstance(args[-1], int):
            for i in range(len(args[-1])):
                args[-1][i] = i + 1
        return self.err


ENTRY = _build.Entry("K9", "nine", "brdf_nine", (_build.I, _build.P))


@pytest.mark.parametrize("err", [0, 700])
def test_launch_enters_the_device_and_names_the_kernel_on_an_error(monkeypatch, err):
    fake, entered = _Fake(err), []

    class _Device:
        def __init__(self, device):
            entered.append(("enter", device))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            entered.append("exit")

    monkeypatch.setattr(_build, "lookup", lambda e: fake)
    monkeypatch.setattr(torch.cuda, "device", _Device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: type("S", (), {"cuda_stream": 11}))
    if err:
        with pytest.raises(RuntimeError, match=r"K9 \(csrc/nine.cu\) launch failed with cudaError 700"):
            _build.launch(ENTRY, "dev", 5)
    else:
        _build.launch(ENTRY, "dev", 5)
    assert fake.calls == [(5, 11)]          # the stream last
    assert entered == [("enter", "dev"), "exit"]


@pytest.mark.parametrize("err", [0, 2])
def test_query_fills_its_int_array(monkeypatch, err):
    fake = _Fake(err)
    monkeypatch.setattr(_build, "lookup", lambda e: fake)
    if err:
        with pytest.raises(RuntimeError, match="K9 occupancy query failed with cudaError 2"):
            _build.query(ENTRY, 5, 7, 8)
        return
    assert _build.query(ENTRY, 5, 7, 8) == [1, 2, 3, 4, 5]
    assert fake.calls[0][:2] == (7, 8)


def test_on_cuda_picks_the_plain_version_on_the_cpu_and_refuses_other_devices():
    assert _build.on_cuda(torch.zeros(1), "the nine kernels run") is False
    with pytest.raises(ValueError, match="the nine kernels run on cuda or cpu, not meta"):
        _build.on_cuda(torch.zeros(1, device="meta"), "the nine kernels run")
    rows = ne.ne_rows("lambert", "chi2", torch.zeros(1, 4, 2), torch.zeros(4, 2), None,
                      torch.zeros(1, 2))
    assert rows.shape == (1, 2) and ne.LAUNCHES["ne"] == 0


CSRC = Path(_build.__file__).resolve().parents[1] / "csrc"
_C_ENTRY = re.compile(r'extern "C" int (brdf_\w+)\(([^)]*)\)')
# a C parameter's type → its ctypes argument type
_KINDS = {"int": _build.I, "float": _build.F}


def _c_functions() -> dict:
    """``(source, symbol) → argtypes`` read from the C entries of csrc/*.cu:
    a pointer is P, an int I and a float F."""
    out = {}
    for src in sorted(CSRC.glob("*.cu")):
        for symbol, params in _C_ENTRY.findall(src.read_text()):
            kinds = []
            for prm in params.split(","):
                prm = " ".join(prm.split())
                kinds.append(_build.P if "*" in prm else _KINDS[prm.split(" ")[-2]])
            out[(src.stem, symbol)] = tuple(kinds)
    return out


def _entries() -> dict:
    """Every ``_build.Entry`` the ops modules declare, by symbol."""
    found = {}
    for mod in (k1, k8, k5, ne, shading, grid_init, joint_levmar):
        for value in vars(mod).values():
            for e in value.values() if isinstance(value, dict) else (value,):
                if isinstance(e, _build.Entry):
                    found[e.symbol] = e
    return found


@pytest.mark.parametrize("symbol", sorted(_entries()))
def test_every_entry_types_each_argument_of_its_c_function(symbol):
    entry = _entries()[symbol]
    assert _c_functions()[(entry.source, symbol)] == entry.argtypes


def test_every_c_entry_is_declared_once():
    assert sorted(s for _, s in _c_functions()) == sorted(_entries())
