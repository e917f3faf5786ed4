"""Probe of kernel K3 (``csrc/shade.cu::shade_bwd_params_kernel``) on one GPU.

    python3 tools/k3_probe.py [--baseline DIR] [--all-lobes] [--out FILE]

Separates what holds K3 (bytes or issue) before and after a change to it.
It builds ``brdf_tpu_torch/csrc/shade.cu`` with the port's own nvcc flags
into ``build/k3_probe/`` and also:

- a copy in which K3's lobe evaluation is stubbed out (the view's angles
  summed, times each parameter): same loads, same stores, almost no
  arithmetic, so its time is what the bytes and the loop cost alone;
- with ``--baseline DIR``, the ``shade.cu`` of another ``csrc`` directory
  (an earlier commit's, unpacked beside the repository).

Every build is timed in turns on the same inputs (each in order, then in
reverse order), so that the builds share one card and its state.

For each build it reports K3's registers (``-Xptxas -v``), the warps an SM
they allow (the CUDA runtime's, through the build's own
``brdf_shade_bwd_params_occupancy``, where it has one), and its SASS
instructions per (view, texel) pair from ``cuobjdump -sass`` (``chip_smoke.py::view_loop``). The
issue floor is instructions × pairs / (SMs × 4 schedulers × 32 lanes × the
SM clock). Times are CUDA events around 20 back-to-back launches, median of
3, on the shading batch (cook_torrance, 1048576 × 16), at T halved and
doubled, at V = 8, 16 and 32, on the relight call's shape (1581363 × 16)
and for blinn_phong (with ``--all-lobes`` every lobe at the batch's shape);
each output is held against the plain version (equality) for the builds
that evaluate the lobe. Prints one JSON object and writes it to ``--out``
(default ``chiprun_out/k3_probe.json``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from brdf_tpu_torch.ops import _build, shading as k0  # noqa: E402

OUT_DIR = ROOT / "build" / "k3_probe"
# (model, T, V) of each timed case; the first is the shading batch
CASES = {
    "batch": ("cook_torrance", cs.T_SHADE, 16),
    "half_T": ("cook_torrance", cs.T_SHADE // 2, 16),
    "double_T": ("cook_torrance", cs.T_SHADE * 2, 16),
    "V8": ("cook_torrance", cs.T_SHADE, 8),
    "V32": ("cook_torrance", cs.T_SHADE, 32),
    "relight_shape": ("cook_torrance", 1581363, 16),
    "blinn_phong_batch": ("blinn_phong", cs.T_SHADE, 16),
}
# with --all-lobes, every other lobe at the shading batch's shape too
OTHER_LOBES = tuple(m for m in cs.ALL_LOBES if m not in ("cook_torrance", "blinn_phong"))
STUB = """
template <int L>
__device__ __forceinline__ brdf::LobeOut<L> k3_probe_stub(const float* av, const float* p) {
  brdf::LobeOut<L> o;
  float s = av[0];
#pragma unroll
  for (int a = 1; a < brdf::LobeTraits<L>::n_angles; ++a) s = s + av[a];
  o.i = s;
#pragma unroll
  for (int j = 0; j < brdf::LobeTraits<L>::n_params; ++j) o.dp[j] = s * p[j];
#pragma unroll
  for (int a = 0; a < brdf::LobeTraits<L>::n_angles; ++a) o.da[a] = 0.0f;
  return o;
}
"""


def stub_source(text: str) -> str:
    """K3's lobe call replaced by the stub; the other kernels untouched."""
    start = text.index("shade_bwd_params_kernel(")
    end = text.index("shade_bwd_angles_kernel(")
    body = text[start:end]
    stubbed, n = re.subn(r"brdf::lobe_full<L>\(", "k3_probe_stub<L>(", body)
    if n == 0:
        raise RuntimeError("no lobe call found in K3's body to stub")
    head = text[:start].replace("namespace {", "namespace {\n" + STUB, 1)
    return head + stubbed + text[end:]


def build(label: str, source: Path, include: Path) -> dict:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    lib = OUT_DIR / f"libshade_{label}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(include), "-o", str(lib),
           str(source)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stdout}")
    regs = {e["entry"]: e for e in _build.ptxas_report(proc.stdout)
            if "shade_bwd_params" in e["entry"]}
    return dict(lib=lib, ptxas=regs)


def entry(lib: Path):
    fn = ctypes.CDLL(str(lib)).brdf_shade_bwd_params
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i, p, p, p, p, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def warps_per_sm(lib: Path, model: str) -> int | None:
    """K3's resident warps an SM for ``model`` in a build, from the CUDA
    runtime (``brdf_shade_bwd_params_occupancy``); None for a build that has
    no such entry (an earlier commit's)."""
    occ = getattr(ctypes.CDLL(str(lib)), "brdf_shade_bwd_params_occupancy", None)
    if occ is None:
        return None
    occ.argtypes = [ctypes.c_int, ctypes.c_void_p]
    occ.restype = ctypes.c_int
    res = (ctypes.c_int * 4)()
    if occ(k0.SHADING_KERNELS[model].lobe_id, res) != 0:
        raise RuntimeError(f"K3 occupancy query failed for {model}")
    return res[0] * res[3] // 32


def launch(fn, model: str, ang, prm, ct):
    out = torch.empty_like(prm)
    err = fn(k0.SHADING_KERNELS[model].lobe_id, ang.data_ptr(), prm.data_ptr(), ct.data_ptr(),
             out.data_ptr(), ang.shape[2], ang.shape[1],
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"K3 launch failed with cudaError {err}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", type=Path, help="a csrc directory whose shade.cu is timed too")
    ap.add_argument("--all-lobes", action="store_true",
                    help="time every lobe at the shading batch's shape, not only two")
    ap.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "k3_probe.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k3_probe: no CUDA device is available", file=sys.stderr)
        return 1
    csrc = _build.CSRC
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    stub = OUT_DIR / "shade_stub.cu"
    stub.write_text(stub_source((csrc / "shade.cu").read_text()))
    sources = {"current": (csrc / "shade.cu", csrc), "stub": (stub, csrc)}
    if args.baseline is not None:
        sources["baseline"] = (args.baseline / "shade.cu", args.baseline)
    builds = {label: build(label, *src) for label, src in sources.items()}
    cases = dict(CASES)
    if args.all_lobes:
        cases.update({f"{m}_batch": (m, cs.T_SHADE, 16) for m in OTHER_LOBES})
    clock_hz = cs.sm_clock_max_hz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lanes_per_s = sms * 4 * 32 * clock_hz
    res = dict(card=cs.card_line(), sm_clock_max_mhz=clock_hz / 1e6, sms=sms, builds={})
    for label, b in builds.items():
        funcs = _build.sass(b["lib"])
        per_lobe = {}
        for model in sorted({m for m, _, _ in cases.values()}):
            spec = k0.SHADING_KERNELS[model]
            name = next(n for n in funcs if "shade_bwd_params" in n
                        and f"ILi{spec.lobe_id}E" in n)
            ptx = next((e for n, e in b["ptxas"].items() if f"ILi{spec.lobe_id}E" in n), {})
            per_lobe[model] = dict(
                registers=ptx.get("registers"), spill_bytes=ptx.get("spill_store_bytes"),
                warps_per_sm=warps_per_sm(b["lib"], model),
                sass_total=len(funcs[name]),
                loop=cs.view_loop(funcs[name], len(spec.angle_names) + 1))
        res["builds"][label] = dict(per_lobe=per_lobe, times={})
    rng = np.random.default_rng(61)
    order = list(builds)
    turns = order + order[::-1]
    fns = {label: entry(b["lib"]) for label, b in builds.items()}
    for key, (model, t, v) in cases.items():
        ang, prm, ct = cs.make_shade_case(rng, model, t, v)
        ref = k0.shade_bwd_params_plain(model, ang, prm, ct)
        nbytes = cs.shade_bytes(model, t, v)["bwd_params"]
        pairs = float(t) * v
        for label in order:
            got = launch(fns[label], model, ang, prm, ct)
            torch.cuda.synchronize()
            rec = res["builds"][label]["times"].setdefault(key, dict(model=model, texels=t, views=v))
            if label != "stub":
                rec["equal_to_plain"] = bool(cs.same(got, ref).all())
        runs = {label: [] for label in order}
        for label in turns:
            runs[label].append(cs.cuda_ms(lambda: launch(fns[label], model, ang, prm, ct), reps=20))
        for label in order:
            rec = res["builds"][label]["times"][key]
            per_pair = res["builds"][label]["per_lobe"][model]["loop"]["per_pair"]
            rec.update(ms=float(np.median(runs[label])), ms_runs=runs[label],
                       byte_bound_ms=nbytes / cs.HBM_BYTES_PER_S * 1e3,
                       issue_floor_ms=(per_pair * pairs / lanes_per_s * 1e3
                                       if per_pair else None))
        print(f"[k3_probe] {key}: " + ", ".join(
            f"{label} {res['builds'][label]['times'][key]['ms']:.4f} ms" for label in order),
            file=sys.stderr, flush=True)
        del ang, prm, ct, ref
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
