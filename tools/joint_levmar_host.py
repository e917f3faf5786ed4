"""The joint LM kernel (``brdf_tpu_torch/csrc/joint_levmar.cu``) on the host:
its CUDA source built with g++ against ``tools/host_simt/`` (a warp of 32
lanes, each a context of its own, that meet at every warp intrinsic; the
warps of the whole grid take turns) and run through its own C entry on CPU
tensors, so that its state machine, lane groups and refill can be checked
without a card, at any lanes a face and any grid.

    from tools import joint_levmar_host as host
    res = host.solve("cook_torrance_aniso", lv, y, w, frame, p0_rows, lower, upper, opts,
                     lanes=8, sms=1)

The arithmetic is the kernel's, rounded by the host (``-ffp-contract=off``,
as the card's ``-fmad=false``; the host's libm in place of CUDA's), so the
answers agree with the card's to float32's rounding, not bit for bit. A
warp whose lanes reach different intrinsics or leave the kernel apart is
refused (``RuntimeError``). The build goes to ``build/joint_levmar_host/``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from brdf_tpu_torch.ops import joint_levmar as jl
from brdf_tpu_torch.ops.shading import SHADING_KERNELS
from brdf_tpu_torch.solver.lm import LMOptions, LMResult

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "brdf_tpu_torch" / "csrc"
SHIM = Path(__file__).resolve().parent / "host_simt"
BUILD = ROOT / "build" / "joint_levmar_host"
FLAGS = ["-std=c++20", "-O2", "-shared", "-fPIC", "-ffp-contract=off", "-w"]


def available() -> bool:
    """Whether a host compiler is there to build the kernel with."""
    return shutil.which("g++") is not None


def host_source(cuda: str) -> str:
    """The kernel's source as host C++: its dynamic shared memory is the
    block's buffer of ``simt.h``, and its launch ``simt.h``'s ``launch``."""
    out = cuda.replace("extern __shared__ float smem[];", "float* const smem = brdf_host::g_smem;")
    launch = re.compile(r"(\w+)<<<(.*?)>>>\(", re.S)
    match = launch.search(out)
    if match is None or "extern __shared__" in out:
        raise ValueError("joint_levmar.cu: no launch or shared memory in the form the host build reads")
    grid, block, smem = (x.strip() for x in match.group(2).split(",")[:3])
    return (out[:match.start()] + f"brdf_host::launch({match.group(1)}, {grid}, {block}, {smem}, "
            + out[match.end():])


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The host build of the kernel, made once for its sources' contents."""
    sources = [CSRC / f for f in ("joint_levmar.cu", "lobes.cuh", "bvls2.cuh", "lanegroup.cuh")]
    sources += [SHIM / "simt.h", SHIM / "cuda_runtime.h"]
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in sources)
                            + " ".join(FLAGS).encode()).hexdigest()[:16]
    lib = BUILD / f"libjoint_levmar_host.{digest}.so"
    if not lib.exists():
        # each process builds under names of its own, and the last to finish
        # puts its library in place (test workers may build at once)
        BUILD.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
            tu = Path(tmp) / "joint_levmar_host.cpp"
            tu.write_text(host_source((CSRC / "joint_levmar.cu").read_text()))
            subprocess.run(["g++", *FLAGS, f"-I{SHIM}", f"-I{CSRC}", str(tu), "-o",
                            str(Path(tmp) / lib.name)], check=True, capture_output=True, text=True)
            os.replace(Path(tmp) / lib.name, lib)
    so = ctypes.CDLL(str(lib))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    so.brdf_joint_levmar.argtypes = (I,) + (P,) * 9 + (I, I, I, P, P) + (F,) * 6 + (I, I, P)
    so.brdf_joint_levmar.restype = I
    so.brdf_host_set_sms.argtypes = (I,)
    so.brdf_host_error.restype = ctypes.c_char_p
    return so


def solve(base_model: str, lv, y, w, frame, p0_rows, lower, upper, opts: LMOptions,
          lanes: int, sms: int = 132) -> LMResult:
    """``ops/joint_levmar.py::joint_levmar_cuda`` on the host: the same
    operands (contiguous float32 CPU tensors), ``lanes`` lanes a face and a
    card of ``sms`` SMs of two blocks each (fewer blocks than the faces fill
    make groups refill) → ``levmar_bc``'s ``LMResult``."""
    so = library()
    _, v, t = lv.shape
    ops = [x.contiguous().float() for x in (lv, y, w, frame, p0_rows)]
    p = torch.empty((t, jl.M), dtype=torch.float32)
    f = torch.empty((5, t), dtype=torch.float32)
    n = torch.empty((5, t), dtype=torch.int32)
    counters = torch.zeros(2, dtype=torch.int32)
    lo = (ctypes.c_float * jl.M)(*lower)
    hi = (ctypes.c_float * jl.M)(*upper)
    f32 = torch.tensor([opts.tau, opts.eps1, opts.eps2 * opts.eps2, opts.eps3, opts.mu_max,
                        opts.mu_max / 2], dtype=torch.float32).tolist()
    so.brdf_host_set_sms(sms)
    err = so.brdf_joint_levmar(SHADING_KERNELS[base_model].lobe_id,
                               *(x.data_ptr() for x in ops), p.data_ptr(), f.data_ptr(),
                               n.data_ptr(), counters.data_ptr(), t, v, lanes, lo, hi, *f32,
                               int(opts.itmax), int(opts.max_inner), None)
    if err:
        why = so.brdf_host_error()
        raise RuntimeError(f"the joint LM kernel on the host: error {err}"
                           + (f" ({why.decode()})" if why else ""))
    return LMResult(p=p, chi2=f[0], chi2_init=f[1], g_inf=f[2], iters=n[0], stop=n[1],
                    nfev=n[2], njev=n[3], mu=f[3], nu=f[4], nlss=n[4],
                    constraint_violation=torch.zeros(t, dtype=torch.float32))
