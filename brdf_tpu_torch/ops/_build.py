"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` becomes ``build/torch_kernels/lib<name>.so`` under
the repository root, compiled at first use by ``nvcc`` for ``sm_90a``
(Hopper) with a plain C interface and loaded with :mod:`ctypes`. That takes
seconds, where a build against PyTorch's headers takes minutes. A library
is rebuilt when any ``csrc`` source is newer than it. :func:`build_all`
starts one ``nvcc`` per source, all at once. Every build runs with
``-Xptxas -v``; what the assembler said of each kernel (registers, spills)
is kept in :data:`BUILD_LOGS` and read with :func:`ptxas_report`, and each
build's wall seconds in :data:`BUILD_SECONDS`; :func:`sass` reads a built
library's machine code back with ``cuobjdump``.

Every ``csrc`` source exports plain C functions that take raw pointers and
scalars and return a ``cudaError``: a launch takes the stream last, an
occupancy query an int array that it fills. An :class:`Entry` names one
such function and its argument types; :func:`lookup` types it once, and
:func:`launch` and :func:`query` call it and raise on an error. Before a
launch a wrapper holds its tensors to :func:`check_operands`, and
:func:`on_cuda` picks between a kernel and its plain version.

Nothing here runs at import time: this module is imported on machines that
have no ``nvcc`` and no GPU.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
import re
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # no FMA contraction: every a*b+c rounds twice, as the plain PyTorch
    # versions' separate kernels do (csrc/lobes.cuh says why that matters)
    "-fmad=false",
    # the assembler's per-kernel report (registers, spills) goes to the log
    "-Xptxas", "-v",
]
SOURCES = ("varpro", "lm", "lobes_eval", "shade", "ne", "joint_ne", "varpro_nd", "lm_step",
           "grid_init", "joint_levmar")
# nvcc's output, and its wall seconds, for each source built by this process
BUILD_LOGS: dict[str, str] = {}
BUILD_SECONDS: dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_nvcc = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cuda_nvcc.exists():
        return str(cuda_nvcc)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = library_path(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))
    return lib.stat().st_mtime < newest


def _compile(name: str) -> None:
    """nvcc for one source into a temporary file beside the library (renamed
    into place on success, so a reader never sees half a file), its output
    and wall seconds noted."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f"lib{name}.", suffix=".so.tmp", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{proc.stdout}")
    BUILD_LOGS[name] = proc.stdout
    BUILD_SECONDS[name] = time.perf_counter() - t0
    os.replace(tmp, library_path(name))


def ptxas_report(log: str) -> list[dict]:
    """``-Xptxas -v`` output → one entry per kernel: its mangled name,
    registers a thread, stack frame and spill bytes."""
    out = []
    entry = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = dict(entry=m.group(1), registers=None, stack_bytes=0,
                         spill_store_bytes=0, spill_load_bytes=0)
            out.append(entry)
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            entry["stack_bytes"], entry["spill_store_bytes"], entry["spill_load_bytes"] = (
                int(x) for x in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m.group(1))
    return out


def sass(lib: Path) -> dict[str, list[tuple[int, str]]]:
    """``cuobjdump -sass`` of a built library (``build(name)``) → its kernels
    by mangled name, each a list of (address, instruction) pairs."""
    cuobjdump = Path(_nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    funcs: dict[str, list[tuple[int, str]]] = {}
    cur = None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2)))
    return funcs


def build(name: str) -> Path:
    """Build ``csrc/<name>.cu`` if its library is missing or stale."""
    if _stale(name):
        _compile(name)
    return library_path(name)


def build_all() -> list[Path]:
    """Build every stale source, one ``nvcc`` process each, in parallel."""
    stale = [name for name in SOURCES if _stale(name)]
    if stale:
        with ThreadPoolExecutor(max_workers=len(stale)) as pool:
            runs = [pool.submit(_compile, name) for name in stale]
        errors = [str(run.exception()) for run in runs if run.exception() is not None]
        if errors:
            raise RuntimeError("\n".join(errors))
    return [library_path(name) for name in SOURCES]


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built at first use."""
    return ctypes.CDLL(str(build(name)))


# the argument types of the C entries
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@dataclasses.dataclass(frozen=True, eq=False)
class Entry:
    """One C function of ``csrc/<source>.cu``: ``kernel`` names it in
    messages, ``symbol`` is its exported name and ``argtypes`` its
    arguments, the stream or the filled int array last. Making one loads
    nothing."""

    kernel: str
    source: str
    symbol: str
    argtypes: tuple


@functools.lru_cache(maxsize=None)
def lookup(entry: Entry):
    """``entry``'s C function with its argument types and its ``cudaError``
    return, its library built and loaded at first use."""
    fn = getattr(load(entry.source), entry.symbol)
    fn.argtypes = entry.argtypes
    fn.restype = ctypes.c_int
    return fn


def check_operands(kernel: str, first: torch.Tensor, *rest: torch.Tensor) -> None:
    """Refuse, naming ``kernel``, operands that are not contiguous float32
    CUDA tensors on the device of the first."""
    for x in (first, *rest):
        if not x.is_cuda or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{kernel} takes contiguous float32 CUDA tensors")
        if x.device != first.device:
            raise ValueError(f"{kernel}'s inputs must lie on one device")


def launch(entry: Entry, device: torch.device, *args) -> None:
    """Call the launch ``entry`` with ``args`` and the current stream of
    ``device``, inside that device; a ``cudaError`` raises ``RuntimeError``
    naming the kernel and its source."""
    fn = lookup(entry)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry.kernel} (csrc/{entry.source}.cu) launch failed with "
                           f"cudaError {err}")


def query(entry: Entry, ints: int, *args) -> list[int]:
    """Call the occupancy query ``entry`` with ``args`` and an array of
    ``ints`` ints, which it fills with the CUDA runtime's figures."""
    res = (ctypes.c_int * ints)()
    err = lookup(entry)(*args, res)
    if err != 0:
        raise RuntimeError(f"{entry.kernel} occupancy query failed with cudaError {err}")
    return list(res)


def on_cuda(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (the kernel runs), False for a CPU tensor (its
    plain version runs); on any other device ``ValueError`` says that
    ``what`` (e.g. "the fused LM solve runs") on cuda or cpu only."""
    if x.is_cuda:
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{what} on cuda or cpu, not {x.device}")
