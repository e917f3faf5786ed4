# Adapted from brdf_tpu/native.py (the port imports nothing of brdf_tpu).
"""Native (C++) host code, built on demand and loaded with ctypes.

The z-buffered rasterizer core (``csrc/rasterizer.cpp``) is host code, not a
device kernel: it is built with ``g++`` into ``build/native/`` under the
repository root at first use and rebuilt when its source is newer. Loading
gives ``None`` where no toolchain is available; the caller keeps its NumPy
version for that case.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"


def _build_lib(name: str) -> Path | None:
    src = CSRC / f"{name}.cpp"
    out = BUILD_DIR / f"lib{name}.so"
    if out.exists() and out.stat().st_mtime >= src.stat().st_mtime:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # built into a temporary file and renamed, so a reader never sees half a file
    fd, tmp = tempfile.mkstemp(prefix=f"lib{name}.", suffix=".so.tmp", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", str(src), "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, FileNotFoundError):
        os.unlink(tmp)
        return None
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL | None:
    """Load (building if needed) ``csrc/<name>.cpp`` as a shared library."""
    path = _build_lib(name)
    return ctypes.CDLL(str(path)) if path else None


def rasterizer_lib():
    """``rasterize_faces`` of ``csrc/rasterizer.cpp`` with its argument types
    set, or ``None`` without a C++ toolchain."""
    lib = load("rasterizer")
    if lib is None:
        return None
    fn = lib.rasterize_faces
    fn.restype = None
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_double),  # uv
        ctypes.POINTER(ctypes.c_double),  # z
        ctypes.POINTER(ctypes.c_int32),   # faces
        ctypes.c_int64,                   # n_faces
        ctypes.c_int32,                   # width
        ctypes.c_int32,                   # height
        ctypes.POINTER(ctypes.c_int32),   # face_id
        ctypes.POINTER(ctypes.c_float),   # bary
        ctypes.POINTER(ctypes.c_float),   # depth
    ]
    return fn
