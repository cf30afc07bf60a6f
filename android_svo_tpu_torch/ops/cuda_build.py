"""Build and bind the CUDA patch kernels (`csrc/patch_kernels.cu`).

The source has a plain C interface; it is compiled with nvcc for sm_90a into
a shared library under `build/torch_kernels/` at the repository root (a
directory `.gitignore` lists) the first time a kernel is launched on a CUDA
tensor, and loaded with ctypes.  The library's file name carries a hash of
the source and flags, so an edited source is rebuilt.  Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent.parent / "csrc" / "patch_kernels.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
build_info: dict = {}      # seconds, path and ptxas report of the last build

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_SIGNATURES = {
    "launch_sample_patches": [_P, _LL, _LL, _I, _I, _I, _P, _P, _P, _I, _I,
                              _I, _P, _P, _P, _P],
    "launch_epi_scan": [_P, _LL, _LL, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                        _I, _I, _I, _P, _P, _P],
    "launch_align_iclk": [_P, _LL, _LL, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                          _P, _P, _P, _I, _I, _I, _P, _P, _P, _P],
    "launch_align_iclk_window": [_P, _LL, _LL, _I, _I, _I, _I, _I, _P, _P,
                                 _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P,
                                 _P, _P, _P, _P],
}


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: the CUDA patch kernels are built "
                       "from source and need the CUDA toolkit")


def build(force: bool = False) -> Path:
    """Compile the kernels (if the library for this source is not built
    yet) and return the library's path."""
    src = SRC.read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    so = BUILD_DIR / f"libpatch_kernels_{digest[:12]}.so"
    if so.exists() and not force:
        build_info.setdefault("path", str(so))
        build_info.setdefault("seconds", 0.0)
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SRC)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)
    build_info.update(path=str(so), seconds=seconds,
                      ptxas=(proc.stdout + proc.stderr).strip())
    return so


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
