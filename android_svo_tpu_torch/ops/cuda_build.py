"""Build, bind and launch the port's CUDA kernels (every `csrc/*.cu`).

Each source has a plain C interface.  All of them are compiled with nvcc for
sm_90a, one nvcc per source started together, and linked into one shared
library under `build/torch_kernels/` at the repository root (a directory
`.gitignore` lists) the first time a kernel is launched on a CUDA tensor; the
library is loaded with ctypes.  Its file name carries a hash of every
source's name and bytes and of the flags, so an edited source is rebuilt.
Nothing here runs at import time.

The launch plumbing every wrapper shares (`ops/patch_kernels.py`,
`ops/gather_probe.py`, `ops/pose_gn.py`, `ops/point_gn.py`,
`ops/sparse_align_gn.py`, `ops/camera_kernels.py`) is here too: `check`,
`contiguous` and `frame_contiguous` test an input against what the kernel
takes (the wrappers convert nothing), `stream` is the current raw stream,
and `launch` calls a launcher, raises on its cudaError_t and adds one to
the wrapper module's launch count.  So is the dispatch every custom op
shares (`ops/patch_kernels.py`, `core/pose_opt.py`, `core/point_opt.py`,
`geometry/camera.py`): `cfg_use_pallas` and `use_kernels` read the knob,
`on_card` decides kernel or plain version, `call_op` calls an op's body
directly outside a `torch.func` transform, and `batch_first` moves a vmap
rule's argument's batch dimension first.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from android_svo_tpu_torch.utils import profiling

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
build_info: dict = {}      # seconds, path and ptxas report of the last build

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "launch_sample_patches": [_P, _LL, _LL, _LL, _I, _I, _I, _P, _P, _LL,
                              _LL, _P, _I, _I, _I, _I, _P, _P],
    "launch_epi_scan": [_P, _LL, _LL, _LL, _I, _I, _I, _I, _I, _I, _P, _P,
                        _LL, _LL, _P, _LL, _LL, _P, _P, _LL, _LL, _I, _I, _I,
                        _P, _P, _P],
    "launch_align_iclk": [_P, _LL, _LL, _LL, _I, _I, _I, _I, _I, _I, _P, _P,
                          _LL, _LL, _P, _LL, _LL, _P, _LL, _LL, _P, _LL, _LL,
                          _P, _I, _I, _I, _P, _P, _P, _P],
    "launch_align_iclk_window": [_P, _LL, _LL, _LL, _I, _I, _I, _I, _I, _I,
                                 _P, _P, _LL, _LL, _P, _LL, _LL, _P, _LL,
                                 _LL, _P, _LL, _LL, _P, _I, _I, _I, _I, _F,
                                 _I, _F, _P, _P, _P, _P],
    "launch_dump_windows": [_P, _LL, _LL, _LL, _I, _I, _I, _P, _P, _LL,
                            _LL, _P, _I, _I, _P, _P, _P],
    "launch_probe_patches": [_P, _I, _I, _P, _I, _I, _P, _P],
    "launch_pose_gn": [_P, _LL, _P, _LL, _P, _LL, _P, _LL, _P, _LL, _P, _LL,
                       _P, _LL, _I, _I, _I, _F, _I, _P, _P, _P, _P, _P, _P,
                       _P, _P],
    "launch_point_gn": [_P, _LL] * 10 + [_I] * 7 + [_P, _P, _P],
    "launch_sparse_align": [_P, _LL, _LL, _LL, _P, _LL, _P, _LL, _P, _LL, _P,
                            _P, _P, _P, _P, _I, _I, _I, _P, _I, _I, _I, _I,
                            _I, _F, _I, _P, _P, _P, _P, _P, _P],
    "launch_camera_cam2world": [_P, _LL, _P, _P, _P, _P, _P, _P, _P],
    "launch_camera_world2cam": [_P, _LL, _I, _P, _P, _P, _P, _P, _P, _P],
}
# queries a source may define beside its launchers (each returns a
# cudaError_t): the ICLK layout and its residency on the card
_QUERIES = {"iclk_residency": [_I, _I, _I, _P]}


def bind(lib, names) -> None:
    """Give `lib`'s functions `names` their ctypes signatures (launchers
    and queries), each returning an int."""
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = _SIGNATURES.get(name) or _QUERIES[name]
        fn.restype = ctypes.c_int


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source and need the CUDA toolkit")


def _digest(srcs) -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in srcs:
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return h.hexdigest()[:12]


def build(force: bool = False) -> Path:
    """Compile the kernels (if the library for these sources is not built
    yet) and return the library's path."""
    srcs = sources()
    so = BUILD_DIR / f"libtorch_kernels_{_digest(srcs)}.so"
    if so.exists() and not force:
        build_info.setdefault("path", str(so))
        build_info.setdefault("seconds", 0.0)
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in srcs]
    tmp = so.with_name(f"{tag}.tmp.so")
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(srcs, objs)]
        reports = [(src, proc.communicate()[0], proc.returncode)
                   for src, proc in zip(srcs, procs)]
        failed = [f"{src.name} ({rc}):\n{out}"
                  for src, out, rc in reports if rc]
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
        os.replace(tmp, so)
    finally:
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)
    build_info.update(path=str(so), seconds=time.perf_counter() - t0,
                      ptxas="\n".join(out.strip() for _, out, _ in reports))
    return so


def library():
    """The loaded kernel library (built on first use; the sources' digest
    and the load, or the compile, are span `build.cuda_kernels`)."""
    global _lib
    if _lib is None:
        with profiling.span("build.cuda_kernels"):
            lib = ctypes.CDLL(str(build()))
            bind(lib, [*_SIGNATURES, *_QUERIES])
        _lib = lib
    return _lib


def cfg_use_pallas(cfg) -> bool | None:
    """Map the config knob to the dispatch argument, as the JAX package
    does: True by config is "auto" (None: the kernels for CUDA tensors, the
    plain versions for CPU tensors), False forces the plain versions."""
    return None if cfg.use_pallas else False


def use_kernels(use_pallas) -> bool:
    """The dispatch argument with None ("auto") read as True: the tensors'
    device then decides."""
    return True if use_pallas is None else bool(use_pallas)


def on_card(t: torch.Tensor, use_pallas) -> bool:
    """Whether a call on t launches its kernel (else the plain version)."""
    return use_kernels(use_pallas) and t.is_cuda


def call_op(op, body, *args):
    """A custom op inside a `torch.func` transform, where the op's vmap
    rule batches the call; outside one, the op's body itself, which spares
    the single path the dispatcher's per-call cost."""
    if torch._C._functorch.maybe_current_level() is None:
        return body(*args)
    return op(*args)


def batch_first(x, d, B: int):
    """A vmap rule's argument with its batch dimension first (an unbatched
    one expanded to the batch, which costs no copy)."""
    if x is None:
        return None
    if d is None:
        return x.expand((B,) + tuple(x.shape))
    return x.movedim(d, 0)


def stream(device: int) -> int:
    """The current stream's cudaStream_t on CUDA device index `device` (a C
    call, no Python stream object)."""
    return torch._C._cuda_getCurrentRawStream(device)


def check(t, name: str, dtype, shape, device: int) -> None:
    """Raise unless t is a `dtype` tensor of `shape` on CUDA device index
    `device`: the wrappers convert nothing.  (The common case is three
    attribute reads; the message is built only on failure.)"""
    try:
        if (t.dtype is dtype and t.shape == shape
                and t.get_device() == device):
            return
        got = t.dtype
    except AttributeError:
        got = type(t).__name__
    if got is not dtype:
        raise TypeError(f"{name} must be a {dtype} tensor, got {got}")
    if t.shape != shape:
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    raise ValueError(f"{name} is on {t.device}, the kernel's other inputs "
                     f"on CUDA device {device}")


def frame_contiguous(t: torch.Tensor, lead: int) -> bool:
    """Whether t is contiguous after its first `lead` dimensions (a
    dimension of size 1 may have any stride)."""
    expect = 1
    for size, stride in zip(reversed(t.shape[lead:]),
                            reversed(t.stride()[lead:])):
        if size != 1 and stride != expect:
            return False
        expect *= size
    return True


def contiguous(t, name: str) -> None:
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch(counts: dict, name: str, fn_name: str, *args) -> None:
    """Call launcher `fn_name`; raise if the launch was refused, else add
    one to `counts[name]`."""
    rc = getattr(library(), fn_name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with cudaError_t {rc}")
    counts[name] += 1
