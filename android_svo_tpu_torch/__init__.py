"""android_svo_tpu_torch — the PyTorch/CUDA port of the semi-direct visual
odometry engine in `android_svo_tpu`.

Same layout and function names as the JAX package (geometry/, ops/, core/,
data/, evals/), written as plain functions on tensors with dataclasses of
tensors for state.  The four patch kernels of the tracking path are CUDA C++
for Hopper (`csrc/patch_kernels.cu`, built with nvcc on first CUDA use and
bound with ctypes); each has a plain PyTorch version beside it in
`ops/patch_kernels.py` that serves CPU tensors.

Entry points (FrameHandler, make_track_frame, init_state, the renderer) run
on the CUDA device unless the caller passes `device="cpu"`.
"""

from __future__ import annotations

import torch

# The Hessian einsums of sparse alignment and the ICLK normal equations need
# full fp32: TF32 keeps ~3 decimal digits and costs convergences.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless `device` says
    otherwise.  Raises when CUDA is asked for (explicitly or by default) and
    no card is present — there is no silent fallback to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "android_svo_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run the plain versions on "
            "the CPU")
    return dev
