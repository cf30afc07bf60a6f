"""Sparse image alignment's Gauss-Newton (or Levenberg-Marquardt) loop in
one launch: `sparse_align_kernel` (`csrc/pose_kernels.cu`).
`ops/sparse_align.py::sparse_img_align` dispatches to it on CUDA tensors,
beside its plain loop, which stays the CPU path and the spec.

The kernel replaces no Pallas kernel.  It takes every iteration of every
level (the pose applied to the reference points, the camera's projection,
the bounds test, the current patches' bilinear taps, the residuals and the
normal equations, the 6x6 solve, the exponential, the best-so-far registers
and the stop test) off the host, which dispatched some 360 ATen launches
and one blocking read an iteration for it: one block per frame, one launch
for a frame or for a batch.  Each level's reference side (the reference
points' validity and the sampler's patches and gradients) is made before
the launch and passed in.

Nothing here converts: a float32 (L, Hp, Wp) stack (any strides with
contiguous rows; a batch's may be one shared stack), float32 points, pose
and camera tensors, and per level a bool validity and float32 patch, gx
and gy of (n, area), all on one CUDA device, each contiguous within a
frame; other types or layouts raise.
`sparse_align_gn` is one frame, `sparse_align_gn_batched` a batch (the
stack (B, L, Hp, Wp) and each row operand with a leading batch dimension
read at its stride; the camera shared; B blocks).  Each block sums in an
order that does not depend on B, so the batched launch gives each frame's
single launch bit for bit.  Either is the five output allocations and one
launch, which adds one to `LAUNCHES`; neither writes an input or reads
anything back to the host.
"""

from __future__ import annotations

import ctypes

import torch

from android_svo_tpu_torch.ops.cuda_build import (check, frame_contiguous,
                                                  launch, stream)
from android_svo_tpu_torch.ops.patch_kernels import _stack_args

LAUNCHES = {"sparse_align_kernel": 0}

MAX_LEVELS = 8                 # the kernel's kMaxLevels
CAMERA_KINDS = {"pinhole": 0, "radtan": 1, "atan": 2}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def camera_args(cam):
    """(kind, fx, fy, cx, cy, params) of a camera: a `PinholeCamera` with
    or without distortion (its radtan coefficients) or an `ATANCamera`
    (its s)."""
    if hasattr(cam, "s"):
        return CAMERA_KINDS["atan"], cam.fx, cam.fy, cam.cx, cam.cy, cam.s
    kind = "pinhole" if cam.distortion_free else "radtan"
    return CAMERA_KINDS[kind], cam.fx, cam.fy, cam.cx, cam.cy, cam.dist


def _operand(t, name, dtype, shape, lead, dev):
    """Check t and return (pointer, batch stride)."""
    check(t, name, dtype, lead + shape, dev)
    if not frame_contiguous(t, len(lead)):
        raise ValueError(f"{name} must be contiguous within a frame")
    return t.data_ptr(), t.stride()[0] if lead else 0


def _launch(stack, xyz, q0, t0, cam, levels, half: int, n_iter: int,
            eps: float, lm: bool, batch: int | None):
    """Checks, the output allocations and the one launch.  `levels` holds
    (level, rows, cols, ok, patch, gx, gy) for each level, coarse to fine:
    the plane of the stack, the clamps of its substack and the reference
    side."""
    n = xyz.shape[-2]
    dev = xyz.get_device()
    lead = () if batch is None else (batch,)
    area = (2 * half) ** 2
    if not 1 <= half <= 4:
        raise ValueError(f"half must be 1 to 4, got {half}")
    if n_iter < 0:
        raise ValueError(f"n_iter must be >= 0, got {n_iter}")
    if len(levels) > MAX_LEVELS:
        raise ValueError(f"at most {MAX_LEVELS} levels, got {len(levels)}")
    if stack.dim() != 3 and (batch is None or stack.shape[0] != batch):
        raise ValueError(f"stack {tuple(stack.shape)} is not one frame's "
                         "(L, Hp, Wp) or the batch's (B, L, Hp, Wp)")
    s_ptr, s_b, s_l, s_r, n_planes = _stack_args(stack)[:5]
    if stack.get_device() != dev:
        raise ValueError(f"stack is on {stack.device}, the kernel's other "
                         f"inputs on CUDA device {dev}")
    x_ptr, s_x = _operand(xyz, "xyz_ref", torch.float32, (n, 3), lead, dev)
    q_ptr, s_q = _operand(q0, "q", torch.float32, (4,), lead, dev)
    t_ptr, s_t = _operand(t0, "t", torch.float32, (3,), lead, dev)
    kind, *cam_t = camera_args(cam)
    for name, c in zip(("fx", "fy", "cx", "cy"), cam_t):
        check(c, name, torch.float32, (), dev)
    params = cam_t[4]
    check(params, "camera parameters", torch.float32,
          () if kind == CAMERA_KINDS["atan"] else (5,), dev)
    record = []
    for level, rows, cols, ok, patch, gx, gy in levels:
        if not 0 <= level < n_planes:
            raise ValueError(f"level {level} is not a plane of the "
                             f"{n_planes}-level stack")
        record += [level, rows, cols,
                   *_operand(ok, "ok_ref", torch.bool, (n,), lead, dev),
                   *_operand(patch, "patch_ref", torch.float32, (n, area),
                             lead, dev),
                   *_operand(gx, "gx", torch.float32, (n, area), lead, dev),
                   *_operand(gy, "gy", torch.float32, (n, area), lead, dev)]
    device = xyz.device
    q = torch.empty(lead + (4,), dtype=torch.float32, device=device)
    t = torch.empty(lead + (3,), dtype=torch.float32, device=device)
    n_tracked = torch.empty(lead, dtype=torch.int32, device=device)
    chi2 = torch.empty(lead, dtype=torch.float32, device=device)
    iters = torch.empty(lead + (len(levels),), dtype=torch.int32,
                        device=device)
    launch(LAUNCHES, "sparse_align_kernel", "launch_sparse_align", s_ptr, s_b,
           s_l, s_r, x_ptr, s_x, q_ptr, s_q, t_ptr, s_t,
           *(c.data_ptr() for c in cam_t), kind, cam.width, cam.height,
           (ctypes.c_longlong * max(len(record), 1))(*record), len(levels),
           1 if batch is None else batch, n, half, int(n_iter), float(eps),
           int(lm), q.data_ptr(), t.data_ptr(), n_tracked.data_ptr(),
           chi2.data_ptr(), iters.data_ptr(), stream(dev))
    return q, t, n_tracked, chi2, iters


def sparse_align_gn(stack, xyz, q0, t0, cam, levels, half: int, n_iter: int,
                    eps: float, lm: bool):
    """Align one frame: the current frame's stack (L, Hp, Wp), the
    reference points xyz (n, 3), the start (q0, t0) and, per level coarse to
    fine, (level, rows, cols, ok, patch, gx, gy).  Returns (q, t, n_tracked
    int32, chi2, iters (levels,) int32): the result, the rows usable at it
    on the last level, its chi2 there, and each level's iterations."""
    return _launch(stack, xyz, q0, t0, cam, levels, half, n_iter, eps, lm,
                   None)


def sparse_align_gn_batched(stack, xyz, q0, t0, cam, levels, half: int,
                            n_iter: int, eps: float, lm: bool):
    """sparse_align_gn for a batch: the stack (B, L, Hp, Wp) and every row
    operand with a leading batch dimension B, the camera shared; one launch
    of B blocks, each frame's loop stopping where its own stops."""
    return _launch(stack, xyz, q0, t0, cam, levels, half, n_iter, eps, lm,
                   xyz.shape[0])
