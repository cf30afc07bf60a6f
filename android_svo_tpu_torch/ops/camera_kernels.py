"""The radtan camera in one launch a call: `camera_cam2world_kernel` and
`camera_world2cam_kernel` (`csrc/camera_kernels.cu`).
`geometry/camera.py::PinholeCamera` dispatches to them on CUDA tensors when
it has distortion and its `use_pallas` is not False (`cfg.use_pallas`,
through `geometry.camera.for_config`), beside its plain code, which stays
the CPU path and the spec.

The kernels replace no Pallas kernel (the JAX package leaves the camera to
XLA).  Their bound is far under the launch floor (~20 bytes and up to ~250
flops a row), so their design is one launch a call: `cam2world` is the
intrinsics, undistort's 8 Newton steps, unproject2d and the norm, which the
host dispatched as ~250 ATen launches; `world2cam_uv` / `world2cam` are
distort and the intrinsics (after project2d), ~45.  Pixels and the unit
plane equal the plain code's on the same CUDA inputs bit for bit; the
bearing's norm may round one ulp apart (the order of its 3-term sum).

Nothing here converts: a float32 input of any leading shape, contiguous,
and the camera's float32 tensors (fx, fy, cx, cy 0-d; dist (5,) = k1, k2,
p1, p2, k3), all on one CUDA device; other types or layouts raise.  Each
call is one output allocation and one launch (none for an empty input),
which adds one to `LAUNCHES`; it reads nothing back to the host.
"""

from __future__ import annotations

import torch

from android_svo_tpu_torch.ops.cuda_build import (check, contiguous, launch,
                                                  stream)

LAUNCHES = {"camera_cam2world_kernel": 0, "camera_world2cam_kernel": 0}

_CAMERA = (("fx", ()), ("fy", ()), ("cx", ()), ("cy", ()), ("dist", (5,)))


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _checked(x, width: int, name: str, camera) -> tuple:
    """Check x (..., width) and the camera, the type, shape and layout
    before the device; return (rows, CUDA device index, the camera's
    pointers)."""
    if not isinstance(x, torch.Tensor) or x.dtype is not torch.float32:
        raise TypeError(f"{name} must be a torch.float32 tensor, got "
                        f"{getattr(x, 'dtype', type(x).__name__)}")
    if x.dim() == 0 or x.shape[-1] != width:
        raise ValueError(f"{name} must have shape (..., {width}), got "
                         f"{tuple(x.shape)}")
    contiguous(x, name)
    if not x.is_cuda:
        raise ValueError(f"{name} is on {x.device}: the kernels run on CUDA "
                         "tensors only")
    dev = x.get_device()
    for t, (cname, shape) in zip(camera, _CAMERA):
        check(t, cname, torch.float32, shape, dev)
    return x.numel() // width, dev, [t.data_ptr() for t in camera]


def cam2world(px, fx, fy, cx, cy, dist):
    """Pixels (..., 2) -> unit bearings (..., 3), as
    `PinholeCamera.cam2world` with distortion."""
    rows, dev, cam = _checked(px, 2, "px", (fx, fy, cx, cy, dist))
    out = torch.empty(px.shape[:-1] + (3,), dtype=torch.float32,
                      device=px.device)
    if rows:
        launch(LAUNCHES, "camera_cam2world_kernel", "launch_camera_cam2world",
               px.data_ptr(), rows, *cam, out.data_ptr(), stream(dev))
    return out


def world2cam(x, fx, fy, cx, cy, dist, project: bool):
    """Points (..., 3) with `project` (`PinholeCamera.world2cam`), else
    unit-plane points (..., 2) (`world2cam_uv`) -> pixels (..., 2), with
    distortion."""
    rows, dev, cam = _checked(x, 3 if project else 2,
                              "xyz" if project else "uv",
                              (fx, fy, cx, cy, dist))
    out = torch.empty(x.shape[:-1] + (2,), dtype=torch.float32,
                      device=x.device)
    if rows:
        launch(LAUNCHES, "camera_world2cam_kernel", "launch_camera_world2cam",
               x.data_ptr(), rows, int(project), *cam, out.data_ptr(),
               stream(dev))
    return out
