"""Camera models as batched tensor functions — port of
`android_svo_tpu/geometry/camera.py`: `PinholeCamera` (radtan distortion
with the `distortion_free` fast path) and `ATANCamera` (the FOV model).

On CUDA tensors a `PinholeCamera` with distortion computes `cam2world`,
`world2cam_uv` and `world2cam` in one launch each
(`ops/camera_kernels.py`): the kernels give the plain code's pixels and
unit plane bit for bit.  There is no fallback.  The camera's `use_pallas`
is the dispatch argument every kernel takes (`ops/cuda_build.on_card`);
`for_config` sets it from `cfg.use_pallas`, and the tracking entry points
(`FrameHandler`, `make_track_frame`, `make_batched_track`) hold their
camera so, which makes a run with the knob off plain throughout.  Under
`torch.func.vmap` a call is the op `svo_torch::camera_cam2world` or
`svo_torch::camera_world2cam`, whose vmap rule makes the batch one launch.
On CPU tensors, without distortion and with `use_pallas` False, the plain
code below runs: it is the spec the kernels answer to.  The kernels take
float32 alone, with the camera's tensors on the points' device: a
distorted camera in another dtype, or with its tensors on another device
than CUDA points, raises on the card.

Pixel convention: px[..., 0] = u (column), px[..., 1] = v (row), origin at
the centre of the top-left pixel.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from android_svo_tpu_torch.ops import camera_kernels
from android_svo_tpu_torch.ops.cuda_build import (batch_first, call_op,
                                                  cfg_use_pallas, on_card)


def project2d(xyz: torch.Tensor) -> torch.Tensor:
    """3D -> unit-plane 2D."""
    return xyz[..., :2] / xyz[..., 2:3]


def unproject2d(uv: torch.Tensor) -> torch.Tensor:
    """Unit-plane 2D -> homogeneous 3D with z=1."""
    return torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)


@dataclass
class PinholeCamera:
    """Pinhole + radtan(k1,k2,p1,p2,k3).  Build with `create`, the only place
    `distortion_free` is derived."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    dist: torch.Tensor                      # (5,) = k1,k2,p1,p2,k3
    width: int = 752
    height: int = 480
    distortion_free: bool = False
    use_pallas: bool | None = None          # the kernels' dispatch argument

    @classmethod
    def create(cls, width, height, fx, fy, cx, cy,
               k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0,
               dtype=torch.float32, device=None) -> "PinholeCamera":
        """A camera of `dtype` on `device`.  With distortion, calls on CUDA
        points launch the radtan kernels, which take float32 alone, on the
        camera's device: build such a camera as float32 on that device."""
        ks = [float(k) for k in (k1, k2, p1, p2, k3)]

        def scalar(v):
            return torch.tensor(float(v), dtype=dtype, device=device)

        return cls(fx=scalar(fx), fy=scalar(fy), cx=scalar(cx), cy=scalar(cy),
                   dist=torch.tensor(ks, dtype=dtype, device=device),
                   width=int(width), height=int(height),
                   distortion_free=all(k == 0.0 for k in ks))

    @property
    def has_distortion(self) -> bool:
        return not self.distortion_free

    def errorMultiplier2(self) -> torch.Tensor:
        return self.fx

    def _on_card(self, x: torch.Tensor) -> bool:
        """Whether a call on x launches the radtan kernels."""
        return not self.distortion_free and on_card(x, self.use_pallas)

    def _params(self) -> tuple:
        return self.fx, self.fy, self.cx, self.cy, self.dist

    def distort(self, uv: torch.Tensor) -> torch.Tensor:
        if self.distortion_free:
            return uv
        k1, k2, p1, p2, k3 = self.dist.unbind(0)
        x, y = uv[..., 0], uv[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        xy = x * y
        xd = x * radial + 2.0 * p1 * xy + p2 * (r2 + 2.0 * x * x)
        yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * xy
        return torch.stack([xd, yd], dim=-1)

    def undistort(self, uvd: torch.Tensor, n_iter: int = 8) -> torch.Tensor:
        if self.distortion_free:
            return uvd
        k1, k2, p1, p2, k3 = self.dist.unbind(0)
        xd, yd = uvd[..., 0], uvd[..., 1]
        x, y = xd, yd
        for _ in range(n_iter):
            r2 = x * x + y * y
            radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
            dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
            dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
            x = (xd - dx) / radial
            y = (yd - dy) / radial
        return torch.stack([x, y], dim=-1)

    def world2cam_uv(self, uv: torch.Tensor) -> torch.Tensor:
        if self._on_card(uv):
            return call_op(_world2cam_op, _world2cam_body, uv,
                           *self._params(), False)
        return self.world2cam_uv_plain(uv)

    def world2cam(self, xyz: torch.Tensor) -> torch.Tensor:
        if self._on_card(xyz):
            return call_op(_world2cam_op, _world2cam_body, xyz,
                           *self._params(), True)
        return self.world2cam_plain(xyz)

    def cam2world(self, px: torch.Tensor) -> torch.Tensor:
        if self._on_card(px):
            return call_op(_cam2world_op, _cam2world_body, px,
                           *self._params())
        return self.cam2world_plain(px)

    # the plain versions: the CPU path, and the spec of the radtan kernels

    def world2cam_uv_plain(self, uv: torch.Tensor) -> torch.Tensor:
        uvd = self.distort(uv)
        return torch.stack([self.fx * uvd[..., 0] + self.cx,
                            self.fy * uvd[..., 1] + self.cy], dim=-1)

    def world2cam_plain(self, xyz: torch.Tensor) -> torch.Tensor:
        return self.world2cam_uv_plain(project2d(xyz))

    def cam2world_plain(self, px: torch.Tensor) -> torch.Tensor:
        uvd = torch.stack([(px[..., 0] - self.cx) / self.fx,
                           (px[..., 1] - self.cy) / self.fy], dim=-1)
        xyz = unproject2d(self.undistort(uvd))
        return xyz / torch.linalg.norm(xyz, dim=-1, keepdim=True)

    def is_in_frame(self, px: torch.Tensor, boundary: float = 0.0,
                    level: int = 0) -> torch.Tensor:
        """Pixel inside the image at pyramid `level`, `boundary` px in (ref
        abstract_camera.h isInFrame)."""
        return _in_frame(px, self.width, self.height, boundary, level)


def for_config(cam, cfg):
    """`cam` as `cfg.use_pallas` has it: with the knob off, a
    `PinholeCamera` runs its plain versions on CUDA tensors too.  Another
    camera is returned as it is."""
    if isinstance(cam, PinholeCamera):
        return dataclasses.replace(cam, use_pallas=cfg_use_pallas(cfg))
    return cam


# The radtan kernels as ops (`PinholeCamera` sends them CUDA tensors only).

def _cam2world_body(px, fx, fy, cx, cy, dist):
    return camera_kernels.cam2world(px.contiguous(), fx, fy, cx, cy, dist)


def _world2cam_body(x, fx, fy, cx, cy, dist, project):
    return camera_kernels.world2cam(x.contiguous(), fx, fy, cx, cy, dist,
                                    project)


def _vmap_rule(body):
    """The batch as one call of `body`: the rows are independent, so the
    points with their batch dimension first are just more rows.  The
    camera is the batch's one camera."""
    def rule(info, in_dims, x, *rest):
        if any(d is not None for d in in_dims[1:]):
            raise NotImplementedError("the radtan kernels take one camera "
                                      "for the whole batch")
        return body(batch_first(x, in_dims[0], info.batch_size), *rest), 0
    return rule


_CAMERA_SCHEMA = "Tensor fx, Tensor fy, Tensor cx, Tensor cy, Tensor dist"
_cam2world_op = torch.library.custom_op(
    "svo_torch::camera_cam2world", _cam2world_body, mutates_args=(),
    schema=f"(Tensor px, {_CAMERA_SCHEMA}) -> Tensor")
_cam2world_op.register_vmap(_vmap_rule(_cam2world_body))
_world2cam_op = torch.library.custom_op(
    "svo_torch::camera_world2cam", _world2cam_body, mutates_args=(),
    schema=f"(Tensor x, {_CAMERA_SCHEMA}, bool project) -> Tensor")
_world2cam_op.register_vmap(_vmap_rule(_world2cam_body))


def _in_frame(px, width: int, height: int, boundary: float, level: int):
    scale = float(2 ** level)
    w = width / scale
    h = height / scale
    return ((px[..., 0] >= boundary) & (px[..., 0] < w - boundary)
            & (px[..., 1] >= boundary) & (px[..., 1] < h - boundary))


@dataclass
class ATANCamera:
    """FOV/ATAN model: rd = atan(2 r tan(s/2)) / s on the unit plane.
    Intrinsics are in pixels."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    s: torch.Tensor                         # FOV distortion parameter omega
    width: int = 752
    height: int = 480

    @classmethod
    def create(cls, width, height, fx, fy, cx, cy, s,
               dtype=torch.float32, device=None) -> "ATANCamera":
        def scalar(v):
            return torch.tensor(float(v), dtype=dtype, device=device)

        return cls(fx=scalar(fx), fy=scalar(fy), cx=scalar(cx), cy=scalar(cy),
                   s=scalar(s), width=int(width), height=int(height))

    def errorMultiplier2(self) -> torch.Tensor:
        return self.fx

    def _rd_factor(self, r: torch.Tensor) -> torch.Tensor:
        """rd / r, with its limit below r = 1e-6."""
        two_tan_half = 2.0 * torch.tan(self.s / 2.0)
        small = r < 1e-6
        rs = torch.where(small, torch.full_like(r, 1e-6), r)
        return torch.where(small, two_tan_half / self.s,
                           torch.atan(rs * two_tan_half) / (rs * self.s))

    def _ru_factor(self, rd: torch.Tensor) -> torch.Tensor:
        """r / rd (the inverse distortion), with its limit below 1e-6."""
        two_tan_half = 2.0 * torch.tan(self.s / 2.0)
        small = rd < 1e-6
        rds = torch.where(small, torch.full_like(rd, 1e-6), rd)
        return torch.where(small, self.s / two_tan_half,
                           torch.tan(rds * self.s) / (rds * two_tan_half))

    def world2cam_uv(self, uv: torch.Tensor) -> torch.Tensor:
        uvd = uv * self._rd_factor(torch.linalg.norm(uv, dim=-1))[..., None]
        return torch.stack([self.fx * uvd[..., 0] + self.cx,
                            self.fy * uvd[..., 1] + self.cy], dim=-1)

    def world2cam(self, xyz: torch.Tensor) -> torch.Tensor:
        return self.world2cam_uv(project2d(xyz))

    def cam2world(self, px: torch.Tensor) -> torch.Tensor:
        uvd = torch.stack([(px[..., 0] - self.cx) / self.fx,
                           (px[..., 1] - self.cy) / self.fy], dim=-1)
        rd = torch.linalg.norm(uvd, dim=-1)
        xyz = unproject2d(uvd * self._ru_factor(rd)[..., None])
        return xyz / torch.linalg.norm(xyz, dim=-1, keepdim=True)

    def is_in_frame(self, px: torch.Tensor, boundary: float = 0.0,
                    level: int = 0) -> torch.Tensor:
        """Pixel inside the image at pyramid `level`, `boundary` px in."""
        return _in_frame(px, self.width, self.height, boundary, level)
