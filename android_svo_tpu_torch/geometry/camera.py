"""Pinhole camera model as batched tensor functions — port of the
`PinholeCamera` of `android_svo_tpu/geometry/camera.py` (radtan distortion
with the `distortion_free` fast path).  The ATAN model is not ported yet.

Pixel convention: px[..., 0] = u (column), px[..., 1] = v (row), origin at
the centre of the top-left pixel.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


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

    @classmethod
    def create(cls, width, height, fx, fy, cx, cy,
               k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0,
               dtype=torch.float32, device=None) -> "PinholeCamera":
        ks = [float(k) for k in (k1, k2, p1, p2, k3)]

        def scalar(v):
            return torch.tensor(float(v), dtype=dtype, device=device)

        return cls(fx=scalar(fx), fy=scalar(fy), cx=scalar(cx), cy=scalar(cy),
                   dist=torch.tensor(ks, dtype=dtype, device=device),
                   width=int(width), height=int(height),
                   distortion_free=all(k == 0.0 for k in ks))

    def errorMultiplier2(self) -> torch.Tensor:
        return self.fx

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
        uvd = self.distort(uv)
        return torch.stack([self.fx * uvd[..., 0] + self.cx,
                            self.fy * uvd[..., 1] + self.cy], dim=-1)

    def world2cam(self, xyz: torch.Tensor) -> torch.Tensor:
        return self.world2cam_uv(project2d(xyz))

    def cam2world(self, px: torch.Tensor) -> torch.Tensor:
        uvd = torch.stack([(px[..., 0] - self.cx) / self.fx,
                           (px[..., 1] - self.cy) / self.fy], dim=-1)
        xyz = unproject2d(self.undistort(uvd))
        return xyz / torch.linalg.norm(xyz, dim=-1, keepdim=True)
