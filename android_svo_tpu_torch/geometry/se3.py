"""Batched SE(3)/SO(3) on unit wxyz quaternions — port of
`android_svo_tpu/geometry/se3.py`.

Poses are dataclasses of `(..., 4)` quaternions and `(..., 3)` translations;
every operation broadcasts over leading batch dimensions.  Twist convention
(Sophus): ``xi = (rho, phi)``, translation block first.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.utils._pytree as _pytree

from android_svo_tpu_torch import resolve_device

_EPS2 = 1e-8  # squared-angle threshold below which Taylor branches engage


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def quat_mul(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    pw, px, py, pz = p.unbind(-1)
    qw, qx, qy, qz = q.unbind(-1)
    return torch.stack([
        pw * qw - px * qx - py * qy - pz * qz,
        pw * qx + px * qw + py * qz - pz * qy,
        pw * qy - px * qz + py * qw + pz * qx,
        pw * qz + px * qy - py * qx + pz * qw,
    ], dim=-1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (...,3) by unit quaternions q (...,4)."""
    qvec = q[..., 1:]
    qvec, v = torch.broadcast_tensors(qvec, v)
    uv = _cross(qvec, v)
    uuv = _cross(qvec, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (...,3,3) -> wxyz quaternion, branch-free (Shepperd)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                      1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1)
    qw = torch.sqrt(torch.clamp(qw, min=1e-12)) * 0.5
    q0, q1, q2, q3 = qw.unbind(-1)
    c0 = torch.stack([q0, (m21 - m12) / (4 * q0),
                      (m02 - m20) / (4 * q0), (m10 - m01) / (4 * q0)], -1)
    c1 = torch.stack([(m21 - m12) / (4 * q1), q1,
                      (m01 + m10) / (4 * q1), (m02 + m20) / (4 * q1)], -1)
    c2 = torch.stack([(m02 - m20) / (4 * q2), (m01 + m10) / (4 * q2),
                      q2, (m12 + m21) / (4 * q2)], -1)
    c3 = torch.stack([(m10 - m01) / (4 * q3), (m02 + m20) / (4 * q3),
                      (m12 + m21) / (4 * q3), q3], -1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)             # (...,4,4)
    best = torch.argmax(qw, dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = torch.where(q[..., :1] < 0, -q, q)
    return quat_normalize(q)


def hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix (...,3) -> (...,3,3)."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


class SO3:
    """Stateless helpers for rotation exp/log on quaternions."""

    @staticmethod
    def exp(phi: torch.Tensor) -> torch.Tensor:
        theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)
        theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
        small = theta2 < _EPS2
        half = 0.5 * theta
        k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
        w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
        return quat_normalize(torch.cat([w, k * phi], dim=-1))

    @staticmethod
    def log(q: torch.Tensor) -> torch.Tensor:
        q = torch.where(q[..., :1] < 0, -q, q)
        w = torch.clamp(q[..., :1], -1.0, 1.0)
        vn2 = torch.sum(q[..., 1:] ** 2, dim=-1, keepdim=True)
        vn = torch.sqrt(torch.clamp(vn2, min=1e-24))
        theta = 2.0 * torch.atan2(vn, w)
        small = vn2 < _EPS2
        k = torch.where(small, 2.0 / torch.clamp(w, min=1e-6), theta / vn)
        return k * q[..., 1:]


@dataclass
class SE3:
    """Rigid transform(s): x_out = R @ x + t.  q is a wxyz unit quaternion."""

    q: torch.Tensor  # (..., 4)
    t: torch.Tensor  # (..., 3)

    @classmethod
    def identity(cls, batch_shape=(), dtype=torch.float32,
                 device=None) -> "SE3":
        q = torch.tensor([1.0, 0, 0, 0], dtype=dtype, device=device)
        q = q.expand(tuple(batch_shape) + (4,)).clone()
        t = torch.zeros(tuple(batch_shape) + (3,), dtype=dtype, device=device)
        return cls(q=q, t=t)

    @classmethod
    def from_matrix(cls, m, device=None) -> "SE3":
        """(...,4,4) or (...,3,4) homogeneous matrix -> SE3 (ref
        SE3.h:81-99).  A tensor stays where it is; an array goes to
        `device` (the card unless the caller asks for the CPU)."""
        if not isinstance(m, torch.Tensor):
            m = torch.tensor(np.asarray(m), device=resolve_device(device))
        return cls(q=matrix_to_quat(m[..., :3, :3]), t=m[..., :3, 3])

    @classmethod
    def from_rt(cls, rot: torch.Tensor, t: torch.Tensor) -> "SE3":
        return cls(q=matrix_to_quat(rot), t=t)

    @property
    def batch_shape(self):
        return self.q.shape[:-1]

    def rotation_matrix(self) -> torch.Tensor:
        return quat_to_matrix(self.q)

    def as_matrix(self) -> torch.Tensor:
        """(...,4,4) homogeneous matrix (ref SE3.h getMatrix)."""
        top = torch.cat([self.rotation_matrix(), self.t[..., :, None]], dim=-1)
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=self.t.dtype,
                              device=self.t.device)
        return torch.cat([top, bottom.expand(top.shape[:-2] + (1, 4))],
                         dim=-2)

    def compose(self, other: "SE3") -> "SE3":
        """self @ other (apply other first)."""
        return SE3(q=quat_normalize(quat_mul(self.q, other.q)),
                   t=quat_rotate(self.q, other.t) + self.t)

    def __matmul__(self, other):
        if isinstance(other, SE3):
            return self.compose(other)
        return self.apply(other)

    def inverse(self) -> "SE3":
        qi = quat_conj(self.q)
        return SE3(q=qi, t=-quat_rotate(qi, self.t))

    def apply(self, pts: torch.Tensor) -> torch.Tensor:
        return quat_rotate(self.q, pts) + self.t

    def rotate(self, v: torch.Tensor) -> torch.Tensor:
        return quat_rotate(self.q, v)

    @classmethod
    def exp(cls, xi: torch.Tensor) -> "SE3":
        rho, phi = xi[..., :3], xi[..., 3:]
        q = SO3.exp(phi)
        theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)
        theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
        small = theta2 < _EPS2
        a = torch.where(small, 0.5 - theta2 / 24.0,
                        (1.0 - torch.cos(theta)) / theta2)
        b = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                        (theta - torch.sin(theta)) / (theta2 * theta))
        cross1 = _cross(phi, rho)
        cross2 = _cross(phi, cross1)
        return cls(q=q, t=rho + a * cross1 + b * cross2)

    def log(self) -> torch.Tensor:
        phi = SO3.log(self.q)
        theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)
        theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
        small = theta2 < _EPS2
        half_t = 0.5 * theta
        cot = torch.where(
            small, 1.0 / 12.0 + theta2 / 720.0,
            (1.0 / theta2)
            - 0.5 * torch.cos(half_t) / (theta * torch.sin(half_t) + 1e-24))
        cross1 = _cross(phi, self.t)
        cross2 = _cross(phi, cross1)
        rho = self.t - 0.5 * cross1 + cot * cross2
        return torch.cat([rho, phi], dim=-1)

    def normalize(self) -> "SE3":
        return SE3(q=quat_normalize(self.q), t=self.t)

    def __getitem__(self, idx) -> "SE3":
        return SE3(q=self.q[idx], t=self.t[idx])


def distance(a: SE3, b: SE3):
    """(translation distance, rotation angle) between two poses."""
    rel = a.inverse().compose(b)
    return (torch.linalg.norm(rel.t, dim=-1),
            torch.linalg.norm(SO3.log(rel.q), dim=-1))


# a pytree node, so poses pass through torch.func.vmap as (q, t)
_pytree.register_pytree_node(
    SE3, lambda T: ([T.q, T.t], None),
    lambda children, _: SE3(q=children[0], t=children[1]))

