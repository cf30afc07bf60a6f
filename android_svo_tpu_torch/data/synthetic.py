"""Synthetic textured-plane scene with exact ground truth — port of
`android_svo_tpu/data/synthetic.py` (texture noise from a `torch.Generator`,
so it differs from the JAX texture of the same seed; `render` of a given
texture and pose is the same function).

World: a textured plane at z = 0, the camera above it at negative z looking
along +z.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from android_svo_tpu_torch import resolve_device
from android_svo_tpu_torch.geometry.camera import PinholeCamera
from android_svo_tpu_torch.geometry.se3 import SE3, SO3
from android_svo_tpu_torch.ops.interp import bilinear_sample


def make_texture(generator: torch.Generator, size: int = 1024,
                 octaves: int | None = None, device=None) -> torch.Tensor:
    """Multi-octave value-noise texture in [0, 255], (size, size) f32, with
    a quantized copy mixed in for sharp corners.  The noise is drawn on the
    generator's device and the texture is built on `device`."""
    dev = resolve_device(device)
    if octaves is None:
        octaves = max(int(math.log2(size // 4)) + 1, 5)
    img = torch.zeros((size, size), dtype=torch.float32, device=dev)
    amp = 1.0
    for o in range(octaves):
        res = min(4 * (2 ** o), size)
        noise = torch.rand((res, res), generator=generator,
                           dtype=torch.float32).to(dev)
        up = F.interpolate(noise[None, None], size=(size, size),
                           mode="bilinear", align_corners=False)[0, 0]
        img = img + amp * up
        amp *= 0.75
    img = img - img.min()
    img = img / img.max()
    bands = torch.floor(img * 8.0) / 7.0
    mixed = 0.65 * bands + 0.35 * img
    mixed = mixed - mixed.min()
    mixed = mixed / mixed.max()
    return mixed * 255.0


def default_camera(width: int = 640, height: int = 480,
                   device=None) -> PinholeCamera:
    return PinholeCamera.create(width, height, 420.0, 420.0,
                                width / 2.0 - 0.5, height / 2.0 - 0.5,
                                device=resolve_device(device))


def render(texture: torch.Tensor, cam: PinholeCamera, T_w_c: SE3,
           tex_scale: float = 100.0) -> torch.Tensor:
    """Render the plane z=0 seen from camera pose T_w_c (camera-to-world);
    tex_scale is texture pixels per world unit, texture centred on the
    origin.  Runs on the texture's device."""
    h, w = cam.height, cam.width
    dev = texture.device
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    px = torch.stack([xx, yy], dim=-1).reshape(-1, 2)
    f_cam = cam.cam2world(px)
    d_w = T_w_c.rotate(f_cam)
    o_w = T_w_c.t
    tz = -o_w[2] / d_w[..., 2]
    p_w = o_w + tz[..., None] * d_w
    ts = texture.shape[0]
    uv = p_w[..., :2] * tex_scale + ts / 2.0
    return bilinear_sample(texture, uv).reshape(h, w)


def lookdown_pose(x: float, y: float, z: float = -3.0,
                  rot_xyz=(0.0, 0.0, 0.0), device=None) -> SE3:
    """Camera at (x, y, z<0) looking along +z, with a small extra rotation
    (axis-angle) applied."""
    dev = resolve_device(device)
    base = SE3(q=torch.tensor([1.0, 0, 0, 0], device=dev),
               t=torch.tensor([x, y, z], dtype=torch.float32, device=dev))
    dq = SO3.exp(torch.tensor(rot_xyz, dtype=torch.float32, device=dev))
    return base.compose(SE3(q=dq, t=torch.zeros(3, device=dev)))

