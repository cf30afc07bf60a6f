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


def make_edge_texture(generator: torch.Generator, size: int = 1024,
                      noise_band: float = 0.18, device=None) -> torch.Tensor:
    """Low-corner, edge-rich texture for the edgelet path: concentric
    intensity rings (step edges in every orientation, almost no corners)
    on a gentle radial ramp, with a horizontal band of `make_texture` noise
    across the middle (`noise_band` of the height) that keeps corners for
    the two-frame bootstrap.  Outside the band it equals the JAX texture
    exactly."""
    dev = resolve_device(device)
    idx = torch.arange(size, dtype=torch.float32, device=dev)
    yy, xx = torch.meshgrid(idx, idx, indexing="ij")
    c = size / 2.0
    # the square root in fp64, rounded once to fp32: torch's vectorised
    # fp32 sqrt on the CPU is not always correctly rounded, XLA's is
    r = torch.sqrt(((xx - c) ** 2 + (yy - c) ** 2).double()).float()
    rings = torch.remainder(torch.floor(r / 28.0), 2) * 200.0 + 25.0
    rings = rings + 0.01 * r
    noise = make_texture(generator, size, device=dev)
    band = (torch.abs(yy / size - 0.5) < noise_band / 2).to(torch.float32)
    img = rings * (1 - band) + noise * band
    return torch.clamp(img, 0.0, 255.0)


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



def make_trajectory(n_frames: int, radius: float = 0.4, height: float = -3.0,
                    forward: float = 0.02, rot_amp: float = 0.02,
                    device=None) -> list:
    """Smooth sideways+forward sweep with small rotations: a list of SE3
    camera-to-world poses (T_w_c) on `device` (the card unless the caller
    asks for the CPU)."""
    dev = resolve_device(device)
    poses = []
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1)
        x = radius * math.sin(2 * math.pi * s * 0.75)
        rot = (rot_amp * math.sin(2 * math.pi * s),
               rot_amp * math.cos(2 * math.pi * s), 0.15 * rot_amp * i)
        poses.append(lookdown_pose(x, forward * i, height, rot, device=dev))
    return poses


def true_depth(cam: PinholeCamera, T_w_c: SE3,
               px: torch.Tensor) -> torch.Tensor:
    """Ground-truth depth along the bearing of pixels px (N, 2): the
    distance from the camera to the plane along each unit ray."""
    d_w = T_w_c.rotate(cam.cam2world(px))
    return -T_w_c.t[2] / d_w[..., 2]
