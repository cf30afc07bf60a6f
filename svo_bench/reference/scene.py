"""The scene every cell's frames are rendered from: a value-noise textured
plane at z = 0, seen through a pinhole radtan camera from poses on a path:
a closed orbit, or a straight traverse over a texture that tiles the
plane.  Frozen from the port at 804481e: `data/synthetic.py`
(`make_texture`, `render`, `lookdown_pose`), `geometry/camera.py`
(`cam2world` and its radtan undistortion), `geometry/se3.py` (quaternions,
`SO3.exp`), `ops/interp.py` (`bilinear_sample`) and `chip_smoke.py::
seq_poses`, whose drifting rotation is made periodic here so that a lap
ends where it began.  The traverse and the tiling are the benchmark's own.

Poses are camera-to-world, a unit quaternion (w, x, y, z) and a position.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# rotations
# ---------------------------------------------------------------------------

def quat_mul(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    pw, px, py, pz = p.unbind(-1)
    qw, qx, qy, qz = q.unbind(-1)
    return torch.stack([pw * qw - px * qx - py * qy - pz * qz,
                        pw * qx + px * qw + py * qz - pz * qy,
                        pw * qy - px * qz + py * qw + pz * qx,
                        pw * qz + px * qy - py * qx + pz * qw], dim=-1)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], dim=-2)


def so3_exp(phi) -> tuple:
    """Axis-angle -> unit quaternion, as a tuple of four floats."""
    theta = math.sqrt(sum(float(v) ** 2 for v in phi))
    if theta < 1e-12:
        return (1.0, 0.5 * phi[0], 0.5 * phi[1], 0.5 * phi[2])
    s = math.sin(0.5 * theta) / theta
    return (math.cos(0.5 * theta), s * phi[0], s * phi[1], s * phi[2])


def lookdown_pose(x: float, y: float, z: float, rot) -> tuple:
    """Camera at (x, y, z < 0) looking along +z, turned by the axis-angle
    `rot`: ((w, x, y, z), (x, y, z)) as plain floats."""
    return so3_exp(rot), (float(x), float(y), float(z))


# ---------------------------------------------------------------------------
# the paths
# ---------------------------------------------------------------------------

def lap_frames(traffic: dict, s: int) -> int:
    """Frames in one lap of sequence s: the traffic's lap less its step per
    sequence, so that sequences reach their keyframes at different steps."""
    return int(traffic["lap_frames"]) - int(traffic.get("lap_step", 0)) * s


def _wobble(traffic: dict, n: int, j: int, cycles: int = 1) -> tuple:
    """A rotation that turns at `turn_rate` rad per frame at the start of
    each of the lap's `cycles` and back by its end."""
    amp = math.sin(2.0 * math.pi * cycles * j / n) * n / (
        2.0 * math.pi * cycles)
    return tuple(amp * k for k in traffic["turn_rate"])


def orbit_pose(traffic: dict, s: int, j: int, phase0: float) -> tuple:
    """Orbit frame j of sequence s (j counts on past the lap; the pose is
    periodic in it): an ellipse of radii `radius` around the pre-roll's end,
    starting at phase 2 pi s / `phase_spacing` + phase0, pitched `pitch`
    rad, with a rotation that turns at `turn_rate` rad per frame at the
    start of the lap and back by its end."""
    n = lap_frames(traffic, s)
    j = j % n
    R, r = traffic["radius"]
    phi = 2.0 * math.pi * s / traffic["phase_spacing"] + phase0
    ph = phi + 2.0 * math.pi * j / n
    x = R * (math.sin(ph) - math.sin(phi))
    y = r * (math.cos(ph) - math.cos(phi))
    rx, ry, rz = _wobble(traffic, n, j)
    return lookdown_pose(x, y, traffic["height"],
                         (traffic["pitch"] + rx, ry, rz))


def texture_period(traffic: dict) -> float:
    """World units after which a tiling texture repeats."""
    return float(traffic["texture_size"]) / float(traffic["tex_scale"])


def traverse_pose(traffic: dict, s: int, j: int, phase0: float) -> tuple:
    """Traverse frame j of sequence s (j counts on past the lap, and the
    path never comes back): a straight line along +x that crosses one
    texture period a lap, from x = period * phase0 / (2 pi), swaying
    `sway` in y and turning (`turn_rate`) `sway_cycles` times a lap.  Frame
    j + lap is frame j one period further on, so over the tiling texture
    it sees the same image."""
    n = lap_frames(traffic, s)
    period = texture_period(traffic)
    k = int(traffic["sway_cycles"])
    x = period * (phase0 / (2.0 * math.pi) + j / n)
    y = traffic["sway"] * math.sin(2.0 * math.pi * k * j / n)
    rx, ry, rz = _wobble(traffic, n, j % n, k)
    return lookdown_pose(x, y, traffic["height"],
                         (traffic["pitch"] + rx, ry, rz))


PATHS = {"orbit": orbit_pose, "traverse": traverse_pose}


def path_pose(traffic: dict, s: int, j: int, phase0: float) -> tuple:
    """Frame j after the pre-roll on the traffic's `path` (an orbit unless
    it says otherwise)."""
    return PATHS[traffic.get("path", "orbit")](traffic, s, j, phase0)


def lap_offset(traffic: dict) -> tuple:
    """How far the path has moved on after each lap: nothing on a closed
    orbit, one texture period along x on a traverse."""
    if traffic.get("path", "orbit") == "traverse":
        return (texture_period(traffic), 0.0, 0.0)
    return (0.0, 0.0, 0.0)


def preroll_poses(traffic: dict, first: tuple = None) -> list:
    """The bootstrap pre-roll: `preroll_frames` poses stepping
    `preroll_step` along x into the path's first pose `first` (the
    orbit's, at the origin, if not given)."""
    n = int(traffic["preroll_frames"])
    x, y, _ = first[1] if first is not None else (0.0, 0.0, 0.0)
    return [lookdown_pose(x - traffic["preroll_step"] * (n - i), y,
                          traffic["height"], (traffic["pitch"], 0.0, 0.0))
            for i in range(n)]


def lap_poses(traffic: dict, s: int, phase0: float) -> list:
    return [path_pose(traffic, s, j, phase0)
            for j in range(lap_frames(traffic, s))]


def phase_offset(seed: int) -> float:
    """The path's starting phase drawn from the seed, in [0, 2 pi)."""
    gen = torch.Generator().manual_seed(int(seed) % (2 ** 63))
    return float(torch.rand((), generator=gen, dtype=torch.float64)
                 * 2.0 * math.pi)


def pose_tensors(poses: list, device) -> tuple:
    """(N, 4) quaternions and (N, 3) positions, float64, on `device`."""
    q = torch.tensor([p[0] for p in poses], dtype=torch.float64,
                     device=device)
    t = torch.tensor([p[1] for p in poses], dtype=torch.float64,
                     device=device)
    return q, t


# ---------------------------------------------------------------------------
# the texture and the camera
# ---------------------------------------------------------------------------

def _upsample(noise: torch.Tensor, size: int, periodic: bool):
    """Bilinear upsampling of a (res, res) grid to (size, size), pixel
    centres aligned as `F.interpolate(align_corners=False)` aligns them;
    `periodic` wraps the grid so that the result tiles."""
    if not periodic:
        return F.interpolate(noise[None, None], size=(size, size),
                             mode="bilinear", align_corners=False)[0, 0]
    res = noise.shape[0]
    u = (torch.arange(size, dtype=torch.float32, device=noise.device)
         + 0.5) * (res / size) - 0.5
    i0 = torch.floor(u)
    f = u - i0
    i0 = i0.long() % res
    i1 = (i0 + 1) % res
    rows = noise[i0] * (1 - f)[:, None] + noise[i1] * f[:, None]
    return rows[:, i0] * (1 - f)[None, :] + rows[:, i1] * f[None, :]


def make_texture(generator: torch.Generator, size: int,
                 periodic: bool = False) -> torch.Tensor:
    """Multi-octave value-noise texture in [0, 255], (size, size) float32,
    with a quantised copy mixed in for sharp corners, on the generator's
    device; `periodic` makes it tile the plane with no seam."""
    dev = generator.device
    octaves = max(int(math.log2(size // 4)) + 1, 5)
    img = torch.zeros((size, size), dtype=torch.float32, device=dev)
    amp = 1.0
    for o in range(octaves):
        res = min(4 * (2 ** o), size)
        noise = torch.rand((res, res), generator=generator,
                           dtype=torch.float32, device=dev)
        img = img + amp * _upsample(noise, size, periodic)
        amp *= 0.75
    img = img - img.min()
    img = img / img.max()
    bands = torch.floor(img * 8.0) / 7.0
    mixed = 0.65 * bands + 0.35 * img
    mixed = mixed - mixed.min()
    mixed = mixed / mixed.max()
    return mixed * 255.0


def camera_rays(camera: dict, device, n_iter: int = 20) -> torch.Tensor:
    """Unit bearing (H*W, 3), float64, of every pixel centre of the camera
    (`resolution`, `intrinsics` fx fy cx cy, radtan
    `distortion_coefficients` k1 k2 p1 p2 [k3]), the distortion inverted by
    fixed-point iteration."""
    w, h = camera["resolution"]
    fx, fy, cx, cy = camera["intrinsics"]
    k = (list(camera.get("distortion_coefficients", [])) + [0.0] * 5)[:5]
    k1, k2, p1, p2, k3 = k
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=device),
                            torch.arange(w, dtype=torch.float64, device=device),
                            indexing="ij")
    xd = ((xx - cx) / fx).reshape(-1)
    yd = ((yy - cy) / fy).reshape(-1)
    x, y = xd, yd
    for _ in range(n_iter):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    f = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    return f / torch.linalg.norm(f, dim=-1, keepdim=True)


def bilinear_sample(img: torch.Tensor, uv: torch.Tensor,
                    wrap: bool = False) -> torch.Tensor:
    """Sample img (H, W) at uv (..., 2) pixel coordinates, bilinear, the
    index clamped to the border, or with `wrap` taken around it."""
    h, w = img.shape
    x, y = uv[..., 0], uv[..., 1]
    x0f, y0f = torch.floor(x), torch.floor(y)
    wx, wy = x - x0f, y - y0f
    if wrap:
        x0, y0 = x0f.long() % w, y0f.long() % h
        x1, y1 = (x0 + 1) % w, (y0 + 1) % h
        return ((1 - wy) * ((1 - wx) * img[y0, x0] + wx * img[y0, x1])
                + wy * ((1 - wx) * img[y1, x0] + wx * img[y1, x1]))
    x0 = torch.nan_to_num(x0f, nan=0.0).clamp(-1.0, float(w)).long()
    y0 = torch.nan_to_num(y0f, nan=0.0).clamp(-1.0, float(h)).long()
    x0, y0 = x0.clamp(0, w - 1), y0.clamp(0, h - 1)
    x1, y1 = (x0 + 1).clamp(0, w - 1), (y0 + 1).clamp(0, h - 1)
    return ((1 - wy) * ((1 - wx) * img[y0, x0] + wx * img[y0, x1])
            + wy * ((1 - wx) * img[y1, x0] + wx * img[y1, x1]))


def render(texture: torch.Tensor, rays: torch.Tensor, q: torch.Tensor,
           t: torch.Tensor, hw: tuple, tex_scale: float,
           wrap: bool = False) -> torch.Tensor:
    """uint8 frames (N, H, W) of the plane z = 0 seen from the N poses
    (q (N, 4), t (N, 3), camera-to-world), rounded as an 8-bit camera
    gives them; `tex_scale` texture pixels per world unit, the texture
    centred on the origin and, with `wrap`, tiling the plane."""
    R = quat_to_matrix(q)                               # (N, 3, 3)
    d = torch.einsum("nij,pj->npi", R, rays)            # (N, HW, 3)
    tz = -t[:, None, 2] / d[..., 2]
    p = t[:, None, :2] + tz[..., None] * d[..., :2]
    uv = (p * tex_scale + texture.shape[0] / 2.0).to(torch.float32)
    img = bilinear_sample(texture, uv, wrap)
    img = torch.round(torch.clamp(img, 0.0, 255.0)).to(torch.uint8)
    return img.reshape((q.shape[0],) + tuple(hw))


def render_poses(texture, rays, poses: list, hw: tuple, tex_scale: float,
                 chunk: int = 32, wrap: bool = False) -> torch.Tensor:
    """`render` over a list of poses in chunks: (N, H, W) uint8."""
    q, t = pose_tensors(poses, texture.device)
    return torch.cat([render(texture, rays, q[i:i + chunk], t[i:i + chunk],
                             hw, tex_scale, wrap)
                      for i in range(0, len(poses), chunk)])
