"""Tracking overlay and AR cube rendering onto frames — port of
`android_svo_tpu/viz/overlay.py` (the reference's feature circles,
`svo_system.cpp:64-66`, and the GL thread's coloured unit cube,
`GLRenderer.cpp:281-345`).

The rasterizer stays numpy on the host, as in the JAX package: this is an
I/O and debug path, not device compute.  The port's tensors (a gray frame,
an `SE3`, the features' pixels and mask) cross to the host once per frame;
the cube's 8 corners are projected through the port's camera on its
device.  Painter's-algorithm face fill gives the reference's depth-tested
convex cube.
"""

from __future__ import annotations

import os

import numpy as np
import torch

# one color per cube face, RGB in [0,255] — mirrors the per-vertex colors in
# GLRenderer.cpp:36-44
FACE_COLORS = np.array([
    [230, 80, 80], [80, 230, 80], [80, 80, 230],
    [230, 230, 80], [230, 80, 230], [80, 230, 230]], np.uint8)

# unit cube centered at origin: 8 corners, 6 faces (quads, CCW outward)
_CORNERS = np.array([[x, y, z] for x in (-.5, .5) for y in (-.5, .5)
                     for z in (-.5, .5)], np.float64)
_FACES = np.array([
    [0, 1, 3, 2],   # -x
    [4, 6, 7, 5],   # +x
    [0, 4, 5, 1],   # -y
    [2, 3, 7, 6],   # +y
    [0, 2, 6, 4],   # -z
    [1, 5, 7, 3],   # +z
])


def _host(x) -> np.ndarray:
    """A tensor on any device, or an array, as a numpy array."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def gray_to_rgb(gray) -> np.ndarray:
    """(H, W) float [0,255] or [0,1] -> (H, W, 3) uint8."""
    g = _host(gray).astype(np.float32)
    if g.max() <= 1.5:
        g = g * 255.0
    g = np.clip(g, 0, 255).astype(np.uint8)
    return np.stack([g, g, g], axis=-1)


def draw_features(img_rgb: np.ndarray, px, valid=None, radius: int = 3,
                  color=(80, 255, 80)) -> np.ndarray:
    """Draw circles at feature pixel locations (≡ cv::circle loop,
    svo_system.cpp:64-66).  px: (N, 2) in (x, y); valid: (N,) mask."""
    h, w = img_rgb.shape[:2]
    px = _host(px)
    if valid is None:
        valid = np.ones(px.shape[0], bool)
    valid = _host(valid).astype(bool) & np.isfinite(px).all(axis=-1)
    pts = np.round(px[valid]).astype(np.int64)
    if pts.size == 0:
        return img_rgb
    # ring offsets at the given radius (1px-thick circle)
    dy, dx = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    r = np.hypot(dx, dy)
    ring = np.argwhere((r >= radius - 0.6) & (r <= radius + 0.6))
    oy, ox = ring[:, 0] - radius, ring[:, 1] - radius
    ys = (pts[:, 1, None] + oy[None, :]).ravel()
    xs = (pts[:, 0, None] + ox[None, :]).ravel()
    ok = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
    img_rgb[ys[ok], xs[ok]] = np.asarray(color, np.uint8)
    return img_rgb


def _fill_convex_quad(img: np.ndarray, quad: np.ndarray, color) -> None:
    """Rasterize a convex quad given as (4,2) float pixel coords."""
    h, w = img.shape[:2]
    x0 = max(int(np.floor(quad[:, 0].min())), 0)
    x1 = min(int(np.ceil(quad[:, 0].max())), w - 1)
    y0 = max(int(np.floor(quad[:, 1].min())), 0)
    y1 = min(int(np.ceil(quad[:, 1].max())), h - 1)
    if x1 < x0 or y1 < y0:
        return
    yy, xx = np.mgrid[y0:y1 + 1, x0:x1 + 1]
    inside = np.ones(yy.shape, bool)
    # sign-consistent half-plane test around the quad (either winding)
    signs = []
    for i in range(4):
        a, b = quad[i], quad[(i + 1) % 4]
        cross = (b[0] - a[0]) * (yy - a[1]) - (b[1] - a[1]) * (xx - a[0])
        signs.append(cross)
    signs = np.stack(signs)
    inside = (signs >= 0).all(axis=0) | (signs <= 0).all(axis=0)
    img[yy[inside], xx[inside]] = color


def draw_cube(img_rgb: np.ndarray, cam, T_cw, center=(0.0, 0.0, 0.0),
              size: float = 0.3, edge_color=(255, 255, 255),
              fill: bool = True) -> np.ndarray:
    """Render the AR cube at world-space `center` under camera pose T_cw
    (world->camera SE3) — the GLRenderer cube (GLRenderer.cpp:281-345).

    Painter's algorithm: faces sorted far-to-near by mean camera depth, each
    filled with its face color, then wireframe edges on top."""
    corners_w = _CORNERS * size + np.asarray(center, np.float64)
    q = _host(T_cw.q).astype(np.float64)
    t = _host(T_cw.t).astype(np.float64)
    # quaternion (w,x,y,z) rotate
    w_, x, y, z = q
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w_ * z), 2 * (x * z + w_ * y)],
        [2 * (x * y + w_ * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w_ * x)],
        [2 * (x * z - w_ * y), 2 * (y * z + w_ * x), 1 - 2 * (x * x + y * y)],
    ])
    p_c = corners_w @ R.T + t
    if (p_c[:, 2] <= 1e-3).any():
        return img_rgb                       # cube (partly) behind camera
    uv = _host(cam.world2cam(torch.from_numpy(p_c.astype(np.float32)).to(
        cam.fx.device))).astype(np.float64)

    if fill:
        depth = p_c[_FACES].mean(axis=(1,))[:, 2]
        order = np.argsort(-depth)           # far to near
        for i in order:
            _fill_convex_quad(img_rgb, uv[_FACES[i]], FACE_COLORS[i])
    # wireframe on top
    edges = set()
    for f in _FACES:
        for i in range(4):
            e = tuple(sorted((f[i], f[(i + 1) % 4])))
            edges.add(e)
    h, w = img_rgb.shape[:2]
    for a, b in edges:
        n = int(max(abs(uv[b] - uv[a]).max(), 1)) + 1
        ts = np.linspace(0.0, 1.0, n)
        pts = np.round(uv[a] + ts[:, None] * (uv[b] - uv[a])).astype(np.int64)
        ok = ((pts[:, 0] >= 0) & (pts[:, 0] < w)
              & (pts[:, 1] >= 0) & (pts[:, 1] < h))
        img_rgb[pts[ok, 1], pts[ok, 0]] = np.asarray(edge_color, np.uint8)
    return img_rgb


def save_ppm(path: str, img_rgb: np.ndarray) -> None:
    """Write binary PPM (P6) — dependency-free image output."""
    h, w = img_rgb.shape[:2]
    with open(path, "wb") as fh:
        fh.write(f"P6\n{w} {h}\n255\n".encode())
        fh.write(np.ascontiguousarray(img_rgb, np.uint8).tobytes())


class Visualizer:
    """Per-frame overlay writer — the role of the reference's `visualize`
    callback (`android_main.cpp:120-142`): pose -> AR cube, features ->
    circles, frame -> display surface (here: numbered PPM files)."""

    def __init__(self, out_dir: str, cam, cube_center=(0.0, 0.0, 0.0),
                 cube_size: float = 0.3, draw_cube_overlay: bool = True):
        self.out_dir = out_dir
        self.cam = cam
        self.cube_center = cube_center
        self.cube_size = cube_size
        self.draw_cube_overlay = draw_cube_overlay
        self.n = 0
        os.makedirs(out_dir, exist_ok=True)

    def __call__(self, img_gray, T_cw, ftr_px=None, ftr_valid=None
                 ) -> np.ndarray:
        frame = gray_to_rgb(img_gray)
        if ftr_px is not None:
            draw_features(frame, ftr_px, ftr_valid)
        if self.draw_cube_overlay:
            draw_cube(frame, self.cam, T_cw, self.cube_center, self.cube_size)
        save_ppm(os.path.join(self.out_dir, f"frame_{self.n:06d}.ppm"), frame)
        self.n += 1
        return frame
