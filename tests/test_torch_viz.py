"""The port's overlay (`android_svo_tpu_torch/viz`) against the JAX
package's on the CPU: the same frame, features, pose and camera give the
same RGB bytes and the same PPM files."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from android_svo_tpu.geometry.camera import PinholeCamera as JCamera
from android_svo_tpu.geometry.se3 import SE3 as JSE3
from android_svo_tpu import viz as jviz

from android_svo_tpu_torch import viz
from android_svo_tpu_torch.data.euroc import MH01_CAM0
from android_svo_tpu_torch.geometry.camera import PinholeCamera
from android_svo_tpu_torch.geometry.se3 import SE3

torch.set_num_threads(1)

W, H = 188, 120                         # MH_01 cam0 at a quarter


def _cameras(distorted):
    fx, fy, cx, cy = (v / 4 for v in MH01_CAM0["intrinsics"])
    d = MH01_CAM0["distortion_coefficients"] if distorted else (0.0,) * 4
    return (JCamera.create(W, H, fx, fy, cx, cy, *d),
            PinholeCamera.create(W, H, fx, fy, cx, cy, *d, device="cpu"))


def _frame(seed=0):
    return np.random.default_rng(seed).uniform(0, 255, (H, W)).astype(
        np.float32)


def _pose(rot, t):
    """T_cw as a JAX and a port SE3 from the same numpy rotation vector
    and translation."""
    from android_svo_tpu.geometry.se3 import SO3 as JSO3
    q = np.asarray(JSO3.exp(jnp.asarray(rot, jnp.float32)))
    t = np.asarray(t, np.float32)
    return (JSE3(q=jnp.asarray(q), t=jnp.asarray(t)),
            SE3(q=torch.from_numpy(q.copy()), t=torch.from_numpy(t.copy())))


@pytest.mark.parametrize("scale", [255.0, 1.0], ids=["0-255", "0-1"])
def test_gray_to_rgb_matches_jax(scale):
    img = _frame() / 255.0 * scale
    out = viz.gray_to_rgb(torch.from_numpy(img))
    assert out.dtype == np.uint8 and out.shape == (H, W, 3)
    np.testing.assert_array_equal(out, jviz.gray_to_rgb(img))


@pytest.mark.parametrize("radius", [3, 5])
def test_draw_features_matches_jax(radius):
    """Circles at seeded pixels, some off the image, one NaN, a mask:
    byte-identical to the JAX overlay."""
    rng = np.random.default_rng(radius)
    px = rng.uniform(-10, [W + 10, H + 10], (64, 2)).astype(np.float32)
    px[5] = np.nan
    valid = rng.random(64) < 0.8
    a = jviz.gray_to_rgb(_frame())
    b = a.copy()
    jviz.draw_features(a, px, valid, radius=radius)
    out = viz.draw_features(b, torch.from_numpy(px),
                            torch.from_numpy(valid), radius=radius)
    assert out is b and (b != jviz.gray_to_rgb(_frame())).any()
    np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("distorted", [False, True],
                         ids=["pinhole", "radtan"])
@pytest.mark.parametrize("pose", [
    ((0.0, 0.0, 0.0), (0.0, 0.0, 1.5)),
    ((0.2, -0.3, 0.1), (0.1, -0.05, 1.2)),
    ((-0.1, 0.25, -0.4), (-0.2, 0.1, 2.0)),
    ((0.0, 0.0, 0.0), (0.0, 0.0, -1.0))],       # behind: nothing drawn
    ids=["ahead", "turned", "far", "behind"])
def test_draw_cube_matches_jax(distorted, pose):
    """The AR cube (faces, then edges) under one pose and camera: the
    port projects the corners in torch fp32, JAX in XLA fp32; the pixels
    are identical on these poses."""
    jcam, pcam = _cameras(distorted)
    jT, pT = _pose(*pose)
    base = jviz.gray_to_rgb(_frame(1))
    a, b = base.copy(), base.copy()
    jviz.draw_cube(a, jcam, jT, size=0.5)
    viz.draw_cube(b, pcam, pT, size=0.5)
    np.testing.assert_array_equal(b, a)
    drawn = (b != base).any()
    assert drawn == (pose[1][2] > 0)


def test_save_ppm_matches_jax(tmp_path):
    rgb = jviz.gray_to_rgb(_frame(2))
    jviz.save_ppm(str(tmp_path / "j.ppm"), rgb)
    viz.save_ppm(str(tmp_path / "p.ppm"), rgb)
    data = (tmp_path / "p.ppm").read_bytes()
    assert data == (tmp_path / "j.ppm").read_bytes()
    assert data.startswith(b"P6\n%d %d\n255\n" % (W, H))


def test_visualizer_writes_numbered_ppms(tmp_path):
    """Both Visualizers over three frames: one numbered PPM per call,
    byte-identical files, the cube's face colours present."""
    jcam, pcam = _cameras(True)
    jv = jviz.Visualizer(str(tmp_path / "j"), jcam, cube_center=(0, 0, 1.5))
    pv = viz.Visualizer(str(tmp_path / "p"), pcam, cube_center=(0, 0, 1.5))
    rng = np.random.default_rng(3)
    for i in range(3):
        img = _frame(10 + i)
        px = rng.uniform(0, [W, H], (32, 2)).astype(np.float32)
        valid = rng.random(32) < 0.7
        jT, pT = _pose((0.05 * i, -0.03 * i, 0.02 * i), (0.02 * i, 0, 0))
        fa = jv(img, jT, px, valid)
        fb = pv(torch.from_numpy(img), pT, torch.from_numpy(px),
                torch.from_numpy(valid))
        np.testing.assert_array_equal(fb, fa)
        colours = {tuple(c) for c in fb.reshape(-1, 3)}
        assert colours & {tuple(c) for c in viz.overlay.FACE_COLORS}
    names = sorted(os.listdir(tmp_path / "p"))
    assert names == [f"frame_{i:06d}.ppm" for i in range(3)]
    assert pv.n == 3
    for name in names:
        assert ((tmp_path / "p" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes())
