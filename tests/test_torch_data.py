"""The port's dataset path held against the JAX package on the CPU: the
EuRoC and TUM loaders (and the IMU stream) on the JAX harness's fixture
trees, the YUV conversions, the native feeder's decode and ordered
prefetch, the ASL writer, tracking through a distorted camera (EuRoC MH_01
cam0 at half size) from one JAX-built state, and the dataset path end to
end (write, load, decode, track, checkpoint, resume)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from android_svo_tpu.config import SVOConfig as JConfig
from android_svo_tpu.core import frame_handler as jfh
from android_svo_tpu.data import euroc as jeuroc
from android_svo_tpu.data import native_feeder as jfeeder
from android_svo_tpu.data import synthetic as jsyn
from android_svo_tpu.data import tum as jtum
from android_svo_tpu.data import yuv as jyuv
from android_svo_tpu.geometry.camera import PinholeCamera as JCamera

from android_svo_tpu_torch.config import SVOConfig
from android_svo_tpu_torch.core import frame_handler as fh
from android_svo_tpu_torch.core import pipeline
from android_svo_tpu_torch.core import state as st
from android_svo_tpu_torch.data import euroc, native_feeder, synthetic, tum
from android_svo_tpu_torch.data import yuv
from android_svo_tpu_torch.geometry.camera import PinholeCamera

# The tensors here are small and the suite's workers share the machine's
# cores: one intra-op thread per process keeps torch's OpenMP pools from
# oversubscribing them (they slow every worker, the JAX ones included).
torch.set_num_threads(1)

CPU = torch.device("cpu")
STAMP0 = 1403636579763555584           # MH_01's first cam0 stamp


def _write_png_pil(path, arr):
    from PIL import Image
    Image.fromarray(arr.astype(np.uint8), mode="L").save(path)


def _write_pgm(path, img):
    h, w = img.shape
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (w, h))
        f.write(img.astype(np.uint8).tobytes())


# ---- loaders --------------------------------------------------------------

def _euroc_tree(root, distortion):
    """tests/test_harness.py's EuRoC fixture (3 PIL PNGs at 64x48, one GT
    row), with the given distortion line, plus an IMU stream."""
    cam = root / "mav0" / "cam0"
    (cam / "data").mkdir(parents=True)
    gt = root / "mav0" / "state_groundtruth_estimate0"
    gt.mkdir(parents=True)
    rng = np.random.RandomState(0)
    rows = []
    for i in range(3):
        ts = STAMP0 + i * 50_000_000
        fn = f"{ts}.png"
        _write_png_pil(cam / "data" / fn, rng.randint(0, 255, (48, 64)))
        rows.append(f"{ts},{fn}")
    (cam / "data.csv").write_text("#ts,filename\n" + "\n".join(rows) + "\n")
    (cam / "sensor.yaml").write_text(
        "sensor_type: camera\n"
        "resolution: [64, 48]\n"
        "intrinsics: [458.654, 457.296, 367.215, 248.375]\n"
        f"distortion_coefficients: {distortion}\n")
    (gt / "data.csv").write_text(
        "#ts,x,y,z,qw,qx,qy,qz\n"
        f"{STAMP0},1.0,2.0,3.0,1.0,0.0,0.0,0.0\n"
        f"{STAMP0 + 100_000_000},1.5,2.5,3.5,0.0,1.0,0.0,0.0\n")
    imu = root / "mav0" / "imu0"
    imu.mkdir(parents=True)
    with open(imu / "data.csv", "w") as f:
        f.write("#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n")
        for i in range(5):
            f.write(f"{1000000000 + i * 5000000},0.01,{0.02 * i},0.03,"
                    f"0.1,0.2,{9.8 - 0.01 * i}\n")
    return str(root)


def _assert_same_camera(pc, jc):
    """Every field of the port's camera equal to the JAX camera's in
    fp32."""
    for name in ("fx", "fy", "cx", "cy", "dist"):
        np.testing.assert_array_equal(getattr(pc, name).numpy(),
                                      np.asarray(getattr(jc, name)),
                                      err_msg=name)
        assert getattr(pc, name).dtype == torch.float32
    assert (pc.width, pc.height, pc.distortion_free) == (
        jc.width, jc.height, jc.distortion_free)


@pytest.mark.parametrize("distortion", [
    "[-0.2834, 0.0739, 0.0002, 0.00002]", "[0.0, 0.0, 0.0, 0.0]"],
    ids=["radtan", "pinhole"])
def test_load_euroc_matches_jax(tmp_path, distortion):
    root = _euroc_tree(tmp_path / "seq", distortion)
    js = jeuroc.load_euroc(root)
    ps = euroc.load_euroc(root, device="cpu")
    _assert_same_camera(ps.camera, js.camera)
    assert ps.camera.distortion_free == (distortion.startswith("[0.0"))
    assert ps.timestamps == js.timestamps
    assert ps.filenames == js.filenames
    for name in ("gt_stamps", "gt_positions", "gt_quats"):
        np.testing.assert_array_equal(getattr(ps, name), getattr(js, name))
    frames_j, frames_p = list(js.frames()), list(ps.frames())
    assert len(frames_p) == len(ps) == 3
    for (tj, fj), (tp, fp) in zip(frames_j, frames_p):
        assert tj == tp and fp.dtype == torch.float32 and fp.device == CPU
        np.testing.assert_array_equal(fp.numpy(), fj)
    for t in (frames_p[0][0], frames_p[2][0], 0.0):
        np.testing.assert_array_equal(ps.gt_at(t), js.gt_at(t))


def test_load_imu_matches_jax(tmp_path):
    root = _euroc_tree(tmp_path / "seq", "[0.0, 0.0, 0.0, 0.0]")
    ji, pi = jeuroc.load_imu(root), euroc.load_imu(root)
    assert set(pi) == set(ji) == {"stamps", "gyro", "accel"}
    for k in ji:
        assert pi[k].dtype == ji[k].dtype
        np.testing.assert_array_equal(pi[k], ji[k])
    assert euroc.load_imu(str(tmp_path / "nope")) is None


@pytest.mark.parametrize("with_dist", [False, True],
                         ids=["pinhole", "radtan"])
def test_load_tum_matches_jax(tmp_path, with_dist):
    """tests/test_harness.py's TUM fixture (two PNGs at 40x32), with a
    ground-truth file and, in one case, five distortion terms."""
    root = tmp_path / "tum"
    (root / "rgb").mkdir(parents=True)
    rng = np.random.RandomState(0)
    lines = []
    for i in range(2):
        fn = f"rgb/{i}.png"
        _write_png_pil(root / fn, rng.randint(0, 255, (32, 40)))
        lines.append(f"{i * 0.1:.4f} {fn}")
    (root / "rgb.txt").write_text("# tum\n" + "\n".join(lines) + "\n")
    dist = " -0.2834 0.0739 0.0002 0.00002 0.001" if with_dist else ""
    (root / "camera.txt").write_text(f"300 300 20 16{dist}\n40 32\n")
    (root / "groundtruth.txt").write_text(
        "# t tx ty tz qx qy qz qw\n0.0 1 2 3 0 0 0 1\n0.1 1.1 2 3 0 0 0 1\n")
    js = jtum.load_tum(str(root))
    ps = tum.load_tum(str(root), device="cpu")
    _assert_same_camera(ps.camera, js.camera)
    assert ps.camera.distortion_free is not with_dist
    assert ps.timestamps == js.timestamps and ps.filenames == js.filenames
    np.testing.assert_array_equal(ps.gt_stamps, js.gt_stamps)
    np.testing.assert_array_equal(ps.gt_positions, js.gt_positions)
    for (tj, fj), (tp, fp) in zip(js.frames(), ps.frames()):
        assert tj == tp
        np.testing.assert_array_equal(fp.numpy(), fj)
    with pytest.raises(FileNotFoundError):
        tum.load_tum(str(tmp_path), device="cpu")


@pytest.mark.parametrize("loader", ["euroc", "tum"])
def test_loaders_build_the_camera_on_the_asked_device(monkeypatch, tmp_path,
                                                      loader):
    """With CUDA asked for (by default), the loaders build the camera on
    CUDA: a loader that left it on the CPU would hand the handler a camera
    on another device than its frames."""
    if loader == "euroc":
        root = _euroc_tree(tmp_path / "seq", "[0.0, 0.0, 0.0, 0.0]")
    else:
        root = tmp_path / "tum"
        root.mkdir()
        (root / "rgb.txt").write_text("0.0 rgb/0.png\n")
        (root / "camera.txt").write_text("300 300 20 16\n40 32\n")
    seen = []

    def create(*args, device=None, **kw):
        seen.append(device)
        return "camera"

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(PinholeCamera, "create", create)
    load = euroc.load_euroc if loader == "euroc" else tum.load_tum
    assert load(str(root)).camera == "camera"
    assert seen == [torch.device("cuda")]


def test_write_euroc_loads_in_both_packages(tmp_path):
    """The ASL writer's tree (stdlib PNGs at MH_01 cam0's geometry, GT
    rows of positions and quaternions) loads the same in both packages,
    and each PNG decodes under PIL to the array written."""
    from PIL import Image
    rng = np.random.default_rng(4)
    frames = [rng.integers(0, 256, (48, 75), np.uint8) for _ in range(3)]
    stamps = [STAMP0 + i * 50_000_000 for i in range(3)]
    pos = rng.standard_normal((3, 3))
    quat = rng.standard_normal((3, 4))
    sensor = dict(euroc.MH01_CAM0, resolution=(75, 48))
    paths = euroc.write_euroc(str(tmp_path), frames, stamps, sensor, pos,
                              quat)
    for p, img in zip(paths, frames):
        np.testing.assert_array_equal(np.asarray(Image.open(p)), img)
    js = jeuroc.load_euroc(str(tmp_path))
    ps = euroc.load_euroc(str(tmp_path), device="cpu")
    _assert_same_camera(ps.camera, js.camera)
    fx, fy, cx, cy = euroc.MH01_CAM0["intrinsics"]
    want = PinholeCamera.create(75, 48, fx, fy, cx, cy,
                                *euroc.MH01_CAM0["distortion_coefficients"],
                                device="cpu")
    for name in ("fx", "fy", "cx", "cy", "dist"):
        assert torch.equal(getattr(ps.camera, name), getattr(want, name))
    assert ps.paths() == paths
    assert ps.timestamps == js.timestamps == [s * 1e-9 for s in stamps]
    np.testing.assert_array_equal(ps.gt_positions, pos)
    np.testing.assert_array_equal(ps.gt_quats, quat)
    np.testing.assert_array_equal(js.gt_quats, quat)


# ---- YUV ------------------------------------------------------------------

@pytest.fixture(params=[(48, 64), (480, 640)], ids=["64x48", "640x480"])
def planes(request):
    h, w = request.param
    rng = np.random.default_rng(h)
    return (rng.integers(0, 256, (h, w), np.uint8),
            rng.integers(0, 256, (h // 2, w // 2), np.uint8),
            rng.integers(0, 256, (h // 2, w // 2), np.uint8))


@pytest.mark.parametrize("fn", ["yuv420_to_rgb", "yuv420_to_gray",
                                "rgb_to_gray"])
def test_yuv_matches_jax(planes, fn):
    """Each conversion on seeded uint8 planes, port against JAX: max |d|
    <= 1e-4 (the same fp32 operations in the same order)."""
    y, u, v = planes
    if fn == "yuv420_to_rgb":
        j = jyuv.yuv420_to_rgb(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v))
        p = yuv.yuv420_to_rgb(*map(torch.from_numpy, (y, u, v)))
        assert p.shape == y.shape + (3,)
    elif fn == "yuv420_to_gray":
        j = jyuv.yuv420_to_gray(jnp.asarray(y))
        p = yuv.yuv420_to_gray(torch.from_numpy(y))
    else:
        rgb = np.asarray(jyuv.yuv420_to_rgb(
            jnp.asarray(y), jnp.asarray(u), jnp.asarray(v)))
        j = jyuv.rgb_to_gray(jnp.asarray(rgb))
        p = yuv.rgb_to_gray(torch.from_numpy(rgb))
    assert p.dtype == torch.float32
    assert float(np.abs(p.numpy() - np.asarray(j)).max()) <= 1e-4


# ---- native feeder --------------------------------------------------------

@pytest.fixture(scope="module")
def lib_ok():
    if not native_feeder.available():
        pytest.skip("the native feeder does not build here (no g++?)")
    return True


@pytest.fixture
def jax_feeder(lib_ok, monkeypatch):
    """The JAX package's feeder module bound to the library the port built
    from the same `native/` sources: the JAX module would otherwise run
    make into `native/build/` unlocked, racing tests/test_native_feeder.py
    on another worker."""
    monkeypatch.setattr(jfeeder, "_LIB_PATH", str(native_feeder.LIB_PATH))
    monkeypatch.setattr(jfeeder, "_lib", None)
    return jfeeder


@pytest.mark.parametrize("fmt", ["pgm", "png"])
def test_decode_image_matches_jax(tmp_path, jax_feeder, fmt):
    img = np.random.default_rng(1).integers(0, 256, (37, 53), np.uint8)
    path = str(tmp_path / f"a.{fmt}")
    (_write_pgm if fmt == "pgm" else _write_png_pil)(path, img)
    out = native_feeder.decode_image(path)
    assert out.dtype == torch.float32 and out.device == CPU
    np.testing.assert_array_equal(out.numpy(), jax_feeder.decode_image(path))
    np.testing.assert_array_equal(out.numpy(), img.astype(np.float32))
    with pytest.raises(IOError):
        native_feeder.decode_image(str(tmp_path / "missing.png"))


def test_feeder_order_and_content(tmp_path, jax_feeder):
    """The CPU feeder yields every frame in order, each a fresh tensor
    equal to the JAX feeder's frame, with a ring smaller than the
    sequence."""
    rng = np.random.default_rng(2)
    paths, imgs = [], []
    for i in range(12):
        imgs.append(rng.integers(0, 256, (32, 40), np.uint8))
        paths.append(str(tmp_path / f"f{i:03d}.png"))
        euroc.write_png(paths[-1], imgs[-1])
    feeder = native_feeder.NativeFrameFeeder(paths, capacity=4, n_threads=3,
                                             device="cpu")
    assert (feeder.height, feeder.width, len(feeder)) == (32, 40, 12)
    got = list(feeder)
    feeder.close()
    assert [i for i, _ in got] == list(range(12))
    assert len({f.data_ptr() for _, f in got}) == 12
    jf = jax_feeder.NativeFrameFeeder(paths, capacity=4, n_threads=3)
    for (i, f), (ji, jframe) in zip(got, jf):
        assert i == ji
        np.testing.assert_array_equal(f.numpy(), jframe)
        np.testing.assert_array_equal(f.numpy(), imgs[i].astype(np.float32))
    jf.close()


# ---- tracking through the distorted camera -------------------------------

W2, H2 = 376, 240                       # MH_01 cam0 at half size
CFG_DIST = dict(max_n_kfs=8, max_points=2048, max_seeds=1024,
                ransac_n_trials=128, img_align_n_iter=15,
                init_min_disparity=20.0)     # local BA on (loba_n_iter=5)
N_DIST = 12                             # bootstrap on frame 5, 6 tracked


def _half_mh01():
    fx, fy, cx, cy = (v / 2 for v in euroc.MH01_CAM0["intrinsics"])
    return fx, fy, cx, cy, euroc.MH01_CAM0["distortion_coefficients"]


@pytest.fixture(scope="module")
def distorted_run():
    """The JAX FrameHandler over 12 frames the JAX renderer draws through
    the half-size MH_01 camera: the post-bootstrap state and every tracked
    frame's outputs."""
    fx, fy, cx, cy, d = _half_mh01()
    jcam = JCamera.create(W2, H2, fx, fy, cx, cy, *d)
    tex = jsyn.make_texture(jax.random.PRNGKey(11), 2048)
    imgs = [np.array(jsyn.render(tex, jcam, jsyn.lookdown_pose(
        0.08 * i, 0.024 * i, -3.0,
        (0.45 + 0.002 * i, -0.002 * i, 0.004 * i))))
        for i in range(N_DIST)]
    handler = jfh.FrameHandler(jcam, JConfig(**CFG_DIST))
    boot, outs = None, []
    for img in imgs:
        was_default = handler.stage == jfh.STAGE_DEFAULT_FRAME
        res = handler.add_image(jnp.asarray(img))
        if not was_default and handler.stage == jfh.STAGE_DEFAULT_FRAME:
            vo = jax.device_get(handler.vo)
            boot = {}
            for f in dataclasses.fields(vo):
                val = getattr(vo, f.name)
                if dataclasses.is_dataclass(val):
                    for g in dataclasses.fields(val):
                        boot[f"{f.name}.{g.name}"] = np.asarray(
                            getattr(val, g.name))
                else:
                    boot[f.name] = np.asarray(val)
        elif was_default:
            outs.append({"result": res.result,
                         "t_wc": np.asarray(res.t_wc)})
    assert boot is not None, "the JAX handler did not bootstrap"
    return imgs, boot, outs


def test_distorted_tracking_matches_jax(distorted_run):
    """The port's FrameHandler seated on the JAX post-bootstrap state
    tracks the same frames through the same radtan camera (local BA on):
    equal result codes, camera centres within 2e-3 (test_torch_slice.py's
    tolerances)."""
    imgs, boot, jouts = distorted_run
    assert len(jouts) >= 5
    assert pipeline.RES_IS_KEYFRAME in [o["result"] for o in jouts]
    fx, fy, cx, cy, d = _half_mh01()
    cam = PinholeCamera.create(W2, H2, fx, fy, cx, cy, *d, device="cpu")
    assert not cam.distortion_free
    handler = fh.FrameHandler(cam, SVOConfig(**CFG_DIST), device="cpu")
    handler.vo = st.state_from_numpy(boot, device=CPU)
    handler.stage = fh.STAGE_DEFAULT_FRAME
    start = len(imgs) - len(jouts)
    for k, jo in enumerate(jouts):
        res = handler.add_image(torch.from_numpy(imgs[start + k]))
        assert res.result == jo["result"], (k, res.result, jo["result"])
        dc = np.abs(res.t_wc.numpy() - jo["t_wc"]).max()
        assert dc < 2e-3, (k, dc)
    assert handler.n_local_ba >= 1


# ---- the dataset path end to end -----------------------------------------

def test_euroc_track_checkpoint_resume(tmp_path, lib_ok):
    """tests/test_harness.py's end-to-end harness run on the port: render
    a 160x120 sequence, write it as an ASL tree, load it, decode it through
    the native feeder, track it, checkpoint at frame 6 and resume: the
    tail is reproduced within 1e-6, ATE < 0.25 (a sanity gate: the
    configuration truncates every optimiser, as the JAX test's does)."""
    from android_svo_tpu_torch.evals.trajectory import ate_rmse
    from android_svo_tpu_torch.utils.checkpoint import (load_handler,
                                                        save_handler)
    w, h, n = 160, 120, 10
    cam = synthetic.default_camera(w, h, device="cpu")
    tex = synthetic.make_texture(torch.Generator().manual_seed(3), 1024,
                                 device="cpu")
    poses = [synthetic.lookdown_pose(0.06 * i, 0.02 * i, -3.0,
                                     (0.002 * i, 0.0, 0.003 * i),
                                     device="cpu") for i in range(n)]
    imgs = [torch.round(torch.clamp(synthetic.render(tex, cam, p), 0, 255))
            .to(torch.uint8).numpy() for p in poses]
    stamps = [STAMP0 + i * 50_000_000 for i in range(n)]
    sensor = {"resolution": (w, h),
              "intrinsics": [float(v) for v in (cam.fx, cam.fy, cam.cx,
                                                cam.cy)],
              "distortion_coefficients": [0.0] * 4}
    euroc.write_euroc(str(tmp_path / "seq"), imgs, stamps, sensor,
                      np.stack([p.t.numpy() for p in poses]),
                      np.stack([p.q.numpy() for p in poses]))

    seq = euroc.load_euroc(str(tmp_path / "seq"), device="cpu")
    assert len(seq) == n and seq.camera.width == w
    feeder = native_feeder.NativeFrameFeeder(seq.paths(), device="cpu")
    frames = [f for _, f in feeder]
    feeder.close()
    for f, img in zip(frames, imgs):
        assert torch.equal(f, torch.from_numpy(img).float())

    cfg = SVOConfig(
        max_n_kfs=4, max_points=256, max_seeds=256,
        img_align_n_iter=3, poseoptim_n_iter=2, structureoptim_n_iter=2,
        max_epi_search_steps=16, ransac_n_trials=64,
        init_min_kps=20, init_min_tracked=15, init_min_disparity=8.0,
        init_min_inliers=12, min_reproj_matches=10, quality_min_fts=10,
        min_pose_opt_edges=5)
    handler = fh.FrameHandler(seq.camera, cfg, device="cpu")
    est, gt = [], []

    def track(i):
        res = handler.add_image(frames[i], seq.timestamps[i])
        if handler.stage == fh.STAGE_DEFAULT_FRAME:
            est.append(res.T_cw.inverse().t.numpy())
            gt.append(seq.gt_at(seq.timestamps[i]))
        return res.T_cw.t.numpy()

    for i in range(6):
        track(i)
    assert handler.stage == fh.STAGE_DEFAULT_FRAME
    save_handler(str(tmp_path / "ckpt"), handler)
    tail_a = [track(i) for i in range(6, n)]
    n_est = len(est)
    load_handler(str(tmp_path / "ckpt"), handler)
    tail_b = [track(i) for i in range(6, n)]
    np.testing.assert_allclose(np.array(tail_a), np.array(tail_b), atol=1e-6)
    ate = ate_rmse(np.array(est[:n_est]), np.array(gt[:n_est]))
    assert ate < 0.25, ate
