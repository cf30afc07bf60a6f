"""The radtan camera's kernels (`ops/camera_kernels.py`,
`csrc/camera_kernels.cu`) and their dispatch from
`geometry/camera.py::PinholeCamera`.

On the CPU: CPU tensors never reach the kernels (`LAUNCHES` stays 0) and
run the plain code, which is still the float64 inverse pair; the wrapper
module imports without a card and refuses what the kernels do not take
before it builds or launches anything; the ops' vmap rule gives the single
calls bit for bit; `cfg.use_pallas` reaches the camera's dispatch.

On the card (marked `cuda`, skipped without one; run as
`python -m pytest tests/test_torch_camera_kernel.py -q --noconftest -o
addopts=""`): the refusals on the card, and the launches of tracked frames,
none with `use_pallas` off.  The kernels against the plain versions, one
launch a call and under torch.func.vmap, are `silicon_gate.path_gate`'s
`camera_kernels` check, which `tests/test_torch_cuda.py::test_path_gate`
runs.
"""

from types import SimpleNamespace

import pytest
import torch

from android_svo_tpu_torch.config import SVOConfig
from android_svo_tpu_torch.core import frame_handler as fh
from android_svo_tpu_torch.geometry import camera as camera_mod
from android_svo_tpu_torch.ops import camera_kernels as ck
from android_svo_tpu_torch.ops import cuda_build, silicon_gate

EUROC = silicon_gate.CAMERA_COEFFS["euroc"]


def _launches():
    return sum(ck.LAUNCHES.values())


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("coeffs", list(silicon_gate.CAMERA_COEFFS))
@pytest.mark.parametrize("n", [1, 912])
def test_cpu_tensors_run_the_plain_code(coeffs, n):
    """Every form on CPU tensors (and under torch.func.vmap) equals the
    plain version bit for bit and launches nothing."""
    cam = silicon_gate.radtan_camera(coeffs, "cpu")
    ck.reset_launch_counts()
    for form, (fn, plain, _) in silicon_gate.camera_calls(
            cam, n, 3, "cpu").items():
        assert torch.equal(fn(), plain()), form
    px = torch.stack([silicon_gate.camera_pixels(cam, n, s, "cpu")
                      for s in range(3)])
    assert torch.equal(torch.func.vmap(cam.cam2world)(px),
                       torch.stack([cam.cam2world_plain(p) for p in px]))
    assert ck.LAUNCHES == {"camera_cam2world_kernel": 0,
                           "camera_world2cam_kernel": 0}


@pytest.mark.parametrize("coeffs", list(silicon_gate.CAMERA_COEFFS))
def test_plain_pair_is_the_float64_inverse(coeffs):
    """In float64, distort(undistort(x)) returns x within 1e-6 on the unit
    plane where undistort's 8 steps converge (|x| <= 0.5); the float32
    plain camera equals its float64 twin within rounding (1e-5 on bearings,
    1e-3 px) over the whole image, corners included."""
    cam32 = silicon_gate.radtan_camera(coeffs, "cpu")
    cam64 = camera_mod.PinholeCamera.create(
        cam32.width, cam32.height, *(float(v) for v in (
            cam32.fx, cam32.fy, cam32.cx, cam32.cy)),
        **silicon_gate.CAMERA_COEFFS[coeffs], dtype=torch.float64,
        device="cpu")
    g = torch.Generator().manual_seed(5)
    uv = (torch.rand(4096, 2, generator=g, dtype=torch.float64) - 0.5)
    uv = uv[uv.norm(dim=-1) <= 0.5]
    assert uv.shape[0] > 1000
    assert float((cam64.distort(cam64.undistort(uv)) - uv).abs().max()) \
        <= 1e-6
    px = silicon_gate.camera_pixels(cam32, 4096, 5, "cpu")
    f32, f64 = cam32.cam2world(px), cam64.cam2world(px.double())
    assert float((f32.double() - f64).abs().max()) <= 1e-5
    xyz = f64 * 3.0
    p32, p64 = cam32.world2cam(xyz.float()), cam64.world2cam(xyz)
    assert float((p32.double() - p64).abs().max()) <= 1e-3


def test_module_imports_without_a_card():
    """Importing the wrapper and the camera builds nothing and launches
    nothing; the two kernels are counted by name."""
    assert set(ck.LAUNCHES) == {"camera_cam2world_kernel",
                                "camera_world2cam_kernel"}
    assert {"launch_camera_cam2world", "launch_camera_world2cam"} <= set(
        cuda_build._SIGNATURES)
    if not torch.cuda.is_available():
        assert cuda_build._lib is None


@pytest.mark.parametrize("call", ["cam2world", "world2cam", "world2cam_uv"])
def test_wrapper_refuses_before_launching(call):
    """float64, a non-contiguous input, a wrong last dimension and a CPU
    tensor each raise before anything is built or launched."""
    cam = silicon_gate.radtan_camera("euroc", "cpu")
    width = 3 if call == "world2cam" else 2
    fn = {"cam2world": ck.cam2world,
          "world2cam": lambda x, *c: ck.world2cam(x, *c, True),
          "world2cam_uv": lambda x, *c: ck.world2cam(x, *c, False)}[call]
    ck.reset_launch_counts()
    with pytest.raises(TypeError, match="float32"):
        fn(torch.zeros(4, width, dtype=torch.float64), *cam._params())
    with pytest.raises(ValueError, match="contiguous"):
        fn(torch.zeros(width, 4).t(), *cam._params())
    with pytest.raises(ValueError, match="shape"):
        fn(torch.zeros(4, width + 1), *cam._params())
    with pytest.raises(ValueError, match="CUDA"):
        fn(torch.zeros(4, width), *cam._params())
    assert _launches() == 0


def test_vmap_rule_equals_single_calls():
    """The ops' vmap rule (`_vmap_rule`), held here with the plain version
    as the body the kernels take the place of: the batch, on any
    dimension, goes to the body as more rows in one call, and each
    sequence equals its single call bit for bit; a batched camera is
    refused."""
    cam = silicon_gate.radtan_camera("euroc", "cpu")
    px = torch.stack([silicon_gate.camera_pixels(cam, 64, s, "cpu")
                      for s in range(3)])
    calls = []

    def body(x, *camera):
        calls.append(tuple(x.shape))
        return camera_mod.PinholeCamera(*camera).cam2world_plain(x)

    rule = camera_mod._vmap_rule(body)
    info = SimpleNamespace(batch_size=3)
    unbatched = (None,) * 5
    out, out_dim = rule(info, (1,) + unbatched, px.movedim(0, 1),
                        *cam._params())
    assert out_dim == 0 and calls == [(3, 64, 2)]
    for b in range(3):
        assert torch.equal(out[b], cam.cam2world_plain(px[b]))
    with pytest.raises(NotImplementedError, match="one camera"):
        rule(info, (0, 0) + unbatched[1:], px, torch.stack([cam.fx] * 3),
             *cam._params()[1:])


@pytest.mark.parametrize("use_pallas,want", [(True, None), (False, False)])
def test_for_config_sets_the_dispatch(use_pallas, want):
    """`for_config` gives a PinholeCamera the config's dispatch argument
    (`cfg_use_pallas`): a distorted camera takes the kernels' path on CUDA
    tensors unless the knob is off, never on CPU tensors, and a
    distortion-free camera never; an ATANCamera is returned as it is."""
    cfg = SVOConfig(use_pallas=use_pallas)
    cuda_x, cpu_x = SimpleNamespace(is_cuda=True), torch.zeros(1, 2)
    cam = camera_mod.for_config(silicon_gate.radtan_camera("euroc", "cpu"),
                                cfg)
    assert cam.use_pallas is want
    assert cam._on_card(cuda_x) is use_pallas
    assert not cam._on_card(cpu_x)
    free = camera_mod.for_config(camera_mod.PinholeCamera.create(
        640, 480, 535.4, 539.2, 320.1, 247.6, device="cpu"), cfg)
    assert not free._on_card(cuda_x)
    atan = camera_mod.ATANCamera.create(752, 480, 450.0, 450.0, 376.0,
                                        240.0, 0.9, device="cpu")
    assert camera_mod.for_config(atan, cfg) is atan


def test_tracking_entry_points_hold_the_configured_camera():
    """FrameHandler holds its camera under its config's knob, and with the
    knob off its calls run the plain versions (on the CPU, bit for bit
    what the camera given computes)."""
    cam = silicon_gate.radtan_camera("euroc", "cpu")
    assert cam.use_pallas is None
    for use_pallas, want in ((True, None), (False, False)):
        handler = fh.FrameHandler(cam, SVOConfig(use_pallas=use_pallas),
                                  device="cpu")
        assert handler.cam.use_pallas is want
        assert cam.use_pallas is None
    px = silicon_gate.camera_pixels(cam, 64, 1, "cpu")
    assert torch.equal(handler.cam.cam2world(px), cam.cam2world(px))


@pytest.mark.parametrize("form,want", [
    ("cam2world", (0.0000055, "bytes", 18276, 207936)),
    ("world2cam", (0.0000055, "bytes", 18276, 29184)),
    ("world2cam_uv", (0.0000044, "bytes", 14628, 27360))])
def test_least_time_of_the_camera_kernels(form, want):
    """camera_bound gives the bounds PERF.md's kernel table records at the
    grid's 912 rows: bytes bind every form, far under a launch."""
    ms, by, n_bytes, flops = silicon_gate.camera_bound(912, form)
    assert (round(ms, 7), by, n_bytes, flops) == want


def test_distortion_free_camera_keeps_its_path():
    """A camera without distortion never takes the radtan kernels' path,
    on any device (`_on_card` false), and its plain calls are unchanged."""
    cam = camera_mod.PinholeCamera.create(640, 480, 535.4, 539.2, 320.1,
                                          247.6, device="cpu")
    assert cam.distortion_free and not cam._on_card(torch.zeros(1, 2))
    px = silicon_gate.camera_pixels(cam, 64, 0, "cpu")
    assert torch.equal(cam.cam2world(px), cam.cam2world_plain(px))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_refuse_on_the_card(card):
    """float64 and non-contiguous CUDA inputs and a camera left on the CPU
    raise before any launch; an empty input launches nothing."""
    cam = silicon_gate.radtan_camera("euroc", card)
    cpu_cam = silicon_gate.radtan_camera("euroc", "cpu")
    ck.reset_launch_counts()
    with pytest.raises(TypeError):
        ck.cam2world(torch.zeros(4, 2, dtype=torch.float64, device=card),
                     *cam._params())
    with pytest.raises(ValueError, match="contiguous"):
        ck.world2cam(torch.zeros(3, 4, device=card).t(), *cam._params(),
                     True)
    with pytest.raises(ValueError):
        ck.cam2world(torch.zeros(4, 2, device=card), *cpu_cam._params())
    out = cam.cam2world(torch.zeros(0, 2, device=card))
    assert out.shape == (0, 3) and _launches() == 0


def _replay_frames(cell: str, seed: int, frames: int):
    """The benchmark cell set up and warmed from `seed` as `svo_bench.run`
    does, then `frames` frames with the span recorder on: each frame's
    camera launches, whether it was a keyframe, and its counters."""
    from android_svo_tpu_torch.utils import profiling
    from svo_bench import cells, drivers
    c = cells.find_cell(cell)
    driver = drivers.ReplayDriver(c.config, c.traffic, seed,
                                  torch.device("cuda"), 1.0)
    rows = []
    try:
        driver.warm()
        mon = profiling.install()
        try:
            for _ in range(frames):
                before = dict(ck.LAUNCHES)
                u = driver.unit(False)
                rows.append((u["keyframe"], {k: ck.LAUNCHES[k] - before[k]
                                             for k in before}))
        finally:
            profiling.uninstall()
        distortion_free = driver.handler.cam.distortion_free
    finally:
        driver.close()
    return rows, mon.unit_counts[-frames:], distortion_free


@pytest.mark.cuda
def test_launches_of_a_tracked_replay_frame(card):
    """On the replay cell (EuRoC cam0, radtan) a frame that is not a
    keyframe makes 7 cam2world launches (two warp refreshes' 4,
    reprojection's 2, the epipolar search's 1) and 15 world2cam launches
    (alignment's 3 level set-ups, reprojection's 1, the keyframe decision's
    2, the warps' 6, the seed update's 1, the epipolar segment's 2), and 7
    host reads, as before the kernels; on the edgelet cell's
    distortion-free camera none."""
    rows, counts, free = _replay_frames("euroc_mh01_noloba.replay",
                                        3420000101, 8)
    assert not free
    plain = [launch for kf, launch in rows if not kf]
    assert plain and all(launch == {"camera_cam2world_kernel": 7,
                                    "camera_world2cam_kernel": 15}
                         for launch in plain), rows
    assert all(c.get("host_reads") == 7 for c in counts), counts
    rows, _, free = _replay_frames("tum_fr3_edgelet.replay", 3420000102, 4)
    assert free
    assert all(sum(launch.values()) == 0 for _, launch in rows), rows


@pytest.mark.cuda
def test_batched_step_launches_as_one_frame(card):
    """A batched step of 11 sequences through a radtan camera launches the
    camera kernels as often as one sequence's single frame from the same
    state (one launch a call, whatever the batch), and tracks as it does;
    with `use_pallas` off neither launches them."""
    from android_svo_tpu_torch.config import SVOConfig
    from android_svo_tpu_torch.core import pipeline
    from android_svo_tpu_torch.core import state as st
    from android_svo_tpu_torch.data import synthetic
    from android_svo_tpu_torch.parallel.multi_seq import make_batched_track
    cam = camera_mod.PinholeCamera.create(320, 240, 420.0, 420.0, 159.5,
                                          119.5, **EUROC, device=card)
    tex = synthetic.make_texture(torch.Generator().manual_seed(3), 1024,
                                 device=card)
    imgs = [synthetic.render(tex, cam, synthetic.lookdown_pose(
        0.05 * i, 0.015 * i, -3.0, (0.45 + 0.002 * i, -0.002 * i,
                                    0.004 * i), device=card))
            for i in range(11)]
    cfg = SVOConfig(init_min_disparity=20.0, loba_n_iter=0)
    handler = fh.FrameHandler(cam, cfg, device=card)
    for img in (imgs[0], imgs[4]):
        handler.add_image(img)
    assert handler.stage == fh.STAGE_DEFAULT_FRAME
    for img in imgs[5:10]:
        handler.add_image(img)
    track = make_batched_track(cfg, handler.cam, handler.dims)
    vo0 = handler.vo
    vo_b = st.stack_states([vo0] * 11)
    before = dict(ck.LAUNCHES)
    _, out = track(vo_b, torch.stack([imgs[10]] * 11))
    batched = {k: ck.LAUNCHES[k] - before[k] for k in before}
    before = dict(ck.LAUNCHES)
    res = handler.add_image(imgs[10]).result
    single = {k: ck.LAUNCHES[k] - before[k] for k in before}
    assert out["result"].tolist() == [res] * 11
    assert batched == single and sum(single.values()) >= 20, (batched,
                                                              single)
    plain = cfg.replace(use_pallas=False)
    before = _launches()
    track_p = make_batched_track(plain, cam, handler.dims)
    _, out_p = track_p(vo_b, torch.stack([imgs[10]] * 11))
    res_p = pipeline.make_track_frame(plain, cam, handler.dims)(
        vo0, imgs[10])[1]["result"]
    assert _launches() == before
    assert out_p["result"].tolist() == [int(res_p)] * 11
