"""The harness's arithmetic on hand-made inputs: the closed orbits, the
traverse over the tiling texture, the union of device intervals, the per-range attribution and the readers, the
bounds, and the frozen reference against the port's plain versions."""

import math

import numpy as np
import pytest
import torch

from svo_bench import cells, check, trace
from svo_bench.reference import bounds, patches, pose, scene, trajectory

TRAFFIC = {"preroll_frames": 4, "preroll_step": 0.15, "lap_frames": 148,
           "lap_step": 6, "phase_spacing": 11, "radius": [0.5, 0.16],
           "height": -3.0, "pitch": 0.45,
           "turn_rate": [0.0008, -0.0008, 0.001]}


def _step(a, b):
    (qa, ta), (qb, tb) = a, b
    dq = 1.0 - abs(float(np.dot(qa, qb)))
    return float(np.linalg.norm(np.subtract(ta, tb))), dq


@pytest.mark.parametrize("s", [0, 5, 10])
def test_a_closed_orbit_leads_its_last_pose_into_its_first(s):
    phase0 = scene.phase_offset(4_294_967_311)
    n = scene.lap_frames(TRAFFIC, s)
    assert n == 148 - 6 * s
    lap = scene.lap_poses(TRAFFIC, s, phase0)
    assert scene.orbit_pose(TRAFFIC, s, n, phase0) == lap[0]
    seam = _step(lap[-1], lap[0])
    steps = [_step(a, b) for a, b in zip(lap, lap[1:])]
    assert min(d for d, _ in steps) * 0.9 <= seam[0] <= max(
        d for d, _ in steps) * 1.1
    assert seam[1] <= max(q for _, q in steps) * 1.1
    pre = scene.preroll_poses(TRAFFIC)
    d_pre = _step(pre[-1], lap[0])[0]
    assert d_pre == pytest.approx(0.15, rel=1e-6)


TRAVERSE = {"path": "traverse", "preroll_frames": 4, "preroll_step": 0.15,
            "lap_frames": 64, "sway": 0.16, "sway_cycles": 2,
            "height": -3.0, "pitch": 0.45,
            "turn_rate": [0.0008, -0.0008, 0.001], "texture_size": 256,
            "tex_scale": 100.0}


def test_a_traverse_moves_on_and_sees_its_first_lap_again():
    """A lap on, the traverse is one texture period further along x with
    the same rotation, it never steps back, and over the tiling texture
    it sees the image it saw a lap before."""
    phase0 = scene.phase_offset(4_294_967_311)
    lap = scene.lap_poses(TRAVERSE, 0, phase0)
    nxt = scene.traverse_pose(TRAVERSE, 0, len(lap), phase0)
    period = scene.texture_period(TRAVERSE)
    assert nxt[0] == pytest.approx(lap[0][0])
    assert np.subtract(nxt[1], lap[0][1]) == pytest.approx(
        [period, 0.0, 0.0])
    assert scene.lap_offset(TRAVERSE) == (period, 0.0, 0.0)
    xs = [p[1][0] for p in lap] + [nxt[1][0]]
    assert min(np.diff(xs)) > 0
    pre = scene.preroll_poses(TRAVERSE, lap[0])
    assert _step(pre[-1], lap[0])[0] == pytest.approx(0.15, rel=1e-6)
    cam = {"resolution": [64, 48], "intrinsics": [60.0, 60.0, 31.5, 23.5],
           "distortion_coefficients": [-0.28, 0.07, 0.0002, 0.00002]}
    rays = scene.camera_rays(cam, "cpu")
    tex = scene.make_texture(torch.Generator().manual_seed(5), 256,
                             periodic=True)
    a, b = (scene.render_poses(tex, rays, [p], (48, 64), 100.0, wrap=True)
            .int() for p in (lap[0], nxt))
    assert int((a - b).abs().max()) <= 1


def test_a_tiling_texture_has_no_seam():
    tex = scene.make_texture(torch.Generator().manual_seed(9), 128,
                             periodic=True)
    inner = (tex[:, 1:] - tex[:, :-1]).abs().max()
    assert float((tex[:, 0] - tex[:, -1]).abs().max()) <= float(inner)
    assert float((tex[0] - tex[-1]).abs().max()) <= float(
        (tex[1:] - tex[:-1]).abs().max())


def test_stretches_cover_every_frame():
    assert trajectory.stretches(50, 120) == [(0, 50)]
    assert trajectory.stretches(240, 120) == [(0, 120), (120, 240)]
    assert trajectory.stretches(300, 120) == [(0, 120), (120, 240),
                                              (180, 300)]


def test_the_worst_stretch_is_compared():
    """A pose altered in one stretch alone fails `ate_m`, where a median
    over the stretches would let it pass."""
    rng = np.random.default_rng(1)
    gt = np.cumsum(rng.normal(scale=0.02, size=(400, 3)), axis=0)
    est = 0.3 * gt + 2.0
    assert check.pose_numbers(est, gt)["ate_m"] < 1e-9
    est[250:300:2] += 0.3 * np.array([0.3, 0.0, 0.0])
    assert check.pose_numbers(est, gt)["ate_m"] > 0.02


def _pose_problem(seed=0, n=300):
    g = torch.Generator().manual_seed(seed)
    p_w = torch.rand(n, 3, generator=g, dtype=torch.float64) * torch.tensor(
        [4.0, 3.0, 0.0]) - torch.tensor([2.0, 1.5, 0.0])
    q_true = torch.tensor([0.97, 0.2, 0.05, -0.02], dtype=torch.float64)
    q_true = q_true / q_true.norm()
    t_true = -(pose.quat_to_matrix(q_true) @ torch.tensor(
        [0.1, -0.2, -3.0], dtype=torch.float64))
    xyz = p_w @ pose.quat_to_matrix(q_true).T + t_true
    f = xyz / xyz.norm(dim=-1, keepdim=True)
    f[:, :2] += torch.randn(n, 2, generator=g, dtype=torch.float64) * 1e-3
    level = torch.randint(0, 3, (n,), generator=g, dtype=torch.int32)
    valid = torch.rand(n, generator=g) < 0.9
    q0 = q_true + torch.tensor([0.0, 0.01, -0.01, 0.005], dtype=torch.float64)
    t0 = t_true + torch.tensor([0.03, -0.02, 0.05], dtype=torch.float64)
    return q0 / q0.norm(), t0, p_w, f, level, valid


def test_the_pose_reference_follows_the_ports_optimizer():
    """The frozen pose refinement (float64) against the port's
    `optimize_pose` (float32, CPU) on one problem: within a hundredth of
    a pixel, and the TF32 control far further off."""
    from android_svo_tpu_torch.config import SVOConfig
    from android_svo_tpu_torch.core.pose_opt import optimize_pose
    from android_svo_tpu_torch.geometry.se3 import SE3
    q0, t0, p_w, f, level, valid = _pose_problem()
    cfg = SVOConfig()
    out = optimize_pose(SE3(q=q0.float(), t=t0.float()), p_w.float(),
                        f.float(), level, valid, torch.tensor(458.654), cfg)
    rec = {"q0": q0.float(), "t0": t0.float(), "p_w": p_w.float(),
           "f_meas": f.float(), "level": level, "valid": valid,
           "focal": torch.tensor(458.654), "n_iter": cfg.poseoptim_n_iter,
           "method": cfg.poseoptim_method, "q": out[0].q, "t": out[0].t}
    assert check.pose_gap([rec]) < 1e-2
    assert check.pose_gap([rec], control=True) > 10 * max(
        check.pose_gap([rec]), 1e-3)
    moved = dict(rec, t=rec["t"] + torch.tensor([0.01, 0.0, 0.0]))
    assert check.pose_gap([moved]) > 1.0


def test_inputs_come_from_the_seed():
    cam = {"resolution": [64, 48], "intrinsics": [60.0, 60.0, 31.5, 23.5],
           "distortion_coefficients": [-0.28, 0.07, 0.0002, 0.00002]}
    rays = scene.camera_rays(cam, "cpu")

    def frames(seed):
        tex = scene.make_texture(torch.Generator().manual_seed(seed), 256)
        return scene.render_poses(tex, rays, scene.lap_poses(
            TRAFFIC, 0, scene.phase_offset(seed))[:3], (48, 64), 100.0)

    a, b, c = frames(2 ** 31 + 7), frames(2 ** 31 + 7), frames(2 ** 31 + 8)
    assert a.dtype == torch.uint8 and a.shape == (3, 48, 64)
    assert torch.equal(a, b) and not torch.equal(a, c)


def _ev(name, start, end, device=False, ident=0, annotation=False):
    return trace.Event(name, start, end, device, ident, annotation)


def test_the_stretch_reduces_to_busy_units_and_ranges():
    """Two frames of 100 us; a kernel overlaps a copy, so the union counts
    them once; the kernels launched inside `local_ba` are its own, even
    one that runs after the range has closed; the gap that opens inside
    `local_ba` is named after it."""
    ev = [_ev("svo_bench.frame", 0, 100, annotation=True),
          _ev("svo_bench.frame", 100, 200, annotation=True),
          _ev("local_ba", 130, 140, annotation=True),
          _ev("cudaLaunchKernel", 10, 11, ident=1),
          _ev("cudaMemcpyAsync", 12, 13, ident=2),
          _ev("cudaLaunchKernel", 131, 132, ident=3),
          _ev("cudaLaunchKernel", 139, 140, ident=4),
          _ev("k1", 20, 40, device=True, ident=1),
          _ev("Memcpy HtoD", 30, 50, device=True, ident=2),
          _ev("k2", 132, 136, device=True, ident=3),
          _ev("k2", 160, 180, device=True, ident=4),
          _ev("local_ba", 150, 170, device=True)]       # the range's span
    st = trace.reduce_events(ev, "svo_bench.frame")
    assert st["window_s"] == pytest.approx(200e-6)
    assert st["busy_s"] == pytest.approx(54e-6)   # 20-50, 132-136, 160-180
    assert [u["activities"] for u in st["units"]] == [2, 2]
    assert st["ranges"]["local_ba"] == [(2, 24.0)]
    assert st["linked_share"] == 1.0
    ctx = {"stretch": st, "stretch_keyframe": [False, True]}
    idle = cells.load_reader("idle_share.replay")(ctx)
    assert idle == pytest.approx(73.0)
    assert cells.load_reader("activities_per_frame")(ctx) == 2
    assert cells.load_reader("local_ba_activities")(ctx) == 2
    assert cells.load_reader("local_ba_device_ms")(ctx) == pytest.approx(
        0.024)
    gaps = dict(st["idle_gaps"])
    assert gaps["local_ba"] == pytest.approx(24e-6)      # 136-160
    assert gaps["host"] == pytest.approx(122e-6)
    assert sum(gaps.values()) == pytest.approx(146e-6)


def test_roofline_is_the_sum_of_least_over_the_sum_of_device_time():
    ctx = {"kernel_calls": [(1e-6, 4e-6), (3e-6, 6e-6), (5e-6, 0.0)]}
    got = cells.load_reader("kernel_roofline.replay")(ctx)
    assert got == pytest.approx(40.0)
    assert cells.load_reader("kernel_roofline.batch11")({"kernel_calls": []}) \
        is None


def _problem(n=40, b=None, seed=0):
    g = torch.Generator().manual_seed(seed)
    lead = (n,) if b is None else (b, n)
    stack = torch.rand(((b,) if b else ()) + (3, 64, 128), generator=g) * 255
    lvl = torch.randint(0, 3, lead, generator=g, dtype=torch.int32)
    uv = torch.rand(lead + (2,), generator=g) * torch.tensor([20.0, 10.0]) + 8
    return stack, lvl, uv, g


def test_sample_bound_counts_reads_writes_and_flops():
    stack, lvl, uv, _ = _problem()
    a = {"stack": stack, "lvl": lvl, "uv": uv, "half": 2, "grad": False,
         "valid": None}
    nbytes, flops = bounds.sample_patches(a)
    assert flops == 40 * 16 * 11
    assert nbytes == 40 * 25 * 4 + 40 * 12 + 40 * 16 * 4
    assert bounds.call_seconds("sample_patches", a) == pytest.approx(
        nbytes / bounds.HBM_BYTES_PER_S)


def test_the_reference_follows_the_ports_plain_versions():
    """The frozen reference (float64) against the port's plain versions
    (float32, CPU) on one problem: float32 rounding apart."""
    from android_svo_tpu_torch.ops import patch_kernels as pk
    stack, lvl, uv, g = _problem(b=2)
    got = pk.sample_patches_batched(stack, lvl, uv, 4, grad=True,
                                    use_pallas=False)
    ref = patches.sample_patches(stack, lvl, uv, 4, grad=True)
    for a, r in zip(got, ref):
        assert float((a.reshape(-1, 8, 8).double() - r).abs().max()) < 1e-3
    ref_p, dx, dy = (t.reshape(2, 40, 8, 8).float() for t in ref)
    valid = torch.ones(2, 40, dtype=torch.bool)
    init = uv + 0.7
    for kind, fn in (("align_iclk", pk.align_iclk_batched),
                     ("align_iclk_mxu", pk.align_iclk_mxu_batched)):
        out = fn(stack, lvl, ref_p, dx, dy, init, valid, 10, 64, 128,
                 use_pallas=False)
        a = {"stack": stack, "lvl": lvl, "ref_patch": ref_p, "ref_dx": dx,
             "ref_dy": dy, "init_uv": init, "valid": valid, "n_iter": 10,
             "h": 64, "w": 128, "zmssd_factor": None, "min_patch_std": None}
        got = check.judge_call(kind, a, out, check.reference_call(kind, a))
        assert got["iclk_flip_share"][0] <= 1
        assert got["iclk_uv_gap_px"][0] < 1e-3
    uv_b = uv + torch.tensor([6.0, 3.0])
    steps = torch.full((2, 40), 30, dtype=torch.int32)
    out = pk.epi_scan_batched(stack, lvl, uv, uv_b, ref_p, 100, 4, steps,
                              64, 128, use_pallas=False)
    a = {"stack": stack, "lvl": lvl, "uv_a": uv, "uv_b": uv_b,
         "ref_patch": ref_p, "n_steps_max": 100, "half": 4,
         "n_steps_each": steps, "h": 64, "w": 128}
    got = check.judge_call("epi_scan", a, out,
                           check.reference_call("epi_scan", a))
    assert got["scan_gap"][0] < 1e-5 and got["scan_flip_share"][0] == 0


def test_the_control_is_far_from_the_reference():
    stack, lvl, uv, _ = _problem(seed=3)
    a = {"stack": stack, "lvl": lvl, "uv": uv, "half": 4, "grad": True,
         "valid": None}
    got = check.kernel_numbers([("sample_patches", a, None)], control=True)
    assert got["sample_gap"] > 0.1


def test_ate_is_invariant_to_a_similarity():
    rng = np.random.default_rng(0)
    gt = rng.normal(size=(50, 3))
    c, s = math.cos(0.3), math.sin(0.3)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    est = (2.5 * (R @ gt.T)).T + 1.0
    assert trajectory.ate_rmse(est, gt) < 1e-12
    assert trajectory.ate_rmse(est[:2], gt[:2]) == float("inf")


def test_decide_fails_a_missing_or_infinite_number():
    ok, compared = check.decide({"a": 0.0, "b": float("inf")},
                                {"a": 0.0, "b": 1.0, "c": 1.0})
    assert not ok and compared["b"]["value"] is None
    assert compared["c"]["value"] is None and compared["a"]["value"] == 0.0
    assert check.decide({"a": 0.5}, {"a": 1.0}) == (
        True, {"a": {"value": 0.5, "limit": 1.0}})
