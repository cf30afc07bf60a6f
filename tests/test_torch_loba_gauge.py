"""Local BA's monocular gauge (`parallel/ba.py`, `SVOConfig.
loba_fix_neighbour_kfs`): the port against the float64 reference
`svo_bench/reference/local_ba.py` on seeded scenes, with a lower-precision
control that must fail; the flag off as the JAX package's rule, bit for bit;
the window's scale held by the fixed neighbour keyframes and left free
without them; and a short tracking run with local BA after every keyframe.

Tolerances (`reference/local_ba.py::LIMITS`, set by the cell's calls on
the card, where fp32 reads up to 1.2e-2 of the camera twists of one
iteration, 9.8e-4 of the landmarks' move, and 7.4e-5 and 7.8e-4 after
five): limits 5e-2 and 5e-3 after one iteration, 2e-3 and 5e-3 after five.
On these scenes fp32 reads at most 1.8e-4, 5.6e-5, 1.4e-5 and 2.9e-5.  The
controls: the program's einsums with their operands rounded to TF32's
10-bit mantissa (as the card's tensor cores take them) part the landmarks
of one iteration by 1.0e-2 to 0.12; its landmark blocks rounded to
bfloat16 before their inversion part the twists by 4.1e-2 to 0.16 and the
landmarks by 7.2e-2 to 0.6: every scene fails a limit under each.
"""

import pytest
import torch

from android_svo_tpu_torch.config import SVOConfig
from android_svo_tpu_torch.core import frame_handler as fh
from android_svo_tpu_torch.geometry.camera import PinholeCamera
from android_svo_tpu_torch.geometry.se3 import SE3
from android_svo_tpu_torch.parallel import ba
from svo_bench import check
from svo_bench.reference import local_ba as ref
from svo_bench.reference import scene as sc
from svo_bench.reference import trajectory

torch.set_num_threads(1)

F64 = torch.float64
FOCAL = 300.0


def make_window(seed, K=10, P=120, O=6, n_core=5, dead=True):
    """K keyframes 0.25 apart along x at 3 units above a point cloud, each
    turned a little; each landmark seen by up to O of them (some slots
    empty), a few landmarks invalid; the cameras and landmarks perturbed.
    The core window is the n_core newest slots, the oldest of them fixed;
    with `dead` one keyframe outside the core is an evicted slot whose
    observations must be left out.  float32 inputs, as the program holds
    them."""
    g = torch.Generator().manual_seed(seed)
    pts = torch.cat([torch.rand(P, 2, generator=g, dtype=F64) * 3 - 1.5,
                     torch.rand(P, 1, generator=g, dtype=F64) * 0.6 - 0.3], 1)
    q, t = [], []
    for i in range(K):
        phi = (torch.rand(3, generator=g, dtype=F64) - 0.5) * 0.1
        rot = SE3.exp(torch.cat([torch.zeros(3, dtype=F64), phi])).q
        T = SE3(q=rot, t=torch.tensor([0.25 * i - 1.0, 0.05 * i, -3.0],
                                      dtype=F64)).inverse()
        q.append(T.q)
        t.append(T.t)
    q, t = torch.stack(q), torch.stack(t)
    obs_kf = torch.stack([torch.randperm(K, generator=g)[:O]
                          for _ in range(P)])
    obs_kf[torch.rand(P, O, generator=g) < 0.2] = -1
    ks = obs_kf.clamp(min=0)
    f = SE3(q=q[ks], t=t[ks]).apply(pts[:, None, :])
    f = f / f.norm(dim=-1, keepdim=True)
    f = f + torch.randn(f.shape, generator=g, dtype=F64) * 3e-4
    f = f / f.norm(dim=-1, keepdim=True)
    Tp = SE3.exp(torch.randn(K, 6, generator=g, dtype=F64) * 0.01).compose(
        SE3(q=q, t=t))
    kf_valid = torch.ones(K, dtype=torch.bool)
    if dead:
        kf_valid[1] = False
    f32 = torch.float32
    fixed = torch.zeros(n_core, dtype=torch.bool)
    fixed[0] = True
    return dict(pos=(pts + torch.randn(P, 3, generator=g, dtype=F64) * 0.03)
                .to(f32), valid=torch.rand(P, generator=g) > 0.1,
                obs_kf=obs_kf.to(torch.int32), obs_f=f.to(f32),
                q=Tp.q.to(f32), t=Tp.t.to(f32),
                core=torch.arange(K - n_core, K), fixed=fixed,
                kf_valid=kf_valid)


def run_port(w, n_iter, flag=True, **kw):
    """The port's `local_ba` on the window; with the camera twists of its
    first iteration under `dx` (read from `_ba_solve`)."""
    cfg = SVOConfig(loba_n_iter=n_iter, loba_fix_neighbour_kfs=flag)
    dxs, solve = [], ba._ba_solve

    def spy(*args):
        dxs.append(solve(*args))
        return dxs[-1]

    ba._ba_solve = spy
    try:
        q, t, pos, chi2 = ba.local_ba(
            w["pos"], w["valid"], w["obs_kf"], w["obs_f"], w["q"], w["t"],
            w["core"], w["fixed"], torch.tensor(FOCAL), cfg, **kw)
    finally:
        ba._ba_solve = solve
    return dict(q=q, t=t, pos=pos, chi2=chi2, dx=dxs[0] if dxs else None)


def run_ref(w, n_iter):
    return ref.local_ba(w["pos"], w["valid"], w["obs_kf"], w["obs_f"],
                        w["q"], w["t"], w["core"], w["fixed"], FOCAL, 1.0,
                        n_iter, w["kf_valid"])


def held(w, got, want, n_iter):
    """The gaps `LIMITS` names: after 1 iteration the camera twists and
    the landmarks, after 5 the stored poses and landmarks."""
    if n_iter == 1:
        return {"cam_gap": ref.increment_gap(got["dx"], want["dx"][0]),
                "point_gap": ref.gaps(w, got, want, w["core"])["point_gap"]}
    g = ref.gaps(w, got, want, w["core"], floor=ref.POSE_FLOOR)
    return {k: g[k] for k in ("cam_gap", "point_gap")}


def _tf32(x):
    """fp32 values rounded to TF32's 10-bit mantissa (to nearest)."""
    if x.dtype != torch.float32:
        return x
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _failing(g, n_iter):
    return [k for k, lim in ref.LIMITS[n_iter].items() if not g[k] <= lim]


@pytest.mark.parametrize("n_iter", [1, 5])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_port_matches_the_float64_reference(seed, n_iter):
    """(a) With the flag, the port's cameras and landmarks lie within the
    limits of the reference's."""
    w = make_window(seed)
    want = run_ref(w, n_iter)
    got = run_port(w, n_iter, kf_valid=w["kf_valid"])
    g = held(w, got, want, n_iter)
    assert _failing(g, n_iter) == [], g
    assert float(got["chi2"]) == pytest.approx(float(want["chi2"]),
                                               rel=1e-5)
    # the anchor, the keyframes outside the core and the invalid landmarks
    # keep their values
    keep = torch.ones(w["q"].shape[0], dtype=torch.bool)
    keep[w["core"][1:]] = False
    assert torch.equal(got["q"][keep], w["q"][keep])
    assert torch.equal(got["pos"][~w["valid"]], w["pos"][~w["valid"]])


def _bf16_blocks(monkeypatch):
    """The landmark blocks U_p rounded to bfloat16 before their
    inversion."""
    inv = ba.inv_spd
    monkeypatch.setattr(ba, "inv_spd", lambda U: inv(
        U.to(torch.bfloat16).to(U.dtype)))


def _tf32_einsums(monkeypatch):
    """Every einsum of the program with its operands in TF32, accumulating
    in fp32."""
    einsum = torch.einsum
    monkeypatch.setattr(torch, "einsum", lambda eq, *ops: einsum(
        eq, *[_tf32(o) for o in ops]))


@pytest.mark.parametrize("control", [_tf32_einsums, _bf16_blocks],
                         ids=["tf32_einsums", "bf16_point_blocks"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_lower_precision_fails_the_limits(seed, control, monkeypatch):
    """(a) The controls, one precision down in the program's place, miss
    the reference's first iteration by more than a limit."""
    w = make_window(seed)
    want = run_ref(w, 1)
    control(monkeypatch)
    ctl = held(w, run_port(w, 1, kf_valid=w["kf_valid"]), want, 1)
    assert _failing(ctl, 1), ctl


def test_dead_keyframes_are_left_out():
    """An evicted slot's observations enter neither side: the port with
    `kf_valid` matches the reference, and without it (every slot live)
    misses the reference by more than the limit."""
    w = make_window(4)
    for n_iter in (1, 5):
        want = run_ref(w, n_iter)
        assert _failing(held(w, run_port(w, n_iter, kf_valid=w["kf_valid"]),
                             want, n_iter), n_iter) == []
        assert _failing(held(w, run_port(w, n_iter), want, n_iter), n_iter)


def _old_rule(w, n_iter):
    """The JAX package's rule spelled out with the module's own parts:
    only the core keyframes' observations enter."""
    cfg = SVOConfig(loba_n_iter=n_iter)
    core = w["core"].to(torch.int64)
    is_core = w["obs_kf"][:, :, None] == core[None, None, :]
    obs_ok = (is_core.any(-1) & (w["obs_kf"] >= 0)) & w["valid"][:, None]
    q, t, pos = w["q"], w["t"], w["pos"]
    width = cfg.loba_robust_huber_width / torch.tensor(FOCAL)
    for _ in range(n_iter):
        sums, local = ba._ba_partials(pos, w["obs_f"], obs_ok,
                                      is_core.to(pos.dtype), q, t,
                                      w["obs_kf"], width)
        dxc = ba._ba_solve(*sums[:4], w["fixed"])
        q, t, pos = ba._ba_update(pos, w["valid"], local, dxc, q, t, core)
    return dict(q=q, t=t, pos=pos, chi2=sums[4])


@pytest.mark.parametrize("n_iter", [1, 5])
def test_flag_off_is_the_jax_rule_bit_for_bit(n_iter):
    """(b) Off, `local_ba` is the core-only rule bit for bit, with or
    without `kf_valid`, and the observations of keyframes outside the core
    move nothing; on, they do."""
    w = make_window(5)
    want = _old_rule(w, n_iter)
    for kw in ({}, {"kf_valid": w["kf_valid"]}):
        got = run_port(w, n_iter, flag=False, **kw)
        for k in ("q", "t", "pos", "chi2"):
            assert torch.equal(got[k], want[k]), k
    outside = ~torch.isin(w["obs_kf"].to(torch.int64), w["core"]) \
        & (w["obs_kf"] >= 0)
    moved = dict(w, obs_f=torch.where(outside[..., None],
                                      w["obs_f"].roll(1, 0), w["obs_f"]))
    off = run_port(moved, n_iter, flag=False)
    assert all(torch.equal(off[k], want[k]) for k in ("q", "t", "pos"))
    on = run_port(moved, n_iter)
    assert not torch.equal(on["pos"], run_port(w, n_iter)["pos"])


def scaled_window(s=1.1, K=10, n_core=5):
    """Keyframes 0.3 apart along x looking down at a strip of landmarks,
    each seen (without noise) by every keyframe within 1.2 of it along x,
    up to 8; then the core window (the 5 newest, the oldest of them the
    fixed anchor) and the landmarks it sees scaled by s about the anchor's
    centre: the direction of the gauge that one fixed core camera leaves
    free, since the core's own observations fit it exactly.  Returns the
    window and the true camera centres and landmark positions."""
    g = torch.Generator().manual_seed(9)
    P, O = 200, 8
    cen = torch.stack([torch.tensor([0.3 * i, 0.0, -3.0], dtype=F64)
                       for i in range(K)])
    pts = torch.cat([torch.rand(P, 1, generator=g, dtype=F64) * 3.9 - 0.6,
                     torch.rand(P, 1, generator=g, dtype=F64) * 2 - 1,
                     torch.rand(P, 1, generator=g, dtype=F64) * 0.6 - 0.3], 1)
    near = (pts[:, None, 0] - cen[None, :, 0]).abs() < 1.2        # (P,K)
    rank = torch.cumsum(near.to(torch.int64), 1)
    near &= rank <= O
    obs_kf = torch.full((P, O), -1, dtype=torch.int64)
    for p in range(P):
        ks = torch.nonzero(near[p])[:, 0]
        obs_kf[p, :len(ks)] = ks
    f = pts[:, None, :] - cen[obs_kf.clamp(min=0)]
    f = f / f.norm(dim=-1, keepdim=True)
    core = torch.arange(K - n_core, K)
    seen_by_core = torch.isin(obs_kf, core).any(1)
    anchor = cen[core[0]]
    cen_p = cen.clone()
    cen_p[core] = anchor + s * (cen[core] - anchor)
    pos = torch.where(seen_by_core[:, None], anchor + s * (pts - anchor), pts)
    q = torch.tensor([1.0, 0, 0, 0], dtype=F64).expand(K, 4)
    fixed = torch.zeros(n_core, dtype=torch.bool)
    fixed[0] = True
    f32 = torch.float32
    w = dict(pos=pos.to(f32), valid=seen_by_core & ((obs_kf >= 0).sum(1) >= 2),
             obs_kf=obs_kf.to(torch.int32), obs_f=f.to(f32),
             q=q.to(f32), t=(-cen_p).to(f32), core=core, fixed=fixed)
    return w, cen, pts


def window_scale(w, got, cen, pts):
    """The Sim(3) scale that lays the core cameras' centres and the
    refined landmarks on the truth (1 for a window at the true scale)."""
    c = SE3(q=got["q"][w["core"]].to(F64), t=got["t"][w["core"]].to(F64)
            ).inverse().t
    est = torch.cat([c, got["pos"][w["valid"]].to(F64)]).numpy()
    gt = torch.cat([cen[w["core"]], pts[w["valid"]]]).numpy()
    return trajectory.umeyama_alignment(est, gt)[0]


def test_fixed_neighbours_hold_the_scale():
    """(c) A core window 10% too large: with the flag the fixed neighbour
    keyframes pull its Sim(3) scale back within 1% of the truth in one
    call; without it the scale stays where it was (the fault: the core's
    observations fit any scale about the anchor)."""
    w, cen, pts = scaled_window()
    before = window_scale(w, dict(q=w["q"], t=w["t"], pos=w["pos"]), cen, pts)
    assert before == pytest.approx(1 / 1.1, rel=1e-5)
    on = window_scale(w, run_port(w, 5), cen, pts)
    off = window_scale(w, run_port(w, 5, flag=False), cen, pts)
    assert abs(on - 1.0) < 0.01, on
    assert abs(off - before) < 1e-3 and abs(off - 1.0) > 0.05, off


@pytest.mark.parametrize("n_live,want", [(3, [1]), (5, [3]), (6, []),
                                         (9, [])])
def test_second_anchor_only_before_any_neighbour(n_live, want):
    """With the flag the handler fixes the second farthest live core camera
    as well while every live keyframe is in the core (no neighbour holds
    the scale then), and only then; the core is in
    `select_core_keyframes`' order, live slots nearest first."""
    K = 8
    kf_valid = torch.zeros(K, dtype=torch.bool)
    kf_valid[:n_live] = True
    t = torch.zeros(K, 3)
    t[:, 0] = torch.arange(K, dtype=torch.float32)
    cam = SE3(q=torch.tensor([1.0, 0, 0, 0]), t=torch.tensor([0.0, 0, 0]))
    core, fixed = ba.select_core_keyframes(
        torch.tensor([1.0, 0, 0, 0]).expand(K, 4), t, kf_valid, cam, 5)
    extra = fh._second_anchor(kf_valid, core)
    assert torch.nonzero(extra)[:, 0].tolist() == want
    assert not (extra & fixed).any()


# (d): EuRoC cam0 at half size on the benchmark's fast traverse
W2, H2 = 376, 240
CAM0 = {"resolution": [W2, H2],
        "intrinsics": [458.654 / 2, 457.296 / 2, 367.715 / 2 - 0.5,
                       248.875 / 2 - 0.5],
        "distortion_coefficients": [-0.28340811, 0.07395907, 0.00019359,
                                    1.76187114e-05]}
FAST = {"path": "traverse", "preroll_frames": 4, "preroll_step": 0.15,
        "lap_frames": 256, "sway": 0.16, "sway_cycles": 2, "height": -3.0,
        "pitch": 0.45, "turn_rate": [0.002, -0.002, 0.0025],
        "texture_size": 1024, "tex_scale": 100.0}
N_TRACK = 64


def test_tracking_with_local_ba_holds_the_stated_accuracy():
    """(d) Local BA after every keyframe, its gauge held by the fixed
    neighbours, on the fast traverse: no failure, local BA on every
    keyframe, and the tracked positions' ATE within the stated 0.02 of
    each 120-frame stretch (one stretch here)."""
    tex = sc.make_texture(torch.Generator().manual_seed(21), 1024, True)
    lap = sc.lap_poses(FAST, 0, 0.7)[:N_TRACK]
    poses = sc.preroll_poses(FAST, lap[0]) + lap
    frames = sc.render_poses(tex, sc.camera_rays(CAM0, "cpu"), poses,
                             (H2, W2), 100.0, wrap=True)
    cam = PinholeCamera.create(W2, H2, *CAM0["intrinsics"],
                               *CAM0["distortion_coefficients"],
                               device="cpu")
    cfg = SVOConfig(loba_fix_neighbour_kfs=True, init_min_disparity=20.0,
                    max_points=2048, max_seeds=512, ransac_n_trials=64)
    handler = fh.FrameHandler(cam, cfg, device="cpu")
    est, gt, kfs = [], [], 0
    for i, img in enumerate(frames):
        res = handler.add_image(img)
        if handler.stage != fh.STAGE_DEFAULT_FRAME or res.t_wc is None:
            assert i < 8, f"frame {i} lost"
            continue
        assert res.result != fh.pipeline.RES_FAILURE, i
        kfs += res.result == fh.pipeline.RES_IS_KEYFRAME
        est.append(res.t_wc.reshape(-1).tolist())
        gt.append(poses[i][1])
    assert handler.n_local_ba == kfs - 1 >= 6      # the bootstrap's aside
    (ate, _), = trajectory.stretch_ates(est, gt, check.STRETCH)
    assert ate <= 0.02, ate
