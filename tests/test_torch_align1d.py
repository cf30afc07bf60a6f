"""The port's 1D alignment (`ops/matcher.py::align1d_stack`, plain path)
and the 1D branch of `find_epipolar_match` (`epi_search_1d`) against the
benchmark's plain float64 reference (`svo_bench/reference/align1d.py`),
on seeded random images at a small size; the reference one precision
down (bfloat16 image data on float32 coordinates) fails the same
tolerances.

Tolerances, over the valid rows of four seeds:
  UV_TOL    widest distance between the program's uv and the reference's
            where both converge, level pixels: float32 against float64
            reads up to 0.0083 px here (a row that starts near the edge of
            its basin wanders and amplifies the rounding); the control
            reads 1.3 px or more on every seed
  FLIP_TOL  share of rows whose `converged` differs, pooled: a flip needs
            a row to end within rounding of the level's margin or of the
            drift limit (one patch width); the program flips 1 row in
            29,503 (3.4e-5), the control 13 (4.4e-4)
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from android_svo_tpu_torch.config import SVOConfig
from android_svo_tpu_torch.data import synthetic
from android_svo_tpu_torch.ops import matcher
from android_svo_tpu_torch.ops import patch_kernels as pk
from android_svo_tpu_torch.ops.feature_align import patch_gradients
from svo_bench.reference import align1d as ref
from svo_bench.reference import patches

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
UV_TOL = 0.05
FLIP_TOL = 1.5e-4
SEEDS = (0, 1, 2, 3)
N_ITER = 10


def problem(seed: int, n: int = 8192, h: int = 96, w: int = 128,
            levels: int = 3):
    """Reference patches cut (with their border, for the gradients) from a
    smooth random image at random rows, levels and unit directions, each
    alignment started up to 8 px (one patch width) along its direction
    from the patch's own position; a tenth of the rows invalid."""
    g = torch.Generator().manual_seed(seed)
    base = torch.rand((1, 1, h // 8, w // 8), generator=g)
    img = torch.nn.functional.interpolate(base, size=(h, w), mode="bicubic",
                                          align_corners=False)[0, 0]
    img = (img * 255).clamp(0, 255).round()
    stack = patches.build_stack(img.double(), levels).float()
    lvl = torch.randint(0, levels, (n,), generator=g, dtype=torch.int32)
    wl, hl = (w >> lvl).float(), (h >> lvl).float()
    uv = torch.stack([6 + torch.rand(n, generator=g) * (wl - 13),
                      6 + torch.rand(n, generator=g) * (hl - 13)], -1)
    ang = torch.rand(n, generator=g) * 6.2832
    direction = torch.stack([ang.cos(), ang.sin()], -1)
    shift = (torch.rand(n, generator=g) - 0.5) * 16.0
    border = pk.sample_patches(stack, lvl, uv, 5, use_pallas=False)
    ref_patch, gx, gy = patch_gradients(border)
    init = uv + shift[:, None] * direction
    valid = torch.rand(n, generator=g) < 0.9
    return (stack, lvl, ref_patch, gx, gy, direction, init, valid, N_ITER,
            h, w)


@pytest.fixture(scope="module")
def readings():
    """Per seed: the program's and the control's gaps to the reference."""
    out = []
    for seed in SEEDS:
        args = problem(seed)
        valid = args[7]
        got = matcher.align1d_stack(*args, use_pallas=False)
        want = ref.align1d(*args)
        ctl = ref.align1d(*args, *ref.CONTROL)
        out.append((ref.gaps(got, want, valid), ref.gaps(ctl, want, valid)))
    return out


def _pooled_flips(parts):
    rows = sum(p["rows"] for p in parts)
    return sum(p["flip_share"] * p["rows"] for p in parts) / rows


@pytest.mark.parametrize("i", range(len(SEEDS)))
def test_align1d_stack_holds_to_the_reference(readings, i):
    prog, _ = readings[i]
    assert prog["both"] >= 0.6 * prog["rows"]
    assert prog["uv_gap_px"] <= UV_TOL, prog


def test_align1d_stack_flips_few_rows(readings):
    assert _pooled_flips([p for p, _ in readings]) <= FLIP_TOL


@pytest.mark.parametrize("i", range(len(SEEDS)))
def test_the_control_fails_the_uv_tolerance(readings, i):
    _, ctl = readings[i]
    assert ctl["uv_gap_px"] > UV_TOL, ctl


def test_the_control_fails_the_flip_tolerance(readings):
    assert _pooled_flips([c for _, c in readings]) > FLIP_TOL


W, H = 320, 240


@pytest.fixture(scope="module")
def epipolar():
    """find_epipolar_match with `epi_search_1d` on two rendered views of
    the edge-rich plane, every `align1d_stack` call it makes captured:
    (the calls, find_epipolar_match's outputs, the search levels, and the
    camera, bearings, true depths and relative pose)."""
    cam = synthetic.default_camera(W, H, device="cpu")
    tex = synthetic.make_edge_texture(torch.Generator().manual_seed(7), 1024,
                                      device="cpu")
    poses = [synthetic.lookdown_pose(0.04 * i, 0.012 * i, -3.0,
                                     (0.45 + 0.002 * i, -0.002 * i, 0.0),
                                     device="cpu") for i in range(2)]
    imgs = [synthetic.render(tex, cam, p) for p in poses]
    stk = [patches.build_stack(im.double(), 5).float() for im in imgs]
    g = torch.Generator().manual_seed(6)
    n = 256
    px = 30 + torch.rand((n, 2), generator=g) * torch.tensor([W - 60.0,
                                                               H - 60.0])
    lvl = torch.randint(0, 3, (n,), generator=g, dtype=torch.int32)
    f = cam.cam2world(px)
    d = synthetic.true_depth(cam, poses[0], px)
    T = poses[1].inverse().compose(poses[0])
    kf = torch.zeros(n, dtype=torch.int32)
    valid = torch.ones(n, dtype=torch.bool)
    cfg = SVOConfig(epi_search_1d=True)
    kf_stack = stk[0][None]
    pb, sl, _, ok = matcher.compute_warp_batch(kf_stack, kf, cam, px, f, d,
                                               lvl, T, valid, cfg)
    calls = []
    orig = matcher.align1d_stack

    def captured(*args, **kw):
        out = orig(*args, **kw)
        calls.append((args, kw, out))
        return out

    matcher.align1d_stack = captured
    try:
        depth, px_cur, success = matcher.find_epipolar_match(
            stk[1], kf_stack, kf, cam, px, f, lvl, T, d, d * 0.8, d * 1.25,
            ok, cfg, cached=(pb, sl))
    finally:
        matcher.align1d_stack = orig
    return calls, (depth, px_cur, success), sl, (cam, f, d, T)


def test_the_1d_branch_holds_to_the_reference(epipolar):
    """One `align1d_stack` call, `subpix_n_iter` iterations; its uv,
    scaled to level 0, is the match, and each match comes from a row that
    converged; the call against the reference within the tolerances, and
    the control outside them."""
    calls, (_, px_cur, success), sl, (cam, f, d, T) = epipolar
    assert len(calls) == 1
    args, _, (uv, conv, _) = calls[0]
    assert args[8] == SVOConfig().subpix_n_iter
    scale = 2.0 ** torch.clamp(sl, 0, 2).float()
    assert torch.equal(px_cur, uv * scale[:, None])
    assert bool((conv | ~success).all()) and int(success.sum()) >= 0.5 * len(d)
    # the matches lie near the truth (1D refinement accepts every row that
    # stays inside the margin and within a patch width: the median, not
    # the worst)
    truth = cam.world2cam(T.apply(f * d[:, None]))
    err = torch.linalg.norm(px_cur[success] - truth[success], dim=-1)
    assert float(err.median()) < 1.0
    valid = args[7]
    want = ref.align1d(*args)
    prog = ref.gaps((uv, conv), want, valid)
    assert prog["uv_gap_px"] <= UV_TOL and prog["flip_share"] == 0.0, prog
    ctl = ref.gaps(ref.align1d(*args, *ref.CONTROL), want, valid)
    assert ctl["uv_gap_px"] > UV_TOL, ctl


def test_the_reference_imports_neither_jax_nor_the_port():
    path = ROOT / "svo_bench" / "reference" / "align1d.py"
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "torch", "svo_bench"}, names
    code = ("import sys, svo_bench.reference.align1d; "
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'android_svo_tpu', 'android_svo_tpu_torch'}; "
            "print(sorted(bad)); sys.exit(1 if bad else 0)")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr
