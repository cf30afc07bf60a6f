"""The port's gather probe (`ops/gather_probe.py`) against the JAX package's
three Pallas probe kernels, run in TPU interpret mode on the CPU with the
scripts' own BlockSpecs (in a process of their own,
`tests/_probe_pallas_worker.py`), on seeded numpy inputs at 480x640.

Tolerances: the plain version repeats the probes' arithmetic (weights from
uv - floor(uv) once per feature), so it matches them to 1e-5; against
`interp.extract_patches`, which floors every tap's own coordinate, the
weights round differently (2.5e-5 measured), so that check is held to 1e-4.
"""

import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from android_svo_tpu.ops import interp as jinterp

from android_svo_tpu_torch.ops import gather_probe, interp

# The tensors here are small and the suite's workers share the machine's
# cores: one intra-op thread per process keeps torch's OpenMP pools from
# oversubscribing them (they slow every worker, the JAX ones included).
torch.set_num_threads(1)

WORKER = pathlib.Path(__file__).resolve().parent / "_probe_pallas_worker.py"
H, W = 480, 640
N = 256
P = gather_probe.P


def _inputs(seed, lo, hi_margin):
    """The scripts' image (uniform [0, 1)) and uv ranges: x in
    [lo, W - hi_margin), y in [lo, H - hi_margin)."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.0, 1.0, (H, W)).astype(np.float32)
    uv = np.stack([rng.uniform(lo, W - hi_margin, N),
                   rng.uniform(lo, H - hi_margin, N)], -1).astype(np.float32)
    return img, uv


# per case: the inputs' seed (the scripts' ranges: probe_pallas_variants.py
# :99-102 and probe_pallas_patch.py:80-83, both [5.5, size-6.5))
CASES = {"A": 1, "B": 1, "C": 1, "D": 1, "roll": 2}


@pytest.fixture(scope="module")
def jax_twins(tmp_path_factory):
    """{case: (img, uv, JAX twin's patches)} from one worker process."""
    tmp = tmp_path_factory.mktemp("probe_twins")
    inputs = {case: _inputs(seed, 5.5, 6.5) for case, seed in CASES.items()}
    np.savez(tmp / "in.npz",
             **{f"img_{c}": v[0] for c, v in inputs.items()},
             **{f"uv_{c}": v[1] for c, v in inputs.items()})
    proc = subprocess.run([sys.executable, str(WORKER), str(tmp / "in.npz"),
                           str(tmp / "out.npz")], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = np.load(tmp / "out.npz")
    return {c: (*inputs[c], out[c]) for c in CASES}


def _port(img, uv, variant):
    return gather_probe.probe_patches(torch.from_numpy(img),
                                      torch.from_numpy(uv), variant).numpy()


@pytest.mark.parametrize("variant", gather_probe.VARIANTS)
def test_variants_match_jax_twins(jax_twins, variant):
    """probe_pallas_variants.py::make_kernel(variant)."""
    img, uv, ref = jax_twins[variant]
    got = _port(img, uv, variant)
    assert got.shape == ref.shape == (N, P, P)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_variant_a_matches_aligned_roll_kernel(jax_twins):
    """probe_pallas_patch.py::_kernel (aligned window + two rolls)."""
    img, uv, ref = jax_twins["roll"]
    np.testing.assert_allclose(_port(img, uv, "A"), ref, atol=1e-5, rtol=0)


def test_variant_a_matches_extract_patches():
    """microbench_gather.py's check of its window-slice kernel against the
    XLA gather, on its uv range [10, W-10) (microbench_gather.py:45-48)."""
    img, uv = _inputs(3, 10.0, 10.0)
    ref = np.asarray(jinterp.extract_patches(jnp.asarray(img),
                                             jnp.asarray(uv), P // 2))
    got = _port(img, uv, "A")
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    # and the port's own extract_patches agrees with JAX's
    own = interp.extract_patches(torch.from_numpy(img), torch.from_numpy(uv),
                                 P // 2).numpy()
    np.testing.assert_allclose(own, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("variant", gather_probe.VARIANTS)
def test_reads_clamp_outside_the_image(variant):
    """Off the scripts' ranges every read clamps to the border: finite
    output equal to a direct per-pixel clamped bilinear."""
    rng = np.random.default_rng(4)
    img = rng.uniform(0.0, 1.0, (40, 300)).astype(np.float32)
    uv = np.array([[-30.2, -7.9], [299.6, 45.1], [3.5, 1.25],
                   [150.0, 20.0]], np.float32)
    got = _port(img, uv, variant)
    oy, ox = gather_probe.window_origin(torch.from_numpy(uv), variant,
                                        40, 300)
    for i in range(len(uv)):
        wx = uv[i, 0] - np.floor(uv[i, 0])
        wy = uv[i, 1] - np.floor(uv[i, 1])
        for r in range(P):
            for c in range(P):
                y0, y1 = (np.clip(int(oy[i]) + r + d, 0, 39) for d in (0, 1))
                x0, x1 = (np.clip(int(ox[i]) + c + d, 0, 299)
                          for d in (0, 1))
                want = ((1 - wy) * ((1 - wx) * img[y0, x0]
                                    + wx * img[y0, x1])
                        + wy * ((1 - wx) * img[y1, x0] + wx * img[y1, x1]))
                assert abs(got[i, r, c] - want) < 1e-6


def test_unknown_variant_raises():
    with pytest.raises(ValueError, match="variant"):
        gather_probe.probe_patches(torch.zeros(16, 16), torch.zeros(1, 2),
                                   "E")


def _staged_lerp(img, uv, variant):
    """The kernel's schedule in PyTorch: stage each feature's clamped 9x9
    window once (element e = (e // 9, e % 9) from the variant's origin),
    then lerp every output pixel from tile entries [r][c], [r][c+1],
    [r+1][c] and [r+1][c+1] with the weights taken once per feature."""
    h, w = img.shape
    t = P + 1
    oy, ox = gather_probe.window_origin(uv, variant, h, w)
    e = torch.arange(t * t)
    rows = (oy[:, None] + e // t).clamp(0, h - 1)
    cols = (ox[:, None] + e % t).clamp(0, w - 1)
    tile = img[rows, cols].reshape(-1, t, t)
    p = torch.arange(P * P)
    r, c = p // P, p % P
    wx = (uv[:, 0] - torch.floor(uv[:, 0]))[:, None]
    wy = (uv[:, 1] - torch.floor(uv[:, 1]))[:, None]
    top = (1 - wx) * tile[:, r, c] + wx * tile[:, r, c + 1]
    bot = (1 - wx) * tile[:, r + 1, c] + wx * tile[:, r + 1, c + 1]
    return ((1 - wy) * top + wy * bot).reshape(-1, P, P)


def _uv_set(name):
    """The scripts' range; borders and off-image; NaN and +-1e6 (mixed
    with finite coordinates, so both kinds of row occur)."""
    rng = np.random.default_rng(5)
    if name == "scripts":
        return _inputs(5, 5.5, 6.5)[1]
    if name == "borders":
        xs = np.array([-40.7, -9.0, -4.5, -0.25, 0.0, 0.5, 3.99, 127.5,
                       255.9, W - 8.5, W - 4.0, W - 1.0, W - 0.01, W + 0.5,
                       W + 3.0, W + 55.2], np.float32)
        ys = np.array([-33.3, -8.0, -4.01, -0.75, 0.0, 1.5, 7.5, 15.99,
                       H - 9.5, H - 5.0, H - 1.0, H - 0.5, H, H + 2.25,
                       H + 8.0, H + 71.6], np.float32)
        grid = np.stack(np.meshgrid(xs, ys, indexing="ij"), -1)
        return grid.reshape(-1, 2).astype(np.float32)
    specials = np.array([np.nan, 1e6, -1e6], np.float32)
    uv = _inputs(6, 5.5, 6.5)[1][:64].copy()
    uv[0::4, 0] = specials[rng.integers(0, 3, 16)]
    uv[1::4, 1] = specials[rng.integers(0, 3, 16)]
    uv[2::4] = specials[rng.integers(0, 3, (16, 2))]
    return uv


def _same(a, b):
    """Equal values, with NaN where the other has NaN."""
    return (torch.equal(a.isnan(), b.isnan())
            and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))


@pytest.mark.parametrize("uv_set", ["scripts", "borders", "nan_huge"])
@pytest.mark.parametrize("variant", gather_probe.VARIANTS)
def test_window_staging_is_exact(variant, uv_set):
    """Clamping acts on each coordinate alone, so the plain version's taps
    are entries of the staged window: lerping from the staged tile gives
    probe_patches_plain's result exactly, for any uv."""
    img = torch.from_numpy(_inputs(5, 5.5, 6.5)[0])
    uv = torch.from_numpy(_uv_set(uv_set))
    got = _staged_lerp(img, uv, variant)
    want = gather_probe.probe_patches_plain(img, uv, variant)
    assert got.shape == want.shape == (uv.shape[0], P, P)
    assert _same(got, want)
    if uv_set == "nan_huge":                 # both kinds of row occur
        rows = torch.isnan(want).flatten(1).all(1)
        assert rows.any() and not rows.all()
        assert torch.isfinite(want[~rows]).all()
    else:
        assert torch.equal(got, want)


@pytest.mark.parametrize("bad", ["img_float64", "img_3d", "img_strided",
                                 "uv_float64", "uv_strided", "uv_n3",
                                 "variant"])
def test_kernel_path_checks_before_launch(bad):
    """The CUDA path converts nothing: an image or uv of another type,
    shape or layout, or an unknown variant, raises before any allocation
    or launch (its checks run here on CPU tensors)."""
    img = torch.zeros((16, 24))
    uv = torch.full((5, 2), 8.0)
    variant = "A"
    if bad == "img_float64":
        img = img.double()
    elif bad == "img_3d":
        img = img[None]
    elif bad == "img_strided":
        img = img.t()
    elif bad == "uv_float64":
        uv = uv.double()
    elif bad == "uv_strided":
        uv = torch.full((2, 5), 8.0).t()
    elif bad == "uv_n3":
        uv = torch.full((5, 3), 8.0)
    else:
        variant = "E"
    gather_probe.reset_launch_counts()
    err = TypeError if bad.endswith("float64") else ValueError
    with pytest.raises(err):
        gather_probe._probe_kernel(img, uv, variant)
    assert gather_probe.LAUNCHES["probe_patches_kernel"] == 0


ROOT = pathlib.Path(__file__).resolve().parents[1]
KEPT_PATCHES = sorted((ROOT / "build").glob("probe_patches_*.patch"))


@pytest.mark.parametrize("patch", KEPT_PATCHES,
                         ids=[p.stem for p in KEPT_PATCHES])
def test_kept_variant_patches_apply(patch):
    """Each kernel variant kept as a patch under build/ applies to the
    current source (probe_ab rebuilds it from there), and a source whose
    context lines differ is refused rather than patched elsewhere."""
    from android_svo_tpu_torch.ops import cuda_build
    from android_svo_tpu_torch.tools.probe_ab import apply_patch
    src = (cuda_build.CSRC / "gather_probe_kernels.cu").read_text()
    text = patch.read_text()
    out = apply_patch(src, text)
    added = [ln[1:] for ln in text.splitlines(keepends=True)
             if ln.startswith("+") and not ln.startswith("+++")]
    assert out != src and all(ln in out for ln in added)
    with pytest.raises(ValueError, match="does not apply"):
        apply_patch(src.replace("  __syncwarp();", "  __syncwarp(); "), text)


def test_probe_ab_refuses_without_card(monkeypatch):
    """The A/B tool times the card; without one it raises before building
    anything."""
    from android_svo_tpu_torch.tools import probe_ab
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        probe_ab.run({"this": ""})
