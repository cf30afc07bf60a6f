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
