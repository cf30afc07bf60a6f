"""The CUDA kernels (the patch kernels and the gather probe) against their
plain PyTorch versions on the card.

These need a CUDA device and the CUDA toolkit (the kernels are compiled with
nvcc on first use); without a card they skip.  On a machine with one:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -o addopts=""

(`--noconftest`: the suite's conftest imports JAX, which the machine with the
card need not have.)
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def problem(card):
    from android_svo_tpu_torch.ops import silicon_gate
    return silicon_gate.gate_inputs(n=256, h=240, w=320, seed=1, device=card)


def test_kernel_gate(problem):
    from android_svo_tpu_torch.ops import silicon_gate
    rep = silicon_gate.run_gate(problem)
    torch.cuda.synchronize()
    assert rep.ok, rep.failures


@pytest.mark.parametrize("name", ["sample_patches_kernel", "epi_scan_kernel",
                                  "align_iclk_kernel",
                                  "align_iclk_window_kernel"])
def test_wrapper_launches_and_counts(problem, name):
    from android_svo_tpu_torch.ops import patch_kernels as pk
    from android_svo_tpu_torch.ops import silicon_gate
    call = silicon_gate.kernel_calls(problem)[name]
    pk.reset_launch_counts()
    call(False)                                  # plain version: no launch
    assert pk.LAUNCHES[name] == 0
    call(True)
    torch.cuda.synchronize()
    assert pk.LAUNCHES[name] == 1


@pytest.mark.parametrize("variant", ["A", "B", "C", "D"])
def test_probe_kernel_matches_plain(card, variant):
    """probe_patches_kernel against probe_patches_plain at the microbench's
    size; the kernel rounds each operation as the plain version does."""
    from android_svo_tpu_torch.ops import gather_probe as gp
    from android_svo_tpu_torch.tools.microbench_gather import make_inputs
    img, uv = make_inputs(seed=2, device=card)
    gp.reset_launch_counts()
    out = gp.probe_patches(img, uv, variant)
    torch.cuda.synchronize()
    assert gp.LAUNCHES["probe_patches_kernel"] == 1
    ref = gp.probe_patches_plain(img, uv, variant)
    assert float((out - ref).abs().max()) <= 1e-5


def test_probe_kernel_clamps_off_image(card):
    """Off the scripts' ranges the kernel clamps its reads like the plain
    version (no fault, same values)."""
    from android_svo_tpu_torch.ops import gather_probe as gp
    img = torch.rand((40, 300), device=card)
    uv = torch.tensor([[-30.2, -7.9], [299.6, 45.1], [3.5, 1.25],
                       [float("nan"), 20.0]], device=card)
    for v in gp.VARIANTS:
        out = gp.probe_patches(img, uv, v)
        torch.cuda.synchronize()
        ref = gp.probe_patches_plain(img, uv, v)
        torch.testing.assert_close(out, ref, atol=1e-6, rtol=0,
                                   equal_nan=True)
