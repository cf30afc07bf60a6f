"""The CUDA patch kernels against their plain PyTorch versions on the card.

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
