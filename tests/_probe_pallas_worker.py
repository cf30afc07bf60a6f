"""Worker process for tests/test_torch_gather_probe.py: runs the JAX
package's three Pallas probe kernels in TPU interpret mode on the CPU, with
the scripts' own BlockSpecs, and saves their outputs.

TPU interpret mode keeps process-wide state and runs its kernels through
callbacks; interleaved in one process with other interpret-mode suites
(tests/test_patch_pallas.py) it can stall, so the twins run here, in a
process of their own.

Usage: python _probe_pallas_worker.py <inputs.npz> <outputs.npz>
  inputs: img_<case>, uv_<case> for case in A, B, C, D, roll
  outputs: the (N, P, P) patches of each case: variant v of
  probe_pallas_variants.make_kernel for A-D, probe_pallas_patch._kernel for
  roll.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

import probe_pallas_patch  # noqa: E402
import probe_pallas_variants  # noqa: E402

P = probe_pallas_variants.P
BLK = probe_pallas_variants.BLK


def pallas(kernel, img, uv):
    """The scripts' pallas_call (probe_pallas_patch.py:59-71,
    probe_pallas_variants.py:76-88) in TPU interpret mode, as the JAX
    package runs its own kernels on the CPU (ops/patch_pallas.py:241-242)."""
    n = uv.shape[0]
    h, w = img.shape
    with pltpu.force_tpu_interpret_mode():
        out = pl.pallas_call(
            kernel, grid=(n // BLK,),
            in_specs=[pl.BlockSpec((BLK, 2), lambda i: (i, 0),
                                   memory_space=pltpu.SMEM),
                      pl.BlockSpec((h, w), lambda i: (0, 0),
                                   memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec((BLK, P, P), lambda i: (i, 0, 0),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((n, P, P), jnp.float32),
        )(jnp.asarray(uv), jnp.asarray(img))
        return np.asarray(out)


def main():
    src = np.load(sys.argv[1])
    kernels = {v: probe_pallas_variants.make_kernel(v) for v in "ABCD"}
    kernels["roll"] = probe_pallas_patch._kernel
    np.savez(sys.argv[2], **{
        case: pallas(k, src[f"img_{case}"], src[f"uv_{case}"])
        for case, k in kernels.items()})


if __name__ == "__main__":
    main()
