"""The gather probe: one bilinear 8x8 patch per uv from one (H, W) image,
with the window origin of one of the JAX package's four probe variants —
the port of the Pallas kernels of `scripts/probe_pallas_patch.py`,
`scripts/microbench_gather.py` and `scripts/probe_pallas_variants.py`.

  kernel                  replaces                                  plain version
  probe_patches_kernel    probe_pallas_patch.py:26 (_kernel),       probe_patches_plain
                          microbench_gather.py:133 (patch_kernel),
                          probe_pallas_variants.py:25 (make_kernel)

With xi = floor(x) - 4 and yi = floor(y) - 4 the (P+1)^2 source window
starts at:
  A  (yi, xi)                                    the true patch
  B  (yi, clip(xi, 0, w-128))                    cost probes, wrong by design
  C  (yi, clip((xi//128)*128, 0, w-256))
  D  (clip((yi//8)*8, 0, h-16), 0)
and the bilinear weights are uv - floor(uv), once per feature.  Reads outside
the image clamp to its border (the TPU twins wrap inside their window there;
on the scripts' uv ranges no read leaves the image).

The kernel gives each feature one warp, which stages the (P+1)^2 window
once in shared memory (81 image loads instead of 256) and lerps its 64
pixels from there; it agrees with `probe_patches_plain` bit for bit, for
any uv (`csrc/gather_probe_kernels.cu`).

Dispatch as in `ops/patch_kernels.py`: the wrapper launches the kernel when
the image lies on a CUDA device and takes the plain version only for CPU
tensors.  On CUDA it converts nothing: it takes a contiguous (H, W) float32
image and contiguous (N, 2) float32 uv on the same device, raises
`TypeError` / `ValueError` on anything else before any launch, and is one
allocation and one launch on the current raw stream (the launch plumbing
of `ops/cuda_build.py`, shared with the patch wrappers).  A refused launch
raises.  Every launch adds one to `LAUNCHES["probe_patches_kernel"]`.
"""

from __future__ import annotations

import torch

from android_svo_tpu_torch.ops.cuda_build import (check, contiguous,
                                                  launch, stream)

P = 8
VARIANTS = ("A", "B", "C", "D")
LAUNCHES = {"probe_patches_kernel": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _floor_int(f: torch.Tensor) -> torch.Tensor:
    """int(floor) with NaN read as 0 and the float clamped before the cast
    (the kernel's rule)."""
    return torch.nan_to_num(f, nan=0.0).clamp(-65536.0, 65536.0).to(
        torch.int64)


def _check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got "
                         f"{variant!r}")


def window_origin(uv: torch.Tensor, variant: str, h: int, w: int):
    """(oy, ox) int64 of each feature's (P+1)^2 source window."""
    _check_variant(variant)
    xi = _floor_int(torch.floor(uv[:, 0])) - P // 2
    yi = _floor_int(torch.floor(uv[:, 1])) - P // 2
    if variant == "B":
        return yi, torch.clamp(xi, 0, w - 128)
    if variant == "C":
        return yi, torch.clamp((xi // 128) * 128, 0, w - 256)
    if variant == "D":
        return torch.clamp((yi // 8) * 8, 0, h - 16), torch.zeros_like(xi)
    return yi, xi


def probe_patches_plain(img: torch.Tensor, uv: torch.Tensor,
                        variant: str) -> torch.Tensor:
    """Plain PyTorch version of probe_patches_kernel: (N, 2) uv -> (N, P, P)
    patches, in the kernel's arithmetic order."""
    h, w = img.shape
    oy, ox = window_origin(uv, variant, h, w)
    wx = (uv[:, 0] - torch.floor(uv[:, 0]))[:, None, None]
    wy = (uv[:, 1] - torch.floor(uv[:, 1]))[:, None, None]
    r = torch.arange(P, device=uv.device)
    rows = oy[:, None, None] + r[None, :, None]          # (N, P, 1)
    cols = ox[:, None, None] + r[None, None, :]          # (N, 1, P)
    y0, y1 = rows.clamp(0, h - 1), (rows + 1).clamp(0, h - 1)
    x0, x1 = cols.clamp(0, w - 1), (cols + 1).clamp(0, w - 1)
    top = (1 - wx) * img[y0, x0] + wx * img[y0, x1]
    bot = (1 - wx) * img[y1, x0] + wx * img[y1, x1]
    return (1 - wy) * top + wy * bot


def _probe_kernel(img: torch.Tensor, uv: torch.Tensor,
                  variant: str) -> torch.Tensor:
    """One allocation and one launch; inputs the kernel does not take raise
    before either."""
    _check_variant(variant)
    if img.dtype is not torch.float32:
        raise TypeError(f"img must be a torch.float32 tensor, got "
                        f"{img.dtype}")
    if img.dim() != 2:
        raise ValueError(f"img must be (H, W), got {tuple(img.shape)}")
    contiguous(img, "img")
    dev = img.get_device()
    n = uv.shape[0]
    check(uv, "uv", torch.float32, (n, 2), dev)
    contiguous(uv, "uv")
    out = torch.empty((n, P, P), dtype=torch.float32, device=img.device)
    if n:
        h, w = img.shape
        launch(LAUNCHES, "probe_patches_kernel", "launch_probe_patches",
               img.data_ptr(), h, w, uv.data_ptr(), n, ord(variant),
               out.data_ptr(), stream(dev))
    return out


def probe_patches(img: torch.Tensor, uv: torch.Tensor,
                  variant: str = "A") -> torch.Tensor:
    """Bilinear P x P patches (N, P, P) at uv (N, 2) = (x, y) pixels with the
    window origin rule of `variant`."""
    if img.is_cuda:
        return _probe_kernel(img, uv, variant)
    return probe_patches_plain(img, uv, variant)
