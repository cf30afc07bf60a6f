"""YUV_420_888 -> RGB / grayscale conversion — port of
`android_svo_tpu/data/yuv.py` (the reference's `ImageProcess`,
`image_process.cpp:97-186`).

Plain functions on tensors: each runs on its input's device, so a live
camera frame is converted on the card where the tracker reads it.  Layout:
I420/YUV420p planes (Y: HxW, U, V: H/2 x W/2).
"""

from __future__ import annotations

import torch


def yuv420_to_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor
                  ) -> torch.Tensor:
    """(H,W), (H/2,W/2), (H/2,W/2) uint8/float -> (H,W,3) float32 RGB in
    [0,255]: fixed-point BT.601 limited range as the reference's integer
    kernel (1192*(y-16) with 1634/833/400/2066 chroma terms, >>10)."""
    yf = y.to(torch.float32)
    # nearest 2x chroma upsample, as the reference's uv_row_start>>1 walk
    uf = u.to(torch.float32).repeat_interleave(2, 0).repeat_interleave(2, 1)
    vf = v.to(torch.float32).repeat_interleave(2, 0).repeat_interleave(2, 1)
    uf = uf[: yf.shape[0], : yf.shape[1]] - 128.0
    vf = vf[: yf.shape[0], : yf.shape[1]] - 128.0
    yy = torch.clamp(yf - 16.0, min=0.0) * (1192.0 / 1024.0)
    r = yy + (1634.0 / 1024.0) * vf
    g = yy - (833.0 / 1024.0) * vf - (400.0 / 1024.0) * uf
    b = yy + (2066.0 / 1024.0) * uf
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 255.0)


def yuv420_to_gray(y: torch.Tensor) -> torch.Tensor:
    """Grayscale for the tracker: the luma plane as float32."""
    return y.to(torch.float32)


def rgb_to_gray(rgb: torch.Tensor) -> torch.Tensor:
    """BT.601 luma from RGB (cv::cvtColor COLOR_RGBA2GRAY's weights)."""
    dtype = rgb.dtype if rgb.is_floating_point() else torch.float32
    w = torch.tensor([0.299, 0.587, 0.114], dtype=dtype, device=rgb.device)
    return rgb.to(dtype) @ w
