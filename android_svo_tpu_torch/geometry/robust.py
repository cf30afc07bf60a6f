"""Robust scale estimators and M-estimator weights — port of what
`core/pose_opt` and `parallel/ba` use from
`android_svo_tpu/geometry/robust.py`."""

from __future__ import annotations

import torch

from android_svo_tpu_torch.geometry.triangulation import masked_median

MAD_NORMALIZER = 1.48
# the reference's TukeyWeightFunction::DEFAULT_B (twice the textbook 4.6851)
TUKEY_B = 8.6851
HUBER_K = 1.345


def mad_scale(errors: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return MAD_NORMALIZER * masked_median(torch.abs(errors), mask)


def tukey_weight(x_norm: torch.Tensor, b: float = TUKEY_B) -> torch.Tensor:
    r = x_norm / b
    w = 1.0 - r * r
    return torch.where(torch.abs(r) < 1.0, w * w, torch.zeros_like(w))


def huber_weight(x_norm: torch.Tensor, k: float = HUBER_K) -> torch.Tensor:
    """Huber weight of normalised residuals (ref HuberWeightFunction)."""
    ax = torch.abs(x_norm)
    return torch.where(ax < k, torch.ones_like(ax),
                       k / torch.clamp(ax, min=1e-12))
