"""Robust scale estimators and M-estimator weights — port of
`android_svo_tpu/geometry/robust.py` (the reference's `vk::robust_cost`,
`robust_cost.cpp:29-157`).  Every function takes tensors and an optional
validity mask over a fixed-size arena."""

from __future__ import annotations

import torch

from android_svo_tpu_torch.geometry.triangulation import masked_median

MAD_NORMALIZER = 1.48
# the reference's TukeyWeightFunction::DEFAULT_B (twice the textbook 4.6851)
TUKEY_B = 8.6851
HUBER_K = 1.345
TDIST_DOF = 5.0


def mad_scale(errors: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return MAD_NORMALIZER * masked_median(torch.abs(errors), mask)


def normal_scale(errors: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """RMS scale (ref NormalDistributionScaleEstimator)."""
    n = torch.clamp(torch.sum(mask.to(errors.dtype)), min=1.0)
    e2 = torch.where(mask, errors * errors, torch.zeros_like(errors))
    return torch.sqrt(torch.sum(e2) / n)


def tdist_scale(errors: torch.Tensor, mask: torch.Tensor,
                n_iter: int = 10) -> torch.Tensor:
    """Student-t scale by fixed-point EM from the RMS scale (ref
    TDistributionScaleEstimator)."""
    dof = TDIST_DOF
    n = torch.clamp(torch.sum(mask.to(errors.dtype)), min=1.0)
    e2 = torch.where(mask, errors * errors, torch.zeros_like(errors))
    sigma2 = torch.clamp(torch.sum(e2) / n, min=1e-12)
    for _ in range(n_iter):
        w = (dof + 1.0) / (dof + e2 / sigma2)
        sigma2 = torch.clamp(torch.sum(w * e2) / n, min=1e-12)
    return torch.sqrt(sigma2)


def unit_weight(x: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(x)


def tukey_weight(x_norm: torch.Tensor, b: float = TUKEY_B) -> torch.Tensor:
    r = x_norm / b
    w = 1.0 - r * r
    return torch.where(torch.abs(r) < 1.0, w * w, torch.zeros_like(w))


def huber_weight(x_norm: torch.Tensor, k: float = HUBER_K) -> torch.Tensor:
    """Huber weight of normalised residuals (ref HuberWeightFunction)."""
    ax = torch.abs(x_norm)
    return torch.where(ax < k, torch.ones_like(ax),
                       k / torch.clamp(ax, min=1e-12))


def tdist_weight(x_norm: torch.Tensor, dof: float = TDIST_DOF) -> torch.Tensor:
    """Student-t weight (ref TDistributionWeightFunction)."""
    return (dof + 1.0) / (dof + x_norm * x_norm)
