"""Recursive Bayesian inverse-depth filter (Gaussian x Beta model) — port of
`android_svo_tpu/core/depth_filter.py`.  Seeds: a, b (Beta evidence), mu,
sigma2 (Gaussian inverse depth), z_range (1/depth_min at birth)."""

from __future__ import annotations

import math

import torch

from android_svo_tpu_torch.config import SVOConfig


def seed_init(depth_mean: torch.Tensor, depth_min: torch.Tensor):
    """Initial (a, b, mu, sigma2, z_range) for new seeds."""
    a = torch.full_like(depth_mean, 10.0)
    b = torch.full_like(depth_mean, 10.0)
    mu = 1.0 / depth_mean
    z_range = 1.0 / depth_min
    sigma2 = (z_range * z_range) / 36.0
    return a, b, mu, sigma2, z_range


def compute_tau(T_ref_cur_t, f, z, px_error_angle):
    """Depth uncertainty from a one-pixel angular matching error."""
    t = torch.broadcast_to(T_ref_cur_t, f.shape)
    a_vec = f * z[..., None] - t
    t_norm = torch.linalg.norm(t, dim=-1)
    a_norm = torch.linalg.norm(a_vec, dim=-1)
    eps = 1e-12
    alpha = torch.arccos(torch.clamp(
        torch.sum(f * t, dim=-1) / torch.clamp(t_norm, min=eps), -1.0, 1.0))
    beta = torch.arccos(torch.clamp(
        torch.sum(a_vec * -t, dim=-1)
        / torch.clamp(a_norm * t_norm, min=eps), -1.0, 1.0))
    beta_plus = beta + px_error_angle
    gamma_plus = math.pi - alpha - beta_plus
    sin_g = torch.sin(gamma_plus)
    z_plus = t_norm * torch.sin(beta_plus) / torch.where(
        torch.abs(sin_g) < eps, torch.full_like(sin_g, eps), sin_g)
    return torch.abs(z_plus - z)


def tau_inverse(z, tau):
    """Depth sigma -> inverse-depth sigma."""
    return 0.5 * (1.0 / torch.clamp(z - tau, min=1e-7) - 1.0 / (z + tau))


def update_seed(x, tau2, a, b, mu, sigma2, z_range):
    """One Bayesian measurement update.  Returns (a, b, mu, sigma2)."""
    norm_scale = torch.clamp(torch.sqrt(sigma2 + tau2), min=1e-12)
    s2 = 1.0 / (1.0 / sigma2 + 1.0 / tau2)
    m = s2 * (mu / sigma2 + x / tau2)
    inv_sqrt2pi = 0.3989422804014327
    pdf = (inv_sqrt2pi / norm_scale
           * torch.exp(-0.5 * ((x - mu) / norm_scale) ** 2))
    C1 = a / (a + b) * pdf
    C2 = b / (a + b) * (1.0 / z_range)
    norm_const = torch.clamp(C1 + C2, min=1e-30)
    C1 = C1 / norm_const
    C2 = C2 / norm_const
    f = C1 * (a + 1.0) / (a + b + 1.0) + C2 * a / (a + b + 1.0)
    e = (C1 * (a + 1.0) * (a + 2.0) / ((a + b + 1.0) * (a + b + 2.0))
         + C2 * a * (a + 1.0) / ((a + b + 1.0) * (a + b + 2.0)))
    mu_new = C1 * m + C2 * mu
    sigma2_new = (C1 * (s2 + m * m) + C2 * (sigma2 + mu * mu)
                  - mu_new * mu_new)
    fe = f - e / f
    denom = torch.where(torch.abs(fe) < 1e-12, torch.full_like(fe, 1e-12), fe)
    a_new = (e - f) / denom
    b_new = a_new * (1.0 - f) / torch.clamp(f, min=1e-12)
    a_new = torch.clamp(a_new, 1e-3, 1e6)
    b_new = torch.clamp(b_new, 1e-3, 1e6)
    sigma2_new = torch.clamp(sigma2_new, min=1e-14)
    return a_new, b_new, mu_new, sigma2_new


def is_converged(sigma2, z_range, cfg: SVOConfig):
    return torch.sqrt(sigma2) < z_range / cfg.seed_convergence_sigma2_thresh


def px_error_angle(cam_fx, noise_px: float = 1.0):
    return torch.arctan(noise_px / (2.0 * cam_fx)) * 2.0
