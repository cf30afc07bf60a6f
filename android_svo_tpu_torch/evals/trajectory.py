"""Trajectory evaluation: Umeyama Sim(3) alignment, ATE and RPE — the
port's own copy of `android_svo_tpu/evals/trajectory.py` (numpy,
float64)."""

from __future__ import annotations

import numpy as np


def umeyama_alignment(est: np.ndarray, gt: np.ndarray, with_scale=True):
    """Least-squares similarity aligning est -> gt (N, 3).  Returns
    (s, R, t) with gt ~ s * R @ est + t."""
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    ec = est - mu_e
    gc = gt - mu_g
    cov = gc.T @ ec / est.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_e = (ec ** 2).sum() / est.shape[0]
        s = float(np.trace(np.diag(D) @ S) / max(var_e, 1e-12))
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate_rmse(est_positions, gt_positions, with_scale=True) -> float:
    """Absolute trajectory error RMSE after Sim(3) (or SE(3)) alignment."""
    s, R, t = umeyama_alignment(est_positions, gt_positions, with_scale)
    aligned = (s * (R @ np.asarray(est_positions, np.float64).T)).T + t
    err = aligned - np.asarray(gt_positions, np.float64)
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))



def rpe_stats(est_positions, gt_positions, delta: int = 1):
    """Relative pose (translation drift) error over a frame gap, after
    Sim(3) alignment: (mean, median) of ||d_est - d_gt||."""
    s, R, t = umeyama_alignment(est_positions, gt_positions)
    est = (s * (R @ np.asarray(est_positions, np.float64).T)).T + t
    gt = np.asarray(gt_positions, np.float64)
    de = est[delta:] - est[:-delta]
    dg = gt[delta:] - gt[:-delta]
    err = np.linalg.norm(de - dg, axis=1)
    return float(err.mean()), float(np.median(err))
