"""Umeyama Sim(3) alignment and the absolute trajectory error, NumPy in
float64 — frozen from the port's `evals/trajectory.py` at 804481e."""

from __future__ import annotations

import numpy as np


def umeyama_alignment(est, gt, with_scale: bool = True):
    """Least-squares similarity aligning est -> gt (N, 3): (s, R, t) with
    gt ~ s * R @ est + t."""
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    mu_e, mu_g = est.mean(axis=0), gt.mean(axis=0)
    ec, gc = est - mu_e, gt - mu_g
    cov = gc.T @ ec / est.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    s = 1.0
    if with_scale:
        var_e = (ec ** 2).sum() / est.shape[0]
        s = float(np.trace(np.diag(D) @ S) / max(var_e, 1e-12))
    return s, R, mu_g - s * R @ mu_e


def ate_rmse(est, gt, with_scale: bool = True) -> float:
    """RMSE of the positions after Sim(3) (or SE(3)) alignment; infinite
    for fewer than three positions or any that is not finite."""
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    if len(est) < 3 or not np.isfinite(est).all():
        return float("inf")
    s, R, t = umeyama_alignment(est, gt, with_scale)
    err = (s * (R @ est.T)).T + t - gt
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))


def stretches(n: int, length: int) -> list:
    """[start, end) of the consecutive `length`-frame stretches of n frames,
    and one more ending at the last frame where they leave a remainder:
    every frame lies in one (all n in one stretch where n < length)."""
    if n < length:
        return [(0, n)]
    out = [(a, a + length) for a in range(0, n - length + 1, length)]
    if out[-1][1] < n:
        out.append((n - length, n))
    return out


def stretch_ates(est, gt, length: int) -> list:
    """(ATE, Sim(3) scale) of each of `stretches`, each aligned by its
    own similarity."""
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    out = []
    for a, b in stretches(len(est), length):
        e, g = est[a:b], gt[a:b]
        ok = len(e) >= 3 and np.isfinite(e).all()
        out.append((ate_rmse(e, g), umeyama_alignment(e, g)[0] if ok
                    else float("nan")))
    return out
