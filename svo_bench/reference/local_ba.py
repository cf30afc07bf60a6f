"""Local bundle adjustment with fixed neighbour keyframes, plain torch in
float64: the reference the program's `parallel/ba.py::local_ba` is held to
(with `loba_fix_neighbour_kfs`).  It imports neither the program nor JAX.

Gauss-Newton over the free core cameras and the landmarks, upstream SVO's
`ba::localBA` problem: every observation of a landmark by a live keyframe is
a residual on the unit plane; a keyframe outside the core window is a
constant camera, a core camera marked fixed is one too (the gauge anchor).
Each iteration assembles the FULL normal equations of the free cameras and
the landmarks as one dense matrix and solves it with `torch.linalg.solve`:
no Schur complement, no hand-written factorisation.

Copies of the program's choices (not SVO's), each marked where it is made:
  - the Huber width `huber_width_px / focal` on the unit plane, weights
    k / |e| beyond k = 1.345 widths, recomputed each iteration
  - the depth gate: an observation at depth <= 1e-2 leaves the iteration
  - 1e-5 added to each landmark's diagonal
  - the trace regulariser 1e-6 (trace(S) / (6 NC) + 1) on the free cameras'
    diagonal, S the reduced camera system after the gauge rows are zeroed
  - the safety nets: a camera step that is not finite or is 10 or longer
    is dropped; a landmark step that is not finite or is 1 + |p| or longer
    is dropped
  - the update T <- exp(dx) T with dx = (translation, rotation)
"""

from __future__ import annotations

import torch

from svo_bench.reference import scene

F64 = torch.float64
HUBER_K = 1.345           # copy of the program's Huber constant

# The limits the program is held to (`increment_gap` and `gaps`), by GN
# iterations.  After 1: the camera twists of the iteration, read before the
# program stores them in its fp32 poses, and the landmarks; after 5 the
# stored poses and landmarks, each move read against at least POSE_FLOOR:
# the poses are fp32 (a coordinate near 15 rounds to ~1e-6), and the
# cell's local BA moves its cameras by ~1e-4, so a share of that move
# would read the storage and not the algorithm.  The twists carry fp32's
# own cancellation: near the optimum the gradient is a small sum of large
# terms, and the cell's calls read up to 1.2e-2 of a 1e-4 twist.  Readings
# (fp32 on seeded scenes, tests/test_torch_loba_gauge.py, and on the cell's
# calls on the card, svo_bench/tests/test_svo_bench_v102.py; the controls:
# TF32 einsums, the landmark blocks in bfloat16) are in PERF.md.
LIMITS = {1: {"cam_gap": 5e-2, "point_gap": 5e-3},
          5: {"cam_gap": 2e-3, "point_gap": 5e-3}}
POSE_FLOOR = 1e-3


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternions, normalised here -> (..., 3, 3)."""
    return scene.quat_to_matrix(q / torch.linalg.norm(q, dim=-1,
                                                      keepdim=True))


def skew(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[..., 0])
    x, y, w = v.unbind(-1)
    return torch.stack([torch.stack([z, -w, y], -1),
                        torch.stack([w, z, -x], -1),
                        torch.stack([-y, x, z], -1)], -2)


def se3_exp(xi: torch.Tensor) -> tuple:
    """(..., 6) twists (translation, rotation) -> (R, t)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    th = torch.linalg.norm(phi, dim=-1)[..., None, None]
    K = skew(phi)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(K.shape)
    small = th < 1e-8
    ths = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, 1 - th ** 2 / 6, torch.sin(ths) / ths)
    b = torch.where(small, 0.5 - th ** 2 / 24, (1 - torch.cos(ths)) / ths ** 2)
    c = torch.where(small, 1 / 6 - th ** 2 / 120,
                    (ths - torch.sin(ths)) / ths ** 3)
    R = eye + a * K + b * (K @ K)
    V = eye + b * K + c * (K @ K)
    return R, (V @ rho[..., None])[..., 0]


def local_ba(pos, point_valid, obs_kf, obs_f, q_kw, t_kw, core_slots, fixed,
             focal, huber_width_px: float, n_iter: int, kf_valid=None):
    """Refine the free core cameras and the landmarks.

    Arguments as the program's `local_ba` takes them (any float dtype; the
    work is float64).  Returns a dict of float64 tensors: `R` (K, 3, 3) and
    `t` (K, 3), the poses (world -> keyframe) with only the free core
    cameras changed; `pos` (P, 3); `chi2`, the robust cost at the last
    iteration's linearisation; `dx` (n_iter, NC, 6), each iteration's
    camera twists (zero for fixed cameras)."""
    dev = pos.device
    pos = pos.to(F64).clone()
    R = quat_to_matrix(q_kw.to(F64))
    t = t_kw.to(F64).clone()
    K, NC = R.shape[0], core_slots.shape[0]
    obs_kf = obs_kf.to(torch.int64)
    core_slots = core_slots.to(torch.int64)
    live = torch.ones(K, dtype=torch.bool, device=dev) if kf_valid is None \
        else kf_valid.to(torch.bool)
    ks = obs_kf.clamp(min=0)
    used = (obs_kf >= 0) & live[ks] & point_valid.to(torch.bool)[:, None]
    # camera variable of each keyframe slot: its place among the free core
    # cameras, or -1 (constant)
    free = core_slots[~fixed.to(torch.bool)]
    NF = free.shape[0]
    var = torch.full((K,), -1, dtype=torch.int64, device=dev)
    var[free] = torch.arange(NF, device=dev)
    meas = obs_f[..., :2].to(F64) / obs_f[..., 2:].to(F64)
    width = huber_width_px / float(focal)
    P = pos.shape[0]
    n = 6 * NF + 3 * P
    dxs, chi2 = [], None
    for _ in range(n_iter):
        Rk, tk = R[ks], t[ks]                                   # (P,O,..)
        xyz = (Rk @ pos[:, None, :, None])[..., 0] + tk
        ok = used & (xyz[..., 2] > 1e-2)                        # depth gate
        z = torch.where(ok, xyz[..., 2], torch.ones_like(xyz[..., 2]))
        e = xyz[..., :2] / z[..., None] - meas
        e = torch.where(ok[..., None], e, torch.zeros_like(e))
        en = torch.linalg.norm(e, dim=-1)
        r = en / width
        w = torch.where(r < HUBER_K, torch.ones_like(r),
                        HUBER_K / r.clamp(min=1e-300)) * ok.to(F64)
        chi2 = (w * en * en).sum()
        dpi = torch.zeros(xyz.shape[:-1] + (2, 3), dtype=F64, device=dev)
        dpi[..., 0, 0] = 1 / z
        dpi[..., 1, 1] = 1 / z
        dpi[..., 0, 2] = -xyz[..., 0] / z ** 2
        dpi[..., 1, 2] = -xyz[..., 1] / z ** 2
        Jp = dpi @ Rk                                          # (P,O,2,3)
        eye = torch.eye(3, dtype=F64, device=dev).expand(xyz.shape + (3,))
        Jc = dpi @ torch.cat([eye, -skew(xyz)], -1)             # (P,O,2,6)

        # every residual's Jacobian over the free variables, scattered into
        # the dense normal equations
        cam = var[ks]
        has_cam = ok & (cam >= 0)
        cols_c = 6 * cam.clamp(min=0)[..., None] + torch.arange(6, device=dev)
        cols_p = (6 * NF + 3 * torch.arange(P, device=dev))[:, None, None] \
            + torch.arange(3, device=dev)
        cols_p = cols_p.expand(obs_kf.shape + (3,))
        J = torch.cat([Jc * has_cam[..., None, None].to(F64),
                       Jp * ok[..., None, None].to(F64)], -1)   # (P,O,2,9)
        cols = torch.cat([cols_c, cols_p], -1)                   # (P,O,9)
        wJ = w[..., None, None] * J
        blk = wJ.transpose(-1, -2) @ J                           # (P,O,9,9)
        g = (wJ.transpose(-1, -2) @ e[..., None])[..., 0]        # (P,O,9)
        H = torch.zeros(n * n, dtype=F64, device=dev)
        H.index_add_(0, (cols[..., :, None] * n + cols[..., None, :])
                     .reshape(-1), blk.reshape(-1))
        H = H.reshape(n, n)
        b = torch.zeros(n, dtype=F64, device=dev)
        b.index_add_(0, cols.reshape(-1), g.reshape(-1))
        # the program's landmark damping
        idx_p = torch.arange(6 * NF, n, device=dev)
        H[idx_p, idx_p] += 1e-5
        # the program's trace regulariser: trace of the reduced camera
        # system (for its value only; the solve below is of the full system)
        Hcc, Hcp, Hpp = H[:6 * NF, :6 * NF], H[:6 * NF, 6 * NF:], \
            H[6 * NF:, 6 * NF:]
        tr_S = torch.trace(Hcc) - torch.trace(
            Hcp @ torch.linalg.solve(Hpp, Hcp.T)) if NF else \
            torch.zeros((), dtype=F64, device=dev)
        damp = 1e-6 * (tr_S / (6 * NC) + 1.0)
        idx_c = torch.arange(6 * NF, device=dev)
        H[idx_c, idx_c] += damp
        x = torch.linalg.solve(H, -b)
        dxc = x[:6 * NF].reshape(NF, 6)
        dxp = x[6 * NF:].reshape(P, 3)
        # the program's safety nets
        cam_ok = torch.isfinite(dxc).all(-1) & (
            torch.linalg.norm(dxc, dim=-1) < 10.0)
        dxc = torch.where(cam_ok[:, None], dxc, torch.zeros_like(dxc))
        step_ok = torch.isfinite(dxp).all(-1) & (
            torch.linalg.norm(dxp, dim=-1) < 1.0 + torch.linalg.norm(pos, dim=-1))
        move = step_ok & ok.any(1)
        pos = torch.where(move[:, None], pos + dxp, pos)
        dR, dt = se3_exp(dxc)
        R[free] = dR @ R[free]
        t[free] = (dR @ t[free][..., None])[..., 0] + dt
        full = torch.zeros((NC, 6), dtype=F64, device=dev)
        full[~fixed.to(torch.bool)] = dxc
        dxs.append(full)
    return {"R": R, "t": t, "pos": pos, "chi2": chi2,
            "dx": torch.stack(dxs) if dxs else torch.zeros((0, NC, 6))}


def increments(R0, t0, R1, t1):
    """The left increment (dR, dt) with T1 = (dR, dt) o T0, per camera."""
    dR = R1 @ R0.transpose(-1, -2)
    return dR, t1 - (dR @ t0[..., None])[..., 0]


def increment_gap(dx_got, dx_ref) -> float:
    """How far the program's camera twists of one iteration (NC, 6) lie
    from the reference's, as a share of the reference's largest entry."""
    dx_ref = dx_ref.to(F64)
    gap = (dx_got.to(F64) - dx_ref).abs().max()
    return float(gap / dx_ref.abs().max().clamp(min=1e-300))


def gaps(inputs: dict, got: dict, ref: dict, core_slots,
         floor: float = 0.0) -> dict:
    """How far the program's answer (`got`: q, t, pos) lies from the
    reference's (`ref`), each as a share of how far the reference moved,
    or of `floor` where it moved less: `cam_gap`, over the core cameras'
    increments (rotation entries and translations together); `point_gap`,
    over the landmarks.  0 for an exact answer; 1 is an answer as wrong as
    no update."""
    core = core_slots.to(torch.int64)
    R0 = quat_to_matrix(inputs["q"].to(F64))[core]
    t0 = inputs["t"].to(F64)[core]
    Rg = quat_to_matrix(got["q"].to(F64))[core]
    tg = got["t"].to(F64)[core]
    dRr, dtr = increments(R0, t0, ref["R"][core], ref["t"][core])
    dRg, dtg = increments(R0, t0, Rg, tg)
    eye = torch.eye(3, dtype=F64, device=R0.device)
    size_c = torch.maximum((dRr - eye).abs().max(), dtr.abs().max())
    gap_c = torch.maximum((dRg - dRr).abs().max(), (dtg - dtr).abs().max())
    p0 = inputs["pos"].to(F64)
    size_p = (ref["pos"] - p0).abs().max()
    gap_p = (got["pos"].to(F64) - ref["pos"]).abs().max()
    return {"cam_gap": float(gap_c / size_c.clamp(min=max(floor, 1e-300))),
            "point_gap": float(gap_p / size_p.clamp(min=max(floor, 1e-300))),
            "cam_move": float(size_c), "point_move": float(size_p)}
