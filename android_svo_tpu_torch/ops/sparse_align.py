"""Sparse image alignment: coarse-to-fine inverse-compositional Gauss-Newton
on 4x4 photometric patches — port of `android_svo_tpu/ops/sparse_align.py`
(GN only; `method="lm"` raises).

The JAX while-loop stops a level on the first non-improving step or a tiny
update; one more iteration after such a stop would still overwrite the
best-so-far registers, so the loop is not freeze-safe.  Here the loop breaks
on the host on the same condition (one scalar read per iteration), which
reproduces the JAX carry exactly.
"""

from __future__ import annotations

import torch

from android_svo_tpu_torch.config import SVOConfig, not_ported
from android_svo_tpu_torch.geometry.linsolve import solve_spd
from android_svo_tpu_torch.geometry.se3 import SE3, hat
from android_svo_tpu_torch.ops import interp
from android_svo_tpu_torch.ops import patch_kernels as pk


def _geo_jacobian(p: torch.Tensor) -> torch.Tensor:
    """d(unit-plane uv)/d(twist) for a right perturbation; (N, 2, 6), twist
    order (v, w)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    zi = 1.0 / z
    zi2 = zi * zi
    zero = torch.zeros_like(zi)
    dpi = torch.stack([
        torch.stack([zi, zero, -x * zi2], dim=-1),
        torch.stack([zero, zi, -y * zi2], dim=-1),
    ], dim=-2)
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(
        p.shape[:-1] + (3, 3))
    dp = torch.cat([eye, -hat(p)], dim=-1)
    return dpi @ dp


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def level_substack(stack: torch.Tensor, level: int, h: int, w: int):
    """A (1, rows, cols) slice of one pyramid level out of the padded stack
    (a strided view: the sampling kernel takes its strides)."""
    hl, wl = h >> level, w >> level
    rows = min(max(_round_up(hl, 8), 24), stack.shape[-2])
    cols = min(max(_round_up(wl, 128), 256), stack.shape[-1])
    return stack[level:level + 1, :rows, :cols]


def sparse_img_align(ref_stack, cur_stack, cam, T_cur_ref_init: SE3,
                     ref_px, ref_f, ref_depth, valid, cfg: SVOConfig,
                     method: str = "gn"):
    """Estimate T_cur_ref by direct alignment.  Returns (T_cur_ref,
    n_tracked, chi2)."""
    if method != "gn":
        raise not_ported("img_align method", method)
    dtype = ref_px.dtype
    dev = ref_px.device
    half = cfg.img_align_patch_halfsize
    patch_area = cfg.img_align_patch_size ** 2
    use_pallas = cfg.use_pallas
    H_img, W_img = cam.height, cam.width
    xyz_ref = ref_f * ref_depth[..., None]
    n = ref_px.shape[0]
    zeros_lvl = torch.zeros((n,), dtype=torch.int32, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)

    T = T_cur_ref_init
    n_tracked = torch.zeros((), dtype=torch.int32, device=dev)
    chi2_out = torch.zeros((), dtype=dtype, device=dev)

    for level in range(cfg.img_align_max_level,
                       cfg.img_align_min_level - 1, -1):
        scale = 1.0 / 2 ** level
        h, w = H_img >> level, W_img >> level
        ref_sub = level_substack(ref_stack, level, H_img, W_img)
        cur_sub = level_substack(cur_stack, level, H_img, W_img)

        uv_ref = cam.world2cam(xyz_ref) * scale
        ok_ref = (valid & interp.in_bounds(uv_ref, h, w, half + 1)
                  & (xyz_ref[..., 2] > 1e-3))
        patch_ref, gx, gy = pk.sample_patches(
            ref_sub, zeros_lvl, uv_ref, half, grad=True, valid=ok_ref,
            use_pallas=use_pallas)
        patch_ref = patch_ref.reshape(n, patch_area)
        gx = gx.reshape(n, patch_area)
        gy = gy.reshape(n, patch_area)
        jgeo = _geo_jacobian(xyz_ref)
        fx = cam.fx * scale
        fy = cam.fy * scale
        J = (gx[..., None] * (fx * jgeo[:, None, 0, :])
             + gy[..., None] * (fy * jgeo[:, None, 1, :]))

        T_q, T_t = T.q, T.t
        best_q, best_t = T.q, T.t
        best_chi2 = torch.tensor(float("inf"), dtype=dtype, device=dev)
        for _ in range(cfg.img_align_n_iter):
            Tl = SE3(q=T_q, t=T_t)
            xyz_cur = Tl.apply(xyz_ref)
            uv_cur = cam.world2cam(xyz_cur) * scale
            ok = (ok_ref & (xyz_cur[..., 2] > 1e-3)
                  & interp.in_bounds(uv_cur, h, w, half + 1))
            patch_cur = pk.sample_patches(
                cur_sub, zeros_lvl, uv_cur, half, valid=ok,
                use_pallas=use_pallas).reshape(n, patch_area)
            r = patch_cur - patch_ref
            r = torch.where(ok[:, None], r, torch.zeros_like(r))
            Jm = torch.where(ok[:, None, None], J, torch.zeros_like(J))
            n_meas = torch.clamp(torch.sum(ok) * patch_area, min=1)
            chi2 = torch.sum(r * r) / n_meas.to(dtype)
            Hm = torch.einsum("nai,naj->ij", Jm, Jm)
            g = torch.einsum("nai,na->i", Jm, r)
            Hm = Hm + 1e-4 * eye6 * torch.trace(Hm) / 6.0
            dx = solve_spd(Hm, -g)
            improved = chi2 < best_chi2
            best_q = torch.where(improved, T_q, best_q)
            best_t = torch.where(improved, T_t, best_t)
            best_chi2 = torch.where(improved, chi2, best_chi2)
            T_new = Tl.compose(SE3.exp(dx)).normalize()
            small = torch.linalg.norm(dx) < cfg.img_align_eps
            # rollback: once chi2 stops improving, keep the best iterate and
            # stop (one host read per iteration)
            stop = bool((~improved | small).item())
            T_q = torch.where(improved, T_new.q, T_q)
            T_t = torch.where(improved, T_new.t, T_t)
            if stop:
                break
        T = SE3(q=best_q, t=best_t)
        chi2_out = best_chi2

        if level == cfg.img_align_min_level:
            xyz_cur = T.apply(xyz_ref)
            uv_cur = cam.world2cam(xyz_cur) * scale
            ok = (ok_ref & (xyz_cur[..., 2] > 1e-3)
                  & interp.in_bounds(uv_cur, h, w, half + 1))
            n_tracked = torch.sum(ok).to(torch.int32)

    return T, n_tracked, chi2_out
