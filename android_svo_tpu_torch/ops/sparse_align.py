"""Sparse image alignment: coarse-to-fine inverse-compositional Gauss-Newton
(or Levenberg-Marquardt) on 4x4 photometric patches — port of
`android_svo_tpu/ops/sparse_align.py`.

Each level's reference side (the reference points' validity, one sampler
call for their patches and gradients, and the photometric Jacobian) does
not depend on the pose: the levels' set-ups are made first, then the loop
runs level by level.

On CUDA tensors (with `cfg.use_pallas`) the whole loop, every iteration of
every level, is one launch of `sparse_align_kernel`
(`ops/sparse_align_gn.py`), one block a frame, one launch for a batch; it
reads nothing back, adds one to the installed monitor's `align_launches`
and leaves each level's iteration count on the device in
`KERNEL_ITERATIONS`.  On CPU tensors, or with `use_pallas` off, the plain
loop below runs, the kernel's spec: the JAX while-loop stops a level on the
first non-improving step (GN) or a tiny update (both methods); one more
iteration after such a stop would still overwrite the best-so-far
registers, so the loop is not freeze-safe.  Here the loop breaks on the
host on the same condition (one scalar read per iteration,
`profiling.host_read` site `align_stop`), which reproduces the JAX carry
exactly; the batched form keeps a stopped element's carry and reads
`any(active)` instead (site `align_active`).  Each iteration adds one to
the installed monitor's `align_iters` and to `ITERATIONS`.  Under LM the
iterate steps every iteration, also when chi2 got worse: only the
best-so-far registers keep the best iterate, and the damping mu (0.01 at
the start of each level) grows tenfold after a worse step and relaxes to
max(mu/3, 1e-8) after a better one.
"""

from __future__ import annotations

from functools import partial

import torch

from android_svo_tpu_torch.config import SVOConfig
from android_svo_tpu_torch.geometry.linsolve import solve_spd
from android_svo_tpu_torch.geometry.se3 import SE3, hat
from android_svo_tpu_torch.ops import interp
from android_svo_tpu_torch.ops import patch_kernels as pk
from android_svo_tpu_torch.ops import sparse_align_gn
from android_svo_tpu_torch.ops.cuda_build import cfg_use_pallas, on_card
from android_svo_tpu_torch.ops.reduce import fixed_sum
from android_svo_tpu_torch.utils import profiling


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


def substack_dims(level: int, h: int, w: int, stack_hw) -> tuple:
    """(rows, cols) of `level_substack`'s slice: the sampler's clamps."""
    hl, wl = h >> level, w >> level
    return (min(max(_round_up(hl, 8), 24), stack_hw[0]),
            min(max(_round_up(wl, 128), 256), stack_hw[1]))


def level_substack(stack: torch.Tensor, level: int, h: int, w: int):
    """A (1, rows, cols) slice of one pyramid level out of the padded stack
    (a strided view: the sampling kernel takes its strides)."""
    rows, cols = substack_dims(level, h, w, stack.shape[-2:])
    return stack[level:level + 1, :rows, :cols]


# Gauss-Newton (or LM) iterations each level of the last call of the plain
# loop ran, coarse to fine (host ints the loop counts anyway; a batched
# call's loop runs as long as its slowest element's): what the step's
# sampler launches are held to.  The kernel path leaves it empty.
ITERATIONS: list = []
# the kernel path's iterations per level of the last call, an int32 device
# tensor, (levels,) or (B, levels): read it after a synchronise
KERNEL_ITERATIONS = None


def _level_refs(ref_stack, xyz_ref, valid, cam, level: int,
                cfg: SVOConfig):
    """One level's reference side: the reference patches' validity, and
    the patches and their gradients gx, gy (n, area) (one sampler call)."""
    n = xyz_ref.shape[0]
    half = cfg.img_align_patch_halfsize
    patch_area = cfg.img_align_patch_size ** 2
    scale = 1.0 / 2 ** level
    h, w = cam.height >> level, cam.width >> level
    ref_sub = level_substack(ref_stack, level, cam.height, cam.width)
    zeros_lvl = torch.zeros((n,), dtype=torch.int32, device=xyz_ref.device)
    uv_ref = cam.world2cam(xyz_ref) * scale
    ok_ref = (valid & interp.in_bounds(uv_ref, h, w, half + 1)
              & (xyz_ref[..., 2] > 1e-3))
    patch_ref, gx, gy = pk.sample_patches(
        ref_sub, zeros_lvl, uv_ref, half, grad=True, valid=ok_ref,
        use_pallas=cfg.use_pallas)
    return (ok_ref, patch_ref.reshape(n, patch_area),
            gx.reshape(n, patch_area), gy.reshape(n, patch_area))


def _photometric_jacobian(gx, gy, xyz_ref, cam, level: int):
    """J (n, area, 6): each pixel's image gradient through the level's
    focal lengths and `_geo_jacobian` at the reference point."""
    scale = 1.0 / 2 ** level
    jgeo = _geo_jacobian(xyz_ref)
    fx = cam.fx * scale
    fy = cam.fy * scale
    return (gx[..., None] * (fx * jgeo[:, None, 0, :])
            + gy[..., None] * (fy * jgeo[:, None, 1, :]))


def _level_setup(ref_stack, xyz_ref, valid, cam, level: int,
                 cfg: SVOConfig):
    """One level's constants: the reference patches' validity, the patches
    and the photometric Jacobian J (n, area, 6)."""
    ok_ref, patch_ref, gx, gy = _level_refs(ref_stack, xyz_ref, valid, cam,
                                            level, cfg)
    return ok_ref, patch_ref, _photometric_jacobian(gx, gy, xyz_ref, cam,
                                                    level)


def _align_step(cur_stack, xyz_ref, ok_ref, patch_ref, J, carry, cam,
                level: int, cfg: SVOConfig, lm: bool):
    """One GN (or LM) iteration as a pure function of the carry (T_q, T_t,
    best_q, best_t, best_chi2[, mu]).  Returns (carry', stop): `stop` is
    the loop's exit test (GN: no improvement or a tiny update; LM: a tiny
    update)."""
    n = xyz_ref.shape[0]
    dtype = xyz_ref.dtype
    half = cfg.img_align_patch_halfsize
    patch_area = cfg.img_align_patch_size ** 2
    scale = 1.0 / 2 ** level
    h, w = cam.height >> level, cam.width >> level
    cur_sub = level_substack(cur_stack, level, cam.height, cam.width)
    zeros_lvl = torch.zeros((n,), dtype=torch.int32, device=xyz_ref.device)
    eye6 = torch.eye(6, dtype=dtype, device=xyz_ref.device)
    T_q, T_t, best_q, best_t, best_chi2 = carry[:5]
    Tl = SE3(q=T_q, t=T_t)
    xyz_cur = Tl.apply(xyz_ref)
    uv_cur = cam.world2cam(xyz_cur) * scale
    ok = (ok_ref & (xyz_cur[..., 2] > 1e-3)
          & interp.in_bounds(uv_cur, h, w, half + 1))
    patch_cur = pk.sample_patches(
        cur_sub, zeros_lvl, uv_cur, half, valid=ok,
        use_pallas=cfg.use_pallas).reshape(n, patch_area)
    r = patch_cur - patch_ref
    r = torch.where(ok[:, None], r, torch.zeros_like(r))
    Jm = torch.where(ok[:, None, None], J, torch.zeros_like(J))
    n_meas = torch.clamp(torch.sum(ok) * patch_area, min=1)
    # the normal equations' sums in a fixed order (ops/reduce.py): the
    # batched step rounds them as each sequence's single step does
    chi2 = fixed_sum(r * r, 2) / n_meas.to(dtype)
    Hm = fixed_sum(Jm[..., :, None] * Jm[..., None, :], 2)
    g = fixed_sum(Jm * r[..., None], 2)
    damp = 1e-4 + carry[5] if lm else 1e-4
    Hm = Hm + damp * eye6 * torch.diagonal(Hm).sum() / 6.0
    dx = solve_spd(Hm, -g)
    improved = chi2 < best_chi2
    best_q = torch.where(improved, T_q, best_q)
    best_t = torch.where(improved, T_t, best_t)
    best_chi2 = torch.where(improved, chi2, best_chi2)
    T_new = Tl.compose(SE3.exp(dx)).normalize()
    small = torch.linalg.norm(dx) < cfg.img_align_eps
    if lm:
        mu = carry[5]
        mu = torch.where(improved, torch.clamp(mu / 3.0, min=1e-8),
                         mu * 10.0)
        return (T_new.q, T_new.t, best_q, best_t, best_chi2, mu), small
    # rollback: once chi2 stops improving, keep the best iterate and stop
    T_q = torch.where(improved, T_new.q, T_q)
    T_t = torch.where(improved, T_new.t, T_t)
    return (T_q, T_t, best_q, best_t, best_chi2), ~improved | small


def _n_tracked(xyz_ref, ok_ref, T_q, T_t, cam, level: int, cfg: SVOConfig):
    scale = 1.0 / 2 ** level
    h, w = cam.height >> level, cam.width >> level
    half = cfg.img_align_patch_halfsize
    xyz_cur = SE3(q=T_q, t=T_t).apply(xyz_ref)
    uv_cur = cam.world2cam(xyz_cur) * scale
    ok = (ok_ref & (xyz_cur[..., 2] > 1e-3)
          & interp.in_bounds(uv_cur, h, w, half + 1))
    return torch.sum(ok).to(torch.int32)


def sparse_img_align(ref_stack, cur_stack, cam, T_cur_ref_init: SE3,
                     ref_px, ref_f, ref_depth, valid, cfg: SVOConfig,
                     method: str = "gn", batched: bool = False):
    """Estimate T_cur_ref by direct alignment; `method` is "gn" or "lm".
    Returns (T_cur_ref, n_tracked, chi2).

    With `batched`, every input has a leading batch axis (B independent
    alignments): each level's set-up runs under `torch.func.vmap` (the
    sampler one launch for the batch).  On the card the loop is one launch
    of B blocks, each stopping where its own loop stops; the plain loop
    runs each iteration under vmap, an element that has stopped keeps its
    whole carry, and it reads `any(active)` once per iteration, so every
    element ends where its own loop would have ended (JAX's batched
    while-loop)."""
    lm = method == "lm"
    xyz_ref = ref_f * ref_depth[..., None]
    vm = torch.func.vmap if batched else (lambda f: f)
    levels = range(cfg.img_align_max_level, cfg.img_align_min_level - 1, -1)
    if on_card(ref_px, cfg_use_pallas(cfg)):
        refs = [vm(partial(_level_refs, cam=cam, level=level, cfg=cfg))(
            ref_stack, xyz_ref, valid) for level in levels]
        return _align_kernel(cur_stack, cam, T_cur_ref_init, xyz_ref,
                             levels, refs, cfg, lm, batched)
    setups = [vm(partial(_level_setup, cam=cam, level=level, cfg=cfg))(
        ref_stack, xyz_ref, valid) for level in levels]
    return _align_plain(cur_stack, cam, T_cur_ref_init, xyz_ref, levels,
                        setups, cfg, lm, batched)


def _align_kernel(cur_stack, cam, T: SE3, xyz_ref, levels, refs,
                  cfg: SVOConfig, lm: bool, batched: bool):
    """The loop as one launch of `sparse_align_kernel`."""
    global KERNEL_ITERATIONS
    ITERATIONS.clear()
    hw = cur_stack.shape[-2:]
    args = [(level, *substack_dims(level, cam.height, cam.width, hw), *ref)
            for level, ref in zip(levels, refs)]
    fn = (sparse_align_gn.sparse_align_gn_batched if batched
          else sparse_align_gn.sparse_align_gn)
    q, t, n_tracked, chi2, KERNEL_ITERATIONS = fn(
        cur_stack, xyz_ref, T.q, T.t, cam, args,
        cfg.img_align_patch_halfsize, cfg.img_align_n_iter,
        cfg.img_align_eps, lm)
    profiling.count("align_launches")
    return SE3(q=q, t=t), n_tracked, chi2


def _align_plain(cur_stack, cam, T: SE3, xyz_ref, levels, setups,
                 cfg: SVOConfig, lm: bool, batched: bool):
    """The plain loop: one host read of the stop test an iteration."""
    dtype = xyz_ref.dtype
    dev = xyz_ref.device
    lead = xyz_ref.shape[:-2]                # () or (B,)
    vm = torch.func.vmap if batched else (lambda f: f)
    ITERATIONS.clear()
    n_tracked = torch.zeros(lead, dtype=torch.int32, device=dev)
    chi2_out = torch.zeros(lead, dtype=dtype, device=dev)

    for level, (ok_ref, patch_ref, J) in zip(levels, setups):
        carry = (T.q, T.t, T.q, T.t,
                 torch.full(lead, float("inf"), dtype=dtype, device=dev))
        if lm:
            carry = carry + (torch.full(lead, 0.01, dtype=dtype,
                                        device=dev),)
        step = vm(lambda cs, x, o, p, j, c: _align_step(
            cs, x, o, p, j, c, cam, level, cfg, lm))
        active = torch.ones(lead, dtype=torch.bool, device=dev)
        ITERATIONS.append(0)
        for _ in range(cfg.img_align_n_iter):
            new, stop = step(cur_stack, xyz_ref, ok_ref, patch_ref, J, carry)
            ITERATIONS[-1] += 1
            profiling.count("align_iters")
            if not batched:
                carry = new
                if profiling.host_read(stop, "align_stop"):
                    break
                continue
            carry = tuple(
                torch.where(active.reshape(lead + (1,) * (c.dim() - 1)),
                            nc, c) for nc, c in zip(new, carry))
            active = active & ~stop
            if not profiling.host_read(active.any(), "align_active"):
                break
        T = SE3(q=carry[2], t=carry[3])
        chi2_out = carry[4]

        if level == cfg.img_align_min_level:
            n_tracked = vm(lambda x, o, q, t: _n_tracked(
                x, o, q, t, cam, level, cfg))(xyz_ref, ok_ref, T.q, T.t)

    return T, n_tracked, chi2_out
