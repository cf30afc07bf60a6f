"""Scattered bilinear patch work — the port of
`android_svo_tpu/ops/patch_pallas.py`.

Four hand-written CUDA kernels (`csrc/patch_kernels.cu`), each with its
plain PyTorch version beside it:

  kernel                      replaces (patch_pallas.py)          plain version
  sample_patches_kernel       _sample_pallas                      _sample_plain
  epi_scan_kernel             _scan_pallas                        _scan_plain
  align_iclk_kernel           _align_pallas                       _align_plain
  align_iclk_window_kernel    _dump_pallas + align_iclk_mxu's     dump_windows_plain +
                              one-hot einsum ICLK                 _align_mxu_plain

Dispatch: a wrapper launches the kernel when `use_pallas` is true and its
tensors lie on a CUDA device, and takes the plain version only for CPU
tensors (or when `use_pallas` is false).  On a CUDA tensor it launches or
raises; there is no fallback.  Every launch adds one to `LAUNCHES[name]`.

Layout contract as in the JAX package: the stack is `(L, Hp, Wp)` with level
l in the top-left `(h>>l, w>>l)` corner; uv are level-pixel coordinates; the
plain versions compute every slot, the kernels write zeros (or the initial
position) for dead ones, so compare valid slots only.
"""

from __future__ import annotations

import ctypes

import torch

from android_svo_tpu_torch.geometry.linsolve import inv_spd
from android_svo_tpu_torch.ops import interp

# feature_alignment.cpp:276: min_update_squared = 0.03*0.03
MIN_UPDATE_SQUARED = 0.03 * 0.03
DUMP_WR = 32     # ICLK window rows
DUMP_WC = 64     # ICLK window cols

LAUNCHES = {
    "sample_patches_kernel": 0,
    "epi_scan_kernel": 0,
    "align_iclk_kernel": 0,
    "align_iclk_window_kernel": 0,
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_card(t: torch.Tensor, use_pallas) -> bool:
    return bool(use_pallas) and t.is_cuda


# ---------------------------------------------------------------------------
# launch plumbing
# ---------------------------------------------------------------------------

def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _stack_args(stack: torch.Tensor):
    if stack.dtype != torch.float32 or stack.dim() != 3:
        raise ValueError(f"stack must be (L, H, W) float32, got "
                         f"{tuple(stack.shape)} {stack.dtype}")
    if stack.stride(2) != 1:
        raise ValueError("stack rows must be contiguous (stride(2) == 1)")
    L, H, W = stack.shape
    return (_ptr(stack), stack.stride(0), stack.stride(1), L, H, W)


def _f32(t, device, shape=None):
    t = t.to(device=device, dtype=torch.float32).contiguous()
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    return t


def _i32(t, device):
    return t.to(device=device, dtype=torch.int32).contiguous()


def _b8(t, device):
    return t.to(device=device, dtype=torch.bool).contiguous()


def _nan0(t):
    return torch.nan_to_num(t, nan=0.0, posinf=0.0, neginf=0.0)


def _launch(name: str, fn_name: str, *args) -> None:
    from android_svo_tpu_torch.ops.cuda_build import library
    rc = getattr(library(), fn_name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with cudaError_t {rc}")
    LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# patch sampling
# ---------------------------------------------------------------------------

def _sample_plain(stack, lvl, uv, half: int, grad: bool):
    """Plain version of sample_patches_kernel (port of _sample_fallback):
    bilinear patches from the padded stack with interp's clamps."""
    p = 2 * half
    n = uv.shape[0]
    offs = interp.patch_offsets(half, uv.dtype, uv.device)
    coords = uv[:, None, :] + offs[None, :, :]
    val = interp.bilinear_sample_stack(stack, lvl, coords)
    if not grad:
        return val.reshape(n, p, p)
    ex = torch.tensor([1.0, 0.0], dtype=uv.dtype, device=uv.device)
    ey = torch.tensor([0.0, 1.0], dtype=uv.dtype, device=uv.device)
    dx = 0.5 * (interp.bilinear_sample_stack(stack, lvl, coords + ex)
                - interp.bilinear_sample_stack(stack, lvl, coords - ex))
    dy = 0.5 * (interp.bilinear_sample_stack(stack, lvl, coords + ey)
                - interp.bilinear_sample_stack(stack, lvl, coords - ey))
    return (val.reshape(n, p, p), dx.reshape(n, p, p), dy.reshape(n, p, p))


def _sample_kernel(stack, lvl, uv, half: int, grad: bool, valid):
    dev = stack.device
    n = uv.shape[0]
    p = 2 * half
    outs = [torch.empty((n, p, p), dtype=torch.float32, device=dev)
            for _ in range(3 if grad else 1)]
    if n:
        lvl_c = _i32(lvl, dev)
        uv_c = _f32(_nan0(uv), dev, (n, 2))
        valid_c = (torch.ones((n,), dtype=torch.bool, device=dev)
                   if valid is None else _b8(valid, dev))
        o_dx = outs[1] if grad else outs[0]
        o_dy = outs[2] if grad else outs[0]
        _launch("sample_patches_kernel", "launch_sample_patches",
                *_stack_args(stack), _ptr(lvl_c), _ptr(uv_c), _ptr(valid_c),
                n, half, int(grad), _ptr(outs[0]), _ptr(o_dx), _ptr(o_dy),
                _stream(stack))
    return tuple(outs) if grad else outs[0]


def sample_patches(stack, lvl, uv, half: int, grad: bool = False,
                   valid=None, use_pallas=True):
    """Bilinear (2*half)^2 patches (optionally with central-difference
    gradients) at per-feature pyramid level `lvl` and level-coords `uv`.
    Returns (N, P, P) or a (patch, dx, dy) triple when grad=True."""
    if _on_card(stack, use_pallas):
        return _sample_kernel(stack, lvl, uv, half, grad, valid)
    return _sample_plain(stack, lvl, uv, half, grad)


# ---------------------------------------------------------------------------
# fused epipolar ZMSSD scan
# ---------------------------------------------------------------------------

def _scan_plain(stack, lvl, uv_a, uv_b, n_steps_each, ref_patch_zm,
                n_steps_max: int, half: int, h: int, w: int):
    """Plain version of epi_scan_kernel (port of _scan_fallback)."""
    p = 2 * half
    n = lvl.shape[0]
    dtype = uv_a.dtype
    dev = uv_a.device
    k = torch.clamp(n_steps_each.to(torch.int64), 0, n_steps_max)
    js = torch.arange(n_steps_max, dtype=dtype, device=dev)
    ts = js[None, :] / torch.clamp(k - 1, min=1)[:, None].to(dtype)
    live = js[None, :] < k[:, None].to(dtype)
    ts = torch.clamp(ts, max=1.0)
    uvk = (uv_a[:, None, :] * (1 - ts[..., None])
           + uv_b[:, None, :] * ts[..., None])
    offs = interp.patch_offsets(half, dtype, dev)
    coords = uvk[:, :, None, :] + offs[None, None, :, :]
    lvl = lvl.to(torch.int64)
    cur = interp.bilinear_sample_stack(
        stack, lvl[:, None].expand(n, n_steps_max).reshape(-1),
        coords.reshape(n * n_steps_max, -1, 2)).reshape(n, n_steps_max,
                                                        p * p)
    cur = cur - cur.mean(dim=-1, keepdim=True)
    d = cur - ref_patch_zm.reshape(n, 1, p * p)
    score = torch.sum(d * d, dim=-1)
    L = stack.shape[0]
    lvl_n = torch.where(lvl < 0, lvl + L, lvl).clamp(0, L - 1)
    wl = (w >> lvl_n).to(dtype)[:, None]
    hl = (h >> lvl_n).to(dtype)[:, None]
    m = half + 2.0
    inb = ((uvk[..., 0] >= m) & (uvk[..., 0] < wl - 1 - m)
           & (uvk[..., 1] >= m) & (uvk[..., 1] < hl - 1 - m))
    score = torch.where(inb & live, score, torch.full_like(score,
                                                          float("inf")))
    best = torch.argmin(score, dim=-1)
    best_t = torch.gather(ts, 1, best[:, None])[:, 0]
    best_s = torch.gather(score, 1, best[:, None])[:, 0]
    return best_t, best_s


def _scan_kernel(stack, lvl, uv_a, uv_b, n_steps_each, ref_patch_zm,
                 n_steps_max: int, half: int, h: int, w: int):
    dev = stack.device
    n = lvl.shape[0]
    p = 2 * half
    if p * p > 128:
        raise ValueError("epi_scan_kernel takes patches of at most 128 px")
    best_t = torch.empty((n,), dtype=torch.float32, device=dev)
    best_s = torch.empty((n,), dtype=torch.float32, device=dev)
    if n:
        lvl_c = _i32(lvl, dev)
        a = _f32(_nan0(uv_a), dev, (n, 2))
        b = _f32(_nan0(uv_b), dev, (n, 2))
        ns = _i32(n_steps_each, dev)
        ref = _f32(ref_patch_zm, dev, (n, p, p))
        _launch("epi_scan_kernel", "launch_epi_scan", *_stack_args(stack),
                int(h), int(w), _ptr(lvl_c), _ptr(a), _ptr(b), _ptr(ns),
                _ptr(ref), n, int(n_steps_max), half, _ptr(best_t),
                _ptr(best_s), _stream(stack))
    return best_t, best_s


def epi_scan(stack, lvl, uv_a, uv_b, ref_patch, n_steps_max: int,
             half: int = 4, n_steps_each=None, h: int | None = None,
             w: int | None = None, use_pallas=True):
    """Best ZMSSD match along each seed's epipolar segment: scans
    `n_steps_each[i]` (clipped to [0, n_steps_max]) uniform positions from
    uv_a to uv_b; returns (t_best in [0,1], score).  Positions outside the
    TRUE level dims (h>>l, w>>l) with margin half+2 score +inf."""
    L, hp, wp = stack.shape
    h = hp if h is None else h
    w = wp if w is None else w
    if n_steps_each is None:
        n_steps_each = torch.full(lvl.shape, n_steps_max, dtype=torch.int32,
                                  device=lvl.device)
    rp = ref_patch.reshape(ref_patch.shape[0], -1)
    rp = (rp - rp.mean(dim=-1, keepdim=True)).reshape(ref_patch.shape)
    fn = _scan_kernel if _on_card(stack, use_pallas) else _scan_plain
    return fn(stack, lvl, uv_a, uv_b, n_steps_each, rp, n_steps_max, half,
              h, w)


# ---------------------------------------------------------------------------
# inverse-compositional LK alignment (align2D)
# ---------------------------------------------------------------------------

def _iclk_hinv(ref_dx, ref_dy):
    """Inverse of the IC Hessian over (du, dv, d_mean)."""
    n = ref_dx.shape[0]
    gxf = ref_dx.reshape(n, -1)
    gyf = ref_dy.reshape(n, -1)
    J = torch.stack([gxf, gyf, torch.ones_like(gxf)], dim=-1)
    H = torch.einsum("nai,naj->nij", J, J) + 1e-6 * torch.eye(
        3, dtype=gxf.dtype, device=gxf.device)
    return inv_spd(H)


def _level_dims(lvl_c, h: int, w: int, dtype):
    return (w >> lvl_c).to(dtype), (h >> lvl_c).to(dtype)


def _align_plain(stack, lvl, T, gx, gy, hinv, uv0, valid, n_iter: int,
                 half: int, h: int, w: int, updates: list | None = None):
    """Plain version of align_iclk_kernel (port of _align_fallback).  A
    fixed-count loop: each feature freezes once done, which is what the JAX
    while-loop computes without its early global exit."""
    n = lvl.shape[0]
    p = 2 * half
    area = p * p
    dtype = uv0.dtype
    Tf = T.reshape(n, area)
    J = torch.stack([gx.reshape(n, area), gy.reshape(n, area),
                     torch.ones((n, area), dtype=dtype, device=uv0.device)],
                    dim=-1)
    lvl = torch.clamp(lvl.to(torch.int64), 0, stack.shape[0] - 1)
    wl, hl = _level_dims(lvl, h, w, dtype)
    m = half + 1.0

    def inb(uv):
        return ((uv[..., 0] >= m) & (uv[..., 0] < wl - 1 - m)
                & (uv[..., 1] >= m) & (uv[..., 1] < hl - 1 - m))

    def step(uv, mean):
        cur = _sample_plain(stack, lvl, uv, half, False).reshape(n, area)
        r = cur - Tf + mean[:, None]
        g = torch.einsum("nai,na->ni", J, r)
        return torch.einsum("nij,nj->ni", hinv, g)

    uv = uv0
    mean = torch.zeros((n,), dtype=dtype, device=uv0.device)
    done = torch.zeros((n,), dtype=torch.bool, device=uv0.device)
    for _ in range(n_iter):
        ok = valid & inb(uv) & ~done
        if updates is not None:
            updates.append(int(ok.sum()))
        upd = step(uv, mean)
        uv = torch.where(ok[:, None], uv - upd[:, :2], uv)
        mean = torch.where(ok, mean - upd[:, 2], mean)
        step2 = torch.sum(upd[:, :2] ** 2, dim=-1)
        done = done | ~inb(uv) | (step2 < MIN_UPDATE_SQUARED)
    ok = valid & inb(uv)
    upd = step(uv, mean)
    step2 = torch.where(ok, torch.sum(upd[:, :2] ** 2, dim=-1),
                        torch.full_like(mean, float("inf")))
    return uv, mean, step2


def _align_kernel(stack, lvl, T, gx, gy, hinv, uv0, valid, n_iter: int,
                  half: int, h: int, w: int):
    dev = stack.device
    n = lvl.shape[0]
    p = 2 * half
    if p * p > 128:
        raise ValueError("align_iclk_kernel takes patches of at most 128 px")
    out_uv = torch.empty((n, 2), dtype=torch.float32, device=dev)
    out_mean = torch.empty((n,), dtype=torch.float32, device=dev)
    out_step2 = torch.empty((n,), dtype=torch.float32, device=dev)
    if n:
        args = [_i32(lvl, dev), _f32(T, dev, (n, p, p)),
                _f32(gx, dev, (n, p, p)), _f32(gy, dev, (n, p, p)),
                _f32(hinv, dev, (n, 3, 3)), _f32(_nan0(uv0), dev, (n, 2)),
                _b8(valid, dev)]
        _launch("align_iclk_kernel", "launch_align_iclk", *_stack_args(stack),
                int(h), int(w), *[_ptr(a) for a in args], n, int(n_iter),
                half, _ptr(out_uv), _ptr(out_mean), _ptr(out_step2),
                _stream(stack))
    return out_uv, out_mean, out_step2


def align_iclk(stack, lvl, ref_patch, ref_dx, ref_dy, init_uv, valid,
               n_iter: int, h: int | None = None, w: int | None = None,
               use_pallas=True):
    """Batched 2D inverse-compositional LK with mean-brightness term at
    per-feature pyramid level.  Returns (uv, converged, mean_diff)."""
    L, hp, wp = stack.shape
    h = hp if h is None else h
    w = wp if w is None else w
    p = ref_patch.shape[1]
    hinv = _iclk_hinv(ref_dx, ref_dy)
    fn = _align_kernel if _on_card(stack, use_pallas) else _align_plain
    uv, mean, step2 = fn(stack, lvl, ref_patch, ref_dx, ref_dy, hinv,
                         init_uv, valid, n_iter, p // 2, h, w)
    drift = torch.linalg.norm(uv - init_uv, dim=-1)
    converged = valid & (step2 < 4.0 * MIN_UPDATE_SQUARED) & (drift < p)
    return uv, converged, mean


# ---------------------------------------------------------------------------
# window-staged ICLK (align_iclk_mxu)
# ---------------------------------------------------------------------------

def _window_origin(stack, uv):
    L, hp, wp = stack.shape
    xi = torch.clamp(torch.floor(uv[:, 0]).to(torch.int32) - DUMP_WC // 2,
                     0, wp - (DUMP_WC + 1))
    yi = torch.clamp(torch.floor(uv[:, 1]).to(torch.int32) - DUMP_WR // 2,
                     0, hp - (DUMP_WR + 1))
    return torch.stack([xi, yi], dim=-1)


def dump_windows_plain(stack, lvl, uv, valid=None):
    """One (DUMP_WR, DUMP_WC) window per feature around integer(uv), plus the
    window origin (xi, yi) — port of dump_windows' fallback path.  The
    window kernel stages the same window in shared memory instead of
    writing it out."""
    L, hp, wp = stack.shape
    uv = _nan0(uv)
    org = _window_origin(stack, uv)
    lvl_c = torch.clamp(lvl.to(torch.int64), 0, L - 1)
    # dynamic_slice semantics: the start is clamped so the window fits
    sx = org[:, 0].to(torch.int64).clamp(0, max(wp - DUMP_WC, 0))
    sy = org[:, 1].to(torch.int64).clamp(0, max(hp - DUMP_WR, 0))
    rr = torch.arange(DUMP_WR, device=stack.device)
    cc = torch.arange(DUMP_WC, device=stack.device)
    rows = (sy[:, None] + rr[None, :])[:, :, None]
    cols = (sx[:, None] + cc[None, :])[:, None, :]
    wins = stack[lvl_c[:, None, None], rows, cols]
    return wins, org


def _onehot_patch(wins, u, v, p: int):
    """(N, p, p) bilinear patches at window coords (u, v) via two one-hot
    batched products (separable axis-aligned bilinear), as the JAX package
    computes them."""
    dtype = wins.dtype
    dev = wins.device
    half = p // 2
    offs = torch.arange(p, dtype=dtype, device=dev) - half
    ys = v[:, None] + offs[None, :]
    xs = u[:, None] + offs[None, :]
    yi = torch.floor(ys)
    xi = torch.floor(xs)
    wy = ys - yi
    wx = xs - xi
    rr = torch.arange(DUMP_WR, dtype=dtype, device=dev)
    cc = torch.arange(DUMP_WC, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    Rm = (torch.where(rr[None, None] == yi[..., None], 1 - wy[..., None], zero)
          + torch.where(rr[None, None] == yi[..., None] + 1, wy[..., None],
                        zero))
    Cm = (torch.where(cc[None, None] == xi[..., None], 1 - wx[..., None], zero)
          + torch.where(cc[None, None] == xi[..., None] + 1, wx[..., None],
                        zero))
    t = torch.einsum("nrc,nbc->nbr", wins, Cm)
    return torch.einsum("nbr,nar->nab", t, Rm)


def _align_mxu_plain(stack, lvl, T, gx, gy, hinv, uv0, valid, n_iter: int,
                     half: int, h: int, w: int, updates: list | None = None):
    """Plain version of align_iclk_window_kernel: dump_windows_plain plus
    the one-hot ICLK of align_iclk_mxu (fixed-count loop with per-feature
    freeze).  Returns (uv, mean, step2, zmssd score, population std) of the
    final resample."""
    n = lvl.shape[0]
    p = 2 * half
    area = p * p
    dtype = T.dtype
    wins, org = dump_windows_plain(stack, lvl, uv0, valid)
    orgf = org.to(dtype)
    lvl_c = torch.clamp(lvl.to(torch.int64), 0, stack.shape[0] - 1)
    wl, hl = _level_dims(lvl_c, h, w, dtype)
    m = half + 1.0
    wb = half + 2.0

    def inb(u, v):
        lvl_ok = (u >= m) & (u < wl - 1 - m) & (v >= m) & (v < hl - 1 - m)
        win_ok = ((u - orgf[:, 0] >= wb) & (u - orgf[:, 0] < DUMP_WC - 1 - wb)
                  & (v - orgf[:, 1] >= wb)
                  & (v - orgf[:, 1] < DUMP_WR - 1 - wb))
        return lvl_ok & win_ok

    def step(u, v, mean):
        cur = _onehot_patch(wins, u - orgf[:, 0], v - orgf[:, 1], p)
        r = cur - T + mean[:, None, None]
        g = torch.stack([torch.sum(gx * r, dim=(1, 2)),
                         torch.sum(gy * r, dim=(1, 2)),
                         torch.sum(r, dim=(1, 2))], dim=-1)
        return torch.einsum("nij,nj->ni", hinv, g), cur

    u = uv0[:, 0]
    v = uv0[:, 1]
    mean = torch.zeros((n,), dtype=dtype, device=uv0.device)
    done = torch.zeros((n,), dtype=torch.bool, device=uv0.device)
    for _ in range(n_iter):
        ok = valid & inb(u, v) & ~done
        if updates is not None:
            updates.append(int(ok.sum()))
        upd, _ = step(u, v, mean)
        u = torch.where(ok, u - upd[:, 0], u)
        v = torch.where(ok, v - upd[:, 1], v)
        mean = torch.where(ok, mean - upd[:, 2], mean)
        step2 = upd[:, 0] ** 2 + upd[:, 1] ** 2
        done = done | ~inb(u, v) | (step2 < MIN_UPDATE_SQUARED)
    ok = valid & inb(u, v)
    upd, cur = step(u, v, mean)
    step2 = torch.where(ok, upd[:, 0] ** 2 + upd[:, 1] ** 2,
                        torch.full_like(u, float("inf")))
    curf = cur.reshape(n, area)
    rz = T.reshape(n, area)
    rz = rz - rz.mean(dim=-1, keepdim=True)
    cz = curf - curf.mean(dim=-1, keepdim=True)
    score = torch.sum((cz - rz) ** 2, dim=-1)
    std = curf.std(dim=-1, correction=0)
    return torch.stack([u, v], dim=-1), mean, step2, score, std


def _align_window_kernel(stack, lvl, T, gx, gy, hinv, uv0, valid,
                         n_iter: int, half: int, h: int, w: int):
    dev = stack.device
    n = lvl.shape[0]
    p = 2 * half
    if (p * p) % 32 or p * p > 1024:
        raise ValueError("align_iclk_window_kernel takes patches whose area "
                         "is a multiple of 32, at most 1024 px")
    outs = [torch.empty(s, dtype=torch.float32, device=dev)
            for s in ((n, 2), (n,), (n,), (n,), (n,))]
    if n:
        uv0_c = _f32(uv0, dev, (n, 2))
        org = _window_origin(stack, uv0_c).contiguous()
        args = [_i32(lvl, dev), org, _f32(T, dev, (n, p, p)),
                _f32(gx, dev, (n, p, p)), _f32(gy, dev, (n, p, p)),
                _f32(hinv, dev, (n, 3, 3)), uv0_c, _b8(valid, dev)]
        _launch("align_iclk_window_kernel", "launch_align_iclk_window",
                *_stack_args(stack), int(h), int(w), *[_ptr(a) for a in args],
                n, int(n_iter), half, *[_ptr(o) for o in outs],
                _stream(stack))
    return tuple(outs)


def align_iclk_mxu(stack, lvl, ref_patch, ref_dx, ref_dy, init_uv, valid,
                   n_iter: int, h: int | None = None, w: int | None = None,
                   use_pallas=True, zmssd_factor: float | None = None,
                   min_patch_std: float | None = None):
    """align_iclk on a per-feature window staged once (the JAX package's
    align_iclk_mxu), with the direct-match appearance gates computed from
    the final resample: `converged` folds in `score < zmssd_factor * area`
    and `std >= min_patch_std` when they are given."""
    L, hp, wp = stack.shape
    h = hp if h is None else h
    w = wp if w is None else w
    n, p, _ = ref_patch.shape
    area = p * p
    hinv = _iclk_hinv(ref_dx, ref_dy)
    init_uv = _nan0(init_uv)
    fn = (_align_window_kernel if _on_card(stack, use_pallas)
          else _align_mxu_plain)
    uv, mean, step2, score, std = fn(stack, lvl, ref_patch, ref_dx, ref_dy,
                                     hinv, init_uv, valid, n_iter, p // 2,
                                     h, w)
    drift = torch.linalg.norm(uv - init_uv, dim=-1)
    converged = valid & (step2 < 4.0 * MIN_UPDATE_SQUARED) & (drift < p)
    if zmssd_factor is not None:
        converged = converged & (score < zmssd_factor * area)
    if min_patch_std is not None:
        converged = converged & (std >= min_patch_std)
    return uv, converged, mean


def count_iclk_updates(stack, lvl, ref_patch, ref_dx, ref_dy, init_uv, valid,
                       n_iter: int, h: int, w: int, window: bool) -> int:
    """ICLK updates the inputs need (features x iterations before each
    feature freezes), counted by the plain version: the data-dependent work
    of align_iclk (window=False) or align_iclk_mxu (window=True)."""
    hinv = _iclk_hinv(ref_dx, ref_dy)
    updates: list = []
    fn = _align_mxu_plain if window else _align_plain
    if window:
        init_uv = _nan0(init_uv)
    fn(stack, lvl, ref_patch, ref_dx, ref_dy, hinv, init_uv, valid, n_iter,
       ref_patch.shape[1] // 2, h, w, updates=updates)
    return sum(updates)
