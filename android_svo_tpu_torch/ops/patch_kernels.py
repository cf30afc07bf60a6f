"""Scattered bilinear patch work — the port of
`android_svo_tpu/ops/patch_pallas.py`.

Four hand-written CUDA kernels (`csrc/patch_kernels.cu`), each with its
plain PyTorch version beside it:

  kernel                      replaces (patch_pallas.py)          plain version
  sample_patches_kernel       _sample_pallas                      _sample_plain
  epi_scan_kernel             _scan_pallas + the rest of          _scan_plain
                              epi_scan (centring, nan_to_num)
  align_iclk_kernel           _align_pallas + the rest of         _align_plain
                              align_iclk (Hessian, convergence)
  align_iclk_window_kernel    _dump_pallas + the rest of          dump_windows_plain +
                              align_iclk_mxu (Hessian, one-hot    _align_mxu_plain
                              einsum ICLK, gates)

Dispatch: a wrapper launches the kernel when `use_pallas` is true and its
tensors lie on a CUDA device, and takes the plain version only for CPU
tensors (or when `use_pallas` is false).  On a CUDA tensor it launches or
raises; there is no fallback.  Every launch adds one to `LAUNCHES[name]`.
No wrapper converts anything on CUDA: each makes its output allocations and
one launch, and raises on inputs of another type or device (at the
tracking path's sizes the kernels take microseconds on an NVIDIA H100 80GB
HBM3 at 700 W, less than the dozens of small tensor ops they used to sit
between).

Layout contract as in the JAX package: the stack is `(L, Hp, Wp)` with level
l in the top-left `(h>>l, w>>l)` corner; uv are level-pixel coordinates; the
plain versions compute every slot, the kernels write zeros (or the initial
position) for dead ones, so compare valid slots only.
"""

from __future__ import annotations

import torch

from android_svo_tpu_torch.geometry.linsolve import inv_spd
from android_svo_tpu_torch.ops import interp
from android_svo_tpu_torch.ops.cuda_build import (check, contiguous,
                                                  launch, stream)

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
# argument packing (the shared checks and launch: `ops/cuda_build.py`)
# ---------------------------------------------------------------------------

def _stack_args(stack: torch.Tensor):
    if stack.dtype is not torch.float32 or stack.dim() != 3:
        raise ValueError(f"stack must be (L, H, W) float32, got "
                         f"{tuple(stack.shape)} {stack.dtype}")
    s = stack.stride()
    if s[2] != 1:
        raise ValueError("stack rows must be contiguous (stride(2) == 1)")
    L, H, W = stack.shape
    return (stack.data_ptr(), s[0], s[1], L, H, W)


def _patch_args(t, name: str, n: int, p: int, device: int):
    """(pointer, stride(0), stride(1)) of an (n, p, p) float32 patch tensor
    with contiguous rows (patch_gradients' strided interior view passes)."""
    check(t, name, torch.float32, (n, p, p), device)
    s = t.stride()
    if n and s[2] != 1:
        raise ValueError(f"{name} rows must be contiguous (stride(2) == 1)")
    return (t.data_ptr(), s[0], s[1])


def _nan0(t):
    return torch.nan_to_num(t, nan=0.0, posinf=0.0, neginf=0.0)


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
    """One allocation and one launch: the kernel zeroes non-finite uv, reads
    uv through its strides and takes a null `valid` as all live, so nothing
    is converted here; inputs of another type or device raise."""
    n = uv.shape[0]
    p = 2 * half
    dev = stack.get_device()
    if half < 1:
        raise ValueError(f"half must be >= 1, got {half}")
    check(uv, "uv", torch.float32, (n, 2), dev)
    check(lvl, "lvl", torch.int32, (n,), dev)
    contiguous(lvl, "lvl")
    if valid is not None:
        check(valid, "valid", torch.bool, (n,), dev)
        contiguous(valid, "valid")
    out = torch.empty((3, n, p, p) if grad else (n, p, p),
                      dtype=torch.float32, device=stack.device)
    if n:
        su = uv.stride()
        launch(LAUNCHES, "sample_patches_kernel", "launch_sample_patches",
               *_stack_args(stack), lvl.data_ptr(), uv.data_ptr(), su[0],
               su[1], None if valid is None else valid.data_ptr(), n, half,
               int(grad), out.data_ptr(), stream(dev))
    return out.unbind(0) if grad else out


def sample_patches(stack, lvl, uv, half: int, grad: bool = False,
                   valid=None, use_pallas=True):
    """Bilinear (2*half)^2 patches (optionally with central-difference
    gradients) at per-feature pyramid level `lvl` and level-coords `uv`.
    Returns (N, P, P) or a (patch, dx, dy) triple when grad=True.

    On CUDA the kernel takes float32 uv (any strides; NaN and +-inf read as
    0, as the JAX kernel path's nan_to_num), int32 `lvl` and bool `valid`
    (or None: every slot live), and raises on other types; the wrapper
    makes one allocation and one launch.  The kernel runs at the launch
    floor (1.8 us at the sparse-align call's shapes on an NVIDIA H100 80GB
    HBM3 at 700 W, against a bound of 0.04 us), so a call costs what the
    host spends on it: the checks, the allocation and the ctypes call.  On the CPU the plain version
    computes every slot from uv as given."""
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


def _scan_kernel(stack, lvl, uv_a, uv_b, n_steps_each, ref_patch,
                 n_steps_max: int, half: int, h: int, w: int):
    """The whole of epi_scan in one launch (the kernel centres the
    reference, zeroes non-finite segment ends and reads uv and the reference
    through their strides; a None `n_steps_each` is a null pointer); the
    host allocates the two outputs and converts nothing."""
    dev = stack.get_device()
    n = lvl.shape[0]
    p = 2 * half
    if not 0 < p * p <= 128:
        raise ValueError(f"epi_scan_kernel takes patches of 1 to 128 px, got "
                         f"half={half}")
    stack_args = _stack_args(stack)
    if h > stack_args[4] or w > stack_args[5]:
        # the kernel reads in-bounds taps without clamps
        raise ValueError(f"image dims {h}x{w} exceed the stack's "
                         f"{stack_args[4]}x{stack_args[5]}")
    ref = _patch_args(ref_patch, "ref_patch", n, p, dev)
    check(uv_a, "uv_a", torch.float32, (n, 2), dev)
    check(uv_b, "uv_b", torch.float32, (n, 2), dev)
    check(lvl, "lvl", torch.int32, (n,), dev)
    contiguous(lvl, "lvl")
    if n_steps_each is not None:
        check(n_steps_each, "n_steps_each", torch.int32, (n,), dev)
        contiguous(n_steps_each, "n_steps_each")
    best_t = torch.empty((n,), dtype=torch.float32, device=stack.device)
    best_s = torch.empty((n,), dtype=torch.float32, device=stack.device)
    if n:
        sa, sb = uv_a.stride(), uv_b.stride()
        launch(LAUNCHES, "epi_scan_kernel", "launch_epi_scan", *stack_args,
               int(h), int(w), lvl.data_ptr(), uv_a.data_ptr(), sa[0], sa[1],
               uv_b.data_ptr(), sb[0], sb[1],
               None if n_steps_each is None else n_steps_each.data_ptr(),
               *ref, n, int(n_steps_max), half,
               best_t.data_ptr(), best_s.data_ptr(), stream(dev))
    return best_t, best_s


def epi_scan(stack, lvl, uv_a, uv_b, ref_patch, n_steps_max: int,
             half: int = 4, n_steps_each=None, h: int | None = None,
             w: int | None = None, use_pallas=True):
    """Best ZMSSD match along each seed's epipolar segment: scans
    `n_steps_each[i]` (clipped to [0, n_steps_max]; None: n_steps_max)
    uniform positions from uv_a to uv_b; returns (t_best in [0,1], score),
    the first minimum.  Positions outside the TRUE level dims (h>>l, w>>l)
    with margin half+2 score +inf; a seed with none in bounds (or 0 steps)
    gives (0, +inf).

    On CUDA one launch of epi_scan_kernel computes all of it: the wrapper
    allocates the two outputs and raises on inputs that are not float32 uv
    and reference patches (any strides; the patches' rows contiguous) and
    int32 `lvl` / `n_steps_each` on the stack's device.  On the CPU the
    plain version runs on the centred reference."""
    L, hp, wp = stack.shape
    h = hp if h is None else h
    w = wp if w is None else w
    if _on_card(stack, use_pallas):
        return _scan_kernel(stack, lvl, uv_a, uv_b, n_steps_each, ref_patch,
                            n_steps_max, half, h, w)
    if n_steps_each is None:
        n_steps_each = torch.full(lvl.shape, n_steps_max, dtype=torch.int32,
                                  device=lvl.device)
    rp = ref_patch.reshape(ref_patch.shape[0], -1)
    rp = (rp - rp.mean(dim=-1, keepdim=True)).reshape(ref_patch.shape)
    return _scan_plain(stack, lvl, uv_a, uv_b, n_steps_each, rp, n_steps_max,
                       half, h, w)


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


def _iclk_launch(name: str, fn_name: str, stack, lvl, T, gx, gy, uv0, valid,
                 n_iter: int, h: int, w: int, gates: tuple = ()):
    """Checks, the three output allocations and the one launch of an ICLK
    kernel (`gates`: the window kernel's gate flags and levels); inputs of
    another type, shape, layout or device raise before any allocation."""
    dev = stack.get_device()
    n, p = T.shape[0], T.shape[-1]
    if p % 2 or not 0 < p * p <= 128:
        raise ValueError(f"{name} takes even patch sides of at most 128 px, "
                         f"got {tuple(T.shape)}")
    stack_args = _stack_args(stack)
    args = [*_patch_args(T, "ref_patch", n, p, dev),
            *_patch_args(gx, "ref_dx", n, p, dev),
            *_patch_args(gy, "ref_dy", n, p, dev)]
    check(uv0, "init_uv", torch.float32, (n, 2), dev)
    check(lvl, "lvl", torch.int32, (n,), dev)
    contiguous(lvl, "lvl")
    check(valid, "valid", torch.bool, (n,), dev)
    contiguous(valid, "valid")
    device = stack.device
    out_uv = torch.empty((n, 2), dtype=torch.float32, device=device)
    out_conv = torch.empty((n,), dtype=torch.bool, device=device)
    out_mean = torch.empty((n,), dtype=torch.float32, device=device)
    if n:
        su = uv0.stride()
        launch(LAUNCHES, name, fn_name, *stack_args, int(h), int(w),
               lvl.data_ptr(), *args, uv0.data_ptr(), su[0], su[1],
               valid.data_ptr(), n, int(n_iter), p // 2, *gates,
               out_uv.data_ptr(), out_conv.data_ptr(), out_mean.data_ptr(),
               stream(dev))
    return out_uv, out_conv, out_mean


def _align_kernel(stack, lvl, T, gx, gy, uv0, valid, n_iter: int, h: int,
                  w: int):
    """The whole of align_iclk in one launch (Hessian and inverse,
    NaN-zeroing, ICLK and convergence in the kernel)."""
    return _iclk_launch("align_iclk_kernel", "launch_align_iclk", stack, lvl,
                        T, gx, gy, uv0, valid, n_iter, h, w)


def align_iclk(stack, lvl, ref_patch, ref_dx, ref_dy, init_uv, valid,
               n_iter: int, h: int | None = None, w: int | None = None,
               use_pallas=True):
    """Batched 2D inverse-compositional LK with mean-brightness term at
    per-feature pyramid level.  Returns (uv, converged, mean_diff);
    `converged` measures the drift from `init_uv` as given, so a non-finite
    start never converges.

    On CUDA one launch of align_iclk_kernel computes all of it; the wrapper
    allocates the outputs and raises on inputs that are not float32
    patches (any strides with contiguous rows) and uv, int32 `lvl` and bool
    `valid` on the stack's device.  The kernel starts from `init_uv` with
    NaN and +-inf read as 0 and returns that start for dead slots.  On the
    CPU the plain version runs from `init_uv` as given."""
    L, hp, wp = stack.shape
    h = hp if h is None else h
    w = wp if w is None else w
    if _on_card(stack, use_pallas):
        return _align_kernel(stack, lvl, ref_patch, ref_dx, ref_dy, init_uv,
                             valid, n_iter, h, w)
    p = ref_patch.shape[1]
    hinv = _iclk_hinv(ref_dx, ref_dy)
    uv, mean, step2 = _align_plain(stack, lvl, ref_patch, ref_dx, ref_dy,
                                   hinv, init_uv, valid, n_iter, p // 2, h, w)
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
    window kernel reads this window's pixels in place, through the window's
    own index clamps, instead of writing it out."""
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


def _align_window_kernel(stack, lvl, T, gx, gy, uv0, valid, n_iter: int,
                         h: int, w: int, zmssd_factor, min_patch_std):
    """The whole of align_iclk_mxu in one launch (Hessian and inverse,
    NaN-zeroing, window origin, ICLK, convergence and gates in the kernel)."""
    p = T.shape[-1]
    zmssd_on = zmssd_factor is not None
    std_on = min_patch_std is not None
    gates = (int(zmssd_on), float(zmssd_factor) * p * p if zmssd_on else 0.0,
             int(std_on), float(min_patch_std) if std_on else 0.0)
    return _iclk_launch("align_iclk_window_kernel", "launch_align_iclk_window",
                        stack, lvl, T, gx, gy, uv0, valid, n_iter, h, w, gates)


def align_iclk_mxu(stack, lvl, ref_patch, ref_dx, ref_dy, init_uv, valid,
                   n_iter: int, h: int | None = None, w: int | None = None,
                   use_pallas=True, zmssd_factor: float | None = None,
                   min_patch_std: float | None = None):
    """align_iclk on a per-feature window staged once (the JAX package's
    align_iclk_mxu), with the direct-match appearance gates computed from
    the final resample: `converged` folds in `score < zmssd_factor * area`
    and `std >= min_patch_std` when they are given.

    On CUDA one launch of align_iclk_window_kernel computes all of it; the
    wrapper allocates the outputs and raises on inputs that are not float32
    patches (any strides with contiguous rows) and uv, int32 `lvl` and bool
    `valid` on the stack's device.  The kernel is bound by the dependent
    chain of each feature's iterations (one warp each: 8.8-9.0 us at 768
    features on an NVIDIA H100 80GB HBM3 at 700 W, against a bytes bound
    of 0.34 us); the host's checks, three allocations and the ctypes call
    cost more.  On the CPU the plain
    version runs."""
    L, hp, wp = stack.shape
    h = hp if h is None else h
    w = wp if w is None else w
    if _on_card(stack, use_pallas):
        return _align_window_kernel(stack, lvl, ref_patch, ref_dx, ref_dy,
                                    init_uv, valid, n_iter, h, w,
                                    zmssd_factor, min_patch_std)
    n, p, _ = ref_patch.shape
    area = p * p
    hinv = _iclk_hinv(ref_dx, ref_dy)
    init_uv = _nan0(init_uv)
    uv, mean, step2, score, std = _align_mxu_plain(
        stack, lvl, ref_patch, ref_dx, ref_dy, hinv, init_uv, valid, n_iter,
        p // 2, h, w)
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
