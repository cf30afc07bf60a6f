"""Scattered bilinear patch work — the port of
`android_svo_tpu/ops/patch_pallas.py`.

Five hand-written CUDA kernels (`csrc/patch_kernels.cu`), each with its
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
  dump_windows_kernel         _dump_pallas + the rest of          dump_windows_plain
                              dump_windows (origin, nan_to_num)

The window ICLK reads its window in place; `dump_windows_kernel` writes the
windows out and runs only through the public `dump_windows` (and its
batched form), which no tracking path calls.

Dispatch: a wrapper launches the kernel when `use_pallas` is true or None
(the JAX package's "auto", `cfg_use_pallas`) and its tensors lie on a CUDA
device, and takes the plain version only for CPU tensors (or when
`use_pallas` is false).  On a CUDA tensor it launches or raises; there is no
fallback.  Every launch adds one to `LAUNCHES[name]`.
No wrapper converts anything on CUDA: each makes its output allocations and
one launch, and raises on inputs of another type or device (at the
tracking path's sizes the kernels take microseconds on an NVIDIA H100 80GB
HBM3 at 700 W, less than the dozens of small tensor ops they used to sit
between).

Layout contract as in the JAX package: the stack is `(L, Hp, Wp)` with level
l in the top-left `(h>>l, w>>l)` corner; uv are level-pixel coordinates; the
plain versions compute every slot, the kernels write zeros (or the initial
position) for dead ones, so compare valid slots only.

Batches: each wrapper is a `torch.library.custom_op` (namespace `svo_torch`)
with a `register_vmap` rule, the counterpart of the Pallas batching rule
that gives a `pallas_call` under `jax.vmap` a batch grid axis.  Under
`torch.func.vmap` the rule calls the `*_batched` form: a `(B, L, Hp, Wp)`
stack (an unbatched stack is read with batch stride 0) and `(B, N, ...)`
features, B*N rows for one allocation per output and ONE launch for the
whole batch (`LAUNCHES` adds one per batched call; the sampler and the
ICLKs read the (B, N) rows in place, the others flatten them); on the
CPU the batched plain version runs the per-frame plain version on the B*L
planes, each feature reading plane b*L + level.  Outside a `torch.func`
transform a wrapper calls its op's body directly (`call_op`): the single path
pays no dispatcher cost, and its ATen ops are those of the body.

Each call is one span `patch.<function>` (`utils/profiling.py`): the body
and the batched form each open it, and a call runs exactly one of them
(the body alone, or the vmap rule's batched form alone).
"""

from __future__ import annotations

import functools

import torch

from android_svo_tpu_torch.geometry.linsolve import inv_spd
from android_svo_tpu_torch.ops import interp
# cfg_use_pallas: the JAX module's name for the knob's reading, kept here
from android_svo_tpu_torch.ops.cuda_build import (  # noqa: F401
    batch_first, call_op, cfg_use_pallas, check, contiguous, launch, on_card,
    stream, use_kernels)
from android_svo_tpu_torch.utils import profiling

# feature_alignment.cpp:276: min_update_squared = 0.03*0.03
MIN_UPDATE_SQUARED = 0.03 * 0.03
DUMP_WR = 32     # ICLK window rows
DUMP_WC = 64     # ICLK window cols

LAUNCHES = {
    "sample_patches_kernel": 0,
    "epi_scan_kernel": 0,
    "align_iclk_kernel": 0,
    "align_iclk_window_kernel": 0,
    "dump_windows_kernel": 0,
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _spanned(function: str):
    """Run the decorated body or batched form inside span
    `patch.<function>`."""
    name = "patch." + function

    def wrap(fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with profiling.span(name):
                return fn(*args, **kwargs)
        return spanned
    return wrap


def _planes(stack: torch.Tensor, lvl: torch.Tensor, wrap: bool):
    """A (B, L, Hp, Wp) stack as B*L planes, and the plane each of the
    (B, N) features reads: b*L + its level, normalised as the per-frame
    plain version normalises it (the sampler and the scan count a negative
    level from the end, `wrap`; the ICLKs clamp it), so every feature reads
    what it reads in its own frame."""
    B, L = stack.shape[:2]
    lv = lvl.to(torch.int64)
    if wrap:
        lv = torch.where(lv < 0, lv + L, lv)
    lv = lv.clamp(0, L - 1)
    base = torch.arange(B, device=lvl.device)[:, None] * L
    return stack.reshape((B * L,) + stack.shape[2:]), (base + lv).reshape(-1)


# ---------------------------------------------------------------------------
# argument packing (the shared checks and launch: `ops/cuda_build.py`)
# ---------------------------------------------------------------------------

def _stack_args(stack: torch.Tensor):
    """(pointer, s_b, s_l, s_r, L, H, W) of an (L, H, W) stack (s_b = 0) or
    a (B, L, H, W) batch of stacks, any strides with contiguous rows."""
    if stack.dtype is not torch.float32 or stack.dim() not in (3, 4):
        raise ValueError(f"stack must be (L, H, W) or (B, L, H, W) float32, "
                         f"got {tuple(stack.shape)} {stack.dtype}")
    s = stack.stride()
    if s[-1] != 1:
        raise ValueError("stack rows must be contiguous (stride(-1) == 1)")
    L, H, W = stack.shape[-3:]
    s_b = s[0] if stack.dim() == 4 else 0
    return (stack.data_ptr(), s_b, s[-3], s[-2], L, H, W)


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


def _sample_plain_batched(stack, lvl, uv, half: int, grad: bool):
    """Batched plain version: stack (B, L, Hp, Wp), lvl (B, N), uv
    (B, N, 2); `_sample_plain` on the B*L planes."""
    B, N = lvl.shape
    planes, plane = _planes(stack, lvl, wrap=True)
    out = _sample_plain(planes, plane, uv.reshape(B * N, 2), half, grad)
    if not grad:
        return out.reshape(B, N, 2 * half, 2 * half)
    return tuple(o.reshape(B, N, 2 * half, 2 * half) for o in out)


def _sample_kernel(stack, lvl, uv, half: int, grad: bool, valid):
    """One allocation and one launch: the kernel zeroes non-finite uv, reads
    uv through its strides and takes a null `valid` as all live, so nothing
    is converted here; inputs of another type or device raise.  `lvl` is
    (N,), or (B, N) for a (B, L, Hp, Wp) stack: B * N rows, row i reading
    frame i // N, with uv and valid of the same leading shape, read in
    place (no view is made: each costs microseconds of host time beside a
    launch of a few); the output is `lvl.shape + (P, P)`, with a leading 3
    (patch, dx, dy) when grad is set."""
    rows = lvl.shape
    n = lvl.numel()
    p = 2 * half
    dev = stack.get_device()
    if half < 1:
        raise ValueError(f"half must be >= 1, got {half}")
    if len(rows) not in (1, 2) or (len(rows) == 2 and stack.dim() == 4
                                   and stack.shape[0] != rows[0]):
        raise ValueError(f"lvl {tuple(rows)} is not (N,) or one row of N "
                         f"per frame of a {tuple(stack.shape)} stack")
    check(lvl, "lvl", torch.int32, rows, dev)
    contiguous(lvl, "lvl")
    check(uv, "uv", torch.float32, (*rows, 2), dev)
    su = uv.stride()
    if len(rows) == 2 and rows[0] > 1 and su[0] != rows[1] * su[1]:
        uv = uv.reshape(n, 2)           # frames at no common row stride
        su = uv.stride()
    if valid is not None:
        check(valid, "valid", torch.bool, rows, dev)
        contiguous(valid, "valid")
    out = torch.empty((3, *rows, p, p) if grad else (*rows, p, p),
                      dtype=torch.float32, device=stack.device)
    if n:
        launch(LAUNCHES, "sample_patches_kernel", "launch_sample_patches",
               *_stack_args(stack), lvl.data_ptr(), uv.data_ptr(), su[-2],
               su[-1], None if valid is None else valid.data_ptr(), n,
               rows[-1], half, int(grad), out.data_ptr(), stream(dev))
    return out


@_spanned("sample_patches")
def _sample_body(stack, lvl, uv, half, grad, valid, use_pallas):
    if on_card(stack, use_pallas):
        return _sample_kernel(stack, lvl, uv, half, grad, valid)
    out = _sample_plain(stack, lvl, uv, half, grad)
    return torch.stack(out) if grad else out


_sample_op = torch.library.custom_op(
    "svo_torch::sample_patches", _sample_body, mutates_args=(),
    schema="(Tensor stack, Tensor lvl, Tensor uv, int half, bool grad, "
           "Tensor? valid, bool use_pallas) -> Tensor")


@_spanned("sample_patches")
def sample_patches_batched(stack, lvl, uv, half: int, grad: bool = False,
                           valid=None, use_pallas=True):
    """sample_patches for a batch: stack (B, L, Hp, Wp), lvl (B, N), uv
    (B, N, 2), valid (B, N) or None.  Returns (B, N, P, P), or the
    (patch, dx, dy) triple.  On CUDA one launch for all B*N features,
    reading the (B, N) rows in place; a mask or level tensor whose rows
    are not contiguous (a vmap rule's moved or expanded argument) is made
    so."""
    if on_card(stack, use_pallas):
        out = _sample_kernel(stack, lvl.contiguous(), uv, half, grad,
                             None if valid is None else valid.contiguous())
        return out.unbind(0) if grad else out
    return _sample_plain_batched(stack, lvl, uv, half, grad)


@_sample_op.register_vmap
def _sample_vmap(info, in_dims, stack, lvl, uv, half, grad, valid,
                 use_pallas):
    B = info.batch_size
    d_stack, d_lvl, d_uv, _, _, d_valid, _ = in_dims
    out = sample_patches_batched(
        batch_first(stack, d_stack, B), batch_first(lvl, d_lvl, B),
        batch_first(uv, d_uv, B), half, grad,
        batch_first(valid, d_valid, B), use_pallas)
    if grad:
        return torch.stack(out), 1
    return out, 0


def sample_patches(stack, lvl, uv, half: int, grad: bool = False,
                   valid=None, use_pallas=True):
    """Bilinear (2*half)^2 patches (optionally with central-difference
    gradients) at per-feature pyramid level `lvl` and level-coords `uv`.
    Returns (N, P, P) or a (patch, dx, dy) triple when grad=True.

    On CUDA the kernel takes float32 uv (any strides; NaN and +-inf read as
    0, as the JAX kernel path's nan_to_num), int32 `lvl` and bool `valid`
    (or None: every slot live), and raises on other types; the wrapper
    makes one allocation and one launch.  The kernel runs near the launch
    floor (1.6 us at the sparse-align call's shapes against a floor of
    1.15 us and a bound of 0.04 us on an NVIDIA H100 80GB HBM3 at 700 W),
    so a call costs what the host spends on it: the checks, the allocation,
    the ctypes call and the launch (tools/patch_ab.py's wrapper_split).  On
    the CPU the plain version computes every slot from uv as given.  Under
    `torch.func.vmap` the batch takes one launch (`sample_patches_batched`)."""
    out = call_op(_sample_op, _sample_body, stack, lvl, uv, half, grad,
                  valid, use_kernels(use_pallas))
    return out.unbind(0) if grad else out


# ---------------------------------------------------------------------------
# fused epipolar ZMSSD scan
# ---------------------------------------------------------------------------

def _scan_plain(stack, lvl, uv_a, uv_b, n_steps_each, ref_patch_zm,
                n_steps_max: int, half: int, h: int, w: int, plane=None,
                L: int | None = None):
    """Plain version of epi_scan_kernel (port of _scan_fallback).  `plane`
    (default: `lvl`) is the stack plane each seed samples and `L` (default:
    the stack's depth) the level count its level is normalised with: the
    batched version passes the B*L planes and the per-frame L."""
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
    plane = lvl if plane is None else plane
    cur = interp.bilinear_sample_stack(
        stack, plane[:, None].expand(n, n_steps_max).reshape(-1),
        coords.reshape(n * n_steps_max, -1, 2)).reshape(n, n_steps_max,
                                                        p * p)
    cur = cur - cur.mean(dim=-1, keepdim=True)
    d = cur - ref_patch_zm.reshape(n, 1, p * p)
    score = torch.sum(d * d, dim=-1)
    L = stack.shape[0] if L is None else L
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
                 n_steps_max: int, half: int, h: int, w: int,
                 n_per: int | None = None):
    """The whole of epi_scan in one launch (the kernel centres the
    reference, zeroes non-finite segment ends and reads uv and the reference
    through their strides; a None `n_steps_each` is a null pointer); the
    host allocates the two outputs and converts nothing.  A (B, L, Hp, Wp)
    stack takes B * n_per seeds, seed i reading frame i // n_per."""
    dev = stack.get_device()
    n = lvl.shape[0]
    p = 2 * half
    if not 0 < p * p <= 128:
        raise ValueError(f"epi_scan_kernel takes patches of 1 to 128 px, got "
                         f"half={half}")
    stack_args = _stack_args(stack)
    if h > stack_args[5] or w > stack_args[6]:
        # the kernel reads in-bounds taps without clamps
        raise ValueError(f"image dims {h}x{w} exceed the stack's "
                         f"{stack_args[5]}x{stack_args[6]}")
    ref = _row_args(ref_patch, "ref_patch", (n,), (p, p), dev)[1:]
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
               int(h), int(w), n if n_per is None else n_per,
               lvl.data_ptr(), uv_a.data_ptr(), sa[0], sa[1],
               uv_b.data_ptr(), sb[0], sb[1],
               None if n_steps_each is None else n_steps_each.data_ptr(),
               *ref, n, int(n_steps_max), half,
               best_t.data_ptr(), best_s.data_ptr(), stream(dev))
    return best_t, best_s


def _epi_scan_plain(stack, lvl, uv_a, uv_b, ref_patch, n_steps_max: int,
                    half: int, n_steps_each, h: int, w: int, plane=None,
                    L: int | None = None):
    """The whole of epi_scan's plain version: the centred reference, the
    default step count, `_scan_plain`."""
    if n_steps_each is None:
        n_steps_each = torch.full(lvl.shape, n_steps_max, dtype=torch.int32,
                                  device=lvl.device)
    rp = ref_patch.reshape(ref_patch.shape[0], -1)
    rp = (rp - rp.mean(dim=-1, keepdim=True)).reshape(ref_patch.shape)
    return _scan_plain(stack, lvl, uv_a, uv_b, n_steps_each, rp, n_steps_max,
                       half, h, w, plane=plane, L=L)


@_spanned("epi_scan")
def _scan_body(stack, lvl, uv_a, uv_b, ref_patch, n_steps_max, half,
               n_steps_each, h, w, use_pallas):
    if on_card(stack, use_pallas):
        return _scan_kernel(stack, lvl, uv_a, uv_b, n_steps_each, ref_patch,
                            n_steps_max, half, h, w)
    return _epi_scan_plain(stack, lvl, uv_a, uv_b, ref_patch, n_steps_max,
                           half, n_steps_each, h, w)


_scan_op = torch.library.custom_op(
    "svo_torch::epi_scan", _scan_body, mutates_args=(),
    schema="(Tensor stack, Tensor lvl, Tensor uv_a, Tensor uv_b, "
           "Tensor ref_patch, int n_steps_max, int half, "
           "Tensor? n_steps_each, int h, int w, bool use_pallas) "
           "-> (Tensor, Tensor)")


@_spanned("epi_scan")
def epi_scan_batched(stack, lvl, uv_a, uv_b, ref_patch, n_steps_max: int,
                     half: int = 4, n_steps_each=None, h: int | None = None,
                     w: int | None = None, use_pallas=True):
    """epi_scan for a batch: stack (B, L, Hp, Wp), lvl / n_steps_each
    (B, N), uv_a / uv_b (B, N, 2), ref_patch (B, N, P, P).  Returns
    (t_best, score), each (B, N).  On CUDA one launch for all B*N seeds."""
    B, N = lvl.shape
    L, hp, wp = stack.shape[-3:]
    h = hp if h is None else h
    w = wp if w is None else w
    p = ref_patch.shape[-1]
    flat = (lvl.reshape(B * N), uv_a.reshape(B * N, 2),
            uv_b.reshape(B * N, 2), ref_patch.reshape(B * N, p, p),
            None if n_steps_each is None else n_steps_each.reshape(B * N))
    if on_card(stack, use_pallas):
        t, sc = _scan_kernel(stack, flat[0], flat[1], flat[2], flat[4],
                             flat[3], n_steps_max, half, h, w, n_per=N)
    else:
        planes, plane = _planes(stack, lvl, wrap=True)
        t, sc = _epi_scan_plain(planes, flat[0], flat[1], flat[2], flat[3],
                                n_steps_max, half, flat[4], h, w,
                                plane=plane, L=L)
    return t.view(B, N), sc.view(B, N)


@_scan_op.register_vmap
def _scan_vmap(info, in_dims, stack, lvl, uv_a, uv_b, ref_patch, n_steps_max,
               half, n_steps_each, h, w, use_pallas):
    B = info.batch_size
    d = in_dims
    out = epi_scan_batched(
        batch_first(stack, d[0], B), batch_first(lvl, d[1], B),
        batch_first(uv_a, d[2], B), batch_first(uv_b, d[3], B),
        batch_first(ref_patch, d[4], B), n_steps_max, half,
        batch_first(n_steps_each, d[7], B), h, w, use_pallas)
    return out, (0, 0)


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
    plain version runs on the centred reference.  Under `torch.func.vmap`
    the batch takes one launch (`epi_scan_batched`)."""
    L, hp, wp = stack.shape
    h = hp if h is None else h
    w = wp if w is None else w
    return call_op(_scan_op, _scan_body, stack, lvl, uv_a, uv_b, ref_patch,
                   int(n_steps_max), int(half), n_steps_each, int(h), int(w),
                   use_kernels(use_pallas))


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
                 half: int, h: int, w: int, updates: list | None = None,
                 plane=None, L: int | None = None):
    """Plain version of align_iclk_kernel (port of _align_fallback).  A
    fixed-count loop: each feature freezes once done, which is what the JAX
    while-loop computes without its early global exit.  `plane` and `L` as
    in `_scan_plain`."""
    n = lvl.shape[0]
    p = 2 * half
    area = p * p
    dtype = uv0.dtype
    Tf = T.reshape(n, area)
    J = torch.stack([gx.reshape(n, area), gy.reshape(n, area),
                     torch.ones((n, area), dtype=dtype, device=uv0.device)],
                    dim=-1)
    L = stack.shape[0] if L is None else L
    lvl = torch.clamp(lvl.to(torch.int64), 0, L - 1)
    plane = lvl if plane is None else plane
    wl, hl = _level_dims(lvl, h, w, dtype)
    m = half + 1.0

    def inb(uv):
        return ((uv[..., 0] >= m) & (uv[..., 0] < wl - 1 - m)
                & (uv[..., 1] >= m) & (uv[..., 1] < hl - 1 - m))

    def step(uv, mean):
        cur = _sample_plain(stack, plane, uv, half, False).reshape(n, area)
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


def _row_args(t, name: str, rows: tuple, tail: tuple, device: int):
    """(tensor, pointer, row stride, stride(-2)) of a float32 `rows + tail`
    tensor read in place: (N, ...) rows, or (B, N, ...) rows whose frames
    lie at one common row stride (row i at i * stride); other (B, N, ...)
    inputs (a vmap rule's moved or expanded argument) are reshaped to B*N
    rows, and the tensor returned is what the kernel reads (keep it until
    the launch).  Patches (`tail` (P, P)) must have contiguous rows."""
    check(t, name, torch.float32, rows + tail, device)
    s = t.stride()
    if len(tail) == 2 and t.numel() and s[-1] != 1:
        raise ValueError(f"{name} rows must be contiguous (stride(-1) == 1)")
    if len(rows) == 2 and rows[0] > 1 and s[0] != rows[1] * s[1]:
        t = t.reshape((rows[0] * rows[1],) + tail)   # no common row stride
        s = (0,) + t.stride()
    return (t, t.data_ptr(), *s[len(rows) - 1:len(rows) + 1])


def _iclk_launch(name: str, fn_name: str, stack, lvl, T, gx, gy, uv0, valid,
                 n_iter: int, h: int, w: int, gates: tuple = ()):
    """Checks, the three output allocations and the one launch of an ICLK
    kernel (`gates`: the window kernel's gate flags and levels); inputs of
    another type, shape, layout or device raise before any allocation.
    `lvl` is (N,), or (B, N) for a (B, L, Hp, Wp) stack: B * N rows, row i
    reading frame i // N, the other inputs of the same leading shape and
    read in place (`_row_args`); the outputs are (B, N, ...) then."""
    dev = stack.get_device()
    rows = tuple(lvl.shape)
    p = T.shape[-1]
    if p % 2 or not 0 < p * p <= 128:
        raise ValueError(f"{name} takes even patch sides of at most 128 px, "
                         f"got {tuple(T.shape)}")
    if len(rows) not in (1, 2) or (len(rows) == 2 and (
            stack.dim() != 4 or stack.shape[0] != rows[0])):
        raise ValueError(f"lvl {rows} is not (N,) or one row of N per "
                         f"frame of a {tuple(stack.shape)} stack")
    stack_args = _stack_args(stack)
    read = [_row_args(T, "ref_patch", rows, (p, p), dev),
            _row_args(gx, "ref_dx", rows, (p, p), dev),
            _row_args(gy, "ref_dy", rows, (p, p), dev),
            _row_args(uv0, "init_uv", rows, (2,), dev)]
    check(lvl, "lvl", torch.int32, rows, dev)
    contiguous(lvl, "lvl")
    check(valid, "valid", torch.bool, rows, dev)
    contiguous(valid, "valid")
    device = stack.device
    out_uv = torch.empty(rows + (2,), dtype=torch.float32, device=device)
    out_conv = torch.empty(rows, dtype=torch.bool, device=device)
    out_mean = torch.empty(rows, dtype=torch.float32, device=device)
    n = lvl.numel()
    if n:
        launch(LAUNCHES, name, fn_name, *stack_args, int(h), int(w),
               rows[-1], lvl.data_ptr(), *(a for r in read for a in r[1:]),
               valid.data_ptr(), n, int(n_iter), p // 2, *gates,
               out_uv.data_ptr(), out_conv.data_ptr(), out_mean.data_ptr(),
               stream(dev))
    return out_uv, out_conv, out_mean


def _align_kernel(stack, lvl, T, gx, gy, uv0, valid, n_iter: int, h: int,
                  w: int):
    """The whole of align_iclk in one launch (Hessian and inverse,
    NaN-zeroing, ICLK and convergence in the kernel), for (N,) or (B, N)
    rows (`_iclk_launch`)."""
    return _iclk_launch("align_iclk_kernel", "launch_align_iclk", stack, lvl,
                        T, gx, gy, uv0, valid, n_iter, h, w)


def _align_iclk_plain(stack, lvl, ref_patch, ref_dx, ref_dy, init_uv, valid,
                      n_iter: int, h: int, w: int, plane=None,
                      L: int | None = None):
    """The whole of align_iclk's plain version: the Hessian's inverse, the
    loop and the convergence test."""
    p = ref_patch.shape[1]
    hinv = _iclk_hinv(ref_dx, ref_dy)
    uv, mean, step2 = _align_plain(stack, lvl, ref_patch, ref_dx, ref_dy,
                                   hinv, init_uv, valid, n_iter, p // 2, h, w,
                                   plane=plane, L=L)
    drift = torch.linalg.norm(uv - init_uv, dim=-1)
    converged = valid & (step2 < 4.0 * MIN_UPDATE_SQUARED) & (drift < p)
    # with no iteration uv is init_uv itself; an op returns no input
    return (uv.clone() if uv is init_uv else uv), converged, mean


def _flat_features(B: int, N: int, ref_patch, ref_dx, ref_dy, init_uv,
                   valid):
    p = ref_patch.shape[-1]
    return (ref_patch.reshape(B * N, p, p), ref_dx.reshape(B * N, p, p),
            ref_dy.reshape(B * N, p, p), init_uv.reshape(B * N, 2),
            valid.reshape(B * N))


@_spanned("align_iclk")
def _align_body(stack, lvl, ref_patch, ref_dx, ref_dy, init_uv, valid,
                n_iter, h, w, use_pallas):
    if on_card(stack, use_pallas):
        return _align_kernel(stack, lvl, ref_patch, ref_dx, ref_dy, init_uv,
                             valid, n_iter, h, w)
    return _align_iclk_plain(stack, lvl, ref_patch, ref_dx, ref_dy, init_uv,
                             valid, n_iter, h, w)


_align_op = torch.library.custom_op(
    "svo_torch::align_iclk", _align_body, mutates_args=(),
    schema="(Tensor stack, Tensor lvl, Tensor ref_patch, Tensor ref_dx, "
           "Tensor ref_dy, Tensor init_uv, Tensor valid, int n_iter, int h, "
           "int w, bool use_pallas) -> (Tensor, Tensor, Tensor)")


@_spanned("align_iclk")
def align_iclk_batched(stack, lvl, ref_patch, ref_dx, ref_dy, init_uv, valid,
                       n_iter: int, h: int | None = None,
                       w: int | None = None, use_pallas=True):
    """align_iclk for a batch: stack (B, L, Hp, Wp), lvl / valid (B, N),
    patches (B, N, P, P), init_uv (B, N, 2).  Returns (uv, converged,
    mean_diff) with a leading (B, N).  On CUDA three allocations and one
    launch for all B*N features, the (B, N, ...) rows read in place; a
    mask or level tensor whose rows are not contiguous (a vmap rule's moved
    or expanded argument) is made so."""
    B, N = lvl.shape
    L, hp, wp = stack.shape[-3:]
    h = hp if h is None else h
    w = wp if w is None else w
    if on_card(stack, use_pallas):
        return _align_kernel(stack, lvl.contiguous(), ref_patch, ref_dx,
                             ref_dy, init_uv, valid.contiguous(), n_iter, h,
                             w)
    T, gx, gy, uv0, ok = _flat_features(B, N, ref_patch, ref_dx, ref_dy,
                                        init_uv, valid)
    planes, plane = _planes(stack, lvl, wrap=False)
    uv, conv, mean = _align_iclk_plain(planes, lvl.reshape(B * N), T, gx, gy,
                                       uv0, ok, n_iter, h, w, plane=plane,
                                       L=L)
    return uv.view(B, N, 2), conv.view(B, N), mean.view(B, N)


@_align_op.register_vmap
def _align_vmap(info, in_dims, stack, lvl, ref_patch, ref_dx, ref_dy,
                init_uv, valid, n_iter, h, w, use_pallas):
    B = info.batch_size
    d = in_dims
    out = align_iclk_batched(
        batch_first(stack, d[0], B), batch_first(lvl, d[1], B),
        batch_first(ref_patch, d[2], B), batch_first(ref_dx, d[3], B),
        batch_first(ref_dy, d[4], B), batch_first(init_uv, d[5], B),
        batch_first(valid, d[6], B), n_iter, h, w, use_pallas)
    return out, (0, 0, 0)


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
    CPU the plain version runs from `init_uv` as given.  Under
    `torch.func.vmap` the batch takes one launch (`align_iclk_batched`)."""
    L, hp, wp = stack.shape
    h = hp if h is None else h
    w = wp if w is None else w
    return call_op(_align_op, _align_body, stack, lvl, ref_patch, ref_dx,
                   ref_dy, init_uv, valid, int(n_iter), int(h), int(w),
                   use_kernels(use_pallas))


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


def dump_windows_plain(stack, lvl, uv, valid=None, plane=None):
    """One (DUMP_WR, DUMP_WC) window per feature around integer(uv), plus the
    window origin (xi, yi) — plain version of dump_windows_kernel, the port
    of dump_windows' fallback path (every row copied, `valid` unused).  The
    window ICLK kernel reads this window's pixels in place, through the
    window's own index clamps, instead of writing it out.  `plane`
    (default: the clamped level) is the stack plane each window is cut
    from."""
    L, hp, wp = stack.shape
    uv = _nan0(uv)
    org = _window_origin(stack, uv)
    lvl_c = (torch.clamp(lvl.to(torch.int64), 0, L - 1) if plane is None
             else plane)
    # dynamic_slice semantics: the start is clamped so the window fits
    sx = org[:, 0].to(torch.int64).clamp(0, max(wp - DUMP_WC, 0))
    sy = org[:, 1].to(torch.int64).clamp(0, max(hp - DUMP_WR, 0))
    rr = torch.arange(DUMP_WR, device=stack.device)
    cc = torch.arange(DUMP_WC, device=stack.device)
    rows = (sy[:, None] + rr[None, :])[:, :, None]
    cols = (sx[:, None] + cc[None, :])[:, None, :]
    wins = stack[lvl_c[:, None, None], rows, cols]
    return wins, org


def _dump_kernel(stack, lvl, uv, valid, n_per: int | None = None):
    """The whole of dump_windows in one launch (the kernel zeroes
    non-finite uv, computes and clamps the origin, clamps the level and
    writes zeros for dead rows); the host makes the two allocations and
    converts nothing: inputs of another type, shape or device raise.  With
    `n_per`, a (B, L, Hp, Wp) stack takes B * n_per rows, row i cut from
    frame i // n_per (an (L, Hp, Wp) stack is read with batch stride 0)."""
    if stack.dim() != 3 and (n_per is None or stack.dim() != 4):
        raise ValueError(f"stack must be (L, H, W)"
                         f"{'' if n_per is None else ' or (B, L, H, W)'}, "
                         f"got {tuple(stack.shape)}")
    stack_args = _stack_args(stack)
    H, W = stack_args[5:]
    if H < DUMP_WR or W < DUMP_WC:
        raise ValueError(f"dump_windows_kernel takes planes of at least "
                         f"{DUMP_WR}x{DUMP_WC}, got {H}x{W}")
    dev = stack.get_device()
    n = uv.shape[0]
    if n_per is not None and (n_per < 1 or stack.dim() == 4
                              and n != stack.shape[0] * n_per):
        raise ValueError(f"{n} rows are not {n_per} per frame of a "
                         f"{tuple(stack.shape)} stack")
    check(uv, "uv", torch.float32, (n, 2), dev)
    check(lvl, "lvl", torch.int32, (n,), dev)
    contiguous(lvl, "lvl")
    check(valid, "valid", torch.bool, (n,), dev)
    contiguous(valid, "valid")
    wins = torch.empty((n, DUMP_WR, DUMP_WC), dtype=torch.float32,
                       device=stack.device)
    org = torch.empty((n, 2), dtype=torch.int32, device=stack.device)
    if n:
        su = uv.stride()
        launch(LAUNCHES, "dump_windows_kernel", "launch_dump_windows",
               *stack_args, lvl.data_ptr(), uv.data_ptr(), su[0], su[1],
               valid.data_ptr(), n, n if n_per is None else n_per,
               wins.data_ptr(), org.data_ptr(), stream(dev))
    return wins, org


@_spanned("dump_windows")
def _dump_body(stack, lvl, uv, valid, use_pallas):
    if on_card(stack, use_pallas):
        return _dump_kernel(stack, lvl, uv, valid)
    return dump_windows_plain(stack, lvl, uv, valid)


_dump_op = torch.library.custom_op(
    "svo_torch::dump_windows", _dump_body, mutates_args=(),
    schema="(Tensor stack, Tensor lvl, Tensor uv, Tensor? valid, "
           "bool use_pallas) -> (Tensor, Tensor)")


@_spanned("dump_windows")
def dump_windows_batched(stack, lvl, uv, valid, use_pallas=None):
    """dump_windows for a batch: stack (B, L, Hp, Wp) (or (L, Hp, Wp),
    shared by every frame), lvl / valid (B, N), uv (B, N, 2).  Returns
    (wins (B, N, 32, 64) float32, org (B, N, 2) int32).  On CUDA two
    allocations and one launch for all B*N rows; on the CPU the plain
    version on the B*L planes (every frame's planes have the same (Hp, Wp),
    so each row's origin is its frame's)."""
    B, N = lvl.shape
    flat = (lvl.reshape(B * N), uv.reshape(B * N, 2),
            None if valid is None else valid.reshape(B * N))
    if on_card(stack, use_pallas):
        wins, org = _dump_kernel(stack, *flat, n_per=N)
    else:
        if stack.dim() == 3:
            stack = stack.expand((B,) + tuple(stack.shape))
        planes, plane = _planes(stack, lvl, wrap=False)
        wins, org = dump_windows_plain(planes, *flat, plane=plane)
    return wins.view(B, N, DUMP_WR, DUMP_WC), org.view(B, N, 2)


@_dump_op.register_vmap
def _dump_vmap(info, in_dims, stack, lvl, uv, valid, use_pallas):
    B = info.batch_size
    d = in_dims
    out = dump_windows_batched(
        batch_first(stack, d[0], B), batch_first(lvl, d[1], B),
        batch_first(uv, d[2], B), batch_first(valid, d[3], B), use_pallas)
    return out, (0, 0)


def dump_windows(stack, lvl, uv, valid, use_pallas=None):
    """One (DUMP_WR, DUMP_WC) = (32, 64) window per feature around
    integer(uv) at its level, plus the window origin (xi, yi) in
    level-pixel coordinates: floor(uv) - (32, 16) with NaN and +-inf read
    as 0, clamped to [0, Wp - 65] x [0, Hp - 33].  Returns (wins (N, 32,
    64) float32, org (N, 2) int32).

    On CUDA one launch of dump_windows_kernel computes all of it: the stack
    is (L, Hp, Wp) float32 with contiguous rows (any plane and row
    strides), uv float32 (any strides), `lvl` int32 and `valid` bool, else
    it raises; a dead row's window is zeros, as the TPU kernel writes it.
    On the CPU (or with use_pallas=False) the plain version copies every
    row's window, as the JAX fallback does: compare valid rows.  Under
    `torch.func.vmap` the batch takes one launch (`dump_windows_batched`)."""
    return call_op(_dump_op, _dump_body, stack, lvl, uv, valid,
                   use_kernels(use_pallas))


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
                     half: int, h: int, w: int, updates: list | None = None,
                     plane=None, L: int | None = None):
    """Plain version of align_iclk_window_kernel: dump_windows_plain plus
    the one-hot ICLK of align_iclk_mxu (fixed-count loop with per-feature
    freeze).  Returns (uv, mean, step2, zmssd score, population std) of the
    final resample.  `plane` and `L` as in `_scan_plain`."""
    n = lvl.shape[0]
    p = 2 * half
    area = p * p
    dtype = T.dtype
    wins, org = dump_windows_plain(stack, lvl, uv0, valid, plane=plane)
    orgf = org.to(dtype)
    L = stack.shape[0] if L is None else L
    lvl_c = torch.clamp(lvl.to(torch.int64), 0, L - 1)
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
    NaN-zeroing, window origin, ICLK, convergence and gates in the kernel),
    for (N,) or (B, N) rows (`_iclk_launch`)."""
    p = T.shape[-1]
    zmssd_on = zmssd_factor is not None
    std_on = min_patch_std is not None
    gates = (int(zmssd_on), float(zmssd_factor) * p * p if zmssd_on else 0.0,
             int(std_on), float(min_patch_std) if std_on else 0.0)
    return _iclk_launch("align_iclk_window_kernel", "launch_align_iclk_window",
                        stack, lvl, T, gx, gy, uv0, valid, n_iter, h, w, gates)


def _align_iclk_mxu_plain(stack, lvl, ref_patch, ref_dx, ref_dy, init_uv,
                          valid, n_iter: int, h: int, w: int, zmssd_factor,
                          min_patch_std, plane=None, L: int | None = None):
    """The whole of align_iclk_mxu's plain version: the Hessian's inverse,
    the window loop, the convergence test and the gates."""
    n, p, _ = ref_patch.shape
    area = p * p
    hinv = _iclk_hinv(ref_dx, ref_dy)
    init_uv = _nan0(init_uv)
    uv, mean, step2, score, std = _align_mxu_plain(
        stack, lvl, ref_patch, ref_dx, ref_dy, hinv, init_uv, valid, n_iter,
        p // 2, h, w, plane=plane, L=L)
    drift = torch.linalg.norm(uv - init_uv, dim=-1)
    converged = valid & (step2 < 4.0 * MIN_UPDATE_SQUARED) & (drift < p)
    if zmssd_factor is not None:
        converged = converged & (score < zmssd_factor * area)
    if min_patch_std is not None:
        converged = converged & (std >= min_patch_std)
    return uv, converged, mean


@_spanned("align_iclk_mxu")
def _align_mxu_body(stack, lvl, ref_patch, ref_dx, ref_dy, init_uv, valid,
                    n_iter, h, w, use_pallas, zmssd_factor, min_patch_std):
    if on_card(stack, use_pallas):
        return _align_window_kernel(stack, lvl, ref_patch, ref_dx, ref_dy,
                                    init_uv, valid, n_iter, h, w,
                                    zmssd_factor, min_patch_std)
    return _align_iclk_mxu_plain(stack, lvl, ref_patch, ref_dx, ref_dy,
                                 init_uv, valid, n_iter, h, w, zmssd_factor,
                                 min_patch_std)


_align_mxu_op = torch.library.custom_op(
    "svo_torch::align_iclk_mxu", _align_mxu_body, mutates_args=(),
    schema="(Tensor stack, Tensor lvl, Tensor ref_patch, Tensor ref_dx, "
           "Tensor ref_dy, Tensor init_uv, Tensor valid, int n_iter, int h, "
           "int w, bool use_pallas, float? zmssd_factor, "
           "float? min_patch_std) -> (Tensor, Tensor, Tensor)")


@_spanned("align_iclk_mxu")
def align_iclk_mxu_batched(stack, lvl, ref_patch, ref_dx, ref_dy, init_uv,
                           valid, n_iter: int, h: int | None = None,
                           w: int | None = None, use_pallas=True,
                           zmssd_factor: float | None = None,
                           min_patch_std: float | None = None):
    """align_iclk_mxu for a batch, with the shapes of align_iclk_batched.
    On CUDA three allocations and one launch for all B*N features, the
    (B, N, ...) rows read in place (as in align_iclk_batched)."""
    B, N = lvl.shape
    L, hp, wp = stack.shape[-3:]
    h = hp if h is None else h
    w = wp if w is None else w
    if on_card(stack, use_pallas):
        return _align_window_kernel(stack, lvl.contiguous(), ref_patch,
                                    ref_dx, ref_dy, init_uv,
                                    valid.contiguous(), n_iter, h, w,
                                    zmssd_factor, min_patch_std)
    T, gx, gy, uv0, ok = _flat_features(B, N, ref_patch, ref_dx, ref_dy,
                                        init_uv, valid)
    planes, plane = _planes(stack, lvl, wrap=False)
    uv, conv, mean = _align_iclk_mxu_plain(
        planes, lvl.reshape(B * N), T, gx, gy, uv0, ok, n_iter, h, w,
        zmssd_factor, min_patch_std, plane=plane, L=L)
    return uv.view(B, N, 2), conv.view(B, N), mean.view(B, N)


@_align_mxu_op.register_vmap
def _align_mxu_vmap(info, in_dims, stack, lvl, ref_patch, ref_dx, ref_dy,
                    init_uv, valid, n_iter, h, w, use_pallas, zmssd_factor,
                    min_patch_std):
    B = info.batch_size
    d = in_dims
    out = align_iclk_mxu_batched(
        batch_first(stack, d[0], B), batch_first(lvl, d[1], B),
        batch_first(ref_patch, d[2], B), batch_first(ref_dx, d[3], B),
        batch_first(ref_dy, d[4], B), batch_first(init_uv, d[5], B),
        batch_first(valid, d[6], B), n_iter, h, w, use_pallas, zmssd_factor,
        min_patch_std)
    return out, (0, 0, 0)


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
    `valid` on the stack's device.  The kernel is bound by the
    instructions each feature's dependent samples issue: one warp a
    feature at the single frame's 768 rows, 7.4-7.6 us (8.8-9.1 before
    slice 12), two features a warp from 2,048 rows on, 18.3-18.4 us at
    the batched step's 8,448 (28.6-28.7 before), against bytes
    bounds of 0.34 and 3.7 us (tools/patch_ab.py, NVIDIA H100 80GB HBM3,
    700 W); the host's checks, three allocations and the ctypes call cost
    more.  On the CPU the plain version runs.  Under `torch.func.vmap` the
    batch takes one launch (`align_iclk_mxu_batched`)."""
    L, hp, wp = stack.shape
    h = hp if h is None else h
    w = wp if w is None else w
    return call_op(
        _align_mxu_op, _align_mxu_body, stack, lvl, ref_patch, ref_dx, ref_dy,
        init_uv, valid, int(n_iter), int(h), int(w), use_kernels(use_pallas),
        None if zmssd_factor is None else float(zmssd_factor),
        None if min_patch_std is None else float(min_patch_std))


RESIDENCY_KEYS = ("registers", "local_bytes", "blocks_per_sm",
                  "threads_per_block", "blocks", "features_per_warp", "sms")


def iclk_residency(half: int, window: bool, n: int, lib=None) -> dict:
    """The layout an ICLK launch of `n` rows of (2*half)^2 patches takes
    and what the card makes of it, from the runtime (csrc
    `iclk_residency`: cudaFuncGetAttributes and the occupancy query):
    registers and local (spill) bytes per thread, resident blocks per SM,
    threads per block, blocks, features per warp, the card's SMs, and the
    waves (blocks over resident blocks times SMs).  `lib`: another build
    of the kernels (tools/patch_ab.py's versions).  CUDA only."""
    import ctypes
    from android_svo_tpu_torch.ops import cuda_build
    out = (ctypes.c_int * len(RESIDENCY_KEYS))()
    lib = cuda_build.library() if lib is None else lib
    rc = lib.iclk_residency(int(half), int(bool(window)), int(n), out)
    if rc != 0:
        raise RuntimeError(f"iclk_residency failed with cudaError_t {rc}")
    res = dict(zip(RESIDENCY_KEYS, out))
    per_wave = res["blocks_per_sm"] * res["sms"]
    res["waves"] = res["blocks"] / per_wave if per_wave else float("inf")
    return res


def count_iclk_updates(stack, lvl, ref_patch, ref_dx, ref_dy, init_uv, valid,
                       n_iter: int, h: int, w: int, window: bool, plane=None,
                       L: int | None = None) -> int:
    """ICLK updates the inputs need (features x iterations before each
    feature freezes), counted by the plain version: the data-dependent work
    of align_iclk (window=False) or align_iclk_mxu (window=True).  `plane`
    and `L` as in `_scan_plain` (a batch's B*L planes)."""
    hinv = _iclk_hinv(ref_dx, ref_dy)
    updates: list = []
    fn = _align_mxu_plain if window else _align_plain
    if window:
        init_uv = _nan0(init_uv)
    fn(stack, lvl, ref_patch, ref_dx, ref_dy, hinv, init_uv, valid, n_iter,
       ref_patch.shape[1] // 2, h, w, updates=updates, plane=plane, L=L)
    return sum(updates)
