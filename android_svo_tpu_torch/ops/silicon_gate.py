"""Kernel gate: every CUDA kernel of the tracking path against its plain
PyTorch version on the card, at the path's shapes — the port of
`android_svo_tpu/ops/silicon_gate.py` (same bounds).

`gate_inputs` builds one problem per kernel from a rendered, smoothly
textured pyramid and uv/level draws from a seeded `torch.Generator`;
`kernel_calls` calls each kernel in every form the tracker's configurations
give it (a form is named `kernel/form`); `run_gate` runs kernel and plain
version on the same inputs and returns the deviations and the failures.
`batched_gate_inputs`, `batched_kernel_calls` and `run_batched_gate` do the
same for the batched forms (B frames, one launch per call), which must also
equal the B single launches bit for bit.  `pose_inputs`,
`projection_gap_px` and `compare_pose` hold `pose_gn_kernel` against
`core/pose_opt.py::optimize_pose_plain` on the same inputs;
`point_inputs`, `point_operands` and `compare_points` hold
`point_gn_kernel` against `core/point_opt.py::optimize_selected_plain`;
`align_inputs`, `compare_align` and `plain_align_trace` hold
`sparse_align_kernel` against the plain loop of `ops/sparse_align.py`;
`camera_calls` and `camera_failures` hold the radtan camera's kernels
against `PinholeCamera`'s plain versions.  `path_gate` runs every one of
these checks at the tracking path's shapes, with each call's dispatch
(ATen ops, device activities) and reads back; the card tests
(`tests/test_torch_cuda.py`) and `chip_smoke.py`'s phase 3 both run it, and
the card tests hold every kernel to these bounds at more shapes.
`tools/patch_ab.py` and `chip_smoke.py`'s phase 11 take their inputs from
here.  `pose_bound`, `point_bound`, `align_bound`, `probe_bound` and
`camera_bound` give the least time of the kernels
`svo_bench/reference/bounds.py` leaves out.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from android_svo_tpu_torch.ops import patch_kernels as pk
from android_svo_tpu_torch.ops.sparse_align import level_substack


@dataclass
class GateReport:
    ok: bool
    failures: list = field(default_factory=list)
    detail: dict = field(default_factory=dict)
    max_abs_err: dict = field(default_factory=dict)   # kernel -> max |d|

    def as_dict(self):
        return {"ok": self.ok, "failures": self.failures,
                "detail": {k: round(float(v), 6)
                           for k, v in self.detail.items()}}


def _gate_stack(h: int, w: int, n_levels: int = 5, device=None,
                shift: float = 0.0):
    """Smooth-textured test pyramid (realistic gradients) rendered by the
    port's own renderer, the camera `shift` along x."""
    from android_svo_tpu_torch.data import synthetic
    from android_svo_tpu_torch.ops import pyramid

    cam = synthetic.default_camera(w, h, device=device)
    gen = torch.Generator().manual_seed(7)
    tex = synthetic.make_texture(gen, 1024, device=device)
    img = synthetic.render(tex, cam, synthetic.lookdown_pose(
        shift, 0.0, -3.0, (0.45, 0.0, 0.0), device=device))
    return pyramid.build_stack(img, n_levels)


def gate_inputs(n: int = 768, h: int = 480, w: int = 640, seed: int = 0,
                device=None, shift: float = 0.0) -> dict:
    """One problem per kernel at the tracking path's shapes (n features of
    8x8 patches on the three searchable levels; 4x4 patches on sparse
    alignment's level-2 substack); `shift` moves the rendered frame."""
    dev = torch.device("cuda" if device is None else device)
    gen = torch.Generator().manual_seed(seed)
    stack_all = _gate_stack(h, w, device=dev, shift=shift)
    stack = stack_all[:3]

    def rand(*shape):
        return torch.rand(shape, generator=gen).to(dev)

    lvl = torch.randint(0, 3, (n,), generator=gen).to(dev, torch.int32)
    wl = (w >> lvl).float()
    hl = (h >> lvl).float()
    u01 = rand(n, 2)
    uv = torch.stack([12 + u01[:, 0] * (wl - 24), 12 + u01[:, 1] * (hl - 24)],
                     dim=-1)
    valid = torch.ones((n,), dtype=torch.bool, device=dev)
    # the 1D alignment's per-iteration mask: features that left the margin
    valid_mixed = rand(n) < 0.85
    ref, rdx, rdy = pk.sample_patches(stack, lvl, uv, 4, grad=True,
                                      use_pallas=False)
    off = rand(n, 2) * 4.0 - 2.0
    ang = rand(n) * (2 * math.pi)
    seg = torch.stack([torch.cos(ang), torch.sin(ang)], -1) * 35.0
    nsteps = torch.randint(2, 100, (n,), generator=gen).to(dev, torch.int32)

    sub = level_substack(stack_all, 2, h, w)
    sub_uv = torch.stack([12 + u01[:, 0] * ((w >> 2) - 24),
                          12 + u01[:, 1] * ((h >> 2) - 24)], dim=-1)
    zeros_lvl = torch.zeros((n,), dtype=torch.int32, device=dev)
    # the window dump's centres: the ICLK starts, some of them non-finite
    dump_uv = uv + off
    dump_uv[::29, 0] = float("nan")
    dump_uv[5::37, 1] = float("inf")
    dump_uv[11::41] = float("-inf")
    return {
        "stack": stack, "lvl": lvl, "uv": uv, "valid": valid,
        "valid_mixed": valid_mixed, "ref": ref,
        "rdx": rdx, "rdy": rdy, "off": off, "init": uv + off, "seg": seg,
        "uv_a": uv - seg, "uv_b": uv + seg, "nsteps": nsteps,
        "h": h, "w": w, "sub": sub, "sub_uv": sub_uv, "zeros_lvl": zeros_lvl,
        "dump_uv": dump_uv,
    }


def kernel_of(name: str) -> str:
    """The kernel a `kernel_calls` entry launches."""
    return name.split("/")[0]


def kernel_calls(x: dict) -> dict:
    """name -> fn(use_pallas) calling the kernel's wrapper on its problem;
    the same callables time kernel and plain version.  A name without a
    `/form` is the default path's call; `sample_patches_kernel/align1d` is
    the 1D alignment's per-iteration sampler (8x8 patches at mixed levels
    of the 3-level stack, with a valid mask; also `_zmssd_accept`'s call)
    and `align_iclk_window_kernel/ungated` the window ICLK with both
    appearance gates off (the edgelet configuration's direct match).
    `dump_windows_kernel` is the public `dump_windows` (no tracking path
    calls it) on the mixed valid mask and the partly non-finite starts."""
    return {
        "sample_patches_kernel": lambda up: pk.sample_patches(
            x["sub"], x["zeros_lvl"], x["sub_uv"], 2, valid=x["valid"],
            use_pallas=up),
        "epi_scan_kernel": lambda up: pk.epi_scan(
            x["stack"], x["lvl"], x["uv_a"], x["uv_b"], x["ref"], 100,
            half=4, n_steps_each=x["nsteps"], h=x["h"], w=x["w"],
            use_pallas=up),
        "align_iclk_kernel": lambda up: pk.align_iclk(
            x["stack"], x["lvl"], x["ref"], x["rdx"], x["rdy"],
            x["init"], x["valid"], 10, h=x["h"], w=x["w"], use_pallas=up),
        "align_iclk_window_kernel": lambda up: pk.align_iclk_mxu(
            x["stack"], x["lvl"], x["ref"], x["rdx"], x["rdy"],
            x["init"], x["valid"], 10, h=x["h"], w=x["w"],
            use_pallas=up, zmssd_factor=2000.0, min_patch_std=5.0),
        "sample_patches_kernel/align1d": lambda up: pk.sample_patches(
            x["stack"], x["lvl"], x["uv"], 4, valid=x["valid_mixed"],
            use_pallas=up),
        "align_iclk_window_kernel/ungated": lambda up: pk.align_iclk_mxu(
            x["stack"], x["lvl"], x["ref"], x["rdx"], x["rdy"],
            x["init"], x["valid"], 10, h=x["h"], w=x["w"], use_pallas=up),
        "dump_windows_kernel": lambda up: pk.dump_windows(
            x["stack"], x["lvl"], x["dump_uv"], x["valid_mixed"],
            use_pallas=up),
    }


def gate_calls(x: dict) -> dict:
    """`kernel_calls` and the 8x8 sampler with gradients at per-feature
    levels (`sample_patches_kernel/grad`), which the gate checks too."""
    calls = dict(kernel_calls(x))
    calls["sample_patches_kernel/grad"] = lambda up: pk.sample_patches(
        x["stack"], x["lvl"], x["uv"], 4, grad=True, valid=x["valid"],
        use_pallas=up)
    return calls


def _np(t):
    return t.detach().double().cpu().numpy()


def run_gate(x: dict, calls: dict | None = None) -> GateReport:
    """Kernel vs plain version on the card, every form of `kernel_calls`,
    bounds of the JAX package's gate: patches 0.02 (live slots); scan
    best_t 1e-3 and score 2.0 on finite scores (>= 80% finite); convergence
    agreement >= 0.95 and kernel convergences >= 0.8 x plain; align uv max
    0.05 px where both converge; window ICLK (gated and ungated) uv p90 <=
    0.05 px and max <= 0.5 px; median converged error to the true uv <=
    0.5 px; the window dump (a copy) bit for bit on valid rows, origins
    equal, dead rows zero (the plain version, like the JAX fallback, copies
    them too).  `calls` (default `kernel_calls(x)`, and the 8x8 sampler with
    gradients on x) may give every form as another function of the same
    features, flattened: the batched gate's."""
    failures: list[str] = []
    detail: dict[str, float] = {}
    errs: dict[str, float] = {}
    n = x["lvl"].shape[0]

    def check(name, form, a, b, tol, mask=None):
        a, b = _np(a), _np(b)
        if mask is not None:
            a, b = a[mask], b[mask]
        dev = float(np.abs(a - b).max()) if a.size else 0.0
        detail[name] = dev
        for key in {form, kernel_of(form)}:
            errs[key] = max(errs.get(key, 0.0), dev)
        if not dev <= tol:
            failures.append(f"{name}: max|d|={dev:.5f} > {tol}")

    # sample_patches: the 8x8+grad form at per-feature levels, and the
    # sparse-align form (4x4 on the strided level-2 substack)
    if calls is None:
        calls = gate_calls(x)
    k = calls["sample_patches_kernel/grad"](True)
    p = calls["sample_patches_kernel/grad"](False)
    for nm, a, b in zip(("patch", "dx", "dy"), k, p):
        check(f"sample.{nm}", "sample_patches_kernel", a, b, 0.02)
    k = calls["sample_patches_kernel"](True)
    p = calls["sample_patches_kernel"](False)
    check("sample.substack_4x4", "sample_patches_kernel", k, p, 0.02)
    name = "sample_patches_kernel/align1d"
    k, p = calls[name](True), calls[name](False)
    check("sample.align1d_8x8", name, k, p, 0.02,
          mask=_np(x["valid_mixed"]).astype(bool))

    # epi_scan
    tk, sk = calls["epi_scan_kernel"](True)
    tp, sp = calls["epi_scan_kernel"](False)
    fin = np.isfinite(_np(sk)) & np.isfinite(_np(sp))
    detail["scan.finite_frac"] = float(fin.mean())
    if fin.sum() < 0.8 * n:
        failures.append(f"epi_scan: only {int(fin.sum())}/{n} finite")
    check("scan.best_t", "epi_scan_kernel", tk, tp, 1e-3, mask=fin)
    check("scan.score", "epi_scan_kernel", sk, sp, 2.0, mask=fin)
    detail["scan.inf_agree_frac"] = float(
        (np.isfinite(_np(sk)) == np.isfinite(_np(sp))).mean())

    uv_true = _np(x["uv"])
    for name, short in (("align_iclk_kernel", "align"),
                        ("align_iclk_window_kernel", "align_window"),
                        ("align_iclk_window_kernel/ungated",
                         "align_window_ungated")):
        uk, ck, _ = calls[name](True)
        up, cp, _ = calls[name](False)
        ck, cp = _np(ck).astype(bool), _np(cp).astype(bool)
        agree = float((ck == cp).mean())
        detail[f"{short}.conv_agree_frac"] = agree
        detail[f"{short}.n_conv_kernel"] = int(ck.sum())
        detail[f"{short}.n_conv_plain"] = int(cp.sum())
        if agree < 0.95:
            failures.append(f"{short}: convergence agrees {agree:.3f}")
        if cp.sum() and ck.sum() < 0.8 * cp.sum():
            failures.append(f"{short}: kernel converges {int(ck.sum())} vs "
                            f"plain {int(cp.sum())}")
        both = ck & cp
        d = np.linalg.norm(_np(uk)[both] - _np(up)[both], axis=-1)
        dmax = float(d.max()) if d.size else 0.0
        p90 = float(np.percentile(d, 90)) if d.size else 0.0
        detail[f"{short}.uv_max"] = dmax
        detail[f"{short}.uv_p90"] = p90
        for key in {name, kernel_of(name)}:
            errs[key] = max(errs.get(key, 0.0), dmax)
        if short == "align" and not dmax <= 0.05:
            failures.append(f"align: uv max dev {dmax:.4f} > 0.05")
        if short != "align" and not (p90 <= 0.05 and dmax <= 0.5):
            failures.append(f"{short}: uv dev p90={p90:.4f} "
                            f"max={dmax:.4f}")
        if ck.sum():
            err = np.linalg.norm(_np(uk) - uv_true, axis=-1)
            med = float(np.median(err[ck]))
            detail[f"{short}.med_err_px"] = med
            if not med <= 0.5:
                failures.append(f"{short}: median converged error {med:.3f}")
        else:
            failures.append(f"{short}: kernel converged nothing")

    name = "dump_windows_kernel"
    if name in calls:
        (wk, ok_), (wp, op) = calls[name](True), calls[name](False)
        live = _np(x["valid_mixed"]).astype(bool)
        check("dump.windows", name, wk, wp, 0.0, mask=live)
        org_equal = bool(torch.equal(ok_.cpu(), op.cpu()))
        dead_zero = bool((wk[~x["valid_mixed"]] == 0).all())
        detail.update({"dump.org_equal": org_equal,
                       "dump.dead_rows_zero": dead_zero,
                       "dump.n_dead": int((~live).sum()),
                       "dump.n_nonfinite": int(
                           (~torch.isfinite(x["dump_uv"])).any(-1).sum())})
        if not org_equal:
            failures.append("dump: window origins differ")
        if not dead_zero:
            failures.append("dump: a dead row's window is not zeros")
    return GateReport(ok=not failures, failures=failures, detail=detail,
                      max_abs_err=errs)


# ---------------------------------------------------------------------------
# the batched forms
# ---------------------------------------------------------------------------

_FEATURE_KEYS = ("lvl", "uv", "valid", "valid_mixed", "ref", "rdx", "rdy",
                 "init", "uv_a", "uv_b", "nsteps", "sub_uv", "zeros_lvl",
                 "dump_uv")


def batched_gate_inputs(batch: int, n: int = 768, h: int = 480,
                        w: int = 752, seed: int = 0, device=None):
    """`batch` frames' problems (`gate_inputs`, each frame rendered from
    its own camera position and with its own draws) and the same problems
    stacked: (B, 3, Hp, Wp) stacks, (B, 1, rows, cols) level-2 substacks
    and (B, n, ...) features.  Returns (frames, xb)."""
    frames = [gate_inputs(n, h, w, seed=seed + b, device=device,
                          shift=0.05 * b) for b in range(batch)]
    xb = {k: torch.stack([f[k] for f in frames])
          for k in ("stack", "sub") + _FEATURE_KEYS}
    xb.update(h=h, w=w)
    return frames, xb


def batched_kernel_calls(xb: dict) -> dict:
    """`gate_calls` in their batched forms, the window dump's included:
    name -> fn(use_pallas) returning (B, n, ...)."""
    return {
        "sample_patches_kernel": lambda up: pk.sample_patches_batched(
            xb["sub"], xb["zeros_lvl"], xb["sub_uv"], 2, valid=xb["valid"],
            use_pallas=up),
        "sample_patches_kernel/grad": lambda up: pk.sample_patches_batched(
            xb["stack"], xb["lvl"], xb["uv"], 4, grad=True,
            valid=xb["valid"], use_pallas=up),
        "epi_scan_kernel": lambda up: pk.epi_scan_batched(
            xb["stack"], xb["lvl"], xb["uv_a"], xb["uv_b"], xb["ref"], 100,
            half=4, n_steps_each=xb["nsteps"], h=xb["h"], w=xb["w"],
            use_pallas=up),
        "align_iclk_kernel": lambda up: pk.align_iclk_batched(
            xb["stack"], xb["lvl"], xb["ref"], xb["rdx"], xb["rdy"],
            xb["init"], xb["valid"], 10, h=xb["h"], w=xb["w"],
            use_pallas=up),
        "align_iclk_window_kernel": lambda up: pk.align_iclk_mxu_batched(
            xb["stack"], xb["lvl"], xb["ref"], xb["rdx"], xb["rdy"],
            xb["init"], xb["valid"], 10, h=xb["h"], w=xb["w"],
            use_pallas=up, zmssd_factor=2000.0, min_patch_std=5.0),
        "sample_patches_kernel/align1d": lambda up: pk.sample_patches_batched(
            xb["stack"], xb["lvl"], xb["uv"], 4, valid=xb["valid_mixed"],
            use_pallas=up),
        "align_iclk_window_kernel/ungated": lambda up: (
            pk.align_iclk_mxu_batched(
                xb["stack"], xb["lvl"], xb["ref"], xb["rdx"], xb["rdy"],
                xb["init"], xb["valid"], 10, h=xb["h"], w=xb["w"],
                use_pallas=up)),
        "dump_windows_kernel": lambda up: pk.dump_windows_batched(
            xb["stack"], xb["lvl"], xb["dump_uv"], xb["valid_mixed"],
            use_pallas=up),
    }


def _flat(out):
    if isinstance(out, tuple):
        return tuple(_flat(o) for o in out)
    return out.reshape((-1,) + tuple(out.shape[2:]))


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit, NaN where the other has NaN."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        nan = torch.isnan(a)
        return bool(torch.equal(nan, torch.isnan(b))
                    and torch.equal(a[~nan], b[~nan]))
    return bool(torch.equal(a, b))


def run_batched_gate(frames: list, xb: dict) -> GateReport:
    """Each batched form: against its batched plain version with
    `run_gate`'s bounds (over all B*n features), against the B single
    launches on the frames bit for bit, and one launch per call."""
    calls = batched_kernel_calls(xb)
    flat = {k: (lambda up, f=f: _flat(f(up))) for k, f in calls.items()}
    x_flat = {k: xb[k].reshape((-1,) + tuple(xb[k].shape[2:]))
              for k in ("lvl", "uv", "valid_mixed", "dump_uv")}
    rep = run_gate(x_flat, calls=flat)
    for name, fn in calls.items():
        kernel = kernel_of(name)
        before = pk.LAUNCHES[kernel]
        out = fn(True)
        launches = pk.LAUNCHES[kernel] - before
        rep.detail[f"{name}.launches"] = launches
        if launches != 1:
            rep.failures.append(f"{name}: {launches} launches for a batch")
        out = out if isinstance(out, tuple) else (out,)
        for b, x in enumerate(frames):
            one = gate_calls(x)[name](True)
            one = one if isinstance(one, tuple) else (one,)
            if not all(same_bits(o[b], s) for o, s in zip(out, one)):
                rep.failures.append(f"{name}: frame {b} differs from its "
                                    f"single launch")
        rep.detail[f"{name}.bit_exact"] = not any(
            f.startswith(f"{name}: frame") for f in rep.failures)
    rep.ok = not rep.failures
    return rep


# ---------------------------------------------------------------------------
# pose refinement: pose_gn_kernel against optimize_pose_plain
# ---------------------------------------------------------------------------

POSE_FOCAL = 458.654               # EuRoC cam0's fx, the cells' focal
POSE_GAP_PX = 0.05                 # pose tolerance, px of projection gap


def pose_inputs(seed: int, n: int = 912, valid_share: float = 0.8,
                behind: float = 0.0, outliers: float = 0.1, device="cuda"):
    """One frame's refinement problem: n points 2-6 units ahead, seen from
    a pose a small twist away from the start (identity) as noisy bearings,
    a share of them outliers, a share marked invalid, a share mirrored
    behind the camera; levels 0-2.  Returns optimize_pose's inputs but the
    config: (T_fw_init, p_w, f_meas, level, valid, focal)."""
    from android_svo_tpu_torch.geometry.se3 import SE3
    g = torch.Generator().manual_seed(seed)
    p_w = (torch.randn(n, 3, generator=g) * torch.tensor([2.0, 1.5, 1.0])
           + torch.tensor([0.0, 0.0, 4.0]))
    xyz = SE3.exp(torch.randn(6, generator=g) * 0.03).apply(p_w)
    f = xyz / torch.linalg.norm(xyz, dim=-1, keepdim=True)
    f = f + torch.randn(n, 3, generator=g) * 0.0015
    out = torch.rand(n, generator=g) < outliers
    f = torch.where(out[:, None], f + torch.randn(n, 3, generator=g) * 0.05,
                    f)
    back = torch.rand(n, generator=g) < behind
    p_w = torch.where(back[:, None], p_w * torch.tensor([1.0, 1.0, -1.0]),
                      p_w)
    level = torch.randint(0, 3, (n,), generator=g, dtype=torch.int32)
    valid = torch.rand(n, generator=g) < valid_share
    T0 = SE3(q=torch.tensor([1.0, 0.0, 0.0, 0.0], device=device),
             t=torch.zeros(3, device=device))
    return (T0, *(x.to(device) for x in (p_w, f, level, valid)),
            torch.tensor(POSE_FOCAL, device=device))


def projection_gap_px(Ta, Tb, p_w, valid) -> float:
    """The widest gap (px at the cells' focal) between the projections of
    the valid points at least one unit in front of both poses (the scene's
    points lie about 2-6 ahead; a gap grows as 1/z^2, so the few the
    generator puts near z = 0 would measure that, not the poses)."""
    a, b = Ta.apply(p_w), Tb.apply(p_w)
    ok = valid & (a[:, 2] > 1.0) & (b[:, 2] > 1.0)
    d = torch.linalg.norm(a[:, :2] / a[:, 2:] - b[:, :2] / b[:, 2:], dim=-1)
    return float(d[ok].max()) * POSE_FOCAL if bool(ok.any()) else 0.0


def compare_pose(k, p, args, thresh: float):
    """optimize_pose's outputs on the kernel (k) against the plain
    version's (p) on the same inputs (`args`, as `pose_inputs` gives them).
    Only the order of the sums differs, so the tolerances are rounding's:
      - pose: 0.05 px of projection gap.  A step whose cost lies within
        rounding of the current cost can be kept on one side and refused
        on the other (GN stops moving at its first refused step), which
        parts the poses by a fraction of a step near the optimum;
      - chi2_init: 1e-5 relative (the same residuals summed in another
        order); chi2_final 1e-3 relative plus 1e-9 (at the two poses);
      - cov: 1e-2 of its largest entry (the final system at the two poses;
        its smallest pivots amplify the difference);
      - inliers: equal but for rows whose error lies within 0.05 px of the
        threshold (`thresh`, px), and the count is the mask's.
    Returns (the deviations, the failures)."""
    _, p_w, f, level, valid, _ = args
    gap = projection_gap_px(k[0], p[0], p_w, valid)
    cov_d = float((k[3] - p[3]).abs().max())
    cov_scale = float(p[3].abs().max())
    detail = {"gap_px": gap, "cov_d": cov_d, "cov_scale": cov_scale,
              "chi2_init": (float(k[4]), float(p[4])),
              "chi2_final": (float(k[5]), float(p[5])),
              "n_inliers": (int(k[2]), int(p[2])),
              "inlier_flips": int((k[1] != p[1]).sum())}
    failures = []
    if not gap <= POSE_GAP_PX:
        failures.append(f"pose: projection gap {gap} px > {POSE_GAP_PX}")
    if not torch.allclose(k[4], p[4], rtol=1e-5, atol=0.0):
        failures.append(f"chi2_init {detail['chi2_init']}")
    if not torch.allclose(k[5], p[5], rtol=1e-3, atol=1e-9):
        failures.append(f"chi2_final {detail['chi2_final']}")
    if not cov_d <= 1e-2 * cov_scale:
        failures.append(f"cov: max |d| {cov_d} > 1e-2 x {cov_scale}")
    if int(k[2]) != int(k[1].sum()):
        failures.append(f"n_inliers {int(k[2])} is not the mask's "
                        f"{int(k[1].sum())}")
    differ = k[1] != p[1]
    if bool(differ.any()):
        xyz = p[0].apply(p_w)
        uv = f[:, :2] / f[:, 2:]
        e = (xyz[:, :2] / xyz[:, 2:] - uv) / (2.0 ** level.float())[:, None]
        err_px = torch.linalg.norm(e, dim=-1) * POSE_FOCAL
        far = differ & ~((err_px - thresh).abs() < 0.05)
        if bool(far.any()):
            failures.append(f"{int(far.sum())} inlier flips away from the "
                            "threshold")
    return detail, failures


# ---------------------------------------------------------------------------
# structure optimisation: point_gn_kernel against optimize_selected_plain
# ---------------------------------------------------------------------------

# the path's shapes: SVOConfig()'s 8,192 landmarks of 8 observations, 16
# keyframes, 20 selected, 5 iterations; the batched step's 11 sequences
POINT_SHAPES = {"points": 8192, "obs": 8, "kfs": 16, "select": 20,
                "n_iter": 5}
POINT_BATCH = 11
POINT_REL = 1e-2        # final costs, relative (an H100 read up to 3.2e-3)
POINT_COST_ABS = 1e-10  # a cost's absolute rounding (unit plane, squared)
POINT_COND = 1e8        # a system past this condition number is singular
POINT_STAGE_OPS = 12    # the stage's ATen ops a call (selection + launch)


def point_config(method: str = "gn", **kw):
    """SVOConfig at the path's structure shapes (`POINT_SHAPES`)."""
    from android_svo_tpu_torch.config import SVOConfig
    base = dict(max_points=POINT_SHAPES["points"],
                max_obs_per_point=POINT_SHAPES["obs"],
                max_n_kfs=POINT_SHAPES["kfs"],
                structureoptim_max_pts=POINT_SHAPES["select"],
                structureoptim_n_iter=POINT_SHAPES["n_iter"],
                structureoptim_method=method)
    return SVOConfig(**{**base, **kw})


def point_inputs(seed: int, cfg=None, live_share: float = 0.6,
                 kf_live_share: float = 0.85, outliers: float = 0.05,
                 noise: float = 0.0015, offset: float = 0.05,
                 device="cuda"):
    """One frame's structure problem at `cfg`'s arena sizes: keyframes
    spread a few tenths of a unit about the origin (a share of slots not
    live), landmarks 2-6 units ahead (a share of slots deleted), each seen
    from 0 to O keyframes as noisy bearings (a share of them gross
    outliers: the bearing mirrored through the camera), its stored
    position `offset` off per axis, and last_optim stamps with ties.
    Returns `optimize_structure`'s inputs but the config: (points, kfs,
    frame_id)."""
    from android_svo_tpu_torch.core import state as st
    from android_svo_tpu_torch.geometry.se3 import SE3
    cfg = cfg or point_config()
    P, O, K = cfg.max_points, cfg.max_obs_per_point, cfg.max_n_kfs
    g = torch.Generator().manual_seed(seed)
    T_kw = SE3.exp(torch.randn(K, 6, generator=g)
                   * torch.tensor([0.3, 0.3, 0.2, 0.05, 0.05, 0.05]))
    p_true = (torch.randn(P, 3, generator=g) * torch.tensor([2.0, 1.5, 1.0])
              + torch.tensor([0.0, 0.0, 4.0]))
    n_obs = torch.randint(0, O + 1, (P,), generator=g)
    obs_kf = torch.stack([torch.randperm(K, generator=g)[:O]
                          for _ in range(P)]).to(torch.int32)
    obs_kf = torch.where(torch.arange(O)[None, :] < n_obs[:, None], obs_kf,
                         torch.full_like(obs_kf, -1))
    xyz = SE3(q=T_kw.q[obs_kf.clamp(min=0).long()],
              t=T_kw.t[obs_kf.clamp(min=0).long()]).apply(p_true[:, None, :])
    out = torch.rand(P, O, generator=g) < outliers
    xyz = torch.where(out[..., None], xyz * torch.tensor([1.0, 1.0, -1.0]),
                      xyz)
    f = xyz / torch.linalg.norm(xyz, dim=-1, keepdim=True)
    f = f + torch.randn(P, O, 3, generator=g) * noise
    f = torch.where((obs_kf >= 0)[..., None], f, torch.zeros_like(f))
    live = torch.rand(P, generator=g) < live_share
    pos = p_true + torch.randn(P, 3, generator=g) * offset
    kf_live = torch.rand(K, generator=g) < kf_live_share
    vo = st.init_state(cfg, 64, 48, device="cpu")
    points = vo.points.replace(
        pos=pos, ptype=torch.where(live, st.TYPE_CANDIDATE,
                                 st.TYPE_DELETED).to(torch.int32),
        last_optim=torch.randint(0, 40, (P,), generator=g,
                                 dtype=torch.int32),
        obs_kf=obs_kf, obs_f=f, obs_count=n_obs.to(torch.int32))
    kfs = vo.kfs.replace(q_kw=T_kw.q, t_kw=T_kw.t, valid=kf_live)
    move = (lambda a: a.replace(**{
        k: getattr(a, k).to(device) for k in a.__dataclass_fields__}))
    return (move(points), move(kfs),
            torch.tensor(137, dtype=torch.int32, device=device))


def point_operands(points, kfs, frame_id, cfg):
    """The op `svo_torch::point_gn`'s tensor operands for these inputs,
    the selection made as `optimize_structure` makes it."""
    from android_svo_tpu_torch.core import point_opt
    slots, sel = point_opt.select_points_for_optim(
        points.last_optim, points.valid & (points.obs_count >= 2),
        cfg.structureoptim_max_pts)
    return (points.pos, points.last_optim, points.obs_kf, points.obs_f,
            kfs.q_kw, kfs.t_kw, kfs.valid, slots, sel, frame_id)


def compare_points(args, n_iter: int, lm: bool):
    """point_gn_kernel against the plain version in float32 and in float64
    (`optimize_selected_plain`, the operands cast up) on the same operands
    (`point_operands`), by the cost each selected landmark ends at, in
    float64 on its live observations: the quantity the loop lowers.
    Float32 rounding alone sets where the plain version ends (a step kept
    or refused where its two costs lie a rounding apart, LM's damping then
    following that decision; a weakly held depth moved along its ray), so:
      - each landmark's cost may not exceed its starting cost (every step
        the kernel keeps lowered it);
      - where the landmark's 3x3 system at the start is regular in float32
        (condition number at most `POINT_COND`), its cost lies between the
        plain version's in float32 and in float64, widened by `POINT_REL`;
        a singular system (one usable observation, or nearly parallel
        rays) takes steps along its null direction that rounding alone
        sets, on each side its own way;
      - every other row, and all of `last_optim`, equal.
    Each cost comparison also admits `POINT_COST_ABS`.  Returns (the
    deviations, the failures)."""
    from android_svo_tpu_torch.core import point_opt
    from android_svo_tpu_torch.geometry.se3 import SE3
    from android_svo_tpu_torch.ops import point_gn
    plain = point_opt.optimize_selected_plain
    wide = [a.double() if a.is_floating_point() else a for a in args]
    ref, ref_lo = plain(*wide, n_iter, lm)
    kern, kern_lo = point_gn.point_gn(*args, n_iter, lm)
    pos, _, obs_kf, obs_f, q_kw, t_kw, kf_valid, slots, sel, _ = wide
    rows = slots[sel]
    okf = obs_kf[rows]
    ks = okf.clamp(min=0).long()
    live = (okf >= 0) & kf_valid[ks]
    T = SE3(q=q_kw[ks], t=t_kw[ks])

    def cost(p):
        return point_opt.optimize_points(p[rows].double(), T.q, T.t,
                                         obs_f[rows], live, sel[sel], 0)[1]

    # the condition number of each landmark's system at the start
    xyz = T.apply(pos[rows][:, None, :])
    ok = live & (xyz[..., 2] > 1e-2)
    z = torch.where(ok, xyz[..., 2], 1.0)
    zero = torch.zeros_like(z)
    dpi = torch.stack([torch.stack([1 / z, zero, -xyz[..., 0] / z**2], -1),
                       torch.stack([zero, 1 / z, -xyz[..., 1] / z**2], -1)],
                      -2)
    J = (dpi @ T.rotation_matrix()) * ok[..., None, None]
    eig = torch.linalg.eigvalsh(torch.einsum("soij,soik->sjk", J, J))
    regular = eig[:, -1] <= POINT_COND * eig[:, 0]

    c0, c_ref, c32, ck = (cost(pos), cost(ref),
                          cost(plain(*args, n_iter, lm)[0]), cost(kern))
    hi, lo = torch.maximum(c_ref, c32), torch.minimum(c_ref, c32)
    above = (ck - hi) / (hi + POINT_COST_ABS)
    below = (lo - ck) / (lo + POINT_COST_ABS)
    risen = (ck - c0) / (c0 + POINT_COST_ABS)

    def worst(x):
        return float(x.max()) if x.numel() else 0.0

    detail = {"landmarks": int(rows.numel()),
              "singular": int((~regular).sum()),
              "above": worst(above[regular]), "below": worst(below[regular]),
              "risen": worst(risen),
              "plain_gap": worst((c32 - c_ref).abs() / (c_ref
                                                        + POINT_COST_ABS))}
    failures = []
    for what, x, where in (("above the plain versions' by", above, regular),
                           ("below the plain versions' by", below, regular),
                           ("above its start by", risen,
                            torch.ones_like(regular))):
        far = ~(x <= POINT_REL) & where
        if bool(far.any()):
            failures.append(f"final costs of landmarks {rows[far].tolist()} "
                            f"{what} {x[far].tolist()}")
    rest = torch.ones(pos.shape[0], dtype=torch.bool, device=pos.device)
    rest[rows] = False
    if not torch.equal(kern[rest], args[0][rest]):
        failures.append("rows not selected differ")
    if not torch.equal(kern_lo, ref_lo):
        failures.append("last_optim differs")
    return detail, failures


# ---------------------------------------------------------------------------
# sparse image alignment: sparse_align_kernel against the plain loop
# ---------------------------------------------------------------------------

# the cameras the loop projects through: EuRoC cam0 (752x480, radtan; the
# cells' 912 grid rows), TUM fr3 (640x480 without distortion; 768 rows) and
# an ATAN (FOV) camera at 752x480
ALIGN_CAMERAS = {
    "radtan": (752, 480, (458.654, 457.296, 367.215, 248.375),
               {"k1": -0.28340811, "k2": 0.07395907, "p1": 0.00019359,
                "p2": 1.76187114e-05}),
    "pinhole": (640, 480, (535.4, 539.2, 320.1, 247.6), {}),
    "atan": (752, 480, (420.0, 420.0, 375.5, 239.5), {"s": 0.9}),
}
ALIGN_ROWS = {"radtan": 912, "pinhole": 768, "atan": 912}
ALIGN_GAP_PX = 0.05        # pose tolerance, px of projection gap at level 0
ALIGN_CHI2_RTOL = 1e-4     # final chi2, relative


def align_camera(kind: str, device="cuda"):
    from android_svo_tpu_torch.geometry.camera import (ATANCamera,
                                                       PinholeCamera)
    w, h, (fx, fy, cx, cy), extra = ALIGN_CAMERAS[kind]
    if kind == "atan":
        return ATANCamera.create(w, h, fx, fy, cx, cy, extra["s"],
                                 device=device)
    return PinholeCamera.create(w, h, fx, fy, cx, cy, **extra, device=device)


def align_inputs(seed: int, camera: str = "radtan", n: int | None = None,
                 valid_share: float = 0.9, behind: float = 0.0,
                 margin: float = 0.0, device="cuda"):
    """One frame's alignment problem: a textured plane 3 units ahead seen
    through `camera` from a reference pose and from a pose a few pixels of
    motion on (0.5-2 cm closer, up to 3 cm aside, a few mrad of rotation),
    both rendered and made into 5-level stacks; n reference pixels (the
    camera's grid rows by default) with their true depths, a share of them
    marked invalid, a share `behind` of them behind the camera (a negative
    depth) and a share `margin` of them within 40 px of the image's left or
    right border (about the in-bounds margin at the coarse levels).  Returns
    sparse_img_align's inputs but the config: (ref_stack, cur_stack, cam,
    T_init (identity), ref_px, ref_f, ref_depth, valid)."""
    from android_svo_tpu_torch.data import synthetic
    from android_svo_tpu_torch.geometry.se3 import SE3
    from android_svo_tpu_torch.ops.pyramid import build_stack
    g = torch.Generator().manual_seed(seed)
    cam = align_camera(camera, device)
    n = ALIGN_ROWS[camera] if n is None else n
    w, h = cam.width, cam.height
    tex = synthetic.make_texture(g, 1024, device=device)
    u = torch.rand(8, generator=g)
    x0, y0 = float(u[0] - 0.5) * 0.4, float(u[1] - 0.5) * 0.4
    rot0 = tuple(float(r) for r in (torch.rand(3, generator=g) - 0.5) * 0.04)
    T_ref = synthetic.lookdown_pose(x0, y0, -3.0, rot0, device=device)
    drot = (torch.rand(3, generator=g) - 0.5) * 0.008
    T_cur = synthetic.lookdown_pose(
        x0 + float(u[2] - 0.5) * 0.06, y0 + float(u[3] - 0.5) * 0.06,
        -3.0 + 0.005 + float(u[4]) * 0.015,
        tuple(r + float(d) for r, d in zip(rot0, drot)), device=device)
    stacks = [build_stack(synthetic.render(tex, cam, T), 5)
              for T in (T_ref, T_cur)]
    px = torch.rand(n, 2, generator=g) * torch.tensor([w - 1.0, h - 1.0])
    edge = torch.rand(n, generator=g) < margin
    side = torch.rand(n, generator=g) < 0.5
    near = torch.rand(n, generator=g) * 40.0
    px[:, 0] = torch.where(edge, torch.where(side, near, w - 1.0 - near),
                           px[:, 0])
    px = px.to(device)
    f = cam.cam2world(px)
    depth = synthetic.true_depth(cam, T_ref, px)
    back = (torch.rand(n, generator=g) < behind).to(device)
    depth = torch.where(back, -depth, depth)
    valid = (torch.rand(n, generator=g) < valid_share).to(device)
    T0 = SE3.identity(device=device)
    return (stacks[0], stacks[1], cam, T0, px, f, depth, valid)


def stack_align_inputs(scenes: list):
    """The batched form of several `align_inputs` of one camera: every
    input stacked on a leading axis, the camera shared."""
    from android_svo_tpu_torch.geometry.se3 import SE3
    cam = scenes[0][2]
    T0 = SE3(q=torch.stack([s[3].q for s in scenes]),
             t=torch.stack([s[3].t for s in scenes]))
    rest = [torch.stack([s[i] for s in scenes]) for i in (4, 5, 6, 7)]
    return (torch.stack([s[0] for s in scenes]),
            torch.stack([s[1] for s in scenes]), cam, T0, *rest)


def align_gap_px(Ta, Tb, args) -> float:
    """The widest gap (level-0 px) between the projections of the valid
    reference points in front of both poses."""
    cam, depth, valid = args[2], args[6], args[7]
    xyz = args[5] * depth[..., None]
    a, b = Ta.apply(xyz), Tb.apply(xyz)
    ok = valid & (depth > 0) & (a[:, 2] > 1e-3) & (b[:, 2] > 1e-3)
    d = torch.linalg.norm(cam.world2cam(a) - cam.world2cam(b), dim=-1)
    return float(d[ok].max()) if bool(ok.any()) else 0.0


def compare_align(k, p, args):
    """sparse_img_align's outputs (T, n_tracked, chi2) on the kernel (k)
    against the plain loop's (p) on the same inputs (`args`, as
    `align_inputs` gives them).  Only the order of the sums differs, so the
    tolerances are rounding's:
      - pose: 0.05 px of projection gap at level 0.  A step whose cost lies
        within rounding of the best so far can be kept on one side and
        refused on the other (GN stops at its first refused step), which
        parts the poses by a fraction of a step near the optimum;
      - n_tracked: equal (the rows usable at the result);
      - chi2: 1e-4 relative (the same residuals summed in another order).
    Returns (the deviations, the failures)."""
    gap = align_gap_px(k[0], p[0], args)
    detail = {"gap_px": gap, "n_tracked": (int(k[1]), int(p[1])),
              "chi2": (float(k[2]), float(p[2]))}
    failures = []
    if not gap <= ALIGN_GAP_PX:
        failures.append(f"pose: projection gap {gap} px > {ALIGN_GAP_PX}")
    if int(k[1]) != int(p[1]):
        failures.append(f"n_tracked {detail['n_tracked']}")
    if not torch.allclose(k[2], p[2], rtol=ALIGN_CHI2_RTOL, atol=0.0):
        failures.append(f"chi2 {detail['chi2']}")
    return detail, failures


def plain_align_trace(args, cfg, method: str = "gn"):
    """The plain loop on `args` (one frame, `use_pallas` off) with each
    iteration's cost at its pose and the best cost so far recorded: returns
    (outputs, iterations per level, [(level, chi2, best_chi2)]).  A step
    whose chi2 lies within ALIGN_CHI2_RTOL of the best so far is a tie that
    rounding may decide either way: the kernel's and the plain loop's
    iteration counts may part from that level on."""
    from android_svo_tpu_torch.ops import sparse_align as sa
    orig = sa._align_step
    rec = []

    def traced(cur_stack, xyz_ref, ok_ref, patch_ref, J, carry, cam, level,
               cfg_, lm):
        fresh = (carry[0], carry[1], carry[0], carry[1],
                 torch.full_like(carry[4], math.inf), *carry[5:])
        chi2 = orig(cur_stack, xyz_ref, ok_ref, patch_ref, J, fresh, cam,
                    level, cfg_, lm)[0][4]
        rec.append((level, float(chi2), float(carry[4])))
        return orig(cur_stack, xyz_ref, ok_ref, patch_ref, J, carry, cam,
                    level, cfg_, lm)

    sa._align_step = traced
    try:
        out = sa.sparse_img_align(*args, cfg.replace(use_pallas=False),
                                  method=method)
    finally:
        sa._align_step = orig
    return out, list(sa.ITERATIONS), rec


def first_tie_level(rec, levels) -> int:
    """The index (into `levels`, coarse to fine) of the first level whose
    plain loop met a tie (`plain_align_trace`), or len(levels)."""
    for level, chi2, best in rec:
        if math.isfinite(best) and abs(chi2 - best) <= (
                ALIGN_CHI2_RTOL * abs(best)):
            return list(levels).index(level)
    return len(levels)


# ---------------------------------------------------------------------------
# the radtan camera: camera_cam2world_kernel and camera_world2cam_kernel
# against PinholeCamera's plain versions
# ---------------------------------------------------------------------------

# EuRoC cam0's coefficients (the cells' camera) and a strongly distorted set
# with every coefficient set (8 Newton steps still undistort its corners to
# 0.03 px of the round trip)
CAMERA_COEFFS = {"euroc": ALIGN_CAMERAS["radtan"][3],
                 "strong": {"k1": -0.36, "k2": 0.14, "p1": 0.002,
                            "p2": -0.0017, "k3": -0.02}}
CAMERA_ROWS = (1, 912, 2048, 8192)  # one row, the grid's rows, seeds,
                                    # the landmarks
CAMERA_BATCH = (11, 912)          # the batched step's sequences and rows


def radtan_camera(coeffs: str = "euroc", device="cuda"):
    """EuRoC cam0's 752x480 intrinsics with the `CAMERA_COEFFS` set."""
    from android_svo_tpu_torch.geometry.camera import PinholeCamera
    w, h, (fx, fy, cx, cy), _ = ALIGN_CAMERAS["radtan"]
    return PinholeCamera.create(w, h, fx, fy, cx, cy,
                                **CAMERA_COEFFS[coeffs], device=device)


def camera_pixels(cam, n: int, seed: int, device="cuda") -> torch.Tensor:
    """n pixels (n, 2): the four image corners, where r^2 is largest, then
    uniform draws over the image from `seed`."""
    g = torch.Generator().manual_seed(seed)
    w, h = cam.width - 0.5, cam.height - 0.5
    corners = torch.tensor([[-0.5, -0.5], [w, -0.5], [-0.5, h], [w, h]])
    px = torch.rand(n, 2, generator=g) * torch.tensor([w + 0.5, h + 0.5]) \
        - 0.5
    return torch.cat([corners, px])[:n].to(device)


def camera_points(cam, n: int, seed: int, device="cuda") -> torch.Tensor:
    """n points (n, 3) in front of the camera, 0.5-10 units deep along the
    rays of `camera_pixels`."""
    g = torch.Generator().manual_seed(seed + 1)
    depth = (0.5 + 9.5 * torch.rand(n, 1, generator=g)).to(device)
    return cam.cam2world_plain(camera_pixels(cam, n, seed, device)) * depth


def ulp_gap(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance of two float32 tensors in units in the last place
    (NaNs where both have them left out)."""
    both = ~(torch.isnan(a) & torch.isnan(b))
    ia, ib = (t[both].view(torch.int32).to(torch.int64) for t in (a, b))
    ia, ib = (torch.where(i < 0, -(i & 0x7FFFFFFF), i) for i in (ia, ib))
    return int((ia - ib).abs().max()) if ia.numel() else 0


def camera_calls(cam, n: int, seed: int, device="cuda") -> dict:
    """form -> (kernel call, plain call, ulps allowed) of every form on n
    rows: cam2world on (n, 2) and on (K, M, 2); world2cam on (n, 3) and on
    (B, N, 3); world2cam_uv on (n, 2).  Pixels bit for bit; the bearings
    within one ulp (the norm's 3-term sum)."""
    px = camera_pixels(cam, n, seed, device)
    xyz = camera_points(cam, n, seed, device)
    uv = xyz[:, :2] / xyz[:, 2:]
    k = 8 if n % 8 == 0 else 1
    return {
        "cam2world": (lambda: cam.cam2world(px),
                      lambda: cam.cam2world_plain(px), 1),
        "cam2world (K, M, 2)": (
            lambda: cam.cam2world(px.reshape(k, -1, 2)),
            lambda: cam.cam2world_plain(px.reshape(k, -1, 2)), 1),
        "world2cam": (lambda: cam.world2cam(xyz),
                      lambda: cam.world2cam_plain(xyz), 0),
        "world2cam (B, N, 3)": (
            lambda: cam.world2cam(xyz.reshape(k, -1, 3)),
            lambda: cam.world2cam_plain(xyz.reshape(k, -1, 3)), 0),
        "world2cam_uv": (lambda: cam.world2cam_uv(uv),
                         lambda: cam.world2cam_uv_plain(uv), 0),
    }


def camera_failures(device="cuda") -> list:
    """The radtan kernels against the plain versions (`camera_calls`) at
    EuRoC cam0's and the strong coefficients and `CAMERA_ROWS`, corners
    included: the plain version's shape, one launch a call; one call one
    device activity, at most 2 ATen ops, nothing read back; under
    torch.func.vmap over 11 x 912 rows, one launch a call, each sequence
    bit for bit its single launch, and the batch on dimension 1 the
    same."""
    from android_svo_tpu_torch.ops import camera_kernels as ck
    failures = []
    for coeffs in CAMERA_COEFFS:
        cam = radtan_camera(coeffs, device)
        for n in CAMERA_ROWS:
            for form, (kernel, plain, ulps) in camera_calls(
                    cam, n, n, device).items():
                what = f"{coeffs}, {n} rows, {form}"
                before = sum(ck.LAUNCHES.values())
                got, want = kernel(), plain()
                if sum(ck.LAUNCHES.values()) - before != 1:
                    failures.append(f"{what}: not one launch")
                if got.shape != want.shape:
                    failures.append(f"{what}: shape {tuple(got.shape)}, "
                                    f"not {tuple(want.shape)}")
                    continue
                gap = ulp_gap(got, want)
                if not (torch.equal(torch.isnan(got), torch.isnan(want))
                        and gap <= ulps):
                    failures.append(f"{what}: {gap} ulps from the plain "
                                    f"version (allowed {ulps})")
    cam = radtan_camera("euroc", device)
    calls = camera_calls(cam, CAMERA_BATCH[1], 0, device)
    failures += dispatch_failures(
        {f"dispatch {form}": (fn, 2) for form, (fn, _, _) in calls.items()})
    for form, (fn, _, _) in calls.items():
        failures += [f"{form} reads {r}" for r in host_reads(fn)]

    b, n = CAMERA_BATCH
    px = torch.stack([camera_pixels(cam, n, s, device) for s in range(b)])
    xyz = torch.stack([camera_points(cam, n, s, device) for s in range(b)])
    uv = xyz[..., :2] / xyz[..., 2:]
    vm = torch.func.vmap
    for form, fn, x in (("cam2world", cam.cam2world, px),
                        ("world2cam", cam.world2cam, xyz),
                        ("world2cam_uv", cam.world2cam_uv, uv)):
        before = sum(ck.LAUNCHES.values())
        out = vm(fn)(x)
        if sum(ck.LAUNCHES.values()) - before != 1:
            failures.append(f"batched {form}: not one launch for {b} "
                            "sequences")
        if not all(same_bits(out[i], fn(x[i])) for i in range(b)):
            failures.append(f"batched {form}: differs from its single "
                            "launches")
        if not same_bits(vm(fn, in_dims=1)(x.movedim(0, 1).contiguous()),
                         out):
            failures.append(f"batched {form}: the batch on dimension 1 "
                            "differs")
        failures += dispatch_failures(
            {f"batched {form}": (lambda fn=fn, x=x: vm(fn)(x), None)})
        failures += [f"batched {form} reads {r}"
                     for r in host_reads(lambda fn=fn, x=x: vm(fn)(x))]
    return failures


# ---------------------------------------------------------------------------
# every kernel at the tracking path's shapes, in one call
# ---------------------------------------------------------------------------

# the tracking path's gate problems as (n, h, w): 768 rows on 640x480 and on
# EuRoC cam0's 752x480 (level 0 padded to 768 columns, level 4 47 wide);
# the batched step's as (B, n, h, w): 11 frames of 768 rows on 752x480
PATH_SHAPES = {"768_640x480": (768, 480, 640), "768_752x480": (768, 480, 752)}
BATCHED_PATH_SHAPES = {"11x768_752x480": (11, 768, 480, 752)}
POSE_ROWS = (912, 768)     # the arena's rows at 752x480 and at 640x480
PROBE_N = 2048             # the reference probe scripts' feature count


# the host's runtime calls that each put one kernel, copy or set on the card
ENQUEUE_CALLS = frozenset({
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
    "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemcpy", "cudaMemsetAsync",
    "cudaMemset"})
# the host's runtime calls that wait for the card: a read back waits so
WAIT_CALLS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy"})
_RANGE = "silicon_gate.call"


def _profile_call(fn):
    """The profiler's events of one call of fn inside a range of its own,
    the card synchronised after the range, and a test of whether an event
    lies inside the range."""
    from torch.profiler import ProfilerActivity, profile
    from android_svo_tpu_torch.utils import profiling
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with profiling.span(_RANGE):
            fn()
        torch.cuda.synchronize()

    def inside(e):
        p = e.cpu_parent
        while p is not None and p.name != _RANGE:
            p = p.cpu_parent
        return p is not None

    return prof.events(), inside


def dispatch_counts(fn) -> tuple:
    """(ATen ops, device activities) of one call of fn under torch.profiler:
    the ATen ops fn dispatches itself, counted as
    `utils/profiling.py::dispatch_counts` counts them (a port custom op,
    `svo_torch::*`, and a patch function's span, `patch.*`, looked
    through), and the kernels, copies and sets it puts on the card, counted
    on the host as the runtime calls that enqueue them (`ENQUEUE_CALLS`).
    The host's side, because the profiler drops the card's own records of
    short profiles: on an H100 machine, from about 30 s into a process
    (busy or idle), a profile of one launch held its runtime call and no
    device record, not even its range's."""
    events, _ = _profile_call(fn)

    def own(e):
        p = e.cpu_parent
        while p is not None and p.name.startswith(("svo_torch::", "patch.")):
            p = p.cpu_parent
        return p is not None and p.name == _RANGE

    return (sum(e.name.startswith("aten::") and own(e) for e in events),
            sum(e.name in ENQUEUE_CALLS for e in events))


def host_reads(fn) -> list:
    """The names of the events of one profiled call of fn that read the
    card back or wait for it: a 0-d read (`aten::item`,
    `aten::_local_scalar_dense`), a device-to-host copy, or, inside the
    call, a runtime call that waits for the card (`WAIT_CALLS`: a read
    back waits on its stream; the copy's own device record may be
    dropped, see `dispatch_counts`)."""
    events, inside = _profile_call(fn)
    return sorted({e.name for e in events
                   if e.name in ("aten::item", "aten::_local_scalar_dense")
                   or "DtoH" in e.name or "Device -> Host" in e.name
                   or (e.name in WAIT_CALLS and inside(e))})


def dispatch_cases(x: dict) -> dict:
    """case -> (fn, its ATen-op limit) for one call of every patch-function
    form on a gate problem; each call must also be exactly one device
    activity."""
    from android_svo_tpu_torch.tools import patch_ab
    calls = {**kernel_calls(x), **patch_ab.extra_calls(x)}

    def form(name):
        return lambda: calls[name](True)

    return {
        "sample_4x4": (form("sample_patches_kernel"), 4),
        "sample_8x8_grad": (lambda: pk.sample_patches(
            x["stack"], x["lvl"], x["uv"], 4, grad=True), 4),
        "sample_8x8_align1d": (form("sample_patches_kernel/align1d"), 4),
        "sample_4x4_ref_grad": (form("sample_patches_kernel/ref_grad"), 4),
        "window_gated": (form("align_iclk_window_kernel"), 3),
        "window_ungated": (form("align_iclk_window_kernel/ungated"), 3),
        "align": (form("align_iclk_kernel"), 3),
        "scan": (form("epi_scan_kernel"), 3),
        "scan_path": (form("epi_scan_kernel/path"), 3),
        "scan_no_steps": (lambda: pk.epi_scan(
            x["stack"], x["lvl"], x["uv_a"], x["uv_b"], x["ref"], 100,
            h=x["h"], w=x["w"]), 3),
        "dump": (form("dump_windows_kernel"), 3),
    }


def extra_forms_failures(x: dict, batched: bool = False) -> list:
    """The two forms the gate's own calls leave out
    (`tools/patch_ab.py::extra_calls`) against their plain versions with
    the gate's bounds: the 4x4 gradient form within 0.02 on live slots;
    the scan at the path's 0.7 px with at least 80% of seeds finite,
    scores within 2.0, and best_t within 1e-3 but on at most 1% of seeds
    within one step (1/99): at 0.7 px two neighbouring positions score
    within rounding of each other, and the plain version rounds the blend
    apart from the kernel.  Returns the failures."""
    from android_svo_tpu_torch.tools import patch_ab
    calls = patch_ab.extra_calls(x, batched=batched)
    failures = []
    live = x["valid"].reshape(-1)
    name = "sample_patches_kernel/ref_grad"
    for a, b in zip(calls[name](True), calls[name](False)):
        a, b = (o.reshape(live.numel(), -1)[live] for o in (a, b))
        d = float((a - b).abs().max())
        if not d <= 0.02:
            failures.append(f"{name}: max|d| {d} > 0.02")
    name = "epi_scan_kernel/path"
    (tk, sk), (tp, sp) = ([o.reshape(-1) for o in calls[name](up)]
                          for up in (True, False))
    fin = torch.isfinite(sk) & torch.isfinite(sp)
    if int(fin.sum()) < 0.8 * fin.numel():
        failures.append(f"{name}: only {int(fin.sum())}/{fin.numel()} "
                        "finite")
    dt = (tk - tp)[fin].abs()
    ds = float((sk - sp)[fin].abs().max()) if dt.numel() else 0.0
    moved = int((dt > 1e-3).sum())
    if dt.numel() and not (float(dt.max()) <= 1.0 / 99 + 1e-6
                           and moved <= 0.01 * fin.numel() and ds <= 2.0):
        failures.append(f"{name}: best_t max|d| {float(dt.max())} "
                        f"({moved} seeds past 1e-3), score max|d| {ds}")
    return failures


def dispatch_failures(cases: dict) -> list:
    """Each case -> (fn, ATen-op limit or None) called once, then profiled
    (`dispatch_counts`): the cases past the limit or not one device
    activity a call."""
    failures = []
    for case, (fn, limit) in cases.items():
        fn()
        n_ops, n_dev = dispatch_counts(fn)
        if n_dev != 1 or (limit is not None and n_ops > limit):
            failures.append(f"{case}: {n_ops} ATen ops and {n_dev} device "
                            "activities a call")
    return failures


def batched_extra_failures(frames: list, xb: dict) -> list:
    """The batched forms beyond `run_batched_gate`'s: the two extra forms
    against their batched plain versions (`extra_forms_failures`), one
    launch a batch and each frame bit for bit its single launch; every
    batched form one device activity a call, the ICLKs at most 3 ATen ops
    (their output allocations: they read the (B, N) rows in place)."""
    from android_svo_tpu_torch.tools import patch_ab
    failures = extra_forms_failures(xb, batched=True)
    extra = patch_ab.extra_calls(xb, batched=True)
    for name, fn in extra.items():
        kernel = kernel_of(name)
        before = pk.LAUNCHES[kernel]
        out = fn(True)
        if pk.LAUNCHES[kernel] - before != 1:
            failures.append(f"batched {name}: not one launch a batch")
        out = out if isinstance(out, tuple) else (out,)
        for b, x in enumerate(frames):
            one = patch_ab.extra_calls(x)[name](True)
            one = one if isinstance(one, tuple) else (one,)
            if not all(same_bits(o[b], s) for o, s in zip(out, one)):
                failures.append(f"batched {name}: frame {b} differs from "
                                "its single launch")
    calls = {**batched_kernel_calls(xb), **extra}
    cases = {f"batched {name}": (
        lambda fn=fn: fn(True), 3 if name.startswith("align_iclk") else None)
        for name, fn in calls.items()}
    return failures + dispatch_failures(cases)


def pose_failures(device="cuda") -> list:
    """pose_gn_kernel against the plain version (`compare_pose`) at
    `POSE_ROWS`, GN and LM, one launch a call; one call a frame is one
    device activity and at most 7 ATen ops, and reads nothing back; a
    torch.func.vmap over 11 frames of 912 rows is one launch and one
    device activity, reads nothing back, each frame within `compare_pose`
    of the vmapped plain version and bit for bit its single launch."""
    from android_svo_tpu_torch.config import SVOConfig
    from android_svo_tpu_torch.core import pose_opt
    from android_svo_tpu_torch.geometry.se3 import SE3
    from android_svo_tpu_torch.ops import pose_gn as pg
    kernel = "pose_gn_kernel"
    failures = []
    for n in POSE_ROWS:
        for method in ("gn", "lm"):
            cfg = SVOConfig(poseoptim_method=method)
            args = pose_inputs(1, n=n, device=device)
            pg.reset_launch_counts()
            k = pose_opt.optimize_pose(*args, cfg)
            p = pose_opt.optimize_pose(*args, cfg.replace(use_pallas=False))
            torch.cuda.synchronize()
            if pg.LAUNCHES[kernel] != 1:
                failures.append(f"{n} rows, {method}: {pg.LAUNCHES[kernel]}"
                                " launches for a kernel and a plain call")
            failures += [f"{n} rows, {method}: {f}" for f in compare_pose(
                k, p, args, cfg.poseoptim_thresh)[1]]
            if method == "gn":
                one = (lambda a=args, c=cfg: pose_opt.optimize_pose(*a, c))
                failures += dispatch_failures({f"{n} rows": (one, 7)})
                failures += [f"{n} rows reads {r}" for r in host_reads(one)]

    cfg = SVOConfig()
    scenes = [pose_inputs(10 + s, n=POSE_ROWS[0], outliers=0.05 * (s % 4),
                          behind=0.02 * (s % 3), device=device)
              for s in range(11)]
    q = torch.stack([sc[0].q for sc in scenes])
    t = torch.stack([sc[0].t for sc in scenes]) + 0.01
    rows = [torch.stack([sc[i] for sc in scenes]) for i in range(1, 5)]
    focal = scenes[0][5]

    def batched(c):
        return torch.func.vmap(lambda q, t, *r: pose_opt.optimize_pose(
            SE3(q=q, t=t), *r, focal, c))(q, t, *rows)

    pg.reset_launch_counts()
    out = batched(cfg)
    out_p = batched(cfg.replace(use_pallas=False))
    torch.cuda.synchronize()
    if pg.LAUNCHES[kernel] != 1:
        failures.append(f"batched: {pg.LAUNCHES[kernel]} launches for a "
                        "vmapped call and its plain run")
    for b in range(11):
        args = (SE3(q=q[b], t=t[b]), *(r[b] for r in rows), focal)
        kb, pb = ((SE3(q=o[0].q[b], t=o[0].t[b]), *(v[b] for v in o[1:]))
                  for o in (out, out_p))
        failures += [f"batched, frame {b}: {f}" for f in compare_pose(
            kb, pb, args, cfg.poseoptim_thresh)[1]]
        one = pose_opt.optimize_pose(*args, cfg)
        if not all(same_bits(o, s) for o, s in zip(
                (kb[0].q, kb[0].t, *kb[1:]), (one[0].q, one[0].t, *one[1:]))):
            failures.append(f"batched, frame {b}: differs from its single "
                            "launch")
    failures += dispatch_failures({"batched": (lambda: batched(cfg), None)})
    failures += [f"batched reads {r}" for r in host_reads(
        lambda: batched(cfg))]
    return failures


def point_failures(device="cuda") -> list:
    """point_gn_kernel against the plain version (`compare_points`) at the
    path's shapes (`POINT_SHAPES`), GN and LM: one launch a call, the stage
    (`optimize_structure`: the selection and the launch) at most
    `POINT_STAGE_OPS` ATen ops and the op one device activity, nothing read
    back; a torch.func.vmap of the stage over `POINT_BATCH` sequences is
    one launch, reads nothing back, and gives each sequence its single
    launch bit for bit."""
    from android_svo_tpu_torch.core import point_opt
    from android_svo_tpu_torch.core import state as st
    from android_svo_tpu_torch.ops import point_gn as pg
    kernel = "point_gn_kernel"
    n_iter = POINT_SHAPES["n_iter"]
    failures = []
    for method in ("gn", "lm"):
        cfg = point_config(method)
        inputs = point_inputs(1, cfg, device=device)
        args = point_operands(*inputs, cfg)
        failures += [f"{method}: {f}" for f in compare_points(
            args, n_iter, method == "lm")[1]]
        pg.reset_launch_counts()
        stage = (lambda i=inputs, c=cfg: point_opt.optimize_structure(*i, c))
        stage()
        torch.cuda.synchronize()
        if pg.LAUNCHES[kernel] != 1:
            failures.append(f"{method}: {pg.LAUNCHES[kernel]} launches for "
                            "a stage")
        n_ops, _ = dispatch_counts(stage)
        if n_ops > POINT_STAGE_OPS:
            failures.append(f"{method}: the stage dispatches {n_ops} ATen "
                            "ops")
        failures += dispatch_failures({f"{method} op": (
            lambda a=args, lm=method == "lm": pg.point_gn(*a, n_iter, lm),
            2)})
        failures += [f"{method} reads {r}" for r in host_reads(stage)]

    cfg = point_config()
    scenes = [point_inputs(10 + s, cfg, live_share=0.3 + 0.05 * s,
                           outliers=0.02 * (s % 3), device=device)
              for s in range(POINT_BATCH)]
    stacked = [st.stack_states([sc[i] for sc in scenes])
               for i in range(3)]

    def batched():
        return torch.func.vmap(lambda p, k, f: point_opt.optimize_structure(
            p, k, f, cfg))(*stacked)

    pg.reset_launch_counts()
    out = batched()
    torch.cuda.synchronize()
    if pg.LAUNCHES[kernel] != 1:
        failures.append(f"batched: {pg.LAUNCHES[kernel]} launches")
    for b, sc in enumerate(scenes):
        one = point_opt.optimize_structure(*sc, cfg)
        if not (same_bits(out.pos[b], one.pos)
                and same_bits(out.last_optim[b], one.last_optim)):
            failures.append(f"batched, sequence {b}: differs from its "
                            "single launch")
        failures += [f"batched, sequence {b}: {f}" for f in compare_points(
            point_operands(*sc, cfg), n_iter, False)[1]]
    failures += [f"batched reads {r}" for r in host_reads(batched)]
    return failures


def align_failures(device="cuda") -> list:
    """sparse_align_kernel against the plain loop (`compare_align`) at the
    cells' cameras and rows (radtan at 752x480, 912; no distortion at
    640x480, 768), GN and LM, one launch a call, no read back; 11 radtan
    frames in one batched call: one launch, no read back, each frame bit
    for bit its single launch (its iteration counts too) and within
    `compare_align` of its plain loop."""
    from android_svo_tpu_torch.config import SVOConfig
    from android_svo_tpu_torch.ops import sparse_align
    from android_svo_tpu_torch.ops import sparse_align_gn as sg
    kernel = "sparse_align_kernel"
    cfg = SVOConfig()
    failures = []
    for camera in ("radtan", "pinhole"):
        args = align_inputs(1, camera, device=device)
        for method in ("gn", "lm"):
            sg.reset_launch_counts()
            k = sparse_align.sparse_img_align(*args, cfg, method=method)
            p = sparse_align.sparse_img_align(
                *args, cfg.replace(use_pallas=False), method=method)
            torch.cuda.synchronize()
            what = f"{camera}, {method}"
            if sg.LAUNCHES[kernel] != 1:
                failures.append(f"{what}: {sg.LAUNCHES[kernel]} launches "
                                "for a kernel and a plain call")
            failures += [f"{what}: {f}"
                         for f in compare_align(k, p, args)[1]]
            failures += [f"{what} reads {r}" for r in host_reads(
                lambda: sparse_align.sparse_img_align(*args, cfg,
                                                      method=method))]

    scenes = [align_inputs(10 + s, "radtan", device=device,
                           behind=0.02 * (s % 3), margin=0.1 * (s % 2))
              for s in range(11)]
    batch = stack_align_inputs(scenes)
    sg.reset_launch_counts()
    T, n_tr, chi2 = sparse_align.sparse_img_align(*batch, cfg, batched=True)
    its = sparse_align.KERNEL_ITERATIONS.tolist()
    if sg.LAUNCHES[kernel] != 1:
        failures.append(f"batched: {sg.LAUNCHES[kernel]} launches for 11 "
                        "frames")
    for b, sc in enumerate(scenes):
        one = sparse_align.sparse_img_align(*sc, cfg)
        if not (all(same_bits(o, w) for o, w in zip(
                (T.q[b], T.t[b], n_tr[b], chi2[b]),
                (one[0].q, one[0].t, one[1], one[2])))
                and its[b] == sparse_align.KERNEL_ITERATIONS.tolist()):
            failures.append(f"batched, frame {b}: differs from its single "
                            "launch")
        p = sparse_align.sparse_img_align(*sc, cfg.replace(use_pallas=False))
        failures += [f"batched, frame {b}: {f}"
                     for f in compare_align(one, p, sc)[1]]
    failures += [f"batched reads {r}" for r in host_reads(
        lambda: sparse_align.sparse_img_align(*batch, cfg, batched=True))]
    return failures


def probe_failures(device="cuda", n: int = PROBE_N) -> list:
    """probe_patches_kernel on the gather microbench's inputs at n
    features: every variant within 1e-5 of its plain version, variant A
    within 1e-4 of interp.extract_patches; variant A's call one launch, at
    most 1 ATen op (its output) and one device activity."""
    from android_svo_tpu_torch.ops import gather_probe as gp, interp
    from android_svo_tpu_torch.tools import microbench_gather
    img, uv = microbench_gather.make_inputs(n=n, seed=1, device=device)
    failures = []
    for v in gp.VARIANTS:
        out = gp.probe_patches(img, uv, v)
        d = float((out - gp.probe_patches_plain(img, uv, v)).abs().max())
        if not d <= 1e-5:
            failures.append(f"variant {v}: max|d| vs plain {d} > 1e-5")
        if v == "A":
            d = float((out - interp.extract_patches(img, uv, gp.P // 2))
                      .abs().max())
            if not d <= 1e-4:
                failures.append(f"variant A: max|d| vs extract_patches "
                                f"{d} > 1e-4")
    return failures + dispatch_failures(
        {"variant A": (lambda: gp.probe_patches(img, uv, "A"), 1)})


def path_gate(device="cuda") -> dict:
    """Every kernel against its plain version, its launches and its
    dispatch at the tracking path's shapes: `run_gate`, the two extra
    forms and each form's dispatch (`dispatch_cases`) at `PATH_SHAPES`;
    no ICLK layout spilling at their rows; `run_batched_gate` and
    `batched_extra_failures` at `BATCHED_PATH_SHAPES`; pose GN
    (`pose_failures`), structure GN (`point_failures`), sparse alignment
    (`align_failures`), the gather
    probe (`probe_failures`) and the radtan camera
    (`camera_failures`).  Returns check -> its failures (empty where it
    held).  The card tests and `chip_smoke.py` both run it; a new
    kernel's check at the path's shapes goes here."""
    out = {}
    for name, (n, h, w) in PATH_SHAPES.items():
        x = gate_inputs(n=n, h=h, w=w, seed=0, device=device)
        out[f"gate {name}"] = (
            run_gate(x).failures + extra_forms_failures(x)
            + dispatch_failures(dispatch_cases(x)))
        out[f"iclk layout {n} rows"] = [
            f"{'window' if window else 'align'}: {r['local_bytes']} local "
            "bytes a thread"
            for window in (False, True)
            for r in [pk.iclk_residency(4, window, n)] if r["local_bytes"]]
    for name, (b, n, h, w) in BATCHED_PATH_SHAPES.items():
        frames, xb = batched_gate_inputs(b, n=n, h=h, w=w, seed=0,
                                         device=device)
        out[f"batched gate {name}"] = (
            run_batched_gate(frames, xb).failures
            + batched_extra_failures(frames, xb))
        out[f"iclk layout {b * n} rows"] = [
            f"{'window' if window else 'align'}: {r['local_bytes']} local "
            "bytes a thread"
            for window in (False, True)
            for r in [pk.iclk_residency(4, window, b * n)]
            if r["local_bytes"]]
    out["pose_gn_kernel"] = pose_failures(device)
    out["point_gn_kernel"] = point_failures(device)
    out["sparse_align_kernel"] = align_failures(device)
    out["probe_patches_kernel"] = probe_failures(device)
    out["camera_kernels"] = camera_failures(device)
    return out


# ---------------------------------------------------------------------------
# least times of the kernels the benchmark's bounds leave out
# ---------------------------------------------------------------------------

# NVIDIA H100 SXM data sheet, as `svo_bench/reference/bounds.py`: HBM3
# bandwidth and float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12


def least_ms(bytes_moved: float, flops: float) -> tuple:
    """(ms, "bytes" or "operations", bytes, flops): the larger of the bytes
    over the HBM's rate and the operations over the float32 peak."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations",
            int(bytes_moved), int(flops))


def pose_bound(n: int, n_iter: int, batch: int = 1) -> tuple:
    """Least time of pose_gn_kernel on `batch` frames of n rows
    (`least_ms`): the bytes it must move (29 a row read: p_w, f_meas,
    level, valid; 1 a row written: the inlier mask; 72 for the pose, focal
    and the scalars; 144 for cov), or its fp32 operations: a row costs ~36
    in a weighted cost (transform, projection, norm, Tukey weight) and
    ~170 in the normal equations (the 2x6 Jacobian, 21 + 6 products summed
    over two residuals), so ~242 an iteration (the cost at the pose, the
    system, the cost at the step) and ~235 at the start and the end (the
    residuals, the final system).  The kernel is bound by neither: by the
    latency of its serial iterations."""
    return least_ms(batch * (n * 30 + 72 + 144),
                    batch * n * (242 * n_iter + 235))


def point_bound(n_points: int, n_obs: int, n_iter: int, n_select: int,
                batch: int = 1) -> tuple:
    """Least time of point_gn_kernel on `batch` frames (`least_ms`): the
    bytes it must move (the arena's pos and last_optim read and the new
    ones written, 32 bytes a row; a selected landmark's slot, flag and row,
    21 bytes, and each of its observations, 16 bytes and its keyframe's 29;
    4 for the frame's stamp), or its fp32 operations: an observation costs
    ~30 in the cost (the pose applied, the projection, the squared
    residual) and ~75 more in the normal equations (R from q, the 2x3
    Jacobian, 6 + 3 products summed), a landmark's solve and step ~40, so
    ~(135 n_obs + 40) an iteration and ~30 n_obs at the start.  The kernel
    is bound by neither: by the latency of its serial iterations."""
    bytes_moved = (n_points * 32 + n_select * (21 + n_obs * (16 + 29)) + 4)
    flops = n_select * (n_iter * (135 * n_obs + 40) + 30 * n_obs)
    return least_ms(batch * bytes_moved, batch * flops)


def align_bound(n: int, n_iter: int, batch: int = 1, n_levels: int = 3,
                area: int = 16) -> tuple:
    """Least time of sparse_align_kernel on `batch` frames of n rows that
    ran n_iter iterations in all, summed over the frames (`least_ms`): the
    bytes it must move (the reference side once a level: a flag and the
    patch, gx and gy a row, 1 + 12 area bytes; the points once, 12 a row;
    the current level planes at most once, taken as the 4x4 taps of every
    row, 4 area bytes a row a level; 40 written), or its fp32 operations:
    a row costs ~60 in the transform and projection and ~85 a pixel (the
    bilinear taps, J from gx and gy, 21 + 6 products and chi2) an
    iteration.  The kernel is bound by neither: by the latency of its
    serial iterations."""
    return least_ms(batch * (n * (12 + n_levels * (1 + 16 * area)) + 40),
                    n * n_iter * (60 + 85 * area))


def probe_bound(img: torch.Tensor, uv: torch.Tensor, variant: str) -> tuple:
    """Least time of one probe call (`least_ms`): the distinct pixels its
    windows touch (clamped to the image) read once, uv read once, the
    patches written once; ~11 fp32 flops per output pixel."""
    from android_svo_tpu_torch.ops import gather_probe as gp
    h, w = img.shape
    oy, ox = gp.window_origin(uv, variant, h, w)
    r = torch.arange(gp.P + 1, device=uv.device)
    rows = (oy[:, None, None] + r[None, :, None]).clamp(0, h - 1)
    cols = (ox[:, None, None] + r[None, None, :]).clamp(0, w - 1)
    mask = torch.zeros(h * w, dtype=torch.bool, device=uv.device)
    mask[(rows * w + cols).reshape(-1)] = True
    n = uv.shape[0]
    return least_ms(int(mask.sum()) * 4 + n * 8 + n * gp.P * gp.P * 4,
                    n * gp.P * gp.P * 11)


def camera_bound(rows: int, form: str) -> tuple:
    """Least time of one radtan camera call on `rows` rows (`least_ms`):
    cam2world reads 8 bytes and writes 12 a row, ~228 fp32 operations (the
    intrinsics 4, eight Newton steps of 27, the norm and the division 8);
    world2cam reads 12 and writes 8, ~32 operations (project2d 2, distort
    26, the intrinsics 4); world2cam_uv reads 8, ~30.  36 bytes of
    camera."""
    read, flops = {"cam2world": (8, 228), "world2cam": (12, 32),
                   "world2cam_uv": (8, 30)}[form]
    write = 12 if form == "cam2world" else 8
    return least_ms(rows * (read + write) + 36, rows * flops)
