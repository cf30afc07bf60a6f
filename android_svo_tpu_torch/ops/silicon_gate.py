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
equal the B single launches bit for bit.  Used by `chip_smoke.py`.
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
    return {
        "stack": stack, "lvl": lvl, "uv": uv, "valid": valid,
        "valid_mixed": valid_mixed, "ref": ref,
        "rdx": rdx, "rdy": rdy, "off": off, "init": uv + off, "seg": seg,
        "uv_a": uv - seg, "uv_b": uv + seg, "nsteps": nsteps,
        "h": h, "w": w, "sub": sub, "sub_uv": sub_uv, "zeros_lvl": zeros_lvl,
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
    appearance gates off (the edgelet configuration's direct match)."""
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
    0.5 px.  `calls` (default `kernel_calls(x)`, and the 8x8 sampler with
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
    return GateReport(ok=not failures, failures=failures, detail=detail,
                      max_abs_err=errs)


# ---------------------------------------------------------------------------
# the batched forms
# ---------------------------------------------------------------------------

_FEATURE_KEYS = ("lvl", "uv", "valid", "valid_mixed", "ref", "rdx", "rdy",
                 "init", "uv_a", "uv_b", "nsteps", "sub_uv", "zeros_lvl")


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
    """`gate_calls` in their batched forms: name -> fn(use_pallas)
    returning (B, n, ...)."""
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
              for k in ("lvl", "uv", "valid_mixed")}
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
