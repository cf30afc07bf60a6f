"""The CUDA kernels (the patch kernels and the gather probe) against their
plain PyTorch versions on the card.

These need a CUDA device and the CUDA toolkit (the kernels are compiled with
nvcc on first use); without a card they skip.  On a machine with one:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -o addopts=""

(`--noconftest`: the suite's conftest imports JAX, which the machine with the
card need not have.)
"""

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def problem(card):
    from android_svo_tpu_torch.ops import silicon_gate
    return silicon_gate.gate_inputs(n=256, h=240, w=320, seed=1, device=card)


def test_kernel_gate(problem):
    from android_svo_tpu_torch.ops import silicon_gate
    rep = silicon_gate.run_gate(problem)
    torch.cuda.synchronize()
    assert rep.ok, rep.failures


@pytest.mark.parametrize("name", ["sample_patches_kernel", "epi_scan_kernel",
                                  "align_iclk_kernel",
                                  "align_iclk_window_kernel",
                                  "sample_patches_kernel/align1d",
                                  "align_iclk_window_kernel/ungated",
                                  "dump_windows_kernel",
                                  "sample_patches_kernel/ref_grad",
                                  "epi_scan_kernel/path"])
def test_wrapper_launches_and_counts(problem, name):
    from android_svo_tpu_torch.ops import patch_kernels as pk
    from android_svo_tpu_torch.ops import silicon_gate
    from android_svo_tpu_torch.tools import patch_ab
    call = {**silicon_gate.kernel_calls(problem),
            **patch_ab.extra_calls(problem)}[name]
    kernel = silicon_gate.kernel_of(name)
    pk.reset_launch_counts()
    call(False)                                  # plain version: no launch
    assert pk.LAUNCHES[kernel] == 0
    call(True)
    torch.cuda.synchronize()
    assert pk.LAUNCHES[kernel] == 1


def test_align1d_sampler_form_matches_plain(problem):
    """The 1D alignment's sampler form (8x8 at mixed levels on the 3-level
    stack, a valid mask) within the gate's 0.02 on live slots, and the
    whole align1d_stack loop (ten such launches) against its plain run."""
    from android_svo_tpu_torch.ops import matcher, silicon_gate
    from android_svo_tpu_torch.ops import patch_kernels as pk
    x = problem
    call = silicon_gate.kernel_calls(x)["sample_patches_kernel/align1d"]
    k, p = call(True), call(False)
    live = x["valid_mixed"]
    assert not bool(live.all()) and bool(live.any())
    assert float((k[live] - p[live]).abs().max()) <= 0.02
    ang = torch.linspace(0, 6.28, x["lvl"].shape[0], device=k.device)
    direction = torch.stack([torch.cos(ang), torch.sin(ang)], -1)
    args = (x["stack"], x["lvl"], x["ref"], x["rdx"], x["rdy"], direction,
            x["init"], x["valid"], 10, x["h"], x["w"])
    pk.reset_launch_counts()
    uk, ck, _ = matcher.align1d_stack(*args)
    assert pk.LAUNCHES["sample_patches_kernel"] == 10
    up, cp, _ = matcher.align1d_stack(*args, use_pallas=False)
    torch.cuda.synchronize()
    assert pk.LAUNCHES["sample_patches_kernel"] == 10
    assert float((ck == cp).float().mean()) >= 0.95
    both = ck & cp
    assert int(both.sum()) > 0
    assert float((uk[both] - up[both]).abs().max()) <= 0.05


def _same(a, b):
    """Equal values, with NaN where the other has NaN."""
    return (torch.equal(a.isnan(), b.isnan())
            and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0)))


@pytest.mark.parametrize("n", [0, 1, 7, 2049, 32768])
def test_probe_kernel_matches_plain(card, n):
    """probe_patches_kernel against probe_patches_plain, bit for bit, every
    variant, at sizes with partial blocks and warps (8 features per block)
    and at 16x the microbench's N: the kernel stages the plain version's
    clamped taps and rounds each operation as the plain version does."""
    from android_svo_tpu_torch.ops import gather_probe as gp
    from android_svo_tpu_torch.tools.microbench_gather import make_inputs
    img, uv = make_inputs(n=n, seed=2, device=card)
    for v in gp.VARIANTS:
        gp.reset_launch_counts()
        out = gp.probe_patches(img, uv, v)
        torch.cuda.synchronize()
        assert gp.LAUNCHES["probe_patches_kernel"] == (1 if n else 0)
        assert out.shape == (n, gp.P, gp.P)
        assert torch.equal(out, gp.probe_patches_plain(img, uv, v)), v


@pytest.mark.parametrize("variant", ["A", "B", "C", "D"])
def test_probe_kernel_clamps_off_image(card, variant):
    """Off the scripts' ranges (off-image and border uv, NaN, +-inf and
    +-1e6) the kernel clamps its reads like the plain version: no fault,
    the same bits, NaN where the plain version has NaN."""
    from android_svo_tpu_torch.ops import gather_probe as gp
    g = torch.Generator(device=card).manual_seed(4)
    img = torch.rand((480, 640), generator=g, device=card)
    r = torch.rand((4096, 2), generator=g, device=card)
    uv = r * torch.tensor([800.0, 640.0], device=card) - 80.0
    specials = torch.tensor([float("nan"), float("inf"), -float("inf"),
                             1e6, -1e6, 0.0, 639.5, 479.99], device=card)
    pick = torch.randint(0, 8, (4096, 2), generator=g, device=card)
    mask = torch.rand((4096, 2), generator=g, device=card) < 0.3
    uv = torch.where(mask, specials[pick], uv).contiguous()
    out = gp.probe_patches(img, uv, variant)
    torch.cuda.synchronize()
    assert _same(out, gp.probe_patches_plain(img, uv, variant))


@pytest.mark.parametrize("bad", ["uv_float64", "uv_strided", "uv_n3",
                                 "uv_on_cpu", "img_strided"])
def test_probe_checks_before_launch(card, bad):
    """Every input the kernel does not take raises before any launch; the
    wrapper converts nothing."""
    from android_svo_tpu_torch.ops import gather_probe as gp
    from android_svo_tpu_torch.tools.microbench_gather import make_inputs
    img, uv = make_inputs(n=64, seed=5, device=card)
    if bad == "uv_float64":
        uv = uv.double()
    elif bad == "uv_strided":
        uv = uv.t().contiguous().t()
    elif bad == "uv_n3":
        uv = torch.cat([uv, uv[:, :1]], 1)
    elif bad == "uv_on_cpu":
        uv = uv.cpu()
    else:
        img = img.t().contiguous().t()
    gp.reset_launch_counts()
    with pytest.raises(TypeError if bad == "uv_float64" else ValueError):
        gp.probe_patches(img, uv, "A")
    torch.cuda.synchronize()
    assert gp.LAUNCHES["probe_patches_kernel"] == 0


@pytest.mark.parametrize("variant", ["A", "D"])
def test_probe_dispatch_counts(card, variant):
    """One call of the probe wrapper: at most 1 ATen op (the output
    allocation) and exactly 1 device activity, one launch counted."""
    from android_svo_tpu_torch.ops import gather_probe as gp
    from android_svo_tpu_torch.tools.microbench_gather import make_inputs
    from android_svo_tpu_torch.utils.profiling import dispatch_counts
    img, uv = make_inputs(seed=6, device=card)
    gp.probe_patches(img, uv, variant)              # build and warm up
    gp.reset_launch_counts()
    n_ops, n_dev = dispatch_counts(lambda: gp.probe_patches(img, uv,
                                                            variant))
    assert n_ops <= 1 and n_dev == 1, (n_ops, n_dev)
    assert gp.LAUNCHES["probe_patches_kernel"] == 1


def _nan0(t):
    return torch.nan_to_num(t, nan=0.0, posinf=0.0, neginf=0.0)


def _poison(t):
    """A copy of (n, 2) coordinates with NaN, +inf and -inf planted."""
    t = t.clone()
    t[0::5, 0] = float("nan")
    t[1::5, 1] = float("inf")
    t[2::5, 0] = float("-inf")
    return t


def test_nonfinite_uv_read_as_zero(problem):
    """NaN and +-inf in uv / init_uv give the plain version's answer on
    nan_to_num'd inputs: the kernels zero them themselves."""
    from android_svo_tpu_torch.ops import patch_kernels as pk
    x = problem
    uv = _poison(x["uv"])
    k = pk.sample_patches(x["stack"], x["lvl"], uv, 4, grad=True)
    p = pk.sample_patches(x["stack"], x["lvl"], _nan0(uv), 4, grad=True,
                          use_pallas=False)
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        # the same taps; dx and dy only differ by the rounding of uv+off+-1
        assert float((a - b).abs().max()) <= 1e-3
    init = _poison(x["init"])
    bad = ~torch.isfinite(init).all(dim=-1)
    args = (x["stack"], x["lvl"], x["ref"], x["rdx"], x["rdy"])
    uk, ck, _ = pk.align_iclk_mxu(*args, init, x["valid"], 10, h=x["h"],
                                  w=x["w"])
    up, cp, _ = pk.align_iclk_mxu(*args, _nan0(init), x["valid"], 10,
                                  h=x["h"], w=x["w"], use_pallas=False)
    torch.cuda.synchronize()
    # a zeroed coordinate leaves the level: both stay put, unconverged
    assert torch.equal(uk[bad], up[bad]) and torch.equal(uk[bad],
                                                         _nan0(init)[bad])
    assert not ck[bad].any() and not cp[bad].any()
    assert float((ck == cp).float().mean()) >= 0.95


def _split_near_median(vals):
    """A threshold in the widest gap between neighbouring values of the
    middle fifth, so about half of them fall on each side and none lies
    within rounding of it."""
    v = torch.sort(vals[torch.isfinite(vals)]).values
    k = v.shape[0]
    lo, hi = int(0.4 * k), int(0.6 * k)
    j = lo + int(torch.argmax(v[lo + 1:hi + 1] - v[lo:hi]))
    return float(0.5 * (v[j] + v[j + 1]))


def _gate_levels(x):
    """ZMSSD factor and std floor near the plain version's medians, so each
    gate rejects about half of the features."""
    from android_svo_tpu_torch.ops import patch_kernels as pk
    hinv = pk._iclk_hinv(x["rdx"], x["rdy"])
    _, _, _, score, std = pk._align_mxu_plain(
        x["stack"], x["lvl"], x["ref"], x["rdx"], x["rdy"], hinv, x["init"],
        x["valid"], 10, 4, x["h"], x["w"])
    return _split_near_median(score) / 64, _split_near_median(std)


@pytest.mark.parametrize("gates", ["none", "zmssd", "std", "both"])
def test_window_gates_match_plain(problem, gates):
    """align_iclk_mxu with each appearance gate off, on, and both on:
    `converged` agrees with the plain version on >= 0.95 of features and
    equals it wherever the two iterates agree to 1e-4."""
    from android_svo_tpu_torch.ops import patch_kernels as pk
    x = problem
    zf, sf = _gate_levels(x)
    kw = {"zmssd_factor": zf if gates in ("zmssd", "both") else None,
          "min_patch_std": sf if gates in ("std", "both") else None}
    args = (x["stack"], x["lvl"], x["ref"], x["rdx"], x["rdy"], x["init"],
            x["valid"], 10)
    uk, ck, _ = pk.align_iclk_mxu(*args, h=x["h"], w=x["w"], **kw)
    up, cp, _ = pk.align_iclk_mxu(*args, h=x["h"], w=x["w"],
                                  use_pallas=False, **kw)
    torch.cuda.synchronize()
    assert float((ck == cp).float().mean()) >= 0.95
    same = (uk - up).abs().max(dim=-1).values <= 1e-4
    assert int(same.sum()) >= 0.5 * x["lvl"].shape[0]
    assert torch.equal(ck[same], cp[same])
    if gates != "none":                    # the gate bites
        _, c_off, _ = pk.align_iclk_mxu(*args, h=x["h"], w=x["w"])
        assert int(ck.sum()) < int(c_off.sum())


def test_wrappers_refuse_other_types(problem):
    """An int64 level tensor or a float64 uv raises and is not converted:
    nothing is launched."""
    from android_svo_tpu_torch.ops import patch_kernels as pk
    x = problem
    pk.reset_launch_counts()
    with pytest.raises(TypeError, match="lvl"):
        pk.sample_patches(x["stack"], x["lvl"].long(), x["uv"], 4)
    with pytest.raises(TypeError, match="uv"):
        pk.sample_patches(x["stack"], x["lvl"], x["uv"].double(), 4)
    args = (x["stack"], x["lvl"], x["ref"], x["rdx"], x["rdy"])
    for align in (pk.align_iclk_mxu, pk.align_iclk):
        with pytest.raises(TypeError, match="lvl"):
            align(x["stack"], x["lvl"].long(), *args[2:], x["init"],
                  x["valid"], 10)
        with pytest.raises(TypeError, match="init_uv"):
            align(*args, x["init"].double(), x["valid"], 10)
    scan = (x["stack"], x["lvl"], x["uv_a"], x["uv_b"], x["ref"], 100)
    with pytest.raises(TypeError, match="lvl"):
        pk.epi_scan(x["stack"], x["lvl"].long(), *scan[2:],
                    n_steps_each=x["nsteps"])
    with pytest.raises(TypeError, match="n_steps_each"):
        pk.epi_scan(*scan, n_steps_each=x["nsteps"].long())
    with pytest.raises(TypeError, match="uv_a"):
        pk.epi_scan(x["stack"], x["lvl"], x["uv_a"].double(), *scan[3:])
    assert all(v == 0 for v in pk.LAUNCHES.values())


@pytest.mark.parametrize("case", ["sample_4x4", "sample_8x8_grad",
                                  "sample_8x8_align1d", "window_gated",
                                  "window_ungated", "align", "scan",
                                  "scan_no_steps", "dump"])
def test_wrapper_dispatch_counts(problem, case):
    """Under torch.profiler one call of the sampler dispatches at most 4
    ATen ops and one of align_iclk_mxu, align_iclk, epi_scan or
    dump_windows at most 3, each exactly 1 device kernel."""
    from android_svo_tpu_torch.ops import patch_kernels as pk
    from android_svo_tpu_torch.ops import silicon_gate
    from android_svo_tpu_torch.utils.profiling import dispatch_counts
    x = problem
    calls = silicon_gate.kernel_calls(x)
    fn, limit = {
        "sample_4x4": (lambda: calls["sample_patches_kernel"](True), 4),
        "sample_8x8_grad": (lambda: pk.sample_patches(
            x["stack"], x["lvl"], x["uv"], 4, grad=True), 4),
        "sample_8x8_align1d": (
            lambda: calls["sample_patches_kernel/align1d"](True), 4),
        "window_gated": (lambda: calls["align_iclk_window_kernel"](True), 3),
        "window_ungated": (
            lambda: calls["align_iclk_window_kernel/ungated"](True), 3),
        "align": (lambda: calls["align_iclk_kernel"](True), 3),
        "scan": (lambda: calls["epi_scan_kernel"](True), 3),
        "scan_no_steps": (lambda: pk.epi_scan(
            x["stack"], x["lvl"], x["uv_a"], x["uv_b"], x["ref"], 100,
            h=x["h"], w=x["w"]), 3),
        "dump": (lambda: calls["dump_windows_kernel"](True), 3),
    }[case]
    fn()                                   # build and warm up
    n_ops, n_dev = dispatch_counts(fn)
    assert n_ops <= limit and n_dev == 1, (n_ops, n_dev)


def test_window_kernel_reads_strided_templates(problem):
    """patch_gradients' interior view is read through its strides, uv too:
    the same answer as contiguous copies."""
    from android_svo_tpu_torch.ops import patch_kernels as pk
    x = problem
    n = x["lvl"].shape[0]
    pb = torch.zeros((n, 10, 10), device=x["ref"].device)
    pb[:, 1:-1, 1:-1] = x["ref"]
    T = pb[:, 1:-1, 1:-1]
    assert not T.is_contiguous()
    init = torch.stack([x["init"][:, 0], torch.zeros_like(x["init"][:, 0]),
                        x["init"][:, 1]], dim=-1)[:, ::2]
    assert init.stride() == (3, 2)
    a = pk.align_iclk_mxu(x["stack"], x["lvl"], T, x["rdx"], x["rdy"], init,
                          x["valid"], 10)
    b = pk.align_iclk_mxu(x["stack"], x["lvl"], x["ref"], x["rdx"],
                          x["rdy"], x["init"], x["valid"], 10)
    torch.cuda.synchronize()
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def _strided_copy(t):
    """t's values in the interior view of a larger zero tensor, as
    patch_gradients returns them: rows contiguous, the whole not."""
    n, p, _ = t.shape
    pb = torch.zeros((n, p + 2, p + 2), device=t.device)
    pb[:, 1:-1, 1:-1] = t
    view = pb[:, 1:-1, 1:-1]
    assert not view.is_contiguous()
    return view


def _strided_uv(uv):
    view = torch.stack([uv[:, 0], torch.zeros_like(uv[:, 0]), uv[:, 1]],
                       dim=-1)[:, ::2]
    assert view.stride() == (3, 2)
    return view


def test_align_and_scan_read_strided_inputs(problem):
    """align_iclk's T / gx / gy and init_uv and epi_scan's reference and
    segment ends are read through their strides: the same answer as
    contiguous copies."""
    from android_svo_tpu_torch.ops import patch_kernels as pk
    x = problem
    a = pk.align_iclk(x["stack"], x["lvl"], _strided_copy(x["ref"]),
                      _strided_copy(x["rdx"]), _strided_copy(x["rdy"]),
                      _strided_uv(x["init"]), x["valid"], 10)
    b = pk.align_iclk(x["stack"], x["lvl"], x["ref"], x["rdx"], x["rdy"],
                      x["init"], x["valid"], 10)
    c = pk.epi_scan(x["stack"], x["lvl"], _strided_uv(x["uv_a"]),
                    _strided_uv(x["uv_b"]), _strided_copy(x["ref"]), 100,
                    n_steps_each=x["nsteps"], h=x["h"], w=x["w"])
    d = pk.epi_scan(x["stack"], x["lvl"], x["uv_a"], x["uv_b"], x["ref"],
                    100, n_steps_each=x["nsteps"], h=x["h"], w=x["w"])
    torch.cuda.synchronize()
    for u, v in zip((*a, *c), (*b, *d)):
        assert torch.equal(u, v)


def test_align_nonfinite_start_never_converges(problem):
    """align_iclk_kernel iterates from init_uv with NaN and +-inf read as
    0 (the same iterates as from the zeroed start) but measures the drift
    from init_uv as given: a non-finite start never converges, as in the
    plain version."""
    from android_svo_tpu_torch.ops import patch_kernels as pk
    x = problem
    init = _poison(x["init"])
    bad = ~torch.isfinite(init).all(dim=-1)
    args = (x["stack"], x["lvl"], x["ref"], x["rdx"], x["rdy"])
    uk, ck, mk = pk.align_iclk(*args, init, x["valid"], 10)
    uz, cz, mz = pk.align_iclk(*args, _nan0(init), x["valid"], 10)
    up, cp, _ = pk.align_iclk(*args, init, x["valid"], 10, use_pallas=False)
    torch.cuda.synchronize()
    assert torch.equal(uk, uz) and torch.equal(mk, mz)
    assert torch.equal(uk[bad], _nan0(init)[bad])
    assert not ck[bad].any() and not cp[bad].any()
    assert torch.equal(ck[~bad], cz[~bad])
    assert float((ck == cp).float().mean()) >= 0.95


def test_scan_first_minimum_and_empty_seeds(card):
    """The CPU test's flat-stack problem on the card: every in-bounds step
    scores exactly 0, so the tied steps lie on several of the seed's warps
    and the first one must win the reduction across them (j = 4 of 21;
    j = 13 of 30; j = 5 of 41 on level 1), and seeds with no in-bounds
    position or 0 steps give (0, +inf), as the plain version."""
    from android_svo_tpu_torch.ops import patch_kernels as pk
    h, w = 240, 320
    flat = torch.zeros((3, h, w), device=card)
    ua = torch.tensor([[2.25, 60.0], [1.0, 60.0], [100.0, 60.0],
                       [50.0, 1.5], [-6.5, 60.0]], device=card)
    ub = torch.tensor([[22.25, 60.0], [4.0, 60.0], [120.0, 60.0],
                       [50.0, 41.5], [22.5, 60.0]], device=card)
    ns = torch.tensor([21, 10, 0, 41, 30], dtype=torch.int32, device=card)
    lvl = torch.tensor([0, 0, 0, 1, 0], dtype=torch.int32, device=card)
    ref = torch.zeros((5, 8, 8), device=card)
    want = pk.epi_scan(flat, lvl, ua, ub, ref, 41, n_steps_each=ns, h=h, w=w,
                       use_pallas=False)
    want_t = torch.tensor([4 / 20, 0.0, 0.0, 5 / 40, 13 / 29])
    assert torch.equal(want[0].cpu(), want_t)
    pk.reset_launch_counts()
    got = pk.epi_scan(flat, lvl, ua, ub, ref, 41, n_steps_each=ns, h=h, w=w)
    torch.cuda.synchronize()
    assert pk.LAUNCHES["epi_scan_kernel"] == 1
    for a, b in zip(got, want):
        assert torch.equal(a, b), (a, b)


def test_scan_nonfinite_ends_read_as_zero(problem):
    """NaN and +-inf in uv_a / uv_b give the kernel's answer on the zeroed
    ends."""
    from android_svo_tpu_torch.ops import patch_kernels as pk
    x = problem
    kw = dict(n_steps_each=x["nsteps"], h=x["h"], w=x["w"])
    ua, ub = _poison(x["uv_a"]), _poison(x["uv_b"].flip(0)).flip(0)
    a = pk.epi_scan(x["stack"], x["lvl"], ua, ub, x["ref"], 100, **kw)
    b = pk.epi_scan(x["stack"], x["lvl"], _nan0(ua), _nan0(ub), x["ref"],
                    100, **kw)
    torch.cuda.synchronize()
    for u, v in zip(a, b):
        assert torch.equal(u, v)


# ---- dump_windows_kernel ----------------------------------------------------

def _dump_agrees(stack, lvl, uv, valid):
    """dump_windows on the card against its plain version: one launch,
    origins equal, valid rows bit for bit, dead rows zero."""
    from android_svo_tpu_torch.ops import patch_kernels as pk
    pk.reset_launch_counts()
    wk, ok = pk.dump_windows(stack, lvl, uv, valid)
    wp, op = pk.dump_windows(stack, lvl, uv, valid, use_pallas=False)
    torch.cuda.synchronize()
    assert pk.LAUNCHES["dump_windows_kernel"] == 1
    assert wk.shape == (lvl.shape[0], pk.DUMP_WR, pk.DUMP_WC)
    assert ok.dtype == torch.int32 and torch.equal(ok, op)
    assert torch.equal(wk[valid], wp[valid])
    assert not wk[~valid].any()
    return wk, ok


def test_dump_windows_matches_plain(problem):
    """The gate's problem: the mixed valid mask and partly non-finite
    centres at three levels."""
    x = problem
    valid = x["valid_mixed"]
    assert bool(valid.any()) and not bool(valid.all())
    assert not bool(torch.isfinite(x["dump_uv"]).all())
    _dump_agrees(x["stack"], x["lvl"], x["dump_uv"], valid)


def test_dump_windows_reads_strided_stacks(problem):
    """A stack read through its plane and row strides (sparse alignment's
    level-2 substack; a corner of every plane) gives the windows of a
    contiguous copy, bit for bit."""
    from android_svo_tpu_torch.ops import patch_kernels as pk
    x = problem
    n = x["lvl"].shape[0]
    for stack, lvl, uv in (
            (x["sub"], x["zeros_lvl"], x["sub_uv"]),
            (x["stack"][:, :200, :300], x["lvl"], x["uv"])):
        assert not stack.is_contiguous()
        valid = torch.ones((n,), dtype=torch.bool, device=stack.device)
        wk, ok = _dump_agrees(stack, lvl, uv, valid)
        wc, oc = pk.dump_windows(stack.contiguous(), lvl, uv, valid)
        torch.cuda.synchronize()
        assert torch.equal(wk, wc) and torch.equal(ok, oc)


def test_dump_windows_clamps(card):
    """Centres off the plane, on its edges and at +-1e6, levels below 0
    and past the last: origins clamp to [0, Wp - 65] x [0, Hp - 33] and
    levels to [0, L - 1], as in the plain version."""
    g = torch.Generator(device=card).manual_seed(9)
    stack = torch.rand((3, 100, 200), generator=g, device=card)
    n = 512
    uv = torch.rand((n, 2), generator=g, device=card) * 400.0 - 100.0
    specials = torch.tensor([1e6, -1e6, 0.0, 199.5, 99.99, 31.999999,
                             16.0, 64.5], device=card)
    pick = torch.randint(0, 8, (n, 2), generator=g, device=card)
    mask = torch.rand((n, 2), generator=g, device=card) < 0.3
    uv = torch.where(mask, specials[pick], uv).contiguous()
    lvl = torch.randint(-2, 5, (n,), generator=g, device=card).to(torch.int32)
    valid = torch.rand((n,), generator=g, device=card) < 0.9
    _, org = _dump_agrees(stack, lvl, uv, valid)
    assert int(org[:, 0].min()) == 0 and int(org[:, 0].max()) == 200 - 65
    assert int(org[:, 1].min()) == 0 and int(org[:, 1].max()) == 100 - 33


def test_dump_windows_nonfinite_uv_read_as_zero(problem):
    """NaN and +-inf in uv give the windows and origins of the zeroed
    centres (the plain version's nan_to_num)."""
    from android_svo_tpu_torch.ops import patch_kernels as pk
    x = problem
    uv = _poison(x["uv"])
    valid = x["valid"]
    a = _dump_agrees(x["stack"], x["lvl"], uv, valid)
    b = pk.dump_windows(x["stack"], x["lvl"], _nan0(uv), valid)
    torch.cuda.synchronize()
    for u, v in zip(a, b):
        assert torch.equal(u, v)


@pytest.mark.parametrize("bad", ["lvl_int64", "uv_float64", "valid_uint8",
                                 "uv_on_cpu", "valid_on_cpu", "lvl_strided",
                                 "uv_shape", "stack_batched",
                                 "stack_too_small", "stack_float64"])
def test_dump_windows_checks_before_launch(problem, bad):
    """Every input the kernel does not take raises before any allocation
    or launch; the wrapper converts nothing and never takes the plain
    version for a CUDA stack."""
    from android_svo_tpu_torch.ops import patch_kernels as pk
    x = problem
    stack, lvl, uv, valid = x["stack"], x["lvl"], x["uv"], x["valid"]
    if bad == "lvl_int64":
        lvl = lvl.long()
    elif bad == "uv_float64":
        uv = uv.double()
    elif bad == "valid_uint8":
        valid = valid.to(torch.uint8)
    elif bad == "uv_on_cpu":
        uv = uv.cpu()
    elif bad == "valid_on_cpu":
        valid = valid.cpu()
    elif bad == "lvl_strided":
        lvl = torch.stack([lvl, lvl], -1)[:, 0]
    elif bad == "uv_shape":
        uv = uv[:-1]
    elif bad == "stack_batched":
        stack = stack[None]
    elif bad == "stack_too_small":
        stack = stack[:, :31, :]
    else:
        stack = stack.double()
    pk.reset_launch_counts()
    err = TypeError if bad in ("lvl_int64", "uv_float64", "valid_uint8") \
        else ValueError
    with pytest.raises(err):
        pk.dump_windows(stack, lvl, uv, valid)
    torch.cuda.synchronize()
    assert all(v == 0 for v in pk.LAUNCHES.values())


# ---- the dataset path: feeder ring, YUV, loader and handler devices -------

def _write_frames(root, n, h, w, seed):
    import numpy as np
    from android_svo_tpu_torch.data import euroc
    rng = np.random.default_rng(seed)
    imgs = [rng.integers(0, 256, (h, w), np.uint8) for _ in range(n)]
    stamps = [1403636579763555584 + i * 50_000_000 for i in range(n)]
    paths = euroc.write_euroc(str(root), imgs, stamps,
                              dict(euroc.MH01_CAM0, resolution=(w, h)))
    return imgs, paths


def test_feeder_ring_reuses_slots_safely(card, tmp_path):
    """Two pinned slots for 8 frames, with the stream held busy after each
    frame (its copy queued behind the delay): a slot rewritten before its
    copy ran would show in a frame kept to the end."""
    from android_svo_tpu_torch.data import native_feeder
    imgs, paths = _write_frames(tmp_path, 8, 480, 752, seed=5)
    feeder = native_feeder.NativeFrameFeeder(paths, capacity=2, n_threads=4,
                                             device=card)
    kept = []
    for idx, frame in feeder:
        assert frame.device.type == "cuda" and frame.dtype == torch.float32
        kept.append((idx, frame))
        torch.cuda._sleep(20_000_000)
    feeder.close()
    assert [i for i, _ in kept] == list(range(8))
    torch.cuda.synchronize()
    for (i, frame), img in zip(kept, imgs):
        assert torch.equal(frame.cpu(), torch.from_numpy(img).float()), i


def test_yuv420_to_rgb_on_card_matches_cpu(card):
    """The conversion on the card against its CPU result on seeded planes
    at the app's 640x480: max |d| <= 1e-4."""
    import numpy as np
    from android_svo_tpu_torch.data import yuv
    rng = np.random.default_rng(7)
    y = torch.from_numpy(rng.integers(0, 256, (480, 640), np.uint8))
    u = torch.from_numpy(rng.integers(0, 256, (240, 320), np.uint8))
    v = torch.from_numpy(rng.integers(0, 256, (240, 320), np.uint8))
    want = yuv.yuv420_to_rgb(y, u, v)
    got = yuv.yuv420_to_rgb(y.to(card), u.to(card), v.to(card))
    assert got.device.type == "cuda"
    assert float((got.cpu() - want).abs().max()) <= 1e-4
    assert torch.equal(yuv.yuv420_to_gray(y.to(card)).cpu(), y.float())


def test_load_euroc_builds_the_camera_on_the_card(card, tmp_path):
    from android_svo_tpu_torch.core import frame_handler as fh
    from android_svo_tpu_torch.data import euroc
    _write_frames(tmp_path, 2, 48, 64, seed=6)
    seq = euroc.load_euroc(str(tmp_path))
    for name in ("fx", "fy", "cx", "cy", "dist"):
        assert getattr(seq.camera, name).device.type == "cuda", name
    assert not seq.camera.distortion_free
    assert fh.FrameHandler(seq.camera).device.type == "cuda"


def test_handler_takes_device_and_pinned_frames(card):
    """A frame already on the card is tracked as it is (no copy); a pinned
    host frame is copied to the card."""
    from android_svo_tpu_torch.config import SVOConfig
    from android_svo_tpu_torch.core import frame_handler as fh
    from android_svo_tpu_torch.data import synthetic
    handler = fh.FrameHandler(synthetic.default_camera(64, 48),
                              SVOConfig(loba_n_iter=0))
    frame = torch.rand((48, 64), device=card) * 255
    assert handler._frame(frame).data_ptr() == frame.data_ptr()
    pinned = frame.cpu().pin_memory()
    got = handler._frame(pinned)
    assert got.device.type == "cuda" and torch.equal(got, frame)


# ---------------------------------------------------------------------------
# the batched forms: one launch for B frames, each frame as its own launch
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def batched_problem(card):
    from android_svo_tpu_torch.ops import silicon_gate
    return silicon_gate.batched_gate_inputs(3, n=256, h=240, w=320, seed=2,
                                            device=card)


BATCHED_FORMS = ["sample_patches_kernel", "sample_patches_kernel/grad",
                 "sample_patches_kernel/align1d", "epi_scan_kernel",
                 "align_iclk_kernel", "align_iclk_window_kernel",
                 "align_iclk_window_kernel/ungated", "dump_windows_kernel",
                 "sample_patches_kernel/ref_grad", "epi_scan_kernel/path"]


@pytest.mark.parametrize("name", BATCHED_FORMS)
def test_batched_kernel_matches_single_launches(batched_problem, name):
    """A batched call is one launch, and each frame's rows equal that
    frame's own single launch bit for bit."""
    from android_svo_tpu_torch.ops import patch_kernels as pk
    from android_svo_tpu_torch.ops import silicon_gate
    from android_svo_tpu_torch.tools import patch_ab
    frames, xb = batched_problem
    kernel = silicon_gate.kernel_of(name)
    call = {**silicon_gate.batched_kernel_calls(xb),
            **patch_ab.extra_calls(xb, batched=True)}[name]
    pk.reset_launch_counts()
    out = call(True)
    torch.cuda.synchronize()
    assert pk.LAUNCHES[kernel] == 1
    out = out if isinstance(out, tuple) else (out,)
    for b, x in enumerate(frames):
        single = {**silicon_gate.gate_calls(x),
                  **patch_ab.extra_calls(x)}[name](True)
        single = single if isinstance(single, tuple) else (single,)
        for o, s in zip(out, single):
            assert silicon_gate.same_bits(o[b], s), (name, b)


def test_batched_gate(batched_problem):
    from android_svo_tpu_torch.ops import silicon_gate
    rep = silicon_gate.run_batched_gate(*batched_problem)
    torch.cuda.synchronize()
    assert rep.ok, rep.failures


VMAP_WRAPPERS = {
    "sample_patches_kernel": (
        lambda xb: (xb["stack"], xb["lvl"], xb["uv"]),
        lambda pk: lambda s, l, u: pk.sample_patches(s, l, u, 4),
        lambda pk: lambda *a: pk.sample_patches_batched(*a, 4)),
    "dump_windows_kernel": (
        lambda xb: (xb["stack"], xb["lvl"], xb["dump_uv"],
                    xb["valid_mixed"]),
        lambda pk: pk.dump_windows,
        lambda pk: pk.dump_windows_batched),
}


@pytest.mark.parametrize("kernel", list(VMAP_WRAPPERS))
def test_vmap_of_a_wrapper_launches_once(batched_problem, kernel):
    """torch.func.vmap over the per-frame wrapper takes the batched form:
    one launch for the batch, equal to the batched form bit for bit."""
    from android_svo_tpu_torch.ops import patch_kernels as pk
    from android_svo_tpu_torch.ops import silicon_gate
    _, xb = batched_problem
    args, single, batched = VMAP_WRAPPERS[kernel]
    pk.reset_launch_counts()
    out = torch.func.vmap(single(pk))(*args(xb))
    torch.cuda.synchronize()
    assert pk.LAUNCHES[kernel] == 1
    out = out if isinstance(out, tuple) else (out,)
    ref = batched(pk)(*args(xb))
    ref = ref if isinstance(ref, tuple) else (ref,)
    for o, r in zip(out, ref):
        assert silicon_gate.same_bits(o, r)


def test_batched_dump_reads_a_shared_stack(batched_problem):
    """One (L, Hp, Wp) stack for every frame (batch stride 0, as vmap's
    in_dims None gives it): one launch, each frame's rows equal to its own
    single launch on that stack bit for bit, dead rows zero."""
    from android_svo_tpu_torch.ops import patch_kernels as pk
    from android_svo_tpu_torch.ops import silicon_gate
    frames, xb = batched_problem
    stack = frames[1]["stack"]
    feats = (xb["lvl"], xb["dump_uv"], xb["valid_mixed"])
    pk.reset_launch_counts()
    wins, org = pk.dump_windows_batched(stack, *feats)
    wv, ov = torch.func.vmap(pk.dump_windows, in_dims=(None, 0, 0, 0))(
        stack, *feats)
    torch.cuda.synchronize()
    assert pk.LAUNCHES["dump_windows_kernel"] == 2
    same = silicon_gate.same_bits
    assert same(wv, wins) and same(ov, org)
    for b in range(len(frames)):
        w1, o1 = pk.dump_windows(stack, *(f[b] for f in feats))
        assert same(wins[b], w1) and same(org[b], o1), b
    assert not wins[~xb["valid_mixed"]].any()


@pytest.mark.parametrize("bad", ["lvl_int64", "uv_float64", "valid_uint8",
                                 "uv_on_cpu", "valid_on_cpu", "lvl_strided",
                                 "rows_not_per_frame", "stack_5d",
                                 "stack_cols_strided", "stack_float64"])
def test_batched_dump_checks_before_launch(batched_problem, bad):
    """The batched form raises before any allocation or launch on an input
    the kernel does not take; it converts nothing and never takes the plain
    version for a CUDA stack."""
    from android_svo_tpu_torch.ops import patch_kernels as pk
    _, xb = batched_problem
    stack, lvl, uv, valid = (xb["stack"], xb["lvl"], xb["dump_uv"],
                             xb["valid_mixed"])
    if bad == "lvl_int64":
        lvl = lvl.long()
    elif bad == "uv_float64":
        uv = uv.double()
    elif bad == "valid_uint8":
        valid = valid.to(torch.uint8)
    elif bad == "uv_on_cpu":
        uv = uv.cpu()
    elif bad == "valid_on_cpu":
        valid = valid.cpu()
    elif bad == "lvl_strided":
        lvl = torch.stack([lvl, lvl], -1)[..., 0]
    elif bad == "rows_not_per_frame":
        stack = stack[:-1]
    elif bad == "stack_5d":
        stack = stack[None]
    elif bad == "stack_cols_strided":
        stack = stack.transpose(-1, -2)
    else:
        stack = stack.double()
    pk.reset_launch_counts()
    err = TypeError if bad in ("lvl_int64", "uv_float64", "valid_uint8") \
        else ValueError
    with pytest.raises(err):
        pk.dump_windows_batched(stack, lvl, uv, valid)
    torch.cuda.synchronize()
    assert all(v == 0 for v in pk.LAUNCHES.values())


# ---------------------------------------------------------------------------
# the sampler and the scan as redesigned for the batched step: staged
# footprints and tiles, the launch geometry chosen from the row count
# ---------------------------------------------------------------------------

def _border_uv(n, h, w, seed, device):
    """(n, 2) uv: a quarter inside the plane, the rest wholly or partly off
    each of its four borders, with NaN, +-inf and +-1e6 planted."""
    g = torch.Generator().manual_seed(seed)
    u = torch.rand((n, 2), generator=g)
    side = torch.randint(0, 5, (n,), generator=g)
    x = u[:, 0] * w
    y = u[:, 1] * h
    off = torch.rand((n,), generator=g) * 14.0 - 4.0   # -4 .. 10 px out
    x = torch.where(side == 1, -off, x)
    x = torch.where(side == 2, w - 1 + off, x)
    y = torch.where(side == 3, -off, y)
    y = torch.where(side == 4, h - 1 + off, y)
    uv = torch.stack([x, y], -1)
    uv[3::11, 0] = float("nan")
    uv[4::13, 1] = float("inf")
    uv[5::17] = float("-inf")
    uv[6::19, 0] = 1e6
    uv[7::23, 1] = -1e6
    return uv.to(device)


@pytest.mark.parametrize("half", [1, 2, 3, 4])
@pytest.mark.parametrize("grad", [False, True])
def test_sampler_off_borders_matches_plain(problem, half, grad):
    """Features wholly and partly off every border of the gate's planes,
    and non-finite or huge uv: the kernel blends the taps the plain version
    clamps to (within 1e-3: the two round the blend apart; the gradient
    form also samples at uv + off + -1 rounded once), zeros for dead slots,
    at the template half sizes (1, 2, 4) and the run-time one (3)."""
    from android_svo_tpu_torch.ops import patch_kernels as pk
    x = problem
    stack = x["stack"]
    n = 613
    h, w = stack.shape[1:]
    uv = _border_uv(n, h, w, half, stack.device)
    lvl = (torch.arange(n, device=stack.device) % 7 - 3).to(torch.int32)
    valid = torch.arange(n, device=stack.device) % 9 != 4
    k = pk.sample_patches(stack, lvl, uv, half, grad=grad, valid=valid)
    p = pk.sample_patches(stack, lvl, _nan0(uv), half, grad=grad,
                          use_pallas=False)
    torch.cuda.synchronize()
    k = k if grad else (k,)
    p = p if grad else (p,)
    for a, b in zip(k, p):
        assert a.shape == (n, 2 * half, 2 * half)
        assert float((a[valid] - b[valid]).abs().max()) <= 1e-3
        assert not a[~valid].any()


@pytest.mark.parametrize("half", [1, 2, 3, 4])
def test_sampler_staged_taps_equal_the_stack_reads(problem, half):
    """The gradient form's patch plane is sampled with bilin from the stack
    at the very coordinates the plain form blends from its staged
    footprint: the two are equal bit for bit, off the borders and at
    non-finite uv too."""
    from android_svo_tpu_torch.ops import patch_kernels as pk
    x = problem
    stack = x["stack"]
    h, w = stack.shape[1:]
    uv = _border_uv(1001, h, w, 10 + half, stack.device)
    lvl = (torch.arange(1001, device=stack.device) % 3).to(torch.int32)
    patch = pk.sample_patches(stack, lvl, uv, half)
    patch_g, _, _ = pk.sample_patches(stack, lvl, uv, half, grad=True)
    torch.cuda.synchronize()
    assert torch.equal(patch, patch_g)


@pytest.mark.parametrize("n", [1, 7, 8449])
def test_sampler_rows_around_the_block_size(problem, n):
    """Row counts of one, of a part of a block and just past the batched
    step's 8,448 (528 blocks of 16 4x4 features): the 4x4 and 8x8 forms
    against the plain version, and a batch of two frames, one a stride-0
    shared stack, each frame bit for bit its single launch."""
    from android_svo_tpu_torch.ops import patch_kernels as pk
    x = problem
    stack = x["stack"]
    h, w = stack.shape[1:]
    g = torch.Generator().manual_seed(n)
    uv = (torch.rand((n, 2), generator=g) * torch.tensor([w - 1.0, h - 1.0])
          ).to(stack.device)
    lvl = torch.randint(0, 3, (n,), generator=g).to(stack.device,
                                                    torch.int32)
    valid = (torch.rand((n,), generator=g) < 0.9).to(stack.device)
    for half in (2, 4):
        k = pk.sample_patches(stack, lvl, uv, half, valid=valid)
        p = pk.sample_patches(stack, lvl, uv, half, use_pallas=False)
        torch.cuda.synchronize()
        assert float((k[valid] - p[valid]).abs().max()) <= 1e-3
        for stk in (torch.stack([stack, stack.flip(-1).contiguous()]),
                    stack.expand(2, *stack.shape)):
            pk.reset_launch_counts()
            kb = pk.sample_patches_batched(stk, torch.stack([lvl, lvl]),
                                           torch.stack([uv, uv.flip(0)]),
                                           half, valid=torch.stack(
                                               [valid, valid]))
            torch.cuda.synchronize()
            assert pk.LAUNCHES["sample_patches_kernel"] == 1
            assert torch.equal(kb[0], pk.sample_patches(
                stk[0], lvl, uv, half, valid=valid))
            assert torch.equal(kb[1], pk.sample_patches(
                stk[1], lvl, uv.flip(0), half, valid=valid))


def _exact_segment(x0, y0, k, dx):
    """Segment ends whose k positions are exact in fp32 whatever the
    rounding: k - 1 a power of two and a step of dx px along x."""
    a = torch.tensor([x0, y0])
    return a, a + torch.tensor([dx * (k - 1), 0.0])


@pytest.mark.parametrize("half", [1, 2, 3, 4, 5])
def test_scan_tile_reads_equal_the_stack_reads(problem, half):
    """One seed's 65 steps at 0.5 px (its steps read from staged tiles)
    against 65 one-step seeds at the same positions with a far segment end
    (spacing past the tile: read from the stack): the seed's best score is
    bit for bit the least of theirs and its step the first that reaches
    it; a seed at 35 px spacing (the stack path) agrees with the plain
    version."""
    from android_svo_tpu_torch.ops import patch_kernels as pk
    x = problem
    stack, dev = x["stack"], x["stack"].device
    p = 2 * half
    a, b = _exact_segment(40.0, 61.25, 65, 0.5)
    pos = a + torch.arange(65)[:, None] * torch.tensor([0.5, 0.0])
    ua = torch.cat([a[None], pos, torch.tensor([[30.0, 80.0]])]).to(dev)
    ub = torch.cat([b[None], pos + 1000.0,
                    torch.tensor([[100.0, 80.0]])]).to(dev)
    ns = torch.tensor([65] + [1] * 65 + [3], dtype=torch.int32, device=dev)
    lvl = torch.zeros((67,), dtype=torch.int32, device=dev)
    ref = pk.sample_patches(stack, lvl[:1], torch.tensor(
        [[52.3, 60.7]], device=dev), half).expand(67, p, p)
    t, s = pk.epi_scan(stack, lvl, ua, ub, ref, 65, half=half,
                       n_steps_each=ns)
    torch.cuda.synchronize()
    singles = s[1:66]
    j = int((singles == singles.min()).nonzero()[0, 0])
    assert torch.equal(s[0], singles.min())
    assert float(t[0]) == j / 64
    tp, sp = pk.epi_scan(stack, lvl, ua, ub, ref, 65, half=half,
                         n_steps_each=ns, use_pallas=False)
    assert float(t[66]) == float(tp[66])
    assert abs(float(s[66]) - float(sp[66])) <= 2.0


@pytest.mark.parametrize("half", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("n", [5, 1030])
def test_scan_first_minimum_across_the_split(card, n, half):
    """n seeds on a flat stack, where every in-bounds step scores exactly
    0, so the first in-bounds step must win across the seed's warps and
    chunks (8 warps per seed at 5 seeds, 4 at 1,030: past the 1,024 of the
    8-warp launch), at every patch size.  Segments start off the level and
    walk in (so the winner lies in a later chunk), stay off it, or start
    inside it; seeds with 0 or 1 step sit among them.  Every position is exact in fp32
    (k - 1 a power of two, quarter-pixel starts, half-pixel steps), so the
    plain version's margins cut at the same steps: equal bit for bit."""
    from android_svo_tpu_torch.ops import patch_kernels as pk
    h, w = 240, 320
    flat = torch.zeros((3, h, w), device=card)
    i = torch.arange(n)
    k = torch.tensor([0, 17, 33, 65, 1])[i % 5]
    vertical = (i // 5) % 2 == 1
    start = -9.0 + (i % 13).float() * 0.75 + (i % 4 == 3).float() * 30.0
    across = 60.0 + (i % 3).float()
    ua = torch.where(vertical[:, None], torch.stack([across, start], -1),
                     torch.stack([start, across], -1))
    step = torch.where(vertical[:, None], torch.tensor([0.0, 0.5]),
                       torch.tensor([0.5, 0.0]))
    ub = ua + step * torch.clamp(k - 1, min=0)[:, None].float()
    lvl = (i % 2).to(torch.int32)
    ns = k.to(torch.int32)
    args = [t.to(card) for t in (lvl, ua, ub)]
    ref = torch.zeros((n, 2 * half, 2 * half), device=card)
    got = pk.epi_scan(flat, *args, ref, 100, half=half,
                      n_steps_each=ns.to(card), h=h, w=w)
    want = pk.epi_scan(flat, *args, ref, 100, half=half,
                       n_steps_each=ns.to(card), h=h, w=w, use_pallas=False)
    torch.cuda.synchronize()
    assert bool(torch.isinf(want[1]).any()) and bool((want[0] > 0).any())
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("spacing", [0.7, 35.0])
def test_scan_spacings_match_plain(problem, spacing):
    """The gate's seeds with every segment cut to `spacing` px between
    positions (0.7: the path's, each step read from a tile; 35: the stack
    path), held to the gate's bounds, and 1,031 seeds (4 warps per seed)
    equal row for row to the same seeds in one launch of 768 and one of
    263 (8 warps per seed)."""
    from android_svo_tpu_torch.ops import patch_kernels as pk
    x = problem
    d = torch.linalg.norm(x["uv_b"] - x["uv_a"], dim=-1)
    ns = torch.clamp((d / spacing).to(torch.int32) + 1, 2, 100).to(
        torch.int32)
    args = (x["stack"], x["lvl"], x["uv_a"], x["uv_b"], x["ref"], 100)
    kw = dict(half=4, n_steps_each=ns, h=x["h"], w=x["w"])
    tk, sk = pk.epi_scan(*args, **kw)
    tp, sp = pk.epi_scan(*args, **kw, use_pallas=False)
    torch.cuda.synchronize()
    fin = torch.isfinite(sk) & torch.isfinite(sp)
    assert int(fin.sum()) >= 0.8 * fin.numel()
    assert float((tk - tp)[fin].abs().max()) <= 1e-3
    assert float((sk - sp)[fin].abs().max()) <= 2.0
    rep = [t.repeat((5,) + (1,) * (t.dim() - 1))[:1031]
           for t in (x["lvl"], x["uv_a"], x["uv_b"], x["ref"], ns)]
    big = pk.epi_scan(x["stack"], *rep[:4], 100, half=4, n_steps_each=rep[4],
                      h=x["h"], w=x["w"])
    parts = [pk.epi_scan(x["stack"], *(t[lo:hi] for t in rep[:4]), 100,
                         half=4, n_steps_each=rep[4][lo:hi], h=x["h"],
                         w=x["w"]) for lo, hi in ((0, 768), (768, 1031))]
    torch.cuda.synchronize()
    for i in range(2):
        assert torch.equal(big[i], torch.cat([p[i] for p in parts]))


# ---------------------------------------------------------------------------
# the ICLK kernels as redesigned for the batched step: one warp a feature
# below a row count (the kernels' kPackRows, read back with
# pk.iclk_residency), two features a warp (16 lanes each) from there on for
# patches of up to 64 pixels
# ---------------------------------------------------------------------------

ICLK_FORMS = ["align_iclk_kernel", "align_iclk_window_kernel",
              "align_iclk_window_kernel/ungated"]


@pytest.fixture(scope="module")
def wide_problem(card):
    """2,304 features on one 240x320 frame: above the packing threshold."""
    from android_svo_tpu_torch.ops import silicon_gate
    return silicon_gate.gate_inputs(n=2304, h=240, w=320, seed=5,
                                    device=card)


@pytest.fixture(scope="module")
def packed_problem(card):
    """11 frames of 256 features: 2,816 rows, packed in a batched launch;
    each frame's single launch is not."""
    from android_svo_tpu_torch.ops import silicon_gate
    return silicon_gate.batched_gate_inputs(11, n=256, h=240, w=320, seed=6,
                                            device=card)


def _pack_rows():
    """The row count from which an ICLK launch packs two 8x8 features a
    warp, as the kernels report it (pk.iclk_residency)."""
    from android_svo_tpu_torch.ops import patch_kernels as pk
    lo, hi = 1, 8448                       # 1 row unpacked, 8,448 packed
    assert pk.iclk_residency(4, False, hi)["features_per_warp"] == 2
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if pk.iclk_residency(4, False, mid)["features_per_warp"] == 2:
            hi = mid
        else:
            lo = mid
    return hi


def _iclk(form, batched=False):
    """fn(stack, lvl, T, gx, gy, init, valid, h, w, use_pallas) of an ICLK
    form, 10 iterations (the window form with the gate's two gates)."""
    from android_svo_tpu_torch.ops import patch_kernels as pk

    def call(stack, lvl, T, gx, gy, init, valid, h, w, use_pallas=True):
        if form == "align_iclk_kernel":
            fn = pk.align_iclk_batched if batched else pk.align_iclk
            return fn(stack, lvl, T, gx, gy, init, valid, 10, h=h, w=w,
                      use_pallas=use_pallas)
        fn = pk.align_iclk_mxu_batched if batched else pk.align_iclk_mxu
        gates = ({} if form.endswith("/ungated")
                 else dict(zmssd_factor=2000.0, min_patch_std=5.0))
        return fn(stack, lvl, T, gx, gy, init, valid, 10, h=h, w=w,
                  use_pallas=use_pallas, **gates)
    return call


def _iclk_args(x, rows=slice(None), half=4):
    """The ICLK arguments of a gate problem's rows, the patches sampled at
    `half` (the problem's own 8x8 ones at 4)."""
    from android_svo_tpu_torch.ops import patch_kernels as pk
    lvl, uv = x["lvl"][rows], x["uv"][rows]
    if half == 4:
        T, gx, gy = x["ref"][rows], x["rdx"][rows], x["rdy"][rows]
    else:
        T, gx, gy = pk.sample_patches(x["stack"], lvl, uv, half, grad=True,
                                      use_pallas=False)
    return (x["stack"], lvl, T, gx, gy, x["init"][rows], x["valid"][rows],
            x["h"], x["w"])


def _same_all(a, b):
    from android_svo_tpu_torch.ops import silicon_gate
    return all(silicon_gate.same_bits(u, v) for u, v in zip(a, b))


def _agrees_with_plain(form, k, p, uv_true=None, window_bound=False):
    """The kernel gate's ICLK bounds against the plain version
    (ops/silicon_gate.py::run_gate): convergence agreement >= 0.95 and
    kernel convergences >= 0.8 x plain; uv max 0.05 px where both converge
    (align; `window_bound`: the window form's), p90 <= 0.05 and max <= 0.5
    (window); with `uv_true`, the median converged error to it <= 0.5 px."""
    (uk, ck, _), (up, cp, _) = k, p
    assert float((ck == cp).float().mean()) >= 0.95
    assert int(ck.sum()) >= 0.8 * int(cp.sum())
    both = ck & cp
    if both.any():
        d = torch.linalg.norm(uk[both] - up[both], dim=-1)
        if form == "align_iclk_kernel" and not window_bound:
            assert float(d.max()) <= 0.05
        else:
            assert float(torch.quantile(d, 0.9)) <= 0.05
            assert float(d.max()) <= 0.5
    if uv_true is not None:
        err = torch.linalg.norm(uk - uv_true, dim=-1)[ck]
        assert int(ck.sum()) > 0 and float(err.median()) <= 0.5


@pytest.mark.parametrize("half", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("window", [False, True])
def test_iclk_layout_follows_the_row_count(card, half, window):
    """The runtime's view of each ICLK instantiation: one feature a warp
    below the packing row count (and always at half 5), two from there on,
    the switch between 1,536 rows (packing costs there) and 3,072 (it
    pays); the blocks cover the rows; no instantiation spills."""
    from android_svo_tpu_torch.ops import patch_kernels as pk
    pack = _pack_rows()
    assert 1536 < pack <= 3072
    for n in (1, 767, pack - 1, pack, 8448):
        r = pk.iclk_residency(half, window, n)
        v = 2 if half <= 4 and n >= pack else 1
        assert r["features_per_warp"] == v, (n, r)
        warps = -(-n // v)
        assert r["blocks"] == -(-warps * 32 // r["threads_per_block"])
        assert r["local_bytes"] == 0 and r["registers"] > 0
        assert r["blocks_per_sm"] >= 1 and r["sms"] > 0


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("form", ICLK_FORMS)
def test_iclk_permuted_rows_permute_outputs(wide_problem, packed_problem,
                                            form, batched):
    """Permuting the rows permutes the outputs bit for bit, so the two
    features that share a warp do not touch each other: 2,304 rows of one
    frame, and 11 frames of 256 rows each permuted within its frame."""
    g = torch.Generator().manual_seed(11)
    if not batched:
        args = _iclk_args(wide_problem)
        perm = torch.randperm(args[1].shape[0], generator=g).to(args[1].device)
        moved = [a[perm] for a in args[1:7]]
        out = _iclk(form)(*args)
        got = _iclk(form)(args[0], *moved, *args[7:])
        torch.cuda.synchronize()
        assert _same_all([o[perm] for o in out], got)
        return
    _, xb = packed_problem
    args = (xb["stack"], xb["lvl"], xb["ref"], xb["rdx"], xb["rdy"],
            xb["init"], xb["valid"], xb["h"], xb["w"])
    B, N = xb["lvl"].shape
    perm = torch.stack([torch.randperm(N, generator=g) for _ in range(B)]
                       ).to(xb["lvl"].device)

    def rows(t):
        idx = perm.reshape(perm.shape + (1,) * (t.dim() - 2))
        return torch.gather(t, 1, idx.expand_as(t)).contiguous()

    out = _iclk(form, batched=True)(*args)
    got = _iclk(form, batched=True)(args[0], *(rows(a) for a in args[1:7]),
                                    *args[7:])
    torch.cuda.synchronize()
    assert _same_all([rows(o) for o in out], got)


@pytest.mark.parametrize("base, offset", [(1, 0), (3, 0), (767, 0),
                                          ("pack", -1), ("pack", 0),
                                          ("pack", 1), ("pack", 3)])
@pytest.mark.parametrize("form", ICLK_FORMS)
def test_iclk_rows_around_the_threshold(wide_problem, form, base, offset):
    """Launches of n rows on either side of the packing row count (odd
    counts leave the last warp's second feature empty) give each row the
    bits of the same row in a launch of 2,304, and n >= 767 rows agree with
    the plain version within the gate's bounds."""
    n = (_pack_rows() if base == "pack" else base) + offset
    x = wide_problem
    assert n <= x["lvl"].shape[0]
    full = _iclk(form)(*_iclk_args(x))
    args = _iclk_args(x, slice(0, n))
    got = _iclk(form)(*args)
    torch.cuda.synchronize()
    assert _same_all([o[:n] for o in full], got)
    if n >= 767:
        plain = _iclk(form)(*args, use_pallas=False)
        _agrees_with_plain(form, got, plain, x["uv"][:n])


@pytest.mark.parametrize("form", ICLK_FORMS)
def test_iclk_pairs_that_stop_apart(wide_problem, form):
    """Warps whose first feature leaves the level before its first update
    and whose second runs every one of its 10 iterations: each row equals
    its own one-row launch bit for bit."""
    from android_svo_tpu_torch.ops import patch_kernels as pk
    x = wide_problem
    args = _iclk_args(x)
    call = _iclk(form)
    # rows still moving at the 10th iteration: the 9- and 10-iteration
    # plain runs differ there
    if form == "align_iclk_kernel":
        nine = pk.align_iclk(*args[:7], 9, h=args[7], w=args[8],
                             use_pallas=False)
    else:
        nine = pk.align_iclk_mxu(*args[:7], 9, h=args[7], w=args[8],
                                 use_pallas=False)
    ten = call(*args, use_pallas=False)
    runs = torch.nonzero((nine[0] != ten[0]).any(-1)).flatten()
    assert runs.numel() >= 1
    runs = runs[:32]
    k = runs.numel()
    n = 2 * max(k, -(-_pack_rows() // 2))    # packed: pairs share a warp
    pick = torch.stack([runs, runs], -1).flatten().repeat(n // (2 * k) + 1)
    pick = pick[:n]
    lvl, T, gx, gy, init, valid = (a[pick] for a in args[1:7])
    init = init.clone()
    init[0::2] = torch.tensor([1.0, 1.0], device=init.device)  # off level
    out = call(args[0], lvl, T, gx, gy, init, valid, *args[7:])
    for i in range(2 * k):
        one = call(args[0], lvl[i:i + 1], T[i:i + 1], gx[i:i + 1],
                   gy[i:i + 1], init[i:i + 1], valid[i:i + 1], *args[7:])
        assert _same_all([o[i:i + 1] for o in out], one), i
    torch.cuda.synchronize()
    # the pattern repeats: every pair equals the first k pairs
    for o in out:
        o2 = o[:2 * k * (n // (2 * k))].reshape((n // (2 * k), 2 * k)
                                                + tuple(o.shape[1:]))
        assert all(_same_all([o2[j]], [o2[0]]) for j in range(o2.shape[0]))


@pytest.mark.parametrize("half", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("form", ["align_iclk_kernel",
                                  "align_iclk_window_kernel/ungated"])
def test_iclk_halves_match_plain(wide_problem, form, half):
    """Every patch size the kernels take, packed (2,304 rows; half 5 keeps
    a warp a feature) and not (the first 767 rows, bit for bit the same
    rows of the packed launch), within the gate's bounds of the plain
    version (at half 4 also its accuracy bound).  At half 1 the 2x2
    system amplifies the two versions' different summation orders (one
    feature of 2,304 lands 0.052 px from the plain version's, the parent
    kernel's bits too), so align_iclk is held there to the window form's
    bound, p90 <= 0.05 px and max <= 0.5 px."""
    x = wide_problem
    args = _iclk_args(x, half=half)
    call = _iclk(form)
    k = call(*args)
    few = call(*_iclk_args(x, slice(0, 767), half=half))
    p = call(*args, use_pallas=False)
    torch.cuda.synchronize()
    assert _same_all([o[:767] for o in k], few)
    _agrees_with_plain(form, k, p, x["uv"] if half == 4 else None,
                       window_bound=half == 1)


@pytest.mark.parametrize("form", ICLK_FORMS)
def test_iclk_packed_batch_matches_single_launches(packed_problem, form):
    """A batched launch of 11 x 256 rows (packed) gives each frame the bits
    of its own single launch of 256 rows (a warp a feature)."""
    from android_svo_tpu_torch.ops import patch_kernels as pk
    from android_svo_tpu_torch.ops import silicon_gate
    frames, xb = packed_problem
    kernel = silicon_gate.kernel_of(form)
    assert pk.iclk_residency(4, "window" in form, 11 * 256)[
        "features_per_warp"] == 2
    pk.reset_launch_counts()
    out = silicon_gate.batched_kernel_calls(xb)[form](True)
    torch.cuda.synchronize()
    assert pk.LAUNCHES[kernel] == 1
    for b, x in enumerate(frames):
        one = silicon_gate.gate_calls(x)[form](True)
        assert _same_all([o[b] for o in out], one), b


@pytest.mark.parametrize("form", ICLK_FORMS)
def test_iclk_vmap_takes_moved_and_expanded_args(packed_problem, form):
    """torch.func.vmap over the per-frame wrapper with the features' batch
    dimension last but the patch's (moved) and one template shared by
    every frame (expanded): one launch, bit for bit the batched wrapper on
    the same values laid out contiguously."""
    from android_svo_tpu_torch.ops import patch_kernels as pk
    from android_svo_tpu_torch.ops import silicon_gate
    _, xb = packed_problem
    B, N = xb["lvl"].shape
    h, w = xb["h"], xb["w"]
    moved = {k: xb[k].movedim(0, 1).contiguous()
             for k in ("lvl", "rdx", "rdy", "init", "valid")}
    shared = xb["ref"][0]

    def single(stack, lvl, T, gx, gy, init, valid):
        return _iclk(form)(stack, lvl, T, gx, gy, init, valid, h, w)

    pk.reset_launch_counts()
    got = torch.func.vmap(single, in_dims=(0, 1, None, 1, 1, 1, 1))(
        xb["stack"], moved["lvl"], shared, moved["rdx"], moved["rdy"],
        moved["init"], moved["valid"])
    torch.cuda.synchronize()
    assert pk.LAUNCHES[silicon_gate.kernel_of(form)] == 1
    want = _iclk(form, batched=True)(
        xb["stack"], xb["lvl"], shared.expand(B, N, 8, 8).contiguous(),
        xb["rdx"], xb["rdy"], xb["init"], xb["valid"], h, w)
    torch.cuda.synchronize()
    assert _same_all(got, want)


@pytest.mark.parametrize("form", ICLK_FORMS)
def test_batched_iclk_dispatch_counts(packed_problem, form):
    """A batched ICLK call is its three output allocations and one launch:
    at most 3 ATen ops and exactly 1 device activity."""
    from android_svo_tpu_torch.ops import silicon_gate
    from android_svo_tpu_torch.utils.profiling import dispatch_counts
    _, xb = packed_problem
    fn = silicon_gate.batched_kernel_calls(xb)[form]
    fn(True)
    n_ops, n_dev = dispatch_counts(lambda: fn(True))
    assert n_ops <= 3 and n_dev == 1, (n_ops, n_dev)
