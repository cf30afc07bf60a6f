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

from android_svo_tpu_torch.ops import silicon_gate

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def problem(card):
    return silicon_gate.gate_inputs(n=256, h=240, w=320, seed=1, device=card)


# The gate problems of the tests that take `gate_problem`: the fixture's 256
# rows on 320x240, and the tracking path's shapes, as (n, h, w)
GATE_SHAPES = {"256_320x240": None, **silicon_gate.PATH_SHAPES}


@pytest.fixture(scope="module")
def gate_problem(request, problem):
    shape = GATE_SHAPES[request.param]
    if shape is None:
        return problem
    n, h, w = shape
    return silicon_gate.gate_inputs(n=n, h=h, w=w, seed=0,
                                    device=problem["stack"].device)


@pytest.mark.parametrize("gate_problem", list(GATE_SHAPES), indirect=True)
def test_kernel_gate(gate_problem):
    """`silicon_gate.run_gate` at each shape, and the two forms it leaves
    out with its bounds (`silicon_gate.extra_forms_failures`)."""
    rep = silicon_gate.run_gate(gate_problem)
    torch.cuda.synchronize()
    assert rep.ok, rep.failures
    assert not silicon_gate.extra_forms_failures(gate_problem)


def test_path_gate(card):
    """`silicon_gate.path_gate`, which `chip_smoke.py` runs too: every
    kernel against its plain version, its launches and its dispatch at
    the tracking path's shapes, pose GN, sparse alignment and the probe
    included."""
    failed = {k: v for k, v in silicon_gate.path_gate(card).items() if v}
    assert not failed, failed


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
    from android_svo_tpu_torch.ops import matcher
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


@pytest.mark.parametrize("n", [0, 1, 7, 2048, 2049, 32768])
def test_probe_kernel_matches_plain(card, n):
    """probe_patches_kernel against probe_patches_plain, bit for bit, every
    variant, at sizes with partial blocks and warps (8 features per block),
    at the microbench's N and at 16x it: the kernel stages the plain
    version's clamped taps and rounds each operation as the plain version
    does.  Variant A within 1e-4 of interp.extract_patches."""
    from android_svo_tpu_torch.ops import gather_probe as gp, interp
    from android_svo_tpu_torch.tools.microbench_gather import make_inputs
    img, uv = make_inputs(n=n, seed=2, device=card)
    for v in gp.VARIANTS:
        gp.reset_launch_counts()
        out = gp.probe_patches(img, uv, v)
        torch.cuda.synchronize()
        assert gp.LAUNCHES["probe_patches_kernel"] == (1 if n else 0)
        assert out.shape == (n, gp.P, gp.P)
        assert torch.equal(out, gp.probe_patches_plain(img, uv, v)), v
        if v == "A" and n:
            ref = interp.extract_patches(img, uv, gp.P // 2)
            assert float((out - ref).abs().max()) <= 1e-4


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
    img, uv = make_inputs(seed=6, device=card)
    gp.probe_patches(img, uv, variant)              # build and warm up
    gp.reset_launch_counts()
    n_ops, n_dev = silicon_gate.dispatch_counts(
        lambda: gp.probe_patches(img, uv, variant))
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


@pytest.mark.parametrize("gate_problem", list(GATE_SHAPES), indirect=True)
@pytest.mark.parametrize("case", ["sample_4x4", "sample_8x8_grad",
                                  "sample_8x8_align1d", "sample_4x4_ref_grad",
                                  "window_gated", "window_ungated", "align",
                                  "scan", "scan_path", "scan_no_steps",
                                  "dump"])
def test_wrapper_dispatch_counts(gate_problem, case):
    """Under torch.profiler one call of the sampler dispatches at most 4
    ATen ops and one of align_iclk_mxu, align_iclk, epi_scan or
    dump_windows at most 3, each exactly 1 device kernel
    (`silicon_gate.dispatch_cases`)."""
    from android_svo_tpu_torch.ops import patch_kernels as pk
    fn, limit = silicon_gate.dispatch_cases(gate_problem)[case]
    fn()                                   # build and warm up
    n_ops, n_dev = silicon_gate.dispatch_counts(fn)
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
    return silicon_gate.batched_gate_inputs(3, n=256, h=240, w=320, seed=2,
                                            device=card)


# The batched problems of the tests that take `batched_gate_problem`: the
# fixture's 3 frames of 256 rows on 320x240, and the batched step's 11
# frames of 768 rows on EuRoC cam0's 752x480, as (B, n, h, w)
BATCHED_SHAPES = {"3x256_320x240": None, "11x768_752x480": (11, 768, 480, 752)}


@pytest.fixture(scope="module")
def batched_gate_problem(request, batched_problem):
    shape = BATCHED_SHAPES[request.param]
    if shape is None:
        return batched_problem
    b, n, h, w = shape
    return silicon_gate.batched_gate_inputs(
        b, n=n, h=h, w=w, seed=0, device=batched_problem[1]["stack"].device)


BATCHED_FORMS = ["sample_patches_kernel", "sample_patches_kernel/grad",
                 "sample_patches_kernel/align1d", "epi_scan_kernel",
                 "align_iclk_kernel", "align_iclk_window_kernel",
                 "align_iclk_window_kernel/ungated", "dump_windows_kernel",
                 "sample_patches_kernel/ref_grad", "epi_scan_kernel/path"]


@pytest.mark.parametrize("batched_gate_problem", list(BATCHED_SHAPES),
                         indirect=True)
@pytest.mark.parametrize("name", BATCHED_FORMS)
def test_batched_kernel_matches_single_launches(batched_gate_problem, name):
    """A batched call is one launch and one device activity (an ICLK at
    most 3 ATen ops), and each frame's rows equal that frame's own single
    launch bit for bit."""
    from android_svo_tpu_torch.ops import patch_kernels as pk
    from android_svo_tpu_torch.tools import patch_ab
    frames, xb = batched_gate_problem
    kernel = silicon_gate.kernel_of(name)
    call = {**silicon_gate.batched_kernel_calls(xb),
            **patch_ab.extra_calls(xb, batched=True)}[name]
    pk.reset_launch_counts()
    out = call(True)
    torch.cuda.synchronize()
    assert pk.LAUNCHES[kernel] == 1
    # the ICLKs read the (B, N) rows in place: three output allocations
    n_ops, n_dev = silicon_gate.dispatch_counts(lambda: call(True))
    assert n_dev == 1 and (not name.startswith("align_iclk") or n_ops <= 3), \
        (n_ops, n_dev)
    out = out if isinstance(out, tuple) else (out,)
    for b, x in enumerate(frames):
        single = {**silicon_gate.gate_calls(x),
                  **patch_ab.extra_calls(x)}[name](True)
        single = single if isinstance(single, tuple) else (single,)
        for o, s in zip(out, single):
            assert silicon_gate.same_bits(o[b], s), (name, b)


@pytest.mark.parametrize("batched_gate_problem", list(BATCHED_SHAPES),
                         indirect=True)
def test_batched_gate(batched_gate_problem):
    """`silicon_gate.run_batched_gate` at each shape, and the two forms it
    leaves out, batched, with the gate's bounds
    (`silicon_gate.extra_forms_failures`)."""
    rep = silicon_gate.run_batched_gate(*batched_gate_problem)
    torch.cuda.synchronize()
    assert rep.ok, rep.failures
    assert not silicon_gate.extra_forms_failures(batched_gate_problem[1],
                                                 batched=True)


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
    return silicon_gate.gate_inputs(n=2304, h=240, w=320, seed=5,
                                    device=card)


@pytest.fixture(scope="module")
def packed_problem(card):
    """11 frames of 256 features: 2,816 rows, packed in a batched launch;
    each frame's single launch is not."""
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
    for n in (1, 767, 768, pack - 1, pack, 8448):
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
    _, xb = packed_problem
    fn = silicon_gate.batched_kernel_calls(xb)[form]
    fn(True)
    n_ops, n_dev = silicon_gate.dispatch_counts(lambda: fn(True))
    assert n_ops <= 3 and n_dev == 1, (n_ops, n_dev)


# ---------------------------------------------------------------------------
# the program's spans on the card (utils/profiling.py)
# ---------------------------------------------------------------------------

SPAN_OF_KERNEL = (("align_iclk_window_kernel", "patch.align_iclk_mxu"),
                  ("align_iclk_kernel", "patch.align_iclk"),
                  ("sample_patches_kernel", "patch.sample_patches"),
                  ("epi_scan_kernel", "patch.epi_scan"))


def test_spans_bracket_the_work_they_launch(card, tmp_path):
    """Five tracked frames, one of them inserting a keyframe, with the
    recorder on, under `device_trace`: sparse alignment is one
    `align_launches` a frame with no read of its own; on
    the profiler's clock each frame's span holds the launch of every
    device activity (matched to its launch by correlation id), each patch
    kernel is launched inside a span of its patch function, and the
    frames' device-to-host copies are exactly their `host_read`s.  The
    spans' profiler ranges are annotations, so the profiler's own device
    spans of them are not counted as work, and the Chrome trace holds the
    spans beside the kernels."""
    import json
    from torch.autograd import DeviceType
    from android_svo_tpu_torch.config import SVOConfig
    from android_svo_tpu_torch.core import frame_handler as fh
    from android_svo_tpu_torch.core import pipeline
    from android_svo_tpu_torch.data import synthetic
    from android_svo_tpu_torch.utils import profiling
    cam = synthetic.default_camera(320, 240)
    tex = synthetic.make_texture(torch.Generator().manual_seed(3), 1024)
    imgs = [synthetic.render(tex, cam, synthetic.lookdown_pose(
        0.05 * i, 0.015 * i, -3.0, (0.45 + 0.002 * i, -0.002 * i,
                                    0.004 * i))) for i in range(11)]
    handler = fh.FrameHandler(cam, SVOConfig(init_min_disparity=20.0,
                                             loba_n_iter=0))
    for img in (imgs[0], imgs[4], imgs[5]):
        handler.add_image(img)
    assert handler.stage == fh.STAGE_DEFAULT_FRAME
    torch.cuda.synchronize()
    mon = profiling.install()
    try:
        with profiling.device_trace(str(tmp_path)) as prof:
            results = [handler.add_image(img).result for img in imgs[6:11]]
            torch.cuda.synchronize()
    finally:
        profiling.uninstall()
    assert pipeline.RES_IS_KEYFRAME in results
    assert pipeline.RES_FAILURE not in results
    events = list(prof.profiler.kineto_results.events())
    host = [e for e in events if e.device_type() != DeviceType.CUDA]
    ranges = {e.name() for e in host if e.is_user_annotation()}
    spans = mon.spans()
    assert {s.name for s in spans} - {"tot_time"} <= ranges
    launch = {e.correlation_id(): e.start_ns() for e in host
              if e.name().startswith("cu") and e.correlation_id()}
    work = [e for e in events if e.device_type() == DeviceType.CUDA
            and e.name() not in ranges and e.correlation_id() in launch]
    assert work

    def inside(t, name):
        return any(mon.profiler_ns(s.start_ns) - 20_000 <= t
                   <= mon.profiler_ns(s.end_ns) + 20_000
                   for s in spans if s.name == name)

    frames = [s for s in spans if s.name == "tot_time"]
    assert len(frames) == 5
    # sparse alignment's loop is one launch a frame and reads nothing back
    assert mon.counters["align_launches"] == 5
    assert "align_iters" not in mon.counters
    assert not [s for s in spans if s.name in ("host_read.align_stop",
                                               "host_read.align_active")]
    for e in work:
        assert inside(launch[e.correlation_id()], "tot_time"), e.name()
    n_patch = 0
    for e in work:
        for kernel, name in SPAN_OF_KERNEL:
            if kernel in e.name():
                assert inside(launch[e.correlation_id()], name), e.name()
                n_patch += 1
                break
    assert n_patch == sum(s.name.startswith("patch.") for s in spans)
    d2h = [e for e in work if "DtoH" in e.name()]

    def where(t):                  # the host ranges and ops open at time t
        return [e.name() for e in sorted(host, key=lambda e: e.start_ns())
                if e.start_ns() <= t <= e.end_ns()
                and not e.name().startswith("cu")][-4:]

    other = [where(launch[e.correlation_id()]) for e in d2h
             if not any(inside(launch[e.correlation_id()], s.name)
                        for s in spans if s.name.startswith("host_read."))]
    assert len(d2h) == mon.counters["host_reads"] == sum(
        s.name.startswith("host_read.") for s in spans), other
    trace = json.loads((tmp_path / "trace.json").read_text())
    cats = {e.get("cat") for e in trace["traceEvents"]}
    assert {"program_span", "kernel"} <= cats


# ---------------------------------------------------------------------------
# pose refinement in one launch (pose_gn_kernel)
# ---------------------------------------------------------------------------

def _pose_scene(seed, **kw):
    return silicon_gate.pose_inputs(seed, **kw)


def _pose_cfg(method="gn", n_iter=10, **kw):
    from android_svo_tpu_torch.config import SVOConfig
    return SVOConfig(poseoptim_method=method, poseoptim_n_iter=n_iter, **kw)


POSE_SCENES = {"typical": {}, "all_valid": {"valid_share": 1.0},
               "few_valid": {"valid_share": 0.02},
               "none_valid": {"valid_share": 0.0},
               "behind": {"behind": 0.2}, "outliers": {"outliers": 0.4},
               "rows_768": {"n": 768}, "rows_2048": {"n": 2048}}


@pytest.mark.parametrize("scene", list(POSE_SCENES))
@pytest.mark.parametrize("method,n_iter", [("gn", 10), ("gn", 3),
                                           ("lm", 10), ("lm", 3)])
def test_pose_kernel_matches_plain(card, scene, method, n_iter):
    """pose_gn_kernel against the plain version (ATen on the card) at the
    cells' 912 rows (768 at 640x480, and 2,048, past the default 48 KB of
    shared memory), two seeds each, with `silicon_gate.compare_pose`'s
    tolerances (rounding's: only the order of the sums differs): the pose
    within 0.05 px of projection gap, chi2_init 1e-5 relative, chi2_final
    1e-3 relative plus 1e-9, cov 1e-2 of its largest entry, inliers equal
    but for rows within 0.05 px of the threshold, the count the mask's."""
    from android_svo_tpu_torch.core import pose_opt
    from android_svo_tpu_torch.ops import pose_gn
    cfg = _pose_cfg(method, n_iter)
    for seed in (1, 2):
        args = _pose_scene(seed, **POSE_SCENES[scene])
        pose_gn.reset_launch_counts()
        k = pose_opt.optimize_pose(*args, cfg)
        p = pose_opt.optimize_pose(*args, cfg.replace(use_pallas=False))
        torch.cuda.synchronize()
        assert pose_gn.LAUNCHES["pose_gn_kernel"] == 1
        T0 = args[0]
        _, failures = silicon_gate.compare_pose(k, p, args,
                                                cfg.poseoptim_thresh)
        assert not failures, failures
        if scene == "none_valid":
            assert int(k[2]) == 0 and torch.equal(k[0].q, T0.q)


def test_pose_kernel_batched_matches_single_launches(card):
    """torch.func.vmap over optimize_pose on 11 sequences (focal shared,
    every other input batched) is ONE launch, and each sequence's outputs
    equal its own single launch bit for bit: each block sums in an order
    that does not depend on the batch.  Each sequence is within
    `silicon_gate.compare_pose`'s tolerances of the vmapped plain
    version."""
    from android_svo_tpu_torch.core import pose_opt
    from android_svo_tpu_torch.geometry.se3 import SE3
    from android_svo_tpu_torch.ops import pose_gn
    cfg = _pose_cfg()
    scenes = [_pose_scene(10 + s, outliers=0.05 * (s % 4),
                          behind=0.02 * (s % 3)) for s in range(11)]
    T0 = SE3(q=torch.stack([s[0].q for s in scenes]),
             t=torch.stack([s[0].t for s in scenes]) + 0.01)
    rows = [torch.stack([s[i] for s in scenes]) for i in range(1, 5)]
    focal = scenes[0][5]

    def batched(c):
        return torch.func.vmap(lambda q, t, *r: pose_opt.optimize_pose(
            SE3(q=q, t=t), *r, focal, c))(T0.q, T0.t, *rows)

    def frame(out, b):
        return (SE3(q=out[0].q[b], t=out[0].t[b]), *(o[b] for o in out[1:]))

    pose_gn.reset_launch_counts()
    out = batched(cfg)
    torch.cuda.synchronize()
    assert pose_gn.LAUNCHES["pose_gn_kernel"] == 1
    out_p = batched(cfg.replace(use_pallas=False))
    flat = (out[0].q, out[0].t, *out[1:])
    for b in range(11):
        args = (SE3(q=T0.q[b], t=T0.t[b]), *(r[b] for r in rows), focal)
        single = pose_opt.optimize_pose(*args, cfg)
        for o, s in zip(flat, (single[0].q, single[0].t, *single[1:])):
            assert torch.equal(o[b], s), b
        _, failures = silicon_gate.compare_pose(
            frame(out, b), frame(out_p, b), args, cfg.poseoptim_thresh)
        assert not failures, (b, failures)
    assert pose_gn.LAUNCHES["pose_gn_kernel"] == 12


@pytest.mark.parametrize("batched", [False, True])
def test_pose_kernel_launches_once_and_reads_nothing_back(card, batched):
    """One call (a frame, or a vmapped batch of 11) is exactly one launch
    of pose_gn_kernel and one device activity (a frame's call at most 7
    ATen ops), and nothing in it reads the device back: no `aten::item`
    or `aten::_local_scalar_dense`, no device-to-host copy, no wait for
    the card (`silicon_gate.host_reads`).  With use_pallas off the plain
    version runs on the card and launches nothing."""
    from android_svo_tpu_torch.core import pose_opt
    from android_svo_tpu_torch.geometry.se3 import SE3
    from android_svo_tpu_torch.ops import pose_gn
    cfg = _pose_cfg()
    if batched:
        scenes = [_pose_scene(30 + s) for s in range(11)]
        q = torch.stack([s[0].q for s in scenes])
        t = torch.stack([s[0].t for s in scenes])
        rows = [torch.stack([s[i] for s in scenes]) for i in range(1, 5)]

        def call(c):
            return torch.func.vmap(lambda q, t, *r: pose_opt.optimize_pose(
                SE3(q=q, t=t), *r, scenes[0][5], c))(q, t, *rows)
    else:
        args = _pose_scene(30)

        def call(c):
            return pose_opt.optimize_pose(*args, c)
    call(cfg)                                   # warm
    torch.cuda.synchronize()
    n_ops, n_dev = silicon_gate.dispatch_counts(lambda: call(cfg))
    assert n_dev == 1 and (batched or n_ops <= 7), (n_ops, n_dev)
    pose_gn.reset_launch_counts()
    assert not silicon_gate.host_reads(lambda: call(cfg))
    assert pose_gn.LAUNCHES["pose_gn_kernel"] == 1
    call(cfg.replace(use_pallas=False))
    torch.cuda.synchronize()
    assert pose_gn.LAUNCHES["pose_gn_kernel"] == 1


def test_pose_kernel_refuses_other_types(card):
    """On the card the wrapper converts nothing: float64 points or a
    strided bearing array raise before any launch."""
    from android_svo_tpu_torch.core import pose_opt
    from android_svo_tpu_torch.ops import pose_gn
    T0, p_w, f, level, valid, focal = _pose_scene(40)
    cfg = _pose_cfg()
    pose_gn.reset_launch_counts()
    with pytest.raises(TypeError):
        pose_opt.optimize_pose(T0, p_w.double(), f, level, valid, focal, cfg)
    with pytest.raises(TypeError):
        pose_opt.optimize_pose(T0, p_w, f, level.long(), valid, focal, cfg)
    with pytest.raises(ValueError):
        pose_opt.optimize_pose(T0, p_w, torch.cat([f, f], 1)[:, ::2], level,
                               valid, focal, cfg)
    assert pose_gn.LAUNCHES["pose_gn_kernel"] == 0


def test_pose_kernel_once_per_frame_and_per_step(card):
    """On the tracking path: one pose_gn_kernel launch per tracked frame of
    the handler, keyframes included, and one per batched step of 11
    sequences."""
    from android_svo_tpu_torch.config import SVOConfig
    from android_svo_tpu_torch.core import frame_handler as fh
    from android_svo_tpu_torch.core import pipeline
    from android_svo_tpu_torch.core import state as st
    from android_svo_tpu_torch.data import synthetic
    from android_svo_tpu_torch.ops import pose_gn
    from android_svo_tpu_torch.parallel.multi_seq import make_batched_track
    cam = synthetic.default_camera(320, 240)
    tex = synthetic.make_texture(torch.Generator().manual_seed(3), 1024)
    imgs = [synthetic.render(tex, cam, synthetic.lookdown_pose(
        0.05 * i, 0.015 * i, -3.0, (0.45 + 0.002 * i, -0.002 * i,
                                    0.004 * i))) for i in range(11)]
    cfg = SVOConfig(init_min_disparity=20.0, loba_n_iter=0)
    handler = fh.FrameHandler(cam, cfg)
    for img in (imgs[0], imgs[4]):
        handler.add_image(img)
    assert handler.stage == fh.STAGE_DEFAULT_FRAME
    pose_gn.reset_launch_counts()
    results = [handler.add_image(img).result for img in imgs[5:10]]
    torch.cuda.synchronize()
    assert pipeline.RES_FAILURE not in results
    assert pose_gn.LAUNCHES["pose_gn_kernel"] == len(results)
    track = make_batched_track(cfg, handler.cam, handler.dims)
    vo_b = st.stack_states([handler.vo] * 11)
    pose_gn.reset_launch_counts()
    track(vo_b, torch.stack([imgs[10]] * 11))
    torch.cuda.synchronize()
    assert pose_gn.LAUNCHES["pose_gn_kernel"] == 1


# ---------------------------------------------------------------------------
# structure optimisation in one launch (point_gn_kernel)
# ---------------------------------------------------------------------------

POINT_SCENES = {"typical": {}, "all_live": {"live_share": 1.0},
                "few_live": {"live_share": 0.002},
                "none_live": {"live_share": 0.0},
                "dead_keyframes": {"kf_live_share": 0.3},
                "outliers": {"outliers": 0.3},
                "far_off": {"offset": 0.3}}
# (structureoptim_max_pts, max_obs_per_point): the path's, a larger
# selection than a block's 256 threads, other observation counts
POINT_SELECTIONS = {"20x8": (20, 8), "300x8": (300, 8), "64x4": (64, 4),
                "20x12": (20, 12)}


@pytest.mark.parametrize("scene", list(POINT_SCENES))
@pytest.mark.parametrize("method", ["gn", "lm"])
def test_point_kernel_matches_plain(card, scene, method):
    """point_gn_kernel against the plain version (ATen on the card) at the
    path's shapes (8,192 landmarks of 8 observations, 16 keyframes, 20
    selected, 5 iterations), two seeds each, by
    `silicon_gate.compare_points`: each landmark's final cost (float64)
    never above its start, and for a regular start system between the
    plain version's in float32 and in float64, widened by 1e-2; the rest
    of the arena and every stamp equal."""
    from android_svo_tpu_torch.ops import point_gn
    cfg = silicon_gate.point_config(method)
    for seed in (1, 2):
        args = silicon_gate.point_operands(*silicon_gate.point_inputs(
            seed, cfg, device=card, **POINT_SCENES[scene]), cfg)
        point_gn.reset_launch_counts()
        detail, failures = silicon_gate.compare_points(
            args, cfg.structureoptim_n_iter, method == "lm")
        torch.cuda.synchronize()
        assert point_gn.LAUNCHES["point_gn_kernel"] == 1
        assert not failures, (detail, failures)
        if scene == "none_live":
            assert detail["landmarks"] == 0


@pytest.mark.parametrize("shape", list(POINT_SELECTIONS))
@pytest.mark.parametrize("n_iter", [0, 1, 10])
def test_point_kernel_matches_plain_at_other_shapes(card, shape, n_iter):
    """The same check with other selections, observation counts and
    iteration counts (GN and LM), one seed each."""
    n_sel, n_obs = POINT_SELECTIONS[shape]
    for method in ("gn", "lm"):
        cfg = silicon_gate.point_config(
            method, structureoptim_max_pts=n_sel, max_obs_per_point=n_obs,
            structureoptim_n_iter=n_iter)
        args = silicon_gate.point_operands(*silicon_gate.point_inputs(
            3, cfg, device=card), cfg)
        detail, failures = silicon_gate.compare_points(args, n_iter,
                                                       method == "lm")
        assert not failures, (method, detail, failures)
        assert detail["landmarks"] == n_sel


def test_point_kernel_batched_matches_single_launches(card):
    """torch.func.vmap over the stage on 11 sequences is ONE launch, and
    each sequence's arena equals its own single launch bit for bit: each
    landmark sums in an order that does not depend on the batch.  Each
    sequence is within `compare_points` of the plain version, GN and LM."""
    from android_svo_tpu_torch.core import point_opt
    from android_svo_tpu_torch.core import state as st
    from android_svo_tpu_torch.ops import point_gn
    for method in ("gn", "lm"):
        cfg = silicon_gate.point_config(method)
        scenes = [silicon_gate.point_inputs(
            10 + s, cfg, live_share=0.3 + 0.05 * s,
            outliers=0.02 * (s % 3), device=card) for s in range(11)]
        stacked = [st.stack_states([sc[i] for sc in scenes])
                   for i in range(3)]
        point_gn.reset_launch_counts()
        out = torch.func.vmap(lambda p, k, f: point_opt.optimize_structure(
            p, k, f, cfg))(*stacked)
        torch.cuda.synchronize()
        assert point_gn.LAUNCHES["point_gn_kernel"] == 1
        for b, sc in enumerate(scenes):
            one = point_opt.optimize_structure(*sc, cfg)
            assert torch.equal(out.pos[b], one.pos), b
            assert torch.equal(out.last_optim[b], one.last_optim), b
            _, failures = silicon_gate.compare_points(
                silicon_gate.point_operands(*sc, cfg),
                cfg.structureoptim_n_iter, method == "lm")
            assert not failures, (method, b, failures)


@pytest.mark.parametrize("batched", [False, True])
def test_point_kernel_launches_once_and_reads_nothing_back(card, batched):
    """One stage (a frame, or a vmapped batch of 11) is exactly one launch
    of point_gn_kernel and one `point_gn_launches`; a frame's stage (the
    selection and the launch) is at most 12 ATen ops, and the op alone two
    output allocations and one device activity; nothing in it reads the
    device back.  With use_pallas off the plain version runs on the card
    and launches nothing."""
    from android_svo_tpu_torch.core import point_opt
    from android_svo_tpu_torch.core import state as st
    from android_svo_tpu_torch.ops import point_gn
    from android_svo_tpu_torch.utils import profiling
    cfg = silicon_gate.point_config()
    if batched:
        scenes = [silicon_gate.point_inputs(30 + s, cfg, device=card)
                  for s in range(11)]
        stacked = [st.stack_states([sc[i] for sc in scenes])
                   for i in range(3)]

        def call(c):
            return torch.func.vmap(lambda p, k, f: point_opt.
                                   optimize_structure(p, k, f, c))(*stacked)
    else:
        inputs = silicon_gate.point_inputs(30, cfg, device=card)

        def call(c):
            return point_opt.optimize_structure(*inputs, c)
    call(cfg)                                   # warm
    torch.cuda.synchronize()
    n_ops, _ = silicon_gate.dispatch_counts(lambda: call(cfg))
    assert batched or n_ops <= silicon_gate.POINT_STAGE_OPS, n_ops
    if not batched:
        args = silicon_gate.point_operands(*inputs, cfg)
        n_ops, n_dev = silicon_gate.dispatch_counts(
            lambda: point_gn.point_gn(*args, 5, False))
        assert (n_ops, n_dev) == (2, 1)
    point_gn.reset_launch_counts()
    assert not silicon_gate.host_reads(lambda: call(cfg))
    assert point_gn.LAUNCHES["point_gn_kernel"] == 1
    mon = profiling.install()
    try:
        call(cfg)
    finally:
        profiling.uninstall()
    assert mon.counters["point_gn_launches"] == 1
    call(cfg.replace(use_pallas=False))
    torch.cuda.synchronize()
    assert point_gn.LAUNCHES["point_gn_kernel"] == 2


def test_point_kernel_refuses_other_types(card):
    """On the card the wrapper converts nothing: float64 positions, int64
    keyframe slots, int32 selected slots, a strided bearing array or a
    selection on the CPU raise before any launch."""
    from android_svo_tpu_torch.ops import point_gn
    cfg = silicon_gate.point_config()
    args = list(silicon_gate.point_operands(
        *silicon_gate.point_inputs(40, cfg, device=card), cfg))

    def with_(i, x):
        return (*args[:i], x, *args[i + 1:], 5, False)

    point_gn.reset_launch_counts()
    with pytest.raises(TypeError):
        point_gn.point_gn(*with_(0, args[0].double()))
    with pytest.raises(TypeError):
        point_gn.point_gn(*with_(2, args[2].long()))
    with pytest.raises(TypeError):
        point_gn.point_gn(*with_(7, args[7].int()))
    with pytest.raises(ValueError):
        point_gn.point_gn(*with_(3, torch.cat([args[3], args[3]], -1)
                                 [..., ::2]))
    with pytest.raises(ValueError):
        point_gn.point_gn(*with_(8, args[8].cpu()))
    with pytest.raises(ValueError):
        point_gn.point_gn(*with_(1, args[1][:-1]))
    assert point_gn.LAUNCHES["point_gn_kernel"] == 0


def test_point_kernel_once_per_frame_and_per_step(card):
    """On the tracking path: one point_gn_kernel launch per tracked frame
    of the handler, keyframes included, and one per batched step of 11
    sequences; the stage's arena there within `compare_points` of the
    plain version on the same state."""
    from android_svo_tpu_torch.config import SVOConfig
    from android_svo_tpu_torch.core import frame_handler as fh
    from android_svo_tpu_torch.core import pipeline
    from android_svo_tpu_torch.core import state as st
    from android_svo_tpu_torch.data import synthetic
    from android_svo_tpu_torch.ops import point_gn
    from android_svo_tpu_torch.parallel.multi_seq import make_batched_track
    cam = synthetic.default_camera(320, 240)
    tex = synthetic.make_texture(torch.Generator().manual_seed(3), 1024)
    imgs = [synthetic.render(tex, cam, synthetic.lookdown_pose(
        0.05 * i, 0.015 * i, -3.0, (0.45 + 0.002 * i, -0.002 * i,
                                    0.004 * i))) for i in range(11)]
    cfg = SVOConfig(init_min_disparity=20.0, loba_n_iter=0)
    handler = fh.FrameHandler(cam, cfg)
    for img in (imgs[0], imgs[4]):
        handler.add_image(img)
    assert handler.stage == fh.STAGE_DEFAULT_FRAME
    point_gn.reset_launch_counts()
    results = [handler.add_image(img).result for img in imgs[5:10]]
    torch.cuda.synchronize()
    assert pipeline.RES_FAILURE not in results
    assert point_gn.LAUNCHES["point_gn_kernel"] == len(results)
    vo = handler.vo
    args = silicon_gate.point_operands(vo.points, vo.kfs, vo.frame_id, cfg)
    assert int(args[8].sum()) > 0
    detail, failures = silicon_gate.compare_points(
        args, cfg.structureoptim_n_iter, False)
    assert not failures, (detail, failures)
    track = make_batched_track(cfg, handler.cam, handler.dims)
    vo_b = st.stack_states([handler.vo] * 11)
    point_gn.reset_launch_counts()
    track(vo_b, torch.stack([imgs[10]] * 11))
    torch.cuda.synchronize()
    assert point_gn.LAUNCHES["point_gn_kernel"] == 1


# The 1D alignment on the edgelet cell's timed path (`tum_fr3_edgelet.
# replay`) against the benchmark's float64 reference (`svo_bench/
# reference/align1d.py`), every `align1d_stack` call of the window's first
# 60 frames (about 11,700 valid rows, all of them seeds: no landmark of
# this scene is an edgelet, so the matching passes route no row).
# Tolerances, from the cell's readings on three seeds (NVIDIA H100 80GB
# HBM3, 700 W):
#   A1D_UV_TOL    widest uv distance where both sides converge, level px:
#                 the program reads 0.0053-0.0152 (float32 rounding that a
#                 row near the edge of its basin amplifies), the bfloat16
#                 image control 1.46-5.94
#   A1D_FLIP_TOL  share of valid rows whose `converged` differs: a flip
#                 needs a row to end within rounding of the level's margin
#                 or of the drift limit; the program flipped none of
#                 34,807 rows, the control 1-4 in each seed's ~11,600
#                 (8.8e-5 to 3.4e-4; 3.4e-4 on this test's seed)
A1D_FRAMES = 60
A1D_SEED = 3417200101
A1D_UV_TOL = 0.1
A1D_FLIP_TOL = 1e-4


def capture_align1d(seed, frames=A1D_FRAMES, device="cuda"):
    """The edgelet cell set up and warmed from `seed` as `svo_bench.run`
    does, then `frames` frames with the span recorder on: every
    `align1d_stack` call as (caller, args, outputs), each frame's counters
    and result, the sampler's and `align_iclk_kernel`'s launches, and the
    live landmarks with the share of them that are edgelets."""
    import sys

    from android_svo_tpu_torch.ops import matcher
    from android_svo_tpu_torch.ops.detect import FTYPE_EDGELET
    from android_svo_tpu_torch.utils import profiling
    from svo_bench import cells, drivers
    cell = cells.find_cell("tum_fr3_edgelet.replay")
    driver = drivers.ReplayDriver(cell.config, cell.traffic, seed,
                                  torch.device(device), 1.0)
    calls, units = [], []
    orig = matcher.align1d_stack

    def captured(*args, **kw):
        out = orig(*args, **kw)
        calls.append((sys._getframe(1).f_code.co_name, args, out))
        return out

    try:
        driver.warm()
        launches0 = dict(driver.pk.LAUNCHES)
        matcher.align1d_stack = captured
        mon = profiling.install()
        try:
            units = [driver.unit(False) for _ in range(frames)]
        finally:
            profiling.uninstall()
            matcher.align1d_stack = orig
        launches = {k: v - launches0[k] for k, v in driver.pk.LAUNCHES.items()}
        pts = driver.handler.vo.points
        live = int(pts.valid.sum())
        edge = int((pts.valid & (pts.ref_type == FTYPE_EDGELET)).sum())
        camera = driver.handler.cam
    finally:
        driver.close()
    return dict(calls=calls, units=units, counts=mon.unit_counts[-frames:],
                launches=launches, live=live, edge_share=edge / max(live, 1),
                distortion_free=camera.distortion_free)


def align1d_readings(calls):
    """The program's and the control's gaps to the float64 reference over
    the calls: widest uv gap where both converge, flips pooled over the
    valid rows."""
    from svo_bench.reference import align1d as ref
    out = {}
    for side in ("program", "control"):
        gap, flips, rows, both = 0.0, 0, 0, 0
        for _, args, got in calls:
            want = ref.align1d(*args)
            if side == "control":
                got = ref.align1d(*args, *ref.CONTROL)
            g = ref.gaps(got, want, args[7])
            gap = max(gap, g["uv_gap_px"])
            flips += round(g["flip_share"] * g["rows"])
            rows += g["rows"]
            both += g["both"]
        out[side] = {"uv_gap_px": gap, "flip_share": flips / max(rows, 1),
                     "rows": rows, "both": both}
    return out


def test_align1d_on_the_edgelet_cell_holds_to_the_reference(card):
    """The cell's camera is distortion-free; on every frame the 1D loop
    runs (`align1d_iters`: 10 for each call, from the matching passes and
    the seed update) and `align_iclk_kernel` never launches; every call
    holds to the reference within the tolerances and the control fails
    each of them."""
    cap = capture_align1d(A1D_SEED)
    assert cap["distortion_free"]
    assert all(u["ok"][0] for u in cap["units"])
    callers = {c for c, _, _ in cap["calls"]}
    assert callers == {"_align_direct", "find_epipolar_match"}
    assert all(c.get("align1d_iters", 0) >= 30 for c in cap["counts"])
    assert sum(c["align1d_iters"] for c in cap["counts"]) == 10 * len(
        cap["calls"])
    assert cap["launches"]["align_iclk_kernel"] == 0
    assert cap["launches"]["sample_patches_kernel"] >= 29 * A1D_FRAMES
    r = align1d_readings(cap["calls"])
    prog, ctl = r["program"], r["control"]
    assert prog["both"] >= 0.5 * prog["rows"] > 0
    assert prog["uv_gap_px"] <= A1D_UV_TOL, r
    assert prog["flip_share"] <= A1D_FLIP_TOL, r
    assert ctl["uv_gap_px"] > A1D_UV_TOL, r
    assert ctl["flip_share"] > A1D_FLIP_TOL, r


# ---------------------------------------------------------------------------
# sparse image alignment's loop in one launch (sparse_align_kernel)
# ---------------------------------------------------------------------------

def _align_scene(seed, camera="radtan", **kw):
    return silicon_gate.align_inputs(seed, camera, **kw)


ALIGN_SCENES = {"typical": ({}, {}), "all_valid": ({"valid_share": 1.0}, {}),
                "few_valid": ({"valid_share": 0.02}, {}),
                "none_valid": ({"valid_share": 0.0}, {}),
                "behind": ({"behind": 0.2}, {}),
                "margin": ({"margin": 0.3}, {}),
                "n_iter_2": ({}, {"img_align_n_iter": 2}),
                "first_stop": ({}, {"img_align_eps": 10.0}),
                "rows_2048": ({"n": 2048}, {}),
                "half_3": ({}, {"img_align_patch_halfsize": 3})}


@pytest.mark.parametrize("scene", list(ALIGN_SCENES))
@pytest.mark.parametrize("camera", ["radtan", "pinhole", "atan"])
@pytest.mark.parametrize("method", ["gn", "lm"])
def test_align_kernel_matches_plain(card, scene, camera, method):
    """sparse_align_kernel against the plain loop (ATen on the card, one
    host read an iteration) on the same inputs: EuRoC's radtan camera at
    912 rows, TUM fr3's distortion-free one at 768, an ATAN camera at 912;
    two seeds each, with `silicon_gate.compare_align`'s tolerances
    (rounding's: only the order of the sums differs): the pose within 0.05
    px of projection gap at level 0, the same n_tracked, chi2 within 1e-4
    relative.  Each level's iteration count is the plain loop's up to the
    first level where the plain loop met a tie: a step whose chi2 lies
    within 1e-4 of the best so far (`plain_align_trace` records each
    iteration's cost beside the best), which rounding may take or refuse.
    With no valid row the start comes back unchanged; with a cap of 2 no
    level runs more than 2 iterations; with eps 10 every level stops at
    its first.  At 2,048 rows, or with 6x6 patches, the reference rows no
    longer fit in shared memory and the kernel reads them in place."""
    from android_svo_tpu_torch.config import SVOConfig
    from android_svo_tpu_torch.ops import sparse_align
    from android_svo_tpu_torch.ops import sparse_align_gn
    scene_kw, cfg_kw = ALIGN_SCENES[scene]
    cfg = SVOConfig(**cfg_kw)
    levels = range(cfg.img_align_max_level, cfg.img_align_min_level - 1, -1)
    for seed in (1, 2):
        args = _align_scene(seed, camera, **scene_kw)
        sparse_align_gn.reset_launch_counts()
        k = sparse_align.sparse_img_align(*args, cfg, method=method)
        its = sparse_align.KERNEL_ITERATIONS.tolist()
        p, its_p, rec = silicon_gate.plain_align_trace(args, cfg, method)
        torch.cuda.synchronize()
        assert sparse_align_gn.LAUNCHES["sparse_align_kernel"] == 1
        detail, failures = silicon_gate.compare_align(k, p, args)
        assert not failures, (failures, detail)
        tie = silicon_gate.first_tie_level(rec, levels)
        assert its[:tie] == its_p[:tie], (its, its_p, tie)
        assert all(1 <= i <= cfg.img_align_n_iter for i in its)
        if scene == "none_valid":
            assert int(k[1]) == 0
            assert torch.equal(k[0].q, args[3].q)
            assert torch.equal(k[0].t, args[3].t)
        if scene == "first_stop":
            assert its == [1] * len(levels)


def test_align_kernel_batched_matches_single_launches(card):
    """The batched step's form (11 frames of 912 rows, every input batched
    but the camera) is ONE launch, and each frame's outputs and iteration
    counts equal its own single launch bit for bit: each block sums in an
    order that does not depend on the batch and stops where its own loop
    stops.  Each frame is within `silicon_gate.compare_align`'s tolerances
    of its plain loop."""
    from android_svo_tpu_torch.config import SVOConfig
    from android_svo_tpu_torch.ops import sparse_align
    from android_svo_tpu_torch.ops import sparse_align_gn
    cfg = SVOConfig()
    scenes = [_align_scene(10 + s, behind=0.02 * (s % 3),
                           margin=0.1 * (s % 2)) for s in range(11)]
    batch = silicon_gate.stack_align_inputs(scenes)
    sparse_align_gn.reset_launch_counts()
    T, n_tr, chi2 = sparse_align.sparse_img_align(*batch, cfg, batched=True)
    its = sparse_align.KERNEL_ITERATIONS.clone()
    torch.cuda.synchronize()
    assert sparse_align_gn.LAUNCHES["sparse_align_kernel"] == 1
    assert len({tuple(r) for r in its.tolist()}) > 1   # they stop apart
    for b, sc in enumerate(scenes):
        T1, n1, c1 = sparse_align.sparse_img_align(*sc, cfg)
        assert torch.equal(T.q[b], T1.q) and torch.equal(T.t[b], T1.t), b
        assert torch.equal(n_tr[b], n1) and torch.equal(chi2[b], c1), b
        assert torch.equal(its[b], sparse_align.KERNEL_ITERATIONS), b
        p = sparse_align.sparse_img_align(*sc, cfg.replace(use_pallas=False))
        _, failures = silicon_gate.compare_align((T1, n1, c1), p, sc)
        assert not failures, (b, failures)
    assert sparse_align_gn.LAUNCHES["sparse_align_kernel"] == 12


@pytest.mark.parametrize("batched", [False, True])
def test_align_kernel_launches_once_and_reads_nothing_back(card, batched):
    """One call (a frame, or a batch of 11) is exactly one launch of
    sparse_align_kernel beside the set-up's sampler launch per level, and
    nothing in it reads the device back: no `aten::item` or
    `aten::_local_scalar_dense`, no device-to-host copy, no wait for the
    card (`silicon_gate.host_reads`).  With use_pallas off the plain loop
    runs on the card and launches neither."""
    from android_svo_tpu_torch.config import SVOConfig
    from android_svo_tpu_torch.ops import patch_kernels as pk
    from android_svo_tpu_torch.ops import sparse_align
    from android_svo_tpu_torch.ops import sparse_align_gn
    cfg = SVOConfig()
    if batched:
        args = silicon_gate.stack_align_inputs(
            [_align_scene(30 + s) for s in range(11)])
    else:
        args = _align_scene(30)

    def call(c):
        return sparse_align.sparse_img_align(*args, c, batched=batched)

    call(cfg)                                   # warm
    torch.cuda.synchronize()
    sparse_align_gn.reset_launch_counts()
    pk.reset_launch_counts()
    assert not silicon_gate.host_reads(lambda: call(cfg))
    assert sparse_align_gn.LAUNCHES["sparse_align_kernel"] == 1
    assert pk.LAUNCHES["sample_patches_kernel"] == 3
    pk.reset_launch_counts()
    call(cfg.replace(use_pallas=False))
    torch.cuda.synchronize()
    assert sparse_align_gn.LAUNCHES["sparse_align_kernel"] == 1
    assert pk.LAUNCHES["sample_patches_kernel"] == 0


def test_align_kernel_refuses_other_types(card):
    """On the card the wrapper converts nothing and takes what the kernel
    takes: float64 points, or a patch half the kernel is not built for,
    raise before any launch of it."""
    from android_svo_tpu_torch.config import SVOConfig
    from android_svo_tpu_torch.ops import sparse_align, sparse_align_gn
    args = list(_align_scene(40))
    cfg = SVOConfig()
    sparse_align_gn.reset_launch_counts()
    bad = list(args)
    bad[5], bad[6] = args[5].double(), args[6].double()
    with pytest.raises(TypeError):
        sparse_align.sparse_img_align(*bad, cfg)
    with pytest.raises(ValueError):
        sparse_align.sparse_img_align(
            *args, cfg.replace(img_align_patch_halfsize=5))
    assert sparse_align_gn.LAUNCHES["sparse_align_kernel"] == 0


def test_align_kernel_once_per_frame_and_per_step(card):
    """On the tracking path: one sparse_align_kernel launch per tracked
    frame of the handler, keyframes included, and one per batched step of
    11 sequences; inside the `sparse_img_align` stage no host read and one
    sampler call per level (the set-up's), with the recorder counting one
    `align_launches` a unit and no `align_iters`."""
    from android_svo_tpu_torch.config import SVOConfig
    from android_svo_tpu_torch.core import frame_handler as fh
    from android_svo_tpu_torch.core import pipeline
    from android_svo_tpu_torch.core import state as st
    from android_svo_tpu_torch.data import synthetic
    from android_svo_tpu_torch.ops import sparse_align_gn
    from android_svo_tpu_torch.parallel.multi_seq import make_batched_track
    from android_svo_tpu_torch.utils import profiling
    cam = synthetic.default_camera(320, 240)
    tex = synthetic.make_texture(torch.Generator().manual_seed(3), 1024)
    imgs = [synthetic.render(tex, cam, synthetic.lookdown_pose(
        0.05 * i, 0.015 * i, -3.0, (0.45 + 0.002 * i, -0.002 * i,
                                    0.004 * i))) for i in range(11)]
    cfg = SVOConfig(init_min_disparity=20.0, loba_n_iter=0)
    n_levels = cfg.img_align_max_level - cfg.img_align_min_level + 1
    handler = fh.FrameHandler(cam, cfg)
    for img in (imgs[0], imgs[4]):
        handler.add_image(img)
    assert handler.stage == fh.STAGE_DEFAULT_FRAME
    track = make_batched_track(cfg, handler.cam, handler.dims)
    vo_b = st.stack_states([handler.vo] * 11)
    sparse_align_gn.reset_launch_counts()
    mon = profiling.install()
    try:
        results = [handler.add_image(img).result for img in imgs[5:10]]
        track(vo_b, torch.stack([imgs[10]] * 11))
        torch.cuda.synchronize()
    finally:
        profiling.uninstall()
    assert pipeline.RES_FAILURE not in results
    assert sparse_align_gn.LAUNCHES["sparse_align_kernel"] == len(results) + 1
    spans = mon.spans()
    for u in range(mon.unit + 1):
        assert mon.unit_counts[u].get("align_launches") == 1
        assert "align_iters" not in mon.unit_counts[u]
        (stage,) = [i for i, s in enumerate(spans)
                    if s.unit == u and s.name == "sparse_img_align"]
        inside = [s.name for s in spans if s.unit == u
                  and _inside(spans, stage, s)]
        assert not [n for n in inside if n.startswith("host_read.")]
        assert inside.count("patch.sample_patches") == n_levels


def _inside(spans, i, s):
    p = s.parent
    while p >= 0:
        if p == i:
            return True
        p = spans[p].parent
    return False


def test_align_kernel_and_plain_loop_track_the_replay_scene(card):
    """The replay cell's scene (`euroc_mh01_noloba.replay`), set up and
    warmed from one seed as the benchmark does, then its first 120 frames
    tracked with the loop on the kernel and again with the plain loop (the
    rest of the path on its kernels both times): each trajectory's ATE
    against the scene's positions is at most 0.02 (PERF.md's limit)."""
    from android_svo_tpu_torch.ops import sparse_align
    from svo_bench import cells, check, drivers
    cell = cells.find_cell("euroc_mh01_noloba.replay")
    ates = {}
    for side in ("kernel", "plain"):
        orig = sparse_align.cfg_use_pallas
        if side == "plain":
            sparse_align.cfg_use_pallas = lambda cfg: False
        driver = drivers.ReplayDriver(cell.config, cell.traffic, 2718281829,
                                      torch.device("cuda"), 1.0)
        try:
            driver.warm()
            est, gt = [], []
            for _ in range(120):
                u = driver.unit(False)
                assert u["ok"][0]
                est.append(u["pose"][0][7:10])
                gt.append(driver.position(u["g"][0]))
        finally:
            driver.close()
            sparse_align.cfg_use_pallas = orig
        ates[side] = check.pose_numbers(est, gt)["ate_m"]
    assert all(a <= 0.02 for a in ates.values()), ates
