"""The local BA cell (`euroc_v102.fast`): its metrics, its check on the CPU
at a small size (sound: correct; the control in the patch functions' place,
or local BA without its fixed neighbour keyframes: not), and on a card every
`local_ba` call of a window of the cell at its own size held to the float64
reference `svo_bench/reference/local_ba.py`, the calls rerun with the
landmark blocks in bfloat16 as the control (and in TF32, reported)."""

import json
import shutil
from pathlib import Path

import pytest

from svo_bench import cells, run

ROOT = Path(__file__).resolve().parents[2]
CELL = "euroc_v102.fast"


def test_the_cell_reports_its_metrics():
    cell = cells.find_cell(CELL)
    assert cell.config["svo_config"] == {"loba_fix_neighbour_kfs": True}
    assert cell.traffic["warm"]["local_ba"] == 2
    assert cell.traffic["trace"]["local_ba"] == 1
    assert [m["name"] for m in cell.end_to_end] == [
        "frames_per_s", "frame_ms_p95", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == [
        "local_ba_activities", "local_ba_device_ms",
        "activities_per_frame.v102", "idle_share.v102"]
    stretch = {"ranges": {"local_ba": [(3000, 2500.0), (4000, 3500.0)]}}
    assert cells.load_reader("local_ba_activities")(
        {"stretch": stretch}) == 3500
    assert cells.load_reader("local_ba_device_ms")(
        {"stretch": stretch}) == pytest.approx(3.0)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """A checkout of the harness with the cell at half EuRoC's resolution
    (the bootstrap's disparity halved with it), a check that samples the
    window's first frames, and beside it the configuration without the
    fixed neighbours.  Two threads: the test processes share the host."""
    import torch
    torch.set_num_threads(2)
    root = tmp_path_factory.mktemp("small")
    shutil.copytree(ROOT / "svo_bench", root / "svo_bench")
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    path = root / "svo_bench" / "configs" / "euroc_v102.json"
    cfg = json.loads(path.read_text())
    cam = cfg["camera"]
    fx, fy, cx, cy = cam["intrinsics"]
    cam["resolution"] = [376, 240]
    cam["intrinsics"] = [fx / 2, fy / 2, (cx + 0.5) / 2 - 0.5,
                         (cy + 0.5) / 2 - 0.5]
    cfg["svo_config"] = {**cfg["svo_config"], "init_min_disparity": 20.0}
    path.write_text(json.dumps(cfg))
    cfg["svo_config"]["loba_fix_neighbour_kfs"] = False
    (path.parent / "euroc_v102_free.json").write_text(json.dumps(cfg))
    path = root / "svo_bench" / "traffic" / "fast.json"
    mix = json.loads(path.read_text())
    mix["check"] = {"units": 2, "span": 3, "pose_units": 40}
    path.write_text(json.dumps(mix))
    b["workloads"].append({"name": "euroc_v102_free.fast",
                           "config": "euroc_v102_free", "traffic": "fast",
                           "chips": 1, "why": "x"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    shutil.copy(root / "svo_bench" / "limits" / f"{CELL}.json",
                root / "svo_bench" / "limits" / "euroc_v102_free.fast.json")
    return root


@pytest.mark.parametrize("case,units", [("sound", 40), ("control", 40),
                                        ("free_scale", 150)])
def test_the_check_holds_the_cell(small, case, units):
    """Sound: correct.  The control in the patch functions' place:
    `sample_gap` fails.  Local BA without its fixed neighbour keyframes
    (the JAX package's rule): the scale runs away and tracking fails."""
    res = run.execute("euroc_v102_free.fast" if case == "free_scale"
                      else CELL, 2147483659, 0.1, False, device="cpu",
                      control=2 if case == "control" else 0,
                      min_units=units, root=small, log=lambda m: None)
    failing = [k for k, c in res["compared"].items()
               if c["value"] is None or c["value"] > c["limit"]]
    assert res["correct"] is (case == "sound"), failing
    if case == "control":
        assert "sample_gap" in failing
    if case == "free_scale":
        assert {"failures", "ate_m"} & set(failing)


def capture_local_ba(seed: int, n_frames: int):
    """Every `local_ba` call of the cell's first `n_frames` window frames on
    the card, at the cell's own size: (inputs, outputs) as the handler
    passed and got them, with the driver's warm-up first."""
    import torch

    from android_svo_tpu_torch.core import frame_handler as fh
    from svo_bench import drivers
    cell = cells.find_cell(CELL)
    d = drivers.ReplayDriver(cell.config, cell.traffic, seed,
                             torch.device("cuda"), 10.0)
    calls, real = [], fh.local_ba

    def spy(*args, **kw):
        out = real(*args, **kw)
        calls.append(([a.clone() if torch.is_tensor(a) else a
                       for a in args], dict(kw), out))
        return out

    try:
        d.warm()
        fh.local_ba = spy
        for _ in range(n_frames):
            d.unit(False)
    finally:
        fh.local_ba = real
        d.close()
    return calls


def hold_calls(calls, control=None) -> list:
    """Each call's gaps to the float64 reference (`reference/local_ba.py`:
    `LIMITS`): after 1 iteration (the program rerun at `loba_n_iter` 1 on
    the captured inputs) the camera twists and the landmarks, after the
    cell's 5 (the captured outputs, or rerun under a control) the stored
    poses and landmarks.  `control`: "tf32", the program's einsums on the
    card's TF32 tensor cores; "bf16", its landmark blocks U_p rounded to
    bfloat16 before their inversion."""
    import torch

    from android_svo_tpu_torch.parallel import ba
    from svo_bench.reference import local_ba as ref
    out, dxs, solve, inv = [], [], ba._ba_solve, ba.inv_spd

    def spy(*args):
        dxs.append(solve(*args))
        return dxs[-1]

    before = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = control == "tf32"
        if control == "bf16":
            ba.inv_spd = lambda U: inv(U.to(torch.bfloat16).to(U.dtype))
        ba._ba_solve = spy
        for args, kw, got in calls:
            pos, valid, obs_kf, obs_f, q, t, core, fixed, focal, cfg = args
            inputs = dict(pos=pos, q=q, t=t)
            row = {}
            for n_iter in (1, cfg.loba_n_iter):
                dxs.clear()
                res = got if n_iter == cfg.loba_n_iter and control is None \
                    else ba.local_ba(*args[:9],
                                     cfg.replace(loba_n_iter=n_iter), **kw)
                want = ref.local_ba(pos, valid, obs_kf, obs_f, q, t, core,
                                    fixed, float(focal),
                                    cfg.loba_robust_huber_width, n_iter,
                                    kw.get("kf_valid"))
                got_d = dict(q=res[0], t=res[1], pos=res[2])
                if n_iter == 1:
                    row[1] = {
                        "cam_gap": ref.increment_gap(dxs[0], want["dx"][0]),
                        "point_gap": ref.gaps(inputs, got_d, want,
                                              core)["point_gap"]}
                else:
                    g = ref.gaps(inputs, got_d, want, core,
                                 floor=ref.POSE_FLOOR)
                    row[n_iter] = {k: g[k] for k in ("cam_gap", "point_gap",
                                                     "cam_move",
                                                     "point_move")}
            out.append(row)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
        ba._ba_solve, ba.inv_spd = solve, inv
    return out


def _fails(row) -> bool:
    from svo_bench.reference import local_ba as ref
    return any(row[n][k] > lim for n, lims in ref.LIMITS.items()
               for k, lim in lims.items())


@pytest.mark.cuda
def test_local_ba_matches_the_reference_on_the_cell():
    """Every `local_ba` call of the cell's first 120 window frames on the
    card, at the cell's sizes (2,048 landmarks, 5 core keyframes), lies
    within the limits of the float64 reference after 1 and after 5
    iterations; rerun with its landmark blocks in bfloat16, every call
    fails them.  TF32 einsums are read and reported: at the cell's tiny
    camera twists they part from the reference about as much as fp32
    does."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    calls = capture_local_ba(3000000019, 120)
    assert len(calls) >= 12
    sound = hold_calls(calls)
    control = hold_calls(calls, "bf16")
    print(json.dumps({"calls": len(calls), "sound": sound,
                      "control": control, "tf32": hold_calls(calls, "tf32")}))
    assert not any(_fails(r) for r in sound), sound
    assert all(_fails(r) for r in control), control
