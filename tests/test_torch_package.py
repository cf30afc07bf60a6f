"""Package-level checks of the PyTorch port: it imports no JAX, its config
mirrors the JAX one, its entry points refuse to fall back to the CPU, the
default configuration runs, the state converts losslessly, and the trace
monitor writes the JAX monitor's records."""

import ast
import ctypes
import dataclasses
import json
import pathlib
import re

import numpy as np
import pytest
import torch

from android_svo_tpu.config import SVOConfig as JConfig

from android_svo_tpu_torch.config import SVOConfig
from android_svo_tpu_torch.core import state as st

# The tensors here are small and the suite's workers share the machine's
# cores: one intra-op thread per process keeps torch's OpenMP pools from
# oversubscribing them (they slow every worker, the JAX ones included).
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "android_svo_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "android_svo_tpu")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_imports(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


def test_config_matches_jax_field_by_field():
    jf = {f.name: f for f in dataclasses.fields(JConfig)}
    pf = {f.name: f for f in dataclasses.fields(SVOConfig)}
    assert list(jf) == list(pf)
    for name in jf:
        assert jf[name].default == pf[name].default, name
        assert jf[name].type == pf[name].type, name
    a, b = JConfig(), SVOConfig()
    for prop in ("total_pyr_levels", "patch_size", "img_align_patch_size"):
        assert getattr(a, prop) == getattr(b, prop)


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["frame_handler", "init_state",
                                   "camera", "texture", "reloc_demo",
                                   "load_euroc", "load_tum",
                                   "native_feeder", "init_batched_state",
                                   "batched_track", "entry", "make_mesh",
                                   "sharded_rank", "spawn_ranks"])
def test_entry_points_refuse_cpu_fallback(monkeypatch, tmp_path, entry):
    """Without a card, an entry point called without `device` raises
    instead of running on the CPU."""
    from android_svo_tpu_torch.core import frame_handler as fh
    from android_svo_tpu_torch.data import euroc, native_feeder, synthetic
    from android_svo_tpu_torch.data import tum
    from android_svo_tpu_torch.tools import reloc_demo
    from android_svo_tpu_torch import entry as entry_mod
    from android_svo_tpu_torch.parallel import mesh, multi_seq
    from android_svo_tpu_torch.tools import sharded_rank
    _no_cuda(monkeypatch)
    cpu_cam = synthetic.default_camera(64, 48, device="cpu")
    cfg = SVOConfig(loba_n_iter=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "frame_handler":
            fh.FrameHandler(cpu_cam, cfg)
        elif entry == "init_state":
            st.init_state(cfg, 64, 48)
        elif entry == "camera":
            synthetic.default_camera(64, 48)
        elif entry == "texture":
            synthetic.make_texture(torch.Generator().manual_seed(0), 64)
        elif entry == "load_euroc":
            euroc.load_euroc(str(tmp_path))
        elif entry == "load_tum":
            tum.load_tum(str(tmp_path))
        elif entry == "native_feeder":
            native_feeder.NativeFrameFeeder([str(tmp_path / "0.png")])
        elif entry == "init_batched_state":
            st.init_batched_state(cfg, 64, 48, 2)
        elif entry == "batched_track":
            # the state the batched step takes, as a caller would build it
            multi_seq.make_batched_track(cfg, cpu_cam,
                                         st.arena_dims(cfg, 64, 48))
            multi_seq.init_batched_state(cfg, 64, 48, 2)
        elif entry == "entry":
            entry_mod.entry()
        elif entry == "make_mesh":
            mesh.make_mesh(2)
        elif entry == "sharded_rank":
            # the rank raises before it joins a group
            sharded_rank.main(["ba", "0", "1", "tcp://127.0.0.1:1", "1",
                               str(tmp_path / "in.npz"),
                               str(tmp_path / "out.npz")])
        elif entry == "spawn_ranks":
            sharded_rank.spawn_ranks("ba", 1, 1, str(tmp_path / "in.npz"),
                                     str(tmp_path))
        else:
            reloc_demo.run(frames=2, width=64, height=48, trace=None)


def test_microbench_refuses_without_card(monkeypatch):
    """The gather microbench measures the card; without one it raises."""
    from android_svo_tpu_torch.tools import microbench_gather
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA card"):
        microbench_gather.run()


def test_default_config_builds_and_tracks():
    """`FrameHandler(cam, SVOConfig())` — local BA on — builds and tracks.
    Its own bootstrap needs 50 px of disparity, more than this short
    320x240 sweep gives before KLT loses the first frame, so the handler is
    seated on the state of a handler that bootstrapped at 20 px (same
    arenas); from there the default configuration tracks every frame and
    runs local BA after the keyframe it inserts."""
    from android_svo_tpu_torch.core import frame_handler as fh
    from android_svo_tpu_torch.core import pipeline
    from android_svo_tpu_torch.data import synthetic
    cam = synthetic.default_camera(320, 240, device="cpu")
    tex = synthetic.make_texture(torch.Generator().manual_seed(3), 1024,
                                 device="cpu")
    imgs = [synthetic.render(tex, cam, synthetic.lookdown_pose(
        0.05 * i, 0.015 * i, -3.0,
        (0.45 + 0.002 * i, -0.002 * i, 0.004 * i), device="cpu"))
        for i in range(14)]
    boot = fh.FrameHandler(cam, SVOConfig(init_min_disparity=20.0),
                           device="cpu")
    i = 0
    while boot.stage != fh.STAGE_DEFAULT_FRAME:
        boot.add_image(imgs[i])
        i += 1
    handler = fh.FrameHandler(cam, SVOConfig(), device="cpu")
    assert handler.cfg.loba_n_iter == 5
    handler.vo, handler.stage = boot.vo, boot.stage
    results = [handler.add_image(img).result for img in imgs[i:]]
    assert pipeline.RES_FAILURE not in results
    assert pipeline.RES_IS_KEYFRAME in results
    assert handler.n_local_ba >= 1
    assert handler.stage == fh.STAGE_DEFAULT_FRAME


def test_state_numpy_roundtrip_exact():
    cfg = SVOConfig(max_n_kfs=3, max_points=64, max_seeds=32)
    vo = st.init_state(cfg, 64, 48, device="cpu")
    d = st.state_to_numpy(vo)
    rng = np.random.default_rng(0)
    for k, v in d.items():                 # non-trivial contents
        if v.dtype == np.float32:
            d[k] = rng.standard_normal(v.shape).astype(np.float32)
        elif v.dtype == np.int32:
            d[k] = rng.integers(-1, 50, v.shape).astype(np.int32)
        elif v.dtype == np.bool_:
            d[k] = rng.random(v.shape) < 0.5
    back = st.state_to_numpy(st.state_from_numpy(d, device="cpu"))
    assert set(back) == set(d)
    for k in d:
        assert back[k].dtype == d[k].dtype, k
        np.testing.assert_array_equal(back[k], d[k], err_msg=k)


def test_state_keys_match_jax_layout():
    """The numpy dict carries exactly the JAX VOState's field paths."""
    from android_svo_tpu.core import state as jst
    cfg = SVOConfig(max_n_kfs=2, max_points=16, max_seeds=8)
    jvo = jst.init_state(JConfig(**dataclasses.asdict(cfg)), 64, 48)
    keys = set()
    for f in dataclasses.fields(jvo):
        val = getattr(jvo, f.name)
        if dataclasses.is_dataclass(val):
            keys |= {f"{f.name}.{g.name}" for g in dataclasses.fields(val)}
        else:
            keys.add(f.name)
    d = st.state_to_numpy(st.init_state(cfg, 64, 48, device="cpu"))
    assert keys == set(d)
    for k in keys:
        a = np.asarray(eval("jvo." + k))           # noqa: S307
        assert a.shape == d[k].shape and a.dtype == d[k].dtype, k
        np.testing.assert_array_equal(d[k], a, err_msg=k)


def test_tf32_disabled_at_import():
    import android_svo_tpu_torch  # noqa: F401
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_performance_monitor_writes_the_jax_records(tmp_path):
    """The same timer and log calls give the same JSONL keys and logged
    values in both packages' monitors (timings differ)."""
    from android_svo_tpu.utils.profiling import PerformanceMonitor as JPM

    from android_svo_tpu_torch.utils.profiling import PerformanceMonitor

    recs = []
    for cls, name in ((JPM, "jax.jsonl"), (PerformanceMonitor, "port.jsonl")):
        pm = cls(trace_path=str(tmp_path / name))
        for frame in range(3):
            with pm.timer("tot_time"):
                with pm.timer("local_ba" if frame == 1 else "reproject"):
                    sum(range(1000))
            pm.log("frame_id", frame)
            pm.log("n_matches", 10 * frame)
            pm.write_frame()
        pm.close()
        lines = (tmp_path / name).read_text().splitlines()
        recs.append([json.loads(x) for x in lines])
        assert set(pm.summary()) == {"tot_time", "local_ba", "reproject"}
    assert len(recs[0]) == len(recs[1]) == 3
    for a, b in zip(*recs):
        assert list(a) == list(b)
        assert {k: v for k, v in a.items() if not k.startswith("t_")} == {
            k: v for k, v in b.items() if not k.startswith("t_")}


def test_device_trace_writes_a_chrome_trace(tmp_path):
    """`device_trace` profiles its block (host activity here; the card's
    too where there is one) and leaves a Chrome trace in the directory."""
    from android_svo_tpu_torch.utils.profiling import device_trace
    with device_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any("matmul" in e.key for e in prof.key_averages())
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]


_C_KINDS = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
            ctypes.c_longlong: "long long", ctypes.c_float: "float"}


def _launcher_params():
    """name -> the kind of each parameter of every extern "C" launcher
    defined in the port's CUDA sources."""
    found = {}
    for src in sorted((ROOT / "android_svo_tpu_torch" / "csrc").glob("*.cu")):
        text = re.sub(r"//[^\n]*", "", src.read_text())
        for m in re.finditer(r"\bint\s+(launch_\w+)\s*\(([^)]*)\)\s*\{",
                             text):
            assert 'extern "C"' in text[:m.start()], m.group(1)
            kinds = []
            for prm in m.group(2).split(","):
                prm = " ".join(prm.split())
                if "*" in prm:
                    kinds.append("pointer")
                elif prm.startswith("long long "):
                    kinds.append("long long")
                elif prm.startswith(("int ", "float ")):
                    kinds.append(prm.split()[0])
                else:
                    raise AssertionError(f"{m.group(1)}: parameter {prm!r}")
            assert m.group(1) not in found, m.group(1)
            found[m.group(1)] = kinds
    return found


def test_launcher_signatures_match_bindings():
    """Every launcher's C parameters against the ctypes argtypes bound to
    it: the same names, count and pointer / int / long long / float kind
    at each position.  A mismatch passes every CPU test and, on the card,
    cuts a pointer to 32 bits or shifts the arguments."""
    from android_svo_tpu_torch.ops.cuda_build import _SIGNATURES
    params = _launcher_params()
    assert set(params) == set(_SIGNATURES)
    for name, argtypes in _SIGNATURES.items():
        assert [_C_KINDS[a] for a in argtypes] == params[name], name


def test_dispatch_counts_counts_top_level_ops():
    """`dispatch_counts` counts the ATen ops a call dispatches itself, not
    those they call in turn (`unbind` selects each slice)."""
    from android_svo_tpu_torch.utils.profiling import dispatch_counts
    x = torch.ones(4)
    assert dispatch_counts(lambda: (x.data_ptr(), x.stride(), x.shape)) \
        == (0, 0)
    assert dispatch_counts(lambda: torch.empty(3)) == (1, 0)
    assert dispatch_counts(
        lambda: torch.empty((3, 2, 4, 4)).unbind(0)) == (2, 0)


def test_dispatch_counts_looks_through_custom_ops():
    """A patch wrapper's custom op (`svo_torch::*`) is taken only inside
    `torch.func.vmap`, and `dispatch_counts` looks through it: the ATen ops
    its vmap rule dispatches count as the caller's own.  Outside vmap the
    wrapper calls the op's body, and no custom op shows in the profile."""
    from torch.profiler import ProfilerActivity, profile
    from android_svo_tpu_torch.ops import patch_kernels as pk
    from android_svo_tpu_torch.utils.profiling import dispatch_counts
    g = torch.Generator().manual_seed(0)
    stack = torch.rand((2, 3, 40, 48), generator=g)
    lvl = torch.zeros((2, 5), dtype=torch.int32)
    uv = torch.rand((2, 5, 2), generator=g) * 10 + 8
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pk.sample_patches(stack[0], lvl[0], uv[0], 2)
    assert not [e for e in prof.events()
                if e.name.startswith("svo_torch::")]
    n_batched, _ = dispatch_counts(
        lambda: pk.sample_patches_batched(stack, lvl, uv, 2))
    n_vmap, _ = dispatch_counts(lambda: torch.func.vmap(
        lambda s, l, u: pk.sample_patches(s, l, u, 2))(stack, lvl, uv))
    assert n_vmap >= n_batched > 1
