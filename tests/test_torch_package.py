"""Package-level checks of the PyTorch port: it imports no JAX, its config
mirrors the JAX one, its entry points refuse to fall back to the CPU, the
branches it has not ported raise, and the state converts losslessly."""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from android_svo_tpu.config import SVOConfig as JConfig

from android_svo_tpu_torch.config import SVOConfig
from android_svo_tpu_torch.core import state as st

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
                                   "camera", "texture"])
def test_entry_points_refuse_cpu_fallback(monkeypatch, entry):
    """Without a card, an entry point called without `device` raises
    instead of running on the CPU."""
    from android_svo_tpu_torch.core import frame_handler as fh
    from android_svo_tpu_torch.data import synthetic
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
        else:
            synthetic.make_texture(torch.Generator().manual_seed(0), 64)


def _cpu_cam():
    from android_svo_tpu_torch.data import synthetic
    return synthetic.default_camera(64, 48, device="cpu")


@pytest.mark.parametrize("field,value", [
    ("loba_n_iter", 5), ("poseoptim_method", "lm"),
    ("structureoptim_method", "lm"), ("edgelet_detection", True),
    ("epi_search_1d", True), ("img_align_method", "lm"),
    ("find_match_direct", None)])
def test_unported_branches_raise(field, value):
    from android_svo_tpu_torch.core import frame_handler as fh
    from android_svo_tpu_torch.core import point_opt, pose_opt
    from android_svo_tpu_torch.ops import detect, matcher, sparse_align
    z = torch.zeros
    with pytest.raises(NotImplementedError, match=field.split("_method")[0]
                       if field == "img_align_method" else field):
        if field == "loba_n_iter":
            fh.FrameHandler(_cpu_cam(), SVOConfig(loba_n_iter=value),
                            device="cpu")
        elif field == "poseoptim_method":
            from android_svo_tpu_torch.geometry.se3 import SE3
            pose_opt.optimize_pose(SE3.identity(), z(4, 3), z(4, 3),
                                   z(4, dtype=torch.int32),
                                   z(4, dtype=torch.bool), 420.0,
                                   SVOConfig(poseoptim_method=value))
        elif field == "structureoptim_method":
            point_opt.optimize_points(z(2, 3), z(2, 1, 4), z(2, 1, 3),
                                      z(2, 1, 3), z(2, 1, dtype=torch.bool),
                                      z(2, dtype=torch.bool), 2,
                                      method=value)
        elif field == "edgelet_detection":
            detect.detect_features((z(48, 64),) * 3, None,
                                   SVOConfig(edgelet_detection=value))
        elif field == "epi_search_1d":
            matcher.find_epipolar_match(*([None] * 12),
                                        SVOConfig(epi_search_1d=value))
        elif field == "img_align_method":
            sparse_align.sparse_img_align(None, None, None, None, None, None,
                                          None, None, SVOConfig(), value)
        else:
            matcher.find_match_direct()


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
