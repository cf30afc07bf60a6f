"""The two ways a traffic mix drives the program (its `driver` key).

  replay   one camera stream, closed loop: set-up renders the pre-roll and
           one lap of the orbit, writes them as 8-bit PNGs in an ASL tree
           under TMPDIR, loads it with `data/euroc.py::load_euroc`, and
           feeds it lap after lap through `data/native_feeder.py::
           NativeFrameFeeder` into `core/frame_handler.py::FrameHandler.
           add_image`.  A unit is one frame, from asking the feeder for it
           to its pose on the host.
  batched  `sequences` streams in a closed loop of batched steps
           (`parallel/multi_seq.py::make_batched_track`): set-up renders
           each sequence's pre-roll and lap on the card, bootstraps each in
           its own handler and stacks the states.  A unit is one step, from
           gathering its frames to the sequences' poses on the host.

Both make their inputs from the seed with the reference's generators
(`reference/scene.py`) and give the check each unit's positions with the
ground truth they were rendered from.
"""

from __future__ import annotations

import math
import os
import shutil
import struct
import tempfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch.profiler import record_function

from svo_bench.reference import scene


def write_png(path: str, img: np.ndarray) -> None:
    """An 8-bit grayscale PNG: one IHDR, one IDAT (no row filter, zlib level
    1), IEND."""
    h, w = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
                + chunk(b"IEND", b""))


def write_asl(root: str, frames: np.ndarray, camera: dict) -> None:
    """cam0 of an ASL tree: the PNGs, data.csv and sensor.yaml."""
    cam_dir = os.path.join(root, "mav0", "cam0")
    os.makedirs(os.path.join(cam_dir, "data"))
    step_ns = int(round(1e9 / camera["rate_hz"]))
    stamps = [1_403_636_579_763_555_584 + i * step_ns
              for i in range(len(frames))]
    # zlib lets go of the interpreter while it compresses
    with ThreadPoolExecutor(4) as pool:
        list(pool.map(lambda i: write_png(os.path.join(
            cam_dir, "data", f"{stamps[i]}.png"), frames[i]),
            range(len(frames))))
    rows = [f"{stamp},{stamp}.png" for stamp in stamps]
    with open(os.path.join(cam_dir, "data.csv"), "w") as f:
        f.write("#timestamp [ns],filename\n" + "\n".join(rows) + "\n")

    def seq(vals):
        return "[" + ", ".join(repr(v) for v in vals) + "]"

    with open(os.path.join(cam_dir, "sensor.yaml"), "w") as f:
        f.write("sensor_type: camera\n"
                f"rate_hz: {camera['rate_hz']}\n"
                f"resolution: {seq(camera['resolution'])}\n"
                "camera_model: pinhole\n"
                f"intrinsics: {seq(camera['intrinsics'])}\n"
                "distortion_model: radial-tangential\n"
                f"distortion_coefficients: "
                f"{seq(camera['distortion_coefficients'])}\n")


def _range(name: str, on: bool):
    return record_function(name) if on else nullcontext()


class Scene:
    """A sequence's inputs: its texture, its pre-roll and lap poses, and the
    8-bit frames rendered from them ((n_pre + lap, H, W) uint8 on the
    device); global frame g is pre-roll frame g, then lap frame
    (g - n_pre) mod lap, seen from where the path has moved on to by then
    (a traverse's texture tiles the plane, so its frames repeat a lap on
    while its positions do not)."""

    def __init__(self, config, traffic, s, gen, rays, phase0):
        cam = config["camera"]
        w, h = cam["resolution"]
        tiled = traffic.get("path") == "traverse"
        tex = scene.make_texture(gen, int(traffic["texture_size"]), tiled)
        self.lap = scene.lap_poses(traffic, s, phase0)
        self.pre = scene.preroll_poses(traffic, self.lap[0])
        self.poses = self.pre + self.lap
        self.offset = scene.lap_offset(traffic)
        self.frames = scene.render_poses(tex, rays, self.poses, (h, w),
                                         float(traffic["tex_scale"]),
                                         wrap=tiled)
        self.n_pre = len(self.pre)

    def index(self, g: int) -> int:
        return g if g < self.n_pre else (
            self.n_pre + (g - self.n_pre) % len(self.lap))

    def position(self, g: int) -> tuple:
        laps = max(g - self.n_pre, 0) // len(self.lap)
        return tuple(p + laps * d for p, d in
                     zip(self.poses[self.index(g)][1], self.offset))


def _cfg(config):
    from android_svo_tpu_torch.config import SVOConfig
    return SVOConfig(**config.get("svo_config", {}))


def _scenes(config, traffic, seed, device, n_seq):
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    rays = scene.camera_rays(config["camera"], device)
    phase0 = scene.phase_offset(seed) if traffic.get("seed_phase") else 0.0
    return [Scene(config, traffic, s, gen, rays, phase0) for s in range(n_seq)]


class ReplayDriver:
    unit_name = "frame"

    def __init__(self, config, traffic, seed, device, seconds):
        from android_svo_tpu_torch.core import frame_handler as fh
        from android_svo_tpu_torch.core import pipeline
        from android_svo_tpu_torch.data import euroc, native_feeder
        from android_svo_tpu_torch.ops import patch_kernels
        self.fh, self.pipeline, self.pk = fh, pipeline, patch_kernels
        self.traffic = traffic
        self.units_per_step = 1
        (self.scene,) = _scenes(config, traffic, seed, device, 1)
        self.tmp = tempfile.mkdtemp(prefix="svo_bench_")
        write_asl(self.tmp, self.scene.frames.cpu().numpy(), config["camera"])
        seq = euroc.load_euroc(self.tmp, device=device)
        paths = seq.paths()
        n_pre, lap = self.scene.n_pre, len(self.scene.lap)
        # lap after lap, more than the window can take
        laps = 2 + math.ceil(seconds * traffic["max_fps"] / lap)
        self.feeder = native_feeder.NativeFrameFeeder(
            paths[:n_pre] + paths[n_pre:] * laps, device=device)
        self.it = iter(self.feeder)
        self.dt = 1.0 / config["camera"]["rate_hz"]
        self.handler = fh.FrameHandler(seq.camera, _cfg(config), device=device)
        self.g = 0

    # -- units ---------------------------------------------------------------
    def unit(self, traced: bool) -> dict:
        """One frame through the feeder and the handler, its pose read back
        to the host."""
        with _range("svo_bench.frame", traced):
            g, frame = next(self.it)
            res = self.handler.add_image(frame, g * self.dt)
            pose = None
            if res.t_wc is not None:
                pose = torch.cat([res.T_cw.q.reshape(-1),
                                  res.T_cw.t.reshape(-1),
                                  res.t_wc.reshape(-1)]).cpu().numpy()
        self.g = g + 1
        pipeline = self.pipeline
        return {"g": [g], "pose": [pose], "result": [res.result],
                "ok": [pose is not None and res.result != pipeline.RES_FAILURE],
                "keyframe": res.result == pipeline.RES_IS_KEYFRAME,
                "default": self.handler.stage == self.fh.STAGE_DEFAULT_FRAME}

    def warm(self) -> None:
        """Bootstrap on the pre-roll, then track until `warm.keyframes`
        keyframes have been inserted, local BA has run `warm.local_ba`
        times and `warm.after_keyframe` frames have followed the last
        keyframe: every shape of the window is then built."""
        w = self.traffic["warm"]
        since_kf = n = kfs = 0
        while True:
            u = self.unit(False)
            n += 1
            if not u["default"]:
                if n > w["max_frames"]:
                    raise RuntimeError(f"no bootstrap in {n} frames")
                continue
            kfs += u["keyframe"]
            since_kf = 0 if u["keyframe"] else since_kf + 1
            if (kfs >= w.get("keyframes", 0)
                    and self.handler.n_local_ba >= w["local_ba"]
                    and since_kf >= w["after_keyframe"]):
                return
            if n > w["max_frames"]:
                raise RuntimeError(
                    f"warm-up: {kfs} keyframes and {self.handler.n_local_ba}"
                    f" local BA runs in {n} frames")

    # -- what the check and the readers take ---------------------------------
    def position(self, g: int, s: int = 0) -> tuple:
        return self.scene.position(g)

    def local_ba_runs(self) -> int:
        return self.handler.n_local_ba

    def stacks(self) -> tuple:
        """The stack the program made of the last frame, and that frame's
        8-bit image."""
        return ([self.handler.vo.last.stack],
                [self.scene.frames[self.scene.index(self.g - 1)]])

    def feeder_wait_s(self) -> float:
        return self.feeder.wait_s

    def set_perf_mon(self, on: bool) -> None:
        from android_svo_tpu_torch.utils.profiling import PerformanceMonitor
        self.handler.perf_mon = PerformanceMonitor() if on else None

    def break_step(self, fault: str) -> None:
        """Plant a fault in the timed path (the benchmark's own tests)."""
        track = self.handler._track

        def frozen(vo, img):
            _, out = track(vo, img)
            T = vo.last.T_fw
            return vo, {**out, "T_cw": T, "t_wc": T.inverse().t}

        def moved(vo, img):
            vo, out = track(vo, img)
            shift = torch.tensor([0.3, 0.0, 0.0], device=out["t_wc"].device)
            return vo, {**out, "t_wc": out["t_wc"] + shift * (
                int(vo.frame_id) % 2)}

        self.handler._track = {"frozen_step": frozen,
                               "altered_pose": moved}[fault]

    def close(self) -> None:
        self.feeder.close()
        shutil.rmtree(self.tmp, ignore_errors=True)


class BatchedDriver:
    unit_name = "step"

    def __init__(self, config, traffic, seed, device, seconds):
        from android_svo_tpu_torch.core import frame_handler as fh
        from android_svo_tpu_torch.core import pipeline
        from android_svo_tpu_torch.core import state as st
        from android_svo_tpu_torch.geometry.camera import PinholeCamera
        from android_svo_tpu_torch.ops import patch_kernels
        from android_svo_tpu_torch.parallel.multi_seq import make_batched_track
        self.pk, self.pipeline, self.traffic = patch_kernels, pipeline, traffic
        n_seq = int(config["sequences"])
        self.units_per_step = n_seq
        self.scenes = _scenes(config, traffic, seed, device, n_seq)
        self.frames = [sc.frames.to(torch.float32) for sc in self.scenes]
        cam = config["camera"]
        w, h = cam["resolution"]
        camera = PinholeCamera.create(w, h, *cam["intrinsics"],
                                      *cam["distortion_coefficients"],
                                      device=device)
        cfg = _cfg(config)
        states, self.g = [], []
        for s, sc in enumerate(self.scenes):
            handler = fh.FrameHandler(camera, cfg, device=device)
            i = 0
            while handler.stage != fh.STAGE_DEFAULT_FRAME:
                if i >= traffic["warm"]["max_frames"]:
                    raise RuntimeError(f"sequence {s}: no bootstrap in {i} "
                                       "frames")
                handler.add_image(self.frames[s][sc.index(i)])
                i += 1
            states.append(handler.vo)
            self.g.append(i)
        self.vo = st.stack_states(states)
        del states, handler
        self.track = make_batched_track(cfg, camera,
                                        st.arena_dims(cfg, w, h))

    def unit(self, traced: bool) -> dict:
        """One batched step: the sequences' next frames gathered, the step,
        the poses and result codes read back to the host."""
        from android_svo_tpu_torch.core import pipeline
        g = list(self.g)
        with _range("svo_bench.step", traced):
            imgs = torch.stack([f[sc.index(gi)] for f, sc, gi
                                in zip(self.frames, self.scenes, g)])
            self.vo, out = self.track(self.vo, imgs)
            host = torch.cat([out["T_cw"].q, out["T_cw"].t, out["t_wc"],
                              out["result"][:, None].to(torch.float32)],
                             dim=1).cpu().numpy()
        self.g = [gi + 1 for gi in g]
        result = host[:, 10].astype(np.int64)
        return {"g": g, "pose": list(host[:, :10]), "result": list(result),
                "ok": list(result != pipeline.RES_FAILURE),
                "keyframe": bool((result == pipeline.RES_IS_KEYFRAME).any()),
                "default": True}

    def warm(self) -> None:
        """`warm.steps` batched steps, and more until one of them inserted a
        keyframe: every shape of the window is then built."""
        w = self.traffic["warm"]
        kf = False
        for n in range(w["max_steps"]):
            kf = self.unit(False)["keyframe"] or kf
            if kf and n + 1 >= w["steps"]:
                return
        raise RuntimeError(f"warm-up: no keyframe in {w['max_steps']} steps")

    def position(self, g: int, s: int) -> tuple:
        return self.scenes[s].position(g)

    def local_ba_runs(self) -> int:
        return 0

    def stacks(self) -> tuple:
        frames = [sc.frames[sc.index(gi - 1)]
                  for sc, gi in zip(self.scenes, self.g)]
        return list(self.vo.last.stack.unbind(0)), frames

    def feeder_wait_s(self):
        return None

    def set_perf_mon(self, on: bool) -> None:
        pass

    def break_step(self, fault: str) -> None:
        """Plant a fault in the timed path (the benchmark's own tests)."""
        from android_svo_tpu_torch.geometry.se3 import SE3
        track = self.track
        half = self.units_per_step // 2

        def frozen(vo, imgs):
            _, out = track(vo, imgs)
            T = SE3(q=vo.last.q_fw, t=vo.last.t_fw)
            return vo, {**out, "T_cw": T, "t_wc": T.inverse().t}

        def half_batch(vo, imgs):
            new, out = track(vo, imgs)
            keep = pytree.tree_map(
                lambda a, b: torch.cat([a[:half], b[half:]]), new, vo)
            T = SE3(q=vo.last.q_fw, t=vo.last.t_fw)
            t_wc = torch.cat([out["t_wc"][:half], T.inverse().t[half:]])
            return keep, {**out, "t_wc": t_wc}

        def moved(vo, imgs):
            vo, out = track(vo, imgs)
            shift = torch.tensor([0.3, 0.0, 0.0], device=out["t_wc"].device)
            return vo, {**out, "t_wc": out["t_wc"] + shift * (
                int(vo.frame_id[0]) % 2)}

        self.track = {"frozen_step": frozen, "half_batch": half_batch,
                      "altered_pose": moved}[fault]

    def close(self) -> None:
        pass


DRIVERS = {"replay": ReplayDriver, "batched": BatchedDriver}
