"""EuRoC MAV dataset loader (ASL layout) — port of
`android_svo_tpu/data/euroc.py`, with a writer for the same layout.

Layout (ASL):
  <root>/mav0/cam0/data.csv           timestamp_ns, filename
  <root>/mav0/cam0/data/<stamp>.png   8-bit grayscale images
  <root>/mav0/cam0/sensor.yaml        intrinsics (pinhole radtan)
  <root>/mav0/state_groundtruth_estimate0/data.csv   GT poses (optional)

The camera is the port's `PinholeCamera`, built on the device the caller
asks for (CUDA unless `device="cpu"`; without a card `load_euroc` raises).
Frames, stamps, ground truth and IMU stay on the host.  `frames()` decodes
with PIL; the native feeder (`data/native_feeder.py`) decodes the same
files off the Python thread.  `write_euroc` writes a sequence in this
layout with a dependency-free PNG writer (`write_png`: zlib + struct).
"""

from __future__ import annotations

import csv
import os
import struct
import zlib
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

import numpy as np
import torch

from android_svo_tpu_torch import resolve_device
from android_svo_tpu_torch.geometry.camera import PinholeCamera

# EuRoC MH_01_easy, cam0 (its sensor.yaml): resolution, pinhole intrinsics
# fx, fy, cx, cy and radtan k1, k2, p1, p2
MH01_CAM0 = {"resolution": (752, 480),
             "intrinsics": (458.654, 457.296, 367.215, 248.375),
             "distortion_coefficients": (-0.28340811, 0.07395907,
                                         0.00019359, 1.76187114e-05)}


@dataclass
class EurocSequence:
    root: str
    cam_dir: str
    timestamps: list          # seconds (float)
    filenames: list
    camera: Optional[PinholeCamera]
    gt_stamps: Optional[np.ndarray] = None     # (N,) seconds
    gt_positions: Optional[np.ndarray] = None  # (N, 3)
    gt_quats: Optional[np.ndarray] = None      # (N, 4) wxyz

    def __len__(self):
        return len(self.filenames)

    def paths(self) -> list:
        """The image files, in sequence order."""
        return [os.path.join(self.cam_dir, "data", fn)
                for fn in self.filenames]

    def frames(self) -> Iterator[tuple[float, torch.Tensor]]:
        """Yields (timestamp_s, float32 CPU tensor (H, W) in [0, 255])."""
        from PIL import Image
        for ts, path in zip(self.timestamps, self.paths()):
            img = np.asarray(Image.open(path).convert("L"), np.float32)
            yield ts, torch.from_numpy(img)

    def gt_at(self, t: float) -> Optional[np.ndarray]:
        """Nearest-neighbour GT position at time t (None if no GT)."""
        if self.gt_stamps is None or len(self.gt_stamps) == 0:
            return None
        i = int(np.argmin(np.abs(self.gt_stamps - t)))
        return self.gt_positions[i]


def _parse_sensor_yaml(path: str):
    """Minimal YAML reader for EuRoC sensor.yaml (no yaml dependency):
    extracts resolution, intrinsics, distortion_coefficients."""
    vals = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            for key in ("resolution", "intrinsics",
                        "distortion_coefficients"):
                if line.startswith(key + ":"):
                    arr = line.split("[", 1)[1].rsplit("]", 1)[0]
                    vals[key] = [float(x) for x in arr.split(",")]
    return vals


def _csv_rows(path: str, n_cols: int) -> np.ndarray:
    """The numeric rows of an ASL csv (comment lines skipped), float64."""
    rows = []
    with open(path) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            rows.append([float(x) for x in row[:n_cols]])
    return np.asarray(rows)


def load_imu(root: str, imu: str = "imu0") -> Optional[dict]:
    """IMU stream: {"stamps": (N,) s, "gyro": (N,3) rad/s, "accel": (N,3)
    m/s^2}, or None without `mav0/<imu>/data.csv`."""
    imu_csv = os.path.join(root, "mav0", imu, "data.csv")
    if not os.path.exists(imu_csv):
        return None
    arr = _csv_rows(imu_csv, 7)
    return {"stamps": arr[:, 0] * 1e-9, "gyro": arr[:, 1:4],
            "accel": arr[:, 4:7]}


def load_euroc(root: str, cam: str = "cam0", load_gt: bool = True,
               device=None) -> EurocSequence:
    dev = resolve_device(device)
    cam_dir = os.path.join(root, "mav0", cam)
    stamps, files = [], []
    with open(os.path.join(cam_dir, "data.csv")) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            stamps.append(int(row[0]) * 1e-9)
            files.append(row[1].strip())

    camera = None
    yaml_path = os.path.join(cam_dir, "sensor.yaml")
    if os.path.exists(yaml_path):
        v = _parse_sensor_yaml(yaml_path)
        if "intrinsics" in v and "resolution" in v:
            fx, fy, cx, cy = v["intrinsics"]
            w, h = (int(x) for x in v["resolution"])
            d = v.get("distortion_coefficients", [0, 0, 0, 0])
            d = (d + [0.0] * 5)[:5]
            camera = PinholeCamera.create(w, h, fx, fy, cx, cy, *d,
                                          device=dev)

    gt_stamps = gt_pos = gt_quat = None
    gt_csv = os.path.join(root, "mav0", "state_groundtruth_estimate0",
                          "data.csv")
    if load_gt and os.path.exists(gt_csv):
        arr = _csv_rows(gt_csv, 8)
        gt_stamps = arr[:, 0] * 1e-9
        gt_pos = arr[:, 1:4]
        gt_quat = arr[:, 4:8]

    return EurocSequence(root=root, cam_dir=cam_dir, timestamps=stamps,
                         filenames=files, camera=camera,
                         gt_stamps=gt_stamps, gt_positions=gt_pos,
                         gt_quats=gt_quat)


def write_png(path: str, img: np.ndarray) -> None:
    """An 8-bit grayscale (H, W) uint8 array as a PNG: one IHDR, one IDAT
    (filter type 0 on every row; zlib level 1, speed before size), IEND."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 2:
        raise ValueError(f"write_png takes an (H, W) array, got {img.shape}")
    h, w = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw.tobytes(), 1)))
        f.write(chunk(b"IEND", b""))


def write_euroc(root: str, frames: Sequence[np.ndarray],
                stamps_ns: Sequence[int], sensor: dict,
                gt_positions: Optional[np.ndarray] = None,
                gt_quats: Optional[np.ndarray] = None) -> list:
    """Write uint8 (H, W) frames as cam0 of an ASL tree under `root`: the
    PNGs, `data.csv`, `sensor.yaml` (from `sensor`'s resolution, intrinsics
    and distortion_coefficients, as `MH01_CAM0`) and, given positions and
    wxyz quaternions per frame, the ground-truth csv.  Returns the image
    paths."""
    cam_dir = os.path.join(root, "mav0", "cam0")
    os.makedirs(os.path.join(cam_dir, "data"), exist_ok=True)
    paths, rows = [], []
    for img, ts in zip(frames, stamps_ns):
        fn = f"{int(ts)}.png"
        paths.append(os.path.join(cam_dir, "data", fn))
        write_png(paths[-1], img)
        rows.append(f"{int(ts)},{fn}")
    with open(os.path.join(cam_dir, "data.csv"), "w") as f:
        f.write("#timestamp [ns],filename\n" + "\n".join(rows) + "\n")

    def seq(vals, fmt=float):
        return "[" + ", ".join(repr(fmt(x)) for x in vals) + "]"

    with open(os.path.join(cam_dir, "sensor.yaml"), "w") as f:
        f.write("sensor_type: camera\n"
                f"resolution: {seq(sensor['resolution'], int)}\n"
                f"intrinsics: {seq(sensor['intrinsics'])}\n"
                "distortion_model: radial-tangential\n"
                f"distortion_coefficients: "
                f"{seq(sensor['distortion_coefficients'])}\n")
    if gt_positions is not None:
        gt_dir = os.path.join(root, "mav0", "state_groundtruth_estimate0")
        os.makedirs(gt_dir, exist_ok=True)
        with open(os.path.join(gt_dir, "data.csv"), "w") as f:
            f.write("#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z\n")
            for ts, p, q in zip(stamps_ns, gt_positions, gt_quats):
                f.write(",".join([str(int(ts))] + [repr(float(x))
                                                   for x in (*p, *q)]) + "\n")
    return paths
