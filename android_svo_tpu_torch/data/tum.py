"""TUM-mono / TUM-RGBD style dataset loader — port of
`android_svo_tpu/data/tum.py`.  Layout:
  <root>/rgb.txt or images.txt     "timestamp filename" per line
  <root>/rgb/<name>.png            images
  <root>/groundtruth.txt           "t tx ty tz qx qy qz qw" (optional)
  <root>/camera.txt                "fx fy cx cy [k1 k2 p1 p2 k3]" + "w h"

The camera is built on the device the caller asks for (CUDA unless
`device="cpu"`; without a card `load_tum` raises); frames and ground truth
stay on the host.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch

from android_svo_tpu_torch import resolve_device
from android_svo_tpu_torch.geometry.camera import PinholeCamera


@dataclass
class TumSequence:
    root: str
    timestamps: list
    filenames: list
    camera: Optional[PinholeCamera]
    gt_stamps: Optional[np.ndarray] = None
    gt_positions: Optional[np.ndarray] = None

    def __len__(self):
        return len(self.filenames)

    def frames(self) -> Iterator[tuple[float, torch.Tensor]]:
        """Yields (timestamp_s, float32 CPU tensor (H, W) in [0, 255])."""
        from PIL import Image
        for ts, fn in zip(self.timestamps, self.filenames):
            img = np.asarray(
                Image.open(os.path.join(self.root, fn)).convert("L"),
                np.float32)
            yield ts, torch.from_numpy(img)


def load_tum(root: str, device=None) -> TumSequence:
    dev = resolve_device(device)
    index = None
    for cand in ("rgb.txt", "images.txt"):
        p = os.path.join(root, cand)
        if os.path.exists(p):
            index = p
            break
    if index is None:
        raise FileNotFoundError(f"no rgb.txt/images.txt under {root}")

    stamps, files = [], []
    with open(index) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            stamps.append(float(parts[0]))
            files.append(parts[1])

    camera = None
    cam_txt = os.path.join(root, "camera.txt")
    if os.path.exists(cam_txt):
        with open(cam_txt) as f:
            lines = [l.split() for l in f
                     if l.strip() and not l.startswith("#")]
        vals = [float(x) for x in lines[0]]
        fx, fy, cx, cy = vals[:4]
        dist = (vals[4:] + [0.0] * 5)[:5]
        w, h = (int(float(x)) for x in lines[1][:2])
        camera = PinholeCamera.create(w, h, fx, fy, cx, cy, *dist,
                                      device=dev)

    gt_stamps = gt_pos = None
    gt_txt = os.path.join(root, "groundtruth.txt")
    if os.path.exists(gt_txt):
        rows = []
        with open(gt_txt) as f:
            for line in f:
                if line.startswith("#") or not line.strip():
                    continue
                rows.append([float(x) for x in line.split()[:4]])
        arr = np.asarray(rows)
        gt_stamps = arr[:, 0]
        gt_pos = arr[:, 1:4]

    return TumSequence(root=root, timestamps=stamps, filenames=files,
                       camera=camera, gt_stamps=gt_stamps,
                       gt_positions=gt_pos)
