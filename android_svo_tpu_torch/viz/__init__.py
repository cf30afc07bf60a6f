"""Visualization layer — port of `android_svo_tpu/viz`: the feature and AR
cube overlay written as numbered PPM frames."""

from android_svo_tpu_torch.viz.overlay import (  # noqa: F401
    Visualizer, draw_cube, draw_features, gray_to_rgb, save_ppm)
