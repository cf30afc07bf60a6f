"""Typed configuration for the PyTorch port — a field-for-field copy of
`android_svo_tpu.config.SVOConfig` (same names, defaults and meaning; the
port keeps its own copy so it never imports the JAX package).

`use_pallas` keeps its name: True means the hand-written CUDA kernels for
CUDA tensors and the plain PyTorch versions for CPU tensors; False means the
plain versions everywhere.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class SVOConfig:
    # ---- image pyramid ----------------------------------------------------
    n_pyr_levels: int = 3
    img_align_max_level: int = 4
    img_align_min_level: int = 2

    # ---- sparse image alignment ---------------------------------------------
    img_align_patch_halfsize: int = 2
    img_align_n_iter: int = 30
    img_align_eps: float = 1e-7

    # ---- feature detection --------------------------------------------------
    grid_size: int = 20
    triang_min_corner_score: float = 10.0
    fast_threshold: float = 20.0
    max_fts: int = 1200
    edgelet_detection: bool = False
    edgelet_grad_min: float = 30.0

    # ---- matcher / feature alignment ---------------------------------------
    patch_halfsize: int = 4
    align_max_iter: int = 10
    max_epi_search_steps: int = 100
    max_search_level: int = 2
    zmssd_threshold_factor: float = 2000.0
    align_mxu: bool = True              # window-staged ICLK (one window load
                                        # per feature) instead of the
                                        # per-iteration sampling kernel
    match_min_patch_std: float = 5.0
    direct_match_zmssd: bool = True
    max_view_angle_cos: float = 0.5
    subpix_n_iter: int = 10
    epi_search_1d: bool = False

    # ---- reprojector ---------------------------------------------------------
    max_n_kfs_reproject: int = 10
    warp_refresh_budget: int = 64
    seed_warp_refresh_budget: int = 64
    reproject_n_retries: int = 1
    reproject_retry_budget: int = 192
    quality_min_fts: int = 40
    quality_max_drop_fts: int = 500
    min_reproj_matches: int = 40
    point_max_reproj_fail_unknown: int = 15
    point_max_reproj_fail_good: int = 30
    point_min_succ_good: int = 10

    # ---- pose / structure optimization --------------------------------------
    poseoptim_n_iter: int = 10
    poseoptim_thresh: float = 2.0
    poseoptim_method: str = "gn"
    min_pose_opt_edges: int = 20
    structureoptim_max_pts: int = 20
    structureoptim_n_iter: int = 5
    structureoptim_method: str = "gn"

    # ---- relocalization --------------------------------------------------------
    reloc_min_tracked: int = 30

    # ---- keyframe policy ------------------------------------------------------
    kf_select_covisibility: bool = True
    kf_overlap_min_fts: int = 1
    kfselect_mindist: float = 0.06
    max_n_kfs: int = 16
    core_n_kfs: int = 5

    # ---- depth filter ----------------------------------------------------------
    seed_convergence_sigma2_thresh: float = 100.0
    seed_max_kf_age: int = 3
    max_seeds: int = 2048
    seed_update_budget: int = 768
    d_filter_px_noise: float = 1.0

    # ---- initialization (two-frame bootstrap) ----------------------------------
    init_min_kps: int = 100
    init_min_tracked: int = 50
    init_min_disparity: float = 50.0
    init_min_inliers: int = 40
    klt_win_halfsize: int = 15
    klt_max_level: int = 4
    klt_n_iter: int = 30
    ransac_n_trials: int = 256
    ransac_thresh_px: float = 2.0
    map_scale: float = 0.5

    # ---- map ---------------------------------------------------------------------
    max_points: int = 8192
    max_obs_per_point: int = 8
    reproj_thresh: float = 4.0

    # ---- local bundle adjustment (not ported yet: loba_n_iter must be 0) ----------
    loba_n_iter: int = 5
    loba_point_budget: int = 2048
    loba_num_kfs: int = 4
    loba_every_n_kfs: int = 1
    loba_robust_huber_width: float = 1.0
    loba_thresh: float = 2.0

    # ---- numerics / dispatch ---------------------------------------------------------
    dtype: str = "float32"
    use_pallas: bool = True             # hand-written kernels on CUDA tensors

    def replace(self, **kw) -> "SVOConfig":
        return dataclasses.replace(self, **kw)

    @property
    def total_pyr_levels(self) -> int:
        return max(self.n_pyr_levels, self.img_align_max_level + 1)

    @property
    def patch_size(self) -> int:
        return 2 * self.patch_halfsize

    @property
    def img_align_patch_size(self) -> int:
        return 2 * self.img_align_patch_halfsize


def not_ported(field: str, value) -> NotImplementedError:
    """The error a branch of the JAX package that the port has not carried
    over yet raises, naming the config field that selects it."""
    return NotImplementedError(
        f"SVOConfig.{field}={value!r} selects a branch not ported to "
        f"android_svo_tpu_torch yet")
