"""The JAX package's FrameHandler on the edgelet run of `chip_smoke.py`
(phase 8b), on the CPU: the configuration `EDGE_CFG`, the edge-rich texture
(`make_edge_texture`, key 3, 2048 px) and the pose sweep of
tests/test_edgelet.py at 640x480.  Prints one JSON line with the stage,
the tracking failures, the keyframes, the live edgelet landmarks and
seeds, and the ATE (Sim(3)-aligned RMSE) that `chip_smoke.py` holds the
port's run against (`JAX_ATE_EDGE`).

    JAX_PLATFORMS=cpu python tests/_torch_jax_edgelet_ate.py
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

# phase 8b's settings: tests/test_edgelet.py's relaxed thresholds (set for
# 320x240) on phase 4's base; at 640x480 with the same 420 px focal length
# the sweep moves the image as far as at 320x240, and the grid has four
# times the cells, so the thresholds hold
EDGE_CFG = dict(edgelet_detection=True, epi_search_1d=True, max_n_kfs=8,
                loba_n_iter=0, ransac_n_trials=128, img_align_n_iter=15,
                init_min_disparity=15.0, init_min_kps=60,
                init_min_tracked=30, init_min_inliers=25, quality_min_fts=25,
                min_reproj_matches=20, min_pose_opt_edges=12,
                kfselect_mindist=0.03)
N_FRAMES = 20


def main():
    import jax
    import jax.numpy as jnp
    from android_svo_tpu.config import SVOConfig
    from android_svo_tpu.core import frame_handler as fh
    from android_svo_tpu.data import synthetic
    from android_svo_tpu.evals.trajectory import ate_rmse
    from android_svo_tpu.ops import detect

    w, h = (int(a) for a in (sys.argv[1:3] or (640, 480)))
    cam = synthetic.default_camera(w, h)
    tex = synthetic.make_edge_texture(jax.random.PRNGKey(3), 2048)
    handler = fh.FrameHandler(cam, SVOConfig(**EDGE_CFG))
    est, gt, n_fail, n_kf, boot = [], [], 0, 0, None
    for i in range(N_FRAMES):
        pose = synthetic.lookdown_pose(
            0.04 * i, 0.012 * i, -3.0,
            (0.45 + 0.002 * i, -0.002 * i, 0.004 * i))
        was_default = handler.stage == fh.STAGE_DEFAULT_FRAME
        res = handler.add_image(synthetic.render(tex, cam, pose), i * 0.1)
        if handler.stage == fh.STAGE_DEFAULT_FRAME:
            boot = i if boot is None else boot
            est.append(np.asarray(res.T_cw.inverse().t, np.float64))
            gt.append(np.asarray(pose.t, np.float64))
        if was_default:
            n_fail += res.result == 0
            n_kf += res.result == 2
    pts, seeds = handler.vo.points, handler.vo.seeds
    print(json.dumps({
        "size": [w, h], "frames": N_FRAMES, "bootstrap_frame": boot,
        "stage": int(handler.stage), "failures": int(n_fail),
        "keyframes": int(n_kf),
        "edgelet_landmarks": int(jnp.sum(
            pts.valid & (pts.ref_type == detect.FTYPE_EDGELET))),
        "edgelet_seeds": int(jnp.sum(
            seeds.valid & (seeds.ftype == detect.FTYPE_EDGELET))),
        "ate": float(ate_rmse(np.array(est), np.array(gt)))}))


if __name__ == "__main__":
    main()
