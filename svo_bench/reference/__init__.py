"""The benchmark's yardstick: plain PyTorch and NumPy, importing nothing of
the program (`android_svo_tpu_torch`) and nothing of JAX.

  scene       the textured plane (tiling, for a traverse), the camera,
              the renderer and the paths the traffic is made of: closed
              orbits and a traverse (frozen from the port's
              `data/synthetic.py`, `geometry/camera.py`, `geometry/se3.py`
              and `chip_smoke.py::seq_poses` at 804481e)
  trajectory  Umeyama Sim(3) alignment and ATE (frozen from the port's
              `evals/trajectory.py` at 804481e)
  patches     the plain patch functions and the pyramid (frozen from the
              port's `ops/patch_kernels.py`, `ops/interp.py` and
              `ops/pyramid.py` at 804481e), in any float dtype
  pose        the tracking step's motion-only bundle adjustment (frozen
              from the port's `core/pose_opt.py` at 804481e), in float64
              or with TF32 products
  bounds      a patch function's least time on the card from its own
              arguments (frozen from `chip_smoke.py::kernel_bounds`,
              `scan_bound` and `bound`, and `ops/patch_kernels.py::
              count_iclk_updates`, at 804481e), with the published peaks
"""
