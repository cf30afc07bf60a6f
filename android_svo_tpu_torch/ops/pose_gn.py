"""Motion-only pose refinement in one launch: `pose_gn_kernel`
(`csrc/pose_kernels.cu`).  `core/pose_opt.py::optimize_pose` dispatches to
it through the op `svo_torch::pose_gn` (with its vmap rule), beside its
plain version `optimize_pose_plain`.

The kernel replaces no Pallas kernel.  It takes the whole refinement (the
MAD scale, every Gauss-Newton or Levenberg-Marquardt iteration with its 6x6
solve and its step test, the inliers and the covariance) off the host, which
dispatched some 4,400 ATen launches a frame for it: one block per frame,
one launch for a frame or for a batch.

Nothing here converts: float32 poses, points and bearings, int32 levels, a
bool mask and a float32 0-d `focal` (read in the kernel, which computes
`thresh / focal`), all on one CUDA device, each contiguous within a frame;
other types or layouts raise.  `pose_gn` is one frame, `pose_gn_batched` a
batch (each operand with a leading batch dimension read at its stride, 0
for an input the frames share, such as `focal`; B blocks).  Each block sums
in an order that does not depend on B, so the batched launch gives each
frame's single launch bit for bit.  Either is the seven output allocations
and one launch, which adds one to `LAUNCHES`; neither writes an input or
reads anything back to the host.
"""

from __future__ import annotations

import torch

from android_svo_tpu_torch.ops.cuda_build import (check, frame_contiguous,
                                                  launch, stream)

LAUNCHES = {"pose_gn_kernel": 0}

# the operands' shape within one frame, n the row count; the type
_OPERANDS = (("q", (4,), torch.float32), ("t", (3,), torch.float32),
             ("p_w", ("n", 3), torch.float32),
             ("f_meas", ("n", 3), torch.float32),
             ("level", ("n",), torch.int32), ("valid", ("n",), torch.bool),
             ("focal", (), torch.float32))


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _launch(args, n_iter: int, thresh: float, lm: bool, batch: int | None):
    """Checks, the output allocations and the one launch.  `args` are the
    seven operands (`_OPERANDS`) of one frame, or, with `batch`, each with a
    leading batch dimension read at its stride (0: shared)."""
    n = args[2].shape[-2]
    dev = args[2].get_device()
    lead = () if batch is None else (batch,)
    if n_iter < 0:
        raise ValueError(f"n_iter must be >= 0, got {n_iter}")
    packed = []
    for t, (name, shape, dtype) in zip(args, _OPERANDS):
        shape = tuple(n if s == "n" else s for s in shape)
        check(t, name, dtype, lead + shape, dev)
        if not frame_contiguous(t, len(lead)):
            raise ValueError(f"{name} must be contiguous within a frame")
        packed += [t.data_ptr(), t.stride()[0] if lead else 0]
    device = args[2].device
    f32 = torch.float32
    q = torch.empty(lead + (4,), dtype=f32, device=device)
    t = torch.empty(lead + (3,), dtype=f32, device=device)
    inlier = torch.empty(lead + (n,), dtype=torch.bool, device=device)
    n_inl = torch.empty(lead, dtype=torch.int32, device=device)
    cov = torch.empty(lead + (6, 6), dtype=f32, device=device)
    chi2_init = torch.empty(lead, dtype=f32, device=device)
    chi2_final = torch.empty(lead, dtype=f32, device=device)
    launch(LAUNCHES, "pose_gn_kernel", "launch_pose_gn", *packed,
           1 if batch is None else batch, n, int(n_iter), float(thresh),
           int(lm), q.data_ptr(), t.data_ptr(), inlier.data_ptr(),
           n_inl.data_ptr(), cov.data_ptr(), chi2_init.data_ptr(),
           chi2_final.data_ptr(), stream(dev))
    return q, t, inlier, n_inl, cov, chi2_init, chi2_final


def pose_gn(q, t, p_w, f_meas, level, valid, focal, n_iter: int,
            thresh: float, lm: bool):
    """Refine one frame's pose (q, t) against its rows in one launch.
    Returns (q, t, inlier, n_inliers int32, cov (6, 6), chi2_init,
    chi2_final), as `core/pose_opt.py::optimize_pose_plain`."""
    return _launch((q, t, p_w, f_meas, level, valid, focal), n_iter, thresh,
                   lm, None)


def pose_gn_batched(q, t, p_w, f_meas, level, valid, focal, n_iter: int,
                    thresh: float, lm: bool):
    """pose_gn for a batch: every operand with a leading batch dimension B
    (one of stride 0 is read once for all); one launch of B blocks.  An
    operand not contiguous within a frame (a vmap rule's moved argument) is
    made so."""
    args = tuple(a if frame_contiguous(a, 1) else a.contiguous()
                 for a in (q, t, p_w, f_meas, level, valid, focal))
    return _launch(args, n_iter, thresh, lm, p_w.shape[0])
