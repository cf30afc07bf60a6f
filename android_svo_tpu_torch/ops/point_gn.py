"""Structure optimisation in one launch: `point_gn_kernel`
(`csrc/pose_kernels.cu`).  `core/point_opt.py::optimize_structure`
dispatches to it through the op `svo_torch::point_gn` (with its vmap rule),
beside its plain version `optimize_selected_plain`.

The kernel replaces no Pallas kernel.  It takes the stage's work after the
selection off the host, which dispatched some 970 ATen launches a frame for
it: the selected landmarks' gathers, every Gauss-Newton or
Levenberg-Marquardt iteration of each (its 3x3 system over its observations,
the solve, the cost at the candidate, the accept test) and the write-back of
`pos` and `last_optim`; one block per frame, one launch for a frame or for a
batch.

Nothing here converts: the point arena's float32 `pos` (P, 3), int32
`last_optim` (P,) and `obs_kf` (P, O), float32 `obs_f` (P, O, 3), the
keyframes' float32 `q_kw` (K, 4) and `t_kw` (K, 3) and bool `valid` (K,),
the selection's int64 `slots` (S,) and bool `sel` (S,), and the int32 0-d
`frame_id`, all on one CUDA device, each contiguous within a frame; other
types or layouts raise.  `point_gn` is one frame, `point_gn_batched` a batch
(each operand with a leading batch dimension read at its stride, 0 for an
input the frames share; B blocks).  Each landmark sums its observations in
their order, which does not depend on B, so the batched launch gives each
frame's single launch bit for bit.  Either is the two output allocations
(the new `pos` and `last_optim`: no input is written) and one launch, which
adds one to `LAUNCHES` and to the installed monitor's `point_gn_launches`;
neither reads anything back to the host.
"""

from __future__ import annotations

import torch

from android_svo_tpu_torch.ops.cuda_build import (check, frame_contiguous,
                                                  launch, stream)
from android_svo_tpu_torch.utils import profiling

LAUNCHES = {"point_gn_kernel": 0}

# the operands' shape within one frame (P points, O observations a point,
# K keyframes, S selected slots); the type
_OPERANDS = (("pos", ("P", 3), torch.float32),
             ("last_optim", ("P",), torch.int32),
             ("obs_kf", ("P", "O"), torch.int32),
             ("obs_f", ("P", "O", 3), torch.float32),
             ("q_kw", ("K", 4), torch.float32),
             ("t_kw", ("K", 3), torch.float32),
             ("kf_valid", ("K",), torch.bool),
             ("slots", ("S",), torch.int64),
             ("sel", ("S",), torch.bool),
             ("frame_id", (), torch.int32))


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _launch(args, n_iter: int, lm: bool, batch: int | None):
    """Checks, the two output allocations and the one launch.  `args` are
    the ten operands (`_OPERANDS`) of one frame, or, with `batch`, each
    with a leading batch dimension read at its stride (0: shared)."""
    if n_iter < 0:
        raise ValueError(f"n_iter must be >= 0, got {n_iter}")
    pos = args[0]
    if not isinstance(pos, torch.Tensor) or pos.dim() < 2:
        raise TypeError("pos must be a (P, 3) tensor")
    if not pos.is_cuda:
        raise ValueError(f"pos is on {pos.device}: the kernel runs on CUDA")
    lead = () if batch is None else (batch,)
    dev = pos.get_device()
    sizes = {"P": pos.shape[-2], "O": args[2].shape[-1],
             "K": args[4].shape[-2], "S": args[7].shape[-1]}
    packed = []
    for t, (name, shape, dtype) in zip(args, _OPERANDS):
        shape = tuple(sizes.get(s, s) for s in shape)
        check(t, name, dtype, lead + shape, dev)
        if not frame_contiguous(t, len(lead)):
            raise ValueError(f"{name} must be contiguous within a frame")
        packed += [t.data_ptr(), t.stride()[0] if lead else 0]
    P = sizes["P"]
    pos_out = torch.empty(lead + (P, 3), dtype=torch.float32,
                          device=pos.device)
    lo_out = torch.empty(lead + (P,), dtype=torch.int32, device=pos.device)
    launch(LAUNCHES, "point_gn_kernel", "launch_point_gn", *packed,
           1 if batch is None else batch, P, sizes["O"], sizes["K"],
           sizes["S"], int(n_iter), int(lm), pos_out.data_ptr(),
           lo_out.data_ptr(), stream(dev))
    profiling.count("point_gn_launches")
    return pos_out, lo_out


def point_gn(pos, last_optim, obs_kf, obs_f, q_kw, t_kw, kf_valid, slots,
             sel, frame_id, n_iter: int, lm: bool):
    """Refine one frame's selected landmarks in one launch.  Returns the
    new (pos, last_optim), as `core/point_opt.py::optimize_selected_plain`."""
    return _launch((pos, last_optim, obs_kf, obs_f, q_kw, t_kw, kf_valid,
                    slots, sel, frame_id), n_iter, lm, None)


def point_gn_batched(pos, last_optim, obs_kf, obs_f, q_kw, t_kw, kf_valid,
                     slots, sel, frame_id, n_iter: int, lm: bool):
    """point_gn for a batch: every operand with a leading batch dimension
    B (one of stride 0 is read once for all); one launch of B blocks.  An
    operand not contiguous within a frame (a vmap rule's moved argument) is
    made so."""
    args = tuple(a if frame_contiguous(a, 1) else a.contiguous()
                 for a in (pos, last_optim, obs_kf, obs_f, q_kw, t_kw,
                           kf_valid, slots, sel, frame_id))
    return _launch(args, n_iter, lm, pos.shape[0])
