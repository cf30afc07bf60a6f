"""The benchmark's own probes around the program's four patch functions
(`ops/patch_kernels.py`): `sample_patches`, `epi_scan`, `align_iclk` and
`align_iclk_mxu`, or their batched forms, which the vmap rules call for a
batched step.  The callers look each one up on the module at every call,
so a probe set on the module sees every call of the timed path.

  capture   keep each call's arguments and outputs (held, not copied: the
            program writes no tensor in place) for the check
  ranges    open a `svo_bench.<kind>` profiler range around each call and
            keep its arguments, for the kernel roofline
  replace   run `replace(kind, args, call)` in the function's place, `call`
            running the function itself (the control and the planted
            faults)

With all three off a probe is one Python call and a test.  A call on a
`torch.func` transform's tensors is passed through untouched: its batched
form is probed where the vmap rule calls it on the batch's tensors.
"""

from __future__ import annotations

import inspect

import torch
from torch.profiler import record_function

SINGLE = {"sample_patches": "sample_patches", "epi_scan": "epi_scan",
          "align_iclk": "align_iclk", "align_iclk_mxu": "align_iclk_mxu"}
BATCHED = {k: v + "_batched" for k, v in SINGLE.items()}


def _wrapped(t) -> bool:
    """A tensor of a `torch.func` transform (its values are the
    transform's, not the batch's)."""
    return torch._C._functorch.is_functorch_wrapped_tensor(t)


class PatchProbe:
    def __init__(self, module, batched: bool):
        self.module = module
        self.names = BATCHED if batched else SINGLE
        self.capture = False
        self.ranges = False
        self.replace = None
        self.calls: list = []      # (kind, args, outputs) while capturing
        self.traced: list = []     # (kind, args) while ranges are on
        self._orig: dict = {}

    def install(self):
        for kind, name in self.names.items():
            fn = getattr(self.module, name)
            self._orig[name] = fn
            setattr(self.module, name, self._wrap(kind, fn))
        return self

    def remove(self):
        for name, fn in self._orig.items():
            setattr(self.module, name, fn)
        self._orig = {}

    def _wrap(self, kind: str, fn):
        sig = inspect.signature(fn)
        probe = self

        def probed(*args, **kwargs):
            if not (probe.capture or probe.ranges or probe.replace) or (
                    _wrapped(args[0] if args else kwargs["stack"])):
                return fn(*args, **kwargs)
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            a = dict(bound.arguments)

            def call():
                if probe.replace is None:
                    return fn(*args, **kwargs)
                return probe.replace(kind, a, lambda: fn(*args, **kwargs))

            if probe.ranges:
                with record_function(f"svo_bench.{kind}"):
                    out = call()
                probe.traced.append((kind, a))
            else:
                out = call()
            if probe.capture:
                probe.calls.append((kind, a, out))
            return out

        return probed


def _unbatched(x) -> tuple:
    """A tensor of `torch.func.vmap` as the batch's tensor, the batch
    first, and True; any other value as it is (shared by the whole batch)
    and False."""
    fx = torch._C._functorch
    if isinstance(x, torch.Tensor) and fx.is_batchedtensor(x):
        return fx.get_unwrapped(x).movedim(fx.maybe_get_bdim(x), 0), True
    return x, False


class PoseProbe:
    """A probe around the tracking step's motion-only bundle adjustment
    (`core/pipeline.py` calls `optimize_pose` by its module-level name at
    every frame).  While `capture` is on it keeps each call's inputs and
    the pose it returned (held, not copied), one record a frame or, under
    a batched step's `torch.func.vmap`, one a sequence."""

    FIELDS = ("q0", "t0", "p_w", "f_meas", "level", "valid", "q", "t")

    def __init__(self, pipeline):
        self.module = pipeline
        self.capture = False
        self.calls: list = []
        self._orig = None

    def install(self):
        self._orig = fn = self.module.optimize_pose
        probe = self

        def probed(T, p_w, f_meas, level, valid, focal, cfg):
            out = fn(T, p_w, f_meas, level, valid, focal, cfg)
            if probe.capture:
                probe._keep((T.q, T.t, p_w, f_meas, level, valid,
                             out[0].q, out[0].t), focal, cfg)
            return out

        self.module.optimize_pose = probed
        return self

    def remove(self):
        if self._orig is not None:
            self.module.optimize_pose = self._orig
            self._orig = None

    def _keep(self, values, focal, cfg):
        values = [_unbatched(x) for x in values]
        n = max((x.shape[0] for x, b in values if b), default=None)
        focal = _unbatched(focal)[0]      # read once the window has closed
        for i in range(n or 1):
            rec = {k: x[i] if b else x
                   for k, (x, b) in zip(self.FIELDS, values)}
            rec.update(focal=focal, n_iter=int(cfg.poseoptim_n_iter),
                       method=cfg.poseoptim_method)
            self.calls.append(rec)
