"""`probe_patches_kernel` built from several sources, timed in turns on one
card, so that two versions are compared inside one run:

    python -m android_svo_tpu_torch.tools.probe_ab \\
        [--source NAME=FILE.cu ...] [--patch NAME=FILE.patch ...]

"this" is the checkout's `csrc/gather_probe_kernels.cu`; each `--source` is
another version of that file (a parent commit's, say), each `--patch` this
source with a unified diff applied.  Every version is compiled alone with
the port's nvcc flags into a library of its own under
`build/probe_ab/` (all at once) and launched through its 8-argument
`launch_probe_patches`.  At N=2048 (the reference's size) and N=32768 (16x,
so that the per-patch cost stands clear of the launch floor), 8x8 patches on
a 480x640 image (`microbench_gather.make_inputs`), it checks variants A-D of
every version against `probe_patches_plain` bit for bit, then times variant
A's kernel by profiler device time in the versions' order and back (this,
a, b, b, a, this), beside the card's one-launch floor: the device time of
the microbench's trivial op, `x8 + 1.0`.  Every line carries the card's
name and power limit; the last line is the results as one JSON object.
CUDA only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
from pathlib import Path

import torch

from android_svo_tpu_torch.ops import cuda_build, gather_probe
from android_svo_tpu_torch.tools import microbench_gather
from android_svo_tpu_torch.utils.profiling import device_ms

SIZES = (2048, 32768)
OUT_DIR = cuda_build.BUILD_DIR.parent / "probe_ab"


def apply_patch(text: str, patch: str) -> str:
    """`text` with the unified diff `patch` applied; every context and
    removed line must stand where its hunk says, or it raises."""
    lines = text.splitlines(keepends=True)
    plines = patch.splitlines(keepends=True)
    out, pos, i = [], 0, 0
    while i < len(plines):
        m = re.match(r"@@ -(\d+)(?:,\d+)? \+\d+(?:,\d+)? @@", plines[i])
        i += 1
        if not m:
            continue
        start = int(m.group(1)) - 1
        out += lines[pos:start]
        pos = start
        while i < len(plines) and not plines[i].startswith("@@"):
            tag, body = plines[i][0], plines[i][1:]
            if tag in " -":
                if pos >= len(lines) or lines[pos] != body:
                    raise ValueError(f"the patch does not apply at line "
                                     f"{pos + 1}")
                pos += 1
            if tag in " +":
                out.append(body)
            i += 1
    return "".join(out + lines[pos:])


def build_versions(versions: dict, out_dir: Path, fn_names) -> dict:
    """{name: source text} -> {name: (library, nvcc report)}: each version
    compiled alone with the port's nvcc flags into `out_dir/lib<name>.so`,
    one nvcc per version, all started together; the launchers `fn_names`
    get the port's ctypes signatures."""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_build.nvcc_path()
    procs = {}
    for name, text in versions.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *cuda_build.NVCC_FLAGS, "-shared", "-o",
             str(out_dir / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    built = {}
    for name, proc in procs.items():
        report = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{report}")
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        cuda_build.bind(lib, fn_names)
        built[name] = (lib, report)
    return built


def build_all(versions: dict) -> dict:
    """{name: source text} -> {name: launch_probe_patches}."""
    built = build_versions(versions, OUT_DIR, ["launch_probe_patches"])
    return {name: lib.launch_probe_patches for name, (lib, _) in built.items()}


def _call(fn, img, uv, variant: str, out):
    h, w = img.shape
    rc = fn(img.data_ptr(), h, w, uv.data_ptr(), uv.shape[0], ord(variant),
            out.data_ptr(), cuda_build.stream(img.get_device()))
    if rc != 0:
        raise RuntimeError(f"launch failed with cudaError_t {rc}")
    return out


def run(versions: dict, log=print) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("probe_ab times kernels on a CUDA card and none "
                           "is available")
    label = microbench_gather.card_label()
    fns = build_all(versions)
    order = list(fns) + list(fns)[::-1]
    x8 = torch.zeros((8,), device="cuda")
    res = {"card": label, "order": order, "sizes": {}}
    for n in SIZES:
        img, uv = microbench_gather.make_inputs(n=n, seed=1)
        out = torch.empty((n, gather_probe.P, gather_probe.P),
                          device="cuda")
        for v in gather_probe.VARIANTS:
            ref = gather_probe.probe_patches_plain(img, uv, v)
            for name, fn in fns.items():
                got = _call(fn, img, uv, v, out)
                torch.cuda.synchronize()
                if not torch.equal(got, ref):
                    raise RuntimeError(
                        f"{name}, variant {v}, N={n}: max |d| vs plain "
                        f"{float((got - ref).abs().max())}")
        floor = device_ms(lambda: x8 + 1.0, "elementwise_kernel", iters=50)
        times = {name: [] for name in fns}
        for name in order:
            times[name].append(device_ms(
                lambda: _call(fns[name], img, uv, "A", out),
                "probe_patches_kernel", iters=50))
        res["sizes"][n] = {"floor_ms": floor, "kernel_ms": times}
        log(f"N={n}: bit-exact vs plain for A-D in every version; floor "
            f"(x8 + 1.0) {floor} ms; variant A device ms "
            + ", ".join(f"{k} {v}" for k, v in times.items())
            + f" [{label}]")
    return res


def _pairs(items):
    return dict(item.split("=", 1) for item in items)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    help="NAME=FILE.cu: another version of the source")
    ap.add_argument("--patch", action="append", default=[],
                    help="NAME=FILE.patch: this source with a diff applied")
    args = ap.parse_args(argv)
    this = (cuda_build.CSRC / "gather_probe_kernels.cu").read_text()
    versions = {"this": this}
    versions.update({k: Path(v).read_text()
                     for k, v in _pairs(args.source).items()})
    versions.update({k: apply_patch(this, Path(v).read_text())
                     for k, v in _pairs(args.patch).items()})
    print(json.dumps({"probe_ab": run(versions)}), flush=True)


if __name__ == "__main__":
    main()
