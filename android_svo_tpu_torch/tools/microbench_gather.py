"""Microbenchmark of patch-gather strategies on the card — the port of
`scripts/microbench_gather.py`, `scripts/probe_pallas_patch.py` and
`scripts/probe_pallas_variants.py` as one entry point:

    python -m android_svo_tpu_torch.tools.microbench_gather

At N=2048 scattered uv on one 480x640 image, 8x8 patches, K=100 epipolar
candidates, it times with CUDA events (after a warm-up):
  1. launch overhead of a trivial op, and the same plus one `.item()`;
  2. the advanced-index bilinear gather (`ops/interp.extract_patches`);
  3. the N x K gather of the epipolar scan's shape;
  4. a nearest-neighbour 1-D `take`;
  5. one-hot row extraction as a matmul (a library call: the reference left
     it to XLA too);
  6. `probe_patches_kernel` variants A-D (`ops/gather_probe.py`), each with
     ns per patch and max |err| against `extract_patches` (B-D are wrong by
     design: they cost other window origins).
Every printed line carries the card's name and power limit; the last line
is the results as one JSON object.  Runs only on a CUDA device; raises
without one.
"""

from __future__ import annotations

import json
import subprocess

import torch
import torch.nn.functional as F

from android_svo_tpu_torch.ops import gather_probe, interp

# the reference's sizes (microbench_gather.py:38-41, :83)
N, H, W, K = 2048, 480, 640, 100


def card_label() -> str:
    """nvidia-smi's `name, power.limit` line for card 0."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def time_ms(fn, iters=20, warmup=3) -> float:
    """Mean ms per call between two CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def make_inputs(n=N, h=H, w=W, seed=0, device="cuda"):
    """A uniform [0, 1) image and uv in the probe scripts' range
    (x in [5.5, w-6.5), y in [5.5, h-6.5)), drawn on the card."""
    gen = torch.Generator(device=device).manual_seed(seed)
    img = torch.rand((h, w), generator=gen, device=device)
    r = torch.rand((n, 2), generator=gen, device=device)
    uv = torch.stack([5.5 + r[:, 0] * (w - 12.0),
                      5.5 + r[:, 1] * (h - 12.0)], dim=-1)
    return img, uv


def run(log=print) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("the gather microbench measures the CUDA card "
                           "and none is available")
    label = card_label()
    dev = torch.device("cuda")
    n, h, w, k, p = N, H, W, K, gather_probe.P
    img, uv = make_inputs(device=dev)
    area = p * p
    res = {"card": label, "device": torch.cuda.get_device_name(0), "n": n,
           "h": h, "w": w, "p": p, "k": k}

    def say(msg):
        log(f"{msg} [{label}]")

    x8 = torch.zeros((8,), device=dev)
    res["dispatch_ms"] = time_ms(lambda: x8 + 1.0, iters=50)
    say(f"dispatch overhead (trivial op): {res['dispatch_ms']:.4f} ms")
    x0 = torch.zeros((), device=dev)
    res["dispatch_item_ms"] = time_ms(lambda: (x0 + 1.0).item(), iters=50)
    say(f"dispatch + scalar .item():      "
        f"{res['dispatch_item_ms']:.4f} ms")

    ref = interp.extract_patches(img, uv, p // 2)
    t = res["extract_patches_ms"] = time_ms(
        lambda: interp.extract_patches(img, uv, p // 2))
    say(f"advanced-index bilinear gather (N={n}, {p}x{p}): {t:.4f} ms -> "
        f"{n * area * 4 / t / 1e6:.2f} G loads/s")

    ts = torch.linspace(0, 30, k, device=dev)
    uvk = uv[:, None, :] + ts[None, :, None]
    offs = interp.patch_offsets(p // 2, device=dev)

    def gather_k():
        return interp.bilinear_sample(
            img, uvk[:, :, None, :] + offs[None, None, :, :])

    t = res["epi_gather_ms"] = time_ms(gather_k, iters=5, warmup=1)
    say(f"bilinear gather, epi-scan shape (N={n}, K={k}, {p}x{p}): "
        f"{t:.4f} ms -> {n * k * area * 4 / t / 1e6:.2f} G loads/s")

    flat = img.reshape(-1)
    oxy = offs.to(torch.int64)

    def take1d():
        xi = uv[:, 0].to(torch.int64)
        yi = uv[:, 1].to(torch.int64)
        idx = ((yi[:, None] + oxy[None, :, 1]) * w
               + (xi[:, None] + oxy[None, :, 0]))
        return torch.take(flat, idx)

    t = res["take1d_ms"] = time_ms(take1d)
    say(f"1-D take, nearest (N={n}, {p}x{p}): {t:.4f} ms -> "
        f"{n * area / t / 1e6:.2f} G loads/s")

    def onehot_rows():
        y0 = torch.floor(uv[:, 1]).to(torch.int64) - p // 2
        rows = (y0[:, None] + torch.arange(p + 1, device=dev)).clamp(0, h - 1)
        oh = F.one_hot(rows.reshape(-1), h).to(torch.float32)
        return oh @ img

    t = res["onehot_ms"] = time_ms(onehot_rows, iters=5, warmup=1)
    say(f"one-hot row matmul, fp32 (N={n}, {p + 1} rows): {t:.4f} ms -> "
        f"{n * (p + 1) * h * w * 2 / t / 1e9:.2f} TFLOP/s")

    res["probe"] = {}
    for v in gather_probe.VARIANTS:
        out = gather_probe.probe_patches(img, uv, v)
        err = float((out - ref).abs().max())
        t = time_ms(lambda: gather_probe.probe_patches(img, uv, v))
        res["probe"][v] = {"ms": t, "ns_per_patch": t / n * 1e6,
                           "m_patches_per_s": n / t / 1e3,
                           "max_err_vs_extract": err}
        say(f"probe_patches_kernel variant {v}: {t:.4f} ms "
            f"({t / n * 1e6:.1f} ns/patch, {n / t / 1e3:.2f} M patches/s), "
            f"max |err| vs extract_patches {err:.2e}")
    return res


if __name__ == "__main__":
    print(json.dumps({"microbench_gather": run()}))
