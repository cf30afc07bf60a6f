// Gather-probe kernel, CUDA C++ for Hopper (sm_90a).
//
// probe_patches_kernel<V> replaces the three Pallas probe kernels the JAX
// package used to choose how every VO kernel reads patches:
//   V = A: scripts/probe_pallas_patch.py:26-71 (_kernel: aligned (16, 256)
//          window + row and column rolls) and scripts/microbench_gather.py:
//          133-169 (patch_kernel: unaligned (P+1)^2 slice).  Both read the
//          window at (yi, xi) on the scripts' uv ranges.
//   V = B, C, D: scripts/probe_pallas_variants.py:25-90 (make_kernel(v)),
//          cost probes whose windows start elsewhere (wrong by design):
//          B at (yi, clip(xi, 0, w-128)), C at (yi, clip((xi//128)*128, 0,
//          w-256)), D at (clip((yi//8)*8, 0, h-16), 0) with no roll.
// with xi = floor(x) - P/2, yi = floor(y) - P/2.  Each computes one bilinear
// P x P patch per uv from one (H, W) fp32 image, with the weights
// wx = x - floor(x), wy = y - floor(y) taken once per feature (the probes'
// arithmetic, not interp.extract_patches', which floors every tap).
//
// Outside the scripts' uv ranges the TPU twins wrap inside their window
// (pltpu.roll); this kernel clamps every read to the image instead, as the
// plain version (ops/gather_probe.py::probe_patches_plain) does.
//
// Bound: bytes.  The output (256 B per feature) dominates: at 32768
// features on 480x640 the touched pixels (at most the 1.2 MB image), 256 KB
// of uv and 8.4 MB of patches take ~2.9 us at 3.35 TB/s against ~23 MFLOP
// (0.34 us).  The TPU keeps the whole image in VMEM and rolls a window per
// feature into place; the image does not fit one SM's shared memory but
// stays in the 50 MB L2, so here each feature's (P+1)^2 window is staged
// once, on chip, for the warp that computes it:
//   - one warp per feature, 8 features per 256-thread block;
//   - lane l loads window elements l, l+32, l+64 (< 81): element e is the
//     pixel (clamp(oy + e/9, 0, H-1), clamp(ox + e%9, 0, W-1)) of the
//     variant's origin (oy, ox), written to the warp's 9x9 tile in shared
//     memory, then __syncwarp();
//   - lane l computes output pixels l and l+32 from tile entries [r][c],
//     [r][c+1], [r+1][c], [r+1][c+1] and writes them as two coalesced
//     128-byte stores.
// Image loads per feature fall from 256 (one thread per output pixel, four
// taps each) to 81, uv loads from 128 to 64 (two per lane).  Clamping acts
// on each coordinate alone, so the plain version's tap (clamp(oy+r+dy),
// clamp(ox+c+dx)) is tile entry [r+dy][c+dx] for any uv, off-image, NaN and
// +-huge included; the lerp is written with explicitly rounded fp32
// operations in the plain version's order, so the two agree bit for bit.
// TMA is not used: its tile copy fills off-image reads with zeros, not the
// border, and needs a tensor map per image on the host.
//
// Plain C interface (nvcc -shared, bound with ctypes); the launcher returns
// the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kP = 8;                     // patch size
constexpr int kHalf = kP / 2;
constexpr int kT = kP + 1;                // window side
constexpr int kTile = kT * kT;            // window elements
constexpr int kWarps = 8;                 // features per block
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// floor(v) as an int, with NaN read as 0 and the float clamped before the
// cast (the plain version's rule), so any input gives a defined index.
__device__ __forceinline__ int floor_int(float f) {
  f = isnan(f) ? 0.0f : fminf(fmaxf(f, -65536.0f), 65536.0f);
  return (int)f;
}

template <char V>
__global__ void __launch_bounds__(kThreads)
probe_patches_kernel(const float* __restrict__ img, int H, int W,
                     const float* __restrict__ uv, int n,
                     float* __restrict__ out) {
  __shared__ float tiles[kWarps][kTile];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + warp;
  if (i >= n) return;                     // the whole warp leaves together
  const float x = __ldg(uv + 2 * i), y = __ldg(uv + 2 * i + 1);
  const float x0f = floorf(x), y0f = floorf(y);
  const int xi = floor_int(x0f) - kHalf;
  const int yi = floor_int(y0f) - kHalf;
  int oy = yi, ox = xi;
  if constexpr (V == 'B') {
    ox = clampi(xi, 0, W - 128);
  } else if constexpr (V == 'C') {
    ox = clampi(floor_div(xi, 128) * 128, 0, W - 256);
  } else if constexpr (V == 'D') {
    oy = clampi(floor_div(yi, 8) * 8, 0, H - 16);
    ox = 0;
  }
  float* tile = tiles[warp];
#pragma unroll
  for (int e = lane; e < kTile; e += 32) {
    const int ry = clampi(oy + e / kT, 0, H - 1);
    const int rx = clampi(ox + e % kT, 0, W - 1);
    tile[e] = __ldg(img + (long long)ry * W + rx);
  }
  __syncwarp();
  const float wx = __fsub_rn(x, x0f), wy = __fsub_rn(y, y0f);
  const float ux = __fsub_rn(1.0f, wx), uy = __fsub_rn(1.0f, wy);
  float* o = out + (long long)i * (kP * kP);
#pragma unroll
  for (int p = lane; p < kP * kP; p += 32) {
    const float* t = tile + (p / kP) * kT + p % kP;
    const float top = __fadd_rn(__fmul_rn(ux, t[0]), __fmul_rn(wx, t[1]));
    const float bot =
        __fadd_rn(__fmul_rn(ux, t[kT]), __fmul_rn(wx, t[kT + 1]));
    o[p] = __fadd_rn(__fmul_rn(uy, top), __fmul_rn(wy, bot));
  }
}

template <char V>
cudaError_t launch(const float* img, int H, int W, const float* uv, int n,
                   float* out, cudaStream_t s) {
  probe_patches_kernel<V><<<(n + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      img, H, W, uv, n, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int launch_probe_patches(const float* img, int H, int W,
                                    const float* uv, int n, int variant,
                                    float* out, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 'A': return (int)launch<'A'>(img, H, W, uv, n, out, s);
    case 'B': return (int)launch<'B'>(img, H, W, uv, n, out, s);
    case 'C': return (int)launch<'C'>(img, H, W, uv, n, out, s);
    case 'D': return (int)launch<'D'>(img, H, W, uv, n, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
