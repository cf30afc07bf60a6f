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
// Bound: bytes.  At the microbench's size (2048 patches of 8x8 on 480x640)
// the inputs are the touched pixels (at most the 1.2 MB image) and 16 KB of
// uv, the output 0.5 MB; ~11 flops per output pixel is 1.4 MFLOP.  Design:
// one thread per output pixel, 64 threads per feature, four features per
// 256-thread block, so a warp reads two neighbouring 8-pixel row segments
// per tap; the image is read with __ldg (L1/L2-cached, the 9x9 window is
// re-read by its 64 threads from cache).  The TPU's aligned-window-and-roll
// schedule exists for its (8, 128) vector tiles and is not carried over.
// The lerp is written with explicitly rounded fp32 operations in the order
// of the plain version, so the two agree bit for bit.
//
// Plain C interface (nvcc -shared, bound with ctypes); the launcher returns
// the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kP = 8;                     // patch size
constexpr int kHalf = kP / 2;
constexpr int kFeatPerBlock = 4;
constexpr int kThreads = kP * kP * kFeatPerBlock;

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
__global__ void probe_patches_kernel(const float* __restrict__ img, int H,
                                     int W, const float* __restrict__ uv,
                                     int n, float* __restrict__ out) {
  const int gid = blockIdx.x * kThreads + threadIdx.x;
  const int i = gid / (kP * kP);
  if (i >= n) return;
  const int pix = gid % (kP * kP);
  const int r = pix / kP, c = pix % kP;
  const float x = __ldg(uv + 2 * i), y = __ldg(uv + 2 * i + 1);
  const float x0f = floorf(x), y0f = floorf(y);
  const float wx = __fsub_rn(x, x0f), wy = __fsub_rn(y, y0f);
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
  const int y0 = clampi(oy + r, 0, H - 1), y1 = clampi(oy + r + 1, 0, H - 1);
  const int x0 = clampi(ox + c, 0, W - 1), x1 = clampi(ox + c + 1, 0, W - 1);
  const float v00 = __ldg(img + (long long)y0 * W + x0);
  const float v01 = __ldg(img + (long long)y0 * W + x1);
  const float v10 = __ldg(img + (long long)y1 * W + x0);
  const float v11 = __ldg(img + (long long)y1 * W + x1);
  const float ux = __fsub_rn(1.0f, wx), uy = __fsub_rn(1.0f, wy);
  const float top = __fadd_rn(__fmul_rn(ux, v00), __fmul_rn(wx, v01));
  const float bot = __fadd_rn(__fmul_rn(ux, v10), __fmul_rn(wx, v11));
  out[gid] = __fadd_rn(__fmul_rn(uy, top), __fmul_rn(wy, bot));
}

}  // namespace

extern "C" int launch_probe_patches(const float* img, int H, int W,
                                    const float* uv, int n, int variant,
                                    float* out, void* stream) {
  if (n <= 0) return 0;
  const dim3 grid((n + kFeatPerBlock - 1) / kFeatPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 'A':
      probe_patches_kernel<'A'><<<grid, kThreads, 0, s>>>(img, H, W, uv, n,
                                                          out);
      break;
    case 'B':
      probe_patches_kernel<'B'><<<grid, kThreads, 0, s>>>(img, H, W, uv, n,
                                                          out);
      break;
    case 'C':
      probe_patches_kernel<'C'><<<grid, kThreads, 0, s>>>(img, H, W, uv, n,
                                                          out);
      break;
    case 'D':
      probe_patches_kernel<'D'><<<grid, kThreads, 0, s>>>(img, H, W, uv, n,
                                                          out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
