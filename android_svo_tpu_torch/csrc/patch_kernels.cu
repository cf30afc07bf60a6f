// Patch kernels of the tracking path, CUDA C++ for Hopper (sm_90a).
//
// Four kernels, each the port of one Pallas TPU kernel of
// android_svo_tpu/ops/patch_pallas.py.  They read image planes out of the
// padded pyramid stack (ops/pyramid.py layout: level l in the top-left
// (H>>l, W>>l) corner of an (Hp, Wp) plane) through explicit strides, so a
// non-contiguous slice of the stack (sparse alignment's level substack) needs
// no copy.  Bilinear reads clamp exactly as the plain PyTorch versions in
// ops/patch_kernels.py do (floor, clip x0 to [0, W-1], x1 = clip(x0 + 1)), so
// kernel and plain version agree on every slot the callers keep.
//
// What bounds them on an H100: none of them moves enough bytes or does enough
// arithmetic to approach the card's limits at the tracking path's sizes (768
// features, 8x8 patches, one 480x640 frame stack that stays resident in the
// 50 MB L2).  The bytes each must move are kilobytes to a few megabytes,
// i.e. microseconds at 3.35 TB/s; the work is a few MFLOP.  They are bound by
// latency: launch overhead and, inside, the dependent chain of iterations of
// each feature.  The designs below therefore keep every iteration of a
// feature inside one warp (no per-iteration launch, no host sync), keep
// per-feature state in registers, and read the stack through L2; the
// epipolar scan, whose steps are independent, spreads each seed's steps
// over the warps of a block.  Around a launch of a few microseconds the
// wrapper's own tensor ops cost more than the kernel, so every kernel also
// takes over its wrapper's conversions and arithmetic (see each kernel's
// note): a wrapper allocates its outputs and launches once.
//
// Batches: every kernel takes a stack of B frames' pyramids, (B, L, Hp, Wp)
// with batch stride s_b, and B * n_per feature rows, n_per per frame; row i
// reads frame i / n_per.  Only the plane pointer changes: the level is still
// clamped to [0, L-1] and the level's true size still derived from it, so
// s_b = 0 (or B = 1 with n_per = n) is the single-frame launch, bit for bit.
// One launch serves the whole batch (the batched tracking step's kernels).
//
// Plain C interface (route (b) of the build: nvcc -shared, bound with ctypes).
// Every launcher returns the cudaError_t of the launch; the caller raises.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kMinUpdateSquared = 0.03f * 0.03f;   // feature_alignment.cpp:276
constexpr int kWinRows = 32;                          // DUMP_WR
constexpr int kWinCols = 64;                          // DUMP_WC

__device__ __forceinline__ void floor_index(float xf, int n, int* i0, int* i1) {
  float c = isnan(xf) ? 0.0f : fminf(fmaxf(xf, -1.0f), (float)n);
  int a = (int)c;
  a = min(max(a, 0), n - 1);
  *i0 = a;
  *i1 = min(max(a + 1, 0), n - 1);
}

// Bilinear read of one plane with the plain version's border clamps.
__device__ __forceinline__ float bilin(const float* __restrict__ img,
                                       long long s_r, int H, int W,
                                       float x, float y) {
  float x0f = floorf(x), y0f = floorf(y);
  float wx = x - x0f, wy = y - y0f;
  int x0, x1, y0, y1;
  floor_index(x0f, W, &x0, &x1);
  floor_index(y0f, H, &y0, &y1);
  float v00 = __ldg(img + y0 * s_r + x0);
  float v01 = __ldg(img + y0 * s_r + x1);
  float v10 = __ldg(img + y1 * s_r + x0);
  float v11 = __ldg(img + y1 * s_r + x1);
  return (1.0f - wy) * ((1.0f - wx) * v00 + wx * v01)
       + wy * ((1.0f - wx) * v10 + wx * v11);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sums of M values over the warp, the M butterflies interleaved.
template <int M>
__device__ __forceinline__ void warp_sum_n(float (&v)[M]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < M; ++k) v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
  }
}

__device__ __forceinline__ int norm_level(int l, int L) {
  l = l < 0 ? l + L : l;
  return min(max(l, 0), L - 1);
}

// ---------------------------------------------------------------------------
// sample_patches_kernel — replaces _sample_pallas / _make_sample_kernel
// (android_svo_tpu/ops/patch_pallas.py:124-207).
// Bound: launch latency.  The bytes are the patches written once (48 KB per
// output plane at the sparse-align shapes, 768 x 4x4) and the pixels they
// touch in an L2-resident plane: hundredths of a microsecond of HBM time
// against a launch of about two microseconds (1.8 us measured on an NVIDIA
// H100 80GB HBM3 at 700 W).  What is left to save is host work and wasted
// device work, so:
// - the wrapper makes one allocation and this one launch: uv is read through
//   its strides, NaN and +-inf in uv become 0 here (the TPU wrapper's
//   nan_to_num), and a null `valid` means every slot is live;
// - with gradients, each feature's (p+2)^2 bilinear grid is sampled once into
//   shared memory and the patch and its central differences are read from it
//   (36 samples for a 4x4 patch, 100 for 8x8, where sampling each output
//   pixel and its four neighbours takes 80 / 320): the TPU kernel's
//   schedule (patch_pallas.py:126,155-159).  Grid point (j, i) sits at
//   uv + (i - half - 1, j - half - 1), where the plain version samples
//   uv + off +- 1, so the two differ only by the rounding of that sum;
// - features per block are chosen so 768 features make 192 blocks of 64
//   threads (4 features of 4x4 each) and spread over all 132 SMs.
// Without gradients one thread computes one output pixel.  Dead slots write
// zeros.  `out` holds the patch plane, then dx and dy when grad is set.
// ---------------------------------------------------------------------------
__device__ __forceinline__ float finite_or_zero(float x) {
  return isfinite(x) ? x : 0.0f;
}

__global__ void sample_patches_kernel(
    const float* __restrict__ stack, long long s_b, long long s_l,
    long long s_r, int L, int H, int W, const int* __restrict__ lvl,
    const float* __restrict__ uv, long long s_un, long long s_uc,
    const unsigned char* __restrict__ valid, int n, int n_per, int half,
    int grad, int per_block, float* __restrict__ out) {
  extern __shared__ float grid[];          // per_block x (p+2)^2 when grad
  const int p = 2 * half;
  const int area = p * p;
  const int f0 = blockIdx.x * per_block;
  const int nf = min(per_block, n - f0);
  const int s = grad ? p + 2 : p;          // sampled grid side
  const int border = grad ? 1 : 0;
  const int sarea = s * s;
  for (int e = threadIdx.x; e < nf * sarea; e += blockDim.x) {
    const int i = f0 + e / sarea;
    const int g = e % sarea;
    float val = 0.0f;
    if (valid == nullptr || valid[i]) {
      const float* img = stack + (long long)(i / n_per) * s_b
                       + (long long)norm_level(lvl[i], L) * s_l;
      const float u = finite_or_zero(uv[i * s_un]);
      const float v = finite_or_zero(uv[i * s_un + s_uc]);
      val = bilin(img, s_r, H, W, u + (float)(g % s - half - border),
                  v + (float)(g / s - half - border));
    }
    if (grad) {
      grid[e] = val;
    } else {
      out[(long long)i * area + g] = val;
    }
  }
  if (!grad) return;
  __syncthreads();
  const long long plane = (long long)n * area;
  for (int e = threadIdx.x; e < nf * area; e += blockDim.x) {
    const int f = e / area;
    const int pix = e % area;
    const float* c = grid + f * sarea + (pix / p + 1) * s + pix % p + 1;
    const long long o = (long long)(f0 + f) * area + pix;
    out[o] = c[0];
    out[plane + o] = 0.5f * (c[1] - c[-1]);
    out[2 * plane + o] = 0.5f * (c[s] - c[-s]);
  }
}

// ---------------------------------------------------------------------------
// epi_scan_kernel — replaces _scan_pallas / _make_scan_kernel
// (patch_pallas.py:253-345) together with the rest of epi_scan
// (patch_pallas.py:382-414): the reference's mean-centering and the
// NaN-zeroing of the segment ends.
// Bound: operations, and those only nominally: the in-bounds steps' 8x8
// bilinear samples and two reductions each are a few tens of MFLOP at 768
// seeds (well under a microsecond of fp32 time), the inputs and the pixels
// the segments touch a megabyte or two.  What a sequential scan pays is
// the chain: one warp walking up to 100 steps, each a round trip to memory
// and ten dependent shuffles.  The steps do not depend on each other (the
// loop is only a running argmin), so:
// - one block per seed; its warps split the steps, each keeping a strict-<
//   running best (score, j) over its steps in increasing order, so the
//   chain a warp walks is k / nw steps long and the block's warps overlap
//   their round trips.  Each warp scores two steps (j and j + nw) at once,
//   their loads and shuffle reductions interleaved, which halves the chain
//   again;
// - lanes hold K patch pixels each, with the zero-mean reference in
//   registers: every warp loads the reference through its strides and
//   centres it with the same shuffle sum, so all warps hold the same
//   values; a step outside the level's margin is never better than +inf
//   and is not sampled.  Inside the margin every tap lies inside the plane,
//   so the taps skip bilin's clamps (the identity there) and index with
//   32 bits: the same values, and 15.0 us against bilin's 18.5 on an H100;
// - a block reduction in shared memory takes the smaller score and, on
//   equal scores, the smaller j: the first minimum, as the sequential
//   strict < and the plain version's argmin.  Every warp starts from
//   (+inf, 0), so a seed with no in-bounds position gives (0, +inf);
// - a seed's taps lie along one short segment (consecutive positions about
//   0.7 px apart at the search level), so the block's reads of the
//   L2-resident stack hit one SM's L1;
// - seeds with 0 steps (most of the compacted batch in steady state) exit
//   the block at once; a null `n_steps` means n_steps_max for every seed;
//   the segment ends are read through their strides, NaN and +-inf as 0.
// ---------------------------------------------------------------------------
constexpr int kScanWarps = 8;   // warps per seed; 4 ran slower on an H100

// bilin for a tap inside the plane: the same value without the clamps.
__device__ __forceinline__ float bilin_inside(const float* __restrict__ img,
                                              int s_r, float x, float y) {
  const float x0f = floorf(x), y0f = floorf(y);
  const float wx = x - x0f, wy = y - y0f;
  const float* row0 = img + ((int)y0f * s_r + (int)x0f);
  const float* row1 = row0 + s_r;
  const float v00 = __ldg(row0), v01 = __ldg(row0 + 1);
  const float v10 = __ldg(row1), v11 = __ldg(row1 + 1);
  return (1.0f - wy) * ((1.0f - wx) * v00 + wx * v01)
       + wy * ((1.0f - wx) * v10 + wx * v11);
}

template <int HALF>
__global__ void __launch_bounds__(32 * kScanWarps) epi_scan_kernel(
    const float* __restrict__ stack, long long s_b, long long s_l,
    long long s_r64, int L, int h_true, int w_true, int n_per,
    const int* __restrict__ lvl,
    const float* __restrict__ uv_a, long long s_an, long long s_ac,
    const float* __restrict__ uv_b, long long s_bn, long long s_bc,
    const int* __restrict__ n_steps,
    const float* __restrict__ ref, long long s_rn, long long s_rr,
    int n_steps_max, float* __restrict__ out_t, float* __restrict__ out_s) {
  constexpr int P = 2 * HALF;
  constexpr int AREA = P * P;
  constexpr int K = (AREA + 31) / 32;      // patch pixels per lane
  __shared__ float warp_s[kScanWarps];
  __shared__ int warp_j[kScanWarps];
  const long long i = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int nw = kScanWarps;
  const int k = min(max(n_steps == nullptr ? n_steps_max : n_steps[i], 0),
                    n_steps_max);
  if (k == 0) {                            // uniform across the block
    if (threadIdx.x == 0) { out_t[i] = 0.0f; out_s[i] = INFINITY; }
    return;
  }
  const int l = norm_level(lvl[i], L);
  const float* img = stack + (i / n_per) * s_b + (long long)l * s_l;
  const int s_r = (int)s_r64;
  const float wl = (float)(w_true >> l), hl = (float)(h_true >> l);
  const float m = (float)HALF + 2.0f;
  const float ax = finite_or_zero(uv_a[i * s_an]);
  const float ay = finite_or_zero(uv_a[i * s_an + s_ac]);
  const float bx = finite_or_zero(uv_b[i * s_bn]);
  const float by = finite_or_zero(uv_b[i * s_bn + s_bc]);
  float rz[K], offx[K], offy[K];
  float rsum = 0.0f;
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int pix = lane + 32 * q;
    const int r = pix / P, c = pix % P;
    rz[q] = pix < AREA ? ref[i * s_rn + r * s_rr + c] : 0.0f;
    rsum += rz[q];
    offx[q] = (float)(c - HALF);
    offy[q] = (float)(r - HALF);
  }
  const float rmean = warp_sum(rsum) / (float)AREA;
#pragma unroll
  for (int q = 0; q < K; ++q) rz[q] -= rmean;
  const float denom = (float)max(k - 1, 1);
  float best_s = INFINITY;
  int best_j = 0;
  for (int j = warp; j < k; j += 2 * nw) {
    const int js[2] = {j, j + nw};
    float x[2], y[2];
    bool live[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float t = fminf((float)js[s] / denom, 1.0f);
      x[s] = ax * (1.0f - t) + bx * t;
      y[s] = ay * (1.0f - t) + by * t;
      live[s] = js[s] < k && (x[s] >= m) && (x[s] < wl - 1.0f - m)
             && (y[s] >= m) && (y[s] < hl - 1.0f - m);
    }
    if (!live[0] && !live[1]) continue;    // uniform across the warp
    float cur[2][K];
    float mean[2] = {0.0f, 0.0f};
#pragma unroll
    for (int s = 0; s < 2; ++s) {
#pragma unroll
      for (int q = 0; q < K; ++q) {
        cur[s][q] = live[s] && lane + 32 * q < AREA
            ? bilin_inside(img, s_r, x[s] + offx[q], y[s] + offy[q]) : 0.0f;
        mean[s] += cur[s][q];
      }
    }
    warp_sum_n(mean);
    float d2[2] = {0.0f, 0.0f};
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      mean[s] = mean[s] / (float)AREA;
#pragma unroll
      for (int q = 0; q < K; ++q) {
        if (lane + 32 * q < AREA) {
          const float d = (cur[s][q] - mean[s]) - rz[q];
          d2[s] += d * d;
        }
      }
    }
    warp_sum_n(d2);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (live[s] && d2[s] < best_s) { best_s = d2[s]; best_j = js[s]; }
    }
  }
  if (lane == 0) { warp_s[warp] = best_s; warp_j[warp] = best_j; }
  __syncthreads();
  if (threadIdx.x == 0) {
    float bs = warp_s[0];
    int bj = warp_j[0];
    for (int w = 1; w < nw; ++w) {
      const float s = warp_s[w];
      const int j = warp_j[w];
      if (s < bs || (s == bs && j < bj)) { bs = s; bj = j; }
    }
    out_t[i] = fminf((float)bj / denom, 1.0f);
    out_s[i] = bs;
  }
}

// ---------------------------------------------------------------------------
// The two ICLK kernels: one per-feature body, `iclk_feature`, two entries.
//
// align_iclk_kernel — replaces _align_pallas / _make_align_kernel
// (patch_pallas.py:422-557) together with the rest of align_iclk
// (patch_pallas.py:610-649): its Hessian and inverse, the NaN-zeroing of
// the start and the convergence test.
// align_iclk_window_kernel — replaces _dump_pallas / _make_dump_kernel
// (patch_pallas.py:667-717) together with the whole of align_iclk_mxu
// (patch_pallas.py:779-874): its Hessian and inverse, the window origin, the
// one-hot ICLK, the convergence test and the two appearance gates.
// Bound: latency.  The bytes are the templates and gradients (768 B per 8x8
// feature) and the pixels the iterations touch; the work is <= 11 dependent
// 8x8 samples per feature.  The caller pays for the host work around the
// launch, so each kernel takes its whole function and the wrapper only
// allocates the three outputs:
// - H = J^T J + 1e-6 I over (gx, gy, 1) and its inverse by the explicit
//   Cholesky with pivot floor 1e-20 of geometry/linsolve.py (same order of
//   operations), so near-singular features fail as in the plain version;
//   lanes 0-2 solve the inverse's three columns at once;
// - T, gx and gy are read through their strides (the caller's strided
//   interior view of patch_gradients is not copied), init_uv too; the
//   iterations start from init_uv with NaN and +-inf set to 0;
// - `converged` = step^2 < 4 * 0.03^2 at the final probe and a drift under
//   one patch side.  align_iclk measures the drift from the raw init_uv
//   (patch_pallas.py:647), so a non-finite start never converges;
//   align_iclk_mxu from the zeroed one;
// - one warp per feature: template and gradients in registers (K pixels
//   per lane), one fused shuffle reduction of the three sums per
//   iteration, no __syncthreads.  The first sample is taken with the
//   template loads and reduced with the Hessian sums, so the prologue
//   costs one memory round trip and one reduction;
// - align_iclk_kernel samples the stack with the plain version's clamps;
// - the window kernel's 32x64 window of dump_windows is a predicate, not a
//   copy: while `inb` holds (win_ok, patch_pallas.py:821-824) every tap of
//   an 8x8 patch and its bilinear neighbour lie at window columns 2..60
//   and rows 2..28, inside the window and away from its clamps, so
//   `win_read` takes the staged window's pixel straight from the
//   L2-resident stack.  It applies the window's clamps all the same, so
//   every read, the final resample of a feature that left the window
//   included, returns exactly the pixel the staged copy held; the TPU's
//   one-hot matmul schedule was shaped for its matrix unit and computes
//   the same bilinear sample.
// Each gate is on only when the caller gives it (a flag each), as JAX skips
// a gate that is None.  Dead slots return the (NaN-zeroed) initial position,
// mean 0, not converged — what the plain versions return for them.
// ---------------------------------------------------------------------------
constexpr float kPivotFloor = 1e-20f;                 // linsolve._PIVOT_FLOOR
constexpr float kConvStep2 = 4.0f * kMinUpdateSquared;

// geometry/linsolve.py's inv_spd for a 3x3 SPD matrix, in two parts: the
// unrolled Cholesky with the pivot clamped to kPivotFloor (NaN passes
// through, as in torch.clamp), and the forward and back substitution of one
// unit column; the three columns run on three lanes at once.
__device__ __forceinline__ void chol3(const float (&A)[3][3],
                                      float (&Lm)[3][3]) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float s = A[j][j];
#pragma unroll
    for (int k = 0; k < j; ++k) s = s - Lm[j][k] * Lm[j][k];
    Lm[j][j] = sqrtf(s < kPivotFloor ? kPivotFloor : s);
    const float inv = 1.0f / Lm[j][j];
#pragma unroll
    for (int i = j + 1; i < 3; ++i) {
      float t = A[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) t = t - Lm[i][k] * Lm[j][k];
      Lm[i][j] = t * inv;
    }
  }
}

__device__ __forceinline__ void chol_solve_unit(const float (&Lm)[3][3], int c,
                                                float (&x)[3]) {
  float y[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float s = i == c ? 1.0f : 0.0f;
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - Lm[i][k] * y[k];
    y[i] = s / Lm[i][i];
  }
#pragma unroll
  for (int i = 2; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 3; ++k) s = s - Lm[k][i] * x[k];
    x[i] = s / Lm[i][i];
  }
}

// Bilinear read at window coordinates (x, y) of the 32x64 window whose
// top-left is plane pixel (sx, sy), with the staged window's index clamps;
// the plane clamp only keeps windows wider than a tiny plane in memory.
__device__ __forceinline__ float win_read(const float* __restrict__ img,
                                          long long s_r, int H, int W,
                                          int sx, int sy, float x, float y) {
  const float x0f = floorf(x), y0f = floorf(y);
  const float wx = x - x0f, wy = y - y0f;
  int c0, c1, r0, r1;
  floor_index(x0f, kWinCols, &c0, &c1);
  floor_index(y0f, kWinRows, &r0, &r1);
  const float* row0 = img + (long long)min(sy + r0, H - 1) * s_r;
  const float* row1 = img + (long long)min(sy + r1, H - 1) * s_r;
  const int xa = min(sx + c0, W - 1), xb = min(sx + c1, W - 1);
  const float v00 = __ldg(row0 + xa), v01 = __ldg(row0 + xb);
  const float v10 = __ldg(row1 + xa), v11 = __ldg(row1 + xb);
  return (1.0f - wy) * ((1.0f - wx) * v00 + wx * v01)
       + wy * ((1.0f - wx) * v10 + wx * v11);
}

// The launch arguments of both ICLK kernels (the gates are off for
// align_iclk_kernel).
struct IclkArgs {
  const float* stack; long long s_b, s_l, s_r; int L, H, W, h_true, w_true;
  int n_per; const int* lvl;
  const float* T; long long s_tn, s_tr;
  const float* gx; long long s_xn, s_xr;
  const float* gy; long long s_yn, s_yr;
  const float* uv0; long long s_un, s_uc;
  const unsigned char* valid; int n, n_iter, half;
  int zmssd_on; float zmssd_max; int std_on; float std_min;
  float* out_uv; unsigned char* out_conv; float* out_mean;
};

template <int K, bool kWindow>             // patch pixels per lane
__device__ __forceinline__ void iclk_feature(const IclkArgs& a) {
  const int lane = threadIdx.x & 31;
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (i >= a.n) return;
  const int half = a.half;
  const int p = 2 * half;
  const int area = p * p;
  const float u_raw = __ldg(a.uv0 + i * a.s_un);
  const float v_raw = __ldg(a.uv0 + i * a.s_un + a.s_uc);
  const float u_init = finite_or_zero(u_raw);
  const float v_init = finite_or_zero(v_raw);
  if (!a.valid[i]) {
    if (lane == 0) {
      a.out_uv[2 * i] = u_init;
      a.out_uv[2 * i + 1] = v_init;
      a.out_conv[i] = 0;
      a.out_mean[i] = 0.0f;
    }
    return;
  }
  const int H = a.H, W = a.W;
  const long long s_r = a.s_r;
  const int l = min(max(a.lvl[i], 0), a.L - 1);
  const float* __restrict__ img =
      a.stack + (i / a.n_per) * a.s_b + (long long)l * a.s_l;
  // the window kernel's origin (dump_windows: floor(uv) - (32, 16), clamped
  // so the crop fits the padded plane; then the slice start as
  // dynamic_slice clamps it); align_iclk_kernel samples plane coordinates
  int sx = 0, sy = 0;
  float orgx = 0.0f, orgy = 0.0f;
  if (kWindow) {
    const int ox = min(max((int)floorf(u_init) - kWinCols / 2, 0),
                       W - (kWinCols + 1));
    const int oy = min(max((int)floorf(v_init) - kWinRows / 2, 0),
                       H - (kWinRows + 1));
    sx = min(max(ox, 0), max(W - kWinCols, 0));
    sy = min(max(oy, 0), max(H - kWinRows, 0));
    orgx = (float)ox;
    orgy = (float)oy;
  }
  const float wl = (float)(a.w_true >> l), hl = (float)(a.h_true >> l);
  const float m = (float)half + 1.0f;
  const float wb = (float)half + 2.0f;
  // two predicates, then combined: one && chain over all eight tests
  // compiles to branches inside the iteration loop
  auto inb = [&](float x, float y) {
    const bool lvl_ok =
        (x >= m) && (x < wl - 1.0f - m) && (y >= m) && (y < hl - 1.0f - m);
    if (!kWindow) return lvl_ok;
    const bool win_ok = (x - orgx >= wb) && (x - orgx < kWinCols - 1.0f - wb)
                     && (y - orgy >= wb) && (y - orgy < kWinRows - 1.0f - wb);
    return lvl_ok && win_ok;
  };
  float u = u_init, v = v_init, mean = 0.0f;
  float t[K], dx[K], dy[K], offx[K], offy[K], cur[K];
  // Sample at (u, v) with brightness offset `mean`, and this lane's part of
  // the residual sums (gx r, gy r, r) into g[0..2].
  auto sample = [&](float* g) {
    const float cu = u - orgx, cv = v - orgy;      // window coordinates
#pragma unroll
    for (int q = 0; q < K; ++q) {
      cur[q] = 0.0f;
      if (lane + 32 * q < area) {
        const float x = cu + offx[q], y = cv + offy[q];
        cur[q] = kWindow ? win_read(img, s_r, H, W, sx, sy, x, y)
                         : bilin(img, s_r, H, W, x, y);
        const float r = cur[q] - t[q] + mean;
        g[0] += dx[q] * r;
        g[1] += dy[q] * r;
        g[2] += r;
      }
    }
  };
  // The template loads and the first sample (the first iteration's, or the
  // final resample's when the loop does not run) share one memory round
  // trip and one reduction with the Hessian sums (gx^2, gx gy, gx, gy^2,
  // gy) and, for the gates, the template's sum.
  constexpr int kAcc = kWindow ? 9 : 8;
  float acc[kAcc];
#pragma unroll
  for (int e = 0; e < kAcc; ++e) acc[e] = 0.0f;
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int pix = lane + 32 * q;
    const bool on = pix < area;
    const int r = pix / p, c = pix % p;
    t[q] = on ? __ldg(a.T + i * a.s_tn + r * a.s_tr + c) : 0.0f;
    dx[q] = on ? __ldg(a.gx + i * a.s_xn + r * a.s_xr + c) : 0.0f;
    dy[q] = on ? __ldg(a.gy + i * a.s_yn + r * a.s_yr + c) : 0.0f;
    offx[q] = (float)(c - half);
    offy[q] = (float)(r - half);
    acc[3] += dx[q] * dx[q];
    acc[4] += dx[q] * dy[q];
    acc[5] += dx[q];
    acc[6] += dy[q] * dy[q];
    acc[7] += dy[q];
    if constexpr (kWindow) acc[8] += t[q];
  }
  sample(acc);
  warp_sum_n(acc);
  const float Hm[3][3] = {{acc[3] + 1e-6f, acc[4], acc[5]},
                          {acc[4], acc[6] + 1e-6f, acc[7]},
                          {acc[5], acc[7], (float)area + 1e-6f}};
  float Lm[3][3], col[3], hv[3][3];
  chol3(Hm, Lm);
  chol_solve_unit(Lm, lane % 3, col);      // lanes 0-2: columns 0-2
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) hv[r][c] = __shfl_sync(0xffffffffu, col[r], c);
  }
  float g[3] = {acc[0], acc[1], acc[2]};   // residual sums at (u, v, mean)
  auto step = [&](float* d0, float* d1, float* d2) {
    *d0 = hv[0][0] * g[0] + hv[0][1] * g[1] + hv[0][2] * g[2];
    *d1 = hv[1][0] * g[0] + hv[1][1] * g[1] + hv[1][2] * g[2];
    *d2 = hv[2][0] * g[0] + hv[2][1] * g[1] + hv[2][2] * g[2];
  };
  for (int it = 0; it < a.n_iter; ++it) {
    if (!inb(u, v)) break;                 // uniform across the warp
    float d0, d1, d2;
    step(&d0, &d1, &d2);
    u -= d0;
    v -= d1;
    mean -= d2;
    const float step2 = d0 * d0 + d1 * d1;
    // the next iteration's sample, or the final resample after a break
    g[0] = g[1] = g[2] = 0.0f;
    sample(g);
    warp_sum_n(g);
    if (!inb(u, v) || step2 < kMinUpdateSquared) break;
  }
  const bool ok = inb(u, v);
  float d0, d1, d2;
  step(&d0, &d1, &d2);                     // step probe on the final resample
  const float step2 = ok ? d0 * d0 + d1 * d1 : INFINITY;
  const float du = u - (kWindow ? u_init : u_raw);
  const float dv = v - (kWindow ? v_init : v_raw);
  bool conv = (step2 < kConvStep2) && (sqrtf(du * du + dv * dv) < (float)p);
  if constexpr (kWindow) {
    if (a.zmssd_on || a.std_on) {          // appearance gates on the resample
      float s1[1] = {0.0f};
#pragma unroll
      for (int q = 0; q < K; ++q) s1[0] += cur[q];
      warp_sum_n(s1);
      const float cmean = s1[0] / (float)area;
      const float tmean = acc[8] / (float)area;
      float s2[2] = {0.0f, 0.0f};
#pragma unroll
      for (int q = 0; q < K; ++q) {
        if (lane + 32 * q < area) {
          const float cz = cur[q] - cmean;
          const float dz = cz - (t[q] - tmean);
          s2[0] += dz * dz;
          s2[1] += cz * cz;
        }
      }
      warp_sum_n(s2);
      if (a.zmssd_on) conv = conv && (s2[0] < a.zmssd_max);
      if (a.std_on) conv = conv && (sqrtf(s2[1] / (float)area) >= a.std_min);
    }
  }
  if (lane == 0) {
    a.out_uv[2 * i] = u;
    a.out_uv[2 * i + 1] = v;
    a.out_conv[i] = conv ? 1 : 0;
    a.out_mean[i] = mean;
  }
}

template <int K>
__global__ void align_iclk_kernel(const IclkArgs a) {
  iclk_feature<K, false>(a);
}

template <int K>
__global__ void align_iclk_window_kernel(const IclkArgs a) {
  iclk_feature<K, true>(a);
}

inline unsigned blocks_for(long long threads, int per_block) {
  return (unsigned)((threads + per_block - 1) / per_block);
}

template <int K>
int iclk_launch_k(bool window, const IclkArgs& a, cudaStream_t st) {
  const int tpb = 128;                     // 4 features per block
  const dim3 grid(blocks_for((long long)a.n * 32, tpb));
  if (window) {
    align_iclk_window_kernel<K><<<grid, tpb, 0, st>>>(a);
  } else {
    align_iclk_kernel<K><<<grid, tpb, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

int iclk_launch(bool window, const IclkArgs& a, void* stream) {
  if (a.n <= 0) return 0;
  if (a.n_per <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch ((4 * a.half * a.half + 31) / 32) {   // patch pixels per lane
    case 1: return iclk_launch_k<1>(window, a, st);
    case 2: return iclk_launch_k<2>(window, a, st);
    case 3: return iclk_launch_k<3>(window, a, st);
    case 4: return iclk_launch_k<4>(window, a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int launch_sample_patches(const float* stack, long long s_b, long long s_l,
                          long long s_r, int L, int H, int W, const int* lvl,
                          const float* uv, long long s_un, long long s_uc,
                          const unsigned char* valid, int n, int n_per,
                          int half, int grad, float* out, void* stream) {
  if (n <= 0) return 0;
  if (n_per <= 0) return (int)cudaErrorInvalidValue;
  const int area = 4 * half * half;
  const int tpb = area <= 64 ? 64 : 128;
  const int per_block = tpb > area ? tpb / area : 1;
  const int side = 2 * half + 2;
  const size_t smem = grad ? sizeof(float) * per_block * side * side : 0;
  sample_patches_kernel<<<blocks_for(n, per_block), tpb, smem,
                          (cudaStream_t)stream>>>(
      stack, s_b, s_l, s_r, L, H, W, lvl, uv, s_un, s_uc, valid, n, n_per,
      half, grad, per_block, out);
  return (int)cudaGetLastError();
}

int launch_epi_scan(const float* stack, long long s_b, long long s_l,
                    long long s_r, int L, int H, int W, int h_true,
                    int w_true, int n_per, const int* lvl,
                    const float* uv_a, long long s_an, long long s_ac,
                    const float* uv_b, long long s_bn, long long s_bc,
                    const int* n_steps, const float* ref, long long s_rn,
                    long long s_rr, int n, int n_steps_max, int half,
                    float* out_t, float* out_s, void* stream) {
  if (n <= 0) return 0;
  if (n_per <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  constexpr int tpb = 32 * kScanWarps;
#define EPI_SCAN_ARGS                                                        \
  stack, s_b, s_l, s_r, L, h_true, w_true, n_per, lvl, uv_a, s_an, s_ac,    \
      uv_b, s_bn, s_bc, n_steps, ref, s_rn, s_rr, n_steps_max, out_t, out_s
  switch (half) {
    case 1: epi_scan_kernel<1><<<n, tpb, 0, st>>>(EPI_SCAN_ARGS); break;
    case 2: epi_scan_kernel<2><<<n, tpb, 0, st>>>(EPI_SCAN_ARGS); break;
    case 3: epi_scan_kernel<3><<<n, tpb, 0, st>>>(EPI_SCAN_ARGS); break;
    case 4: epi_scan_kernel<4><<<n, tpb, 0, st>>>(EPI_SCAN_ARGS); break;
    case 5: epi_scan_kernel<5><<<n, tpb, 0, st>>>(EPI_SCAN_ARGS); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef EPI_SCAN_ARGS
  return (int)cudaGetLastError();
}

int launch_align_iclk(const float* stack, long long s_b, long long s_l,
                      long long s_r, int L, int H, int W, int h_true,
                      int w_true, int n_per, const int* lvl,
                      const float* T, long long s_tn, long long s_tr,
                      const float* gx, long long s_xn, long long s_xr,
                      const float* gy, long long s_yn, long long s_yr,
                      const float* uv0, long long s_un, long long s_uc,
                      const unsigned char* valid, int n, int n_iter, int half,
                      float* out_uv, unsigned char* out_conv, float* out_mean,
                      void* stream) {
  const IclkArgs a{stack, s_b, s_l, s_r, L, H, W, h_true, w_true, n_per,
                   lvl, T, s_tn, s_tr, gx, s_xn, s_xr, gy, s_yn, s_yr,
                   uv0, s_un, s_uc,
                   valid, n, n_iter, half, 0, 0.0f, 0, 0.0f, out_uv,
                   out_conv, out_mean};
  return iclk_launch(false, a, stream);
}

int launch_align_iclk_window(
    const float* stack, long long s_b, long long s_l, long long s_r, int L,
    int H, int W, int h_true, int w_true, int n_per, const int* lvl,
    const float* T, long long s_tn,
    long long s_tr, const float* gx, long long s_xn, long long s_xr,
    const float* gy, long long s_yn, long long s_yr, const float* uv0,
    long long s_un, long long s_uc, const unsigned char* valid, int n,
    int n_iter, int half, int zmssd_on, float zmssd_max, int std_on,
    float std_min, float* out_uv, unsigned char* out_conv, float* out_mean,
    void* stream) {
  const IclkArgs a{stack, s_b, s_l, s_r, L, H, W, h_true, w_true, n_per,
                   lvl, T, s_tn, s_tr, gx, s_xn, s_xr, gy, s_yn, s_yr,
                   uv0, s_un, s_uc,
                   valid, n, n_iter, half, zmssd_on, zmssd_max, std_on,
                   std_min, out_uv, out_conv, out_mean};
  return iclk_launch(true, a, stream);
}

}  // extern "C"
