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
// per-feature state in registers, and read the stack through L2.  Around
// a launch of a few microseconds the wrapper's own tensor ops cost more than
// the kernel, so the redesigned sampler and window ICLK also take over their
// wrappers' conversions and arithmetic (see each kernel's note).
//
// Plain C interface (route (b) of the build: nvcc -shared, bound with ctypes).
// Every launcher returns the cudaError_t of the launch; the caller raises.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kMinUpdateSquared = 0.03f * 0.03f;   // feature_alignment.cpp:276
constexpr int kWinRows = 32;                          // DUMP_WR
constexpr int kWinCols = 64;                          // DUMP_WC
constexpr int kMaxPerLane = 4;                        // patch area <= 128

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
    const float* __restrict__ stack, long long s_l, long long s_r,
    int L, int H, int W, const int* __restrict__ lvl,
    const float* __restrict__ uv, long long s_un, long long s_uc,
    const unsigned char* __restrict__ valid, int n, int half, int grad,
    int per_block, float* __restrict__ out) {
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
      const float* img = stack + (long long)norm_level(lvl[i], L) * s_l;
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
// (patch_pallas.py:253-345).
// Bound: latency.  The work a seed needs is k (<= 100) dependent 8x8 samples
// and two reductions each; the bytes are the inputs (~0.3 MB at B = 768) and
// 6 KB of output.  Design: one warp per seed, two patch pixels per lane, the
// zero-mean reference held in registers, warp-shuffle reductions for the
// mean and the ZMSSD, and a strict-< running best so the first minimum wins
// as in the plain version's argmin.  Seeds with 0 steps exit at once, so the
// dead part of the compacted batch costs one warp slot each.
// ---------------------------------------------------------------------------
__global__ void epi_scan_kernel(
    const float* __restrict__ stack, long long s_l, long long s_r,
    int L, int H, int W, int h_true, int w_true,
    const int* __restrict__ lvl, const float* __restrict__ uv_a,
    const float* __restrict__ uv_b, const int* __restrict__ n_steps,
    const float* __restrict__ ref_zm, int n, int n_steps_max, int half,
    float* __restrict__ out_t, float* __restrict__ out_s) {
  const int lane = threadIdx.x & 31;
  const int i = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  if (i >= n) return;
  const int p = 2 * half;
  const int area = p * p;
  const int l = norm_level(lvl[i], L);
  const float* img = stack + (long long)l * s_l;
  const int k = min(max(n_steps[i], 0), n_steps_max);
  const float wl = (float)(w_true >> l), hl = (float)(h_true >> l);
  const float m = (float)half + 2.0f;
  const float ax = uv_a[2 * i], ay = uv_a[2 * i + 1];
  const float bx = uv_b[2 * i], by = uv_b[2 * i + 1];
  float ref[kMaxPerLane];
  float offx[kMaxPerLane], offy[kMaxPerLane];
#pragma unroll
  for (int q = 0; q < kMaxPerLane; ++q) {
    int pix = lane + 32 * q;
    bool on = pix < area;
    ref[q] = on ? ref_zm[(long long)i * area + pix] : 0.0f;
    offx[q] = (float)(pix % p - half);
    offy[q] = (float)(pix / p - half);
  }
  const float denom = (float)max(k - 1, 1);
  float best_t = 0.0f, best_s = INFINITY;
  for (int j = 0; j < k; ++j) {
    float t = fminf((float)j / denom, 1.0f);
    float x = ax * (1.0f - t) + bx * t;
    float y = ay * (1.0f - t) + by * t;
    float cur[kMaxPerLane];
    float s = 0.0f;
#pragma unroll
    for (int q = 0; q < kMaxPerLane; ++q) {
      bool on = lane + 32 * q < area;
      cur[q] = on ? bilin(img, s_r, H, W, x + offx[q], y + offy[q]) : 0.0f;
      s += cur[q];
    }
    const float mean = warp_sum(s) / (float)area;
    float d2 = 0.0f;
#pragma unroll
    for (int q = 0; q < kMaxPerLane; ++q) {
      if (lane + 32 * q < area) {
        float d = (cur[q] - mean) - ref[q];
        d2 += d * d;
      }
    }
    float score = warp_sum(d2);
    bool inb = (x >= m) && (x < wl - 1.0f - m) && (y >= m) && (y < hl - 1.0f - m);
    score = inb ? score : INFINITY;
    if (score < best_s) { best_s = score; best_t = t; }
  }
  if (lane == 0) { out_t[i] = best_t; out_s[i] = best_s; }
}

// ---------------------------------------------------------------------------
// align_iclk_kernel — replaces _align_pallas / _make_align_kernel
// (patch_pallas.py:422-557).
// Bound: latency.  Per feature, <= 10 dependent iterations of one 8x8
// bilinear sample, three sums and a 3x3 product; inputs ~0.6 MB at B = 768.
// Design: one warp per feature, hinv in registers, the template and its
// gradients two pixels per lane in registers, samples straight from the
// L2-resident stack, three shuffle reductions per iteration.  A feature
// breaks out as soon as its step is below 0.03 px or it leaves the level
// (the plain version's per-feature freeze), then runs the final step probe.
// ---------------------------------------------------------------------------
__global__ void align_iclk_kernel(
    const float* __restrict__ stack, long long s_l, long long s_r,
    int L, int H, int W, int h_true, int w_true,
    const int* __restrict__ lvl, const float* __restrict__ T,
    const float* __restrict__ gx, const float* __restrict__ gy,
    const float* __restrict__ hinv, const float* __restrict__ uv0,
    const unsigned char* __restrict__ valid, int n, int n_iter, int half,
    float* __restrict__ out_uv, float* __restrict__ out_mean,
    float* __restrict__ out_step2) {
  const int lane = threadIdx.x & 31;
  const int i = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  if (i >= n) return;
  const int p = 2 * half;
  const int area = p * p;
  const int l = min(max(lvl[i], 0), L - 1);
  const float* img = stack + (long long)l * s_l;
  const float wl = (float)(w_true >> l), hl = (float)(h_true >> l);
  const float m = (float)half + 1.0f;
  const bool ok0 = valid[i] != 0;
  float hv[9];
#pragma unroll
  for (int e = 0; e < 9; ++e) hv[e] = hinv[(long long)i * 9 + e];
  float t[kMaxPerLane], dx[kMaxPerLane], dy[kMaxPerLane];
  float offx[kMaxPerLane], offy[kMaxPerLane];
#pragma unroll
  for (int q = 0; q < kMaxPerLane; ++q) {
    int pix = lane + 32 * q;
    bool on = pix < area;
    long long o = (long long)i * area + pix;
    t[q] = on ? T[o] : 0.0f;
    dx[q] = on ? gx[o] : 0.0f;
    dy[q] = on ? gy[o] : 0.0f;
    offx[q] = (float)(pix % p - half);
    offy[q] = (float)(pix / p - half);
  }
  float u = uv0[2 * i], v = uv0[2 * i + 1], mean = 0.0f;
  auto inb = [&](float a, float b) {
    return (a >= m) && (a < wl - 1.0f - m) && (b >= m) && (b < hl - 1.0f - m);
  };
  auto update = [&](float* u0, float* u1, float* u2) {
    float g0 = 0.0f, g1 = 0.0f, g2 = 0.0f;
#pragma unroll
    for (int q = 0; q < kMaxPerLane; ++q) {
      if (lane + 32 * q < area) {
        float r = bilin(img, s_r, H, W, u + offx[q], v + offy[q]) - t[q] + mean;
        g0 += dx[q] * r;
        g1 += dy[q] * r;
        g2 += r;
      }
    }
    g0 = warp_sum(g0);
    g1 = warp_sum(g1);
    g2 = warp_sum(g2);
    *u0 = hv[0] * g0 + hv[1] * g1 + hv[2] * g2;
    *u1 = hv[3] * g0 + hv[4] * g1 + hv[5] * g2;
    *u2 = hv[6] * g0 + hv[7] * g1 + hv[8] * g2;
  };
  for (int it = 0; it < n_iter; ++it) {
    if (!(ok0 && inb(u, v))) break;
    float u0, u1, u2;
    update(&u0, &u1, &u2);
    u -= u0;
    v -= u1;
    mean -= u2;
    float step2 = u0 * u0 + u1 * u1;
    if (!inb(u, v) || step2 < kMinUpdateSquared) break;
  }
  float step2 = INFINITY;
  if (ok0 && inb(u, v)) {                  // final step-size probe
    float u0, u1, u2;
    update(&u0, &u1, &u2);
    step2 = u0 * u0 + u1 * u1;
  }
  if (lane == 0) {
    out_uv[2 * i] = u;
    out_uv[2 * i + 1] = v;
    out_mean[i] = mean;
    out_step2[i] = step2;
  }
}

// ---------------------------------------------------------------------------
// align_iclk_window_kernel — replaces _dump_pallas / _make_dump_kernel
// (patch_pallas.py:667-717) together with the whole of align_iclk_mxu
// (patch_pallas.py:779-874): its Hessian and inverse, the window origin, the
// one-hot ICLK, the convergence test and the two appearance gates.
// Bound: latency.  The bytes are the templates and gradients (768 B per 8x8
// feature) and the pixels the iterations touch; the work is <= 11 dependent
// 8x8 samples per feature.  The caller pays for the host work around the
// launch, so the kernel takes the whole function and the wrapper only
// allocates the three outputs:
// - H = J^T J + 1e-6 I over (gx, gy, 1) and its inverse by the explicit
//   Cholesky with pivot floor 1e-20 of geometry/linsolve.py (same order of
//   operations), so near-singular features fail as in the plain version;
//   lanes 0-2 solve the inverse's three columns at once;
// - T, gx and gy are read through their strides (the caller's strided
//   interior view of patch_gradients is not copied), init_uv too, with NaN
//   and +-inf set to 0;
// - the 32x64 window of dump_windows is a predicate, not a copy: while `inb`
//   holds (win_ok, patch_pallas.py:821-824) every tap of an 8x8 patch and
//   its bilinear neighbour lie at window columns 2..60 and rows 2..28,
//   inside the window and away from its clamps, so `win_read` takes the
//   staged window's pixel straight from the L2-resident stack.  It applies
//   the window's clamps all the same, so every read, the final resample of
//   a feature that left the window included, returns exactly the pixel the
//   staged copy held;
// - one warp per feature, as align_iclk_kernel: template and gradients in
//   registers (K pixels per lane), one fused shuffle reduction of the three
//   sums per iteration, no __syncthreads.  The first sample is taken with
//   the template loads and reduced with the Hessian sums, so the prologue
//   costs one memory round trip and one reduction;
// - the TPU's one-hot matmul schedule was shaped for its matrix unit and
//   computes the same bilinear sample.
// Each gate is on only when the caller gives it (a flag each), as JAX skips
// a gate that is None.  Dead slots return the (NaN-zeroed) initial position,
// mean 0, not converged — what the plain version returns for them.
// ---------------------------------------------------------------------------
constexpr float kPivotFloor = 1e-20f;                 // linsolve._PIVOT_FLOOR
constexpr float kConvStep2 = 4.0f * kMinUpdateSquared;

template <int M>
__device__ __forceinline__ void warp_sum_n(float (&v)[M]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < M; ++k) v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
  }
}

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

template <int K>                           // patch pixels per lane
__global__ void align_iclk_window_kernel(
    const float* __restrict__ stack, long long s_l, long long s_r,
    int L, int H, int W, int h_true, int w_true,
    const int* __restrict__ lvl,
    const float* __restrict__ T, long long s_tn, long long s_tr,
    const float* __restrict__ gx, long long s_xn, long long s_xr,
    const float* __restrict__ gy, long long s_yn, long long s_yr,
    const float* __restrict__ uv0, long long s_un, long long s_uc,
    const unsigned char* __restrict__ valid, int n, int n_iter, int half,
    int zmssd_on, float zmssd_max, int std_on, float std_min,
    float* __restrict__ out_uv, unsigned char* __restrict__ out_conv,
    float* __restrict__ out_mean) {
  const int lane = threadIdx.x & 31;
  const int i = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  if (i >= n) return;
  const int p = 2 * half;
  const int area = p * p;
  const float u_init = finite_or_zero(uv0[i * s_un]);
  const float v_init = finite_or_zero(uv0[i * s_un + s_uc]);
  if (!valid[i]) {
    if (lane == 0) {
      out_uv[2 * i] = u_init;
      out_uv[2 * i + 1] = v_init;
      out_conv[i] = 0;
      out_mean[i] = 0.0f;
    }
    return;
  }
  const int l = min(max(lvl[i], 0), L - 1);
  const float* img = stack + (long long)l * s_l;
  // dump_windows' origin: floor(uv) - (32, 16), clamped so the crop fits
  // the padded plane; then the slice start as dynamic_slice clamps it
  const int ox = min(max((int)floorf(u_init) - kWinCols / 2, 0),
                     W - (kWinCols + 1));
  const int oy = min(max((int)floorf(v_init) - kWinRows / 2, 0),
                     H - (kWinRows + 1));
  const int sx = min(max(ox, 0), max(W - kWinCols, 0));
  const int sy = min(max(oy, 0), max(H - kWinRows, 0));
  const float orgx = (float)ox, orgy = (float)oy;

  const float wl = (float)(w_true >> l), hl = (float)(h_true >> l);
  const float m = (float)half + 1.0f;
  const float wb = (float)half + 2.0f;
  auto inb = [&](float a, float b) {
    bool lvl_ok = (a >= m) && (a < wl - 1.0f - m) && (b >= m) && (b < hl - 1.0f - m);
    bool win_ok = (a - orgx >= wb) && (a - orgx < kWinCols - 1.0f - wb)
               && (b - orgy >= wb) && (b - orgy < kWinRows - 1.0f - wb);
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
        cur[q] = win_read(img, s_r, H, W, sx, sy, cu + offx[q], cv + offy[q]);
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
  // gy) and the template's sum.
  float acc[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int pix = lane + 32 * q;
    const bool on = pix < area;
    const int r = pix / p, c = pix % p;
    t[q] = on ? T[i * s_tn + r * s_tr + c] : 0.0f;
    dx[q] = on ? gx[i * s_xn + r * s_xr + c] : 0.0f;
    dy[q] = on ? gy[i * s_yn + r * s_yr + c] : 0.0f;
    offx[q] = (float)(c - half);
    offy[q] = (float)(r - half);
    acc[3] += dx[q] * dx[q];
    acc[4] += dx[q] * dy[q];
    acc[5] += dx[q];
    acc[6] += dy[q] * dy[q];
    acc[7] += dy[q];
    acc[8] += t[q];
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
  for (int it = 0; it < n_iter; ++it) {
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
  const float du = u - u_init, dv = v - v_init;
  bool conv = (step2 < kConvStep2) && (sqrtf(du * du + dv * dv) < (float)p);
  if (zmssd_on || std_on) {                // appearance gates on the resample
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
    if (zmssd_on) conv = conv && (s2[0] < zmssd_max);
    if (std_on) conv = conv && (sqrtf(s2[1] / (float)area) >= std_min);
  }
  if (lane == 0) {
    out_uv[2 * i] = u;
    out_uv[2 * i + 1] = v;
    out_conv[i] = conv ? 1 : 0;
    out_mean[i] = mean;
  }
}

inline unsigned blocks_for(long long threads, int per_block) {
  return (unsigned)((threads + per_block - 1) / per_block);
}

}  // namespace

extern "C" {

int launch_sample_patches(const float* stack, long long s_l, long long s_r,
                          int L, int H, int W, const int* lvl, const float* uv,
                          long long s_un, long long s_uc,
                          const unsigned char* valid, int n, int half,
                          int grad, float* out, void* stream) {
  if (n <= 0) return 0;
  const int area = 4 * half * half;
  const int tpb = area <= 64 ? 64 : 128;
  const int per_block = tpb > area ? tpb / area : 1;
  const int side = 2 * half + 2;
  const size_t smem = grad ? sizeof(float) * per_block * side * side : 0;
  sample_patches_kernel<<<blocks_for(n, per_block), tpb, smem,
                          (cudaStream_t)stream>>>(
      stack, s_l, s_r, L, H, W, lvl, uv, s_un, s_uc, valid, n, half, grad,
      per_block, out);
  return (int)cudaGetLastError();
}

int launch_epi_scan(const float* stack, long long s_l, long long s_r, int L,
                    int H, int W, int h_true, int w_true, const int* lvl,
                    const float* uv_a, const float* uv_b, const int* n_steps,
                    const float* ref_zm, int n, int n_steps_max, int half,
                    float* out_t, float* out_s, void* stream) {
  const int tpb = 128;                     // 4 seeds per block
  epi_scan_kernel<<<blocks_for((long long)n * 32, tpb), tpb, 0,
                    (cudaStream_t)stream>>>(
      stack, s_l, s_r, L, H, W, h_true, w_true, lvl, uv_a, uv_b, n_steps,
      ref_zm, n, n_steps_max, half, out_t, out_s);
  return (int)cudaGetLastError();
}

int launch_align_iclk(const float* stack, long long s_l, long long s_r, int L,
                      int H, int W, int h_true, int w_true, const int* lvl,
                      const float* T, const float* gx, const float* gy,
                      const float* hinv, const float* uv0,
                      const unsigned char* valid, int n, int n_iter, int half,
                      float* out_uv, float* out_mean, float* out_step2,
                      void* stream) {
  const int tpb = 128;                     // 4 features per block
  align_iclk_kernel<<<blocks_for((long long)n * 32, tpb), tpb, 0,
                      (cudaStream_t)stream>>>(
      stack, s_l, s_r, L, H, W, h_true, w_true, lvl, T, gx, gy, hinv, uv0,
      valid, n, n_iter, half, out_uv, out_mean, out_step2);
  return (int)cudaGetLastError();
}

int launch_align_iclk_window(
    const float* stack, long long s_l, long long s_r, int L, int H, int W,
    int h_true, int w_true, const int* lvl, const float* T, long long s_tn,
    long long s_tr, const float* gx, long long s_xn, long long s_xr,
    const float* gy, long long s_yn, long long s_yr, const float* uv0,
    long long s_un, long long s_uc, const unsigned char* valid, int n,
    int n_iter, int half, int zmssd_on, float zmssd_max, int std_on,
    float std_min, float* out_uv, unsigned char* out_conv, float* out_mean,
    void* stream) {
  if (n <= 0) return 0;
  const int tpb = 128;                     // 4 features per block
  const dim3 grid(blocks_for((long long)n * 32, tpb));
  cudaStream_t st = (cudaStream_t)stream;
#define ICLK_WINDOW_ARGS                                                     \
  stack, s_l, s_r, L, H, W, h_true, w_true, lvl, T, s_tn, s_tr, gx, s_xn,    \
      s_xr, gy, s_yn, s_yr, uv0, s_un, s_uc, valid, n, n_iter, half,         \
      zmssd_on, zmssd_max, std_on, std_min, out_uv, out_conv, out_mean
  switch ((4 * half * half + 31) / 32) {   // patch pixels per lane
    case 1: align_iclk_window_kernel<1><<<grid, tpb, 0, st>>>(ICLK_WINDOW_ARGS); break;
    case 2: align_iclk_window_kernel<2><<<grid, tpb, 0, st>>>(ICLK_WINDOW_ARGS); break;
    case 3: align_iclk_window_kernel<3><<<grid, tpb, 0, st>>>(ICLK_WINDOW_ARGS); break;
    case 4: align_iclk_window_kernel<4><<<grid, tpb, 0, st>>>(ICLK_WINDOW_ARGS); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef ICLK_WINDOW_ARGS
  return (int)cudaGetLastError();
}

}  // extern "C"
