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
// feature inside one warp or block (no per-iteration launch, no host sync),
// keep per-feature state in registers, and read the stack through L2.
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
// Bound: bytes.  n*p*p outputs (x3 with grad) written once, 4 (x12) reads per
// output from an L2-resident plane.  At the sparse-align shapes (768 x 4x4)
// that is ~50 KB out: well under a microsecond of HBM time, so launch latency
// dominates.  Design: one thread per output pixel, so a warp covers two 4x4
// patches and consecutive threads read neighbouring pixels; no shared memory
// (the rows a patch touches are in L2/L1 after the first read).
// ---------------------------------------------------------------------------
__global__ void sample_patches_kernel(
    const float* __restrict__ stack, long long s_l, long long s_r,
    int L, int H, int W, const int* __restrict__ lvl,
    const float* __restrict__ uv, const unsigned char* __restrict__ valid,
    int n, int half, int grad, float* __restrict__ out,
    float* __restrict__ out_dx, float* __restrict__ out_dy) {
  const int p = 2 * half;
  const int area = p * p;
  long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (long long)n * area) return;
  int i = (int)(gid / area);
  int pix = (int)(gid % area);
  if (!valid[i]) {                       // dead slots write zeros
    out[gid] = 0.0f;
    if (grad) { out_dx[gid] = 0.0f; out_dy[gid] = 0.0f; }
    return;
  }
  const float* img = stack + (long long)norm_level(lvl[i], L) * s_l;
  float x = uv[2 * i] + (float)(pix % p - half);
  float y = uv[2 * i + 1] + (float)(pix / p - half);
  out[gid] = bilin(img, s_r, H, W, x, y);
  if (grad) {
    out_dx[gid] = 0.5f * (bilin(img, s_r, H, W, x + 1.0f, y)
                          - bilin(img, s_r, H, W, x - 1.0f, y));
    out_dy[gid] = 0.5f * (bilin(img, s_r, H, W, x, y + 1.0f)
                          - bilin(img, s_r, H, W, x, y - 1.0f));
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
// (patch_pallas.py:667-717) together with the one-hot einsum ICLK of
// align_iclk_mxu (patch_pallas.py:748-874).
// Bound: latency.  The bytes are one 8 KB window per feature (6 MB at
// N = 768, under 2 us of HBM time) and the template inputs; the work is <= 11
// 8x8 samples per feature.  Design: one block of p*p threads (one per patch
// pixel) per feature.  The block stages the 32x64 window at the origin the
// wrapper computed (dump_windows' clamp) in shared memory once, then runs
// every ICLK iteration on it with a direct bilinear read — the one-hot matmul
// schedule was shaped for the TPU's matrix unit and computes the same sample.
// Three block reductions per iteration (shuffles, then one shared-memory
// step across the warps), the per-feature freeze, the final resample, and
// from it the ZMSSD and population-std gates.  Dead slots skip the window
// load.
// ---------------------------------------------------------------------------
__device__ __forceinline__ float block_sum(float v, float* red, int nwarps) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();                         // red[] free from the last use
  if (lane == 0) red[w] = v;
  __syncthreads();
  float s = 0.0f;
  for (int k = 0; k < nwarps; ++k) s += red[k];
  return s;
}

__device__ __forceinline__ float win_bilin(const float* win, float x, float y) {
  float x0f = floorf(x), y0f = floorf(y);
  float wx = x - x0f, wy = y - y0f;
  int x0 = min(max((int)fminf(fmaxf(x0f, -1.0f), (float)kWinCols), 0), kWinCols - 1);
  int y0 = min(max((int)fminf(fmaxf(y0f, -1.0f), (float)kWinRows), 0), kWinRows - 1);
  int x1 = min(x0 + 1, kWinCols - 1), y1 = min(y0 + 1, kWinRows - 1);
  float v00 = win[y0 * kWinCols + x0], v01 = win[y0 * kWinCols + x1];
  float v10 = win[y1 * kWinCols + x0], v11 = win[y1 * kWinCols + x1];
  return (1.0f - wy) * ((1.0f - wx) * v00 + wx * v01)
       + wy * ((1.0f - wx) * v10 + wx * v11);
}

__global__ void align_iclk_window_kernel(
    const float* __restrict__ stack, long long s_l, long long s_r,
    int L, int H, int W, int h_true, int w_true,
    const int* __restrict__ lvl, const int* __restrict__ org,
    const float* __restrict__ T, const float* __restrict__ gx,
    const float* __restrict__ gy, const float* __restrict__ hinv,
    const float* __restrict__ uv0, const unsigned char* __restrict__ valid,
    int n, int n_iter, int half, float* __restrict__ out_uv,
    float* __restrict__ out_mean, float* __restrict__ out_step2,
    float* __restrict__ out_score, float* __restrict__ out_std) {
  __shared__ float win[kWinRows * kWinCols];
  __shared__ float red[32];
  const int i = blockIdx.x;
  const int tid = threadIdx.x;
  const int p = 2 * half;
  const int area = p * p;                  // == blockDim.x
  const int nwarps = (area + 31) / 32;
  const float u_init = uv0[2 * i], v_init = uv0[2 * i + 1];
  if (!valid[i]) {                         // dead slot: no window load
    if (tid == 0) {
      out_uv[2 * i] = u_init;
      out_uv[2 * i + 1] = v_init;
      out_mean[i] = 0.0f;
      out_step2[i] = INFINITY;
      out_score[i] = INFINITY;
      out_std[i] = 0.0f;
    }
    return;
  }
  const int l = min(max(lvl[i], 0), L - 1);
  const int ox = org[2 * i], oy = org[2 * i + 1];
  // dump_windows' slice start, clamped so the window fits the plane
  const int sx = min(max(ox, 0), max(W - kWinCols, 0));
  const int sy = min(max(oy, 0), max(H - kWinRows, 0));
  const float* img = stack + (long long)l * s_l;
  for (int e = tid; e < kWinRows * kWinCols; e += blockDim.x) {
    int r = e / kWinCols, c = e % kWinCols;
    win[e] = __ldg(img + (long long)(sy + r) * s_r + sx + c);
  }
  __syncthreads();

  const float orgx = (float)ox, orgy = (float)oy;
  const float wl = (float)(w_true >> l), hl = (float)(h_true >> l);
  const float m = (float)half + 1.0f;
  const float wb = (float)half + 2.0f;
  float hv[9];
#pragma unroll
  for (int e = 0; e < 9; ++e) hv[e] = hinv[(long long)i * 9 + e];
  const long long o = (long long)i * area + tid;
  const float t = T[o], dxv = gx[o], dyv = gy[o];
  const float offx = (float)(tid % p - half), offy = (float)(tid / p - half);
  auto inb = [&](float a, float b) {
    bool lvl_ok = (a >= m) && (a < wl - 1.0f - m) && (b >= m) && (b < hl - 1.0f - m);
    bool win_ok = (a - orgx >= wb) && (a - orgx < kWinCols - 1.0f - wb)
               && (b - orgy >= wb) && (b - orgy < kWinRows - 1.0f - wb);
    return lvl_ok && win_ok;
  };
  float u = u_init, v = v_init, mean = 0.0f;
  float cur = 0.0f;
  auto update = [&](float* u0, float* u1, float* u2) {
    cur = win_bilin(win, (u - orgx) + offx, (v - orgy) + offy);
    float r = cur - t + mean;
    float g0 = block_sum(dxv * r, red, nwarps);
    float g1 = block_sum(dyv * r, red, nwarps);
    float g2 = block_sum(r, red, nwarps);
    *u0 = hv[0] * g0 + hv[1] * g1 + hv[2] * g2;
    *u1 = hv[3] * g0 + hv[4] * g1 + hv[5] * g2;
    *u2 = hv[6] * g0 + hv[7] * g1 + hv[8] * g2;
  };
  for (int it = 0; it < n_iter; ++it) {
    if (!inb(u, v)) break;                 // uniform across the block
    float u0, u1, u2;
    update(&u0, &u1, &u2);
    u -= u0;
    v -= u1;
    mean -= u2;
    float step2 = u0 * u0 + u1 * u1;
    if (!inb(u, v) || step2 < kMinUpdateSquared) break;
  }
  const bool ok = inb(u, v);
  float u0, u1, u2;
  update(&u0, &u1, &u2);                   // final resample + step probe
  const float step2 = ok ? u0 * u0 + u1 * u1 : INFINITY;
  // appearance gates from the final resample
  const float cmean = block_sum(cur, red, nwarps) / (float)area;
  const float tmean = block_sum(t, red, nwarps) / (float)area;
  const float cz = cur - cmean;
  const float var = block_sum(cz * cz, red, nwarps) / (float)area;
  const float dz = cz - (t - tmean);
  const float score = block_sum(dz * dz, red, nwarps);
  if (tid == 0) {
    out_uv[2 * i] = u;
    out_uv[2 * i + 1] = v;
    out_mean[i] = mean;
    out_step2[i] = step2;
    out_score[i] = score;
    out_std[i] = sqrtf(var);
  }
}

inline unsigned blocks_for(long long threads, int per_block) {
  return (unsigned)((threads + per_block - 1) / per_block);
}

}  // namespace

extern "C" {

int launch_sample_patches(const float* stack, long long s_l, long long s_r,
                          int L, int H, int W, const int* lvl, const float* uv,
                          const unsigned char* valid, int n, int half, int grad,
                          float* out, float* out_dx, float* out_dy,
                          void* stream) {
  const int area = 4 * half * half;
  const int tpb = 256;
  sample_patches_kernel<<<blocks_for((long long)n * area, tpb), tpb, 0,
                          (cudaStream_t)stream>>>(
      stack, s_l, s_r, L, H, W, lvl, uv, valid, n, half, grad, out, out_dx,
      out_dy);
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

int launch_align_iclk_window(const float* stack, long long s_l, long long s_r,
                             int L, int H, int W, int h_true, int w_true,
                             const int* lvl, const int* org, const float* T,
                             const float* gx, const float* gy,
                             const float* hinv, const float* uv0,
                             const unsigned char* valid, int n, int n_iter,
                             int half, float* out_uv, float* out_mean,
                             float* out_step2, float* out_score,
                             float* out_std, void* stream) {
  const int area = 4 * half * half;        // one thread per patch pixel
  align_iclk_window_kernel<<<n, area, 0, (cudaStream_t)stream>>>(
      stack, s_l, s_r, L, H, W, h_true, w_true, lvl, org, T, gx, gy, hinv,
      uv0, valid, n, n_iter, half, out_uv, out_mean, out_step2, out_score,
      out_std);
  return (int)cudaGetLastError();
}

}  // extern "C"
