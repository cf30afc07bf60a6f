// Patch kernels of the tracking path, CUDA C++ for Hopper (sm_90a).
//
// Five kernels, each the port of one Pallas TPU kernel of
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

#include <climits>
#include <cuda_runtime.h>
#include <math.h>
#include <type_traits>

namespace {

constexpr float kMinUpdateSquared = 0.03f * 0.03f;   // feature_alignment.cpp:276
constexpr int kWinRows = 32;                          // DUMP_WR
constexpr int kWinCols = 64;                          // DUMP_WC
constexpr unsigned kFull = 0xffffffffu;               // every lane

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

// The bilinear blend of four taps, bilin's expression: the scan's reads
// from a staged tile and from the stack both use it, so they round alike.
__device__ __forceinline__ float lerp4(float v00, float v01, float v10,
                                       float v11, float wx, float wy) {
  return (1.0f - wy) * ((1.0f - wx) * v00 + wx * v01)
       + wy * ((1.0f - wx) * v10 + wx * v11);
}

__device__ __forceinline__ float finite_or_zero(float x) {
  return isfinite(x) ? x : 0.0f;
}

// ---------------------------------------------------------------------------
// sample_patches_kernel — replaces _sample_pallas / _make_sample_kernel
// (android_svo_tpu/ops/patch_pallas.py:124-207).
// Bound: launch latency and the dependent chain of reads.  The bytes are the
// patches written once (48 KB per output plane at the sparse-align shapes,
// 768 x 4x4; 0.5 MB for the batched step's 8,448 rows) and the pixels they
// touch in an L2-resident plane: tenths of a microsecond of HBM time beside
// a launch of about 1.15 us (NVIDIA H100 80GB HBM3, 700 W).  At 8,448 rows
// the per-pixel integer divisions and the per-pixel reads of each
// feature's mask, level and uv cost more than the taps, so:
// - the patch side and the gradient flag are template arguments for the
//   half sizes the callers use (2: sparse alignment; 4: align1d and the
//   gate's gradient form; 1: the tests), so the index arithmetic is shifts
//   and multiplies; any other half runs the same code with a run-time half;
// - a feature's mask, level, frame (i / n_per) and uv are read once, all at
//   once (NaN and +-inf in uv become 0 here, the TPU wrapper's nan_to_num;
//   a null `valid` means every slot is live).  Without gradients one thread
//   computes one output pixel: the first lane of each feature in a warp
//   reads the feature and shuffles it to the feature's other lanes (no
//   barrier), and every pixel reads its 4 taps with bilin's clamps;
// - with gradients one thread per feature reads it into shared memory, each
//   feature's (p+2)^2 grid of bilinear samples at uv + (i - half - 1,
//   j - half - 1) is sampled once into shared memory, and the patch and its
//   central differences are read from it, the TPU kernel's schedule
//   (patch_pallas.py:126,155-159); the plain version samples uv + off +- 1,
//   so the two differ only by the rounding of that sum;
// - features per block: up to 256 threads of whole patches, halved while
//   that would leave fewer than kMinBlocks blocks, down to 64 threads (the
//   batched step's 8,448 4x4 rows: 528 blocks of 256 threads; 768 rows: 192
//   blocks of 64).
// Staging each feature's clamped (p+2)^2 footprint in shared memory and
// blending from it (as probe_patches_kernel does) gave the same bits but
// ran 0.1-0.4 us slower on the single 4x4 and align1d forms and the batched
// 4x4 form, the main path's, and 0.15 us faster only on the batched align1d
// form (build/sample_staged_footprint.patch, tools/patch_ab.py on an NVIDIA
// H100 80GB HBM3 at 700 W): at 16 or 64 pixels a feature, the shared reads
// do not pay for the barrier and the copy.
// Dead slots write zeros.  `out` holds the patch plane, then dx and dy when
// grad is set.
// ---------------------------------------------------------------------------
constexpr int kSampleThreads = 256;
constexpr int kMinBlocks = 264;         // two per SM of an H100's 132

struct SampleFeature {                  // a feature's reads, made once
  const float* img;                     // its frame's level plane
  float u, v;                           // uv, NaN and +-inf as 0
  int live;
};

// Feature i's reads, all issued at once (a dead slot's level and uv are
// read and not used).
__device__ __forceinline__ SampleFeature read_feature(
    int i, const float* __restrict__ stack, long long s_b, long long s_l,
    int L, const int* __restrict__ lvl, const float* __restrict__ uv,
    long long s_un, long long s_uc, const unsigned char* __restrict__ valid,
    int n_per) {
  const bool live = valid == nullptr || valid[i];
  const int l = lvl[i];
  const float u = uv[i * s_un], v = uv[i * s_un + s_uc];
  return {stack + (long long)(i / n_per) * s_b
              + (long long)norm_level(l, L) * s_l,
          finite_or_zero(u), finite_or_zero(v), live};
}

template <int HALF, bool GRAD>           // HALF = 0: half_rt at run time
__global__ void __launch_bounds__(kSampleThreads) sample_patches_kernel(
    const float* __restrict__ stack, long long s_b, long long s_l,
    long long s_r, int L, int H, int W, const int* __restrict__ lvl,
    const float* __restrict__ uv, long long s_un, long long s_uc,
    const unsigned char* __restrict__ valid, int n, int n_per, int half_rt,
    int per_block, float* __restrict__ out) {
  const int half = HALF ? HALF : half_rt;
  const int p = 2 * half;
  const int area = p * p;
  const int f0 = blockIdx.x * per_block;
  const int nf = min(per_block, n - f0);
  if constexpr (!GRAD) {
    // one thread per output pixel; the first lane of each feature in a warp
    // reads the feature and shuffles it to the feature's other lanes
    const int lane = threadIdx.x & 31;
    for (int base = threadIdx.x - lane; base < nf * area;
         base += blockDim.x) {
      const int e = base + lane;
      const int f = e / area;
      const int pix = e - f * area;
      const int src = max(f * area - base, 0);
      SampleFeature a{nullptr, 0.0f, 0.0f, 0};
      if (lane == src && e < nf * area) {
        a = read_feature(f0 + f, stack, s_b, s_l, L, lvl, uv, s_un, s_uc,
                         valid, n_per);
      }
      a.img = reinterpret_cast<const float*>(__shfl_sync(
          kFull, reinterpret_cast<unsigned long long>(a.img), src));
      a.u = __shfl_sync(kFull, a.u, src);
      a.v = __shfl_sync(kFull, a.v, src);
      a.live = __shfl_sync(kFull, a.live, src);
      if (e < nf * area) {
        const int r = pix / p, c = pix - r * p;
        out[(long long)(f0 + f) * area + pix] =
            a.live ? bilin(a.img, s_r, H, W, a.u + (float)(c - half),
                           a.v + (float)(r - half))
                   : 0.0f;
      }
    }
    return;
  }
  // with gradients: each feature's (p+2)^2 grid of samples in shared memory
  extern __shared__ float4 smem_sample[];
  const int s = p + 2;
  const int sarea = s * s;
  SampleFeature* feat = reinterpret_cast<SampleFeature*>(smem_sample);
  float* grid = reinterpret_cast<float*>(feat + per_block);
  for (int f = threadIdx.x; f < nf; f += blockDim.x) {
    feat[f] = read_feature(f0 + f, stack, s_b, s_l, L, lvl, uv, s_un, s_uc,
                           valid, n_per);
  }
  __syncthreads();
#pragma unroll 4
  for (int e = threadIdx.x; e < nf * sarea; e += blockDim.x) {
    const int f = e / sarea;
    const int g = e - f * sarea;
    const int gy = g / s, gx = g - gy * s;
    const SampleFeature& a = feat[f];
    grid[e] = a.live ? bilin(a.img, s_r, H, W, a.u + (float)(gx - half - 1),
                             a.v + (float)(gy - half - 1))
                     : 0.0f;
  }
  __syncthreads();
  const long long plane = (long long)n * area;
  for (int e = threadIdx.x; e < nf * area; e += blockDim.x) {
    const int f = e / area;
    const int pix = e - f * area;
    const int r = pix / p, c = pix - r * p;
    const float* cc = grid + f * sarea + (r + 1) * s + c + 1;
    const long long o = (long long)(f0 + f) * area + pix;
    out[o] = cc[0];
    out[plane + o] = 0.5f * (cc[1] - cc[-1]);
    out[2 * plane + o] = 0.5f * (cc[s] - cc[-s]);
  }
}

// ---------------------------------------------------------------------------
// epi_scan_kernel — replaces _scan_pallas / _make_scan_kernel
// (patch_pallas.py:253-345) together with the rest of epi_scan
// (patch_pallas.py:382-414): the reference's mean-centering and the
// NaN-zeroing of the segment ends.
// Bound: operations by the kernel table's count (the in-bounds steps' 8x8
// bilinear samples and two reductions each: tens of MFLOP, a microsecond
// of fp32 time at the batched step's 8,448 seeds), and in fact the
// instructions each step must issue to keep its score bit for bit: per
// pixel a floor, an index, 4 tap reads and the blend, per step two 5-level
// shuffle butterflies.  Taking the tap reads and blends out of the batched
// scan at the path's spacing cut it from 131 to 73 us and the butterflies
// from 131 to 111 us (ablations with tools/patch_ab.py, NVIDIA H100 80GB
// HBM3, 700 W); the L1 traffic of taps read from the stack, which reading
// them from shared memory removes, was not what held it.  So:
// - a warp walks its steps in chunks of consecutive steps and stages the
//   union of a chunk's footprints once in a shared-memory tile with
//   cp.async (all rows in flight at once): the box of the chunk's live
//   positions' floors widened by -HALF .. +HALF + 1 (the last column and
//   row are room for a tap whose fp32 sum x + off rounds up to the next
//   integer), at most 32 x 32.  Each step reads its taps from the tile (row
//   pitch 40 floats: a warp's 4 rows x 8 columns of taps fall in 32 banks).
//   A chunk is as many steps as the tile holds at the seed's spacing, at
//   most 32 (0.7 px, the tracking path's: 31-32); where not even two fit
//   (over 21 px a step at HALF 4: the gate's 70 px segments of 2-4 steps),
//   or a chunk's box exceeds the tile, the chunk reads its taps from the
//   stack.  The tile is only another place to read the same pixels from:
//   each pixel floors its own x + off and indexes the tile with that floor,
//   and the blend (lerp4), the lane layout (K pixels per lane) and the
//   warp_sum_n butterflies are the stack path's, so every step scores bit
//   for bit alike on either path and under any split of the steps;
// - one block per seed of W warps: 8 up to kFewSeeds seeds, 4 above (the
//   batched step's 8,448: 4 beat 8 and 2 by 13-23%, and one seed per block
//   beat four per block, whose blocks lived as long as their longest seed,
//   tools/patch_ab.py on an NVIDIA H100 80GB HBM3 at 700 W).
//   A seed's chunks are dealt to its warps in turn, the chunk length cut to
//   ceil(k / W) so every warp has one;
// - a seed's reads are issued at once; warp 0 loads the reference through
//   its strides and centres it (warp shuffle sum) into shared memory for
//   the other warps; a chunk's positions are computed once, one step per
//   lane, and broadcast with shuffles;
// - each warp keeps a strict-< running best (score, j) over its steps in
//   increasing order, and the seed's warps are reduced taking the smaller
//   score and, on equal scores, the smaller j: the first minimum, as the
//   sequential strict < and the plain version's argmin.  Every warp starts
//   from (+inf, 0), so a seed with no in-bounds position gives (0, +inf);
//   a step outside the level's margin is never better than +inf and is not
//   sampled; inside the margin every tap lies inside the plane, so the taps
//   skip bilin's clamps (the identity there) and index with 32 bits;
// - seeds with 0 steps (most of the compacted batch in steady state) leave
//   at once; a null `n_steps` means n_steps_max for every seed; the segment
//   ends are read through their strides, NaN and +-inf as 0.
// ---------------------------------------------------------------------------
constexpr int kScanChunk = 32;          // most steps staged at once
constexpr int kTileRows = 32;
constexpr int kTileCols = 32;           // one column per lane
constexpr int kTilePitch = 40;          // 8 mod 32: 4 rows x 8 taps, 32 banks
constexpr int kRefPad = 128;            // the largest patch the scan takes
constexpr int kFewSeeds = 1024;         // 8 warps per seed up to here

// bilin for a tap inside the plane: the same value without the clamps.
__device__ __forceinline__ float bilin_inside(const float* __restrict__ img,
                                              int s_r, float x, float y) {
  const float x0f = floorf(x), y0f = floorf(y);
  const float* row0 = img + ((int)y0f * s_r + (int)x0f);
  const float* row1 = row0 + s_r;
  return lerp4(__ldg(row0), __ldg(row0 + 1), __ldg(row1), __ldg(row1 + 1),
               x - x0f, y - y0f);
}

// The same read from a staged tile whose element (0, 0) is plane pixel
// (ox, oy).
__device__ __forceinline__ float bilin_tile(const float* tile, int ox, int oy,
                                            float x, float y) {
  const float x0f = floorf(x), y0f = floorf(y);
  const float* row0 = tile + (((int)y0f - oy) * kTilePitch + ((int)x0f - ox));
  return lerp4(row0[0], row0[1], row0[kTilePitch], row0[kTilePitch + 1],
               x - x0f, y - y0f);
}

// Asynchronous 4-byte copies from global to shared memory (cp.async,
// sm_80+): a warp issues a whole tile's rows at once and waits for them
// once, where loads into registers would wait a round trip per batch.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

struct ScanArgs {
  const float* stack; long long s_b, s_l, s_r; int L, h_true, w_true;
  int n_per, n; const int* lvl;
  const float* uv_a; long long s_an, s_ac;
  const float* uv_b; long long s_bn, s_bc;
  const int* n_steps; const float* ref; long long s_rn, s_rr;
  int n_steps_max; float* out_t; float* out_s;
};

template <int HALF, int W>
__global__ void __launch_bounds__(32 * W) epi_scan_kernel(const ScanArgs a) {
  constexpr int P = 2 * HALF;
  constexpr int AREA = P * P;
  constexpr int K = (AREA + 31) / 32;      // patch pixels per lane
  __shared__ float tiles[W][kTileRows * kTilePitch];
  __shared__ float rz_s[kRefPad];
  __shared__ float warp_s[W];
  __shared__ int warp_j[W];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long i = blockIdx.x;
  // the seed's reads at once (a seed with no steps reads them unused)
  const int n_i = a.n_steps == nullptr ? a.n_steps_max : a.n_steps[i];
  const int l_i = a.lvl[i];
  const float uax = a.uv_a[i * a.s_an], uay = a.uv_a[i * a.s_an + a.s_ac];
  const float ubx = a.uv_b[i * a.s_bn], uby = a.uv_b[i * a.s_bn + a.s_bc];
  const int k = min(max(n_i, 0), a.n_steps_max);
  if (k == 0) {                            // uniform across the block
    if (threadIdx.x == 0) { a.out_t[i] = 0.0f; a.out_s[i] = INFINITY; }
    return;
  }
  const int l = norm_level(l_i, a.L);
  const float* img = a.stack + (i / a.n_per) * a.s_b + (long long)l * a.s_l;
  const int s_r = (int)a.s_r;
  const float wl = (float)(a.w_true >> l), hl = (float)(a.h_true >> l);
  const float m = (float)HALF + 2.0f;
  const float ax = finite_or_zero(uax), ay = finite_or_zero(uay);
  const float bx = finite_or_zero(ubx), by = finite_or_zero(uby);
  float rz[K], offx[K], offy[K];
  if (warp == 0) {                         // the centred reference, once
    float rsum = 0.0f;
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int pix = lane + 32 * q;
      const int r = pix / P, c = pix % P;
      rz[q] = pix < AREA ? a.ref[i * a.s_rn + r * a.s_rr + c] : 0.0f;
      rsum += rz[q];
    }
    const float rmean = warp_sum(rsum) / (float)AREA;
#pragma unroll
    for (int q = 0; q < K; ++q) {
      if (lane + 32 * q < AREA) rz_s[lane + 32 * q] = rz[q] - rmean;
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < K; ++q) {
    const int pix = lane + 32 * q;
    rz[q] = pix < AREA ? rz_s[pix] : 0.0f;
    offx[q] = (float)(pix % P - HALF);
    offy[q] = (float)(pix / P - HALF);
  }
  const float denom = (float)max(k - 1, 1);
  // steps past the first whose footprints one tile holds at this spacing
  const float fit = fminf(
      (float)(kTileCols - 2 * HALF - 3) / (fabsf(bx - ax) / denom),
      (float)(kTileRows - 2 * HALF - 3) / (fabsf(by - ay) / denom));
  const bool tiled = fit >= 1.0f;
  int chunk = !tiled || fit >= (float)(kScanChunk - 1) ? kScanChunk
                                                       : 1 + (int)fit;
  chunk = min(chunk, (k + W - 1) / W);
  float* tile = tiles[warp];
  float best_s = INFINITY;
  int best_j = 0;
  for (int c0 = warp * chunk; c0 < k; c0 += W * chunk) {
    const int c1 = min(c0 + chunk, k);
    float px = 0.0f, py = 0.0f;            // lane q places step c0 + q
    bool pl = false;
    if (c0 + lane < c1) {
      const float t = fminf((float)(c0 + lane) / denom, 1.0f);
      px = ax * (1.0f - t) + bx * t;
      py = ay * (1.0f - t) + by * t;
      pl = (px >= m) && (px < wl - 1.0f - m) && (py >= m)
        && (py < hl - 1.0f - m);
    }
    const unsigned live_mask = __ballot_sync(kFull, pl);
    if (live_mask == 0) continue;          // uniform across the warp
    int ox = 0, oy = 0;
    bool use_tile = false;
    if (tiled) {
      const int xl = __reduce_min_sync(kFull, pl ? (int)floorf(px) : INT_MAX);
      const int xh = __reduce_max_sync(kFull, pl ? (int)floorf(px) : INT_MIN);
      const int yl = __reduce_min_sync(kFull, pl ? (int)floorf(py) : INT_MAX);
      const int yh = __reduce_max_sync(kFull, pl ? (int)floorf(py) : INT_MIN);
      ox = xl - HALF;
      oy = yl - HALF;
      const int bw = xh - xl + 2 * HALF + 2, bh = yh - yl + 2 * HALF + 2;
      use_tile = bw <= kTileCols && bh <= kTileRows;
      if (use_tile) {
        __syncwarp();                      // the last chunk's reads are done
        if (lane < bw) {
          const float* src = img + (oy * s_r + ox + lane);
          for (int r = 0; r < bh; ++r) {
            cp_async4(tile + r * kTilePitch + lane, src + r * s_r);
          }
        }
        cp_async_wait_all();
        __syncwarp();
      }
    }
    for (int j = c0; j < c1; j += 2) {
      const int js[2] = {j, j + 1};
      float x[2], y[2];
      bool live[2];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int src = min(js[s] - c0, 31);
        x[s] = __shfl_sync(kFull, px, src);
        y[s] = __shfl_sync(kFull, py, src);
        live[s] = js[s] < c1 && ((live_mask >> src) & 1u);
      }
      if (!live[0] && !live[1]) continue;  // uniform across the warp
      float cur[2][K];
      float mean[2] = {0.0f, 0.0f};
#pragma unroll
      for (int s = 0; s < 2; ++s) {
#pragma unroll
        for (int q = 0; q < K; ++q) {
          const float xx = x[s] + offx[q], yy = y[s] + offy[q];
          cur[s][q] = live[s] && lane + 32 * q < AREA
              ? (use_tile ? bilin_tile(tile, ox, oy, xx, yy)
                          : bilin_inside(img, s_r, xx, yy))
              : 0.0f;
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
  }
  if constexpr (W > 1) {
    if (lane == 0) { warp_s[warp] = best_s; warp_j[warp] = best_j; }
    __syncthreads();
    if (warp != 0) return;
    for (int w = 1; w < W; ++w) {
      const float s = warp_s[w];
      const int j = warp_j[w];
      if (s < best_s || (s == best_s && j < best_j)) {
        best_s = s;
        best_j = j;
      }
    }
  }
  if (lane == 0) {
    a.out_t[i] = fminf((float)best_j / denom, 1.0f);
    a.out_s[i] = best_s;
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
// Bound: the instructions each sample issues, and latency at few rows.
// The bytes are the templates and gradients (768 B per 8x8 feature) and the
// pixels the iterations touch (0.34 us at 768 features, 3.7 us at the
// batched step's 8,448); the work is <= 11 dependent 8x8 samples per
// feature (4.9 updates on average on the batched gate problem), each per
// pixel a floor, 4 tap reads and the blend, then a shuffle reduction of
// the three sums and the 3x3 step.  The one-warp-a-feature layout of 768
// rows took 8.4-8.9 us there and 25-29 us at 8,448 rows (2.0-2.3 waves of
// 7-8 blocks of 128 threads per SM), its time growing with the rows past
// one wave; packing alone, half the waves, did not move it: the issue rate
// of that per-pixel work, not residency, held it (tools/patch_ab.py,
// NVIDIA H100 80GB HBM3, 700 W).  The caller pays for the host work around
// the launch, so each kernel takes its whole function and the wrapper only
// allocates the three outputs:
// - H = J^T J + 1e-6 I over (gx, gy, 1) and its inverse by the explicit
//   Cholesky with pivot floor 1e-20 of geometry/linsolve.py (same order of
//   operations), so near-singular features fail as in the plain version;
//   lanes 0-2 of a feature solve the inverse's three columns at once;
// - T, gx and gy are read through their strides (the caller's strided
//   interior view of patch_gradients is not copied), init_uv too; the
//   iterations start from init_uv with NaN and +-inf set to 0;
// - `converged` = step^2 < 4 * 0.03^2 at the final probe and a drift under
//   one patch side.  align_iclk measures the drift from the raw init_uv
//   (patch_pallas.py:647), so a non-finite start never converges;
//   align_iclk_mxu from the zeroed one;
// - a feature's lanes hold its template and gradients in registers and
//   reduce its three sums with one fused shuffle butterfly per iteration,
//   no __syncthreads.  The first sample is taken with the template loads and
//   reduced with the Hessian sums, so the prologue costs one memory round
//   trip and one reduction;
// - the work per pixel is cut where the bits allow: while inb(u, v) holds,
//   a sample reads its taps without the clamps (the identity there) in
//   32-bit offsets, and where the patch side divides a feature's lanes a
//   lane's pixels share one column, so one x coordinate, its floor and its
//   weights serve them all;
// - the layout follows the row count.  Below kPackRows features (the single
//   frame's 768) a feature has a warp: 32 lanes of K = ceil(area / 32)
//   pixels, every feature's chain on its own warp.  From kPackRows on (the
//   batched step's 8,448), patches of up to 64 pixels are packed V = 2 to a
//   warp: 16 lanes each, every lane standing for two lanes of the warp
//   layout (pixels l + 32q and l + 16 + 32q).  That halves the warps and
//   each feature's shuffles (4 levels, not 5) and the scalar work every
//   lane of a feature repeats (the step, the bounds tests, the 3x3
//   inverse).  The sums keep their bits: a lane forms each stood-for lane's
//   partial in the warp layout's order and adds the two as that layout's
//   xor-16 step does (a + b = b + a), then runs its xor 8, 4, 2, 1 steps
//   (`feature_sum`).  The two features of a warp iterate as long as the
//   longer one: a feature that is done (or dead) keeps its state, issues no
//   reads and joins the warp's shuffles with values nobody uses.  Packing
//   pays from about 3,000 rows and costs below (1,536 rows: 8.0 against
//   7.3 us); kPackRows sits between;
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
// `iclk_residency` reports the layout a launch takes and what the card
// makes of it (registers, spills, resident blocks per SM).  Measured and not
// taken (build/iclk_*.patch): __launch_bounds__ for 8 blocks of 128 per SM
// (spills), the window kernel re-reading its final patch and template for
// the gates instead of holding them (72 registers, not 64, and slower).
// ---------------------------------------------------------------------------
constexpr float kPivotFloor = 1e-20f;                 // linsolve._PIVOT_FLOOR
constexpr float kConvStep2 = 4.0f * kMinUpdateSquared;
constexpr int kIclkThreads = 128;                     // 4 warps per block
constexpr int kPackRows = 2048;                       // 2 features a warp

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

// Sums over a feature's 32 / V lanes of the M values each lane holds for
// the V warp-layout lanes it stands for (p[v]: lane l + (32 / V) v): first
// those partials, added as warp_sum_n's xor steps 16 .. 32 / V add them,
// then the xor steps 16 / V .. 1 across the feature's lanes.  Every lane of
// the feature ends with the sum in p[0], bit for bit warp_sum_n's.
template <int V, int M>
__device__ __forceinline__ void feature_sum(float (&p)[V][M]) {
#pragma unroll
  for (int b = V / 2; b > 0; b >>= 1) {
#pragma unroll
    for (int v = 0; v < b; ++v) {
#pragma unroll
      for (int k = 0; k < M; ++k) p[v][k] = p[v][k] + p[v + b][k];
    }
  }
#pragma unroll
  for (int o = 16 / V; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < M; ++k) p[0][k] += __shfl_xor_sync(kFull, p[0][k], o);
  }
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

// One feature per 32 / V lanes of a warp (V = 1 or 2, module comment).
template <int HALF, int V, bool kWindow>
__device__ __forceinline__ void iclk_feature(const IclkArgs& a) {
  constexpr int P = 2 * HALF;
  constexpr int AREA = P * P;
  constexpr int K = (AREA + 31) / 32;      // pixels per warp-layout lane
  constexpr int LPF = 32 / V;              // lanes per feature
  const int lane = threadIdx.x & 31;
  const int l = lane % LPF;                // the feature's lane
  const long long i =
      (((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * V
      + lane / LPF;
  const bool row = i < a.n;
  float u_raw = 0.0f, v_raw = 0.0f;
  bool live = false;
  if (row) {
    u_raw = __ldg(a.uv0 + i * a.s_un);
    v_raw = __ldg(a.uv0 + i * a.s_un + a.s_uc);
    live = a.valid[i];
  }
  const float u_init = finite_or_zero(u_raw);
  const float v_init = finite_or_zero(v_raw);
  if (row && !live && l == 0) {
    a.out_uv[2 * i] = u_init;
    a.out_uv[2 * i + 1] = v_init;
    a.out_conv[i] = 0;
    a.out_mean[i] = 0.0f;
  }
  // a warp whose features are all dead or past n has nothing to do; in any
  // other, every lane stays to the end for the shuffles
  if (!__any_sync(kFull, live)) return;
  const int H = a.H, W = a.W;
  const long long s_r = a.s_r;
  const int l_c = live ? min(max(a.lvl[i], 0), a.L - 1) : 0;
  const float* __restrict__ img =
      a.stack + (live ? (i / a.n_per) * a.s_b : 0) + (long long)l_c * a.s_l;
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
  const float wl = (float)(a.w_true >> l_c), hl = (float)(a.h_true >> l_c);
  const float m = (float)HALF + 1.0f;
  const float wb = (float)HALF + 2.0f;
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
  // [w][q]: pixel l + LPF * w + 32 * q, the warp layout's lane l + LPF * w
  float t[V][K], dx[V][K], dy[V][K], offx[V][K], offy[V][K], cur[V][K];
  // While inb(u, v) holds every tap of the sample lies inside the level
  // (align_iclk_kernel: columns >= 1 and <= w_l - 2) or inside the window,
  // away from its clamps (columns 2..61, rows 2..29), so the reads' clamps
  // are the identity there: such a sample reads its taps without them, in
  // 32-bit offsets from `base` (the plane, or the window's top-left pixel),
  // the same pixels blended by the same expression.  Planes smaller than
  // the window, or too large for 32-bit offsets, always clamp.
  const bool unclamped_ok =
      (long long)H * s_r < INT_MAX
      && (!kWindow || (H >= kWinRows && W >= kWinCols));
  const float* __restrict__ base = img + (long long)sy * s_r + sx;
  const int s_r32 = (int)s_r;
  // Sample at (u, v) with brightness offset `mean`, and each stood-for
  // lane's part of the residual sums (gx r, gy r, r) into g[w][0..2].
  auto sample = [&](auto& g) {
    const float cu = u - orgx, cv = v - orgy;      // window coordinates
    auto pixels = [&](auto inside) {
#pragma unroll
      for (int w = 0; w < V; ++w) {
#pragma unroll
        for (int q = 0; q < K; ++q) {
          cur[w][q] = 0.0f;
          if (l + LPF * w + 32 * q < AREA) {
            const float x = cu + offx[w][q], y = cv + offy[w][q];
            if constexpr (decltype(inside)::value) {
              cur[w][q] = bilin_inside(base, s_r32, x, y);
            } else {
              cur[w][q] = kWindow ? win_read(img, s_r, H, W, sx, sy, x, y)
                                  : bilin(img, s_r, H, W, x, y);
            }
            const float r = cur[w][q] - t[w][q] + mean;
            g[w][0] += dx[w][q] * r;
            g[w][1] += dy[w][q] * r;
            g[w][2] += r;
          }
        }
      }
    };
    if (unclamped_ok && inb(u, v)) {
      pixels(std::true_type{});
    } else {
      pixels(std::false_type{});
    }
  };
  // The template loads and the first sample (the first iteration's, or the
  // final resample's when the loop does not run) share one memory round
  // trip and one reduction with the Hessian sums (gx^2, gx gy, gx, gy^2,
  // gy) and, for the gates, the template's sum.  A dead feature reads
  // nothing.
  constexpr int kAcc = kWindow ? 9 : 8;
  float acc[V][kAcc];
#pragma unroll
  for (int w = 0; w < V; ++w) {
#pragma unroll
    for (int e = 0; e < kAcc; ++e) acc[w][e] = 0.0f;
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int pix = l + LPF * w + 32 * q;
      const bool on = live && pix < AREA;
      // where P divides the lanes per feature, a lane's pixels share their
      // column: one x coordinate (its floor and weights) serves them all
      const int r = pix / P, c = LPF % P == 0 ? l % P : pix % P;
      t[w][q] = on ? __ldg(a.T + i * a.s_tn + r * a.s_tr + c) : 0.0f;
      dx[w][q] = on ? __ldg(a.gx + i * a.s_xn + r * a.s_xr + c) : 0.0f;
      dy[w][q] = on ? __ldg(a.gy + i * a.s_yn + r * a.s_yr + c) : 0.0f;
      offx[w][q] = (float)(c - HALF);
      offy[w][q] = (float)(r - HALF);
      cur[w][q] = 0.0f;
      acc[w][3] += dx[w][q] * dx[w][q];
      acc[w][4] += dx[w][q] * dy[w][q];
      acc[w][5] += dx[w][q];
      acc[w][6] += dy[w][q] * dy[w][q];
      acc[w][7] += dy[w][q];
      if constexpr (kWindow) acc[w][8] += t[w][q];
    }
  }
  if (live) sample(acc);
  feature_sum(acc);
  const float Hm[3][3] = {{acc[0][3] + 1e-6f, acc[0][4], acc[0][5]},
                          {acc[0][4], acc[0][6] + 1e-6f, acc[0][7]},
                          {acc[0][5], acc[0][7], (float)AREA + 1e-6f}};
  float Lm[3][3], col[3], hv[3][3];
  chol3(Hm, Lm);
  chol_solve_unit(Lm, l % 3, col);         // lanes 0-2: columns 0-2
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) hv[r][c] = __shfl_sync(kFull, col[r], c, LPF);
  }
  float g[3] = {acc[0][0], acc[0][1], acc[0][2]};  // sums at (u, v, mean)
  auto step = [&](float* d0, float* d1, float* d2) {
    *d0 = hv[0][0] * g[0] + hv[0][1] * g[1] + hv[0][2] * g[2];
    *d1 = hv[1][0] * g[0] + hv[1][1] * g[1] + hv[1][2] * g[2];
    *d2 = hv[2][0] * g[0] + hv[2][1] * g[1] + hv[2][2] * g[2];
  };
  bool run = live;                         // this feature still iterates
  for (int it = 0; it < a.n_iter; ++it) {
    run = run && inb(u, v);
    if (!__any_sync(kFull, run)) break;    // every feature of the warp done
    float d0, d1, d2;
    step(&d0, &d1, &d2);
    float step2 = 0.0f;
    // the next iteration's sample, or the final resample after a break
    float gn[V][3];
#pragma unroll
    for (int w = 0; w < V; ++w) gn[w][0] = gn[w][1] = gn[w][2] = 0.0f;
    if (run) {
      u -= d0;
      v -= d1;
      mean -= d2;
      step2 = d0 * d0 + d1 * d1;
      sample(gn);
    }
    feature_sum(gn);
    if (run) {
      g[0] = gn[0][0];
      g[1] = gn[0][1];
      g[2] = gn[0][2];
      run = inb(u, v) && !(step2 < kMinUpdateSquared);
    }
  }
  const bool ok = inb(u, v);
  float d0, d1, d2;
  step(&d0, &d1, &d2);                     // step probe on the final resample
  const float step2 = ok ? d0 * d0 + d1 * d1 : INFINITY;
  const float du = u - (kWindow ? u_init : u_raw);
  const float dv = v - (kWindow ? v_init : v_raw);
  bool conv = (step2 < kConvStep2) && (sqrtf(du * du + dv * dv) < (float)P);
  if constexpr (kWindow) {
    if (a.zmssd_on || a.std_on) {          // appearance gates on the resample
      float s1[V][1];
#pragma unroll
      for (int w = 0; w < V; ++w) {
        s1[w][0] = 0.0f;
#pragma unroll
        for (int q = 0; q < K; ++q) s1[w][0] += cur[w][q];
      }
      feature_sum(s1);
      const float cmean = s1[0][0] / (float)AREA;
      const float tmean = acc[0][8] / (float)AREA;
      float s2[V][2];
#pragma unroll
      for (int w = 0; w < V; ++w) {
        s2[w][0] = s2[w][1] = 0.0f;
#pragma unroll
        for (int q = 0; q < K; ++q) {
          if (l + LPF * w + 32 * q < AREA) {
            const float cz = cur[w][q] - cmean;
            const float dz = cz - (t[w][q] - tmean);
            s2[w][0] += dz * dz;
            s2[w][1] += cz * cz;
          }
        }
      }
      feature_sum(s2);
      if (a.zmssd_on) conv = conv && (s2[0][0] < a.zmssd_max);
      if (a.std_on) {
        conv = conv && (sqrtf(s2[0][1] / (float)AREA) >= a.std_min);
      }
    }
  }
  if (live && l == 0) {
    a.out_uv[2 * i] = u;
    a.out_uv[2 * i + 1] = v;
    a.out_conv[i] = conv ? 1 : 0;
    a.out_mean[i] = mean;
  }
}

// ---------------------------------------------------------------------------
// dump_windows_kernel — replaces _dump_pallas / _make_dump_kernel
// (android_svo_tpu/ops/patch_pallas.py:667-696) and the origin arithmetic of
// dump_windows (:720-731).
// Bound: bytes.  Each feature's 32x64 float window (8 KB) is written once
// and its pixels read once (6.3 MB out and at most 3.7 MB in at 768 features
// on a 3x480x640 stack: about 3 us at 3.35 TB/s); there is no arithmetic to
// speak of.  Design: one 256-thread block per feature, each warp copying
// whole window rows (lane j takes columns j and j + 32), so a warp's loads
// and stores are each one contiguous 128-byte run: the loads coalesce at any
// window origin, without the TPU kernel's aligned load and rolls
// (_load_window, patch_pallas.py:92-110), which exist for its (8, 128)
// tiling.  The kernel does the wrapper's host work too: uv is read through
// its strides with NaN and +-inf as 0, the origin is floor(uv) - (32, 16)
// clamped to [0, W - 65] x [0, H - 33], the level is clamped to [0, L - 1],
// and the window is cut at the origin clamped so it fits the plane (XLA's
// dynamic_slice).  A dead row is written as zeros, as the TPU kernel zeroes
// it before its pl.when(valid) copy.  The launcher takes planes of at least
// 32 x 64 pixels.  Batched (dump_windows under torch.func.vmap, the Pallas
// batching rule's batch grid axis): row i cuts its window from frame
// i / n_per of a (B, L, H, W) stack with batch stride s_b; every frame has
// the same (H, W), so the origin is the single launch's.  Rows and outputs
// are indexed in 64 bits (B * n * 2048 floats passes 2^31 at B * n = 1 M).
// ---------------------------------------------------------------------------
constexpr int kDumpThreads = 256;

// clip(floor(x) - offset, 0, room), with x finite (else 0) and clamped
// before the cast so a huge coordinate stays defined
__device__ __forceinline__ int window_origin(float x, int offset, int room) {
  const float f = fminf(fmaxf(floorf(finite_or_zero(x)), -1e9f), 1e9f);
  return min(max((int)f - offset, 0), room);
}

__global__ void __launch_bounds__(kDumpThreads) dump_windows_kernel(
    const float* __restrict__ stack, long long s_b, long long s_l,
    long long s_r, int L, int H, int W, int n_per,
    const int* __restrict__ lvl, const float* __restrict__ uv,
    long long s_un, long long s_uc, const unsigned char* __restrict__ valid,
    float* __restrict__ out_win, int* __restrict__ out_org) {
  const long long i = blockIdx.x;
  const int ox = window_origin(uv[i * s_un], kWinCols / 2,
                               W - (kWinCols + 1));
  const int oy = window_origin(uv[i * s_un + s_uc], kWinRows / 2,
                               H - (kWinRows + 1));
  if (threadIdx.x == 0) {
    out_org[2 * i] = ox;
    out_org[2 * i + 1] = oy;
  }
  float* win = out_win + i * (kWinRows * kWinCols);
  if (!valid[i]) {
    float4* w4 = reinterpret_cast<float4*>(win);
    for (int e = threadIdx.x; e < kWinRows * kWinCols / 4; e += kDumpThreads)
      w4[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return;
  }
  const int sx = min(max(ox, 0), W - kWinCols);
  const int sy = min(max(oy, 0), H - kWinRows);
  const float* src = stack + (i / n_per) * s_b
                   + (long long)min(max(lvl[i], 0), L - 1) * s_l
                   + (long long)sy * s_r + sx;
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < kWinRows; r += kDumpThreads / 32) {
    const float* row = src + r * s_r;
    win[r * kWinCols + lane] = __ldg(row + lane);
    win[r * kWinCols + lane + 32] = __ldg(row + lane + 32);
  }
}

template <int HALF, int V>
__global__ void align_iclk_kernel(const IclkArgs a) {
  iclk_feature<HALF, V, false>(a);
}

template <int HALF, int V>
__global__ void align_iclk_window_kernel(const IclkArgs a) {
  iclk_feature<HALF, V, true>(a);
}

inline unsigned blocks_for(long long threads, int per_block) {
  return (unsigned)((threads + per_block - 1) / per_block);
}

// The ICLK launch for n rows: the entry, its grid and features per warp.
struct IclkLaunch {
  void (*kernel)(IclkArgs);
  unsigned grid;
  int per_warp;
};

template <int HALF, int V>
IclkLaunch iclk_layout_v(bool window, long long n) {
  return {window ? &align_iclk_window_kernel<HALF, V>
                 : &align_iclk_kernel<HALF, V>,
          blocks_for((n + V - 1) / V * 32, kIclkThreads), V};
}

template <int HALF>
IclkLaunch iclk_layout_h(bool window, long long n) {
  if constexpr (4 * HALF * HALF <= 64) {   // 16 lanes hold the patch
    if (n >= kPackRows) return iclk_layout_v<HALF, 2>(window, n);
  }
  return iclk_layout_v<HALF, 1>(window, n);
}

// The layout of a launch of n rows at `half` (kernel null: no such half).
IclkLaunch iclk_layout(bool window, int half, long long n) {
  switch (half) {
    case 1: return iclk_layout_h<1>(window, n);
    case 2: return iclk_layout_h<2>(window, n);
    case 3: return iclk_layout_h<3>(window, n);
    case 4: return iclk_layout_h<4>(window, n);
    case 5: return iclk_layout_h<5>(window, n);
    default: return {nullptr, 0, 0};
  }
}

int iclk_launch(bool window, const IclkArgs& a, void* stream) {
  if (a.n <= 0) return 0;
  if (a.n_per <= 0) return (int)cudaErrorInvalidValue;
  const IclkLaunch k = iclk_layout(window, a.half, a.n);
  if (k.kernel == nullptr) return (int)cudaErrorInvalidValue;
  k.kernel<<<k.grid, kIclkThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Features per block of the sampler for n features of `area` pixels: whole
// patches in up to kSampleThreads threads, halved while that would leave
// fewer than kMinBlocks blocks, down to 64 threads.
int sample_per_block(int n, int area) {
  int per_block = max(kSampleThreads / area, 1);
  while (per_block > 1 && per_block * area > 64
         && blocks_for(n, per_block) < (unsigned)kMinBlocks) {
    per_block /= 2;
  }
  return per_block;
}

#define SAMPLE_ARGS                                                          \
  stack, s_b, s_l, s_r, L, H, W, lvl, uv, s_un, s_uc, valid, n, n_per, half, \
      per_block, out

template <int HALF>
int sample_launch(bool grad, unsigned grid, int tpb, size_t smem,
                  cudaStream_t st, const float* stack, long long s_b,
                  long long s_l, long long s_r, int L, int H, int W,
                  const int* lvl, const float* uv, long long s_un,
                  long long s_uc, const unsigned char* valid, int n,
                  int n_per, int half, int per_block, float* out) {
  if (grad) {
    sample_patches_kernel<HALF, true><<<grid, tpb, smem, st>>>(SAMPLE_ARGS);
  } else {
    sample_patches_kernel<HALF, false><<<grid, tpb, smem, st>>>(SAMPLE_ARGS);
  }
  return (int)cudaGetLastError();
}

// One launch of the scan with W warps per seed.
template <int W>
int epi_scan_launch(const ScanArgs& a, int half, cudaStream_t st) {
  const unsigned grid = (unsigned)a.n;    // one block per seed
  switch (half) {
    case 1: epi_scan_kernel<1, W><<<grid, 32 * W, 0, st>>>(a); break;
    case 2: epi_scan_kernel<2, W><<<grid, 32 * W, 0, st>>>(a); break;
    case 3: epi_scan_kernel<3, W><<<grid, 32 * W, 0, st>>>(a); break;
    case 4: epi_scan_kernel<4, W><<<grid, 32 * W, 0, st>>>(a); break;
    case 5: epi_scan_kernel<5, W><<<grid, 32 * W, 0, st>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int launch_sample_patches(const float* stack, long long s_b, long long s_l,
                          long long s_r, int L, int H, int W, const int* lvl,
                          const float* uv, long long s_un, long long s_uc,
                          const unsigned char* valid, int n, int n_per,
                          int half, int grad, float* out, void* stream) {
  if (n <= 0) return 0;
  if (n_per <= 0 || half < 1) return (int)cudaErrorInvalidValue;
  const int area = 4 * half * half;
  const int side = 2 * half + 2;
  const int per_block = sample_per_block(n, area);
  const int tpb = (min(per_block * area, kSampleThreads) + 31) / 32 * 32;
  const size_t smem = grad ? per_block * (sizeof(SampleFeature)
                                          + sizeof(float) * side * side)
                           : 0;
  const unsigned grid = blocks_for(n, per_block);
  cudaStream_t st = (cudaStream_t)stream;
  switch (half) {
    case 1: return sample_launch<1>(grad, grid, tpb, smem, st, SAMPLE_ARGS);
    case 2: return sample_launch<2>(grad, grid, tpb, smem, st, SAMPLE_ARGS);
    case 4: return sample_launch<4>(grad, grid, tpb, smem, st, SAMPLE_ARGS);
    default: return sample_launch<0>(grad, grid, tpb, smem, st, SAMPLE_ARGS);
  }
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
  const ScanArgs a{stack, s_b, s_l, s_r, L, h_true, w_true, n_per, n, lvl,
                   uv_a, s_an, s_ac, uv_b, s_bn, s_bc, n_steps, ref, s_rn,
                   s_rr, n_steps_max, out_t, out_s};
  cudaStream_t st = (cudaStream_t)stream;
  return n <= kFewSeeds ? epi_scan_launch<8>(a, half, st)
                        : epi_scan_launch<4>(a, half, st);
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

int launch_dump_windows(const float* stack, long long s_b, long long s_l,
                        long long s_r, int L, int H, int W, const int* lvl,
                        const float* uv, long long s_un, long long s_uc,
                        const unsigned char* valid, int n, int n_per,
                        float* out_win, int* out_org, void* stream) {
  if (n <= 0) return 0;
  if (n_per <= 0 || L <= 0 || H < kWinRows || W < kWinCols) {
    return (int)cudaErrorInvalidValue;
  }
  dump_windows_kernel<<<n, kDumpThreads, 0, (cudaStream_t)stream>>>(
      stack, s_b, s_l, s_r, L, H, W, n_per, lvl, uv, s_un, s_uc, valid,
      out_win, out_org);
  return (int)cudaGetLastError();
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

// The layout an ICLK launch of n rows at `half` takes (window: the window
// kernel) and what the card makes of it: out[0..6] = registers per thread,
// local (spill) bytes per thread, resident blocks per SM at the launch's
// block size, threads per block, blocks, features per warp and the card's
// SM count.  Returns the cudaError_t of the queries.
int iclk_residency(int half, int window, int n, int* out) {
  const IclkLaunch k = iclk_layout(window != 0, half, n);
  if (k.kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t rc = cudaFuncGetAttributes(&attr, k.kernel);
  int blocks = 0, dev = 0, sms = 0;
  if (rc == cudaSuccess) {
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k.kernel,
                                                       kIclkThreads, 0);
  }
  if (rc == cudaSuccess) rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) {
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int vals[7] = {attr.numRegs, (int)attr.localSizeBytes, blocks,
                       kIclkThreads, (int)k.grid, k.per_warp, sms};
  for (int j = 0; j < 7; ++j) out[j] = rc == cudaSuccess ? vals[j] : 0;
  return (int)rc;
}

}  // extern "C"
