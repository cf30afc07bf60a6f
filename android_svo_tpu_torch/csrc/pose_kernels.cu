// Motion-only pose refinement kernel, CUDA C++ for Hopper (sm_90a).
//
// pose_gn_kernel runs the whole of core/pose_opt.py::optimize_pose_plain
// (Gauss-Newton, or Levenberg-Marquardt, with Tukey weights and trust-region
// step acceptance) in one launch: one 256-thread block per frame, B blocks
// for a batch of frames.  It replaces no Pallas kernel (the JAX package
// leaves pose GN to XLA, which fuses it).  It was added because on the card
// the eager version dispatched about 4,400 small ATen launches a frame
// (the unrolled 6x6 Cholesky alone is most of them, in every iteration and
// again for the covariance), about 50 ms of host time a frame with the
// device idle, which set the tracking step's pace.
//
// Bound: latency, not bytes or operations.  A frame reads ~25 KB (C rows of
// a point, a bearing, a level and a flag) and writes ~1 KB; the arithmetic
// is ~0.1 MFLOP.  What takes time is the chain: the MAD scale, then up to
// poseoptim_n_iter serial iterations, each two block reductions (the normal
// equations at the pose, chi2 at the candidate) around one 6x6 solve and one
// SE(3) exponential, then the final system and six column solves.  What the
// design does about it:
//   - the rows are read from device memory once into shared memory and stay
//     there (dynamic shared memory, 29 bytes a row); the pose and the
//     reductions' totals live in shared memory too, so an iteration touches
//     device memory not at all;
//   - every reduction is one pass: each thread sums its rows (tid, tid+256,
//     ...) in row order, a warp-shuffle tree sums each warp, then one thread
//     a value sums the eight warps' partials in warp order.  The order does
//     not depend on blockIdx or on B, so a batched launch rounds each frame
//     as its single launch does, and no atomics are used;
//   - the 6x6 solve and the exponential are a few hundred dependent scalar
//     operations, run by thread 0 while the others wait at the barrier;
//   - under Gauss-Newton a refused step leaves the pose, and so the next
//     iteration's whole computation, unchanged until the Tukey scale is
//     re-seated at iteration 5: such iterations would refuse the same step
//     again and are skipped (the result is the same);
//   - the MAD scale's lower median is selected by rank (each row counts the
//     keys below it, ties broken by row index), not by a sort: n^2 / 256
//     comparisons a thread, a few microseconds at the path's 768-1,200 rows.
//
// It repeats the plain version step by step in float32 (quat_rotate and
// the Sophus exponential of geometry/se3.py, _geo_jacobian's twist order,
// geometry/linsolve.py's unrolled Cholesky with its pivot floor, which
// keeps a NaN a NaN as torch.clamp does); only the order of the sums
// differs.  No fast-math flags.
//
// Plain C interface (nvcc -shared, bound with ctypes); the launcher returns
// the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNH = 21;                   // lower triangle of the 6x6 system
constexpr int kRed = kNH + 7;             // H, g (6), chi2
constexpr float kTukeyB = 8.6851f;        // geometry/robust.py TUKEY_B
constexpr float kMad = 1.48f;             // geometry/robust.py MAD_NORMALIZER
constexpr float kPivotFloor = 1e-20f;     // geometry/linsolve.py
constexpr float kEps2 = 1e-8f;            // geometry/se3.py _EPS2
constexpr unsigned kInfBits = 0x7f800000u;

__device__ __forceinline__ int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// torch.clamp(x, min=lo): a NaN stays NaN (fmaxf would give lo)
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

__device__ __forceinline__ void cross(const float* a, const float* b,
                                      float* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// se3.py quat_rotate: v + 2 (w (qv x v) + qv x (qv x v))
__device__ __forceinline__ void quat_rotate(const float* q, const float* v,
                                            float* o) {
  float uv[3], uuv[3];
  cross(q + 1, v, uv);
  cross(q + 1, uv, uuv);
  for (int i = 0; i < 3; ++i) o[i] = v[i] + 2.0f * (q[0] * uv[i] + uuv[i]);
}

__device__ __forceinline__ void quat_normalize(float* q) {
  const float nrm = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  for (int i = 0; i < 4; ++i) q[i] = q[i] / nrm;
}

__device__ __forceinline__ float tukey(float x) {
  const float r = x / kTukeyB;
  const float w = 1.0f - r * r;
  return fabsf(r) < 1.0f ? w * w : 0.0f;
}

// The rows of one frame, in shared memory.
struct Rows {
  const float *px, *py, *pz, *mx, *my, *ls;
  const unsigned char* valid;
};

// One row's residual at pose P (q[4], t[3]): the plain version's
// `residuals` (the point in the frame with z replaced by 1 where the row is
// not usable, e zero there) and |e|.
struct Res {
  float x, y, zs, ex, ey, en;
  bool ok;
};

__device__ __forceinline__ Res residual(const Rows& R, int r, const float* P) {
  const float p[3] = {R.px[r], R.py[r], R.pz[r]};
  float xyz[3];
  quat_rotate(P, p, xyz);
  Res o;
  o.x = xyz[0] + P[4];
  o.y = xyz[1] + P[5];
  const float z = xyz[2] + P[6];
  o.ok = R.valid[r] && z > 1e-2f;
  o.zs = o.ok ? z : 1.0f;
  const float ls = R.ls[r];
  o.ex = o.ok ? (o.x / o.zs - R.mx[r]) * ls : 0.0f;
  o.ey = o.ok ? (o.y / o.zs - R.my[r]) * ls : 0.0f;
  o.en = sqrtf(o.ex * o.ex + o.ey * o.ey);
  return o;
}

// _geo_jacobian at (x, y, zs) times the level scale: the 2x6 product of
// d(uv)/d(xyz) = [[zi, 0, -x zi^2], [0, zi, -y zi^2]] and [I | -hat(p)],
// twist order (v, w), with the products by zero left out.
__device__ __forceinline__ void jacobian(const Res& e, float ls,
                                         float J[2][6]) {
  const float zi = 1.0f / e.zs, zi2 = zi * zi;
  const float a = -e.x * zi2, b = -e.y * zi2;
  const float x = e.x, y = e.y, z = e.zs;
  const float row0[6] = {zi, 0.0f, a, a * y, zi * z - a * x, -(zi * y)};
  const float row1[6] = {0.0f, zi, b, b * y - zi * z, -(b * x), zi * x};
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    J[0][k] = row0[k] * ls;
    J[1][k] = row1[k] * ls;
  }
}

// Adds one row's weighted normal equations to acc[0..20] (H, lower
// triangle) and, with g, acc[21..26] (J^T W e).
template <bool kG>
__device__ __forceinline__ void add_normal(const Res& e, float ls, float w,
                                           float* acc) {
  float J[2][6], Jw[2][6];
  jacobian(e, ls, J);
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int c = 0; c < 6; ++c) Jw[k][c] = J[k][c] * w;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j)
      acc[tri(i, j)] += Jw[0][i] * J[0][j] + Jw[1][i] * J[1][j];
  if (kG)
#pragma unroll
    for (int i = 0; i < 6; ++i)
      acc[kNH + i] += Jw[0][i] * e.ex + Jw[1][i] * e.ey;
}

// Sums v[0..K) over the block into tot[0..K) (visible to every thread on
// return): a shuffle tree per warp, then the warps' partials in warp order.
template <int K>
__device__ __forceinline__ void block_sum(float* v, float* part, float* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = v[k];
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) part[warp * K + k] = s;
  }
  __syncthreads();
  if (threadIdx.x < K) {
    float s = part[threadIdx.x];
    for (int w = 1; w < kWarps; ++w) s += part[w * K + threadIdx.x];
    tot[threadIdx.x] = s;
  }
  __syncthreads();
}

// linsolve.py _chol_unrolled on the lower triangle h (21 entries).
__device__ void cholesky(const float* h, float L[6][6]) {
  for (int j = 0; j < 6; ++j) {
    float s = h[tri(j, j)];
    for (int k = 0; k < j; ++k) s = s - L[j][k] * L[j][k];
    L[j][j] = sqrtf(clamp_min(s, kPivotFloor));
    const float inv = 1.0f / L[j][j];
    for (int i = j + 1; i < 6; ++i) {
      float t = h[tri(i, j)];
      for (int k = 0; k < j; ++k) t = t - L[i][k] * L[j][k];
      L[i][j] = t * inv;
    }
  }
}

// linsolve.py _chol_solve_cols for one column b.
__device__ void chol_solve(const float L[6][6], const float* b, float* x) {
  float y[6];
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < 6; ++k) s = s - L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

// H + 1e-6 (tr H / 6 + 1) I on the lower triangle.
__device__ __forceinline__ void regularise(float* h) {
  float tr = h[tri(0, 0)];
  for (int i = 1; i < 6; ++i) tr = tr + h[tri(i, i)];
  const float reg = 1e-6f * (tr / 6.0f + 1.0f);
  for (int i = 0; i < 6; ++i) h[tri(i, i)] = h[tri(i, i)] + reg;
}

// SE3.exp(dx).compose(P).normalize(), written to out (q[4], t[3]).
__device__ void exp_compose(const float* dx, const float* P, float* out) {
  const float* rho = dx;
  const float* phi = dx + 3;
  const float theta2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const float theta = sqrtf(clamp_min(theta2, 1e-24f));
  const bool small = theta2 < kEps2;
  const float k = small ? 0.5f - theta2 / 48.0f : sinf(0.5f * theta) / theta;
  float dq[4] = {small ? 1.0f - theta2 / 8.0f : cosf(0.5f * theta),
                 k * phi[0], k * phi[1], k * phi[2]};
  quat_normalize(dq);
  const float a = small ? 0.5f - theta2 / 24.0f
                        : (1.0f - cosf(theta)) / theta2;
  const float b = small ? (float)(1.0 / 6.0) - theta2 / 120.0f
                        : (theta - sinf(theta)) / (theta2 * theta);
  float c1[3], c2[3];
  cross(phi, rho, c1);
  cross(phi, c1, c2);
  // compose: q = normalize(dq * q), t = rotate(dq, t) + dt
  const float* q = P;
  out[0] = dq[0] * q[0] - dq[1] * q[1] - dq[2] * q[2] - dq[3] * q[3];
  out[1] = dq[0] * q[1] + dq[1] * q[0] + dq[2] * q[3] - dq[3] * q[2];
  out[2] = dq[0] * q[2] - dq[1] * q[3] + dq[2] * q[0] + dq[3] * q[1];
  out[3] = dq[0] * q[3] + dq[1] * q[2] - dq[2] * q[1] + dq[3] * q[0];
  quat_normalize(out);
  quat_normalize(out);                    // SE3.normalize()
  float rt[3];
  quat_rotate(dq, P + 4, rt);
  for (int i = 0; i < 3; ++i)
    out[4 + i] = rt[i] + (rho[i] + a * c1[i] + b * c2[i]);
}

__global__ void __launch_bounds__(kThreads)
pose_gn_kernel(const float* __restrict__ q0, long long s_q,
               const float* __restrict__ t0, long long s_t,
               const float* __restrict__ pw, long long s_p,
               const float* __restrict__ fm, long long s_f,
               const int* __restrict__ level, long long s_l,
               const unsigned char* __restrict__ valid, long long s_v,
               const float* __restrict__ focal, long long s_fc,
               int n, int n_iter, float thresh, int lm,
               float* __restrict__ q_out, float* __restrict__ t_out,
               unsigned char* __restrict__ inlier, int* __restrict__ n_inl,
               float* __restrict__ cov, float* __restrict__ chi2_init,
               float* __restrict__ chi2_final) {
  extern __shared__ float sm[];
  __shared__ float part[kWarps * kRed];
  __shared__ float tot[kRed];
  __shared__ float pose[7], cand[7];
  __shared__ float median;
  const int tid = threadIdx.x;
  const long long b = blockIdx.x;

  float* px = sm;
  float* py = px + n;
  float* pz = py + n;
  float* mx = pz + n;
  float* my = mx + n;
  float* ls = my + n;
  unsigned* key = reinterpret_cast<unsigned*>(ls + n);
  unsigned char* vl = reinterpret_cast<unsigned char*>(key + n);
  const Rows R{px, py, pz, mx, my, ls, vl};

  for (int r = tid; r < n; r += kThreads) {
    const float* p = pw + b * s_p + 3LL * r;
    const float* f = fm + b * s_f + 3LL * r;
    px[r] = p[0];
    py[r] = p[1];
    pz[r] = p[2];
    mx[r] = f[0] / f[2];                  // project2d(f_meas)
    my[r] = f[1] / f[2];
    ls[r] = ldexpf(1.0f, -level[b * s_l + r]);   // 1 / 2^level
    vl[r] = valid[b * s_v + r] != 0;
  }
  if (tid < 4) pose[tid] = q0[b * s_q + tid];
  if (tid < 3) pose[4 + tid] = t0[b * s_t + tid];
  if (tid == 0) median = __uint_as_float(kInfBits);
  __syncthreads();

  const float rf = 1.0f / focal[b * s_fc];
  const float scale_fixed = rf * 0.85f;   // 0.85 / focal, as torch rounds it
  const float thresh_px = rf * thresh;

  // the start: chi2_init and the MAD scale over the usable rows
  float P[7];
  for (int i = 0; i < 7; ++i) P[i] = pose[i];
  {
    float v[2] = {0.0f, 0.0f};
    for (int r = tid; r < n; r += kThreads) {
      const Res e = residual(R, r, P);
      key[r] = e.ok ? __float_as_uint(fabsf(e.en)) : kInfBits;
      v[0] += e.en * e.en;
      v[1] += e.ok ? 1.0f : 0.0f;
    }
    block_sum<2>(v, part, tot);
  }
  const float c_init = tot[0];
  const int k_med = max((int)tot[1] - 1, 0) / 2;
  // lower median: the key of rank k_med (keys below, ties by row); the
  // keys are non-negative floats (NaN above +inf), ordered as their bits
  for (int r = tid; r < n; r += kThreads) {
    const unsigned kr = key[r];
    int rank = 0;
    for (int j = 0; j < n; ++j) {
      const unsigned kj = key[j];
      rank += (kj < kr) | ((kj == kr) & (j < r));
    }
    if (rank == k_med) median = __uint_as_float(kr);
  }
  __syncthreads();
  const float scale0 = clamp_min(kMad * median, 1e-7f);

  float mu = 0.01f;
  bool moved = true;
  for (int it = 0; it < n_iter; ++it) {
    // Tukey scale re-seated at ~1 px from iteration 5 on
    const float s = it >= 5 ? scale_fixed : scale0;
    if (!lm && !moved && it != 5) continue;   // the same refused step again
    for (int i = 0; i < 7; ++i) P[i] = pose[i];
    float v[kRed];
#pragma unroll
    for (int i = 0; i < kRed; ++i) v[i] = 0.0f;
    for (int r = tid; r < n; r += kThreads) {
      const Res e = residual(R, r, P);
      const float w = tukey(e.en / s) * (e.ok ? 1.0f : 0.0f);
      add_normal<true>(e, ls[r], w, v);
      v[kRed - 1] += w * e.en * e.en;
    }
    block_sum<kRed>(v, part, tot);
    const float chi2 = tot[kRed - 1];
    if (tid == 0) {
      float h[kNH], L[6][6], g[6], dx[6];
      for (int i = 0; i < kNH; ++i) h[i] = tot[i];
      if (lm)
        for (int i = 0; i < 6; ++i) h[tri(i, i)] = h[tri(i, i)] + mu * h[tri(i, i)];
      regularise(h);
      for (int i = 0; i < 6; ++i) g[i] = -tot[kNH + i];
      cholesky(h, L);
      chol_solve(L, g, dx);
      exp_compose(dx, P, cand);
    }
    __syncthreads();
    float C[7];
    for (int i = 0; i < 7; ++i) C[i] = cand[i];
    float c = 0.0f;
    for (int r = tid; r < n; r += kThreads) {
      const Res e = residual(R, r, C);
      const float w = tukey(e.en / s) * (e.ok ? 1.0f : 0.0f);
      c += w * e.en * e.en;
    }
    block_sum<1>(&c, part, tot);
    const bool accept = tot[0] < chi2;
    if (accept && tid < 7) pose[tid] = C[tid];
    if (lm) mu = accept ? clamp_min(mu / 3.0f, 1e-8f) : mu * 10.0f;
    moved = accept;
    __syncthreads();
  }

  // the end: inliers, the system under the final weights, its inverse
  const float s = n_iter > 5 ? scale_fixed : scale0;
  for (int i = 0; i < 7; ++i) P[i] = pose[i];
  constexpr int kFin = kNH + 2;
  float v[kFin];
#pragma unroll
  for (int i = 0; i < kFin; ++i) v[i] = 0.0f;
  for (int r = tid; r < n; r += kThreads) {
    const Res e = residual(R, r, P);
    const bool in = e.ok && e.en < thresh_px;
    inlier[b * n + r] = in;
    const float w = tukey(e.en / s) * (e.ok ? 1.0f : 0.0f);
    add_normal<false>(e, ls[r], w, v);
    v[kNH] += e.en * e.en;
    v[kNH + 1] += in ? 1.0f : 0.0f;
  }
  block_sum<kFin>(v, part, tot);
  if (tid == 0) {
    float h[kNH], L[6][6];
    for (int i = 0; i < kNH; ++i) h[i] = tot[i];
    regularise(h);
    cholesky(h, L);
    for (int j = 0; j < 6; ++j) {
      float e[6], x[6];
      for (int i = 0; i < 6; ++i) e[i] = i == j ? 1.0f : 0.0f;
      chol_solve(L, e, x);
      for (int i = 0; i < 6; ++i) cov[b * 36 + i * 6 + j] = x[i];
    }
    for (int i = 0; i < 4; ++i) q_out[b * 4 + i] = P[i];
    for (int i = 0; i < 3; ++i) t_out[b * 3 + i] = P[4 + i];
    n_inl[b] = (int)tot[kNH + 1];
    chi2_init[b] = c_init;
    chi2_final[b] = tot[kNH];
  }
}

}  // namespace

// Refines B poses against their rows: frame i reads each input at
// pointer + i * its batch stride (0 for an input the frames share), n rows
// of contiguous points, bearings, levels and flags; the outputs are (B, ...)
// and contiguous.
extern "C" int launch_pose_gn(const float* q0, long long s_q,
                              const float* t0, long long s_t,
                              const float* p_w, long long s_p,
                              const float* f_meas, long long s_f,
                              const int* level, long long s_l,
                              const unsigned char* valid, long long s_v,
                              const float* focal, long long s_fc, int B,
                              int n, int n_iter, float thresh, int lm,
                              float* q_out, float* t_out,
                              unsigned char* inlier, int* n_inl, float* cov,
                              float* chi2_init, float* chi2_final,
                              void* stream) {
  if (B <= 0) return 0;
  if (n < 0 || n_iter < 0) return (int)cudaErrorInvalidValue;
  // six float rows, the median keys and the flags
  const size_t smem = 7 * sizeof(float) * (size_t)n + ((size_t)n + 3) / 4 * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pose_gn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pose_gn_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      q0, s_q, t0, s_t, p_w, s_p, f_meas, s_f, level, s_l, valid, s_v, focal,
      s_fc, n, n_iter, thresh, lm, q_out, t_out, inlier, n_inl, cov,
      chi2_init, chi2_final);
  return (int)cudaGetLastError();
}
