// The tracking step's three Gauss-Newton loops as kernels, CUDA C++ for
// Hopper (sm_90a): pose_gn_kernel (motion-only pose refinement) and, further
// down, point_gn_kernel (structure-only refinement of the selected
// landmarks) and sparse_align_kernel (sparse image alignment), which share
// its helpers.
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
// Plain C interface (nvcc -shared, bound with ctypes); each launcher returns
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

// linsolve.py _chol_unrolled on the lower triangle h (D (D + 1) / 2
// entries: 21 for the 6x6 systems, 6 for point_gn_kernel's 3x3).
template <int D>
__device__ void cholesky(const float* h, float (&L)[D][D]) {
  for (int j = 0; j < D; ++j) {
    float s = h[tri(j, j)];
    for (int k = 0; k < j; ++k) s = s - L[j][k] * L[j][k];
    L[j][j] = sqrtf(clamp_min(s, kPivotFloor));
    const float inv = 1.0f / L[j][j];
    for (int i = j + 1; i < D; ++i) {
      float t = h[tri(i, j)];
      for (int k = 0; k < j; ++k) t = t - L[i][k] * L[j][k];
      L[i][j] = t * inv;
    }
  }
}

// linsolve.py _chol_solve_cols for one column b.
template <int D>
__device__ void chol_solve(const float (&L)[D][D], const float* b, float* x) {
  float y[D];
  for (int i = 0; i < D; ++i) {
    float s = b[i];
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
  for (int i = D - 1; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < D; ++k) s = s - L[k][i] * x[k];
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

// ---------------------------------------------------------------------------
// point_gn_kernel — the tracking step's structure optimisation (the stage
// `point_optimizer`, core/point_opt.py::optimize_selected_plain): the
// selected landmarks' rows gathered from the point arena, every
// Gauss-Newton (or Levenberg-Marquardt) iteration of each against its
// observations, and the new arena's pos and last_optim written, in one
// launch: one 256-thread block per frame, B blocks for a batch.  It
// replaces no Pallas kernel (the JAX package leaves optimize_points to
// XLA).  It was added because on the card the eager stage dispatched ~970
// small ATen launches a frame (the unrolled 3x3 Cholesky, the 2x3
// Jacobians and the masks of five iterations), ~10 ms of host time a frame
// with the device idle, for a few microseconds of arithmetic.
//
// Bound: latency.  A frame selects structureoptim_max_pts (20) landmarks of
// max_obs_per_point (8) observations; each refinement is a chain of
// structureoptim_n_iter (5) dependent steps, each a 3x3 system summed over
// the observations, its solve and the cost at the candidate.  The bytes are
// the arena's two arrays copied into the new ones (16 bytes a row, 8,192
// rows) and ~400 bytes a selected landmark.  What the design does about
// it:
//   - every thread copies the arena's rows first, then, after the
//     barrier, one thread a selected
//     landmark runs its whole refinement in registers, reading its
//     observations and their keyframes' poses through L1, and writes its
//     row.  Landmarks are independent, so nothing is shared and no thread
//     waits on another;
//   - each thread sums its landmark's observations in their order, so the
//     order depends neither on blockIdx nor on B, and a batched launch gives
//     each frame's single launch bit for bit;
//   - a landmark that is not selected keeps its row (the copy).
//
// It repeats the plain version step by step in float32: the keyframe's pose
// applied by quat_rotate, project2d of the measured bearing, the z > 1e-2
// gate, the Jacobian (d project / d xyz) R with R = quat_to_matrix(q),
// H + mu diag(H) under LM, H + 1e-8 I, geometry/linsolve.py's unrolled
// Cholesky with its pivot floor, the accept test `selected & chi2_new <
// chi2`, LM's mu x10 or max(mu / 3, 1e-8).  Only the order of the sums, and
// the multiply-adds nvcc contracts, differ.  No fast-math flags.
// ---------------------------------------------------------------------------
constexpr int kPointThreads = 256;

// One observation of a landmark: its keyframe's pose (q, t), the measured
// bearing on the unit plane (u, v), and whether it counts (a slot filled,
// its keyframe live).
struct PointObs {
  float q[4], t[3], u, v;
  bool live;
};

// One frame's observations and keyframe poses.
struct PointArena {
  const int* kf;                  // (P, O) keyframe slots, -1 empty
  const float* f;                 // (P, O, 3) bearings
  const float* q;                 // (K, 4) world -> keyframe
  const float* t;                 // (K, 3)
  const unsigned char* valid;     // (K,)
  int O;
};

__device__ __forceinline__ PointObs point_obs(const PointArena& A,
                                              long long row, int o) {
  PointObs ob;
  const long long r = row * A.O + o;
  const int kf = A.kf[r];
  // torch.clamp(obs_kf, min=0): an empty slot reads keyframe 0, unused
  const int k = kf < 0 ? 0 : kf;
  ob.live = kf >= 0 && A.valid[k] != 0;
  for (int i = 0; i < 4; ++i) ob.q[i] = A.q[4LL * k + i];
  for (int i = 0; i < 3; ++i) ob.t[i] = A.t[3LL * k + i];
  const float* f = A.f + 3 * r;
  ob.u = f[0] / f[2];                    // project2d(obs_f)
  ob.v = f[1] / f[2];
  return ob;
}

// The observation's residual at p: the point in the keyframe (z replaced
// by 1 where the observation does not count, e zero there).
struct PointRes {
  float x, y, zs, ex, ey;
  bool ok;
};

__device__ __forceinline__ PointRes point_residual(const PointObs& ob,
                                                   const float* p) {
  float xyz[3];
  quat_rotate(ob.q, p, xyz);
  PointRes r;
  r.x = xyz[0] + ob.t[0];
  r.y = xyz[1] + ob.t[1];
  const float z = xyz[2] + ob.t[2];
  r.ok = ob.live && z > 1e-2f;
  r.zs = r.ok ? z : 1.0f;
  r.ex = r.ok ? r.x / r.zs - ob.u : 0.0f;
  r.ey = r.ok ? r.y / r.zs - ob.v : 0.0f;
  return r;
}

// chi2 at p: the squared residuals summed over the observations in order.
__device__ float point_cost(const PointArena& A, long long row,
                            const float* p) {
  float c = 0.0f;
  for (int o = 0; o < A.O; ++o) {
    const PointRes r = point_residual(point_obs(A, row, o), p);
    c += r.ex * r.ex + r.ey * r.ey;
  }
  return c;
}

// se3.py quat_to_matrix, row-major.
__device__ __forceinline__ void quat_to_matrix(const float* q, float* m) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  m[0] = 1.0f - 2.0f * (yy + zz);
  m[1] = 2.0f * (xy - wz);
  m[2] = 2.0f * (xz + wy);
  m[3] = 2.0f * (xy + wz);
  m[4] = 1.0f - 2.0f * (xx + zz);
  m[5] = 2.0f * (yz - wx);
  m[6] = 2.0f * (xz - wy);
  m[7] = 2.0f * (yz + wx);
  m[8] = 1.0f - 2.0f * (xx + yy);
}

// Copies n values of one frame's array from src to dst.
template <typename T>
__device__ __forceinline__ void copy_rows(const T* __restrict__ src,
                                          T* __restrict__ dst, long long n) {
  for (long long i = threadIdx.x; i < n; i += kPointThreads) dst[i] = src[i];
}

__global__ void __launch_bounds__(kPointThreads)
point_gn_kernel(const float* __restrict__ pos, long long s_pos,
                const int* __restrict__ last_optim, long long s_lo,
                const int* __restrict__ obs_kf, long long s_okf,
                const float* __restrict__ obs_f, long long s_of,
                const float* __restrict__ q_kw, long long s_q,
                const float* __restrict__ t_kw, long long s_t,
                const unsigned char* __restrict__ kf_valid, long long s_kv,
                const long long* __restrict__ slots, long long s_sl,
                const unsigned char* __restrict__ sel, long long s_se,
                const int* __restrict__ frame_id, long long s_fi, int P,
                int O, int K, int S, int n_iter, int lm,
                float* __restrict__ pos_out, int* __restrict__ lo_out) {
  const long long b = blockIdx.x;
  const float* pin = pos + b * s_pos;
  const int* lin = last_optim + b * s_lo;
  float* pout = pos_out + b * 3LL * P;
  int* lout = lo_out + b * (long long)P;
  copy_rows(pin, pout, 3LL * P);
  copy_rows(lin, lout, P);
  __syncthreads();

  const PointArena A{obs_kf + b * s_okf, obs_f + b * s_of, q_kw + b * s_q,
                     t_kw + b * s_t, kf_valid + b * s_kv, O};
  for (int s = threadIdx.x; s < S; s += kPointThreads) {
    const long long row = slots[b * s_sl + s];
    if (!sel[b * s_se + s] || row < 0 || row >= P) continue;
    float p[3] = {pin[3 * row], pin[3 * row + 1], pin[3 * row + 2]};
    float c = point_cost(A, row, p);
    float mu = 0.01f;
    for (int it = 0; it < n_iter; ++it) {
      float h[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      float g[3] = {0.0f, 0.0f, 0.0f};
      for (int o = 0; o < O; ++o) {
        const PointObs ob = point_obs(A, row, o);
        const PointRes r = point_residual(ob, p);
        if (!r.ok) continue;                 // J and e are zero there
        const float zi = 1.0f / r.zs, zi2 = zi * zi;
        const float a0 = -r.x * zi2, a1 = -r.y * zi2;
        float R[9], J[2][3];
        quat_to_matrix(ob.q, R);
        for (int k = 0; k < 3; ++k) {        // [[zi, 0, a0], [0, zi, a1]] R
          J[0][k] = zi * R[k] + a0 * R[6 + k];
          J[1][k] = zi * R[3 + k] + a1 * R[6 + k];
        }
        for (int i = 0; i < 3; ++i) {
          for (int j = 0; j <= i; ++j)
            h[tri(i, j)] += J[0][i] * J[0][j] + J[1][i] * J[1][j];
          g[i] += J[0][i] * r.ex + J[1][i] * r.ey;
        }
      }
      for (int i = 0; i < 3; ++i) {
        if (lm) h[tri(i, i)] = h[tri(i, i)] + mu * h[tri(i, i)];
        h[tri(i, i)] = h[tri(i, i)] + 1e-8f;
      }
      float L[3][3], rhs[3], dx[3];
      for (int i = 0; i < 3; ++i) rhs[i] = -g[i];
      cholesky(h, L);
      chol_solve(L, rhs, dx);
      const float cand[3] = {p[0] + dx[0], p[1] + dx[1], p[2] + dx[2]};
      const float c_new = point_cost(A, row, cand);
      const bool accept = c_new < c;
      if (accept) {
        for (int i = 0; i < 3; ++i) p[i] = cand[i];
        c = c_new;
      }
      if (lm) mu = accept ? clamp_min(mu / 3.0f, 1e-8f) : mu * 10.0f;
    }
    for (int i = 0; i < 3; ++i) pout[3 * row + i] = p[i];
    lout[row] = frame_id[b * s_fi];
  }
}

// ---------------------------------------------------------------------------
// sparse_align_kernel — the Gauss-Newton (or Levenberg-Marquardt) loop of
// ops/sparse_align.py::sparse_img_align, every iteration of every level in
// one launch: one 256-thread block per frame, B blocks for a batch.  It
// replaces no Pallas kernel (the JAX package leaves the loop to XLA's
// while-loop).  It was added because on the card each iteration was an
// eager chain of some 360 ATen launches (the SE(3) apply, the camera's
// projection, the bounds test, the sampler, the masks, three fixed-order
// sum trees, the unrolled 6x6 Cholesky, the exponential) ended by a
// blocking read of the stop test, 4.5-5 ms of host time an iteration with
// the device idle, ~9.6 iterations a frame.
//
// What stays on the host is each level's reference side, computed once a
// frame before the launch: the reference points' validity and the sampler's
// patches and central-difference gradients (ops/sparse_align.py::
// _level_refs).  The kernel takes, per level, the validity (n bytes) and the
// patch, gx and gy (n x (2 half)^2 floats each).
//
// Bound: latency.  A frame reads ~200 bytes a row a level (the reference
// side) and ~64 taps a usable row an iteration from an L2-resident level
// plane, and writes 40 bytes; the arithmetic is ~1.3 kFLOP a usable row an
// iteration (the photometric Jacobian J = gx fx jgeo_0 + gy fy jgeo_1 of
// each pixel, its 21 + 6 products, the bilinear taps), ~1 MFLOP an
// iteration at 912 rows.  What takes time is the chain: up to
// img_align_n_iter serial iterations a level, each one block reduction
// around one 6x6 solve and one SE(3) exponential, the next iteration
// waiting on its pose.  What the design does about it:
//   - a level's reference rows are read from device memory once into
//     shared memory and stay there for the level's iterations: the points
//     (12 bytes a row, once a frame), the validity, and the patch, gx and gy
//     transposed to pixel-major rows of an odd pitch (a warp's 32 rows of one
//     pixel fall in 32 banks, and the transposing writes conflict at most
//     two ways): 205 bytes a row at half 2, 187 KB at 912 rows, under the
//     227 KB a block may opt in to.  J is formed per pixel from gx, gy and
//     the row's two Jacobian rows in each iteration, not kept: 96 floats a
//     row (350 KB at 912 rows) fit neither shared memory nor registers.
//     Where the rows do not fit (more rows, or larger patches), the same
//     code reads them from device memory in place, through L1;
//   - the current level plane is read through L1 and L2, not staged: an
//     iteration touches only the usable rows' 5x5 footprints of it, and its
//     largest level (188 x 120 floats at 752x480, 90 KB) would not fit beside
//     the rows;
//   - every reduction is pose_gn_kernel's one pass (block_sum): each thread
//     sums its rows (tid, tid+256, ...) in row order and, within a row, its
//     pixels in order, a warp-shuffle tree sums each warp, then one thread a
//     value sums the eight warps' partials in warp order.  The order does not
//     depend on blockIdx or on B, so a batched launch rounds each frame as
//     its single launch does and each block stops where its own loop stops
//     (the eager batched loop's masked carry); no atomics;
//   - the solve, the exponential, the best-so-far registers, the damping
//     and the stop test are a few hundred dependent scalar operations, run
//     by thread 0 while the block waits at the barrier; the stop test is
//     read from shared memory, so nothing goes back to the host;
//   - the camera is one argument: a distortion-free pinhole, radtan
//     (camera.py's distort, in its order) or ATAN (_rd_factor with its
//     small-r limit), read from the camera's device tensors.
//
// It repeats the plain version step by step in float32: the reference
// points through the pose (quat_rotate), the camera's world2cam, the scale,
// the bounds test with margin half + 1 and z > 1e-3, the sampler's bilinear
// taps with its clamps (as csrc/patch_kernels.cu's bilin), the residuals,
// chi2 over max(usable rows x area, 1), the damping 1e-4 (+ mu) x trace / 6,
// geometry/linsolve.py's Cholesky with its pivot floor, the right
// perturbation T.compose(SE3.exp(dx)).normalize(), GN's rollback and stop on
// a non-improving step or a step under eps, LM's step every iteration with
// mu x10 or max(mu / 3, 1e-8); each level restarts best chi2 at +inf and mu
// at 0.01 from the previous level's best.  Only the order of the sums, and
// the multiply-adds nvcc contracts, differ.  Each level's iteration count
// is written out for the tests; the loop does not need it.
// ---------------------------------------------------------------------------
constexpr int kMaxLevels = 8;
constexpr int kARed = kNH + 8;            // H, g (6), chi2, the usable rows
constexpr int kLevelFields = 11;          // launch_sparse_align's level record
constexpr int kCamPinhole = 0;            // distortion-free pinhole
constexpr int kCamRadtan = 1;             // pinhole with radtan
constexpr int kCamAtan = 2;               // ATAN (FOV)

// One level: where to sample the current frame, and the reference side
// (per frame: pointer + frame * batch stride).
struct AlignLevel {
  const unsigned char* ok;                // (n,) usable reference rows
  const float *patch, *gx, *gy;           // (n, area) each
  long long s_ok, s_patch, s_gx, s_gy;
  int level;                              // plane of the stack
  int rows, cols;                         // the level substack's clamps
};

struct AlignLevels {
  AlignLevel lv[kMaxLevels];
  int count;
};

// The camera's device tensors: fx, fy, cx, cy and radtan's (k1, k2, p1, p2,
// k3) or ATAN's s; its kind and size.
struct AlignCamera {
  const float *fx, *fy, *cx, *cy, *d;
  int kind, width, height;
};

struct CamVals {
  float fx, fy, cx, cy, k1, k2, p1, p2, k3, s, two_tan_half;
  int kind;
};

__device__ __forceinline__ CamVals read_camera(const AlignCamera& c) {
  CamVals o;
  o.kind = c.kind;
  o.fx = *c.fx;
  o.fy = *c.fy;
  o.cx = *c.cx;
  o.cy = *c.cy;
  o.k1 = o.k2 = o.p1 = o.p2 = o.k3 = o.s = o.two_tan_half = 0.0f;
  if (c.kind == kCamRadtan) {
    o.k1 = c.d[0];
    o.k2 = c.d[1];
    o.p1 = c.d[2];
    o.p2 = c.d[3];
    o.k3 = c.d[4];
  } else if (c.kind == kCamAtan) {
    o.s = c.d[0];
    o.two_tan_half = 2.0f * tanf(o.s / 2.0f);
  }
  return o;
}

// camera.py's world2cam of a point at pyramid scale `scale`: project2d,
// the model's distortion, the intrinsics, then the scale.
__device__ __forceinline__ void world2cam(const CamVals& c, const float* p,
                                          float scale, float* u, float* v) {
  float x = p[0] / p[2], y = p[1] / p[2];
  if (c.kind == kCamRadtan) {
    const float r2 = x * x + y * y;
    const float radial = 1.0f + r2 * (c.k1 + r2 * (c.k2 + r2 * c.k3));
    const float xy = x * y;
    const float xd = x * radial + 2.0f * c.p1 * xy
                     + c.p2 * (r2 + 2.0f * x * x);
    const float yd = y * radial + c.p1 * (r2 + 2.0f * y * y)
                     + 2.0f * c.p2 * xy;
    x = xd;
    y = yd;
  } else if (c.kind == kCamAtan) {
    const float r = sqrtf(x * x + y * y);
    const bool small = r < 1e-6f;
    const float rs = small ? 1e-6f : r;
    const float f = small ? c.two_tan_half / c.s
                          : atanf(rs * c.two_tan_half) / (rs * c.s);
    x = x * f;
    y = y * f;
  }
  *u = (c.fx * x + c.cx) * scale;
  *v = (c.fy * y + c.cy) * scale;
}

// csrc/patch_kernels.cu's floor_index and bilin (the sampler's taps and
// clamps), repeated here: each source is its own translation unit.
__device__ __forceinline__ void floor_index(float xf, int n, int* i0,
                                            int* i1) {
  float c = isnan(xf) ? 0.0f : fminf(fmaxf(xf, -1.0f), (float)n);
  int a = (int)c;
  a = min(max(a, 0), n - 1);
  *i0 = a;
  *i1 = min(max(a + 1, 0), n - 1);
}

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

// _level_setup's photometric Jacobian factors of a reference point (x, y,
// z): fx_s times row 0 and fy_s times row 1 of _geo_jacobian (twist order
// (v, w), the products by zero left out); pixel k's J is gx_k a0 + gy_k a1.
__device__ __forceinline__ void jacobian_factors(float x, float y, float z,
                                                 float fxs, float fys,
                                                 float* a0, float* a1) {
  const float zi = 1.0f / z, zi2 = zi * zi;
  const float a = -x * zi2, b = -y * zi2;
  const float row0[6] = {zi, 0.0f, a, a * y, zi * z - a * x, -(zi * y)};
  const float row1[6] = {0.0f, zi, b, b * y - zi * z, -(b * x), zi * x};
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    a0[k] = fxs * row0[k];
    a1[k] = fys * row1[k];
  }
}

// P.compose(SE3.exp(dx)).normalize() (the right perturbation), written to
// out (q[4], t[3]).
__device__ void compose_exp(const float* P, const float* dx, float* out) {
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
  float c1[3], c2[3], dt[3];
  cross(phi, rho, c1);
  cross(phi, c1, c2);
  for (int i = 0; i < 3; ++i) dt[i] = rho[i] + a * c1[i] + b * c2[i];
  // compose: q = normalize(q_P * dq), t = rotate(q_P, dt) + t_P
  const float* q = P;
  out[0] = q[0] * dq[0] - q[1] * dq[1] - q[2] * dq[2] - q[3] * dq[3];
  out[1] = q[0] * dq[1] + q[1] * dq[0] + q[2] * dq[3] - q[3] * dq[2];
  out[2] = q[0] * dq[2] - q[1] * dq[3] + q[2] * dq[0] + q[3] * dq[1];
  out[3] = q[0] * dq[3] + q[1] * dq[2] - q[2] * dq[1] + q[3] * dq[0];
  quat_normalize(out);
  quat_normalize(out);                    // SE3.normalize()
  float rt[3];
  quat_rotate(P, dt, rt);
  for (int i = 0; i < 3; ++i) out[4 + i] = rt[i] + P[4 + i];
}

// One level's reference rows, in shared memory (staged) or in place in
// device memory: point r is (x[r xr], x[r xr + xc], x[r xr + 2 xc]), pixel
// k of row r of patch, gx and gy at [k kr + r rr].
struct RefRows {
  const float *x, *patch, *gx, *gy;
  const unsigned char* ok;
  int xr, xc, kr, rr;
};

// Where row r lands at pose P on the level: whether it is usable (its
// reference usable, z > 1e-3 and the centre inside the margin) and its
// centre (u, v) and point.
struct LevelGeom {
  float scale;
  int h, w, margin;
};

__device__ __forceinline__ bool row_at(const RefRows& R, int r,
                                       const float* P, const CamVals& c,
                                       const LevelGeom& g, float* p,
                                       float* u, float* v) {
  if (!R.ok[r]) return false;
  const float* x = R.x + (long long)r * R.xr;
  p[0] = x[0];
  p[1] = x[R.xc];
  p[2] = x[2 * R.xc];
  float xyz[3];
  quat_rotate(P, p, xyz);
  for (int i = 0; i < 3; ++i) xyz[i] = xyz[i] + P[4 + i];
  if (!(xyz[2] > 1e-3f)) return false;
  world2cam(c, xyz, g.scale, u, v);
  const float m = (float)g.margin;
  return *u >= m && *u < (float)(g.w - 1 - g.margin) && *v >= m
         && *v < (float)(g.h - 1 - g.margin);
}

template <int HALF>
__global__ void __launch_bounds__(kThreads)
sparse_align_kernel(const float* __restrict__ stack, long long s_b,
                    long long s_l, long long s_r,
                    const float* __restrict__ xyz, long long s_x,
                    const float* __restrict__ q0, long long s_q,
                    const float* __restrict__ t0, long long s_t,
                    const AlignCamera cam,
                    const __grid_constant__ AlignLevels lv, int n,
                    int pitch, int staged, int n_iter, float eps, int lm,
                    float* __restrict__ q_out, float* __restrict__ t_out,
                    int* __restrict__ n_tracked, float* __restrict__ chi2_out,
                    int* __restrict__ iters) {
  constexpr int kP = 2 * HALF;
  constexpr int kArea = kP * kP;
  extern __shared__ float sm[];
  __shared__ float part[kWarps * kARed];
  __shared__ float tot[kARed];
  __shared__ float pose[7], best[7];
  __shared__ float best_chi2, mu;
  __shared__ int stop;
  const int tid = threadIdx.x;
  const long long b = blockIdx.x;
  const CamVals c = read_camera(cam);

  // the rows' layout: staged, the points as three pitch-long rows, then the
  // patch, gx and gy as area pitch-long rows each, then the flags
  float* sp = sm + 3 * pitch;
  float* sgx = sp + kArea * pitch;
  float* sgy = sgx + kArea * pitch;
  unsigned char* sok = reinterpret_cast<unsigned char*>(sgy + kArea * pitch);
  RefRows R;
  if (staged) {
    for (int r = tid; r < n; r += kThreads) {
      const float* p = xyz + b * s_x + 3LL * r;
      sm[r] = p[0];
      sm[pitch + r] = p[1];
      sm[2 * pitch + r] = p[2];
    }
    R = RefRows{sm, sp, sgx, sgy, sok, 1, pitch, pitch, 1};
  } else {
    R = RefRows{xyz + b * s_x, nullptr, nullptr, nullptr, nullptr, 3, 1, 1,
                kArea};
  }
  if (tid < 4) pose[tid] = q0[b * s_q + tid];
  if (tid < 3) pose[4 + tid] = t0[b * s_t + tid];
  __syncthreads();

  LevelGeom g{1.0f, 0, 0, HALF + 1};
  const float* img = stack;
  for (int li = 0; li < lv.count; ++li) {
    const AlignLevel& L = lv.lv[li];
    g.scale = ldexpf(1.0f, -L.level);     // 1 / 2^level
    g.h = cam.height >> L.level;
    g.w = cam.width >> L.level;
    const float fxs = c.fx * g.scale, fys = c.fy * g.scale;
    img = stack + b * s_b + L.level * s_l;
    const float* gp = L.patch + b * L.s_patch;
    const float* ggx = L.gx + b * L.s_gx;
    const float* ggy = L.gy + b * L.s_gy;
    const unsigned char* gok = L.ok + b * L.s_ok;
    if (staged) {
      for (int e = tid; e < n * kArea; e += kThreads) {
        const int r = e / kArea, k = e - r * kArea;
        sp[k * pitch + r] = gp[e];
        sgx[k * pitch + r] = ggx[e];
        sgy[k * pitch + r] = ggy[e];
      }
      for (int r = tid; r < n; r += kThreads) sok[r] = gok[r] != 0;
    } else {
      R.patch = gp;
      R.gx = ggx;
      R.gy = ggy;
      R.ok = gok;
    }
    if (tid == 0) {
      for (int i = 0; i < 7; ++i) best[i] = pose[i];
      best_chi2 = __uint_as_float(kInfBits);
      mu = 0.01f;
      stop = n_iter <= 0;
    }
    __syncthreads();

    int it = 0;
    while (!stop) {
      float P[7];
      for (int i = 0; i < 7; ++i) P[i] = pose[i];
      float v[kARed];
#pragma unroll
      for (int i = 0; i < kARed; ++i) v[i] = 0.0f;
      for (int r = tid; r < n; r += kThreads) {
        float p[3], u, w;
        if (!row_at(R, r, P, c, g, p, &u, &w)) continue;
        float a0[6], a1[6];
        jacobian_factors(p[0], p[1], p[2], fxs, fys, a0, a1);
        v[kNH + 7] += 1.0f;
#pragma unroll
        for (int k = 0; k < kArea; ++k) {
          const int pr = k / kP, pc = k - pr * kP;
          const float cur = bilin(img, s_r, L.rows, L.cols,
                                  u + (float)(pc - HALF),
                                  w + (float)(pr - HALF));
          const int at = k * R.kr + r * R.rr;
          const float e = cur - R.patch[at];
          const float gxk = R.gx[at], gyk = R.gy[at];
          float J[6];
#pragma unroll
          for (int q = 0; q < 6; ++q) J[q] = gxk * a0[q] + gyk * a1[q];
          v[kNH + 6] += e * e;
#pragma unroll
          for (int i = 0; i < 6; ++i) {
#pragma unroll
            for (int j = 0; j <= i; ++j) v[tri(i, j)] += J[i] * J[j];
            v[kNH + i] += J[i] * e;
          }
        }
      }
      block_sum<kARed>(v, part, tot);
      if (tid == 0) {
        const int n_meas = max((int)tot[kNH + 7] * kArea, 1);
        const float chi2 = tot[kNH + 6] / (float)n_meas;
        float h[kNH], L6[6][6], rhs[6], dx[6], cand[7];
        for (int i = 0; i < kNH; ++i) h[i] = tot[i];
        float tr = h[tri(0, 0)];
        for (int i = 1; i < 6; ++i) tr = tr + h[tri(i, i)];
        // H + damp I tr / 6 over the whole matrix, as the plain version
        // adds it (off the diagonal 0 x tr, which keeps a non-finite trace)
        const float damp = lm ? 1e-4f + mu : 1e-4f;
        const float on = damp * 1.0f * tr / 6.0f;
        const float off = damp * 0.0f * tr / 6.0f;
        for (int i = 0; i < 6; ++i)
          for (int j = 0; j <= i; ++j)
            h[tri(i, j)] = h[tri(i, j)] + (i == j ? on : off);
        for (int i = 0; i < 6; ++i) rhs[i] = -tot[kNH + i];
        cholesky(h, L6);
        chol_solve(L6, rhs, dx);
        const bool improved = chi2 < best_chi2;
        if (improved) {
          for (int i = 0; i < 7; ++i) best[i] = P[i];
          best_chi2 = chi2;
        }
        compose_exp(P, dx, cand);
        float nrm2 = 0.0f;
        for (int i = 0; i < 6; ++i) nrm2 += dx[i] * dx[i];
        const bool small = sqrtf(nrm2) < eps;
        bool halt;
        if (lm) {
          for (int i = 0; i < 7; ++i) pose[i] = cand[i];
          mu = improved ? clamp_min(mu / 3.0f, 1e-8f) : mu * 10.0f;
          halt = small;
        } else {
          // rollback: once chi2 stops improving, keep the best and stop
          if (improved)
            for (int i = 0; i < 7; ++i) pose[i] = cand[i];
          halt = !improved || small;
        }
        stop = halt || it + 1 >= n_iter;
      }
      ++it;
      __syncthreads();
    }
    if (tid == 0) iters[b * lv.count + li] = it;
    if (tid < 7) pose[tid] = best[tid];
    __syncthreads();
  }

  // the last level: the rows usable at the result, and its chi2
  float P[7];
  for (int i = 0; i < 7; ++i) P[i] = pose[i];
  float cnt = 0.0f;
  if (lv.count > 0) {
    for (int r = tid; r < n; r += kThreads) {
      float p[3], u, w;
      cnt += row_at(R, r, P, c, g, p, &u, &w) ? 1.0f : 0.0f;
    }
  }
  block_sum<1>(&cnt, part, tot);
  if (tid == 0) {
    for (int i = 0; i < 4; ++i) q_out[b * 4 + i] = P[i];
    for (int i = 0; i < 3; ++i) t_out[b * 3 + i] = P[4 + i];
    n_tracked[b] = (int)tot[0];
    chi2_out[b] = lv.count > 0 ? best_chi2 : 0.0f;
  }
}

// The shared memory a launch of n rows stages, and whether it fits beside
// the kernel's static shared memory (else the rows are read in place).
template <int HALF>
int sparse_align_launch(const float* stack, long long s_b, long long s_l,
                        long long s_r, const float* xyz, long long s_x,
                        const float* q0, long long s_q, const float* t0,
                        long long s_t, const AlignCamera& cam,
                        const AlignLevels& lv, int B, int n, int n_iter,
                        float eps, int lm, float* q_out, float* t_out,
                        int* n_tracked, float* chi2, int* iters,
                        cudaStream_t st) {
  constexpr int kArea = 4 * HALF * HALF;
  static int room = -1;                   // dynamic bytes a block may take
  if (room < 0) {
    int dev = 0, optin = 0;
    cudaFuncAttributes attr;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
      e = cudaFuncGetAttributes(&attr, sparse_align_kernel<HALF>);
    if (e != cudaSuccess) return (int)e;
    room = optin - (int)attr.sharedSizeBytes;
    if (room > 48 * 1024) {
      e = cudaFuncSetAttribute(sparse_align_kernel<HALF>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               room);
      if (e != cudaSuccess) return (int)e;
    }
  }
  const int pitch = n | 1;                // odd: a pixel's rows over 32 banks
  const size_t staged = sizeof(float) * (3 + 3 * kArea) * (size_t)pitch
                        + ((size_t)n + 3) / 4 * 4;
  const bool fits = staged <= (size_t)room;
  sparse_align_kernel<HALF><<<B, kThreads, fits ? staged : 0, st>>>(
      stack, s_b, s_l, s_r, xyz, s_x, q0, s_q, t0, s_t, cam, lv, n, pitch,
      (int)fits, n_iter, eps, lm, q_out, t_out, n_tracked, chi2, iters);
  return (int)cudaGetLastError();
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

// Runs structure optimisation for B frames: frame i reads each input at
// pointer + i * its batch stride (0 for an input the frames share): pos
// (P, 3), last_optim (P,), obs_kf (P, O), obs_f (P, O, 3), q_kw (K, 4),
// t_kw (K, 3), kf_valid (K,), slots (S,) int64, sel (S,), frame_id (), each
// contiguous within a frame.  pos_out (B, P, 3) and lo_out (B, P) are
// contiguous: the arena's rows with the selected rows rewritten.
extern "C" int launch_point_gn(const float* pos, long long s_pos,
                               const int* last_optim, long long s_lo,
                               const int* obs_kf, long long s_okf,
                               const float* obs_f, long long s_of,
                               const float* q_kw, long long s_q,
                               const float* t_kw, long long s_t,
                               const unsigned char* kf_valid, long long s_kv,
                               const long long* slots, long long s_sl,
                               const unsigned char* sel, long long s_se,
                               const int* frame_id, long long s_fi, int B,
                               int P, int O, int K, int S, int n_iter, int lm,
                               float* pos_out, int* lo_out, void* stream) {
  if (B <= 0) return 0;
  if (P < 0 || O < 0 || K <= 0 || S < 0 || n_iter < 0)
    return (int)cudaErrorInvalidValue;
  point_gn_kernel<<<B, kPointThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pos, s_pos, last_optim, s_lo, obs_kf, s_okf, obs_f, s_of, q_kw, s_q,
      t_kw, s_t, kf_valid, s_kv, slots, s_sl, sel, s_se, frame_id, s_fi, P, O,
      K, S, n_iter, lm, pos_out, lo_out);
  return (int)cudaGetLastError();
}

// Runs sparse image alignment's loop for B frames: frame i reads each input
// at pointer + i * its batch stride (0 for an input the frames share: the
// camera always, the stack of a single launch), n rows of contiguous points
// and, per level, contiguous flags, patches and gradients.  `levels` is a
// host array of n_levels records of kLevelFields values: the level, the
// substack's rows and cols, then pointer and batch stride of the flags, the
// patches, gx and gy.  The outputs are (B, ...) and contiguous; iters is
// (B, n_levels).
extern "C" int launch_sparse_align(const float* stack, long long s_b,
                                   long long s_l, long long s_r,
                                   const float* xyz, long long s_x,
                                   const float* q0, long long s_q,
                                   const float* t0, long long s_t,
                                   const float* fx, const float* fy,
                                   const float* cx, const float* cy,
                                   const float* dist, int cam_kind, int width,
                                   int height, const long long* levels,
                                   int n_levels, int B, int n, int half,
                                   int n_iter, float eps, int lm,
                                   float* q_out, float* t_out, int* n_tracked,
                                   float* chi2, int* iters, void* stream) {
  if (B <= 0) return 0;
  if (n < 0 || n_iter < 0 || n_levels < 0 || n_levels > kMaxLevels
      || cam_kind < kCamPinhole || cam_kind > kCamAtan)
    return (int)cudaErrorInvalidValue;
  AlignLevels lv;
  lv.count = n_levels;
  for (int i = 0; i < n_levels; ++i) {
    const long long* f = levels + (size_t)i * kLevelFields;
    AlignLevel& L = lv.lv[i];
    L.level = (int)f[0];
    L.rows = (int)f[1];
    L.cols = (int)f[2];
    L.ok = reinterpret_cast<const unsigned char*>(f[3]);
    L.s_ok = f[4];
    L.patch = reinterpret_cast<const float*>(f[5]);
    L.s_patch = f[6];
    L.gx = reinterpret_cast<const float*>(f[7]);
    L.s_gx = f[8];
    L.gy = reinterpret_cast<const float*>(f[9]);
    L.s_gy = f[10];
  }
  const AlignCamera cam{fx, fy, cx, cy, dist, cam_kind, width, height};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SPARSE_ALIGN_ARGS                                                    \
  stack, s_b, s_l, s_r, xyz, s_x, q0, s_q, t0, s_t, cam, lv, B, n, n_iter,   \
      eps, lm, q_out, t_out, n_tracked, chi2, iters, st
  switch (half) {
    case 1: return sparse_align_launch<1>(SPARSE_ALIGN_ARGS);
    case 2: return sparse_align_launch<2>(SPARSE_ALIGN_ARGS);
    case 3: return sparse_align_launch<3>(SPARSE_ALIGN_ARGS);
    case 4: return sparse_align_launch<4>(SPARSE_ALIGN_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SPARSE_ALIGN_ARGS
}
