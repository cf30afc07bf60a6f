// The radtan camera of geometry/camera.py::PinholeCamera as two kernels,
// CUDA C++ for Hopper (sm_90a): camera_cam2world_kernel (pixel -> unit
// bearing: the intrinsics, undistort's 8 fixed Newton steps, the bearing's
// norm) and camera_world2cam_kernel (unit plane, or a 3D point through
// project2d, -> pixel: distort, then the intrinsics).
//
// They replace no Pallas kernel (the JAX package leaves the camera to XLA,
// which fuses it).  They were added because on the card the eager camera
// dispatched one ATen launch per operation: ~250 a cam2world call and ~45 a
// world2cam call, some 2,000 launches of a tracked frame at 752x480.
//
// Bound: neither bytes nor operations.  A row reads 8-12 bytes and writes
// 8-12; cam2world is ~250 flops a row, world2cam ~25.  At the path's
// 768-12,000 rows that is well under a microsecond of the card at either
// peak, far below the launch floor, so the design is one launch a call:
// one thread a row, any leading shape flattened into rows, the camera's
// nine float32 values read from its device tensors by every thread (no
// read back to the host).
//
// Every expression is the plain version's, evaluated in its order with one
// rounding an operation (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn, so
// nvcc contracts no multiply-add): 2.0 * p1 * x * y is ((2 p1) x) y, the
// radial term is nested as written, undistort runs exactly 8 steps with no
// early stop.  So pixels and the unit plane equal the eager ATen ops on the
// card bit for bit.  The bearing's norm sums its three squares in the order
// ATen's norm reduction takes them for a 3-wide last dimension (x^2 + 1,
// then + y^2) and rounds its square root correctly, as ATen does.  No
// fast-math flags.
//
// Plain C interface (nvcc -shared, bound with ctypes); each launcher returns
// the cudaError_t of the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kNewton = 8;                // camera.py undistort's n_iter

struct Radtan {
  float fx, fy, cx, cy, k1, k2, p1, p2, k3;
};

__device__ __forceinline__ Radtan read_radtan(const float* fx,
                                              const float* fy,
                                              const float* cx,
                                              const float* cy,
                                              const float* d) {
  return Radtan{__ldg(fx),    __ldg(fy),    __ldg(cx),
                __ldg(cy),    __ldg(d),     __ldg(d + 1),
                __ldg(d + 2), __ldg(d + 3), __ldg(d + 4)};
}

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}

// x * x + y * y
__device__ __forceinline__ float radius2(float x, float y) {
  return add(mul(x, x), mul(y, y));
}

// 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
__device__ __forceinline__ float radial(const Radtan& c, float r2) {
  return add(1.0f, mul(r2, add(c.k1, mul(r2, add(c.k2, mul(r2, c.k3))))));
}

// r2 + 2.0 * x * x, that is r2 + (2 x) x
__device__ __forceinline__ float r2_plus_2sq(float r2, float x) {
  return add(r2, mul(mul(2.0f, x), x));
}

// camera.py distort
__device__ __forceinline__ void distort(const Radtan& c, float x, float y,
                                        float* xd, float* yd) {
  const float r2 = radius2(x, y);
  const float rad = radial(c, r2);
  const float xy = mul(x, y);
  // x * radial + 2.0 * p1 * xy + p2 * (r2 + 2.0 * x * x)
  *xd = add(add(mul(x, rad), mul(mul(2.0f, c.p1), xy)),
            mul(c.p2, r2_plus_2sq(r2, x)));
  // y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * xy
  *yd = add(add(mul(y, rad), mul(c.p1, r2_plus_2sq(r2, y))),
            mul(mul(2.0f, c.p2), xy));
}

// camera.py undistort: 8 fixed steps of x = (xd - dx) / radial
__device__ __forceinline__ void undistort(const Radtan& c, float xd,
                                          float yd, float* xo, float* yo) {
  const float two_p1 = mul(2.0f, c.p1), two_p2 = mul(2.0f, c.p2);
  float x = xd, y = yd;
#pragma unroll
  for (int i = 0; i < kNewton; ++i) {
    const float r2 = radius2(x, y);
    const float rad = radial(c, r2);
    // 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    const float dx = add(mul(mul(two_p1, x), y),
                         mul(c.p2, r2_plus_2sq(r2, x)));
    // p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    const float dy = add(mul(c.p1, r2_plus_2sq(r2, y)),
                         mul(mul(two_p2, x), y));
    x = __fdiv_rn(__fsub_rn(xd, dx), rad);
    y = __fdiv_rn(__fsub_rn(yd, dy), rad);
  }
  *xo = x;
  *yo = y;
}

// cam2world: px (rows, 2) -> bearing (rows, 3)
__global__ void __launch_bounds__(kThreads)
camera_cam2world_kernel(const float* __restrict__ px, long long rows,
                        const float* fx, const float* fy, const float* cx,
                        const float* cy, const float* dist,
                        float* __restrict__ out) {
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= rows) return;
  const Radtan c = read_radtan(fx, fy, cx, cy, dist);
  const float u = __fdiv_rn(__fsub_rn(px[2 * r], c.cx), c.fx);
  const float v = __fdiv_rn(__fsub_rn(px[2 * r + 1], c.cy), c.fy);
  float x, y;
  undistort(c, u, v, &x, &y);
  // torch.linalg.norm of (x, y, 1): ATen's order, (x^2 + 1^2) + y^2
  const float n = __fsqrt_rn(add(add(mul(x, x), 1.0f), mul(y, y)));
  float* o = out + 3 * r;
  o[0] = __fdiv_rn(x, n);
  o[1] = __fdiv_rn(y, n);
  o[2] = __fdiv_rn(1.0f, n);
}

// world2cam_uv: uv (rows, 2) -> px (rows, 2); with `project` world2cam:
// xyz (rows, 3) -> px, through project2d (x / z, y / z)
__global__ void __launch_bounds__(kThreads)
camera_world2cam_kernel(const float* __restrict__ in, long long rows,
                        int project, const float* fx, const float* fy,
                        const float* cx, const float* cy, const float* dist,
                        float* __restrict__ out) {
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= rows) return;
  const Radtan c = read_radtan(fx, fy, cx, cy, dist);
  float x, y;
  if (project) {
    const float* p = in + 3 * r;
    const float z = p[2];
    x = __fdiv_rn(p[0], z);
    y = __fdiv_rn(p[1], z);
  } else {
    x = in[2 * r];
    y = in[2 * r + 1];
  }
  float xd, yd;
  distort(c, x, y, &xd, &yd);
  out[2 * r] = add(mul(c.fx, xd), c.cx);
  out[2 * r + 1] = add(mul(c.fy, yd), c.cy);
}

int blocks(long long rows) { return (int)((rows + kThreads - 1) / kThreads); }

}  // namespace

// px and out contiguous float32, rows x 2 and rows x 3; fx, fy, cx, cy 0-d
// and dist (k1, k2, p1, p2, k3) on the same device.
extern "C" int launch_camera_cam2world(const float* px, long long rows,
                                       const float* fx, const float* fy,
                                       const float* cx, const float* cy,
                                       const float* dist, float* out,
                                       void* stream) {
  if (rows < 0 || rows > (long long)kThreads * 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  camera_cam2world_kernel<<<blocks(rows), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      px, rows, fx, fy, cx, cy, dist, out);
  return (int)cudaGetLastError();
}

// in contiguous float32, rows x 3 with `project` (else rows x 2); out rows
// x 2; the camera as launch_camera_cam2world's.
extern "C" int launch_camera_world2cam(const float* in, long long rows,
                                       int project, const float* fx,
                                       const float* fy, const float* cx,
                                       const float* cy, const float* dist,
                                       float* out, void* stream) {
  if (rows < 0 || rows > (long long)kThreads * 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  camera_world2cam_kernel<<<blocks(rows), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      in, rows, project, fx, fy, cx, cy, dist, out);
  return (int)cudaGetLastError();
}
