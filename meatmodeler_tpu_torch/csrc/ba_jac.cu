// Per-observation bundle-adjustment Jacobians for Hopper (sm_90a): each
// observation's 2x6 camera and 2x3 point Jacobian of the Rodrigues pinhole
// projection, masked and weighted, one launch per LM iteration for every
// lane of a batch of problems.
//
// Replaces the XLA fusion of meatmodeler_tpu/solvers/bundle_adjust.py:94
// `_obs_jacobians` (jax.jacfwd at :102-103, vmapped over the observations;
// no pallas_call). The port's plain version, solvers/bundle_adjust.py
// `_obs_jacobians_reference`, runs vmap(jacfwd) eagerly behind the
// process-wide forward-AD lock: some 150 launches a call.
//
// What bounds it: neither bytes nor operations at the callers' sizes (264
// to ~8000 observations: 5 KB to 0.8 MB, a few MFLOP), but each thread's
// chain of dependent steps: its indices, then its point, then the
// projection with nine tangents, then the stores. The first design (one
// thread an observation carrying a nine-tangent Jet through the whole
// Rodrigues) took 13 us at either size: ~4000 cycles of its ~15000 went to
// the rotation's sqrt, sin, cos and ~70 divisions, which depend on the
// camera alone (22 cameras against 8097 observations).
//
// Design: blocks of 64 threads, an observation a thread, so a global BA
// spans the SMs. Each thread issues its loads first (the block's cameras,
// its indices, mask, weight and K, then its point). Then the block computes the rotation coefficients a, b and
// cos(theta) of its lanes' cameras with their three rvec tangents
// (pinhole_jet.cuh rotation_coefficients on Jet<T, 3>) into shared memory,
// a camera a thread, and waits at one barrier; where the block's lanes
// hold more cameras than it has threads, each thread computes its own
// camera's instead. Per observation only rotate_by's cross and dot
// products, the translation, the K product and the divide remain, on
// SparseJets (the rvec's tangents, the translation's and the point's kept
// apart, so no exactly-zero tangent is carried). The block's rows are
// staged in shared memory and written out as 16-byte vectors.
//
// The tangents are those of jacfwd with the camera and point as its two
// arguments, in torch's JVP formulas and the plain version's operation
// order for every nonzero tangent (built with -fmad=false), so on inputs
// whose values stay finite the results equal the first design's value for
// value. Then J * (mask * weight), as the plain version multiplies. An
// index outside its lane's cameras or points gives NaN rows (the plain
// version raises there).

#include "pinhole_jet.cuh"

namespace {

using pinhole::Jet;
using pinhole::SparseJet;

constexpr int kThreads = 64;
// A camera's coefficients: a, b, ct, each its value then its three rvec
// tangents, then the camera's rvec and tvec.
constexpr int kCam = 18;
constexpr int kRows = 18;  // an observation's outputs: (2, 6) then (2, 3)

template <typename T>
__device__ __forceinline__ void camera_coefficients(const T* c, T (&out)[kCam]) {
  using J = Jet<T, 3>;
  const J rv[3] = {pinhole::jet<T, 3>(c[0], 0), pinhole::jet<T, 3>(c[1], 1), pinhole::jet<T, 3>(c[2], 2)};
  J co[3];
  pinhole::rotation_coefficients(rv, co[0], co[1], co[2]);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    out[4 * j] = co[j].v;
#pragma unroll
    for (int k = 0; k < 3; ++k) out[4 * j + 1 + k] = co[j].d[k];
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) out[12 + k] = c[k];
}

// One coefficient of `cc` as a jet with the rvec's three tangents.
template <typename T>
__device__ __forceinline__ SparseJet<T, 9, 7u> coefficient(const T* cc) {
  SparseJet<T, 9, 7u> r;
  r.v = cc[0];
#pragma unroll
  for (int k = 0; k < 3; ++k) r.d[k] = cc[1 + k];
  return r;
}

// project_points' nine tangents for one observation from its camera's
// coefficients: out[6 r + k] = d uv_r / d cam_k, out[12 + 3 r + k] =
// d uv_r / d point_k, each times m.
template <typename T>
__device__ __forceinline__ void observation_rows(const T (&cc)[kCam], const T (&x)[3], const T* k, T m,
                                                 T (&out)[kRows]) {
  using pinhole::sparse_unit;
  const auto a = coefficient(cc);
  const auto b = coefficient(cc + 4);
  const auto ct = coefficient(cc + 8);
  const auto r0 = sparse_unit<T, 9, 0>(cc[12]);
  const auto r1 = sparse_unit<T, 9, 1>(cc[13]);
  const auto r2 = sparse_unit<T, 9, 2>(cc[14]);
  const auto t0 = sparse_unit<T, 9, 3>(cc[15]);
  const auto t1 = sparse_unit<T, 9, 4>(cc[16]);
  const auto t2 = sparse_unit<T, 9, 5>(cc[17]);
  const auto q0 = sparse_unit<T, 9, 6>(x[0]);
  const auto q1 = sparse_unit<T, 9, 7>(x[1]);
  const auto q2 = sparse_unit<T, 9, 8>(x[2]);
  // rotate_by, then + t (to_camera), the K product and the divide
  // (project_points), operation for operation.
  const auto cross0 = r1 * q2 - r2 * q1;
  const auto cross1 = r2 * q0 - r0 * q2;
  const auto cross2 = r0 * q1 - r1 * q0;
  const auto dot = (q0 * r0 + q1 * r1) + q2 * r2;
  const auto bd = b * dot;
  const auto c0 = ((ct * q0 + a * cross0) + bd * r0) + t0;
  const auto c1 = ((ct * q1 + a * cross1) + bd * r1) + t1;
  const auto c2 = ((ct * q2 + a * cross2) + bd * r2) + t2;
  const auto h0 = (k[0] * c0 + k[1] * c1) + k[2] * c2;
  const auto h1 = (k[3] * c0 + k[4] * c1) + k[5] * c2;
  const auto h2 = (k[6] * c0 + k[7] * c1) + k[8] * c2;
  const auto u = h0 / h2;
  const auto v = h1 / h2;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    out[j] = u.d[j] * m;
    out[6 + j] = v.d[j] * m;
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    out[12 + j] = u.d[6 + j] * m;
    out[15 + j] = v.d[6 + j] * m;
  }
}

// 16 bytes of T, and two T, from shared memory.
__device__ __forceinline__ float4 vec16(const float* s) { return make_float4(s[0], s[1], s[2], s[3]); }
__device__ __forceinline__ double2 vec16(const double* s) { return make_double2(s[0], s[1]); }
__device__ __forceinline__ float2 vec2(const float* s) { return make_float2(s[0], s[1]); }
__device__ __forceinline__ double2 vec2(const double* s) { return make_double2(s[0], s[1]); }

template <typename T>
__global__ void __launch_bounds__(kThreads) obs_jacobians_kernel(
    const T* __restrict__ cam, const T* __restrict__ pts, const T* __restrict__ intrinsics,
    const int64_t* __restrict__ fidx, const int64_t* __restrict__ pidx, const uint8_t* __restrict__ mask,
    const T* __restrict__ weight, int lanes, int n_cam, int n_pts, int n_obs, T* __restrict__ jc,
    T* __restrict__ jp) {
  __shared__ T table[kThreads * kCam];
  __shared__ __align__(16) T stage[kThreads * kRows];
  const int tid = threadIdx.x;
  const int64_t total = (int64_t)lanes * n_obs;
  const int64_t g0 = (int64_t)blockIdx.x * kThreads;
  const int64_t g = g0 + tid;
  const int here = (int)min((long long)kThreads, (long long)(total - g0));

  // Every load that depends on no other goes out first: the block's
  // cameras (when it keeps their coefficients), this observation's
  // indices, mask, weight and K; the point once its index is in. The
  // coefficients are computed while the point is on its way.
  const bool live = tid < here;
  const int64_t lane0 = g0 / n_obs;
  const int64_t block_cams = ((g0 + here - 1) / n_obs - lane0 + 1) * (int64_t)n_cam;
  const bool shared_table = block_cams <= kThreads;
  T c[6];
  if (shared_table && tid < block_cams) {
#pragma unroll
    for (int j = 0; j < 6; ++j) c[j] = cam[(lane0 * n_cam + tid) * 6 + j];
  }
  int64_t lane = 0, f = -1, p = -1;
  T m = T(0), k[9];
  if (live) {
    lane = g / n_obs;
    f = fidx[g];
    p = pidx[g];
    m = mask[g] ? T(1) : T(0);
    if (weight != nullptr) m = m * weight[g];
#pragma unroll
    for (int j = 0; j < 9; ++j) k[j] = intrinsics[lane * 9 + j];
  }
  const bool valid = live && f >= 0 && f < n_cam && p >= 0 && p < n_pts;
  T x[3] = {T(0), T(0), T(0)};
  if (valid) {
#pragma unroll
    for (int j = 0; j < 3; ++j) x[j] = pts[(lane * n_pts + p) * 3 + j];
  }

  // The coefficients of the cameras of the lanes this block's observations
  // lie in: in shared memory when the block has a thread for each.
  if (shared_table) {
    if (tid < block_cams) {
      T cc[kCam];
      camera_coefficients(c, cc);
#pragma unroll
      for (int j = 0; j < kCam; ++j) table[tid * kCam + j] = cc[j];
    }
    __syncthreads();
  }

  T* row = stage + tid * kRows;
  if (valid) {
    T cc[kCam];
    if (shared_table) {
      const T* src = table + ((lane - lane0) * n_cam + f) * kCam;
#pragma unroll
      for (int j = 0; j < kCam; ++j) cc[j] = src[j];
    } else {
      camera_coefficients(cam + (lane * n_cam + f) * 6, cc);
    }
    T out[kRows];
    observation_rows(cc, x, k, m, out);
#pragma unroll
    for (int j = 0; j < kRows; ++j) row[j] = out[j];
  } else if (live) {
#pragma unroll
    for (int j = 0; j < kRows; ++j) row[j] = T(NAN);
  }
  __syncthreads();

  // The block's rows are contiguous in jc and jp: 16-byte vectors of jc's,
  // pairs of jp's.
  using V = decltype(vec16(stage));
  using V2 = decltype(vec2(stage));
  constexpr int kPerV = 16 / sizeof(T);
  V* out_c = reinterpret_cast<V*>(jc + g0 * 12);
  V2* out_p = reinterpret_cast<V2*>(jp + g0 * 6);
  for (int i = tid; i < here * 12 / kPerV; i += kThreads) {
    const int e = i * kPerV;
    out_c[i] = vec16(stage + (e / 12) * kRows + e % 12);
  }
  for (int i = tid; i < here * 3; i += kThreads) {
    const int e = i * 2;
    out_p[i] = vec2(stage + (e / 6) * kRows + 12 + e % 6);
  }
}

template <typename T>
int launch(const void* cam, const void* pts, const void* intrinsics, const void* fidx, const void* pidx,
           const void* mask, const void* weight, int lanes, int n_cam, int n_pts, int n_obs, void* jc, void* jp,
           void* stream) {
  if (lanes < 1 || n_cam < 0 || n_pts < 0 || n_obs < 1) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)lanes * n_obs;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  obs_jacobians_kernel<T><<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(cam), static_cast<const T*>(pts), static_cast<const T*>(intrinsics),
      static_cast<const int64_t*>(fidx), static_cast<const int64_t*>(pidx), static_cast<const uint8_t*>(mask),
      static_cast<const T*>(weight), lanes, n_cam, n_pts, n_obs, static_cast<T*>(jc), static_cast<T*>(jp));
  return (int)cudaGetLastError();
}

}  // namespace

// Jacobians of `lanes` problems of n_obs observations each: cam (lanes x
// n_cam x 6), pts (lanes x n_pts x 3), intrinsics (lanes x 3 x 3,
// row-major), fidx / pidx (lanes x n_obs int64, numbered within the lane),
// mask (lanes x n_obs bytes), weight (lanes x n_obs, or null). Writes jc
// (lanes x n_obs x 2 x 6) and jp (lanes x n_obs x 2 x 3), both 16-byte
// aligned. Returns the launch's cudaError_t.
extern "C" int obs_jacobians_f32(const void* cam, const void* pts, const void* intrinsics, const void* fidx,
                                 const void* pidx, const void* mask, const void* weight, int lanes, int n_cam,
                                 int n_pts, int n_obs, void* jc, void* jp, void* stream) {
  return launch<float>(cam, pts, intrinsics, fidx, pidx, mask, weight, lanes, n_cam, n_pts, n_obs, jc, jp, stream);
}

extern "C" int obs_jacobians_f64(const void* cam, const void* pts, const void* intrinsics, const void* fidx,
                                 const void* pidx, const void* mask, const void* weight, int lanes, int n_cam,
                                 int n_pts, int n_obs, void* jc, void* jp, void* stream) {
  return launch<double>(cam, pts, intrinsics, fidx, pidx, mask, weight, lanes, n_cam, n_pts, n_obs, jc, jp, stream);
}
