// Per-observation bundle-adjustment Jacobians for Hopper (sm_90a): each
// observation's 2x6 camera and 2x3 point Jacobian of the Rodrigues pinhole
// projection, masked and weighted, one thread per observation, one launch
// per LM iteration for every lane of a batch of problems.
//
// Replaces the XLA fusion of meatmodeler_tpu/solvers/bundle_adjust.py:94
// `_obs_jacobians` (jax.jacfwd at :102-103, vmapped over the observations;
// no pallas_call). The port's plain version, solvers/bundle_adjust.py
// `_obs_jacobians_reference`, runs vmap(jacfwd) eagerly behind the
// process-wide forward-AD lock: some 150 launches a call.
//
// What bounds it: bytes. Each observation reads its camera (6 values), its
// point (3), its two indices, mask and weight, and writes 18 values; its
// ~900 operations (the projection with nine tangents) are under 15 per
// byte, far below the card's float32 rate per byte of HBM. So the design is
// a flat grid, one thread per observation, coalesced writes of the (2, 6)
// and (2, 3) rows, no shared memory, and nothing read twice but the cameras
// and points the observations share (L1/L2).
//
// The nine tangents (the camera's six, then the point's three) are carried
// by pinhole_jet.cuh through rotate_points and the K product with torch's
// JVP formulas, so the columns are those of jacfwd with the camera and
// point as its two arguments. Then J * (mask * weight), as the plain
// version multiplies. An index outside its lane's cameras or points gives
// NaN rows (the plain version raises there).

#include "pinhole_jet.cuh"

namespace {

using pinhole::Jet;

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads) obs_jacobians_kernel(
    const T* __restrict__ cam, const T* __restrict__ pts, const T* __restrict__ intrinsics,
    const int64_t* __restrict__ fidx, const int64_t* __restrict__ pidx, const uint8_t* __restrict__ mask,
    const T* __restrict__ weight, int lanes, int n_cam, int n_pts, int n_obs, T* __restrict__ jc,
    T* __restrict__ jp) {
  const int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (g >= (int64_t)lanes * n_obs) return;
  const int64_t lane = g / n_obs;
  const int64_t f = fidx[g], p = pidx[g];
  T* out_c = jc + g * 12;
  T* out_p = jp + g * 6;
  if (f < 0 || f >= n_cam || p < 0 || p >= n_pts) {
    for (int k = 0; k < 12; ++k) out_c[k] = T(NAN);
    for (int k = 0; k < 6; ++k) out_p[k] = T(NAN);
    return;
  }
  const T* c = cam + (lane * n_cam + f) * 6;
  const T* x = pts + (lane * n_pts + p) * 3;
  using J = Jet<T, 9>;
  J pose[6], pt[3];
#pragma unroll
  for (int k = 0; k < 6; ++k) pose[k] = pinhole::jet<T, 9>(c[k], k);
#pragma unroll
  for (int k = 0; k < 3; ++k) pt[k] = pinhole::jet<T, 9>(x[k], 6 + k);
  J uv[2];
  pinhole::project_points(pt, pose, intrinsics + lane * 9, uv);
  T m = mask[g] ? T(1) : T(0);
  if (weight != nullptr) m = m * weight[g];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int k = 0; k < 6; ++k) out_c[6 * r + k] = uv[r].d[k] * m;
#pragma unroll
    for (int k = 0; k < 3; ++k) out_p[3 * r + k] = uv[r].d[6 + k] * m;
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
// (lanes x n_obs x 2 x 6) and jp (lanes x n_obs x 2 x 3). Returns the
// launch's cudaError_t.
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
