// The odometry's scale step for Hopper (sm_90a): one launch a step of
// odometry.chain_poses, with no host read. It triangulates the step's
// pairs with unit translation, takes the median ratio of the previous
// step's depths to these, composes the chained pose with the scaled
// translation and leaves each slot's depth in the new camera for the next
// step.
//
// Replaces the step body of meatmodeler_tpu/odometry.py:129-163, which the
// JAX package runs as jitted XLA (triangulation.triangulate_pairs) plus
// numpy (the median, _compose); no Pallas kernel covers it. The port's
// plain version (odometry.scale_step_reference) runs it as some 40 eager
// launches, a batched torch.linalg.eigh whose info check reads the host,
// five host copies, numpy and three CPU so3 calls.
//
// What bounds it: neither bytes nor operations. A step reads ~25 bytes and
// does ~1 kFLOP a slot; its time is one slot's chain of dependent Jacobi
// rotations, the sort's barriers and the launch itself.
//
// Design: one block; a thread a slot, looping over the slots beyond the
// block's threads.
//  1. Every thread forms R = exp(rvec) and P2 = K [R | t] itself. For each
//     of its slots it builds the two-view DLT design of
//     (K [I | 0], P2) (triangulation.triangulate_pairs' rows), takes its
//     smallest right singular vector by small_linalg.cuh's one-sided Jacobi
//     on the 4 x 4 design's columns (the normal matrix would square the
//     condition number, which float32 cannot afford), dehomogenises to X,
//     and forms ok = inlier & finite(X.z) & X.z > 1e-3. The slot's depth
//     entry, which held the previous step's depth, gets (R X + t).z where
//     ok and NaN elsewhere; where ok and the previous depth is finite, the
//     ratio previous / X.z goes to the sort buffer, +inf elsewhere.
//     Inliers and qualifying slots are counted with shared atomics.
//  2. A bitonic sort of the buffer (the next power of two, +inf padded) in
//     dynamic shared memory, or in a global scratch beyond 48 KB. A ratio
//     is never NaN (both operands finite, the divisor above 1e-3), so the
//     order is total, and the padding sorts after every ratio.
//  3. The scale, the same bits in every thread: with 8 or more qualifying
//     slots np.median's rule (the middle value, or the mean of the two
//     middle ones, (a + b) / 2); else the previous scale.
//  4. Thread 0 composes pose = (log(exp(rvec) exp(prev)), exp(rvec)
//     prev_t + tvec * scale) with geometry/so3.py's branches, and writes
//     the pose, the scale, the inlier count and whether the scale was held.
//     Every thread scales its slots' depths (NaN stays NaN).
// The depth buffer is updated in place: each slot's previous depth is read,
// and its new depth written, by the same thread. The previous pose and
// scale are inputs only (the chain passes its record's previous row).
// Built with -fmad=false (it shares relpose_hyp.cu's library), so each
// product and sum rounds on its own as the plain version's numpy does; the
// SVD is another algorithm than LAPACK's eigh of the normal matrix, so the
// depths agree to rounding, and the median and the composition follow the
// plain version's order of operations.

#include <stdint.h>

#include "small_linalg.cuh"

namespace {

using sl::finite;

constexpr int kMaxThreads = 512;
constexpr size_t kSharedBytes = 48 * 1024;  // dynamic shared memory without an opt-in
constexpr int kMinRatios = 8;  // fewer qualifying slots keep the previous scale

__host__ __device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads) scale_step_kernel(
    const T* __restrict__ pts1, const T* __restrict__ pts2, const uint8_t* __restrict__ inliers,
    const T* __restrict__ rvec, const T* __restrict__ tvec, const T* __restrict__ k,
    const T* __restrict__ prev_pose, const T* __restrict__ prev_scale, int n, T* scratch, T* depth,
    T* __restrict__ pose, T* __restrict__ scale_out, int* __restrict__ counts) {
  extern __shared__ __align__(16) unsigned char scale_smem[];
  __shared__ int tally[2];  // inliers, qualifying slots
  T* buf = scratch != nullptr ? scratch : reinterpret_cast<T*>(scale_smem);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int p = pow2_at_least(n);
  const T held_scale = *prev_scale;
  if (tid == 0) tally[0] = tally[1] = 0;

  // R = exp(rvec), P2 = K [R | t]; P1 = K [I | 0].
  const T rv[3] = {rvec[0], rvec[1], rvec[2]};
  const T tv[3] = {tvec[0], tvec[1], tvec[2]};
  T rot[9];
  sl::so3_exp(rv, rot);
  T kk[9];
#pragma unroll
  for (int e = 0; e < 9; ++e) kk[e] = k[e];
  T p2[12];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const T c0 = j < 3 ? rot[j] : tv[0], c1 = j < 3 ? rot[3 + j] : tv[1], c2 = j < 3 ? rot[6 + j] : tv[2];
      p2[4 * i + j] = (kk[3 * i] * c0 + kk[3 * i + 1] * c1) + kk[3 * i + 2] * c2;
    }
  }
  __syncthreads();  // tally cleared

  int my_inliers = 0, my_ratios = 0;
  for (int i = tid; i < n; i += nthreads) {
    const T x1 = pts1[2 * i], y1 = pts1[2 * i + 1], x2 = pts2[2 * i], y2 = pts2[2 * i + 1];
    T a[16];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const T k2j = j < 3 ? kk[6 + j] : T(0), k0j = j < 3 ? kk[j] : T(0), k1j = j < 3 ? kk[3 + j] : T(0);
      a[j] = x1 * k2j - k0j;
      a[4 + j] = y1 * k2j - k1j;
      a[8 + j] = x2 * p2[8 + j] - p2[j];
      a[12 + j] = y2 * p2[8 + j] - p2[4 + j];
    }
    T v[4];
    sl::null_vector<T, 4, 4>(a, v);
    const T X0 = v[0] / v[3], X1 = v[1] / v[3], X2 = v[2] / v[3];
    const bool inlier = inliers[i] != 0;
    const bool ok = inlier && finite(X2) && X2 > T(1e-3);
    const T prev = depth[i];
    const bool both = ok && finite(prev);
    const T cam_z = ((rot[6] * X0 + rot[7] * X1) + rot[8] * X2) + tv[2];
    depth[i] = ok ? cam_z : sl::nan_value<T>();
    buf[i] = both ? prev / X2 : T(INFINITY);
    my_inliers += inlier;
    my_ratios += both;
  }
  for (int i = n + tid; i < p; i += nthreads) buf[i] = T(INFINITY);
  if (my_inliers) atomicAdd(&tally[0], my_inliers);
  if (my_ratios) atomicAdd(&tally[1], my_ratios);
  __syncthreads();

  // Bitonic sort, ascending.
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < p; i += nthreads) {
        const int j = i ^ stride;
        if (j > i) {
          const T lo = buf[i], hi = buf[j];
          if ((i & size) == 0 ? lo > hi : lo < hi) {
            buf[i] = hi;
            buf[j] = lo;
          }
        }
      }
      __syncthreads();
    }
  }

  const int m = tally[1];
  const bool held = m < kMinRatios;
  T scale = held_scale;
  if (!held) {
    const T lo = buf[(m - 1) / 2];
    scale = (m & 1) ? lo : (lo + buf[m / 2]) / T(2);
  }

  if (tid == 0) {
    const T ra[3] = {prev_pose[0], prev_pose[1], prev_pose[2]};
    const T ta[3] = {prev_pose[3], prev_pose[4], prev_pose[5]};
    T r_a[9], r_b[9];
    sl::so3_exp(ra, r_a);
    sl::mul3(rot, r_a, r_b);
    T out[3];
    sl::so3_log(r_b, out);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      pose[i] = out[i];
      pose[3 + i] = ((rot[3 * i] * ta[0] + rot[3 * i + 1] * ta[1]) + rot[3 * i + 2] * ta[2]) + tv[i] * scale;
    }
    *scale_out = scale;
    counts[0] = tally[0];
    counts[1] = held;
  }
  for (int i = tid; i < n; i += nthreads) depth[i] = depth[i] * scale;
}

template <typename T>
size_t scratch_bytes(int n) {
  const size_t bytes = sizeof(T) * (size_t)pow2_at_least(n);
  return bytes > kSharedBytes ? bytes : 0;
}

template <typename T>
int launch_scale_step(const void* pts1, const void* pts2, const void* inliers, const void* rvec, const void* tvec,
                      const void* k, const void* prev_pose, const void* prev_scale, int n, void* scratch,
                      void* depth, void* pose, void* scale, void* counts, void* stream) {
  if (n < 0 || (scratch == nullptr && scratch_bytes<T>(n) != 0)) return (int)cudaErrorInvalidValue;
  int threads = (n + 31) / 32 * 32;
  threads = threads < 32 ? 32 : (threads > kMaxThreads ? kMaxThreads : threads);
  const size_t shared = scratch != nullptr ? 0 : sizeof(T) * (size_t)pow2_at_least(n);
  scale_step_kernel<T><<<1, threads, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(pts1), static_cast<const T*>(pts2), static_cast<const uint8_t*>(inliers),
      static_cast<const T*>(rvec), static_cast<const T*>(tvec), static_cast<const T*>(k),
      static_cast<const T*>(prev_pose), static_cast<const T*>(prev_scale), n, static_cast<T*>(scratch),
      static_cast<T*>(depth), static_cast<T*>(pose), static_cast<T*>(scale), static_cast<int*>(counts));
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of global scratch a step of n slots needs for its sort (0 when the
// sort fits in shared memory); f64 selects double.
extern "C" size_t scale_step_scratch_bytes(int f64, int n) {
  return f64 ? scratch_bytes<double>(n) : scratch_bytes<float>(n);
}

// pts1, pts2: n x 2 pixels of the previous and the current frame; inliers:
// n bytes; rvec, tvec: the step's relative pose (unit t); k: 3 x 3
// row-major; prev_pose: the previous frame's world-to-camera [rvec, tvec];
// prev_scale: the previous step's scale (a device scalar); depth: n, the
// previous step's depths in, this step's out (NaN = none). Writes pose (6),
// scale (1) and counts (2 int32: inliers, 1 where the scale was held).
#define SCALE_STEP(NAME, T)                                                                                        \
  extern "C" int NAME(const void* pts1, const void* pts2, const void* inliers, const void* rvec, const void* tvec, \
                      const void* k, const void* prev_pose, const void* prev_scale, int n, void* scratch,         \
                      void* depth, void* pose, void* scale, void* counts, void* stream) {                         \
    return launch_scale_step<T>(pts1, pts2, inliers, rvec, tvec, k, prev_pose, prev_scale, n, scratch, depth, pose, \
                                scale, counts, stream);                                                           \
  }
SCALE_STEP(scale_step_f32, float)
SCALE_STEP(scale_step_f64, double)
