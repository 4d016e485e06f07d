// Robust relative-pose refinement on the essential manifold for Hopper
// (sm_90a): every candidate of one `refine_relative_pose` call, all of its
// Levenberg-damped IRLS iterations, in one launch with no host read.
//
// Replaces the XLA program of meatmodeler_tpu/geometry/ransac.py:372
// `refine_relative_pose` (a jit whose iterations are a fori_loop, vmapped
// over the candidates inside the jitted `estimate_relative_pose`). It is not
// a Pallas kernel: on the TPU, XLA fuses the whole loop into the estimator's
// program. The port's plain version, geometry/ransac.py
// `refine_relative_pose_reference`, runs each iteration as a vmap(jacfwd)
// under the forward-AD lock, two more residual evaluations, a sort-based
// nanmedian and a batched solve: some 400 small launches an iteration.
//
// What bounds it: neither bytes nor operations. A call reads a few KB to a
// few hundred KB (the points) and does some 10-500 MFLOP, well under 10 us
// at the card's memory or float32 rate. Each iteration depends on the one
// before (the accepted pose and the damping), and within an iteration the
// robust scale needs the median of every residual before any weight exists,
// and the step needs all of J^T J before the candidate exists. So one
// iteration is a chain of block-wide phases: residuals, an exact median
// (four radix passes, a fifth for the upper middle of an even count), the
// weighted normal equations, the 6x6 solve, the candidate's cost and the
// accept test. 15 iterations of that chain, each phase a pass over the
// points and a block barrier, are the time.
//
// Design: one block of 256 threads per candidate (16 + 8 of them a call on
// the paths), threads striding over the points. Thread 0 computes the pose's
// rotation, essential matrix and the six tangent matrices dE/dp (forward
// mode through so3.exp: the theta^2 < 1e-12 Taylor branch with its
// safe_theta_sq guard, as jacfwd differentiates it) and broadcasts them
// through shared memory. A point's six Jacobian entries are carried as
// tangents through ex1, etx2, the 1e-12 clamp (a tangent only where the sum
// is >= 1e-12, torch.clamp's rule) and the sqrt, with torch's JVP formulas.
// The median is an exact radix selection on the float bits of |r|
// (non-negative floats order as their bits) with a shared 256-bin histogram;
// residuals live in a global scratch row per candidate (L1/L2 resident).
// Sums are per-thread, then warp shuffles, then one fixed-order pass over the
// warps: deterministic, but in another order than torch.matmul's, so results
// agree with the plain version to rounding, not bit for bit. Thread 0 solves
// the damped system by LU with partial pivoting and updates pose and damping.
// Nothing is skipped for masked points: as in the plain version a non-finite
// residual anywhere makes the sums NaN, and then the step is refused.
//
// NaN rules kept from the plain version: the floors (1e-12 on the Sampson
// denominator and on |t|, 0.05 px^2 on the Cauchy scale) propagate NaN, as
// torch.clamp and jnp.maximum do (fmaxf would not); an empty mask gives a NaN
// median, NaN weights and no accepted step; `better` is false on NaN. The
// library is built with -fmad=false, so each product and sum rounds on its
// own as torch's elementwise ops do. The 6x6 solve, the NaN-keeping floor
// and the 3x3 helpers come from pinhole_jet.cuh, which the board geometry's
// kernels share.

#include "pinhole_jet.cuh"

namespace {

using pinhole::clamp_min;
using pinhole::hat;
using pinhole::matmul3;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSums = 28;  // J^T J's 21 unique entries, J^T r's 6, the cost
constexpr float kSmallAngleSq = 1e-12f;  // so3._SMALL_ANGLE ** 2
constexpr float kTiny = 1e-12f;  // the Sampson denominator's and |t|'s floor
constexpr float kMadScale = (float)(3.0 * 1.4826);
constexpr float kC2Floor = (float)(0.05 * 0.05);  // the Cauchy scale's floor, px^2
constexpr uint32_t kNoKey = 0xFFFFFFFFu;  // above every |r|'s bits (<= 0x7F800000)

// exp(rv) (Rodrigues, so3.exp's branches) and, if `d_rot` is given, its
// tangent along each of the three axes.
__device__ void so3_exp(const float* rv, float (&rot)[9], float (*d_rot)[9]) {
  const float th2 = (rv[0] * rv[0] + rv[1] * rv[1]) + rv[2] * rv[2];
  const bool small = th2 < kSmallAngleSq;
  const float safe = small ? 1.0f : th2;
  const float st = sqrtf(safe);
  const float sn = sinf(st), cs = cosf(st);
  const float a = small ? 1.0f - th2 / 6.0f : sn / st;
  const float b = small ? 0.5f - th2 / 24.0f : (1.0f - cs) / safe;
  float k[9], kk[9];
  hat(rv[0], rv[1], rv[2], k);
  matmul3(k, k, kk);
#pragma unroll
  for (int e = 0; e < 9; ++e) rot[e] = ((e % 4 == 0 ? 1.0f : 0.0f) + a * k[e]) + b * kk[e];
  if (d_rot == nullptr) return;
  for (int ax = 0; ax < 3; ++ax) {
    const float dth2 = rv[ax] + rv[ax];
    const float dsafe = small ? 0.0f : dth2;
    const float dst = dsafe / (2.0f * st);
    // torch's JVPs: sin -> t cos, cos -> t (-sin), a / b -> (a_t - b_t (a / b)) / b.
    const float da = small ? -(dth2 / 6.0f) : (dst * cs - dst * a) / st;
    const float db = small ? -(dth2 / 24.0f) : (-(dst * -sn) - dsafe * b) / safe;
    float dk[9], t1[9], t2[9];
    hat(ax == 0 ? 1.0f : 0.0f, ax == 1 ? 1.0f : 0.0f, ax == 2 ? 1.0f : 0.0f, dk);
    matmul3(dk, k, t1);
    matmul3(k, dk, t2);
#pragma unroll
    for (int e = 0; e < 9; ++e) d_rot[ax][e] = (dk[e] * a + da * k[e]) + ((t1[e] + t2[e]) * b + db * kk[e]);
  }
}

// E = [t]_x exp(rv) of params (rv, t), and if `d_e` is given dE/dp_k.
__device__ void essential(const float* p, float (&e)[9], float (*d_e)[9]) {
  float rot[9], d_rot[3][9], h[9];
  so3_exp(p, rot, d_e == nullptr ? nullptr : d_rot);
  hat(p[3], p[4], p[5], h);
  matmul3(h, rot, e);
  if (d_e == nullptr) return;
  for (int k = 0; k < 3; ++k) matmul3(h, d_rot[k], d_e[k]);
  for (int k = 0; k < 3; ++k) {
    float dh[9];
    hat(k == 0 ? 1.0f : 0.0f, k == 1 ? 1.0f : 0.0f, k == 2 ? 1.0f : 0.0f, dh);
    matmul3(dh, rot, d_e[3 + k]);
  }
}

struct Point {
  float x1, y1, x2, y2;  // normalized rays; the third coordinate is 1
};

__device__ __forceinline__ Point ray(const float2* __restrict__ p1, const float2* __restrict__ p2, int i,
                                     const float (&kin)[4]) {
  const float2 a = p1[i], b = p2[i];
  return {(a.x - kin[2]) / kin[0], (a.y - kin[3]) / kin[1], (b.x - kin[2]) / kin[0], (b.y - kin[3]) / kin[1]};
}

// The pixel-scaled Sampson residual of E at one point, and what its
// tangents need.
struct Residual {
  float ex1[3], etx2[2], num, sum, den, r;
};

__device__ __forceinline__ Residual residual(const float* e, const Point& q, float focal) {
  Residual s;
#pragma unroll
  for (int i = 0; i < 3; ++i) s.ex1[i] = (q.x1 * e[3 * i] + q.y1 * e[3 * i + 1]) + e[3 * i + 2];
#pragma unroll
  for (int j = 0; j < 2; ++j) s.etx2[j] = (q.x2 * e[j] + q.y2 * e[3 + j]) + e[6 + j];
  s.num = (q.x2 * s.ex1[0] + q.y2 * s.ex1[1]) + s.ex1[2];
  s.sum = ((s.ex1[0] * s.ex1[0] + s.ex1[1] * s.ex1[1]) + s.etx2[0] * s.etx2[0]) + s.etx2[1] * s.etx2[1];
  s.den = sqrtf(clamp_min(s.sum, kTiny));
  s.r = (focal * s.num) / s.den;
  return s;
}

// d r / d p_k along the tangent matrix de (forward mode, torch's JVPs).
__device__ __forceinline__ float tangent(const float* de, const Point& q, const Residual& s, float focal) {
  float dex1[3], detx2[2];
#pragma unroll
  for (int i = 0; i < 3; ++i) dex1[i] = (q.x1 * de[3 * i] + q.y1 * de[3 * i + 1]) + de[3 * i + 2];
#pragma unroll
  for (int j = 0; j < 2; ++j) detx2[j] = (q.x2 * de[j] + q.y2 * de[3 + j]) + de[6 + j];
  const float dnum = (q.x2 * dex1[0] + q.y2 * dex1[1]) + dex1[2];
  const float dsum = ((dex1[0] * (2.0f * s.ex1[0]) + dex1[1] * (2.0f * s.ex1[1])) + detx2[0] * (2.0f * s.etx2[0])) +
                     detx2[1] * (2.0f * s.etx2[1]);
  const float dden = (s.sum >= kTiny ? dsum : 0.0f) / (2.0f * s.den);
  return (dnum * focal - dden * s.r) / s.den;
}

__device__ __forceinline__ uint32_t median_key(const float* scratch, const uint8_t* __restrict__ mask, int i) {
  const float r = scratch[i];
  return (mask[i] && !isnan(r)) ? __float_as_uint(fabsf(r)) : kNoKey;
}

// Sums v[k] over the block; thread k < K ends with the total of v[k] in
// out[k] after the trailing barrier. Fixed order.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float (*warp_part)[kWarps], float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float x = v[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) warp_part[k][warp] = x;
  }
  __syncthreads();
  if (threadIdx.x < K) {
    float x = warp_part[threadIdx.x][0];
    for (int w = 1; w < kWarps; ++w) x += warp_part[threadIdx.x][w];
    out[threadIdx.x] = x;
  }
  __syncthreads();
}

struct Shared {
  float params[6], cand[6], lam;
  float e[9], d_e[6][9], e_cand[9];
  float warp_part[kSums][kWarps];
  float sums[kSums];
  uint32_t hist[256];
  uint32_t count_warp[kWarps];
  uint32_t prefix, remaining, equal, n_valid, key_hi;
};

// The key of rank `rank` (0-based) among the n keys of median_key, exactly:
// four 8-bit radix passes. Returns it; *below_or_equal receives how many
// keys are <= it. Every thread must call it.
__device__ uint32_t select_rank(Shared& sh, const float* scratch, const uint8_t* __restrict__ mask, int n,
                                uint32_t rank, uint32_t* below_or_equal) {
  const int lane = threadIdx.x & 31;
  uint32_t prefix = 0, remaining = rank;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int b = threadIdx.x; b < 256; b += kThreads) sh.hist[b] = 0;
    __syncthreads();
    const uint32_t high = shift == 24 ? 0u : (0xFFFFFFFFu << (shift + 8));
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const uint32_t key = median_key(scratch, mask, i);
      if ((key & high) == prefix) atomicAdd(&sh.hist[(key >> shift) & 0xFFu], 1u);
    }
    __syncthreads();
    if (threadIdx.x < 32) {
      uint32_t c[8], local = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) local += (c[j] = sh.hist[8 * lane + j]);
      uint32_t incl = local;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const uint32_t t = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += t;
      }
      uint32_t acc = incl - local;
      if (acc <= remaining && remaining < incl) {
        for (int j = 0; j < 8; ++j) {
          if (remaining < acc + c[j]) {
            sh.prefix = prefix | ((uint32_t)(8 * lane + j) << shift);
            sh.remaining = remaining - acc;
            sh.equal = c[j];
            break;
          }
          acc += c[j];
        }
      }
    }
    __syncthreads();
    prefix = sh.prefix;
    remaining = sh.remaining;
  }
  *below_or_equal = rank - remaining + sh.equal;
  __syncthreads();  // sh.* are rewritten by the next call
  return prefix;
}

// The least key above `key` (kNoKey if none). Every thread must call it.
__device__ uint32_t next_key(Shared& sh, const float* scratch, const uint8_t* __restrict__ mask, int n, uint32_t key) {
  uint32_t best = kNoKey;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const uint32_t k = median_key(scratch, mask, i);
    if (k > key && k < best) best = k;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) best = min(best, __shfl_down_sync(0xffffffffu, best, off));
  if ((threadIdx.x & 31) == 0) sh.count_warp[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t m = sh.count_warp[0];
    for (int w = 1; w < kWarps; ++w) m = min(m, sh.count_warp[w]);
    sh.key_hi = m;
  }
  __syncthreads();
  return sh.key_hi;
}

__device__ __forceinline__ void unit_t(float* p) {
  const float norm = sqrtf((p[3] * p[3] + p[4] * p[4]) + p[5] * p[5]);
  const float d = clamp_min(norm, kTiny);
  p[3] /= d;
  p[4] /= d;
  p[5] /= d;
}

__global__ void __launch_bounds__(kThreads) refine_relpose_kernel(
    const float* __restrict__ rvec, const float* __restrict__ tvec, const float2* __restrict__ pts1,
    const float2* __restrict__ pts2, const uint8_t* __restrict__ mask, const float* __restrict__ intrinsics, int n,
    int iters, float* scratch_all, float* __restrict__ out_rvec, float* __restrict__ out_tvec) {
  __shared__ Shared sh;
  const int cand_id = blockIdx.x;
  float* scratch = scratch_all + (size_t)cand_id * n;
  // fx, fy, cx, cy
  const float kin[4] = {intrinsics[0], intrinsics[4], intrinsics[2], intrinsics[5]};
  const float focal = 0.5f * (kin[0] + kin[1]);

  if (threadIdx.x == 0) {
    for (int k = 0; k < 3; ++k) {
      sh.params[k] = rvec[3 * cand_id + k];
      sh.params[3 + k] = tvec[3 * cand_id + k];
    }
    unit_t(sh.params);
    sh.lam = 1e-4f;
  }
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    if (threadIdx.x == 0) {
      float e[9], d_e[6][9];
      essential(sh.params, e, d_e);
      for (int k = 0; k < 9; ++k) sh.e[k] = e[k];
      for (int j = 0; j < 6; ++j)
        for (int k = 0; k < 9; ++k) sh.d_e[j][k] = d_e[j][k];
    }
    __syncthreads();

    // Residuals, and how many may enter the median.
    uint32_t valid = 0;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float r = residual(sh.e, ray(pts1, pts2, i, kin), focal).r;
      scratch[i] = r;
      valid += (mask[i] && !isnan(r)) ? 1u : 0u;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) valid += __shfl_down_sync(0xffffffffu, valid, off);
    if ((threadIdx.x & 31) == 0) sh.count_warp[threadIdx.x >> 5] = valid;
    __syncthreads();
    if (threadIdx.x == 0) {
      uint32_t total = 0;
      for (int w = 0; w < kWarps; ++w) total += sh.count_warp[w];
      sh.n_valid = total;
    }
    __syncthreads();
    const uint32_t n_valid = sh.n_valid;

    // jnp.nanmedian of |r| over the mask: the mean of the two middle values,
    // NaN when nothing is valid.
    float med = NAN;
    if (n_valid > 0) {
      const uint32_t lo_rank = (n_valid - 1) / 2, hi_rank = n_valid / 2;
      uint32_t upto;
      const uint32_t lo = select_rank(sh, scratch, mask, n, lo_rank, &upto);
      const uint32_t hi = (hi_rank < upto) ? lo : next_key(sh, scratch, mask, n, lo);
      med = 0.5f * (__uint_as_float(lo) + __uint_as_float(hi));
    }
    const float c = kMadScale * med;
    const float c2 = clamp_min(c * c, kC2Floor);

    // Weighted normal equations and the current cost.
    float acc[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) acc[k] = 0.0f;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const Point q = ray(pts1, pts2, i, kin);
      const Residual s = residual(sh.e, q, focal);
      const float w = (mask[i] ? 1.0f : 0.0f) / (1.0f + (s.r * s.r) / c2);
      const float sw = sqrtf(w);
      float j[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) j[k] = tangent(sh.d_e[k], q, s, focal) * sw;
      const float rw = s.r * sw;
      int u = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a)
#pragma unroll
        for (int b = a; b < 6; ++b) acc[u++] += j[a] * j[b];
#pragma unroll
      for (int a = 0; a < 6; ++a) acc[21 + a] += j[a] * rw;
      acc[27] += (w * s.r) * s.r;
    }
    block_sum<kSums>(acc, sh.warp_part, sh.sums);

    // Marquardt-damped step, the candidate with a unit t, its essential matrix.
    if (threadIdx.x == 0) {
      float a[6][6], g[6], step[6];
      int u = 0;
      for (int r = 0; r < 6; ++r)
        for (int q = r; q < 6; ++q) a[r][q] = a[q][r] = sh.sums[u++];
      const float trace = ((((a[0][0] + a[1][1]) + a[2][2]) + a[3][3]) + a[4][4]) + a[5][5];
      const float damp = sh.lam * (trace / 6.0f + kTiny);
      for (int r = 0; r < 6; ++r) {
        a[r][r] += damp;
        g[r] = sh.sums[21 + r];
      }
      pinhole::lu_solve<float, 6>(a, g, step, 6);
      for (int k = 0; k < 6; ++k) sh.cand[k] = sh.params[k] - step[k];
      unit_t(sh.cand);
      float e[9];
      essential(sh.cand, e, nullptr);
      for (int k = 0; k < 9; ++k) sh.e_cand[k] = e[k];
    }
    __syncthreads();

    // The candidate's cost under the same weights.
    float cost[1] = {0.0f};
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const float r = scratch[i];
      const float w = (mask[i] ? 1.0f : 0.0f) / (1.0f + (r * r) / c2);
      const float rc = residual(sh.e_cand, ray(pts1, pts2, i, kin), focal).r;
      cost[0] += w * (rc * rc);
    }
    block_sum<1>(cost, sh.warp_part, sh.sums);
    if (threadIdx.x == 0) {
      // False on NaN: the pose and damping keep or grow.
      const bool better = sh.sums[0] < sh.sums[27];
      if (better) {
        for (int k = 0; k < 6; ++k) sh.params[k] = sh.cand[k];
        sh.lam = clamp_min(sh.lam * 0.3f, 1e-8f);
      } else {
        sh.lam = sh.lam * 10.0f;
      }
    }
    __syncthreads();
  }

  if (threadIdx.x < 3) {
    out_rvec[3 * cand_id + threadIdx.x] = sh.params[threadIdx.x];
    out_tvec[3 * cand_id + threadIdx.x] = sh.params[3 + threadIdx.x];
  }
}

}  // namespace

// Refines b candidate poses (rvec, tvec: b x 3) against n correspondences
// (pts1, pts2: n x 2 pixels, mask: n bytes, intrinsics: 3 x 3 row-major, all
// float32 on the device) for `iters` iterations; scratch holds b x n floats.
// Writes the refined rvec and unit tvec (b x 3 each). Returns the launch's
// cudaError_t.
extern "C" int refine_relpose(const void* rvec, const void* tvec, const void* pts1, const void* pts2,
                              const void* mask, const void* intrinsics, int b, int n, int iters, void* scratch,
                              void* out_rvec, void* out_tvec, void* stream) {
  if (b < 1 || n < 0 || iters < 0) return (int)cudaErrorInvalidValue;
  refine_relpose_kernel<<<b, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rvec), static_cast<const float*>(tvec), static_cast<const float2*>(pts1),
      static_cast<const float2*>(pts2), static_cast<const uint8_t*>(mask), static_cast<const float*>(intrinsics), n,
      iters, static_cast<float*>(scratch), static_cast<float*>(out_rvec), static_cast<float*>(out_tvec));
  return (int)cudaGetLastError();
}
