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
// and the step needs all of J^T J before the candidate exists. So the time
// is the latency of a chain of dependent steps, 15 times over: the pose's
// matrices, an exact median, the weighted normal equations, the 6x6 solve
// and the candidate's cost. The first design (one 256-thread block per
// candidate) spent it on ~20 block barriers an iteration, on thread 0 alone
// building the pose's matrices and solving, and on passes over every slot,
// masked or not, that re-read the points from global memory.
//
// Design: one block per candidate (four warps up to 128 slots, eight
// beyond), all 24 candidates of an estimate in one launch. One warp a
// candidate, with no block barrier at all, was tried first and measured
// slower (184 against 140 us at the odometry's 24 x 128 on an H100): a
// lone warp on its scheduler runs a point's ~550 instructions at well
// under one a cycle, and each lane carried four points; spreading the
// points over the block's warps, one a thread, wins back more than its
// few barriers cost.
//  1. Compaction, once a launch. The block's warps select the slots that can
//     affect the result, in their original order (a count pass, one
//     barrier, a write pass, one barrier), normalise their rays once and
//     keep rays, mask bytes and the candidate's residuals in dynamic shared
//     memory for the whole launch (up to ~8900 slots: 25 bytes a slot);
//     beyond that the same arena lies in a global scratch per block. The
//     rule: a slot in the mask is kept; a slot out of it is dropped only
//     when it adds exactly 0 to every sum at every pose: its weight is
//     0 / (1 + r^2 / c2) = 0 while r and its six tangents are finite, and
//     then J * sqrt(w), r * sqrt(w), w r^2 and the candidate's w rc^2 are
//     all 0. That holds when all four ray coordinates lie within kRayLimit
//     (|p - c| <= kRayLimit |f|, checked without dividing) and K is finite
//     with nonzero fx, fy and |focal| <= kFocalLimit: for a unit (or zero)
//     t the entries of E and dE/dp stay below ~12, so r, its tangents and
//     every intermediate stay below ~1e35 with the 1e-12 floor on the
//     Sampson denominator. Any other slot (a NaN, an inf or a huge
//     coordinate, or any slot under an out-of-range K) is kept, so it
//     poisons the sums exactly as in the plain version, where 0 * inf and
//     0 * NaN are NaN. With an empty mask the median is NaN, so the plain
//     version's weights are NaN everywhere and every step is refused; the
//     kernel refuses them too (NaN sums where a slot is kept, 0 < 0 where
//     none is). ransac_cuda.kept_slots states the same rule in Python.
//  2. The pose's matrices: every thread holds E = [t]_x exp(rv) (the
//     candidate's, once a step is taken), and lanes 1-6 of every warp build
//     one tangent dE/dp_k each after a taken step (forward mode through
//     so3.exp: the theta^2 < 1e-12 Taylor branch with its safe_theta_sq
//     guard, as jacfwd differentiates it), into the warp's shared slice,
//     read after a __syncwarp; a refused step changes neither. A point's
//     six Jacobian entries are carried as tangents through ex1, etx2, the
//     1e-12 clamp (a tangent only where the sum is >= 1e-12, torch.clamp's
//     rule) and the sqrt, with torch's JVP formulas.
//  3. The median: an exact radix selection on the float bits of |r|
//     (non-negative floats order as their bits), 8 bits a pass, one shared
//     histogram per pass (so one barrier a pass: every warp scans it and
//     reaches the same digit); it stops as soon as the selected bin holds
//     one key, which one scan then finds (with the next key up, for the
//     upper middle of an even count).
//  4. The sums: 28 per thread, a reduce-scatter across each warp (31
//     shuffles, a fixed tree) so lane k holds the warp's sum k, one barrier,
//     then lane k of every warp adds the warps' sums k in order. Every warp
//     then solves the damped 6x6 system itself, one row a lane in lanes
//     0-5: LU with partial pivoting (the first largest |pivot|, as LAPACK's
//     i?amax and pinhole::lu_solve), its row operations done by the rows'
//     lanes at once, broadcasts by shuffles; every thread holds the same
//     step, candidate and damping, and no thread waits on another.
//  5. The candidate's residuals are kept: an accepted step makes them the
//     next iteration's, so the residuals are computed once a pass, not twice;
//     its cost is one more warp butterfly and barrier. A refused step
//     leaves the pose, the median and every sum as they were, so the next
//     iteration only solves again with the larger damping.
// So an iteration has one barrier per median pass (2-4), one after the sums
// and one after the cost, against ~20 in the first design. What bounds it
// now is the latency of that chain: clock64 phases on an H100 (odometry,
// 24 x 128, per taken step) give the median ~3400 cycles, the lane LU
// ~2600, the sums' reduction and barrier ~2300, the normal equations
// ~1900, the tangents ~1300, the candidate's E ~1000 and its cost ~1000.
// Ranking the keys by counting, one a thread, was measured slower than the
// radix passes, and every thread solving the 6x6 system alone slower than
// the lanes (dynamic row indices put it in local memory).
// The sums are per-thread, then a fixed shuffle tree and the warps in
// order: deterministic, but in another order than torch.matmul's, so
// results agree with the plain version to rounding, not bit for bit.
//
// NaN rules kept from the plain version: the floors (1e-12 on the Sampson
// denominator and on |t|, 0.05 px^2 on the Cauchy scale) propagate NaN, as
// torch.clamp and jnp.maximum do (fmaxf would not); an empty mask gives a NaN
// median and no accepted step; nanmedian is the mean of the two middle
// values; `better` is false on NaN. The library is built with -fmad=false,
// so each product and sum rounds on its own as torch's elementwise ops do.
// The NaN-keeping floor and the 3x3 helpers come from pinhole_jet.cuh, which
// the board geometry's kernels share.

#include "pinhole_jet.cuh"

namespace {

using pinhole::clamp_min;
using pinhole::hat;
using pinhole::matmul3;

constexpr int kMaxWarps = 8;  // a block's warps at most: a block refines one candidate
constexpr int kMaxThreads = 32 * kMaxWarps;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSums = 28;  // J^T J's 21 unique entries, J^T r's 6, the cost
constexpr float kSmallAngleSq = 1e-12f;  // so3._SMALL_ANGLE ** 2
constexpr float kTiny = 1e-12f;  // the Sampson denominator's and |t|'s floor
constexpr float kMadScale = (float)(3.0 * 1.4826);
constexpr float kC2Floor = (float)(0.05 * 0.05);  // the Cauchy scale's floor, px^2
constexpr uint32_t kNoKey = 0xFFFFFFFFu;  // above every |r|'s bits (<= 0x7F800000)
constexpr float kRayLimit = 64.0f;  // a masked-out slot with rays within this is dropped
constexpr float kFocalLimit = 1e6f;  // ... when |focal| is within this
constexpr int kBatch = 8;  // compaction chunks a warp loads at once

// exp(rv) (Rodrigues, so3.exp's branches), and what its tangents need.
struct So3 {
  float rot[9], k[9], kk[9];
  float a, b, sn, cs, st, safe;
  bool small;
};

__device__ __forceinline__ So3 so3_exp(const float* rv) {
  So3 s;
  const float th2 = (rv[0] * rv[0] + rv[1] * rv[1]) + rv[2] * rv[2];
  s.small = th2 < kSmallAngleSq;
  s.safe = s.small ? 1.0f : th2;
  s.st = sqrtf(s.safe);
  s.sn = sinf(s.st);
  s.cs = cosf(s.st);
  s.a = s.small ? 1.0f - th2 / 6.0f : s.sn / s.st;
  s.b = s.small ? 0.5f - th2 / 24.0f : (1.0f - s.cs) / s.safe;
  hat(rv[0], rv[1], rv[2], s.k);
  matmul3(s.k, s.k, s.kk);
#pragma unroll
  for (int e = 0; e < 9; ++e) s.rot[e] = ((e % 4 == 0 ? 1.0f : 0.0f) + s.a * s.k[e]) + s.b * s.kk[e];
  return s;
}

// d exp(rv) / d rv[ax], torch's JVPs: sin -> t cos, cos -> t (-sin),
// a / b -> (a_t - b_t (a / b)) / b.
__device__ __forceinline__ void so3_tangent(const float* rv, const So3& s, int ax, float (&d)[9]) {
  const float rv_ax = ax == 0 ? rv[0] : (ax == 1 ? rv[1] : rv[2]);  // no dynamic index: rv stays in registers
  const float dth2 = rv_ax + rv_ax;
  const float dsafe = s.small ? 0.0f : dth2;
  const float dst = dsafe / (2.0f * s.st);
  const float da = s.small ? -(dth2 / 6.0f) : (dst * s.cs - dst * s.a) / s.st;
  const float db = s.small ? -(dth2 / 24.0f) : (-(dst * -s.sn) - dsafe * s.b) / s.safe;
  float dk[9], t1[9], t2[9];
  hat(ax == 0 ? 1.0f : 0.0f, ax == 1 ? 1.0f : 0.0f, ax == 2 ? 1.0f : 0.0f, dk);
  matmul3(dk, s.k, t1);
  matmul3(s.k, dk, t2);
#pragma unroll
  for (int e = 0; e < 9; ++e) d[e] = (dk[e] * s.a + da * s.k[e]) + ((t1[e] + t2[e]) * s.b + db * s.kk[e]);
}

// Matrix `which` of params p = (rv, t) whose exp(rv) is s: 0 gives
// E = [t]_x exp(rv), 1-3 dE/drv_k, 4-6 dE/dt_k; each is the same sequence
// of operations whichever lane builds it.
__device__ __forceinline__ void pose_matrix(const float* p, const So3& s, int which, float (&out)[9]) {
  float h[9];
  if (which >= 4) {
    const int k = which - 4;
    hat(k == 0 ? 1.0f : 0.0f, k == 1 ? 1.0f : 0.0f, k == 2 ? 1.0f : 0.0f, h);
    matmul3(h, s.rot, out);
    return;
  }
  hat(p[3], p[4], p[5], h);
  if (which == 0) {
    matmul3(h, s.rot, out);
    return;
  }
  float d[9];
  so3_tangent(p, s, which - 1, d);
  matmul3(h, d, out);
}

struct Point {
  float x1, y1, x2, y2;  // normalized rays; the third coordinate is 1
};

// The pixel-scaled Sampson residual of E at one point, and what its
// tangents need.
struct Residual {
  float ex1[3], etx2[2], num, sum, den, r;
};

__device__ __forceinline__ Residual residual(const float (&e)[9], const Point& q, float focal) {
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
__device__ __forceinline__ float tangent(const float (&de)[9], const Point& q, const Residual& s, float focal) {
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

__device__ __forceinline__ void unit_t(float* p) {
  const float norm = sqrtf((p[3] * p[3] + p[4] * p[4]) + p[5] * p[5]);
  const float d = clamp_min(norm, kTiny);
  p[3] /= d;
  p[4] /= d;
  p[5] /= d;
}

// What a block keeps in shared memory besides its points: each warp's
// copy of the pose's matrices, the warps' partial sums, and one radix
// histogram per median pass.
struct alignas(16) BlockShared {
  float pose[kMaxWarps][64];  // dE/dp_k, 9 floats each
  float sums[kMaxWarps][32];  // each warp's 28 normal-equation sums
  float cost[2][kMaxWarps];  // alternate calls of block_sums use alternate rows
  uint32_t count[2][kMaxWarps];  // compaction counts, then valid residuals
  uint32_t low[kMaxWarps][2];  // the median's scan: least key under / above the prefix
  uint32_t hist[4][256];
};

// Where a launch keeps a candidate's compacted points and residuals: the
// block's dynamic shared memory after BlockShared or, beyond its size, a
// global scratch per block.
struct Arena {
  float4* ray;     // x1, y1, x2, y2 of each kept slot
  float* res;      // two rows of n floats: the current and the candidate's residuals
  uint8_t* live;   // the mask byte of each kept slot
  uint32_t* bits;  // the compaction's first pass: which slots of each 32 are kept
};

__host__ __device__ __forceinline__ size_t round16(size_t x) { return (x + 15) & ~size_t(15); }

__host__ __device__ __forceinline__ size_t arena_bytes(int n) {
  return round16((size_t)16 * n) + round16((size_t)8 * n) + round16((size_t)n) + round16((size_t)4 * ((n + 31) / 32));
}

__device__ __forceinline__ Arena arena_at(unsigned char* base, int n) {
  Arena a;
  a.ray = reinterpret_cast<float4*>(base);
  a.res = reinterpret_cast<float*>(base + round16((size_t)16 * n));
  a.live = base + round16((size_t)16 * n) + round16((size_t)8 * n);
  a.bits = reinterpret_cast<uint32_t*>(a.live + round16((size_t)n));
  return a;
}

__device__ __forceinline__ uint32_t key_at(const float* r, const uint8_t* live, int i) {
  const float v = r[i];
  return (live[i] && !isnan(v)) ? __float_as_uint(fabsf(v)) : kNoKey;
}

// Reduce-scatter over the warp: returns, in lane k, the warp's sum of v[k]
// (a fixed tree: deterministic).
__device__ __forceinline__ float reduce_scatter(float (&v)[32], int lane) {
#pragma unroll
  for (int half = 16; half >= 1; half >>= 1) {
    const bool upper = (lane & half) != 0;
#pragma unroll
    for (int j = 0; j < half; ++j) {
      const float send = upper ? v[j] : v[j + half];
      const float keep = upper ? v[j + half] : v[j];
      v[j] = keep + __shfl_xor_sync(kFull, send, half);
    }
  }
  return v[0];
}

// The warp's sum of v, the same bits in every lane (a butterfly: each step
// adds the same two values in both lanes).
__device__ __forceinline__ float warp_allsum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Index of J^T J's entry (r, c), r <= c, in the 21 upper-triangle sums.
__device__ __forceinline__ int upper_index(int r, int c) { return r * 6 - r * (r - 1) / 2 + (c - r); }

// Solves the damped system held one row a lane (lanes 0-5: a[r][0..5],
// g[r]) by LU with partial pivoting, pinhole::lu_solve's operations; every
// lane returns the solution. Lanes 6-31 carry nothing that is read.
__device__ __forceinline__ void lane_lu_solve(float (&row)[7], float (&x)[6], int lane) {
#pragma unroll
  for (int col = 0; col < 6; ++col) {
    // The pivot: the first largest |a[r][col]|, r >= col, in every lane.
    int piv = col;
    float best = fabsf(__shfl_sync(kFull, row[col], col));
#pragma unroll
    for (int r = col + 1; r < 6; ++r) {
      const float v = fabsf(__shfl_sync(kFull, row[col], r));
      if (v > best) {
        best = v;
        piv = r;
      }
    }
    // The pivot row moves to lane col and row col to lane piv: both read
    // before the swap, so the shuffles issue together.
    float prow[7];
#pragma unroll
    for (int c = col; c < 7; ++c) {
      prow[c] = __shfl_sync(kFull, row[c], piv);
      const float top = __shfl_sync(kFull, row[c], col);
      row[c] = lane == col ? prow[c] : (lane == piv ? top : row[c]);
    }
    if (lane > col && lane < 6) {
      const float f = row[col] / prow[col];
#pragma unroll
      for (int c = col + 1; c < 7; ++c) row[c] -= f * prow[c];
    }
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = row[6];
#pragma unroll
    for (int j = i + 1; j < 6; ++j) s -= row[j] * x[j];
    x[i] = __shfl_sync(kFull, s / row[i], i);
  }
}

// jnp.nanmedian of |r| over the live slots: the mean of the two middle
// values, NaN when none is valid. Every thread of the block calls it and
// gets the same bits; it uses hist[0..passes) (returned in *passes) and
// leaves them for the caller to clear.
__device__ float block_median(BlockShared& sh, const float* r, const uint8_t* live, int count, uint32_t n_valid,
                              int* passes) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nthreads = blockDim.x, warps = nthreads >> 5;
  *passes = 0;
  if (n_valid == 0) return NAN;
  const uint32_t lo_rank = (n_valid - 1) / 2, hi_rank = n_valid / 2;
  uint32_t prefix = 0, fixed = 0, remaining = lo_rank, equal = 0;
  for (int shift = 24, pass = 0; shift >= 0; shift -= 8, ++pass) {
    uint32_t* hist = sh.hist[pass];
    for (int i = threadIdx.x; i < count; i += nthreads) {
      const uint32_t key = key_at(r, live, i);
      if ((key & fixed) == prefix) atomicAdd(&hist[(key >> shift) & 0xFFu], 1u);
    }
    __syncthreads();
    // Every warp scans the histogram and reaches the same digit.
    const uint4 u0 = reinterpret_cast<const uint4*>(hist)[2 * lane];
    const uint4 u1 = reinterpret_cast<const uint4*>(hist)[2 * lane + 1];
    const uint32_t c[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
    uint32_t local = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) local += c[j];
    uint32_t incl = local;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t t = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += t;
    }
    const uint32_t excl = incl - local;
    const bool mine = excl <= remaining && remaining < incl;
    const int who = __ffs(__ballot_sync(kFull, mine)) - 1;
    uint32_t digit = 0, rem = 0, eq = 0, acc = excl;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (mine && eq == 0 && remaining < acc + c[j]) {
        digit = 8 * lane + j;
        rem = remaining - acc;
        eq = c[j];
      }
      acc += c[j];
    }
    prefix |= __shfl_sync(kFull, digit, who) << shift;
    remaining = __shfl_sync(kFull, rem, who);
    equal = __shfl_sync(kFull, eq, who);
    fixed |= 0xFFu << shift;
    *passes = pass + 1;
    if (equal == 1) break;
  }
  // The selected key is the one(s) under `prefix`; one scan finds it and
  // the least key above them.
  uint32_t lo = kNoKey, above = kNoKey;
  for (int i = threadIdx.x; i < count; i += nthreads) {
    const uint32_t key = key_at(r, live, i);
    if ((key & fixed) == prefix) lo = min(lo, key);
    else if ((key & fixed) > prefix) above = min(above, key);
  }
  lo = __reduce_min_sync(kFull, lo);
  above = __reduce_min_sync(kFull, above);
  if (lane == 0) {
    sh.low[warp][0] = lo;
    sh.low[warp][1] = above;
  }
  __syncthreads();
  for (int w = 0; w < warps; ++w) {
    lo = min(lo, sh.low[w][0]);
    above = min(above, sh.low[w][1]);
  }
  // Keys <= lo: those below its prefix, and the `equal` keys sharing it
  // (all equal to lo when the passes ran to the last digit, lo alone when
  // they stopped at a bin of one).
  const uint32_t upto = lo_rank - remaining + equal;
  const uint32_t hi = hi_rank < upto ? lo : above;
  return 0.5f * (__uint_as_float(lo) + __uint_as_float(hi));
}

// The block's sums of a per-thread float (fixed order: the warp's
// butterfly, then the warps in order) and of a per-thread count, the same
// bits in every thread. The partials go to row `flip` (toggled here): a row
// is written again only two calls later, after every thread has passed the
// barrier of the call between and so read it.
__device__ __forceinline__ void block_sums(BlockShared& sh, float& v, uint32_t& n, int& flip) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  v = warp_allsum(v);
  n = __reduce_add_sync(kFull, n);
  if (lane == 0) {
    sh.cost[flip][warp] = v;
    sh.count[flip][warp] = n;
  }
  __syncthreads();
  v = sh.cost[flip][0];
  n = sh.count[flip][0];
  for (int w = 1; w < warps; ++w) {
    v += sh.cost[flip][w];
    n += sh.count[flip][w];
  }
  flip ^= 1;
}

template <bool kStaged>
__global__ void __launch_bounds__(kMaxThreads) refine_relpose_kernel(
    const float* __restrict__ rvec, const float* __restrict__ tvec, const float2* __restrict__ pts1,
    const float2* __restrict__ pts2, const uint8_t* __restrict__ mask, const float* __restrict__ intrinsics, int n,
    int iters, unsigned char* __restrict__ scratch, float* __restrict__ out_rvec, float* __restrict__ out_tvec) {
  extern __shared__ __align__(16) unsigned char smem[];
  BlockShared& sh = *reinterpret_cast<BlockShared*>(smem);
  const Arena arena =
      arena_at(kStaged ? smem + sizeof(BlockShared) : scratch + (size_t)blockIdx.x * arena_bytes(n), n);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nthreads = blockDim.x, warps = nthreads >> 5;
  const int cand_id = blockIdx.x;
  // fx, fy, cx, cy
  const float kin[4] = {intrinsics[0], intrinsics[4], intrinsics[2], intrinsics[5]};
  const float focal = 0.5f * (kin[0] + kin[1]);

  // 1. Compaction: the kept slots, in order (see the note for the rule).
  // Each warp takes a run of 32-slot chunks; the first pass loads kBatch
  // chunks at a time and records which slots it keeps, the second loads
  // the kept slots alone and writes them where the warps' counts put them.
  const bool may_drop = isfinite(kin[0]) && isfinite(kin[1]) && isfinite(kin[2]) && isfinite(kin[3]) &&
                        kin[0] != 0.0f && kin[1] != 0.0f && fabsf(focal) <= kFocalLimit;
  const float lim_x = kRayLimit * fabsf(kin[0]), lim_y = kRayLimit * fabsf(kin[1]);
  const int chunks = (n + 31) / 32, per_warp = (chunks + warps - 1) / warps;
  const int c0 = warp * per_warp, c1 = min(chunks, c0 + per_warp);
  int flip = 0;
  uint32_t mine = 0;
  for (int c = c0; c < c1; c += kBatch) {
    uint8_t mk[kBatch];
    float2 a1[kBatch], a2[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = min(32 * (c + u) + lane, n - 1);
      mk[u] = mask[i];
      a1[u] = pts1[i];
      a2[u] = pts2[i];
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const bool inside = fabsf(a1[u].x - kin[2]) <= lim_x && fabsf(a1[u].y - kin[3]) <= lim_y &&
                          fabsf(a2[u].x - kin[2]) <= lim_x && fabsf(a2[u].y - kin[3]) <= lim_y;
      const bool keep = c + u < c1 && 32 * (c + u) + lane < n && (mk[u] || !may_drop || !inside);
      const uint32_t ballot = __ballot_sync(kFull, keep);
      if (lane == 0 && c + u < c1) arena.bits[c + u] = ballot;
      mine += __popc(ballot);
    }
  }
  if (lane == 0) sh.count[flip][warp] = mine;
  for (int k = threadIdx.x; k < 4 * 256; k += nthreads) sh.hist[k >> 8][k & 255] = 0;
  __syncthreads();
  uint32_t pos = 0, total_kept = 0;
  for (int w = 0; w < warps; ++w) {
    pos += w < warp ? sh.count[flip][w] : 0u;
    total_kept += sh.count[flip][w];
  }
  flip ^= 1;
  for (int c = c0; c < c1; c += kBatch) {
    uint32_t bits[kBatch];
    uint8_t mk[kBatch];
    float2 a1[kBatch], a2[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      bits[u] = c + u < c1 ? arena.bits[c + u] : 0u;
      if ((bits[u] >> lane) & 1u) {
        const int i = 32 * (c + u) + lane;
        mk[u] = mask[i];
        a1[u] = pts1[i];
        a2[u] = pts2[i];
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if ((bits[u] >> lane) & 1u) {
        const uint32_t at = pos + __popc(bits[u] & ((1u << lane) - 1u));
        arena.ray[at] = make_float4((a1[u].x - kin[2]) / kin[0], (a1[u].y - kin[3]) / kin[1],
                                    (a2[u].x - kin[2]) / kin[0], (a2[u].y - kin[3]) / kin[1]);
        arena.live[at] = mk[u] ? 1 : 0;
      }
      pos += __popc(bits[u]);
    }
  }
  __syncthreads();
  const int count = (int)total_kept;
  float* r_cur = arena.res;
  float* r_next = arena.res + n;
  auto point = [&](int i) -> Point {
    const float4 v = arena.ray[i];
    return {v.x, v.y, v.z, v.w};
  };

  float p[6];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p[k] = rvec[3 * cand_id + k];
    p[3 + k] = tvec[3 * cand_id + k];
  }
  unit_t(p);
  float lam = 1e-4f;

  // Residuals at the start, and how many may enter the median. E (every
  // thread's, with exp(rv)) changes only when a step is taken, to the
  // candidate's.
  So3 s_p = so3_exp(p);
  float e[9];
  pose_matrix(p, s_p, 0, e);
  uint32_t n_valid = 0;
  for (int i = threadIdx.x; i < count; i += nthreads) {
    const float r = residual(e, point(i), focal).r;
    r_cur[i] = r;
    n_valid += (arena.live[i] && !isnan(r)) ? 1u : 0u;
  }
  {
    float unused = 0.0f;
    block_sums(sh, unused, n_valid, flip);
  }

  // After a refused step the pose, and so the residuals, the median, the
  // weights and every sum, are those of the iteration before: only the
  // damping changed, so only the solve and the candidate run again.
  bool moved = true;
  float de[6][9], c2 = 0.0f, total = 0.0f;
  for (int it = 0; it < iters; ++it) {
    if (moved) {
      // 2. E's six tangents, one a lane in lanes 1-6 of each warp.
      if (lane >= 1 && lane <= 6) {
        float m[9];
        pose_matrix(p, s_p, lane, m);
#pragma unroll
        for (int k = 0; k < 9; ++k) sh.pose[warp][9 * (lane - 1) + k] = m[k];
      }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 6; ++j)
#pragma unroll
        for (int k = 0; k < 9; ++k) de[j][k] = sh.pose[warp][9 * j + k];

      // 3. The robust scale.
      int passes;
      const float med = block_median(sh, r_cur, arena.live, count, n_valid, &passes);
      const float c = kMadScale * med;
      c2 = clamp_min(c * c, kC2Floor);

      // 4. Weighted normal equations and the current cost.
      float acc[32];
#pragma unroll
      for (int k = 0; k < 32; ++k) acc[k] = 0.0f;
      for (int i = threadIdx.x; i < count; i += nthreads) {
        const Point q = point(i);
        const Residual sr = residual(e, q, focal);
        const float w = (arena.live[i] ? 1.0f : 0.0f) / (1.0f + (sr.r * sr.r) / c2);
        const float sw = sqrtf(w);
        float j[6];
#pragma unroll
        for (int k = 0; k < 6; ++k) j[k] = tangent(de[k], q, sr, focal) * sw;
        const float rw = sr.r * sw;
        int u = 0;
#pragma unroll
        for (int a = 0; a < 6; ++a)
#pragma unroll
          for (int bb = a; bb < 6; ++bb) acc[u++] += j[a] * j[bb];
#pragma unroll
        for (int a = 0; a < 6; ++a) acc[21 + a] += j[a] * rw;
        acc[27] += (w * sr.r) * sr.r;
      }
      sh.sums[warp][lane] = reduce_scatter(acc, lane);
      __syncthreads();
      // The median's histograms are read; clear them for the next median.
      for (int k = threadIdx.x; k < passes * 256; k += nthreads) sh.hist[k >> 8][k & 255] = 0;
      total = sh.sums[0][lane];
      for (int w = 1; w < warps; ++w) total += sh.sums[w][lane];
    }

    // Marquardt-damped step: the system one row a lane, then the candidate
    // with a unit t and its essential matrix, the same in every thread.
    const float trace = ((((__shfl_sync(kFull, total, 0) + __shfl_sync(kFull, total, 6)) +
                           __shfl_sync(kFull, total, 11)) +
                          __shfl_sync(kFull, total, 15)) +
                         __shfl_sync(kFull, total, 18)) +
                        __shfl_sync(kFull, total, 20);
    const float cost_now = __shfl_sync(kFull, total, 27);
    const float damp = lam * (trace / 6.0f + kTiny);
    float row[7];
    const int my_row = lane < 6 ? lane : 0;
#pragma unroll
    for (int col = 0; col < 6; ++col) {
      const int lo = min(my_row, col), hi = max(my_row, col);
      row[col] = __shfl_sync(kFull, total, upper_index(lo, hi));
    }
    row[6] = __shfl_sync(kFull, total, 21 + my_row);
#pragma unroll
    for (int col = 0; col < 6; ++col) row[col] += col == my_row ? damp : 0.0f;
    float step[6];
    lane_lu_solve(row, step, lane);
    float cand[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) cand[k] = p[k] - step[k];
    unit_t(cand);
    const So3 s_cand = so3_exp(cand);
    float e_cand[9];
    pose_matrix(cand, s_cand, 0, e_cand);

    // 5. The candidate's cost under the same weights; its residuals are
    // the next iteration's if it is taken.
    float cost = 0.0f;
    uint32_t valid = 0;
    for (int i = threadIdx.x; i < count; i += nthreads) {
      const float r = r_cur[i];
      const float w = (arena.live[i] ? 1.0f : 0.0f) / (1.0f + (r * r) / c2);
      const float rc = residual(e_cand, point(i), focal).r;
      r_next[i] = rc;
      cost += w * (rc * rc);
      valid += (arena.live[i] && !isnan(rc)) ? 1u : 0u;
    }
    block_sums(sh, cost, valid, flip);
    // False on NaN: the pose and damping keep or grow.
    moved = cost < cost_now;
    if (moved) {
#pragma unroll
      for (int k = 0; k < 6; ++k) p[k] = cand[k];
      s_p = s_cand;
#pragma unroll
      for (int k = 0; k < 9; ++k) e[k] = e_cand[k];
      lam = clamp_min(lam * 0.3f, 1e-8f);
      float* t = r_cur;
      r_cur = r_next;
      r_next = t;
      n_valid = valid;
    } else {
      lam = lam * 10.0f;
    }
  }

  if (threadIdx.x < 3) {
    out_rvec[3 * cand_id + threadIdx.x] = p[threadIdx.x];
    out_tvec[3 * cand_id + threadIdx.x] = p[3 + threadIdx.x];
  }
}

// How a launch over n slots lays out: the threads a block (a block a
// candidate: four warps up to 128 slots, eight beyond), the dynamic shared
// memory, and whether the arena fits there (else it lies in a global
// scratch of one arena per block).
struct Plan {
  int threads;
  bool staged;
  size_t shared;
};

Plan plan_for(int n) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const int threads = n <= 128 ? 128 : kMaxThreads;
  const size_t staged = sizeof(BlockShared) + arena_bytes(n);
  if (staged <= (size_t)optin) return {threads, true, staged};
  return {threads, false, sizeof(BlockShared)};
}

}  // namespace

// Bytes of global scratch `refine_relpose` needs for b candidates over n
// slots on the current device: 0 unless a candidate's compacted slots and
// residuals outgrow shared memory.
extern "C" size_t refine_relpose_scratch_bytes(int b, int n) {
  if (b < 1 || n < 0 || plan_for(n).staged) return 0;
  return (size_t)b * arena_bytes(n);
}

// Refines b candidate poses (rvec, tvec: b x 3) against n correspondences
// (pts1, pts2: n x 2 pixels, mask: n bytes, intrinsics: 3 x 3 row-major, all
// float32 on the device) for `iters` iterations; scratch holds
// refine_relpose_scratch_bytes(b, n) bytes (may be null when that is 0).
// Writes the refined rvec and unit tvec (b x 3 each). Returns the launch's
// cudaError_t.
extern "C" int refine_relpose(const void* rvec, const void* tvec, const void* pts1, const void* pts2,
                              const void* mask, const void* intrinsics, int b, int n, int iters, void* scratch,
                              void* out_rvec, void* out_tvec, void* stream) {
  if (b < 1 || n < 0 || iters < 0) return (int)cudaErrorInvalidValue;
  const Plan plan = plan_for(n);
  if (!plan.staged && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const auto kernel = plan.staged ? refine_relpose_kernel<true> : refine_relpose_kernel<false>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.shared);
  if (err != cudaSuccess) return (int)err;
  kernel<<<b, plan.threads, plan.shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rvec), static_cast<const float*>(tvec), static_cast<const float2*>(pts1),
      static_cast<const float2*>(pts2), static_cast<const uint8_t*>(mask), static_cast<const float*>(intrinsics), n,
      iters, static_cast<unsigned char*>(scratch), static_cast<float*>(out_rvec), static_cast<float*>(out_tvec));
  return (int)cudaGetLastError();
}
