// The LO-RANSAC relative pose's hypotheses, cheirality vote and candidate
// scoring for Hopper (sm_90a): everything of one `estimate_relative_pose`
// call but the draws, the top-k sort, the refinement (relpose.cu) and the
// final ordered argmax, in four kernels and five launches, with no host read.
//
// Replaces the XLA program of the jitted meatmodeler_tpu/geometry/ransac.py:
//   essential_hypotheses_kernel   :502-515, vmap(solve_one) and the Sampson
//                                 consensus counts (_eight_point :63,
//                                 _project_to_essential :183, _sampson :83);
//   homography_hypotheses_kernel  :665 find_homography_ransac: mode 0 its
//                                 4-point DLTs (homography.py find_homography)
//                                 and transfer-error counts, mode 1 the argmax,
//                                 the two weighted-DLT polishes and
//                                 :600 _decompose_homography's 8 candidates;
//   recover_pose_kernel           :329 recover_pose (the four decompositions
//                                 of E, midpoint triangulation :287, votes);
//   score_candidates_kernel       :544 score (E of each refined candidate,
//                                 Sampson inliers, the same cheirality vote,
//                                 triangulated reprojection, good count and
//                                 truncated cost).
// None is a Pallas kernel: XLA fuses them into the estimator's program. The
// port's plain versions (geometry/ransac.py *_reference) run them as some
// 1800 eager launches a call, and each batched torch.linalg eigh/svd reads
// an info flag back to the host.
//
// What bounds them: neither bytes nor operations. The odometry's call reads
// a few KB and does a few hundred MFLOP; each hypothesis is one thread's
// chain of dependent rotations (a 9 x 9 cyclic Jacobi, then two 3 x 3 SVDs),
// so the time is that chain's latency, then the consensus counts (Sampson
// distance or transfer error of every hypothesis at every slot in the
// mask) spread over the block.
//
// Design.
//  - Hypothesis kernels: a block of 128 threads takes 32 hypotheses. Its
//    warps first compact the slots in the mask, in their original order
//    (a ballot pass over the mask, one barrier, a write pass, one barrier;
//    relpose.cu's scheme), into dynamic shared memory (or, beyond the
//    card's shared memory, a global scratch per block): the rays (or
//    pixels) of the kept slots. Slots out of the mask are never read again:
//    they add nothing to a count ((d < thr2) & mask), to the Hartley sums
//    (torch.where(mask, ..., 0)) or to a vote. The block's 32 lanes of
//    warp 0 then solve one hypothesis each in registers (small_linalg.cuh),
//    and the four warps count: a warp a hypothesis, its lanes over the kept
//    slots, one __reduce_add_sync. The essential kernel computes the
//    Hartley normalisation over the kept rays itself (the same in every
//    block: fixed-order block sums).
//  - Mode 1 of the homography kernel is one block of 256 threads: the first
//    argmax of the counts, the kept slots compacted with their indices, the
//    transfer errors of the best H, then per polish the 45 sums of the
//    weighted DLT's normal matrix (fixed-order block sums), one thread's
//    Jacobi, and the re-gated count; `better` keeps or drops it for every
//    thread alike. A slot out of the mask is left out of the polish sums,
//    where the plain version adds (row * 0)^2 = 0, unless a row entry of a
//    slot is not finite: then its 0 * inf = NaN poisons the plain version's
//    normal matrix, so the kernel scans every slot once for that and makes
//    the matrix NaN (the polish is then refused unless nothing was in).
//  - recover_pose and score_candidates: a block a candidate (128 threads,
//    256 beyond 1024 slots); every thread decomposes the candidate's E (one
//    3 x 3 SVD, the det sign, the four (R, t)) itself, then one strided pass
//    (score: two) over the slots, skipping those out of the mask at a byte
//    read; votes, good counts and the truncated cost are fixed-order block
//    sums. score_candidates writes each candidate's Sampson residuals, inf
//    out of the mask, and inliers.
// NaN rules kept from the plain versions: a non-finite normal matrix gives
// a NaN eigenvector (_eigh), a non-finite matrix a NaN SVD (_svd); the
// floors (1e-12 on the Sampson denominator and on norms, 1e-12 on |z| of the
// transfer error's division, 1e-9 on the depths) are torch.where / clamp's,
// and NaN never passes a comparison. Eigenvector signs are arbitrary in
// torch.linalg.eigh; here the largest entry is made positive, which no
// result depends on: E and -E have the same Sampson distances and the same
// four decompositions, and H is divided by its h22.
// The library is built with -fmad=false, so each product and sum rounds on
// its own, as the plain versions' elementwise operations do; the solves are
// other algorithms than LAPACK's and cuSOLVER's, so results agree to
// rounding where rounding does not decide them (tools/relpose_bench).

#include <stdint.h>

#include "small_linalg.cuh"

namespace {

using sl::clamp_min;
using sl::finite;
using sl::sym_index;
using sl::tabs;
using sl::tsqrt;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 8;
constexpr int kHypThreads = 128;  // a hypothesis block: four warps
constexpr int kHypsPerBlock = 32;  // a lane of warp 0 solves each
constexpr int kPolishThreads = 256;
constexpr double kSqrt2 = 1.4142135623730951;

template <typename T>
struct Slot {
  T x1, y1, x2, y2;  // rays (or pixels) of image 1 and image 2
};

// What a block keeps in shared memory besides its slots.
template <typename T>
struct Shared {
  T part[kMaxWarps][8];  // the warps' partial sums of block_sums
  T wide[kMaxWarps][45];  // the warps' normal-matrix sums (the polish)
  T mat[kHypsPerBlock][18];  // each hypothesis' matrix (and inverse), or the polish's H
  uint32_t count[kMaxWarps];  // compaction counts
  uint32_t icount[kMaxWarps][4];  // the warps' integer sums
  long long best_v[kMaxWarps];
  int best_i[kMaxWarps];
};

__host__ __device__ __forceinline__ size_t round16(size_t x) { return (x + 15) & ~size_t(15); }

// A block's compacted slots: the slots, their indices (the polish writes
// results back), two rows of residuals (the polish), the ballot bits.
template <typename T>
struct Arena {
  Slot<T>* slot;
  int* index;
  T* res;
  uint32_t* bits;
};

template <typename T>
__host__ __device__ __forceinline__ size_t arena_bytes(int n, bool polish) {
  size_t b = round16(sizeof(Slot<T>) * (size_t)n) + round16(4 * (size_t)((n + 31) / 32));
  if (polish) b += round16(4 * (size_t)n) + round16(2 * sizeof(T) * (size_t)n);
  return b;
}

template <typename T>
__device__ __forceinline__ Arena<T> arena_at(unsigned char* base, int n, bool polish) {
  Arena<T> a;
  a.slot = reinterpret_cast<Slot<T>*>(base);
  base += round16(sizeof(Slot<T>) * (size_t)n);
  a.bits = reinterpret_cast<uint32_t*>(base);
  base += round16(4 * (size_t)((n + 31) / 32));
  a.index = polish ? reinterpret_cast<int*>(base) : nullptr;
  if (polish) base += round16(4 * (size_t)n);
  a.res = polish ? reinterpret_cast<T*>(base) : nullptr;
  return a;
}

template <typename T>
__device__ __forceinline__ T warp_allsum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The block's sums of K per-thread values, the same bits in every thread
// (each warp's butterfly, then the warps in order).
template <typename T, int K>
__device__ __forceinline__ void block_sums(T (&v)[K], Shared<T>& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_allsum(v[k]);
  __syncthreads();
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < K; ++k) sh.part[warp][k] = v[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    v[k] = sh.part[0][k];
    for (int w = 1; w < warps; ++w) v[k] += sh.part[w][k];
  }
}

// The block's sums of K per-thread counts.
template <typename T, int K>
__device__ __forceinline__ void block_counts(uint32_t (&c)[K], Shared<T>& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) c[k] = __reduce_add_sync(kFull, c[k]);
  __syncthreads();
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < K; ++k) sh.icount[warp][k] = c[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    c[k] = 0;
    for (int w = 0; w < warps; ++w) c[k] += sh.icount[w][k];
  }
}

// Ordered compaction of the slots in the mask into a.slot (rays when `rays`,
// else pixels) and, where a.index is set, their indices. Returns how many.
template <typename T>
__device__ int compact(const uint8_t* __restrict__ mask, const T* __restrict__ pts1, const T* __restrict__ pts2,
                       int n, const T (&kin)[4], bool rays, const Arena<T>& a, Shared<T>& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int chunks = (n + 31) / 32, per = (chunks + warps - 1) / warps;
  const int c0 = warp * per, c1 = min(chunks, c0 + per);
  uint32_t mine = 0;
  for (int c = c0; c < c1; ++c) {
    const int i = 32 * c + lane;
    const uint32_t b = __ballot_sync(kFull, i < n && mask[i] != 0);
    if (lane == 0) a.bits[c] = b;
    mine += __popc(b);
  }
  if (lane == 0) sh.count[warp] = mine;
  __syncthreads();
  uint32_t pos = 0, total = 0;
  for (int w = 0; w < warps; ++w) {
    pos += w < warp ? sh.count[w] : 0u;
    total += sh.count[w];
  }
  for (int c = c0; c < c1; ++c) {
    const uint32_t b = a.bits[c];
    if ((b >> lane) & 1u) {
      const int i = 32 * c + lane;
      const int at = (int)(pos + __popc(b & ((1u << lane) - 1u)));
      Slot<T> s{pts1[2 * i], pts1[2 * i + 1], pts2[2 * i], pts2[2 * i + 1]};
      if (rays) {
        s.x1 = (s.x1 - kin[2]) / kin[0];
        s.y1 = (s.y1 - kin[3]) / kin[1];
        s.x2 = (s.x2 - kin[2]) / kin[0];
        s.y2 = (s.y2 - kin[3]) / kin[1];
      }
      a.slot[at] = s;
      if (a.index != nullptr) a.index[at] = i;
    }
    pos += __popc(b);
  }
  __syncthreads();
  return (int)total;
}

// _sampson of one correspondence (rays) under E.
template <typename T>
__device__ __forceinline__ T sampson(const T* e, const Slot<T>& s) {
  T fp1[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) fp1[r] = (e[3 * r] * s.x1 + e[3 * r + 1] * s.y1) + e[3 * r + 2];
  const T ftp2x = (e[0] * s.x2 + e[3] * s.y2) + e[6];
  const T ftp2y = (e[1] * s.x2 + e[4] * s.y2) + e[7];
  const T num0 = (s.x2 * fp1[0] + s.y2 * fp1[1]) + fp1[2];
  const T num = num0 * num0;
  const T den = ((fp1[0] * fp1[0] + fp1[1] * fp1[1]) + ftp2x * ftp2x) + ftp2y * ftp2y;
  return num / clamp_min(den, T(1e-12));
}

// _homography_transfer_sq of one correspondence (pixels) under H and its inverse.
template <typename T>
__device__ __forceinline__ T transfer_sq(const T* h, const T* hinv, const Slot<T>& s) {
  auto dehom = [](const T* m, T x, T y, T& ox, T& oy) {
    const T fx = (m[0] * x + m[1] * y) + m[2];
    const T fy = (m[3] * x + m[4] * y) + m[5];
    const T fz = (m[6] * x + m[7] * y) + m[8];
    const T z = tabs(fz) > T(1e-12) ? fz : T(1e-12);
    ox = fx / z;
    oy = fy / z;
  };
  T fx, fy, bx, by;
  dehom(h, s.x1, s.y1, fx, fy);
  dehom(hinv, s.x2, s.y2, bx, by);
  const T a = fx - s.x2, b = fy - s.y2, c = bx - s.x1, d = by - s.y1;
  return (a * a + b * b) + (c * c + d * d);
}

// The rank-2 8-point solve of one hypothesis in Hartley-normalised rays,
// mapped back by t2^T F t1 and projected onto the essential manifold with
// unit norm (solve_one of the reference).
template <typename T>
__device__ void essential_of_sample(const T (&p1)[8][2], const T (&p2)[8][2], const T (&t1)[9], const T (&t2)[9],
                                    T (&e)[9]) {
  T a[8 * 9];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const T x1 = p1[r][0], y1 = p1[r][1], x2 = p2[r][0], y2 = p2[r][1];
    const T row[9] = {x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, T(1)};
#pragma unroll
    for (int c = 0; c < 9; ++c) a[9 * r + c] = row[c];
  }
  T f[9];
  sl::null_vector<T, 8, 9>(a, f);
  T u[9], s[3], v[9];
  sl::svd3(f, u, s, v);
  T f2[9];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) f2[3 * r + c] = (u[3 * r] * s[0]) * v[3 * c] + (u[3 * r + 1] * s[1]) * v[3 * c + 1];
  T tmp[9], fpx[9];
  sl::mul3_tn(t2, f2, tmp);
  sl::mul3(tmp, t1, fpx);
  sl::svd3(fpx, u, s, v);
  const T sm = T(0.5) * (s[0] + s[1]);
  T norm2 = T(0);
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      e[3 * r + c] = (u[3 * r] * sm) * v[3 * c] + (u[3 * r + 1] * sm) * v[3 * c + 1];
      norm2 += e[3 * r + c] * e[3 * r + c];
    }
  const T d = clamp_min(tsqrt(norm2), T(1e-12));
#pragma unroll
  for (int k = 0; k < 9; ++k) e[k] /= d;
}

// homography.normalize_points of four points: (T, normalised points).
template <typename T>
__device__ __forceinline__ void normalize4(const T (&p)[4][2], T (&out)[4][2], T& scale, T& cx, T& cy) {
  cx = (((p[0][0] + p[1][0]) + p[2][0]) + p[3][0]) / T(4);
  cy = (((p[0][1] + p[1][1]) + p[2][1]) + p[3][1]) / T(4);
  T dist = T(0);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    out[k][0] = p[k][0] - cx;
    out[k][1] = p[k][1] - cy;
    dist += tsqrt(out[k][0] * out[k][0] + out[k][1] * out[k][1]);
  }
  scale = T(kSqrt2) / clamp_min(dist / T(4), T(1e-12));
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    out[k][0] *= scale;
    out[k][1] *= scale;
  }
}

// The rows of one correspondence in the (weighted) DLT: rows_u, rows_v.
template <typename T>
__device__ __forceinline__ void dlt_rows(T x, T y, T u, T v, T (&ru)[9], T (&rv)[9]) {
  ru[0] = -x; ru[1] = -y; ru[2] = T(-1); ru[3] = T(0); ru[4] = T(0); ru[5] = T(0);
  ru[6] = u * x; ru[7] = u * y; ru[8] = u;
  rv[0] = T(0); rv[1] = T(0); rv[2] = T(0); rv[3] = -x; rv[4] = -y; rv[5] = T(-1);
  rv[6] = v * x; rv[7] = v * y; rv[8] = v;
}

// homography.find_homography of four correspondences (pixels), h22 = 1.
template <typename T>
__device__ void homography_of_sample(const T (&src)[4][2], const T (&dst)[4][2], T (&h)[9]) {
  T sn[4][2], dn[4][2], ss, scx, scy, ds, dcx, dcy;
  normalize4(src, sn, ss, scx, scy);
  normalize4(dst, dn, ds, dcx, dcy);
  // The design: rows_u of the four points, then their rows_v.
  T design[8 * 9];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    T ru[9], rv[9];
    dlt_rows(sn[k][0], sn[k][1], dn[k][0], dn[k][1], ru, rv);
#pragma unroll
    for (int c = 0; c < 9; ++c) {
      design[9 * k + c] = ru[c];
      design[9 * (4 + k) + c] = rv[c];
    }
  }
  T hn[9];
  sl::null_vector<T, 8, 9>(design, hn);
  // h = t_dst^-1 (h_n t_src); t_dst is upper triangular: back substitution.
  const T ts[9] = {ss, T(0), -scx * ss, T(0), ss, -scy * ss, T(0), T(0), T(1)};
  T m[9];
  sl::mul3(hn, ts, m);
  const T a = -dcx * ds, b = -dcy * ds;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    h[6 + c] = m[6 + c];
    h[c] = (m[c] - a * h[6 + c]) / ds;
    h[3 + c] = (m[3 + c] - b * h[6 + c]) / ds;
  }
  const T h22 = h[8];
#pragma unroll
  for (int k = 0; k < 9; ++k) h[k] /= h22;
}

// The four (R, t) of an essential matrix (recover_pose's decomposition).
template <typename T>
struct Decomposition {
  T r[2][9];
  T t[3];
};

template <typename T>
__device__ __forceinline__ Decomposition<T> decompose_essential(const T (&e)[9]) {
  T u[9], s[3], v[9];
  sl::svd3(e, u, s, v);
  const T sign = sl::det3(u) * sl::det3(v) < T(0) ? T(-1) : T(1);
  // u W and u W^T: W = [[0, -1, 0], [1, 0, 0], [0, 0, 1]].
  T uw[9], uwt[9];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    uw[3 * r] = u[3 * r + 1];
    uw[3 * r + 1] = -u[3 * r];
    uw[3 * r + 2] = u[3 * r + 2];
    uwt[3 * r] = -u[3 * r + 1];
    uwt[3 * r + 1] = u[3 * r];
    uwt[3 * r + 2] = u[3 * r + 2];
  }
  Decomposition<T> d;
  sl::mul3_nt(uw, v, d.r[0]);
  sl::mul3_nt(uwt, v, d.r[1]);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    d.r[0][k] *= sign;
    d.r[1][k] *= sign;
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) d.t[r] = u[3 * r + 2];
  return d;
}

// _triangulate_midpoint of one correspondence (rays) for (R, t).
template <typename T>
__device__ __forceinline__ void midpoint(const T* rot, const T* t, const Slot<T>& s, T& z1, T& z2, T (&x)[3]) {
  const T d1[3] = {s.x1, s.y1, T(1)}, d2[3] = {s.x2, s.y2, T(1)};
  T rd1[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) rd1[i] = (rot[3 * i] * d1[0] + rot[3 * i + 1] * d1[1]) + rot[3 * i + 2];
  const T a11 = (rd1[0] * rd1[0] + rd1[1] * rd1[1]) + rd1[2] * rd1[2];
  const T a12 = -((rd1[0] * d2[0] + rd1[1] * d2[1]) + rd1[2] * d2[2]);
  const T a22 = (d2[0] * d2[0] + d2[1] * d2[1]) + d2[2] * d2[2];
  const T b1 = -((rd1[0] * t[0] + rd1[1] * t[1]) + rd1[2] * t[2]);
  const T b2 = (d2[0] * t[0] + d2[1] * t[1]) + d2[2] * t[2];
  const T det = a11 * a22 - a12 * a12;
  const bool bad = tabs(det) < T(1e-12);
  const T sdet = bad ? T(1) : det;
  z1 = bad ? T(0) : (a22 * b1 - a12 * b2) / sdet;
  z2 = bad ? T(0) : (a11 * b2 - a12 * b1) / sdet;
  T w[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) w[j] = z2 * d2[j] - t[j];
#pragma unroll
  for (int k = 0; k < 3; ++k) x[k] = T(0.5) * (z1 * d1[k] + ((w[0] * rot[k] + w[1] * rot[3 + k]) + w[2] * rot[6 + k]));
}

// Which of the four (R, t) the slot is in front of both cameras for.
template <typename T>
__device__ __forceinline__ void vote(const Decomposition<T>& d, const Slot<T>& s, uint32_t (&votes)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const T sg = (k & 1) ? T(-1) : T(1);
    const T t[3] = {sg * d.t[0], sg * d.t[1], sg * d.t[2]};
    T z1, z2, x[3];
    midpoint(d.r[k >> 1], t, s, z1, z2, x);
    votes[k] += (z1 > T(0) && z2 > T(0)) ? 1u : 0u;
  }
}

// The first most-voted (R, t) as (rvec, t).
template <typename T>
__device__ __forceinline__ void pick(const Decomposition<T>& d, const uint32_t (&votes)[4], T (&rv)[3], T (&tv)[3]) {
  int best = 0;
#pragma unroll
  for (int k = 1; k < 4; ++k)
    if (votes[k] > votes[best]) best = k;
  T rot[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) rot[k] = best < 2 ? d.r[0][k] : d.r[1][k];
  sl::so3_log(rot, rv);
  const T sg = (best & 1) ? T(-1) : T(1);
#pragma unroll
  for (int r = 0; r < 3; ++r) tv[r] = sg * d.t[r];
}

__device__ __forceinline__ unsigned char* arena_base(unsigned char* smem, size_t shared_bytes, unsigned char* scratch,
                                                     size_t stride, bool staged) {
  return staged ? smem + round16(shared_bytes) : scratch + (size_t)blockIdx.x * stride;
}

// ---------------------------------------------------------------------------
// The kernels.

template <typename T>
__global__ void __launch_bounds__(kHypThreads) essential_hypotheses_kernel(
    const T* __restrict__ pts1, const T* __restrict__ pts2, const uint8_t* __restrict__ mask, const T* __restrict__ k,
    const long long* __restrict__ idx, const T* __restrict__ thr2p, int h_total, int n, unsigned char* scratch,
    size_t stride, bool staged, T* __restrict__ out_es, long long* __restrict__ out_counts) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared<T>& sh = *reinterpret_cast<Shared<T>*>(smem);
  const Arena<T> ar = arena_at<T>(arena_base(smem, sizeof(Shared<T>), scratch, stride, staged), n, false);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const T kin[4] = {k[0], k[4], k[2], k[5]};  // fx, fy, cx, cy
  const T thr2 = *thr2p;
  const int count = compact(mask, pts1, pts2, n, kin, true, ar, sh);

  // Hartley normalisation of both images' rays over the mask (_normalize).
  T c4[4] = {T(0), T(0), T(0), T(0)};
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const Slot<T> s = ar.slot[i];
    c4[0] += s.x1;
    c4[1] += s.y1;
    c4[2] += s.x2;
    c4[3] += s.y2;
  }
  block_sums(c4, sh);
  const T nn = T(count > 0 ? count : 1);
  const T cen[4] = {c4[0] / nn, c4[1] / nn, c4[2] / nn, c4[3] / nn};
  T d2[2] = {T(0), T(0)};
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const Slot<T> s = ar.slot[i];
    const T a = s.x1 - cen[0], b = s.y1 - cen[1], c = s.x2 - cen[2], d = s.y2 - cen[3];
    d2[0] += tsqrt(a * a + b * b);
    d2[1] += tsqrt(c * c + d * d);
  }
  block_sums(d2, sh);
  const T sc1 = T(kSqrt2) / clamp_min(d2[0] / nn, T(1e-12));
  const T sc2 = T(kSqrt2) / clamp_min(d2[1] / nn, T(1e-12));

  const int h0 = blockIdx.x * kHypsPerBlock;
  const int hn = min(kHypsPerBlock, h_total - h0);
  if (threadIdx.x < hn) {
    const int h = h0 + threadIdx.x;
    T p1[8][2], p2[8][2];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const long long i = idx[8 * (long long)h + r];
      p1[r][0] = ((pts1[2 * i] - kin[2]) / kin[0] - cen[0]) * sc1;
      p1[r][1] = ((pts1[2 * i + 1] - kin[3]) / kin[1] - cen[1]) * sc1;
      p2[r][0] = ((pts2[2 * i] - kin[2]) / kin[0] - cen[2]) * sc2;
      p2[r][1] = ((pts2[2 * i + 1] - kin[3]) / kin[1] - cen[3]) * sc2;
    }
    const T t1[9] = {sc1, T(0), -sc1 * cen[0], T(0), sc1, -sc1 * cen[1], T(0), T(0), T(1)};
    const T t2[9] = {sc2, T(0), -sc2 * cen[2], T(0), sc2, -sc2 * cen[3], T(0), T(0), T(1)};
    T e[9];
    essential_of_sample(p1, p2, t1, t2, e);
#pragma unroll
    for (int q = 0; q < 9; ++q) {
      sh.mat[threadIdx.x][q] = e[q];
      out_es[9 * (long long)h + q] = e[q];
    }
  }
  __syncthreads();
  // The consensus counts: a warp a hypothesis, its lanes over the kept rays.
  for (int j = warp; j < hn; j += warps) {
    const T* e = sh.mat[j];
    uint32_t c = 0;
    for (int i = lane; i < count; i += 32) c += sampson(e, ar.slot[i]) < thr2 ? 1u : 0u;
    c = __reduce_add_sync(kFull, c);
    if (lane == 0) out_counts[h0 + j] = (long long)c;
  }
}

// Mode 0 (kPolish false): a block of 32 four-point hypotheses and their
// transfer-error counts. Mode 1: one block; the first best of the counts,
// two weighted-DLT polishes, and (k not null) the 8 decompositions.
template <typename T, bool kPolish>
__global__ void __launch_bounds__(kPolishThreads) homography_hypotheses_kernel(
    const T* __restrict__ pts1, const T* __restrict__ pts2, const uint8_t* __restrict__ mask,
    const long long* __restrict__ idx, const T* __restrict__ hs, const long long* __restrict__ counts,
    const T* __restrict__ k, T thr2, int h_total, int n, unsigned char* scratch, size_t stride, bool staged,
    T* __restrict__ out_h, long long* __restrict__ out_counts, T* __restrict__ out_res, bool* __restrict__ out_inl,
    T* __restrict__ out_rv, T* __restrict__ out_tv) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared<T>& sh = *reinterpret_cast<Shared<T>*>(smem);
  const Arena<T> ar = arena_at<T>(arena_base(smem, sizeof(Shared<T>), scratch, stride, staged), n, kPolish);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const T none[4] = {T(1), T(1), T(0), T(0)};

  if (!kPolish) {
    const int count = compact(mask, pts1, pts2, n, none, false, ar, sh);
    const int h0 = blockIdx.x * kHypsPerBlock;
    const int hn = min(kHypsPerBlock, h_total - h0);
    if (threadIdx.x < hn) {
      const int h = h0 + threadIdx.x;
      T src[4][2], dst[4][2];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const long long i = idx[4 * (long long)h + r];
        src[r][0] = pts1[2 * i];
        src[r][1] = pts1[2 * i + 1];
        dst[r][0] = pts2[2 * i];
        dst[r][1] = pts2[2 * i + 1];
      }
      T hm[9], hi[9];
      homography_of_sample(src, dst, hm);
      sl::inv3(hm, hi);
#pragma unroll
      for (int q = 0; q < 9; ++q) {
        sh.mat[threadIdx.x][q] = hm[q];
        sh.mat[threadIdx.x][9 + q] = hi[q];
        out_h[9 * (long long)h + q] = hm[q];
      }
    }
    __syncthreads();
    for (int j = warp; j < hn; j += warps) {
      const T* hm = sh.mat[j];
      uint32_t c = 0;
      for (int i = lane; i < count; i += 32) c += transfer_sq(hm, hm + 9, ar.slot[i]) < thr2 ? 1u : 0u;
      c = __reduce_add_sync(kFull, c);
      if (lane == 0) out_counts[h0 + j] = (long long)c;
    }
    return;
  }

  // The first best hypothesis (torch.argmax).
  long long bv = -1;
  int bi = 0;
  for (int h = threadIdx.x; h < h_total; h += blockDim.x) {
    const long long v = counts[h];
    if (v > bv) {
      bv = v;
      bi = h;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const long long ov = __shfl_xor_sync(kFull, bv, off);
    const int oi = __shfl_xor_sync(kFull, bi, off);
    if (ov > bv || (ov == bv && oi < bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane == 0) {
    sh.best_v[warp] = bv;
    sh.best_i[warp] = bi;
  }
  // A slot out of the mask whose DLT rows hold a non-finite entry poisons
  // the plain version's normal matrix (0 * inf = NaN).
  bool poison = false;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const T x = pts1[2 * i], y = pts1[2 * i + 1], u = pts2[2 * i], v = pts2[2 * i + 1];
    poison = poison || !(finite(x) && finite(y) && finite(u) && finite(v) && finite(u * x) && finite(u * y) &&
                         finite(v * x) && finite(v * y));
  }
  poison = __syncthreads_or(poison) != 0;
  bv = sh.best_v[0];
  bi = sh.best_i[0];
  for (int w = 1; w < warps; ++w)
    if (sh.best_v[w] > bv || (sh.best_v[w] == bv && sh.best_i[w] < bi)) {
      bv = sh.best_v[w];
      bi = sh.best_i[w];
    }
  T hm[9], hi[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) hm[q] = hs[9 * (long long)bi + q];
  sl::inv3(hm, hi);
  const int count = compact(mask, pts1, pts2, n, none, false, ar, sh);
  T* res = ar.res;
  T* res_next = ar.res + n;
  uint32_t inl[1] = {0};
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    res[i] = transfer_sq(hm, hi, ar.slot[i]);
    inl[0] += res[i] < thr2 ? 1u : 0u;
  }
  block_counts(inl, sh);

  for (int pass = 0; pass < 2; ++pass) {
    T acc[45];
#pragma unroll
    for (int q = 0; q < 45; ++q) acc[q] = T(0);
    for (int i = threadIdx.x; i < count; i += blockDim.x) {
      if (!(res[i] < thr2)) continue;
      const Slot<T> s = ar.slot[i];
      T ru[9], rv[9];
      dlt_rows(s.x1, s.y1, s.x2, s.y2, ru, rv);
#pragma unroll
      for (int p = 0; p < 9; ++p)
#pragma unroll
        for (int q = p; q < 9; ++q) acc[sym_index<9>(p, q)] += ru[p] * ru[q] + rv[p] * rv[q];
    }
#pragma unroll
    for (int q = 0; q < 45; ++q) acc[q] = warp_allsum(acc[q]);
    if (lane == 0)
#pragma unroll
      for (int q = 0; q < 45; ++q) sh.wide[warp][q] = acc[q];
    __syncthreads();
    if (threadIdx.x == 0) {
      T ata[45];
#pragma unroll
      for (int q = 0; q < 45; ++q) {
        ata[q] = sh.wide[0][q];
        for (int w = 1; w < warps; ++w) ata[q] += sh.wide[w][q];
        if (poison) ata[q] = sl::nan_value<T>();
      }
      T href[9];
      sl::smallest_eigvec<T, 9>(ata, href);
      const T h22 = href[8];
      const T d = tabs(h22) > T(1e-12) ? h22 : T(1);
#pragma unroll
      for (int q = 0; q < 9; ++q) sh.mat[0][q] = href[q] / d;
    }
    __syncthreads();
    T href[9], hiref[9];
#pragma unroll
    for (int q = 0; q < 9; ++q) href[q] = sh.mat[0][q];
    sl::inv3(href, hiref);
    uint32_t inl_ref[1] = {0};
    for (int i = threadIdx.x; i < count; i += blockDim.x) {
      res_next[i] = transfer_sq(href, hiref, ar.slot[i]);
      inl_ref[0] += res_next[i] < thr2 ? 1u : 0u;
    }
    block_counts(inl_ref, sh);
    if (inl_ref[0] >= inl[0]) {  // keep if the consensus does not shrink
#pragma unroll
      for (int q = 0; q < 9; ++q) hm[q] = href[q];
      T* t = res;
      res = res_next;
      res_next = t;
      inl[0] = inl_ref[0];
    }
  }

  // Residuals (inf out of the mask) and inliers, at the slots' own places.
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    if (!mask[i]) {
      out_res[i] = T(INFINITY);
      out_inl[i] = false;
    }
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    out_res[ar.index[i]] = res[i];
    out_inl[ar.index[i]] = res[i] < thr2;
  }
  if (threadIdx.x != 0) return;
#pragma unroll
  for (int q = 0; q < 9; ++q) out_h[q] = hm[q];
  if (k == nullptr) return;

  // _decompose_homography: Faugeras' 8 candidates of K^-1 H K.
  T kk[9], kinv[9], tmp[9], hn[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) kk[q] = k[q];
  sl::inv3(kk, kinv);
  sl::mul3(kinv, hm, tmp);
  sl::mul3(tmp, kk, hn);
  T u[9], d[3], v[9];
  sl::svd3(hn, u, d, v);
  const T d1 = d[0], d2 = d[1], d3 = d[2];
  const T s = sl::det3(u) * sl::det3(v);
  const T denom = clamp_min(d1 * d1 - d3 * d3, T(1e-12));
  const T x1 = tsqrt(clamp_min(d1 * d1 - d2 * d2, T(0)) / denom);
  const T x3 = tsqrt(clamp_min(d2 * d2 - d3 * d3, T(0)) / denom);
  const T d2s = clamp_min(d2, T(1e-12));
  T su[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) su[q] = s * u[q];
  int out = 0;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const T a1 = (a == 0 ? T(1) : T(-1)) * x1, a3 = (b == 0 ? T(1) : T(-1)) * x3;
#pragma unroll
      for (int flip = 0; flip < 2; ++flip) {
        T rp[9], tp[3];
        if (flip == 0) {
          const T sin_t = (((d1 - d3) / d2s) * a1) * a3;
          const T cos_t = ((d1 * a3) * a3 + (d3 * a1) * a1) / d2s;
          const T m[9] = {cos_t, T(0), -sin_t, T(0), T(1), T(0), sin_t, T(0), cos_t};
          for (int q = 0; q < 9; ++q) rp[q] = m[q];
          tp[0] = a1 * (d1 - d3);
          tp[1] = T(0) * (d1 - d3);
          tp[2] = -a3 * (d1 - d3);
        } else {
          const T sin_p = (((d1 + d3) / d2s) * a1) * a3;
          const T cos_p = ((d3 * a1) * a1 - (d1 * a3) * a3) / d2s;
          const T m[9] = {cos_p, T(0), sin_p, T(0), T(-1), T(0), sin_p, T(0), -cos_p};
          for (int q = 0; q < 9; ++q) rp[q] = m[q];
          tp[0] = a1 * (d1 + d3);
          tp[1] = T(0) * (d1 + d3);
          tp[2] = a3 * (d1 + d3);
        }
        T m1[9], rot[9];
        sl::mul3(su, rp, m1);
        sl::mul3_nt(m1, v, rot);
        T rvv[3], t[3];
        sl::so3_log(rot, rvv);
#pragma unroll
        for (int r = 0; r < 3; ++r) t[r] = (u[3 * r] * tp[0] + u[3 * r + 1] * tp[1]) + u[3 * r + 2] * tp[2];
        const T tn = clamp_min(tsqrt((t[0] * t[0] + t[1] * t[1]) + t[2] * t[2]), T(1e-12));
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          out_rv[3 * out + r] = rvv[r];
          out_tv[3 * out + r] = t[r] / tn;
        }
        ++out;
      }
    }
}

// A block a candidate: its E's four (R, t), voted by the slots in the mask
// (row b of mask, or the one row when mask_stride is 0) that E's Sampson
// distance admits (when thr2p is set).
template <typename T>
__global__ void __launch_bounds__(256) recover_pose_kernel(
    const T* __restrict__ es, const T* __restrict__ pts1, const T* __restrict__ pts2, const uint8_t* __restrict__ mask,
    long long mask_stride, const T* __restrict__ k, const T* __restrict__ thr2p, int n, T* __restrict__ out_rv,
    T* __restrict__ out_tv, long long* __restrict__ out_votes) {
  __shared__ Shared<T> sh;
  const int b = blockIdx.x;
  const T kin[4] = {k[0], k[4], k[2], k[5]};
  T e[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) e[q] = es[9 * (long long)b + q];
  const Decomposition<T> d = decompose_essential(e);
  const bool gate = thr2p != nullptr;
  const T thr2 = gate ? *thr2p : T(0);
  const uint8_t* m = mask + mask_stride * b;
  uint32_t votes[4] = {0, 0, 0, 0};
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (!m[i]) continue;
    const Slot<T> s{(pts1[2 * i] - kin[2]) / kin[0], (pts1[2 * i + 1] - kin[3]) / kin[1],
                    (pts2[2 * i] - kin[2]) / kin[0], (pts2[2 * i + 1] - kin[3]) / kin[1]};
    if (gate && !(sampson(e, s) < thr2)) continue;
    vote(d, s, votes);
  }
  block_counts(votes, sh);
  if (threadIdx.x != 0) return;
  T rv[3], tv[3];
  pick(d, votes, rv, tv);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    out_rv[3 * b + r] = rv[r];
    out_tv[3 * b + r] = tv[r];
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) out_votes[4 * b + q] = (long long)votes[q];
}

// A block a refined candidate: its E = [t]_x exp(rv) normalised, Sampson
// residuals and inliers, the cheirality vote among E's decompositions, then
// the winner's triangulated reprojection: good count and truncated cost.
template <typename T>
__global__ void __launch_bounds__(256) score_candidates_kernel(
    const T* __restrict__ rvs, const T* __restrict__ tvs, const T* __restrict__ pts1, const T* __restrict__ pts2,
    const uint8_t* __restrict__ mask, const T* __restrict__ k, const T* __restrict__ thr2p, int n,
    long long* __restrict__ out_good, T* __restrict__ out_msac, T* __restrict__ out_rvd, T* __restrict__ out_tvd,
    T* __restrict__ out_e, T* __restrict__ out_res, bool* __restrict__ out_inl) {
  __shared__ Shared<T> sh;
  const int c = blockIdx.x;
  const T kin[4] = {k[0], k[4], k[2], k[5]};
  const T thr2 = *thr2p;
  const T rthr2 = T(4) * thr2;  // the reprojection gate: 2x the epipolar gate, squared
  const T rv[3] = {rvs[3 * c], rvs[3 * c + 1], rvs[3 * c + 2]};
  T rot[9], tx[9], e[9];
  sl::so3_exp(rv, rot);
  sl::hat3(tvs[3 * c], tvs[3 * c + 1], tvs[3 * c + 2], tx);
  sl::mul3(tx, rot, e);
  T norm2 = T(0);
#pragma unroll
  for (int q = 0; q < 9; ++q) norm2 += e[q] * e[q];
  const T en = clamp_min(tsqrt(norm2), T(1e-12));
#pragma unroll
  for (int q = 0; q < 9; ++q) e[q] /= en;
  const Decomposition<T> d = decompose_essential(e);
  T* res_row = out_res + (long long)c * n;
  bool* inl_row = out_inl + (long long)c * n;
  uint32_t votes[4] = {0, 0, 0, 0};
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (!mask[i]) {
      res_row[i] = T(INFINITY);
      inl_row[i] = false;
      continue;
    }
    const Slot<T> s{(pts1[2 * i] - kin[2]) / kin[0], (pts1[2 * i + 1] - kin[3]) / kin[1],
                    (pts2[2 * i] - kin[2]) / kin[0], (pts2[2 * i + 1] - kin[3]) / kin[1]};
    const T r = sampson(e, s);
    const bool in = r < thr2;
    res_row[i] = r;
    inl_row[i] = in;
    if (in) vote(d, s, votes);
  }
  block_counts(votes, sh);
  T rvd[3], tvd[3], rd[9];
  pick(d, votes, rvd, tvd);
  sl::so3_exp(rvd, rd);
  uint32_t good[1] = {0};
  T msac[1] = {T(0)};
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (!mask[i]) continue;
    const Slot<T> s{(pts1[2 * i] - kin[2]) / kin[0], (pts1[2 * i + 1] - kin[3]) / kin[1],
                    (pts2[2 * i] - kin[2]) / kin[0], (pts2[2 * i + 1] - kin[3]) / kin[1]};
    T z1, z2, x[3];
    midpoint(rd, tvd, s, z1, z2, x);
    T xc2[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) xc2[r] = ((rd[3 * r] * x[0] + rd[3 * r + 1] * x[1]) + rd[3 * r + 2] * x[2]) + tvd[r];
    const T safe1 = tabs(z1) > T(1e-9) ? z1 : T(1e-9);
    const T safe2 = tabs(z2) > T(1e-9) ? z2 : T(1e-9);
    const T a = x[0] / safe1 - s.x1, bb = x[1] / safe1 - s.y1;
    const T cc = xc2[0] / safe2 - s.x2, dd = xc2[1] / safe2 - s.y2;
    const T rmax = sl::nan_max(a * a + bb * bb, cc * cc + dd * dd);
    good[0] += (z1 > T(1e-6) && z2 > T(1e-6) && rmax < rthr2) ? 1u : 0u;
    msac[0] += sl::nan_min(rmax, rthr2);
  }
  block_counts(good, sh);
  block_sums(msac, sh);
  if (threadIdx.x != 0) return;
  out_good[c] = (long long)good[0];
  out_msac[c] = msac[0];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    out_rvd[3 * c + r] = rvd[r];
    out_tvd[3 * c + r] = tvd[r];
  }
#pragma unroll
  for (int q = 0; q < 9; ++q) out_e[9 * c + q] = e[q];
}

// Where a hypothesis launch keeps its compacted slots: dynamic shared
// memory when they fit beside Shared, else a global scratch per block.
struct Plan {
  bool staged;
  size_t shared, stride;
};

template <typename T>
Plan plan_for(int n, bool polish) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t arena = arena_bytes<T>(n, polish);
  const size_t staged = round16(sizeof(Shared<T>)) + arena;
  if (staged <= (size_t)optin) return {true, staged, arena};
  return {false, sizeof(Shared<T>), arena};
}

int hyp_blocks(int h) { return (h + kHypsPerBlock - 1) / kHypsPerBlock; }

template <typename T>
int launch_essential(const void* pts1, const void* pts2, const void* mask, const void* k, const void* idx,
                     const void* thr2, int h, int n, void* scratch, void* out_es, void* out_counts, void* stream) {
  if (h < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const Plan plan = plan_for<T>(n, false);
  if (!plan.staged && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const auto kernel = essential_hypotheses_kernel<T>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.shared);
  if (err != cudaSuccess) return (int)err;
  kernel<<<hyp_blocks(h), kHypThreads, plan.shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(pts1), static_cast<const T*>(pts2), static_cast<const uint8_t*>(mask),
      static_cast<const T*>(k), static_cast<const long long*>(idx), static_cast<const T*>(thr2), h, n,
      static_cast<unsigned char*>(scratch), plan.stride, plan.staged, static_cast<T*>(out_es),
      static_cast<long long*>(out_counts));
  return (int)cudaGetLastError();
}

template <typename T, bool kPolish>
int launch_homography(const void* pts1, const void* pts2, const void* mask, const void* idx, const void* hs,
                      const void* counts, const void* k, double thr2, int h, int n, void* scratch, void* out_h,
                      void* out_counts, void* out_res, void* out_inl, void* out_rv, void* out_tv, void* stream) {
  if (h < 1 || n < 1) return (int)cudaErrorInvalidValue;
  const Plan plan = plan_for<T>(n, kPolish);
  if (!plan.staged && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const auto kernel = homography_hypotheses_kernel<T, kPolish>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)plan.shared);
  if (err != cudaSuccess) return (int)err;
  kernel<<<kPolish ? 1 : hyp_blocks(h), kPolish ? kPolishThreads : kHypThreads, plan.shared,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(pts1), static_cast<const T*>(pts2), static_cast<const uint8_t*>(mask),
      static_cast<const long long*>(idx), static_cast<const T*>(hs), static_cast<const long long*>(counts),
      static_cast<const T*>(k), (T)thr2, h, n, static_cast<unsigned char*>(scratch), plan.stride, plan.staged,
      static_cast<T*>(out_h), static_cast<long long*>(out_counts), static_cast<T*>(out_res),
      static_cast<bool*>(out_inl), static_cast<T*>(out_rv), static_cast<T*>(out_tv));
  return (int)cudaGetLastError();
}

int candidate_threads(int n) { return n <= 1024 ? 128 : 256; }

template <typename T>
int launch_recover(const void* es, const void* pts1, const void* pts2, const void* mask, long long mask_stride,
                   const void* k, const void* thr2, int b, int n, void* out_rv, void* out_tv, void* out_votes,
                   void* stream) {
  if (b < 1 || n < 0) return (int)cudaErrorInvalidValue;
  recover_pose_kernel<T><<<b, candidate_threads(n), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(es), static_cast<const T*>(pts1), static_cast<const T*>(pts2),
      static_cast<const uint8_t*>(mask), mask_stride, static_cast<const T*>(k), static_cast<const T*>(thr2), n,
      static_cast<T*>(out_rv), static_cast<T*>(out_tv), static_cast<long long*>(out_votes));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_score(const void* rvs, const void* tvs, const void* pts1, const void* pts2, const void* mask,
                 const void* k, const void* thr2, int c, int n, void* out_good, void* out_msac, void* out_rvd,
                 void* out_tvd, void* out_e, void* out_res, void* out_inl, void* stream) {
  if (c < 1 || n < 0) return (int)cudaErrorInvalidValue;
  score_candidates_kernel<T><<<c, candidate_threads(n), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(rvs), static_cast<const T*>(tvs), static_cast<const T*>(pts1),
      static_cast<const T*>(pts2), static_cast<const uint8_t*>(mask), static_cast<const T*>(k),
      static_cast<const T*>(thr2), n, static_cast<long long*>(out_good), static_cast<T*>(out_msac),
      static_cast<T*>(out_rvd), static_cast<T*>(out_tvd), static_cast<T*>(out_e), static_cast<T*>(out_res),
      static_cast<bool*>(out_inl));
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of global scratch a hypothesis launch needs on the current device
// (0 when its compacted slots fit in shared memory): kind 0 the essential
// hypotheses, 1 the homography hypotheses, 2 the polish; h hypotheses, n
// slots; f64 selects double.
extern "C" size_t relpose_hyp_scratch_bytes(int kind, int f64, int h, int n) {
  if (h < 1 || n < 1) return 0;
  const bool polish = kind == 2;
  const Plan plan = f64 ? plan_for<double>(n, polish) : plan_for<float>(n, polish);
  if (plan.staged) return 0;
  return (size_t)(polish ? 1 : hyp_blocks(h)) * plan.stride;
}

// pts1, pts2: n x 2 pixels; mask: n bytes; k: 3 x 3 row-major; idx: h x 8
// int64 slot indices; thr2: the squared gate in ray units (a device
// scalar). Writes h essential matrices (h x 3 x 3) and int64 counts.
#define RELPOSE_HYP_ESSENTIAL(NAME, T)                                                                             \
  extern "C" int NAME(const void* pts1, const void* pts2, const void* mask, const void* k, const void* idx,        \
                      const void* thr2, int h, int n, void* scratch, void* out_es, void* out_counts, void* stream) { \
    return launch_essential<T>(pts1, pts2, mask, k, idx, thr2, h, n, scratch, out_es, out_counts, stream);         \
  }
RELPOSE_HYP_ESSENTIAL(essential_hypotheses_f32, float)
RELPOSE_HYP_ESSENTIAL(essential_hypotheses_f64, double)

// Mode 0: idx h x 4; writes h homographies and their int64 counts under
// thr2 (squared pixels).
#define RELPOSE_HYP_HOMOGRAPHY(NAME, T)                                                                            \
  extern "C" int NAME(const void* pts1, const void* pts2, const void* mask, const void* idx, double thr2, int h,  \
                      int n, void* scratch, void* out_h, void* out_counts, void* stream) {                        \
    return launch_homography<T, false>(pts1, pts2, mask, idx, nullptr, nullptr, nullptr, thr2, h, n, scratch,      \
                                       out_h, out_counts, nullptr, nullptr, nullptr, nullptr, stream);            \
  }
RELPOSE_HYP_HOMOGRAPHY(homography_hypotheses_f32, float)
RELPOSE_HYP_HOMOGRAPHY(homography_hypotheses_f64, double)

// Mode 1: hs h x 3 x 3 and their int64 counts; writes the polished H (3 x 3),
// residuals (n, inf out of the mask), inliers (n bools) and, when k is not
// null, the 8 decompositions' rvecs and unit tvecs (8 x 3 each).
#define RELPOSE_HYP_POLISH(NAME, T)                                                                                \
  extern "C" int NAME(const void* pts1, const void* pts2, const void* mask, const void* hs, const void* counts,    \
                      const void* k, double thr2, int h, int n, void* scratch, void* out_h, void* out_res,        \
                      void* out_inl, void* out_rv, void* out_tv, void* stream) {                                  \
    return launch_homography<T, true>(pts1, pts2, mask, nullptr, hs, counts, k, thr2, h, n, scratch, out_h,        \
                                      nullptr, out_res, out_inl, out_rv, out_tv, stream);                         \
  }
RELPOSE_HYP_POLISH(homography_polish_f32, float)
RELPOSE_HYP_POLISH(homography_polish_f64, double)

// es: b x 3 x 3; mask: rows of n bytes mask_stride apart (0: one row for
// all); thr2: a device scalar or null (no Sampson gate). Writes rvec, unit
// t (b x 3 each) and the four int64 votes (b x 4).
#define RELPOSE_HYP_RECOVER(NAME, T)                                                                               \
  extern "C" int NAME(const void* es, const void* pts1, const void* pts2, const void* mask, long long mask_stride, \
                      const void* k, const void* thr2, int b, int n, void* out_rv, void* out_tv, void* out_votes, \
                      void* stream) {                                                                              \
    return launch_recover<T>(es, pts1, pts2, mask, mask_stride, k, thr2, b, n, out_rv, out_tv, out_votes, stream); \
  }
RELPOSE_HYP_RECOVER(recover_pose_f32, float)
RELPOSE_HYP_RECOVER(recover_pose_f64, double)

// rvs, tvs: c x 3; writes the int64 good counts, truncated costs (c), rvd,
// tvd (c x 3), E (c x 3 x 3), residuals (c x n, inf out of the mask) and
// inliers (c x n bools).
#define RELPOSE_HYP_SCORE(NAME, T)                                                                                 \
  extern "C" int NAME(const void* rvs, const void* tvs, const void* pts1, const void* pts2, const void* mask,     \
                      const void* k, const void* thr2, int c, int n, void* out_good, void* out_msac,              \
                      void* out_rvd, void* out_tvd, void* out_e, void* out_res, void* out_inl, void* stream) {    \
    return launch_score<T>(rvs, tvs, pts1, pts2, mask, k, thr2, c, n, out_good, out_msac, out_rvd, out_tvd, out_e, \
                           out_res, out_inl, stream);                                                              \
  }
RELPOSE_HYP_SCORE(score_candidates_f32, float)
RELPOSE_HYP_SCORE(score_candidates_f64, double)
