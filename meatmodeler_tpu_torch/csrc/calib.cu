// Zhang calibration's joint Levenberg-Marquardt fit for Hopper (sm_90a):
// one whole `run_lm` of geometry/calibration.py -- every iteration, both
// damping trials, the accept/stop rule and the damping updates -- in one
// launch, with nothing read back until it ends.
//
// Replaces the XLA program of meatmodeler_tpu/geometry/calibration.py:158
// `calibrate`'s LM (jax.jacfwd of the whole residual at :259 inside the
// lax.while_loop of :255-292; no pallas_call). The port's plain version,
// geometry/calibration.py `run_lm_reference`, pushes one forward-mode
// tangent per parameter through the whole residual (1 + 6F of them in the
// headline config), builds the dense (2NF, n_intr + 6F) Jacobian, solves the
// dense damped system twice an iteration and reads a flag back each time.
//
// What bounds it: neither bytes nor operations. A call reads F x N pixels
// and writes n_intr + 6F parameters (a few KB) and does ~1-10 MFLOP an
// iteration. The iterations are a chain, and each is a chain of dependent
// steps, so the time is iterations x the longest path through one. The
// first design ran each iteration as 9 block-wide phases of 256 threads
// (~87000 cycles an iteration at the headline calibration: 38000 for the
// rows, a point a thread with the view's Rodrigues recomputed for every
// point; 20000 for the per-view sums, serial over a global row workspace;
// 12000 for 6x6 LUs refactored for each right side).
//
// The Jacobian is block-sparse: a view's rows touch the intrinsics and that
// view's six pose parameters only. So J^T J is an arrowhead -- the
// intrinsic block A (n_intr x n_intr), one cross block B_v (n_intr x 6) and
// one 6x6 block C_v per view -- and Marquardt's damping diag(max(diag(J^T
// J), 1e-12)) keeps that shape. Each trial eliminates the view blocks into
// the intrinsics' Schur complement
//   S = A_d - sum_v B_v C_vd^-1 B_v^T,  S d_i = g_i - sum_v B_v C_vd^-1 g_v,
//   d_v = C_vd^-1 g_v - (C_vd^-1 B_v^T) d_i,
// the dense system's exact solution in another rounding; the dense
// (n_intr + 6F)^2 matrix never exists.
//
// Design: a warp per view, the views spread over a cluster of up to 8
// blocks (one an SM: on one SM alone 22 view-warps queue for its four
// schedulers) of up to 16 warps (8 in float64, for the registers; more
// views loop over the warps), three barriers an iteration:
//  A. each warp, for each of its views, with no barrier: the view's
//     rotation coefficients with six pose tangents once (every lane alike);
//     its points on the lanes, 32 at a time, each point's two rows
//     [r, dr/d intrinsics, dr/d pose] (the pose tangents through the
//     rotation, distortion and K; the intrinsic tangents from the camera
//     frame on) into the warp's shared rows; each lane then sums its
//     entries of C_v, B_v, g_v and the view's shares of A and g_i over the
//     rows in row order; both trials' damped C_vd, each factored once by LU
//     with partial pivoting against its n_intr + 1 right sides [B_v^T |
//     g_v] (a half-warp a trial, a lane a column); the view's S_v and s_v,
//     and its terms of the Schur sums pushed into every block's table.
//  -- cluster barrier --
//  B. in every block alike, a warp a trial: A, g_i, S and its right side
//     summed over all the views in view order (from the block's own table;
//     where the table does not fit, from the views' areas, other blocks'
//     through distributed shared memory), and the n_intr solve (a lane a
//     column): the intrinsics' step and candidate.
//  -- block barrier --
//  C. each warp, for each of its views: both candidates' poses (theta -
//     step) and both candidates' costs over its points (the rotation's
//     coefficients once per view and trial), summed on the warp and pushed
//     into every block's table of costs.
//  -- cluster barrier --
//  D. every thread alike: the two costs summed over the views in view
//     order, the reference's rule -- the cheaper trial, accepted if it
//     lowers the cost; lam x 0.5 or x 10; done when not improved with lam >
//     1e8 or when the relative change is under 1e-10 -- and each warp takes
//     its views' accepted poses; the intrinsics, cost, damping and flags
//     live in every thread's registers.
// The per-view sums and trial terms (456 doubles a view) live in their
// block's dynamic shared memory when they fit beside the warps' rows (up
// to ~330 views with all nine intrinsics), else in the wrapper's global
// workspace.
//
// Precision: the Jacobian rows are computed in the call's type, as the
// plain version's jacfwd computes them; the sums over rows, the
// eliminations, the solves, the steps, the costs (their residuals too) and
// the accept test run in double whatever the type, and the candidates (and
// the returned cost) are rounded back to it. In float32 the cost near the
// optimum is flat to within its own noise: the focal and the poses' depth
// trade along the scale ambiguity f / Z, and a float32 residual of a
// ~500 px projection carries ~3e-5 px of rounding, so the costs of K a
// few 1e-4 (relative) apart cannot be told apart, and a float32 LM stops
// at its first refused step anywhere in that span. Costs in double let the
// LM walk on to the optimum of the same float32 inputs that float64 finds;
// the float32 Jacobian only bends the path there. The products of two
// float32 values are exact in double, so the sums lose nothing the rows
// held. The rows, their sums, the factorisations and the Schur terms are
// the first design's operation for operation; only the costs are summed
// in another order (per view, then over the views).

#include <cooperative_groups.h>

#include "pinhole_jet.cuh"

namespace {

namespace cg = cooperative_groups;
using pinhole::Jet;

constexpr int kMaxIntr = 9;  // 2 focals, 2 centre coordinates, 5 distortion coefficients
// One view's area (doubles): its sums C_v (21), B_v (9 x 6), g_v (6), its
// share of A (45) and of g_i (9); per trial X = C_vd^-1 [B_v^T | g_v] (6 x
// 10), S_v (9 x 9), s_v (9); its pose and both candidate poses.
constexpr int kC = 0, kB = 21, kG = 75, kA = 81, kGi = 126;
constexpr int kTrial0 = 135, kTrial = 150, kX = 0, kS = 60, kSv = 141;
constexpr int kPose = 435, kCand = 441, kViewArea = 456;
// The block's own: the two trials' intrinsic steps and candidates.
constexpr int kDi = 0, kCi = 18, kMisc = 36;
constexpr int kLu = 96;         // a warp's factorisation scratch (doubles)
constexpr int kChunk = 32;      // points a warp takes at once
constexpr int kSmemBudget = 232448;  // a block's dynamic shared memory on Hopper
constexpr int kMaxBlocks = 8;        // the largest portable cluster
constexpr int kBatch = 16;           // views whose terms one lane loads at once

template <typename T>
__host__ __device__ constexpr int max_warps() {
  return sizeof(T) == 4 ? 16 : 8;
}

// The intrinsic slots a kernel carries: 1, 4 or all 9.
__host__ __device__ constexpr int intr_slots(int n_intr) { return n_intr <= 1 ? 1 : (n_intr <= 4 ? 4 : kMaxIntr); }
// A row: r, MI intrinsic tangents, 6 pose tangents.
__host__ __device__ constexpr int row_len(int mi) { return 1 + mi + 6; }
// The entries a view sums: C_v 21, g_v 6, B_v 6 MI, g_i MI, A MI (MI + 1) / 2.
__host__ __device__ constexpr int entries(int mi) { return 27 + 7 * mi + mi * (mi + 1) / 2; }
// A view's terms of the Schur sums: A's triangle, g_i, then per trial S_v
// and s_v, over MI intrinsic slots.
__host__ __device__ constexpr int schur_terms(int mi) { return mi * (mi + 1) / 2 + mi + 2 * (mi * mi + mi); }
// The most views one of `blocks` blocks owns.
__host__ __device__ constexpr int own_views(int f, int blocks) { return (f + blocks - 1) / blocks; }

struct Layout {
  int f, n, n_intr, n_focal, n_pp, num_dist;
};

using Acc = double;  // sums, eliminations, solves, steps and costs

// (a, b) with a <= b of the e-th entry of an n x n upper triangle, row-major.
__device__ __forceinline__ void tri(int e, int n, int& a, int& b) {
  a = 0;
  while (e >= n - a) {
    e -= n - a;
    ++a;
  }
  b = a + e;
}
__device__ __forceinline__ int tri_index(int a, int b, int n) { return a * n - (a * (a - 1)) / 2 + (b - a); }

// The view area's offset of a lane's j-th sum and the two row columns it
// multiplies (-1: none).
template <int MI>
__device__ void entry_of(int j, int& off, int& ca, int& cb) {
  constexpr int kPoseCol = 1 + MI;
  int a, b;
  off = -1, ca = 0, cb = 0;
  if (j < 21) {
    tri(j, 6, a, b);
    off = kC + j, ca = kPoseCol + a, cb = kPoseCol + b;
    return;
  }
  j -= 21;
  if (j < 6 * MI) {
    off = kB + j, ca = 1 + j / 6, cb = kPoseCol + j % 6;
    return;
  }
  j -= 6 * MI;
  if (j < 6) {
    off = kG + j, ca = kPoseCol + j, cb = 0;
    return;
  }
  j -= 6;
  if (j < MI * (MI + 1) / 2) {
    tri(j, MI, a, b);
    off = kA + tri_index(a, b, kMaxIntr), ca = 1 + a, cb = 1 + b;
    return;
  }
  j -= MI * (MI + 1) / 2;
  if (j < MI) off = kGi + j, ca = 1 + j, cb = 0;
}

// v[i] for a runtime i, v kept in registers.
template <typename T, int N>
__device__ __forceinline__ T pick(const T (&v)[N], int i) {
  T r = T(0);
#pragma unroll
  for (int k = 0; k < N; ++k)
    if (k == i) r = v[k];
  return r;
}

// The intrinsics (fx, fy, cx, cy, dist[5]) of the intrinsic parameters ti.
template <typename T, int MI>
__device__ __forceinline__ void intrinsics_of(const T (&ti)[MI], const Layout& L, T cx_fixed, T cy_fixed,
                                              T (&kv)[4], T (&dist)[5]) {
  kv[0] = ti[0];
  kv[1] = L.n_focal == 1 ? ti[0] : pick(ti, 1);
  kv[2] = L.n_pp == 0 ? cx_fixed : pick(ti, L.n_focal);
  kv[3] = L.n_pp == 0 ? cy_fixed : pick(ti, L.n_focal + 1);
#pragma unroll
  for (int j = 0; j < 5; ++j) dist[j] = j < L.num_dist ? pick(ti, L.n_focal + L.n_pp + j) : T(0);
}

// Twice the cost of view v under K trials' intrinsics (kt, dt) and poses,
// in double: the sums over its points of r_x^2 + r_y^2, (proj - img) *
// vmask, each trial's in point order; valid in lane 0. Every lane of the
// warp calls it.
template <int K, typename T>
__device__ void view_costs(const T (&kt)[K][4], const T (&dt)[K][5], const T (&pose)[K][6], const T* obj,
                           const T* img, const uint8_t* vmask, int v, int n, int lane, Acc (&out)[K]) {
  using C = Acc;
  C a[K], b[K], ct[K], rv[K][3], dist[K][5];
#pragma unroll
  for (int t = 0; t < K; ++t) {
#pragma unroll
    for (int j = 0; j < 3; ++j) rv[t][j] = C(pose[t][j]);
    pinhole::rotation_coefficients(rv[t], a[t], b[t], ct[t]);
#pragma unroll
    for (int j = 0; j < 5; ++j) dist[t][j] = C(dt[t][j]);
    out[t] = 0.0;
  }
  for (int i = lane; i < n; i += 32) {
    const C p[3] = {C(obj[3 * i]), C(obj[3 * i + 1]), C(obj[3 * i + 2])};
    const int64_t q = (int64_t)v * n + i;
    const C u = C(img[2 * q]), w = C(img[2 * q + 1]);
#pragma unroll
    for (int t = 0; t < K; ++t) {
      C rot[3];
      pinhole::rotate_by(a[t], b[t], ct[t], rv[t], p, rot);
      const C cam[3] = {rot[0] + C(pose[t][3]), rot[1] + C(pose[t][4]), rot[2] + C(pose[t][5])};
      const C x = cam[0] / cam[2];
      const C y = cam[1] / cam[2];
      C xd, yd;
      pinhole::distort(x, y, dist[t], xd, yd);
      C r0 = (xd * C(kt[t][0]) + C(kt[t][2])) - u;
      C r1 = (yd * C(kt[t][1]) + C(kt[t][3])) - w;
      if (vmask != nullptr) {
        const C mm = vmask[v] ? C(1) : C(0);
        r0 = r0 * mm;
        r1 = r1 * mm;
      }
      out[t] += r0 * r0 + r1 * r1;
    }
  }
#pragma unroll
  for (int t = 0; t < K; ++t) out[t] = pinhole::warp_sum(out[t]);
}

// Stage A for view v (its area va): the rows, their sums, both trials'
// factorisations and the view's Schur terms.
template <typename T, int MI, int kE = (entries(MI) + 31) / 32>
__device__ __forceinline__ void view_terms(Acc* va, T* rows, Acc* lu, const Layout& L, const T (&kv)[4],
                                           const T (&dist)[5], const T* obj, const T* img, const uint8_t* vmask,
                                           int v, T lam, const int (&off)[kE], const int (&ca)[kE],
                                           const int (&cb)[kE], int lane) {
  constexpr int kRow = row_len(MI);
  const int n = L.n, ni = L.n_intr;
  const T m = vmask == nullptr ? T(1) : (vmask[v] ? T(1) : T(0));
  using J6 = Jet<T, 6>;
  using JI = Jet<T, MI>;
  // The view's rotation coefficients with their six pose tangents.
  J6 rv[3], tv[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    rv[k] = pinhole::jet<T, 6>(T(va[kPose + k]), k);
    tv[k] = pinhole::jet<T, 6>(T(va[kPose + 3 + k]), 3 + k);
  }
  J6 a, b, ct;
  pinhole::rotation_coefficients(rv, a, b, ct);
  JI distI[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) distI[j] = pinhole::jet<T, MI>(dist[j], j < L.num_dist ? L.n_focal + L.n_pp + j : -1);
  const JI fx = pinhole::jet<T, MI>(kv[0], 0);
  const JI fy = pinhole::jet<T, MI>(kv[1], L.n_focal == 1 ? 0 : 1);
  const JI cx = pinhole::jet<T, MI>(kv[2], L.n_pp == 0 ? -1 : L.n_focal);
  const JI cy = pinhole::jet<T, MI>(kv[3], L.n_pp == 0 ? -1 : L.n_focal + 1);

  Acc acc[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) acc[e] = 0.0;
  for (int base = 0; base < n; base += kChunk) {
    const int i = base + lane;
    if (i < n) {
      const T p[3] = {obj[3 * i], obj[3 * i + 1], obj[3 * i + 2]};
      J6 rot[3];
      pinhole::rotate_by(a, b, ct, rv, p, rot);
      const J6 cam[3] = {rot[0] + tv[0], rot[1] + tv[1], rot[2] + tv[2]};
      const J6 x = cam[0] / cam[2];
      const J6 y = cam[1] / cam[2];
      J6 xd, yd;
      pinhole::distort_by(x, y, dist, xd, yd);
      const J6 uv[2] = {xd * kv[0] + kv[2], yd * kv[1] + kv[3]};
      // The intrinsics' tangents: the camera frame does not depend on them.
      const JI xi = pinhole::make_jet<T, MI>(x.v), yi = pinhole::make_jet<T, MI>(y.v);
      JI xdi, ydi;
      pinhole::distort(xi, yi, distI, xdi, ydi);
      const JI uvi[2] = {xdi * fx + cx, ydi * fy + cy};
      const int64_t q = (int64_t)v * n + i;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        T* row = rows + (2 * lane + c) * kRow;
        row[0] = (uv[c].v - img[2 * q + c]) * m;
#pragma unroll
        for (int j = 0; j < MI; ++j) row[1 + j] = uvi[c].d[j] * m;
#pragma unroll
        for (int j = 0; j < 6; ++j) row[1 + MI + j] = uv[c].d[j] * m;
      }
    }
    __syncwarp();
    const int n_rows = 2 * min(kChunk, n - base);
#pragma unroll 4
    for (int k = 0; k < n_rows; ++k) {
      const T* row = rows + k * kRow;
#pragma unroll
      for (int e = 0; e < kE; ++e)
        if (off[e] >= 0) acc[e] += Acc(row[ca[e]]) * Acc(row[cb[e]]);
    }
    __syncwarp();
  }
#pragma unroll
  for (int e = 0; e < kE; ++e)
    if (off[e] >= 0) va[off[e]] = acc[e];
  __syncwarp();

  // Both trials' damped C_vd and right sides [B_v^T | g_v] (column 9: g_v).
  for (int e = lane; e < 2 * 36; e += 32) {
    const int t = e / 36, r = (e % 36) / 6, c = e % 6;
    const Acc lam_t = Acc(t == 0 ? lam : lam * T(10));
    Acc x = va[kC + tri_index(min(r, c), max(r, c), 6)];
    if (r == c) x = x + lam_t * pinhole::clamp_min(va[kC + tri_index(r, r, 6)], 1e-12);
    lu[e] = x;
  }
  for (int e = lane; e < 2 * 60; e += 32) {
    const int t = e / 60, r = (e % 60) / 10, c = e % 10;
    if (c < ni) va[kTrial0 + t * kTrial + kX + 10 * r + c] = va[kB + 6 * c + r];
    if (c == kMaxIntr) va[kTrial0 + t * kTrial + kX + 10 * r + c] = va[kG + r];
  }
  __syncwarp();
  const int h = lane >> 4, hl = lane & 15;
  Acc* xt = va + kTrial0 + h * kTrial;
  pinhole::group_lu_solve<6, 6, 10>(lu + 36 * h, xt + kX, 6, hl < 6 ? hl : -1, hl < ni ? hl : (hl == ni ? kMaxIntr : -1));
  // S_v = B_v X_B and s_v = B_v X_g.
  for (int e = hl; e < ni * (ni + 1); e += 16) {
    const int r = e / (ni + 1), c = e % (ni + 1);
    const int col = c < ni ? c : kMaxIntr;
    Acc s = 0.0;
    for (int k = 0; k < 6; ++k) s += va[kB + 6 * r + k] * xt[kX + 10 * k + col];
    if (c < ni)
      xt[kS + kMaxIntr * r + c] = s;
    else
      xt[kSv + r] = s;
  }
  __syncwarp();
}

// The cluster: a block (an SM) for each of up to kMaxBlocks views' shares.
__host__ __device__ inline int blocks_for(int f) { return f < kMaxBlocks ? f : kMaxBlocks; }

__host__ __device__ inline int warps_for(int f, int itemsize) {
  const int most = itemsize == 4 ? max_warps<float>() : max_warps<double>();
  const int views = own_views(f, blocks_for(f));
  return views < most ? views : most;
}

// Dynamic shared memory of one block, with or without its view areas and
// the table of every view's Schur terms.
__host__ __device__ inline long long smem_bytes(int f, int n_intr, int itemsize, bool views_in_shared, bool table) {
  const long long w = warps_for(f, itemsize);
  const long long doubles = kMisc + 2LL * f + (table ? (long long)f * schur_terms(intr_slots(n_intr)) : 0) + w * kLu +
                            (views_in_shared ? (long long)own_views(f, blocks_for(f)) * kViewArea : 0);
  return doubles * 8 + w * 2 * kChunk * row_len(intr_slots(n_intr)) * (long long)itemsize;
}

// The views' areas go to shared memory where they fit; the table of their
// Schur terms beside them where it fits too.
__host__ __device__ inline bool views_in_shared(int f, int n_intr, int itemsize) {
  return smem_bytes(f, n_intr, itemsize, true, false) <= kSmemBudget;
}
__host__ __device__ inline bool schur_table_fits(int f, int n_intr, int itemsize) {
  return smem_bytes(f, n_intr, itemsize, views_in_shared(f, n_intr, itemsize), true) <= kSmemBudget;
}

template <typename T, int MI>
__global__ void __launch_bounds__(max_warps<T>() * 32) calib_lm_kernel(
    const T* __restrict__ theta0, const T* __restrict__ img, const T* __restrict__ obj,
    const uint8_t* __restrict__ vmask, Layout L, T cx_fixed, T cy_fixed, int max_iters, Acc* __restrict__ views_global,
    T* __restrict__ theta_out, T* __restrict__ cost_out, int* __restrict__ iters_out) {
  extern __shared__ __align__(16) unsigned char calib_smem[];
  constexpr int kE = (entries(MI) + 31) / 32;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), n_blocks = (int)cluster.num_blocks();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;
  const int f = L.f, n = L.n, ni = L.n_intr;
  // View v belongs to block v % n_blocks, as its local view v / n_blocks,
  // and to that block's warp (v / n_blocks) % n_warps.
  const int own = (f - rank + n_blocks - 1) / n_blocks;
  Acc* misc = reinterpret_cast<Acc*>(calib_smem);
  constexpr int kTerms = schur_terms(MI);
  constexpr int kAI = MI * (MI + 1) / 2 + MI;  // the trials' terms after A's triangle and g_i
  constexpr int kTrialTerms = MI * MI + MI;
  Acc* costs = misc + kMisc;  // every view's two partial costs, pushed by its block
  // Every view's Schur terms, pushed by its block, where they fit.
  const bool table = schur_table_fits(f, ni, sizeof(T));
  Acc* terms = costs + 2 * f;
  Acc* lu = terms + (table ? f * kTerms : 0) + warp * kLu;
  Acc* local = terms + (table ? f * kTerms : 0) + n_warps * kLu;
  T* rows = reinterpret_cast<T*>(local + (views_global != nullptr ? 0 : own_views(f, n_blocks) * kViewArea)) +
            warp * 2 * kChunk * row_len(MI);
  // A view's area: in the global workspace, or in its block's shared memory
  // (another block's through the cluster).
  auto area = [&](int v) -> Acc* {
    if (views_global != nullptr) return views_global + (int64_t)v * kViewArea;
    Acc* a = local + (v / n_blocks) * kViewArea;
    return v % n_blocks == rank ? a : cluster.map_shared_rank(a, v % n_blocks);
  };
  // Entries e1 and e2 of every view's area (the table's t1 and t2 where it
  // is kept), each summed in view order, the loads of kBatch views issued
  // together.
  auto view_sums = [&](int e1, int e2, int t1, int t2, Acc& s1, Acc& s2) {
    s1 = 0.0;
    s2 = 0.0;
    if (table) {
      e1 = t1;
      e2 = t2;
    }
    for (int v0 = 0; v0 < f; v0 += kBatch) {
      const Acc* va[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int v = v0 + j < f ? v0 + j : v0;
        va[j] = table ? terms + v * kTerms : area(v);
      }
      Acc x1[kBatch], x2[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        x1[j] = va[j][e1];
        x2[j] = va[j][e2];
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (v0 + j < f) {
          s1 += x1[j];
          s2 += x2[j];
        }
      }
    }
  };
  // Both trials' costs (the table's two columns), each summed in view order.
  auto cost_sums = [&](Acc& s1, Acc& s2) {
    s1 = 0.0;
    s2 = 0.0;
    for (int v0 = 0; v0 < f; v0 += kBatch) {
      Acc x[2 * kBatch];
#pragma unroll
      for (int j = 0; j < 2 * kBatch; ++j) x[j] = costs[2 * min(v0 + j / 2, f - 1) + j % 2];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        if (v0 + j < f) {
          s1 += x[2 * j];
          s2 += x[2 * j + 1];
        }
      }
    }
  };
  // A view's partial costs into every block's table.
  auto push_costs = [&](int v, const Acc (&c)[2]) {
    if (lane < 2 * n_blocks) {
      Acc* dst = lane / 2 == rank ? costs : cluster.map_shared_rank(costs, lane / 2);
      dst[2 * v + lane % 2] = c[lane % 2];
    }
  };

  int off[kE], ca[kE], cb[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) entry_of<MI>(lane + 32 * e, off[e], ca[e], cb[e]);

  // The intrinsics in every thread's registers; each view's pose in its area.
  T ti[MI];
#pragma unroll
  for (int j = 0; j < MI; ++j) ti[j] = j < ni ? theta0[j] : T(0);
  for (int lv = warp; lv < own; lv += n_warps) {
    const int v = rank + lv * n_blocks;
    if (lane < 6) area(v)[kPose + lane] = Acc(theta0[ni + 6 * v + lane]);
  }
  __syncwarp();
  T kv[4], dist[5];
  intrinsics_of(ti, L, cx_fixed, cy_fixed, kv, dist);
  for (int lv = warp; lv < own; lv += n_warps) {  // the starting cost
    const int v = rank + lv * n_blocks;
    Acc* va = area(v);
    T kt[1][4], dt[1][5], pose[1][6];
#pragma unroll
    for (int k = 0; k < 4; ++k) kt[0][k] = kv[k];
#pragma unroll
    for (int k = 0; k < 5; ++k) dt[0][k] = dist[k];
#pragma unroll
    for (int k = 0; k < 6; ++k) pose[0][k] = T(va[kPose + k]);
    Acc c[2];
    Acc c1[1];
    view_costs<1>(kt, dt, pose, obj, img, vmask, v, n, lane, c1);
    c[0] = __shfl_sync(0xffffffffu, c1[0], 0);
    c[1] = 0.0;
    push_costs(v, c);
  }
  cluster.sync();
  Acc cost, unused;
  cost_sums(cost, unused);
  cost = 0.5 * cost;
  T lam = T(1e-3);

  int it = 0;
  while (it < max_iters) {
    // A. Each view's rows, sums, factorisations and Schur terms.
    for (int lv = warp; lv < own; lv += n_warps) {
      const int v = rank + lv * n_blocks;
      Acc* va = area(v);
      view_terms<T, MI>(va, rows, lu, L, kv, dist, obj, img, vmask, v, lam, off, ca, cb, lane);
      if (table) {  // the view's Schur terms into every block's table
        for (int e = lane; e < kTerms; e += 32) {
          int src;
          if (e < MI * (MI + 1) / 2) {
            int a, b;
            tri(e, MI, a, b);
            src = kA + tri_index(a, b, kMaxIntr);
          } else if (e < kAI) {
            src = kGi + e - MI * (MI + 1) / 2;
          } else {
            const int t = (e - kAI) / kTrialTerms, k = (e - kAI) % kTrialTerms;
            src = kTrial0 + t * kTrial + (k < MI * MI ? kS + kMaxIntr * (k / MI) + k % MI : kSv + k - MI * MI);
          }
          const Acc x = va[src];
          for (int r = 0; r < n_blocks; ++r) {
            Acc* dst = r == rank ? terms : cluster.map_shared_rank(terms, r);
            dst[v * kTerms + e] = x;
          }
        }
      }
    }
    cluster.sync();
    // B. Each trial's Schur complement, summed over the views in order, and
    // its intrinsic step: in every block alike.
    for (int t = warp; t < 2; t += n_warps) {
      const Acc lam_t = Acc(t == 0 ? lam : lam * T(10));
      Acc* sm = lu;  // S (9 x 9), then its right side
      // Entry e of S (e < ni^2) or of its right side: the two sums it takes,
      // chosen without a branch so the lanes load together.
      for (int e = lane; e < ni * ni + ni; e += 32) {
        const bool of_s = e < ni * ni;
        const int a = of_s ? e / ni : e - ni * ni, b = of_s ? e % ni : 0;
        const int lo = min(a, b), hi = max(a, b);
        Acc sa, s;
        view_sums(of_s ? kA + tri_index(lo, hi, kMaxIntr) : kGi + a,
                  kTrial0 + t * kTrial + (of_s ? kS + kMaxIntr * a + b : kSv + a),
                  of_s ? tri_index(lo, hi, MI) : kAI - MI + a,
                  kAI + t * kTrialTerms + (of_s ? MI * a + b : MI * MI + a), sa, s);
        if (of_s) {
          Acc ad = sa;
          if (a == b) ad = ad + lam_t * pinhole::clamp_min(sa, 1e-12);
          sm[kMaxIntr * a + b] = ad - s;
        } else {
          sm[81 + a] = sa - s;
        }
      }
      __syncwarp();
      pinhole::group_lu_solve<MI, kMaxIntr, 1>(sm, sm + 81, ni, lane < ni ? lane : -1, lane == 0 ? 0 : -1);
      if (lane < ni) {
        misc[kDi + kMaxIntr * t + lane] = sm[81 + lane];
        misc[kCi + kMaxIntr * t + lane] = Acc(T(Acc(pick(ti, lane)) - sm[81 + lane]));
      }
      __syncwarp();
    }
    __syncthreads();
    // C. Each view's two candidate poses and their costs.
    for (int lv = warp; lv < own; lv += n_warps) {
      const int v = rank + lv * n_blocks;
      Acc* va = area(v);
      if (lane < 12) {
        const int t = lane / 6, k = lane % 6;
        const Acc* x = va + kTrial0 + t * kTrial + kX + 10 * k;
        Acc s = 0.0;
        for (int b = 0; b < ni; ++b) s += x[b] * misc[kDi + kMaxIntr * t + b];
        const Acc step = x[kMaxIntr] - s;
        va[kCand + 6 * t + k] = Acc(T(va[kPose + k] - step));
      }
      __syncwarp();
      T kt[2][4], dt[2][5], pose[2][6];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        T ci[MI];
#pragma unroll
        for (int j = 0; j < MI; ++j) ci[j] = j < ni ? T(misc[kCi + kMaxIntr * t + j]) : T(0);
        intrinsics_of(ci, L, cx_fixed, cy_fixed, kt[t], dt[t]);
#pragma unroll
        for (int k = 0; k < 6; ++k) pose[t][k] = T(va[kCand + 6 * t + k]);
      }
      Acc c[2];
      view_costs<2>(kt, dt, pose, obj, img, vmask, v, n, lane, c);
#pragma unroll
      for (int t = 0; t < 2; ++t) c[t] = __shfl_sync(0xffffffffu, c[t], 0);
      push_costs(v, c);
    }
    cluster.sync();
    // D. The decision, alike in every thread.
    Acc c1, c2;
    cost_sums(c1, c2);
    c1 = 0.5 * c1;
    c2 = 0.5 * c2;
    const bool use1 = c1 <= c2;
    const Acc cand_cost = use1 ? c1 : c2;
    const T cand_lam = use1 ? lam * T(0.5) : lam * T(10);
    const bool improved = cand_cost < cost;
    const Acc new_cost = improved ? cand_cost : cost;
    const Acc rel = pinhole::pabs(cost - new_cost) / pinhole::clamp_min(cost, 1e-12);
    const bool done = (!improved && lam > T(1e8)) || rel < 1e-10;
    lam = improved ? cand_lam : lam * T(10);
    cost = new_cost;
    if (improved) {
      const int use = use1 ? 0 : 1;
#pragma unroll
      for (int j = 0; j < MI; ++j)
        if (j < ni) ti[j] = T(misc[kCi + kMaxIntr * use + j]);
      intrinsics_of(ti, L, cx_fixed, cy_fixed, kv, dist);
      for (int lv = warp; lv < own; lv += n_warps) {
        Acc* va = area(rank + lv * n_blocks);
        if (lane < 6) va[kPose + lane] = va[kCand + 6 * use + lane];
      }
    }
    __syncwarp();
    ++it;
    if (done) break;
  }

  if (rank == 0) {
#pragma unroll
    for (int j = 0; j < MI; ++j)
      if (j < ni && tid == j) theta_out[j] = ti[j];
    if (tid == 0) {
      cost_out[0] = T(cost);
      iters_out[0] = it;
    }
  }
  for (int lv = warp; lv < own; lv += n_warps) {
    const int v = rank + lv * n_blocks;
    if (lane < 6) theta_out[ni + 6 * v + lane] = T(area(v)[kPose + lane]);
  }
  cluster.sync();  // no block leaves while another may read its views
}

template <typename T, int MI>
int launch_mi(const void* theta0, const void* img, const void* obj, const void* vmask, const Layout& L, double cx_fixed,
              double cy_fixed, int max_iters, void* work, void* theta_out, void* cost_out, void* iters_out,
              void* stream) {
  const bool in_shared = views_in_shared(L.f, L.n_intr, sizeof(T));
  const long long bytes = smem_bytes(L.f, L.n_intr, sizeof(T), in_shared, schur_table_fits(L.f, L.n_intr, sizeof(T)));
  if (!in_shared && work == nullptr) return (int)cudaErrorInvalidValue;
  const cudaError_t set =
      cudaFuncSetAttribute(calib_lm_kernel<T, MI>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (set != cudaSuccess) return (int)set;
  const int blocks = blocks_for(L.f);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks, 1, 1);
  config.blockDim = dim3(32 * warps_for(L.f, sizeof(T)), 1, 1);
  config.dynamicSmemBytes = (size_t)bytes;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t code = cudaLaunchKernelEx(
      &config, calib_lm_kernel<T, MI>, static_cast<const T*>(theta0), static_cast<const T*>(img),
      static_cast<const T*>(obj), static_cast<const uint8_t*>(vmask), L, static_cast<T>(cx_fixed),
      static_cast<T>(cy_fixed), max_iters, in_shared ? nullptr : static_cast<Acc*>(work), static_cast<T*>(theta_out),
      static_cast<T*>(cost_out), static_cast<int*>(iters_out));
  return code != cudaSuccess ? (int)code : (int)cudaGetLastError();
}

template <typename T>
int launch(const void* theta0, const void* img, const void* obj, const void* vmask, int f, int n, int n_focal,
           int n_pp, int num_dist, double cx_fixed, double cy_fixed, int max_iters, void* work, void* theta_out,
           void* cost_out, void* iters_out, void* stream) {
  if (f < 1 || n < 1 || (n_focal != 1 && n_focal != 2) || (n_pp != 0 && n_pp != 2) || num_dist < 0 || num_dist > 5 ||
      max_iters < 0)
    return (int)cudaErrorInvalidValue;
  Layout L;
  L.f = f;
  L.n = n;
  L.n_focal = n_focal;
  L.n_pp = n_pp;
  L.num_dist = num_dist;
  L.n_intr = n_focal + n_pp + num_dist;
  const auto run = intr_slots(L.n_intr) == 1   ? launch_mi<T, 1>
                   : intr_slots(L.n_intr) == 4 ? launch_mi<T, 4>
                                               : launch_mi<T, kMaxIntr>;
  return run(theta0, img, obj, vmask, L, cx_fixed, cy_fixed, max_iters, work, theta_out, cost_out, iters_out, stream);
}

}  // namespace

// The bytes of workspace one call needs for a type of `itemsize` bytes:
// none when every view's sums and trial terms fit in the block's shared
// memory beside the warps' rows, else 456 doubles a view.
extern "C" long long calib_lm_workspace(int f, int n, int n_intr, int itemsize) {
  (void)n;
  return views_in_shared(f, n_intr, itemsize) ? 0 : (long long)f * kViewArea * (long long)sizeof(Acc);
}

// One run_lm: theta0 (n_intr + 6f), img (f x n x 2), obj (n x 3), vmask (f
// bytes, or null), the parameter layout (n_focal 1 or 2, n_pp 0 or 2,
// num_dist 0-5), the fixed principal point (read when n_pp is 0), up to
// max_iters iterations. Writes theta (n_intr + 6f), the final cost and the
// iterations taken. Returns the launch's cudaError_t.
extern "C" int calib_lm_f32(const void* theta0, const void* img, const void* obj, const void* vmask, int f, int n,
                            int n_focal, int n_pp, int num_dist, double cx_fixed, double cy_fixed, int max_iters,
                            void* work, void* theta_out, void* cost_out, void* iters_out, void* stream) {
  return launch<float>(theta0, img, obj, vmask, f, n, n_focal, n_pp, num_dist, cx_fixed, cy_fixed, max_iters, work,
                       theta_out, cost_out, iters_out, stream);
}

extern "C" int calib_lm_f64(const void* theta0, const void* img, const void* obj, const void* vmask, int f, int n,
                            int n_focal, int n_pp, int num_dist, double cx_fixed, double cy_fixed, int max_iters,
                            void* work, void* theta_out, void* cost_out, void* iters_out, void* stream) {
  return launch<double>(theta0, img, obj, vmask, f, n, n_focal, n_pp, num_dist, cx_fixed, cy_fixed, max_iters, work,
                        theta_out, cost_out, iters_out, stream);
}
