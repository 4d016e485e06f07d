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
// iteration. The iterations are a chain, and each is a chain of block-wide
// phases (Jacobian rows; per-view sums; intrinsic sums; per-view 6x6 solves
// for both trials; the Schur complement; its solve; the candidates; their
// costs; the decision), so the time is iterations x phases x a barrier and
// a pass each.
//
// Design: one block of 256 threads. The Jacobian is block-sparse: a view's
// rows touch the intrinsics and that view's six pose parameters only. So
// J^T J is an arrowhead -- the intrinsic block A (n_intr x n_intr), one
// cross block B_v (n_intr x 6) and one 6x6 block C_v per view -- and
// Marquardt's damping diag(max(diag(J^T J), 1e-12)) keeps that shape. Each
// trial eliminates the view blocks into the intrinsics' Schur complement
//   S = A_d - sum_v B_v C_vd^-1 B_v^T,  S d_i = g_i - sum_v B_v C_vd^-1 g_v,
//   d_v = C_vd^-1 g_v - (C_vd^-1 B_v^T) d_i,
// the dense system's exact solution in another rounding; the dense
// (n_intr + 6F)^2 matrix never exists. Phases:
//  1. a thread per point: its two residuals, their six pose tangents (one
//     pass of pinhole_jet.cuh's project_distorted) and n_intr intrinsic
//     tangents (a second pass from the camera frame on: distortion, focal,
//     centre), masked views multiplied by 0 as the plain version does;
//     rows to the workspace;
//  2. a thread per (view, entry): C_v, B_v, g_v and the view's shares of A
//     and g_i, summed over the view's rows in order;
//  3. a thread per entry of A and g_i, summed over the views in order;
//  4. a thread per (trial, view): C_vd by LU with partial pivoting against
//     [B_v^T | g_v], and the view's terms of S and of its right side;
//  5. a thread per (trial, entry of S): the sums over the views in order;
//  6. a thread per trial: S's solve (LU, partial pivoting);
//  7. a thread per (trial, parameter): the candidate theta - step;
//  8. the threads over the points: both candidates' costs, per-thread sums,
//     warp shuffles, one fixed-order pass over the warps;
//  9. thread 0: the reference's rule -- the cheaper trial, accepted if it
//     lowers the cost; lam x 0.5 or x 10; done when not improved with
//     lam > 1e8 or when the relative change is under 1e-10 -- and the block
//     copies the accepted candidate.
// The rows, per-view sums and trial terms live in a global workspace the
// wrapper allocates (L2-resident at these sizes); the intrinsic blocks, the
// damping, the costs and the flags in shared memory.
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
// held.

#include "pinhole_jet.cuh"

namespace {

using pinhole::Jet;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxIntr = 9;          // 2 focals, 2 centre coordinates, 5 distortion coefficients
constexpr int kRow = 1 + kMaxIntr + 6;  // a row: r, its intrinsic tangents, its pose tangents
// One view's sums: C_v (21), B_v (9 x 6), g_v (6), its share of A (45) and of g_i (9).
constexpr int kC = 0, kB = 21, kG = 75, kA = 81, kGi = 126, kView = 135;
// One (trial, view)'s terms: X = C_vd^-1 [B_v^T | g_v] (6 x 10), S_v (9 x 9), s_v (9).
constexpr int kX = 0, kS = 60, kSv = 141, kTrial = 150;

struct Layout {
  int f, n, n_intr, n_focal, n_pp, num_dist, n_params;
};

using Acc = double;  // sums, eliminations, solves and steps

template <typename T>
struct Shared {
  T lam;
  Acc cost, c[2];
  Acc a[kMaxIntr][kMaxIntr], gi[kMaxIntr];
  Acc s[2][kMaxIntr][kMaxIntr], rhs[2][kMaxIntr], di[2][kMaxIntr];
  Acc warp_part[2][kWarps];
  int improved, use1, done;
};

// (a, b) with a <= b of the e-th entry of an n x n upper triangle, row-major.
__device__ __forceinline__ void tri(int e, int n, int& a, int& b) {
  a = 0;
  while (e >= n - a) {
    e -= n - a;
    ++a;
  }
  b = a + e;
}

// The intrinsics of theta as (fx, fy, cx, cy, dist[5]) plain values.
template <typename T>
__device__ __forceinline__ void intrinsics_of(const T* theta, const Layout& L, T cx_fixed, T cy_fixed, T (&kv)[4],
                                              T (&dist)[5]) {
  kv[0] = theta[0];
  kv[1] = L.n_focal == 1 ? theta[0] : theta[1];
  kv[2] = L.n_pp == 0 ? cx_fixed : theta[L.n_focal];
  kv[3] = L.n_pp == 0 ? cy_fixed : theta[L.n_focal + 1];
#pragma unroll
  for (int j = 0; j < 5; ++j) dist[j] = j < L.num_dist ? theta[L.n_focal + L.n_pp + j] : T(0);
}

// The masked residual (proj - img) * vmask of one point under theta,
// computed in C from the values of type T.
template <typename C, typename T>
__device__ __forceinline__ void residual(const T* theta, const Layout& L, T cx_fixed, T cy_fixed, const T* obj,
                                         const T* img, const uint8_t* vmask, int v, int i, C (&r)[2]) {
  T kt[4], dt[5];
  intrinsics_of(theta, L, cx_fixed, cy_fixed, kt, dt);
  const T* pv = theta + L.n_intr + 6 * v;
  const C dist[5] = {C(dt[0]), C(dt[1]), C(dt[2]), C(dt[3]), C(dt[4])};
  const C pose[6] = {C(pv[0]), C(pv[1]), C(pv[2]), C(pv[3]), C(pv[4]), C(pv[5])};
  const C p[3] = {C(obj[3 * i]), C(obj[3 * i + 1]), C(obj[3 * i + 2])};
  C uv[2];
  pinhole::project_distorted(p, pose, C(kt[0]), C(kt[1]), C(kt[2]), C(kt[3]), dist, uv);
  const int64_t q = (int64_t)v * L.n + i;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    r[c] = uv[c] - C(img[2 * q + c]);
    if (vmask != nullptr) r[c] = r[c] * (vmask[v] ? C(1) : C(0));
  }
}

// Phase 1 for one point: its two rows [r, dr/d intrinsics (9 slots), dr/d pose (6)].
template <typename T>
__device__ void point_rows(const T* theta, const Layout& L, T cx_fixed, T cy_fixed, const T* obj, const T* img,
                           const uint8_t* vmask, int v, int i, T* rows) {
  T kv[4], dist[5];
  intrinsics_of(theta, L, cx_fixed, cy_fixed, kv, dist);
  const T* pv = theta + L.n_intr + 6 * v;
  const int64_t q = (int64_t)v * L.n + i;
  const T m = vmask == nullptr ? T(1) : (vmask[v] ? T(1) : T(0));

  // The pose's six tangents through the whole projection.
  using J6 = Jet<T, 6>;
  J6 pose[6], p6[3], dist6[5];
#pragma unroll
  for (int j = 0; j < 6; ++j) pose[j] = pinhole::jet<T, 6>(pv[j], j);
#pragma unroll
  for (int j = 0; j < 3; ++j) p6[j] = pinhole::make_jet<T, 6>(obj[3 * i + j]);
#pragma unroll
  for (int j = 0; j < 5; ++j) dist6[j] = pinhole::make_jet<T, 6>(dist[j]);
  J6 uv6[2];
  pinhole::project_distorted(p6, pose, pinhole::make_jet<T, 6>(kv[0]), pinhole::make_jet<T, 6>(kv[1]),
                             pinhole::make_jet<T, 6>(kv[2]), pinhole::make_jet<T, 6>(kv[3]), dist6, uv6);

  // The intrinsics' tangents: the camera frame does not depend on them.
  using J9 = Jet<T, kMaxIntr>;
  const T pose_v[6] = {pv[0], pv[1], pv[2], pv[3], pv[4], pv[5]};
  const T p[3] = {obj[3 * i], obj[3 * i + 1], obj[3 * i + 2]};
  T cam[3];
  pinhole::to_camera(p, pose_v, cam);
  const J9 x = pinhole::make_jet<T, kMaxIntr>(cam[0] / cam[2]);
  const J9 y = pinhole::make_jet<T, kMaxIntr>(cam[1] / cam[2]);
  const J9 fx = pinhole::jet<T, kMaxIntr>(kv[0], 0);
  const J9 fy = pinhole::jet<T, kMaxIntr>(kv[1], L.n_focal == 1 ? 0 : 1);
  const J9 cx = pinhole::jet<T, kMaxIntr>(kv[2], L.n_pp == 0 ? -1 : L.n_focal);
  const J9 cy = pinhole::jet<T, kMaxIntr>(kv[3], L.n_pp == 0 ? -1 : L.n_focal + 1);
  J9 dist9[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) dist9[j] = pinhole::jet<T, kMaxIntr>(dist[j], j < L.num_dist ? L.n_focal + L.n_pp + j : -1);
  J9 xd, yd;
  pinhole::distort(x, y, dist9, xd, yd);
  const J9 uv9[2] = {xd * fx + cx, yd * fy + cy};

#pragma unroll
  for (int c = 0; c < 2; ++c) {
    T* row = rows + (2 * q + c) * kRow;
    row[0] = (uv6[c].v - img[2 * q + c]) * m;
#pragma unroll
    for (int j = 0; j < kMaxIntr; ++j) row[1 + j] = uv9[c].d[j] * m;
#pragma unroll
    for (int j = 0; j < 6; ++j) row[1 + kMaxIntr + j] = uv6[c].d[j] * m;
  }
}

// The sum over one view's rows of row[ca] * row[cb], in row order.
template <typename T>
__device__ __forceinline__ Acc view_dot(const T* rows, int v, int n, int ca, int cb) {
  Acc s = 0.0;
  const T* r = rows + (int64_t)v * n * 2 * kRow;
  for (int k = 0; k < 2 * n; ++k) s += Acc(r[k * kRow + ca]) * Acc(r[k * kRow + cb]);
  return s;
}

// Sums the per-thread costs of both trials over the block into sh.c[0..1].
template <typename T>
__device__ __forceinline__ void block_costs(Shared<T>& sh, Acc (&acc)[2]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const Acc s = pinhole::warp_sum(acc[t]);
    if (lane == 0) sh.warp_part[t][warp] = s;
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    Acc s = sh.warp_part[threadIdx.x][0];
    for (int w = 1; w < kWarps; ++w) s += sh.warp_part[threadIdx.x][w];
    sh.c[threadIdx.x] = 0.5 * s;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads) calib_lm_kernel(
    const T* __restrict__ theta0, const T* __restrict__ img, const T* __restrict__ obj,
    const uint8_t* __restrict__ vmask, Layout L, T cx_fixed, T cy_fixed, int max_iters, T* __restrict__ work,
    Acc* __restrict__ work_acc, T* __restrict__ theta_out, T* __restrict__ cost_out, int* __restrict__ iters_out) {
  __shared__ Shared<T> sh;
  const int tid = threadIdx.x;
  const int np = L.n_params, ni = L.n_intr, f = L.f, n = L.n;
  const int points = f * n;
  T* theta = work;
  T* cand = theta + np;  // two candidates
  T* rows = cand + 2 * np;
  Acc* views = work_acc;
  Acc* trials = views + (int64_t)f * kView;

  for (int j = tid; j < np; j += kThreads) theta[j] = theta0[j];
  __syncthreads();
  {  // The starting cost.
    Acc acc[2] = {0.0, 0.0};
    for (int q = tid; q < points; q += kThreads) {
      Acc r[2];
      residual(theta, L, cx_fixed, cy_fixed, obj, img, vmask, q / n, q % n, r);
      acc[0] += r[0] * r[0] + r[1] * r[1];
    }
    block_costs(sh, acc);
    if (tid == 0) {
      sh.cost = sh.c[0];
      sh.lam = T(1e-3);
    }
    __syncthreads();
  }

  int it = 0;
  while (it < max_iters) {
    // 1. The rows.
    for (int q = tid; q < points; q += kThreads) point_rows(theta, L, cx_fixed, cy_fixed, obj, img, vmask, q / n, q % n, rows);
    __syncthreads();
    // 2. Per-view sums.
    for (int t = tid; t < f * kView; t += kThreads) {
      const int v = t / kView, e = t % kView;
      int ca, cb;
      if (e < kB) {
        int a, b;
        tri(e - kC, 6, a, b);
        ca = 1 + kMaxIntr + a, cb = 1 + kMaxIntr + b;
      } else if (e < kG) {
        const int a = (e - kB) / 6, b = (e - kB) % 6;
        if (a >= ni) continue;
        ca = 1 + a, cb = 1 + kMaxIntr + b;
      } else if (e < kA) {
        ca = 1 + kMaxIntr + (e - kG), cb = 0;
      } else if (e < kGi) {
        int a, b;
        tri(e - kA, kMaxIntr, a, b);
        if (b >= ni) continue;
        ca = 1 + a, cb = 1 + b;
      } else {
        const int a = e - kGi;
        if (a >= ni) continue;
        ca = 1 + a, cb = 0;
      }
      views[(int64_t)v * kView + e] = view_dot(rows, v, n, ca, cb);
    }
    __syncthreads();
    // 3. A and g_i, summed over the views.
    for (int t = tid; t < 45 + kMaxIntr; t += kThreads) {
      if (t < 45) {
        int a, b;
        tri(t, kMaxIntr, a, b);
        if (b >= ni) continue;
        Acc s = 0.0;
        for (int v = 0; v < f; ++v) s += views[(int64_t)v * kView + kA + t];
        sh.a[a][b] = sh.a[b][a] = s;
      } else {
        const int a = t - 45;
        if (a >= ni) continue;
        Acc s = 0.0;
        for (int v = 0; v < f; ++v) s += views[(int64_t)v * kView + kGi + a];
        sh.gi[a] = s;
      }
    }
    __syncthreads();
    // 4. Each trial's view terms.
    for (int t = tid; t < 2 * f; t += kThreads) {
      const int trial = t / f, v = t % f;
      const Acc lam = Acc(trial == 0 ? sh.lam : sh.lam * T(10));
      const Acc* vs = views + (int64_t)v * kView;
      Acc* out = trials + ((int64_t)trial * f + v) * kTrial;
      Acc cd[6][6];
      for (int e = 0; e < 21; ++e) {
        int a, b;
        tri(e, 6, a, b);
        cd[a][b] = cd[b][a] = vs[kC + e];
      }
      for (int a = 0; a < 6; ++a) cd[a][a] = cd[a][a] + lam * pinhole::clamp_min(vs[kC + (a * (13 - a)) / 2], 1e-12);
      // X = C_vd^-1 [B_v^T | g_v]: column c < ni is B_v's row c, column 9 is g_v.
      for (int c = 0; c <= ni; ++c) {
        const int col = c < ni ? c : kMaxIntr;
        Acc a[6][6], rhs[6], x[6];
        for (int r = 0; r < 6; ++r) {
          for (int q = 0; q < 6; ++q) a[r][q] = cd[r][q];
          rhs[r] = c < ni ? vs[kB + 6 * c + r] : vs[kG + r];
        }
        pinhole::lu_solve<Acc, 6>(a, rhs, x, 6);
        for (int r = 0; r < 6; ++r) out[kX + 10 * r + col] = x[r];
      }
      // S_v = B_v X_B, s_v = B_v X_g.
      for (int a = 0; a < ni; ++a) {
        for (int b = 0; b < ni; ++b) {
          Acc s = 0.0;
          for (int k = 0; k < 6; ++k) s += vs[kB + 6 * a + k] * out[kX + 10 * k + b];
          out[kS + kMaxIntr * a + b] = s;
        }
        Acc s = 0.0;
        for (int k = 0; k < 6; ++k) s += vs[kB + 6 * a + k] * out[kX + 10 * k + kMaxIntr];
        out[kSv + a] = s;
      }
    }
    __syncthreads();
    // 5. The Schur complements and their right sides.
    for (int t = tid; t < 2 * (kMaxIntr * kMaxIntr + kMaxIntr); t += kThreads) {
      const int trial = t / (kMaxIntr * kMaxIntr + kMaxIntr), e = t % (kMaxIntr * kMaxIntr + kMaxIntr);
      const Acc lam = Acc(trial == 0 ? sh.lam : sh.lam * T(10));
      const Acc* tv = trials + (int64_t)trial * f * kTrial;
      if (e < kMaxIntr * kMaxIntr) {
        const int a = e / kMaxIntr, b = e % kMaxIntr;
        if (a >= ni || b >= ni) continue;
        Acc s = 0.0;
        for (int v = 0; v < f; ++v) s += tv[(int64_t)v * kTrial + kS + e];
        Acc ad = sh.a[a][b];
        if (a == b) ad = ad + lam * pinhole::clamp_min(sh.a[a][a], 1e-12);
        sh.s[trial][a][b] = ad - s;
      } else {
        const int a = e - kMaxIntr * kMaxIntr;
        if (a >= ni) continue;
        Acc s = 0.0;
        for (int v = 0; v < f; ++v) s += tv[(int64_t)v * kTrial + kSv + a];
        sh.rhs[trial][a] = sh.gi[a] - s;
      }
    }
    __syncthreads();
    // 6. Each trial's intrinsic step.
    if (tid < 2) {
      Acc a[kMaxIntr][kMaxIntr], rhs[kMaxIntr], x[kMaxIntr];
      for (int r = 0; r < ni; ++r) {
        for (int q = 0; q < ni; ++q) a[r][q] = sh.s[tid][r][q];
        rhs[r] = sh.rhs[tid][r];
      }
      pinhole::lu_solve<Acc, kMaxIntr>(a, rhs, x, ni);
      for (int r = 0; r < ni; ++r) sh.di[tid][r] = x[r];
    }
    __syncthreads();
    // 7. The candidates theta - step.
    for (int t = tid; t < 2 * np; t += kThreads) {
      const int trial = t / np, j = t % np;
      Acc step;
      if (j < ni) {
        step = sh.di[trial][j];
      } else {
        const int v = (j - ni) / 6, k = (j - ni) % 6;
        const Acc* x = trials + ((int64_t)trial * f + v) * kTrial + kX + 10 * k;
        Acc s = 0.0;
        for (int b = 0; b < ni; ++b) s += x[b] * sh.di[trial][b];
        step = x[kMaxIntr] - s;
      }
      cand[(int64_t)trial * np + j] = T(Acc(theta[j]) - step);
    }
    __syncthreads();
    // 8. Their costs.
    Acc acc[2] = {0.0, 0.0};
    for (int q = tid; q < points; q += kThreads) {
#pragma unroll
      for (int trial = 0; trial < 2; ++trial) {
        Acc r[2];
        residual(cand + (int64_t)trial * np, L, cx_fixed, cy_fixed, obj, img, vmask, q / n, q % n, r);
        acc[trial] += r[0] * r[0] + r[1] * r[1];
      }
    }
    block_costs(sh, acc);
    // 9. The decision.
    if (tid == 0) {
      const Acc c1 = sh.c[0], c2 = sh.c[1], cost = sh.cost;
      const T lam = sh.lam;
      const bool use1 = c1 <= c2;
      const Acc cand_cost = use1 ? c1 : c2;
      const T cand_lam = use1 ? lam * T(0.5) : lam * T(10);
      const bool improved = cand_cost < cost;
      const Acc new_cost = improved ? cand_cost : cost;
      const Acc rel = pinhole::pabs(cost - new_cost) / pinhole::clamp_min(cost, 1e-12);
      sh.done = ((!improved && lam > T(1e8)) || rel < 1e-10) ? 1 : 0;
      sh.lam = improved ? cand_lam : lam * T(10);
      sh.cost = new_cost;
      sh.improved = improved ? 1 : 0;
      sh.use1 = use1 ? 1 : 0;
    }
    __syncthreads();
    if (sh.improved) {
      const T* src = cand + (sh.use1 ? 0 : np);
      for (int j = tid; j < np; j += kThreads) theta[j] = src[j];
    }
    ++it;
    const int done = sh.done;
    __syncthreads();
    if (done) break;
  }

  for (int j = tid; j < np; j += kThreads) theta_out[j] = theta[j];
  if (tid == 0) {
    cost_out[0] = T(sh.cost);
    iters_out[0] = it;
  }
}

// Bytes of the workspace's typed part, rounded up to 8.
long long typed_bytes(int f, int n, int n_intr, int itemsize) {
  const long long np = n_intr + 6LL * f;
  const long long bytes = (3 * np + 2LL * f * n * kRow) * itemsize;
  return (bytes + 7) / 8 * 8;
}

template <typename T>
int launch(const void* theta0, const void* img, const void* obj, const void* vmask, int f, int n, int n_focal,
           int n_pp, int num_dist, double cx_fixed, double cy_fixed, int max_iters, void* work, void* theta_out,
           void* cost_out, void* iters_out, void* stream) {
  // The workspace: the parameter vectors and rows in T, then (8-aligned) the
  // per-view sums and trial terms in double.
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
  L.n_params = L.n_intr + 6 * f;
  calib_lm_kernel<T><<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(theta0), static_cast<const T*>(img), static_cast<const T*>(obj),
      static_cast<const uint8_t*>(vmask), L, static_cast<T>(cx_fixed), static_cast<T>(cy_fixed), max_iters,
      static_cast<T*>(work), reinterpret_cast<Acc*>(static_cast<char*>(work) + typed_bytes(f, n, L.n_intr, sizeof(T))),
      static_cast<T*>(theta_out), static_cast<T*>(cost_out), static_cast<int*>(iters_out));
  return (int)cudaGetLastError();
}

}  // namespace

// The bytes of workspace one call needs for a type of `itemsize` bytes:
// three parameter vectors and two rows of 16 per point in that type, then
// 135 sums per view and 150 terms per trial and view in double.
extern "C" long long calib_lm_workspace(int f, int n, int n_intr, int itemsize) {
  return typed_bytes(f, n, n_intr, itemsize) + ((long long)f * kView + 2LL * f * kTrial) * (long long)sizeof(Acc);
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
