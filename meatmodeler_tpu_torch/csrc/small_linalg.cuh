// Small dense linear algebra in one thread's registers, for the relative
// pose's hand-written Hopper kernels (relpose_hyp.cu): what the plain
// versions (geometry/ransac.py) take from torch.linalg and geometry/so3.py.
//
// Every function is a template over its scalar (float on the path, double
// for the held comparison) and runs on the host as well as the card, so one
// body serves both. Matrices are row-major arrays; a symmetric n x n matrix
// is packed as its upper triangle, row by row (sym_index).
//
//   jacobi_eigh    eigen-decomposition of a packed symmetric matrix by cyclic
//                  Jacobi: rotations in the fixed order (0,1), (0,2), ...,
//                  (n-2,n-1), at most Limits<T>::sweeps sweeps, a sweep
//                  that rotates nothing ends it. A rotation of (p, q) is
//                  skipped when |a_pq| <= (eps / 64) * trace (the matrices
//                  here are positive semi-definite, so the trace bounds the
//                  norm): what is left perturbs the eigenvectors by less than
//                  rounding does in LAPACK's backward-stable solvers.
//   smallest_eigvec
//                  the eigenvector of the least eigenvalue of a packed
//                  symmetric matrix (the first on ties), unit length, with
//                  the sign rule: its entry of largest magnitude (the first
//                  on ties) is positive. eigh's sign is arbitrary, so callers
//                  compare such vectors up to sign. A non-finite matrix gives
//                  NaN, as the plain versions' _eigh does.
//   null_vector    the same vector of a^T a for an m x n matrix a, by the same
//                  cyclic Jacobi applied to a's columns (one-sided, Hestenes):
//                  each rotation is the one jacobi_eigh would make on a^T a,
//                  with (a^T a)_pq recomputed from the rotated columns, so
//                  a^T a is never formed and the vector's error goes with
//                  a's condition number, not its square. A rotation is
//                  skipped when the columns are orthogonal to rounding,
//                  |b_p . b_q| <= eps |b_p| |b_q|, or when either column's
//                  squared norm is at the rounding floor, eps^2 |a|_F^2: a
//                  null column shrinks to rounding noise whose direction is
//                  random, so without the floor it never tests orthogonal
//                  and every call runs all sweeps (12 in float32 on the
//                  8-point designs; ~5 with it, the vectors within 3e-5 of
//                  the float64 solve where float32 decides them). The vector
//                  is that of the shortest rotated column; sign rule and NaN
//                  as above.
//   svd3           a 3 x 3 SVD, a = U diag(s) V^T, s descending and >= 0, by
//                  null_vector's one-sided Jacobi (its floor included): V the accumulated
//                  rotations, b_i = a v_i, s_i = |b_i| (sorted descending,
//                  ties kept in index order), u_1 = b_1 / s_1, u_2 = b_2
//                  orthogonalised against u_1 and normalised, u_3 = u_1 x u_2
//                  (negated if u_3 . b_3 < 0). A zero column takes the next
//                  unit axis, so the zero matrix gives U = V = I, as LAPACK
//                  and cuSOLVER's Jacobi do. A non-finite a gives NaN
//                  throughout, as _svd does.
//   det3, inv3     determinant (cofactor expansion along the first row) and
//                  inverse (adjugate over it).
//   so3_exp, so3_log
//                  geometry/so3.py exp and log with their branches: the
//                  theta^2 < 1e-12 Taylor forms, atan2 for the angle and the
//                  diagonal-based axis beyond theta = 2.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace sl {

#define SL_FN __host__ __device__ __forceinline__

__host__ __device__ __forceinline__ float tsqrt(float x) { return sqrtf(x); }
__host__ __device__ __forceinline__ double tsqrt(double x) { return sqrt(x); }
__host__ __device__ __forceinline__ float tabs(float x) { return fabsf(x); }
__host__ __device__ __forceinline__ double tabs(double x) { return fabs(x); }
__host__ __device__ __forceinline__ float tsin(float x) { return sinf(x); }
__host__ __device__ __forceinline__ double tsin(double x) { return sin(x); }
__host__ __device__ __forceinline__ float tcos(float x) { return cosf(x); }
__host__ __device__ __forceinline__ double tcos(double x) { return cos(x); }
__host__ __device__ __forceinline__ float tatan2(float y, float x) { return atan2f(y, x); }
__host__ __device__ __forceinline__ double tatan2(double y, double x) { return atan2(y, x); }

template <typename T>
struct Limits;
template <>
struct Limits<float> {
  static constexpr float eps = 1.1920928955078125e-07f;
  static constexpr int sweeps = 12;
};
template <>
struct Limits<double> {
  static constexpr double eps = 2.220446049250313e-16;
  static constexpr int sweeps = 20;
};

template <typename T>
SL_FN bool finite(T x) {
  return (x - x) == T(0);
}

template <typename T>
SL_FN T nan_value() {
  return T(NAN);
}

// max(x, floor) and min(x, ceil) that keep NaN, as torch.clamp,
// torch.maximum and torch.minimum do.
template <typename T>
SL_FN T clamp_min(T x, T floor) {
  return (x != x || x >= floor) ? x : floor;
}
template <typename T>
SL_FN T nan_max(T a, T b) {
  return (a != a || b != b) ? a + b : (a >= b ? a : b);
}
template <typename T>
SL_FN T nan_min(T a, T b) {
  return (a != a || b != b) ? a + b : (a <= b ? a : b);
}

// Index of (i, j) in an n x n symmetric matrix packed by its upper triangle.
template <int N>
SL_FN constexpr int sym_index(int i, int j) {
  return i <= j ? i * N - i * (i - 1) / 2 + (j - i) : j * N - j * (j - 1) / 2 + (i - j);
}

// a (packed, in) -> its eigenvalues on the diagonal of a (out); v (n x n,
// row-major) holds the eigenvectors in its columns.
template <typename T, int N>
SL_FN void jacobi_eigh(T (&a)[N * (N + 1) / 2], T (&v)[N * N]) {
#pragma unroll
  for (int i = 0; i < N * N; ++i) v[i] = (i % (N + 1) == 0) ? T(1) : T(0);
  T trace = T(0);
#pragma unroll
  for (int i = 0; i < N; ++i) trace += a[sym_index<N>(i, i)];
  const T skip = (Limits<T>::eps / T(64)) * tabs(trace);
  for (int sweep = 0; sweep < Limits<T>::sweeps; ++sweep) {
    bool rotated = false;
#pragma unroll
    for (int p = 0; p < N - 1; ++p) {
#pragma unroll
      for (int q = p + 1; q < N; ++q) {
        const T apq = a[sym_index<N>(p, q)];
        if (!(tabs(apq) > skip)) continue;
        rotated = true;
        const T app = a[sym_index<N>(p, p)], aqq = a[sym_index<N>(q, q)];
        const T theta = (aqq - app) / (T(2) * apq);
        const T t = (theta >= T(0) ? T(1) : T(-1)) / (tabs(theta) + tsqrt(T(1) + theta * theta));
        const T c = T(1) / tsqrt(T(1) + t * t);
        const T s = t * c;
        a[sym_index<N>(p, p)] = app - t * apq;
        a[sym_index<N>(q, q)] = aqq + t * apq;
        a[sym_index<N>(p, q)] = T(0);
#pragma unroll
        for (int r = 0; r < N; ++r) {
          if (r == p || r == q) continue;
          const T arp = a[sym_index<N>(r, p)], arq = a[sym_index<N>(r, q)];
          a[sym_index<N>(r, p)] = c * arp - s * arq;
          a[sym_index<N>(r, q)] = s * arp + c * arq;
        }
#pragma unroll
        for (int r = 0; r < N; ++r) {
          const T vrp = v[r * N + p], vrq = v[r * N + q];
          v[r * N + p] = c * vrp - s * vrq;
          v[r * N + q] = s * vrp + c * vrq;
        }
      }
    }
    if (!rotated) break;
  }
}

// Column k of v (n x n) as a unit vector with the sign rule.
template <typename T, int N>
SL_FN void unit_column(const T (&v)[N * N], int k, T (&x)[N]) {
  T norm2 = T(0), big = T(0), sign = T(1);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T vi = T(0);
#pragma unroll
    for (int j = 0; j < N; ++j) vi = j == k ? v[i * N + j] : vi;  // no dynamic index
    x[i] = vi;
    norm2 += vi * vi;
    if (tabs(vi) > big) {
      big = tabs(vi);
      sign = vi < T(0) ? T(-1) : T(1);
    }
  }
  const T scale = sign / tsqrt(norm2);
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] *= scale;
}

// The unit eigenvector of the least eigenvalue of the packed symmetric a,
// with the sign rule above; NaN if a is not finite.
template <typename T, int N>
SL_FN void smallest_eigvec(const T (&a_in)[N * (N + 1) / 2], T (&x)[N]) {
  T a[N * (N + 1) / 2];
  bool ok = true;
#pragma unroll
  for (int i = 0; i < N * (N + 1) / 2; ++i) {
    a[i] = a_in[i];
    ok = ok && finite(a[i]);
  }
  if (!ok) {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = nan_value<T>();
    return;
  }
  T v[N * N];
  jacobi_eigh<T, N>(a, v);
  int k = 0;
  T least = a[sym_index<N>(0, 0)];
#pragma unroll
  for (int i = 1; i < N; ++i) {
    const T d = a[sym_index<N>(i, i)];
    if (d < least) {
      least = d;
      k = i;
    }
  }
  unit_column<T, N>(v, k, x);
}

// One-sided Jacobi on the n columns (length m) of b (row-major m x n), in
// place; v (n x n) accumulates the rotations.
template <typename T, int M, int N>
SL_FN void one_sided_jacobi(T (&b)[M * N], T (&v)[N * N]) {
#pragma unroll
  for (int i = 0; i < N * N; ++i) v[i] = (i % (N + 1) == 0) ? T(1) : T(0);
  T fro2 = T(0);
#pragma unroll
  for (int i = 0; i < M * N; ++i) fro2 += b[i] * b[i];
  const T floor2 = (Limits<T>::eps * Limits<T>::eps) * fro2;  // rotations keep |b|_F
  for (int sweep = 0; sweep < Limits<T>::sweeps; ++sweep) {
    bool rotated = false;
#pragma unroll
    for (int p = 0; p < N - 1; ++p) {
#pragma unroll
      for (int q = p + 1; q < N; ++q) {
        T alpha = T(0), beta = T(0), gamma = T(0);
#pragma unroll
        for (int i = 0; i < M; ++i) {
          alpha += b[i * N + p] * b[i * N + p];
          beta += b[i * N + q] * b[i * N + q];
          gamma += b[i * N + p] * b[i * N + q];
        }
        if (!(tabs(gamma) > Limits<T>::eps * (tsqrt(alpha) * tsqrt(beta))) || alpha <= floor2 || beta <= floor2)
          continue;
        rotated = true;
        const T zeta = (beta - alpha) / (T(2) * gamma);
        const T t = (zeta >= T(0) ? T(1) : T(-1)) / (tabs(zeta) + tsqrt(T(1) + zeta * zeta));
        const T c = T(1) / tsqrt(T(1) + t * t);
        const T s = t * c;
#pragma unroll
        for (int i = 0; i < M; ++i) {
          const T bp = b[i * N + p], bq = b[i * N + q];
          b[i * N + p] = c * bp - s * bq;
          b[i * N + q] = s * bp + c * bq;
        }
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const T vp = v[i * N + p], vq = v[i * N + q];
          v[i * N + p] = c * vp - s * vq;
          v[i * N + q] = s * vp + c * vq;
        }
      }
    }
    if (!rotated) break;
  }
}

// The unit vector of the least singular value of a (m x n, row-major): the
// smallest eigenvector of a^T a (see the note).
template <typename T, int M, int N>
SL_FN void null_vector(const T (&a)[M * N], T (&x)[N]) {
  T b[M * N];
  bool ok = true;
#pragma unroll
  for (int i = 0; i < M * N; ++i) {
    b[i] = a[i];
    ok = ok && finite(b[i]);
  }
  if (!ok) {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = nan_value<T>();
    return;
  }
  T v[N * N];
  one_sided_jacobi<T, M, N>(b, v);
  int k = 0;
  T least = T(0);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    T n2 = T(0);
#pragma unroll
    for (int i = 0; i < M; ++i) n2 += b[i * N + j] * b[i * N + j];
    if (j == 0 || n2 < least) {
      least = n2;
      k = j;
    }
  }
  unit_column<T, N>(v, k, x);
}

template <typename T>
SL_FN T det3(const T (&a)[9]) {
  return (a[0] * (a[4] * a[8] - a[5] * a[7]) - a[1] * (a[3] * a[8] - a[5] * a[6])) +
         a[2] * (a[3] * a[7] - a[4] * a[6]);
}

template <typename T>
SL_FN void inv3(const T (&a)[9], T (&out)[9]) {
  const T c00 = a[4] * a[8] - a[5] * a[7], c01 = a[5] * a[6] - a[3] * a[8], c02 = a[3] * a[7] - a[4] * a[6];
  const T det = (a[0] * c00 + a[1] * c01) + a[2] * c02;
  out[0] = c00 / det;
  out[1] = (a[2] * a[7] - a[1] * a[8]) / det;
  out[2] = (a[1] * a[5] - a[2] * a[4]) / det;
  out[3] = c01 / det;
  out[4] = (a[0] * a[8] - a[2] * a[6]) / det;
  out[5] = (a[2] * a[3] - a[0] * a[5]) / det;
  out[6] = c02 / det;
  out[7] = (a[1] * a[6] - a[0] * a[7]) / det;
  out[8] = (a[0] * a[4] - a[1] * a[3]) / det;
}

// c = a b (3 x 3).
template <typename T>
SL_FN void mul3(const T (&a)[9], const T (&b)[9], T (&c)[9]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) c[3 * i + j] = (a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j]) + a[3 * i + 2] * b[6 + j];
}

// c = a^T b (3 x 3).
template <typename T>
SL_FN void mul3_tn(const T (&a)[9], const T (&b)[9], T (&c)[9]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) c[3 * i + j] = (a[i] * b[j] + a[3 + i] * b[3 + j]) + a[6 + i] * b[6 + j];
}

// c = a b^T (3 x 3).
template <typename T>
SL_FN void mul3_nt(const T (&a)[9], const T (&b)[9], T (&c)[9]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      c[3 * i + j] = (a[3 * i] * b[3 * j] + a[3 * i + 1] * b[3 * j + 1]) + a[3 * i + 2] * b[3 * j + 2];
}

template <typename T>
SL_FN void hat3(T x, T y, T z, T (&k)[9]) {
  k[0] = T(0); k[1] = -z;   k[2] = y;
  k[3] = z;    k[4] = T(0); k[5] = -x;
  k[6] = -y;   k[7] = x;    k[8] = T(0);
}

// a = U diag(s) V^T (see the note). U and V row-major, columns the vectors.
template <typename T>
SL_FN void svd3(const T (&a)[9], T (&u)[9], T (&s)[3], T (&v)[9]) {
  bool ok = true;
#pragma unroll
  for (int i = 0; i < 9; ++i) ok = ok && finite(a[i]);
  if (!ok) {
#pragma unroll
    for (int i = 0; i < 9; ++i) u[i] = v[i] = nan_value<T>();
    s[0] = s[1] = s[2] = nan_value<T>();
    return;
  }
  T b[9], w[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) b[i] = a[i];
  one_sided_jacobi<T, 3, 3>(b, w);
  T n[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) n[c] = tsqrt((b[c] * b[c] + b[3 + c] * b[3 + c]) + b[6 + c] * b[6 + c]);
  // Order the singular values descending, ties in index order.
  int o0 = 0, o1 = 1, o2 = 2;
  T m0 = n[0], m1 = n[1], m2 = n[2];
  if (m1 > m0) { T tm = m0; m0 = m1; m1 = tm; int to = o0; o0 = o1; o1 = to; }
  if (m2 > m1) { T tm = m1; m1 = m2; m2 = tm; int to = o1; o1 = o2; o2 = to; }
  if (m1 > m0) { T tm = m0; m0 = m1; m1 = tm; int to = o0; o0 = o1; o1 = to; }
  const int order[3] = {o0, o1, o2};
  s[0] = m0;
  s[1] = m1;
  s[2] = m2;
  T col[3][3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int from = order[c];
      v[3 * r + c] = from == 0 ? w[3 * r] : (from == 1 ? w[3 * r + 1] : w[3 * r + 2]);
      col[c][r] = from == 0 ? b[3 * r] : (from == 1 ? b[3 * r + 1] : b[3 * r + 2]);
    }
  T u1[3], u2[3], u3[3];
  if (s[0] > T(0)) {
#pragma unroll
    for (int r = 0; r < 3; ++r) u1[r] = col[0][r] / s[0];
  } else {
    u1[0] = T(1); u1[1] = T(0); u1[2] = T(0);
  }
  const T d = (u1[0] * col[1][0] + u1[1] * col[1][1]) + u1[2] * col[1][2];
#pragma unroll
  for (int r = 0; r < 3; ++r) u2[r] = col[1][r] - d * u1[r];
  T n2 = tsqrt((u2[0] * u2[0] + u2[1] * u2[1]) + u2[2] * u2[2]);
  if (!(n2 > T(0))) {
    // The next unit axis, orthogonalised against u1.
    const int axis = tabs(u1[1]) < T(0.9) ? 1 : 2;
#pragma unroll
    for (int r = 0; r < 3; ++r) u2[r] = (r == axis ? T(1) : T(0)) - u1[axis] * u1[r];
    n2 = tsqrt((u2[0] * u2[0] + u2[1] * u2[1]) + u2[2] * u2[2]);
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) u2[r] /= n2;
  u3[0] = u1[1] * u2[2] - u1[2] * u2[1];
  u3[1] = u1[2] * u2[0] - u1[0] * u2[2];
  u3[2] = u1[0] * u2[1] - u1[1] * u2[0];
  const T s3 = (u3[0] * col[2][0] + u3[1] * col[2][1]) + u3[2] * col[2][2];
  if (s3 < T(0)) {
#pragma unroll
    for (int r = 0; r < 3; ++r) u3[r] = -u3[r];
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    u[3 * r] = u1[r];
    u[3 * r + 1] = u2[r];
    u[3 * r + 2] = u3[r];
  }
}

// geometry/so3.py exp: I + a K + b K^2.
template <typename T>
SL_FN void so3_exp(const T (&rv)[3], T (&rot)[9]) {
  const T th2 = (rv[0] * rv[0] + rv[1] * rv[1]) + rv[2] * rv[2];
  const bool small = th2 < T(1e-12);
  const T safe = small ? T(1) : th2;
  const T st = tsqrt(safe);
  const T a = small ? T(1) - th2 / T(6) : tsin(st) / st;
  const T b = small ? T(0.5) - th2 / T(24) : (T(1) - tcos(st)) / safe;
  T k[9], kk[9];
  hat3(rv[0], rv[1], rv[2], k);
  mul3(k, k, kk);
#pragma unroll
  for (int e = 0; e < 9; ++e) rot[e] = ((e % 4 == 0 ? T(1) : T(0)) + a * k[e]) + b * kk[e];
}

// geometry/so3.py log, branch for branch.
template <typename T>
SL_FN void so3_log(const T (&r)[9], T (&out)[3]) {
  const T trace = (r[0] + r[4]) + r[8];
  T cos_t = (trace - T(1)) / T(2);
  cos_t = cos_t < T(-1) ? T(-1) : (cos_t > T(1) ? T(1) : cos_t);
  const T skew[3] = {(r[7] - r[5]) * T(0.5), (r[2] - r[6]) * T(0.5), (r[3] - r[1]) * T(0.5)};
  const T sin_sq = (skew[0] * skew[0] + skew[1] * skew[1]) + skew[2] * skew[2];
  const bool sin_zero = sin_sq < T(1e-12);
  const bool small = sin_zero && cos_t > T(0);
  const T sin_norm = tsqrt(sin_zero ? T(1) : sin_sq);
  const T theta = tatan2(sin_zero ? T(0) : sin_norm, cos_t);
  const bool near_pi = theta > T(2);
  const T sin_theta = tsin((small || near_pi) ? T(1) : theta);
  const T ratio = theta / sin_theta;
  const T grow = T(1) + sin_sq / T(6);
  const T diag[3] = {r[0], r[4], r[8]};
  const T omc = near_pi ? T(1) - cos_t : T(1);
  T axis[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    T sq = (diag[i] - cos_t) / omc;
    sq = sq < T(0) ? T(0) : (sq > T(1) ? T(1) : sq);
    const bool ok = near_pi && sq > T(1e-12);
    axis[i] = ok ? tsqrt(sq) : T(0);
  }
  const T sym01 = r[1] + r[3], sym02 = r[2] + r[6], sym12 = r[5] + r[7];
  int major = 0;
  if (axis[1] > axis[major]) major = 1;
  if (axis[2] > axis[major]) major = 2;
  const T g01 = sym01 < T(0) ? T(-1) : T(1), g02 = sym02 < T(0) ? T(-1) : T(1), g12 = sym12 < T(0) ? T(-1) : T(1);
  T pa[3];
  pa[0] = major == 0 ? axis[0] : (major == 1 ? axis[0] * g01 : axis[0] * g02);
  pa[1] = major == 0 ? axis[1] * g01 : (major == 1 ? axis[1] : axis[1] * g12);
  pa[2] = major == 0 ? axis[2] * g02 : (major == 1 ? axis[2] * g12 : axis[2]);
  const T align = (pa[0] * skew[0] + pa[1] * skew[1]) + pa[2] * skew[2];
  const T ga = align < T(0) ? T(-1) : T(1);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const T pi_branch = (pa[i] * ga) * theta;
    const T rest = small ? skew[i] * grow : skew[i] * ratio;
    out[i] = near_pi ? pi_branch : rest;
  }
}

#undef SL_FN

}  // namespace sl
