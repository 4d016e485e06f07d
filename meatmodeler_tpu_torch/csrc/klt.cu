// Pyramidal Lucas-Kanade for Hopper (sm_90a): every point of one call,
// every pyramid level and iteration, the final window error and the status,
// in one launch.
//
// Replaces the XLA fusion of meatmodeler_tpu/ops/klt.py:131 `lucas_kanade`
// (a jit of a vmap over points whose per-level iterations are a
// fori_loop). It is not a Pallas kernel: on the TPU, XLA compiles the whole
// device keyframe scan into one program per chunk. The port's plain version,
// ops/klt.py `lucas_kanade_reference`, issues some fifteen small launches
// per iteration, ~2500 for one frame of the scan.
//
// What bounds it: neither bytes nor operations. One call of the scan reads a
// few hundred KB of pyramid and does some ten MFLOP (well under a
// microsecond at the card's memory or float32 rate). Each point is a chain of
// dependent steps: per level, one template load, one bilinear patch and one
// three-value reduction; then up to max_iters iterations of (window gather,
// two-value reduction, 2x2 solve). The latency of that chain is the time.
// The first design (one 256-thread block per point) spent it on two block
// barriers an iteration and three more a level, on thread 0 alone summing
// the warps' partials and solving while the block waited, on clamping every
// window read, and on template loads that each waited for the last.
//
// Design: one 256-thread block per point, as before. On the card a point
// tracked by one warp (each lane owning 8-31 window pixels, warp shuffles
// only, no block barrier) was slower than the first design (50.9 against
// 30.7 us at the scan's seeded call on an H100): a lone warp on its
// scheduler issues an iteration's ~400 instructions at well under one a
// cycle, while eight warps hide each other's latency. So the point keeps
// the block's threads (each owns pixels tid, tid + 256, ... and keeps their
// template value and gradients in registers for the level) and loses the
// waiting:
//  - one barrier an iteration: each warp's sum goes to one of two
//    alternating halves of a shared array, and every thread adds the
//    warps' sums itself, solves the 2x2 system and takes the freeze
//    decision; nothing is broadcast, and no thread works while others wait;
//  - a window wholly inside the level is read without clamping, from a
//    base pointer and per-pixel offsets fixed for the level, and every
//    pixel's loads issue before the first blend;
//  - the template grid and patch are staged in one batch a thread (every
//    load issued before the first store), not a load at a time.
// The sums keep the first design's order (each thread its pixels in
// order, each warp's shuffle tree into lane 0, the warps in order), so the
// results are those of the first design bit for bit. Staging the level's
// neighbourhood in shared memory (cp.async or a TMA tile) is not done: the
// windows' reads hit L1, and nothing on the card has shown that it would
// pay. wgmma and TMA do not apply otherwise: there is no matrix product,
// and the windows move with the data.
//
// Early exit: once a point freezes (|delta|^2 < eps^2) it keeps d, so every
// later iteration gathers the same window, reduces it in the same fixed
// order, gets the same delta and freezes again. Leaving the loop
// therefore gives bit for bit what running all max_iters iterations gives; a level whose G is
// singular (det <= 1e-7) freezes before its first iteration.
//
// Semantics are those of the plain version. A window of side s around
// (cx, cy), read from the image edge-padded by p, starts at
// floor((c - (s-1)/2) + p), clamped into the padded image like
// dynamic_slice's start, while the bilinear fraction keeps the unclamped
// value. The kernel reads the unpadded level with clamped indices instead of
// a padded copy. The start is clamped in float before the int conversion:
// NaN goes to 0 and huge coordinates to the far edge, as the reference's
// saturating conversion does. The library is built with -fmad=false, so
// every product and sum rounds on its own as torch's elementwise ops do;
// only the order of the window sums differs from the plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a block per point
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWin = 31;
constexpr int kMaxLevels = 8;
constexpr int kMaxGrid = (kMaxWin + 3) * (kMaxWin + 3);
constexpr int kMaxPatch = (kMaxWin + 2) * (kMaxWin + 2);
constexpr int kBatch = (kMaxGrid + kThreads - 1) / kThreads;  // staged elements a thread, loads issued together

struct Pyramids {
  const float* prev[kMaxLevels];
  const float* curr[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
};

// Top-left corner (unpadded coordinates) and bilinear fraction of a
// size x size window around (cx, cy) read from the image padded by `pad`.
struct Window {
  int x0, y0;
  float fx, fy;
};

__device__ __forceinline__ Window place(float cx, float cy, int pad, int size, int h, int w) {
  const float half = 0.5f * (float)(size - 1);
  const float tlx = (cx - half) + (float)pad;
  const float tly = (cy - half) + (float)pad;
  const float t0x = floorf(tlx), t0y = floorf(tly);
  Window s;
  s.fx = tlx - t0x;
  s.fy = tly - t0y;
  s.x0 = (int)fminf(fmaxf(t0x, 0.0f), (float)(w + 2 * pad - size - 1)) - pad;
  s.y0 = (int)fminf(fmaxf(t0y, 0.0f), (float)(h + 2 * pad - size - 1)) - pad;
  return s;
}

// A pixel of the edge-padded image.
__device__ __forceinline__ float pixel(const float* __restrict__ img, int h, int w, int y, int x) {
  y = min(max(y, 0), h - 1);
  x = min(max(x, 0), w - 1);
  return __ldg(img + (size_t)y * w + x);
}

// The plain version's blend, term for term and in its order.
__device__ __forceinline__ float blend(float b00, float b01, float b10, float b11, float fx, float fy) {
  const float gx = 1.0f - fx, gy = 1.0f - fy;
  return b00 * gy * gx + b01 * gy * fx + b10 * fy * gx + b11 * fy * fx;
}

__device__ __forceinline__ float sample(const float* __restrict__ img, int h, int w, const Window& s, int i, int j) {
  const int y = s.y0 + i, x = s.x0 + j;
  return blend(pixel(img, h, w, y, x), pixel(img, h, w, y, x + 1), pixel(img, h, w, y + 1, x),
               pixel(img, h, w, y + 1, x + 1), s.fx, s.fy);
}

// k / m for 0 <= k < 34^2 and 0 < m <= 34, given inv_m = 1 / m in float:
// (k + 0.5) / m lies at least 0.5 / m from an integer, far beyond float's
// rounding there.
__device__ __forceinline__ int row_of(int k, float inv_m) { return (int)(((float)k + 0.5f) * inv_m); }

// The bilinear sample at (i, j) of a window lying wholly inside the image
// (no clamping): `p` points at the window's pixel (i, j), `w` is the row
// pitch.
__device__ __forceinline__ float sample_inside(const float* __restrict__ p, int w, float fx, float fy) {
  return blend(__ldg(p), __ldg(p + 1), __ldg(p + w), __ldg(p + w + 1), fx, fy);
}

// Whether a size x size window's bilinear reads (size + 1 pixels a side
// from its corner) lie inside an h x w image.
__device__ __forceinline__ bool inside(const Window& s, int size, int h, int w) {
  return s.x0 >= 0 && s.y0 >= 0 && s.x0 + size < w && s.y0 + size < h;
}

// The block's sum of v[k], the same bits in every thread: each warp's
// shuffle tree into its lane 0, then the warps' sums in warp order (the
// first design's order, which thread 0 alone took). The partials go to
// `part[half]`, whose two halves alternate, so one barrier a sum suffices:
// a half is written again only after the next sum's barrier, which every
// thread passes after reading it.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float (*part)[K][kWarps], int& half) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float x = v[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(kFull, x, off);
    if (lane == 0) part[half][k][warp] = x;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float x = part[half][k][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) x += part[half][k][w];
    v[k] = x;
  }
  half ^= 1;
}

template <int kPix>
__global__ void __launch_bounds__(kThreads) lk_track_kernel(
    Pyramids pyr, int levels, const float* __restrict__ points, const float* __restrict__ init_flow,
    const uint8_t* __restrict__ mask, int win, int max_iters, float eps2, float* __restrict__ out_points,
    uint8_t* __restrict__ out_status, float* __restrict__ out_error, int* __restrict__ out_iters,
    float* __restrict__ out_path) {
  __shared__ float grid[kMaxGrid];
  __shared__ float patch[kMaxPatch];
  __shared__ float part3[2][3][kWarps], part2[2][2][kWarps], part1[2][1][kWarps];
  const int n = blockIdx.x, tid = threadIdx.x;
  const int npix = win * win, ps = win + 2, gs = win + 3;
  const float inv_gs = 1.0f / (float)gs, inv_ps = 1.0f / (float)ps;
  int half3 = 0, half2 = 0, half1 = 0;

  // This thread's window pixels, (row, column) as row << 8 | column; past
  // the window, pixel (0, 0), read but not summed.
  int at[kPix];
  bool in_win[kPix];
#pragma unroll
  for (int q = 0; q < kPix; ++q) {
    const int p = tid + kThreads * q;
    in_win[q] = p < npix;
    at[q] = in_win[q] ? ((p / win) << 8) | (p % win) : 0;
  }

  const float px = points[2 * n], py = points[2 * n + 1];
  const float coarse = (float)(1 << (levels - 1));
  float dx = init_flow ? init_flow[2 * n] / coarse : 0.0f;
  float dy = init_flow ? init_flow[2 * n + 1] / coarse : 0.0f;
  bool ok_all = mask[n] != 0;
  float tm[kPix], gx[kPix], gy[kPix];
  int off[kPix];  // each pixel's offset in the level, from the window's corner

  for (int lvl = levels - 1; lvl >= 0; --lvl) {
    const int h = pyr.h[lvl], w = pyr.w[lvl];
    const float* __restrict__ prev = pyr.prev[lvl];
    const float* __restrict__ curr = pyr.curr[lvl];
    const float lx = px / (float)(1 << lvl), ly = py / (float)(1 << lvl);
#pragma unroll
    for (int q = 0; q < kPix; ++q) off[q] = (at[q] >> 8) * w + (at[q] & 0xFF);

    // The template patch and its gradients, fixed for the level: the
    // grid's and then the patch's kBatch elements a thread, every load
    // issued before the first store.
    const Window t = place(lx, ly, win + 3, ps, h, w);
    __syncthreads();  // the previous level is done with grid and patch
    {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int k = min(kThreads * u + tid, gs * gs - 1), r = row_of(k, inv_gs);
        v[u] = pixel(prev, h, w, t.y0 + r, t.x0 + (k - r * gs));
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (kThreads * u + tid < gs * gs) grid[kThreads * u + tid] = v[u];
      }
    }
    __syncthreads();
    {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int k = min(kThreads * u + tid, ps * ps - 1), r = row_of(k, inv_ps);
        const float* g = grid + r * gs + (k - r * ps);
        v[u] = blend(g[0], g[1], g[gs], g[gs + 1], t.fx, t.fy);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (kThreads * u + tid < ps * ps) patch[kThreads * u + tid] = v[u];
      }
    }
    __syncthreads();
    float gsum[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int q = 0; q < kPix; ++q) {
      tm[q] = gx[q] = gy[q] = 0.0f;
      if (in_win[q]) {
        const float* c = patch + ((at[q] >> 8) + 1) * ps + (at[q] & 0xFF) + 1;
        gx[q] = (c[1] - c[-1]) * 0.5f;
        gy[q] = (c[ps] - c[-ps]) * 0.5f;
        tm[q] = c[0];
        gsum[0] += gx[q] * gx[q];
        gsum[1] += gx[q] * gy[q];
        gsum[2] += gy[q] * gy[q];
      }
    }
    block_sum(gsum, part3, half3);
    const float det = gsum[0] * gsum[2] - gsum[1] * gsum[1];
    const bool ok = det > 1e-7f;
    const float den = ok ? det : 1.0f;
    const float inv0 = gsum[2] / den, inv1 = -gsum[1] / den, inv2 = gsum[0] / den;
    ok_all = ok_all && ok;

    int iters = 0;
    if (ok) {
      for (int it = 0; it < max_iters; ++it) {
        const Window c = place(lx + dx, ly + dy, win + 1, win, h, w);
        // Every pixel's sample first (their loads issue together), then
        // the sums in pixel order.
        float v[kPix];
        if (inside(c, win, h, w)) {
          const float* base = curr + (size_t)c.y0 * w + c.x0;
#pragma unroll
          for (int q = 0; q < kPix; ++q) v[q] = sample_inside(base + off[q], w, c.fx, c.fy);
        } else {
#pragma unroll
          for (int q = 0; q < kPix; ++q) v[q] = sample(curr, h, w, c, at[q] >> 8, at[q] & 0xFF);
        }
        float b[2] = {0.0f, 0.0f};
#pragma unroll
        for (int q = 0; q < kPix; ++q) {
          if (in_win[q]) {
            const float diff = tm[q] - v[q];
            b[0] += diff * gx[q];
            b[1] += diff * gy[q];
          }
        }
        block_sum(b, part2, half2);
        ++iters;
        if (out_path && tid == 0) {
          float* q = out_path + ((size_t)(n * levels + lvl) * max_iters + it) * 2;
          q[0] = dx;
          q[1] = dy;
        }
        const float d0 = inv0 * b[0] + inv1 * b[1];
        const float d1 = inv1 * b[0] + inv2 * b[1];
        if (d0 * d0 + d1 * d1 < eps2) break;  // the same decision in every thread
        dx = dx + d0;
        dy = dy + d1;
      }
    }
    if (out_iters && tid == 0) out_iters[n * levels + lvl] = iters;
    if (lvl > 0) {
      dx *= 2.0f;
      dy *= 2.0f;
    }
  }

  // Status and the mean absolute window error at full resolution.
  const int h0 = pyr.h[0], w0 = pyr.w[0];
  const float nx = px + dx, ny = py + dy;
  const bool status = ok_all && nx >= 0.0f && nx < (float)w0 && ny >= 0.0f && ny < (float)h0;
  float e[1] = {0.0f};
  if (status) {
    const Window a = place(px, py, win + 1, win, h0, w0);
    const Window b = place(nx, ny, win + 1, win, h0, w0);
    float va[kPix], vb[kPix];
#pragma unroll
    for (int q = 0; q < kPix; ++q) {
      va[q] = sample(pyr.prev[0], h0, w0, a, at[q] >> 8, at[q] & 0xFF);
      vb[q] = sample(pyr.curr[0], h0, w0, b, at[q] >> 8, at[q] & 0xFF);
    }
#pragma unroll
    for (int q = 0; q < kPix; ++q) {
      if (in_win[q]) e[0] += fabsf(va[q] - vb[q]);
    }
    block_sum(e, part1, half1);  // status is the block's: every thread is here or none
  }
  if (tid == 0) {
    out_points[2 * n] = nx;
    out_points[2 * n + 1] = ny;
    out_status[n] = status;
    out_error[n] = status ? e[0] / (float)npix : nanf("");
  }
}

template <int kPix>
cudaError_t launch(const Pyramids& pyr, int levels, const float* points, const float* init_flow, const uint8_t* mask,
                   int n, int win, int max_iters, float eps2, float* out_points, uint8_t* out_status,
                   float* out_error, int* out_iters, float* out_path, cudaStream_t stream) {
  lk_track_kernel<kPix><<<n, kThreads, 0, stream>>>(pyr, levels, points, init_flow, mask, win, max_iters, eps2,
                                                    out_points, out_status, out_error, out_iters, out_path);
  return cudaGetLastError();
}

}  // namespace

// Tracks n points through `levels` pyramid levels (prev[l], curr[l]: h[l] x
// w[l] float32, level 0 full resolution). init_flow (n x 2), out_iters
// (n x levels, the iterations each point ran at each level) and out_path
// (n x levels x max_iters x 2, the displacement each iteration sampled the
// current level at; entries past out_iters are left unwritten) may be null.
// Returns the launch's cudaError_t.
extern "C" int lk_track(const void* const* prev, const void* const* curr, const int* h, const int* w, int levels,
                        const void* points, const void* init_flow, const void* mask, int n, int win, int max_iters,
                        float eps2, void* out_points, void* out_status, void* out_error, void* out_iters,
                        void* out_path, void* stream) {
  if (levels < 1 || levels > kMaxLevels || win < 1 || win > kMaxWin || n < 1 || max_iters < 0) {
    return (int)cudaErrorInvalidValue;
  }
  Pyramids pyr{};
  for (int l = 0; l < levels; ++l) {
    pyr.prev[l] = static_cast<const float*>(prev[l]);
    pyr.curr[l] = static_cast<const float*>(curr[l]);
    pyr.h[l] = h[l];
    pyr.w[l] = w[l];
  }
  const auto* pts = static_cast<const float*>(points);
  const auto* flow = static_cast<const float*>(init_flow);
  const auto* m = static_cast<const uint8_t*>(mask);
  auto* op = static_cast<float*>(out_points);
  auto* os = static_cast<uint8_t*>(out_status);
  auto* oe = static_cast<float*>(out_error);
  auto* oi = static_cast<int*>(out_iters);
  auto* opath = static_cast<float*>(out_path);
  auto s = static_cast<cudaStream_t>(stream);
  // Window pixels a thread: 1 up to win 16, 2 up to win 22, 4 up to 31.
  const int pix = (win * win + kThreads - 1) / kThreads;
  const cudaError_t err =
      pix <= 1   ? launch<1>(pyr, levels, pts, flow, m, n, win, max_iters, eps2, op, os, oe, oi, opath, s)
      : pix <= 2 ? launch<2>(pyr, levels, pts, flow, m, n, win, max_iters, eps2, op, os, oe, oi, opath, s)
                 : launch<4>(pyr, levels, pts, flow, m, n, win, max_iters, eps2, op, os, oe, oi, opath, s);
  return (int)err;
}
