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
// three-value block reduction; then up to max_iters iterations of (window
// gather, two-value block reduction, 2x2 solve, broadcast). The latency of
// that chain (loads served by L1/L2 and block barriers) is the time.
//
// Design: one block of 256 threads per point (the scan's 128 points fill 128
// of the 132 SMs in one wave). A level stages the (win+3)^2 samples under the
// template's (win+2)^2 bilinear patch in shared memory, and the patch beside
// them. Each thread owns fixed window pixels (at most four, for win <= 31)
// and keeps their template value and central-difference gradients in
// registers across the level's iterations. An iteration samples the current
// level bilinearly straight from global memory (the levels are small and
// stay in L1/L2), reduces (b0, b1) with warp shuffles and one pass through
// shared memory, and thread 0 solves, tests the freeze and broadcasts the
// displacement. wgmma and TMA do not apply: there is no matrix product, and
// the windows move with the data.
//
// Early exit: once a point freezes (|delta|^2 < eps^2) it keeps d, so every
// later iteration gathers the same window, reduces it in the same fixed
// order, gets the same delta and freezes again. Leaving the loop therefore
// gives bit for bit what running all max_iters iterations gives; a level
// whose G is singular (det <= 1e-7) freezes before its first iteration.
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

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWin = 31;
constexpr int kMaxPix = (kMaxWin * kMaxWin + kThreads - 1) / kThreads;  // window pixels per thread
constexpr int kMaxLevels = 8;
constexpr int kMaxGrid = (kMaxWin + 3) * (kMaxWin + 3);
constexpr int kMaxPatch = (kMaxWin + 2) * (kMaxWin + 2);

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

// Sums v[k] over the block into thread 0's v[k], in a fixed order. Every
// thread must call it; `scratch` is free again after the caller's next
// barrier.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float (&scratch)[3][kWarps]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float x = v[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) scratch[k][warp] = x;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float x = scratch[k][0];
#pragma unroll
      for (int i = 1; i < kWarps; ++i) x += scratch[k][i];
      v[k] = x;
    }
  }
}

__global__ void __launch_bounds__(kThreads) lk_track_kernel(
    Pyramids pyr, int levels, const float* __restrict__ points, const float* __restrict__ init_flow,
    const uint8_t* __restrict__ mask, int win, int max_iters, float eps2, float* __restrict__ out_points,
    uint8_t* __restrict__ out_status, float* __restrict__ out_error, int* __restrict__ out_iters,
    float* __restrict__ out_path) {
  __shared__ float grid[kMaxGrid];
  __shared__ float patch[kMaxPatch];
  __shared__ float scratch[3][kWarps];
  __shared__ float s_d[2], s_inv[3];
  __shared__ int s_ok, s_done;

  const int n = blockIdx.x, tid = threadIdx.x;
  const int npix = win * win, ps = win + 2, gs = win + 3;
  const float px = points[2 * n], py = points[2 * n + 1];
  if (tid == 0) {
    const float coarse = (float)(1 << (levels - 1));
    s_d[0] = init_flow ? init_flow[2 * n] / coarse : 0.0f;
    s_d[1] = init_flow ? init_flow[2 * n + 1] / coarse : 0.0f;
  }
  bool ok_all = mask[n] != 0;
  float tm[kMaxPix], gx[kMaxPix], gy[kMaxPix];

  for (int lvl = levels - 1; lvl >= 0; --lvl) {
    const int h = pyr.h[lvl], w = pyr.w[lvl];
    const float* __restrict__ prev = pyr.prev[lvl];
    const float* __restrict__ curr = pyr.curr[lvl];
    const float lx = px / (float)(1 << lvl), ly = py / (float)(1 << lvl);

    // The template patch and its gradients, fixed for the level.
    const Window t = place(lx, ly, win + 3, ps, h, w);
    __syncthreads();  // the previous level is done with grid, patch and s_*
    for (int k = tid; k < gs * gs; k += kThreads) grid[k] = pixel(prev, h, w, t.y0 + k / gs, t.x0 + k % gs);
    __syncthreads();
    for (int k = tid; k < ps * ps; k += kThreads) {
      const float* g = grid + (k / ps) * gs + k % ps;
      patch[k] = blend(g[0], g[1], g[gs], g[gs + 1], t.fx, t.fy);
    }
    __syncthreads();
    float gsum[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int q = 0; q < kMaxPix; ++q) {
      const int p = tid + q * kThreads;
      tm[q] = gx[q] = gy[q] = 0.0f;
      if (p < npix) {
        const float* c = patch + (p / win + 1) * ps + p % win + 1;
        gx[q] = (c[1] - c[-1]) * 0.5f;
        gy[q] = (c[ps] - c[-ps]) * 0.5f;
        tm[q] = c[0];
      }
      gsum[0] += gx[q] * gx[q];
      gsum[1] += gx[q] * gy[q];
      gsum[2] += gy[q] * gy[q];
    }
    block_sum(gsum, scratch);
    if (tid == 0) {
      const float det = gsum[0] * gsum[2] - gsum[1] * gsum[1];
      const bool ok = det > 1e-7f;
      const float den = ok ? det : 1.0f;
      s_inv[0] = gsum[2] / den;
      s_inv[1] = -gsum[1] / den;
      s_inv[2] = gsum[0] / den;
      s_ok = ok;
    }
    __syncthreads();
    const bool ok = s_ok;
    ok_all = ok_all && ok;

    int iters = 0;
    if (ok) {
      for (int it = 0; it < max_iters; ++it) {
        const float dx = s_d[0], dy = s_d[1];
        const Window c = place(lx + dx, ly + dy, win + 1, win, h, w);
        float b[2] = {0.0f, 0.0f};
#pragma unroll
        for (int q = 0; q < kMaxPix; ++q) {
          const int p = tid + q * kThreads;
          if (p < npix) {
            const float diff = tm[q] - sample(curr, h, w, c, p / win, p % win);
            b[0] += diff * gx[q];
            b[1] += diff * gy[q];
          }
        }
        block_sum(b, scratch);
        ++iters;
        if (tid == 0) {
          if (out_path) {
            float* q = out_path + ((size_t)(n * levels + lvl) * max_iters + it) * 2;
            q[0] = dx;
            q[1] = dy;
          }
          const float d0 = s_inv[0] * b[0] + s_inv[1] * b[1];
          const float d1 = s_inv[1] * b[0] + s_inv[2] * b[1];
          const bool small = d0 * d0 + d1 * d1 < eps2;
          if (!small) {
            s_d[0] = dx + d0;
            s_d[1] = dy + d1;
          }
          s_done = small;
        }
        __syncthreads();
        if (s_done) break;
      }
    }
    if (tid == 0) {
      if (out_iters) out_iters[n * levels + lvl] = iters;
      if (lvl > 0) {
        s_d[0] *= 2.0f;
        s_d[1] *= 2.0f;
      }
    }
  }
  __syncthreads();

  // Status and the mean absolute window error at full resolution.
  const int h0 = pyr.h[0], w0 = pyr.w[0];
  const float nx = px + s_d[0], ny = py + s_d[1];
  const bool status = ok_all && nx >= 0.0f && nx < (float)w0 && ny >= 0.0f && ny < (float)h0;
  float e[1] = {0.0f};
  if (status) {
    const Window a = place(px, py, win + 1, win, h0, w0);
    const Window b = place(nx, ny, win + 1, win, h0, w0);
#pragma unroll
    for (int q = 0; q < kMaxPix; ++q) {
      const int p = tid + q * kThreads;
      if (p < npix) {
        const int i = p / win, j = p % win;
        e[0] += fabsf(sample(pyr.prev[0], h0, w0, a, i, j) - sample(pyr.curr[0], h0, w0, b, i, j));
      }
    }
  }
  block_sum(e, scratch);
  if (tid == 0) {
    out_points[2 * n] = nx;
    out_points[2 * n + 1] = ny;
    out_status[n] = status;
    out_error[n] = status ? e[0] / (float)npix : nanf("");
  }
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
  lk_track_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pyr, levels, static_cast<const float*>(points), static_cast<const float*>(init_flow),
      static_cast<const uint8_t*>(mask), win, max_iters, eps2, static_cast<float*>(out_points),
      static_cast<uint8_t*>(out_status), static_cast<float*>(out_error), static_cast<int*>(out_iters),
      static_cast<float*>(out_path));
  return (int)cudaGetLastError();
}
