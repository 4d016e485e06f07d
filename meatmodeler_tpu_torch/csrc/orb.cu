// ORB on the card: three hand-written CUDA kernels for Hopper (sm_90a) that
// serve one pyramid level of a whole (B, H, W) keyframe stack each.
//
// Replaces no Pallas kernel: meatmodeler_tpu/ops/orb.py:232
// detect_and_compute is XLA (FAST, Harris, NMS, top-k, orientation and the
// BRIEF bin-weight matmul). On the card ops/orb.py ran it as eager PyTorch,
// with a Python loop over keyframes for the orientation and the
// description and host-built tables uploaded at every level; these kernels
// take its place. The selection between them (a stable sort of the masked
// responses) stays in PyTorch, as ops/orb.py::_select.
//
//   level_build_kernel  <- _gauss7 (the blur the descriptor samples) and
//                          _resize (the next level's antialiased downscale)
//   response_kernel     <- fast_score, features.harris_response, the 3x3
//                          NMS (max_pool's -inf padding) and the margin
//   describe_kernel     <- _orientation and _describe, every (keyframe,
//                          keypoint) of the level in one launch
//
// What bounds them: bytes. A level-0 stack of 22 x 540 x 960 float32 is
// 46 MB; each kernel reads its level once (the response re-reads the
// halos of its tiles from shared memory, the descriptor 1.7 K pixels a
// keypoint) and writes one image or the keypoints' 257 bytes. The design
// keeps each pixel's work in shared memory tiles (32 x 16 outputs a block)
// so no intermediate (ring stack, gradients, box sums) reaches device
// memory.
//
// Arithmetic, against the plain path on the same input:
// - the blur is the plain path's bit for bit: the same multiplies and adds
//   in _gauss7's order, unfused (__fmul_rn / __fadd_rn), at replicate-
//   clamped coordinates;
// - the downscale takes the banded taps of _resize_weights (at most
//   kMaxTaps per axis; 3 at 1/1.2), rows first as the einsum contracts, so
//   it differs from cuBLAS's float32 sums only in rounding;
// - FAST compares in float32 against p + t and p - t and takes the plain
//   path's arc windows (starts 0..14 of the doubled ring) exactly; the
//   Harris sums (Sobel, 7 x 7 box, row-major) differ from cuDNN's only in
//   rounding;
// - the orientation's moments are the plain path's float32 products summed
//   in double, then atan2f; the bin is round-half-even of angle / bin
//   width, as torch.round; the BRIEF samples are exact bf16 products summed
//   ((t0 + t1) + t2) + t3, as the plain path sums them.
//
// Plain C interface, loaded with ctypes as part of the CLAHE library
// (ops/clahe_cuda.py); every entry returns cudaGetLastError() after its
// launch. Launches go on the caller's stream, never synchronise, and
// allocate nothing.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileW = 32;  // output tile of the blur and of the response
constexpr int kTileH = 16;
constexpr int kMaxTaps = 8;  // downscale taps per axis (scale factors up to 4)
constexpr int kHalf = 15;    // orientation patch 31 x 31, circle of radius 15
constexpr int kPatch = 2 * kHalf + 1;
constexpr int kWinHalf = 20;  // the descriptor's window: 41 x 41 around the keypoint
constexpr int kWin = 2 * kWinHalf + 1;
constexpr int kBits = 256;
constexpr int kBins = 30;
constexpr int kSamples = 2 * kBits;

struct Gauss7 {
  float g[7];
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// float32 -> bfloat16 -> float32, round half to even (c10::BFloat16's rule).
__device__ __forceinline__ float bf16_round(float x) {
  if (x != x) return x;
  uint32_t u = __float_as_uint(x);
  u = (u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u;
  return __uint_as_float(u);
}

// ---------------------------------------------------------------------------
// Level build: blocks [0, blur_blocks) blur 32 x 16 tiles of the level;
// the rest downscale kThreads pixels of the next level each.

__device__ void blur_tile(const float* __restrict__ img, float* __restrict__ blur, int H, int W, int tiles_x,
                          int tiles_y, int tile, const Gauss7& g) {
  __shared__ float s_in[kTileH + 6][kTileW + 6];
  __shared__ float s_v[kTileH][kTileW + 6];
  const int per_image = tiles_x * tiles_y;
  const int b = tile / per_image, t = tile % per_image;
  const int y0 = (t / tiles_x) * kTileH, x0 = (t % tiles_x) * kTileW;
  const float* src = img + (size_t)b * H * W;
  for (int i = threadIdx.x; i < (kTileH + 6) * (kTileW + 6); i += kThreads) {
    const int r = i / (kTileW + 6), c = i % (kTileW + 6);
    s_in[r][c] = src[(size_t)clampi(y0 - 3 + r, 0, H - 1) * W + clampi(x0 - 3 + c, 0, W - 1)];
  }
  __syncthreads();
  // Rows first (at every column of the halo: the columns' pass pads the
  // rows' result by replicating it, which is the rows' pass at the clamped
  // column), each sum in _gauss7's order.
  for (int i = threadIdx.x; i < kTileH * (kTileW + 6); i += kThreads) {
    const int r = i / (kTileW + 6), c = i % (kTileW + 6);
    float acc = __fmul_rn(g.g[0], s_in[r][c]);
    for (int k = 1; k < 7; ++k) acc = __fadd_rn(acc, __fmul_rn(g.g[k], s_in[r + k][c]));
    s_v[r][c] = acc;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTileH * kTileW; i += kThreads) {
    const int r = i / kTileW, c = i % kTileW;
    const int y = y0 + r, x = x0 + c;
    if (y >= H || x >= W) continue;
    float acc = __fmul_rn(g.g[0], s_v[r][c]);
    for (int k = 1; k < 7; ++k) acc = __fadd_rn(acc, __fmul_rn(g.g[k], s_v[r][c + k]));
    blur[((size_t)b * H + y) * W + x] = acc;
  }
}

// One pixel of the next level: out = sum_j wx_j * (sum_i wy_i * img[ys + i, xs + j]),
// the rows' sums first as the plain path's einsum contracts them.
__device__ void resize_pixel(const float* __restrict__ img, float* __restrict__ next, int H, int W, int NH, int NW,
                             const int* __restrict__ y_start, const float* __restrict__ y_w, int ny,
                             const int* __restrict__ x_start, const float* __restrict__ x_w, int nx, long long p) {
  const int X = (int)(p % NW);
  const long long q = p / NW;
  const int Y = (int)(q % NH), b = (int)(q / NH);
  const float* src = img + (size_t)b * H * W + (size_t)y_start[Y] * W + x_start[X];
  float acc = 0.f;
  for (int j = 0; j < nx; ++j) {
    float col = 0.f;
    for (int i = 0; i < ny; ++i) col = fmaf(y_w[Y * ny + i], src[(size_t)i * W + j], col);
    acc = fmaf(x_w[X * nx + j], col, acc);
  }
  next[p] = acc;
}

__global__ void __launch_bounds__(kThreads)
    level_build_kernel(const float* __restrict__ img, float* __restrict__ blur, float* __restrict__ next, int B,
                       int H, int W, int NH, int NW, const int* __restrict__ y_start, const float* __restrict__ y_w,
                       int ny, const int* __restrict__ x_start, const float* __restrict__ x_w, int nx, Gauss7 g,
                       int tiles_x, int tiles_y) {
  const int blur_blocks = B * tiles_x * tiles_y;
  if ((int)blockIdx.x < blur_blocks) {
    blur_tile(img, blur, H, W, tiles_x, tiles_y, blockIdx.x, g);
    return;
  }
  const long long p = (long long)(blockIdx.x - blur_blocks) * kThreads + threadIdx.x;
  if (p < (long long)B * NH * NW) resize_pixel(img, next, H, W, NH, NW, y_start, y_w, ny, x_start, x_w, nx, p);
}

// ---------------------------------------------------------------------------
// Response: a block per 32 x 16 output tile. Shared regions around the tile
// (halo 5: image; 4: gradient products; 1: responses), each entry at a
// position q holding its quantity at the replicate-clamped position, as the
// plain path's padded convolutions see it.

constexpr int kR5H = kTileH + 10, kR5W = kTileW + 10;
constexpr int kR4H = kTileH + 8, kR4W = kTileW + 8;
constexpr int kR1H = kTileH + 2, kR1W = kTileW + 2;

// FAST's 16-point ring, clockwise from 12 o'clock (ops/orb.py::_RING).
__constant__ int8_t kRingDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int8_t kRingDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

// Whether the plain path's has_arc fires: 9 contiguous set flags starting
// at ring position 0..14 of the ring followed by its first 7 positions.
__device__ __forceinline__ bool has_arc(uint32_t flags) {
  const uint32_t m = flags | (flags << 16);
  uint32_t run = m;
  for (int s = 1; s < 9; ++s) run &= m >> s;
  return (run & 0x7fffu) != 0;
}

__global__ void __launch_bounds__(kThreads)
    response_kernel(const float* __restrict__ img, float* __restrict__ masked, float* __restrict__ raw, int H, int W,
                    int tiles_x, int tiles_y, float threshold, float harris_k, float harris_scale, int margin) {
  __shared__ float s_img[kR5H][kR5W];
  __shared__ float s_xx[kR4H][kR4W];
  __shared__ float s_xy[kR4H][kR4W];
  __shared__ float s_yy[kR4H][kR4W];
  __shared__ float s_resp[kR1H][kR1W];
  const int per_image = tiles_x * tiles_y;
  const int b = blockIdx.x / per_image, t = blockIdx.x % per_image;
  const int y0 = (t / tiles_x) * kTileH, x0 = (t % tiles_x) * kTileW;
  const float* src = img + (size_t)b * H * W;
  const int oy5 = y0 - 5, ox5 = x0 - 5, oy4 = y0 - 4, ox4 = x0 - 4;

  for (int i = threadIdx.x; i < kR5H * kR5W; i += kThreads) {
    const int r = i / kR5W, c = i % kR5W;
    s_img[r][c] = src[(size_t)clampi(oy5 + r, 0, H - 1) * W + clampi(ox5 + c, 0, W - 1)];
  }
  __syncthreads();

  // Sobel at the clamped position (its 3 x 3 taps clamped again), row-major
  // over the taps as the correlation sums them; the products as
  // harris_response forms them.
  for (int i = threadIdx.x; i < kR4H * kR4W; i += kThreads) {
    const int r = i / kR4W, c = i % kR4W;
    const int qy = clampi(oy4 + r, 0, H - 1), qx = clampi(ox4 + c, 0, W - 1);
    float v[3][3];
    for (int dy = 0; dy < 3; ++dy)
      for (int dx = 0; dx < 3; ++dx)
        v[dy][dx] = s_img[clampi(qy + dy - 1, 0, H - 1) - oy5][clampi(qx + dx - 1, 0, W - 1) - ox5];
    float ix = -v[0][0];
    ix = __fadd_rn(ix, v[0][2]);
    ix = __fadd_rn(ix, -2.f * v[1][0]);
    ix = __fadd_rn(ix, 2.f * v[1][2]);
    ix = __fadd_rn(ix, -v[2][0]);
    ix = __fadd_rn(ix, v[2][2]);
    float iy = -v[0][0];
    iy = __fadd_rn(iy, -2.f * v[0][1]);
    iy = __fadd_rn(iy, -v[0][2]);
    iy = __fadd_rn(iy, v[2][0]);
    iy = __fadd_rn(iy, 2.f * v[2][1]);
    iy = __fadd_rn(iy, v[2][2]);
    s_xx[r][c] = __fmul_rn(ix, ix);
    s_xy[r][c] = __fmul_rn(ix, iy);
    s_yy[r][c] = __fmul_rn(iy, iy);
  }
  __syncthreads();

  // FAST and Harris at every in-image position of the tile and its 1-pixel
  // halo; -inf outside the image (max_pool's padding) and off corners.
  for (int i = threadIdx.x; i < kR1H * kR1W; i += kThreads) {
    const int r = i / kR1W, c = i % kR1W;
    const int py = y0 - 1 + r, px = x0 - 1 + c;
    float resp = -INFINITY;
    if (py >= 0 && py < H && px >= 0 && px < W) {
      const float p = s_img[py - oy5][px - ox5];
      const float hi = __fadd_rn(p, threshold), lo = __fsub_rn(p, threshold);
      uint32_t bright = 0, dark = 0;
      for (int k = 0; k < 16; ++k) {
        const float q = s_img[clampi(py + kRingDy[k], 0, H - 1) - oy5][clampi(px + kRingDx[k], 0, W - 1) - ox5];
        bright |= (uint32_t)(q > hi) << k;
        dark |= (uint32_t)(q < lo) << k;
      }
      if (has_arc(bright) || has_arc(dark)) {
        float a = 0.f, bb = 0.f, cc = 0.f;
        for (int dy = -3; dy <= 3; ++dy) {
          const int rr = clampi(py + dy, 0, H - 1) - oy4;
          for (int dx = -3; dx <= 3; ++dx) {
            const int cc4 = clampi(px + dx, 0, W - 1) - ox4;
            a = __fadd_rn(a, s_xx[rr][cc4]);
            bb = __fadd_rn(bb, s_xy[rr][cc4]);
            cc = __fadd_rn(cc, s_yy[rr][cc4]);
          }
        }
        const float det = __fsub_rn(__fmul_rn(a, cc), __fmul_rn(bb, bb));
        const float tr = __fadd_rn(a, cc);
        const float h = __fsub_rn(det, __fmul_rn(__fmul_rn(harris_k, tr), tr));
        resp = __fmul_rn(__fmul_rn(h, harris_scale), harris_scale);
      }
    }
    s_resp[r][c] = resp;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kTileH * kTileW; i += kThreads) {
    const int r = i / kTileW, c = i % kTileW;
    const int y = y0 + r, x = x0 + c;
    if (y >= H || x >= W) continue;
    const float v = s_resp[r + 1][c + 1];
    if (raw != nullptr) raw[((size_t)b * H + y) * W + x] = v;
    float neigh = -INFINITY;
    for (int dy = 0; dy < 3; ++dy)
      for (int dx = 0; dx < 3; ++dx) neigh = fmaxf(neigh, s_resp[r + dy][c + dx]);
    const bool ok = v >= neigh && y >= margin && y < H - margin && x >= margin && x < W - margin;
    masked[((size_t)b * H + y) * W + x] = ok ? v : -INFINITY;
  }
}

// ---------------------------------------------------------------------------
// Orientation and description: a block per (keyframe, keypoint) slot.
// table: (kBins, 512, 4) int32 per sample {y0 | x0 << 8, bf16 w00 | w01 << 16,
// bf16 w10 | w11 << 16, 0}, its taps at window (y0, x0), (y0, x0 + 1),
// (y0 + 1, x0), (y0 + 1, x0 + 1); samples 0..255 the pairs' first ends,
// 256..511 their second.

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ float brief_sample(const int4 tap, const float (*win)[kWin]) {
  const int y = tap.x & 0xff, x = (tap.x >> 8) & 0xff;
  const uint32_t w01 = (uint32_t)tap.y, w23 = (uint32_t)tap.z;
  const float t0 = __fmul_rn(win[y][x], bf16_lo(w01));
  const float t1 = __fmul_rn(win[y][x + 1], bf16_hi(w01));
  const float t2 = __fmul_rn(win[y + 1][x], bf16_lo(w23));
  const float t3 = __fmul_rn(win[y + 1][x + 1], bf16_hi(w23));
  return __fadd_rn(__fadd_rn(__fadd_rn(t0, t1), t2), t3);
}

__global__ void __launch_bounds__(kThreads)
    describe_kernel(const float* __restrict__ img, const float* __restrict__ blur, const int64_t* __restrict__ idx,
                    const float* __restrict__ resp, const int4* __restrict__ table, float* __restrict__ angle,
                    int8_t* __restrict__ desc, int H, int W, int K, float bin_width) {
  __shared__ double s_m01[kThreads];
  __shared__ double s_m10[kThreads];
  __shared__ float s_win[kWin][kWin];
  __shared__ int s_bin;
  const long long slot = blockIdx.x;
  const int tid = threadIdx.x;
  int8_t* bits = desc + slot * kBits;
  if (!isfinite(resp[slot])) {  // a padded slot: angle 0, no bits
    if (tid == 0) angle[slot] = 0.f;
    bits[tid] = 0;
    return;
  }
  const int b = (int)(slot / K);
  const long long id = idx[slot];
  const int x = (int)(id % W), y = (int)(id / W);
  const float* src = img + (size_t)b * H * W;

  // Intensity centroid over the circular patch (clamped into the image as
  // the plain path clamps it): float32 products, double sums, a fixed tree.
  const int ox = clampi(x - kHalf, 0, W - kPatch), oy = clampi(y - kHalf, 0, H - kPatch);
  double m01 = 0.0, m10 = 0.0;
  for (int i = tid; i < kPatch * kPatch; i += kThreads) {
    const int r = i / kPatch, c = i % kPatch, dy = r - kHalf, dx = c - kHalf;
    if (dy * dy + dx * dx > kHalf * kHalf) continue;
    const float v = src[(size_t)(oy + r) * W + ox + c];
    m01 += (double)__fmul_rn(v, (float)dy);
    m10 += (double)__fmul_rn(v, (float)dx);
  }
  s_m01[tid] = m01;
  s_m10[tid] = m10;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (tid < stride) {
      s_m01[tid] += s_m01[tid + stride];
      s_m10[tid] += s_m10[tid + stride];
    }
    __syncthreads();
  }
  if (tid == 0) {
    const float a = atan2f((float)s_m01[0], (float)s_m10[0]);
    angle[slot] = a;
    int q = (int)rintf(__fdiv_rn(a, bin_width)) % kBins;
    s_bin = q < 0 ? q + kBins : q;
  }

  // The window of bf16-rounded blurred pixels, replicate-clamped.
  const float* bsrc = blur + (size_t)b * H * W;
  const int cy = clampi(y, 0, H - 1), cx = clampi(x, 0, W - 1);
  for (int i = tid; i < kWin * kWin; i += kThreads) {
    const int r = i / kWin, c = i % kWin;
    s_win[r][c] = bf16_round(bsrc[(size_t)clampi(cy - kWinHalf + r, 0, H - 1) * W + clampi(cx - kWinHalf + c, 0, W - 1)]);
  }
  __syncthreads();
  const int4* taps = table + (size_t)s_bin * kSamples;
  bits[tid] = brief_sample(taps[tid], s_win) < brief_sample(taps[kBits + tid], s_win) ? 1 : 0;
}

}  // namespace

extern "C" {

// img (B, H, W) float32 -> blur (B, H, W) float32 and, where NH > 0, the
// next level next (B, NH, NW) float32 from the banded taps (y_start (NH,),
// y_w (NH, ny), x_start (NW,), x_w (NW, nx)); gauss: the 7 blur taps.
int orb_level_build(const float* img, float* blur, float* next, int B, int H, int W, int NH, int NW,
                    const int* y_start, const float* y_w, int ny, const int* x_start, const float* x_w, int nx,
                    const float* gauss, void* stream) {
  if (ny > kMaxTaps || nx > kMaxTaps) return static_cast<int>(cudaErrorInvalidValue);
  Gauss7 g;
  for (int k = 0; k < 7; ++k) g.g[k] = gauss[k];
  const int tiles_x = (W + kTileW - 1) / kTileW, tiles_y = (H + kTileH - 1) / kTileH;
  const long long next_px = NH > 0 ? (long long)B * NH * NW : 0;
  const long long blocks = (long long)B * tiles_x * tiles_y + (next_px + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  level_build_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      img, blur, next, B, H, W, NH > 0 ? NH : 1, NH > 0 ? NW : 1, y_start, y_w, ny, x_start, x_w, nx, g, tiles_x,
      tiles_y);
  return static_cast<int>(cudaGetLastError());
}

// img (B, H, W) float32 -> masked (B, H, W) float32: the Harris response
// where FAST fires, the 3x3 maximum holds and the pixel lies `margin` or
// more inside the image; -inf elsewhere. raw (B, H, W), where not null:
// the Harris response where FAST fires, -inf elsewhere (for tests).
int orb_response(const float* img, float* masked, float* raw, int B, int H, int W, float threshold, float harris_k,
                 float harris_scale, int margin, void* stream) {
  const int tiles_x = (W + kTileW - 1) / kTileW, tiles_y = (H + kTileH - 1) / kTileH;
  const long long blocks = (long long)B * tiles_x * tiles_y;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  response_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      img, masked, raw, H, W, tiles_x, tiles_y, threshold, harris_k, harris_scale, margin);
  return static_cast<int>(cudaGetLastError());
}

// img, blur (B, H, W) float32; idx (B, K) int64 flat pixel indices and resp
// (B, K) float32 of the selected keypoints (not finite: a padded slot);
// table (kBins, 512, 4) int32 -> angle (B, K) float32, desc (B, K, 256) int8.
int orb_describe(const float* img, const float* blur, const int64_t* idx, const float* resp, const int* table,
                 float* angle, int8_t* desc, int B, int H, int W, int K, float bin_width, void* stream) {
  const long long blocks = (long long)B * K;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  describe_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      img, blur, idx, resp, reinterpret_cast<const int4*>(table), angle, desc, H, W, K, bin_width);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
