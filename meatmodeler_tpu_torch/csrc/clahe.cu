// CLAHE as two hand-written CUDA kernels for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of meatmodeler_tpu/ops/clahe_pallas.py:
//   clahe_lut_kernel   <- _lut_kernel + _hist_contrib  (pallas_call at :192)
//   clahe_apply_kernel <- _apply_kernel                (pallas_call at :208)
// and computes what ops/clahe.py::clahe_xla computes: per-tile 256-bin
// histograms of the reflect-padded image, OpenCV's integer clip and
// redistribution, a CDF LUT per tile, then a bilinear blend of the four
// neighbouring tiles' LUTs per pixel.
//
// What bounds it: each image is read once by each kernel and written once
// by the apply; the LUTs are 1 KB per tile. There is no matrix product (the
// TPU kernels' one-hot matmuls were an MXU device and are not carried over),
// so both kernels are bound by bytes: the design keeps 16-byte loads in
// flight and does no integer division per pixel.
//
// clahe_lut_kernel walks a tile as items of 4 pixels (one float4 per lane)
// when the tile columns are 16-byte aligned and need no reflect padding,
// else of 1 pixel. Each thread steps its (row, column) by the group size
// without dividing. Every warp counts into its own shared histogram, and
// equal bins are merged first (a warp vote, then a lane's 4 pixels), so a
// flat image costs one shared atomic per warp step, not 128 on one
// address. (__match_any_sync merging was measured and dropped: its cost
// grows with the number of distinct bins in the warp, and a random image
// took twice the time of a flat one; PERF.md.) Tiles of at most
// kWarpTileMaxArea pixels get one warp each (8 tiles per block, 32 lanes
// doing the clip and scan over 8 bins each, no block barrier); larger tiles
// get a whole block, whose 8 warp histograms are summed once at the end.
//
// clahe_apply_kernel runs on a 3D grid (column block, row band, image). A
// band holds the rows between two tile-row centres, so all its rows blend
// the same two tile rows; the block stages those rows' LUTs (only the tile
// columns its 128 pixels touch) into shared memory with coalesced float4
// loads and gathers from there. Each thread takes 4 adjacent pixels per row
// (one float4 load and store), with column weights computed once per thread
// and row weights once per row; its first row's load goes out before the
// staging barrier and each step loads the next row before it blends this
// one. The blend uses unfused multiplies and adds in the plain version's
// order; what differs from it (<= 9.2e-5 measured) is the rounding of the
// weights, which PyTorch on the card derives by another route.
//
// The arithmetic is the reference's: integer clip and redistribution, an
// exact integer CDF, the f32 product cdf * f32(255 / area), rintf binning
// (round half to even), reflect padding by index.
//
// Plain C interface, loaded with ctypes; every entry returns
// cudaGetLastError() after its launch. Launches go on the caller's stream,
// never synchronise, and allocate nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 256;
constexpr int kWarps = 8;  // warps per block, both kernels
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
// Tile area (pixels) up to which a warp, not a block, builds a tile's LUT.
// Measured with meatmodeler_tpu_torch/tools/clahe_bench.py --sweep on an
// H100 (8x8 tiles, ~11.4 M pixels per launch): warps win at 510, 920, 2040
// and 3600 px (40.9 / 27.1 / 24.6 / 24.7 us against blocks' 104.2 / 68.8 /
// 36.8 / 26.4 us), blocks at 8160 px (24.2 against 28.0 us); the crossover
// lies between 3600 and 8160 px. Small tiles leave a block's 256 threads
// idle behind its barriers with a few pixels each; large ones give a warp
// too long a serial walk.
constexpr int kWarpTileMaxArea = 4096;
constexpr int kApplyCols = 128;  // pixels of an apply column block: 32 threads x 4
constexpr int kApplyRows = 8;    // rows per step of an apply block: blockDim.y

__device__ __forceinline__ int reflect_index(int i, int n) {
  // jnp.pad / F.pad mode="reflect" (edge not repeated); the pad is < n.
  return i < n ? i : 2 * (n - 1) - i;
}

__device__ __forceinline__ int pixel_bin(float v) {
  // round-half-even of clip(v, 0, 255), as jnp.round / torch.round.
  return static_cast<int>(rintf(fminf(fmaxf(v, 0.0f), 255.0f)));
}

// One item (VEC adjacent pixels) per lane into the warp's histogram.
// Equal bins are merged before the shared atomics: when the whole warp's
// items hold one bin (flat background) a single lane adds them all; when a
// lane's VEC pixels share a bin it adds them with one atomic. Other items
// cost one atomic per pixel, which contend only as far as their bins do.
template <int VEC>
__device__ __forceinline__ void warp_count(int* hist, const int (&bins)[VEC], bool ok, int lane) {
  const unsigned valid = __ballot_sync(kFull, ok);
  if (valid == 0) return;
  bool same = true;
#pragma unroll
  for (int e = 1; e < VEC; ++e) same &= bins[e] == bins[0];
  const int first = __ffs(valid) - 1;
  const int lead = __shfl_sync(kFull, bins[0], first);
  if (__all_sync(kFull, !ok || (same && bins[0] == lead))) {
    if (lane == first) atomicAdd(&hist[lead], VEC * __popc(valid));
  } else if (ok && same) {
    atomicAdd(&hist[bins[0]], VEC);
  } else if (ok) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) atomicAdd(&hist[bins[e]], 1);
  }
}

// Histogram of the tile whose top-left pixel is (y0, x0) in image `im`,
// walked by G threads (g = rank in the group) as items of VEC pixels: item
// k is tile row k / nv, column group k % nv. Every thread of a warp runs the
// same number of steps, so the warp's votes see all of its lanes.
template <int VEC>
__device__ __forceinline__ void tile_histogram(const float* __restrict__ im, int H, int W, int y0,
                                               int x0, int th, int tw, int g, int G, int* hist,
                                               int lane) {
  constexpr int kUnroll = 4;  // loads in flight per thread
  const int nv = tw / VEC;
  const int steps = (th * nv + G - 1) / G;
  const int dr = G / nv, dc = G - dr * nv;
  int r = g / nv, c = g - r * nv;
  for (int s = 0; s < steps; s += kUnroll) {
    float v[kUnroll][VEC];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      ok[u] = s + u < steps && r < th;
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[u][e] = 0.0f;
      if (ok[u]) {
        const float* row = im + static_cast<int64_t>(reflect_index(y0 + r, H)) * W;
        if constexpr (VEC == 4) {
          const float4 q = __ldg(reinterpret_cast<const float4*>(row + x0) + c);
          v[u][0] = q.x;
          v[u][1] = q.y;
          v[u][2] = q.z;
          v[u][3] = q.w;
        } else {
          v[u][0] = __ldg(row + reflect_index(x0 + c, W));
        }
      }
      c += dc;
      r += dr;
      if (c >= nv) {
        c -= nv;
        ++r;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      int bins[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) bins[e] = pixel_bin(v[u][e]);
      warp_count<VEC>(hist, bins, ok[u], lane);
    }
  }
}

__device__ __forceinline__ float lut_value(int cdf, float scale) {
  // Integer counts: the CDF is exact; the scale is the reference's f32
  // product cdf * f32(255 / area).
  return fminf(fmaxf(rintf(static_cast<float>(cdf) * scale), 0.0f), 255.0f);
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Clip, then spread the excess: floor(excess / 256) to every bin plus one to
// every step-th bin while the residual lasts (ops/clahe.py:114-123).
__device__ __forceinline__ int clipped_count(int count, int bin, int clip, int excess) {
  const int redist = excess / kBins;
  const int residual = excess - redist * kBins;
  const int step = max(kBins / max(residual, 1), 1);
  const int bonus = (bin % step == 0 && bin / step < residual) ? 1 : 0;
  return min(count, clip) + redist + bonus;
}

// One warp turns its tile's histogram into the LUT: lane l owns bins
// 8l .. 8l+7.
__device__ __forceinline__ void warp_lut(const int* hist, float* out, int clip, float scale,
                                         int lane) {
  const int4 a = reinterpret_cast<const int4*>(hist)[2 * lane];
  const int4 b = reinterpret_cast<const int4*>(hist)[2 * lane + 1];
  const int cnt[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  int over = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) over += max(cnt[j] - clip, 0);
  const int excess = warp_sum(over);
  int cdf[8];
  int run = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    run += clipped_count(cnt[j], 8 * lane + j, clip, excess);
    cdf[j] = run;
  }
  int incl = run;  // inclusive scan of the lanes' totals
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += n;
  }
  const int base = incl - run;
  float4* dst = reinterpret_cast<float4*>(out) + 2 * lane;
  dst[0] = make_float4(lut_value(cdf[0] + base, scale), lut_value(cdf[1] + base, scale),
                       lut_value(cdf[2] + base, scale), lut_value(cdf[3] + base, scale));
  dst[1] = make_float4(lut_value(cdf[4] + base, scale), lut_value(cdf[5] + base, scale),
                       lut_value(cdf[6] + base, scale), lut_value(cdf[7] + base, scale));
}

// A block turns its tile's histogram into the LUT: thread t owns bin t.
__device__ __forceinline__ void block_lut(int count, float* out, int clip, float scale,
                                          int* warp_sums) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int over = warp_sum(max(count - clip, 0));
  if (lane == 0) warp_sums[warp] = over;
  __syncthreads();
  int excess = 0;
  for (int i = 0; i < kWarps; ++i) excess += warp_sums[i];
  int v = clipped_count(count, t, clip, excess);
  // Inclusive scan over the 256 bins: warp scans, then the warp totals.
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += n;
  }
  __syncthreads();  // every thread has read warp_sums above
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  for (int i = 0; i < warp; ++i) v += warp_sums[i];
  out[t] = lut_value(v, scale);
}

// Grid: one block per tile (WARP_TILES false) or one per 8 tiles, a warp
// each (WARP_TILES true). Tiles are numbered image-major, row-major.
template <int VEC, bool WARP_TILES>
__global__ void __launch_bounds__(kThreads)
    clahe_lut_kernel(const float* __restrict__ img, float* __restrict__ lut, int n_tiles, int H,
                     int W, int tiles_y, int tiles_x, int th, int tw, int clip) {
  __shared__ __align__(16) int hist[kWarps * kBins];
  __shared__ int warp_sums[kWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int tile = WARP_TILES ? blockIdx.x * kWarps + warp : blockIdx.x;
  if (WARP_TILES && tile >= n_tiles) return;  // no block barrier in this mode
  const int per_image = tiles_y * tiles_x;
  const int b = tile / per_image;
  const int ti = (tile - b * per_image) / tiles_x;
  const int tj = tile - b * per_image - ti * tiles_x;
  const float* im = img + static_cast<int64_t>(b) * H * W;
  const float scale = static_cast<float>(255.0 / static_cast<double>(th * tw));
  int* own = hist + warp * kBins;
  float* out = lut + static_cast<int64_t>(tile) * kBins;

  if (WARP_TILES) {
    for (int j = lane; j < kBins; j += 32) own[j] = 0;
    __syncwarp();
    tile_histogram<VEC>(im, H, W, ti * th, tj * tw, th, tw, lane, 32, own, lane);
    __syncwarp();
    warp_lut(own, out, clip, scale, lane);
  } else {
    for (int j = t; j < kWarps * kBins; j += kThreads) hist[j] = 0;
    __syncthreads();
    tile_histogram<VEC>(im, H, W, ti * th, tj * tw, th, tw, t, kThreads, own, lane);
    __syncthreads();
    int count = 0;
    for (int w = 0; w < kWarps; ++w) count += hist[w * kBins + t];
    block_lut(count, out, clip, scale, warp_sums);
  }
}

// floor(i / tsize - 0.5) in f32, as the plain version computes it: the
// tile whose centre is at or above pixel i (-1 above the first centre).
__device__ __forceinline__ float tile_coord(int i, int tsize) {
  return static_cast<float>(i) / static_cast<float>(tsize) - 0.5f;
}

__device__ __forceinline__ int tile_below(int i, int tsize) {
  return static_cast<int>(floorf(tile_coord(i, tsize)));
}

// First pixel i in [0, n] with tile_below(i) >= band; tile_below is
// monotonic, so the pixels of one band are a contiguous run.
__device__ int band_start(int band, int tsize, int n) {
  int i = min(max(((2 * band + 1) * tsize + 1) / 2, 0), n);
  while (i > 0 && tile_below(i - 1, tsize) >= band) --i;
  while (i < n && tile_below(i, tsize) < band) ++i;
  return i;
}

// Grid: (column blocks of 128 px, tiles_y + 1 row bands, images); block
// (32, 8). Band k holds the rows whose upper tile row is k - 1.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
    clahe_apply_kernel(const float* __restrict__ img, const float* __restrict__ lut,
                       float* __restrict__ out, int H, int W, int tiles_y, int tiles_x, int th,
                       int tw) {
  extern __shared__ __align__(16) float staged[];  // [2][n_cols][kBins]
  const int b = blockIdx.z;
  const int band = static_cast<int>(blockIdx.y) - 1;
  const int row_begin = band_start(band, th, H);
  const int row_end = band + 1 < tiles_y ? band_start(band + 1, th, H) : H;
  if (row_begin >= row_end) return;  // the same for the whole block
  const int ty0 = min(max(band, 0), tiles_y - 1);
  const int ty1 = min(max(band + 1, 0), tiles_y - 1);
  const int col0 = blockIdx.x * kApplyCols;
  const int col_last = min(col0 + kApplyCols, W) - 1;
  const int tx_first = min(max(tile_below(col0, tw), 0), tiles_x - 1);
  const int tx_last = min(max(tile_below(col_last, tw) + 1, 0), tiles_x - 1);
  const int n_cols = tx_last - tx_first + 1;

  // This thread's 4 pixels of a row (zeros past the right edge).
  const int x = col0 + 4 * threadIdx.x;
  const int64_t image_off = static_cast<int64_t>(b) * H * W;
  auto load = [&](int y) {
    const float* src = img + image_off + static_cast<int64_t>(y) * W + x;
    if constexpr (VEC) {
      return __ldg(reinterpret_cast<const float4*>(src));
    } else {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = x + e < W ? __ldg(src + e) : 0.0f;
      return make_float4(v[0], v[1], v[2], v[3]);
    }
  };
  // The first row's load goes out before the staging barrier, and each
  // step loads the next row before it blends this one.
  int y = row_begin + threadIdx.y;
  float4 next = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (x < W && y < row_end) next = load(y);

  // Stage the band's two tile rows, tile columns tx_first .. tx_last.
  const float* image_lut = lut + static_cast<int64_t>(b) * tiles_y * tiles_x * kBins;
  const int per_row = n_cols * (kBins / 4);  // float4s
  const int t = threadIdx.y * 32 + threadIdx.x;
  for (int k = t; k < 2 * per_row; k += kThreads) {
    const int slot = k >= per_row;
    const int kk = k - slot * per_row;
    const int tile = (slot ? ty1 : ty0) * tiles_x + tx_first + kk / (kBins / 4);
    reinterpret_cast<float4*>(staged)[k] =
        __ldg(reinterpret_cast<const float4*>(image_lut + tile * kBins) + kk % (kBins / 4));
  }
  __syncthreads();

  if (x >= W) return;
  int c0[4], c1[4];
  float wx[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float f = tile_coord(min(x + e, W - 1), tw);
    const float f0 = floorf(f);
    const int i0 = static_cast<int>(f0);
    c0[e] = (min(max(i0, 0), tiles_x - 1) - tx_first) * kBins;
    c1[e] = (min(max(i0 + 1, 0), tiles_x - 1) - tx_first) * kBins;
    wx[e] = __fsub_rn(f, f0);
  }
  const float* s0 = staged;
  const float* s1 = staged + n_cols * kBins;
  for (; y < row_end; y += kApplyRows) {
    const float4 q = next;
    if (y + kApplyRows < row_end) next = load(y + kApplyRows);
    const float in[4] = {q.x, q.y, q.z, q.w};
    const float f = tile_coord(y, th);
    const float wy = __fsub_rn(f, floorf(f));
    const float uy = __fsub_rn(1.0f, wy);
    float o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int v = pixel_bin(in[e]);
      const float ux = __fsub_rn(1.0f, wx[e]);
      // (1 - wy) * ((1 - wx) * l00 + wx * l01) + wy * ((1 - wx) * l10 + wx * l11),
      // unfused, as the plain version's separate tensor operations.
      const float top = __fadd_rn(__fmul_rn(ux, s0[c0[e] + v]), __fmul_rn(wx[e], s0[c1[e] + v]));
      const float bot = __fadd_rn(__fmul_rn(ux, s1[c0[e] + v]), __fmul_rn(wx[e], s1[c1[e] + v]));
      o[e] = __fadd_rn(__fmul_rn(uy, top), __fmul_rn(wy, bot));
    }
    float* dst = out + image_off + static_cast<int64_t>(y) * W + x;
    if constexpr (VEC) {
      *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (x + e < W) dst[e] = o[e];
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// img (B, H, W) float32 -> lut (B, ty*tx, 256) float32, with tiles of at
// most `warp_tile_max_area` pixels built by one warp each.
int clahe_lut_with_crossover(const float* img, float* lut, int B, int H, int W, int tiles_y,
                             int tiles_x, int th, int tw, int clip, int warp_tile_max_area,
                             void* stream) {
  const int n_tiles = B * tiles_y * tiles_x;
  const bool vec = W % 4 == 0 && tw % 4 == 0 && tw * tiles_x == W && aligned16(img);
  const bool warp_tiles = th * tw <= warp_tile_max_area;
  const int blocks = warp_tiles ? (n_tiles + kWarps - 1) / kWarps : n_tiles;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!aligned16(lut)) return static_cast<int>(cudaErrorMisalignedAddress);
  if (vec && warp_tiles)
    clahe_lut_kernel<4, true><<<blocks, kThreads, 0, s>>>(img, lut, n_tiles, H, W, tiles_y,
                                                          tiles_x, th, tw, clip);
  else if (vec)
    clahe_lut_kernel<4, false><<<blocks, kThreads, 0, s>>>(img, lut, n_tiles, H, W, tiles_y,
                                                           tiles_x, th, tw, clip);
  else if (warp_tiles)
    clahe_lut_kernel<1, true><<<blocks, kThreads, 0, s>>>(img, lut, n_tiles, H, W, tiles_y,
                                                          tiles_x, th, tw, clip);
  else
    clahe_lut_kernel<1, false><<<blocks, kThreads, 0, s>>>(img, lut, n_tiles, H, W, tiles_y,
                                                           tiles_x, th, tw, clip);
  return static_cast<int>(cudaGetLastError());
}

// img (B, H, W) float32 -> lut (B, ty*tx, 256) float32.
int clahe_lut(const float* img, float* lut, int B, int H, int W, int tiles_y, int tiles_x,
              int th, int tw, int clip, void* stream) {
  return clahe_lut_with_crossover(img, lut, B, H, W, tiles_y, tiles_x, th, tw, clip,
                                  kWarpTileMaxArea, stream);
}

// img (B, H, W) + lut (B, ty*tx, 256) -> out (B, H, W), all float32.
int clahe_apply(const float* img, const float* lut, float* out, int B, int H, int W,
                int tiles_y, int tiles_x, int th, int tw, void* stream) {
  if (!aligned16(lut)) return static_cast<int>(cudaErrorMisalignedAddress);
  // Tile columns one 128-pixel column block can touch, with a margin for
  // the f32 rounding of the tile coordinate at both ends.
  const int max_cols = tiles_x < (kApplyCols - 1) / tw + 3 ? tiles_x : (kApplyCols - 1) / tw + 3;
  const size_t smem = 2u * max_cols * kBins * sizeof(float);
  const bool vec = W % 4 == 0 && aligned16(img) && aligned16(out);
  const dim3 grid((W + kApplyCols - 1) / kApplyCols, tiles_y + 1, B);
  const dim3 block(32, kApplyRows);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(clahe_apply_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    clahe_apply_kernel<true><<<grid, block, smem, s>>>(img, lut, out, H, W, tiles_y, tiles_x, th,
                                                       tw);
  } else {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(clahe_apply_kernel<false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    clahe_apply_kernel<false><<<grid, block, smem, s>>>(img, lut, out, H, W, tiles_y, tiles_x,
                                                        th, tw);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
