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
// What bounds it: at the main path's shapes (a few 540x960 keyframes,
// 2 MB of float32 per image) both kernels move a few MB and do little
// arithmetic, so they are memory- and launch-bound. The TPU kernels built
// histograms and the LUT lookup from one-hot matmuls because the MXU was
// their fast unit; here the histogram is shared-memory atomics, the CDF a
// warp scan, and the lookup a direct gather from the image's 64 KB of LUTs,
// which stay in L1/L2.
//
// Plain C interface, loaded with ctypes; every entry returns
// cudaGetLastError() after its launch. Launches go on the caller's stream,
// never synchronise, and allocate nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBins = 256;

__device__ __forceinline__ int reflect_index(int i, int n) {
  // jnp.pad / F.pad mode="reflect" (edge not repeated); the pad is < n.
  return i < n ? i : 2 * (n - 1) - i;
}

__device__ __forceinline__ int pixel_bin(float v) {
  // round-half-even of clip(v, 0, 255), as jnp.round / torch.round.
  return static_cast<int>(rintf(fminf(fmaxf(v, 0.0f), 255.0f)));
}

// One block of 256 threads per (image, tile): grid = B * ty * tx.
__global__ void clahe_lut_kernel(const float* __restrict__ img, float* __restrict__ lut,
                                 int H, int W, int tiles_y, int tiles_x, int th, int tw,
                                 int clip) {
  __shared__ int hist[kBins];
  __shared__ int warp_sums[kBins / 32];
  const int t = threadIdx.x;
  const int tile = blockIdx.x % (tiles_y * tiles_x);
  const int b = blockIdx.x / (tiles_y * tiles_x);
  const int ti = tile / tiles_x;
  const int tj = tile % tiles_x;
  const float* im = img + static_cast<int64_t>(b) * H * W;

  hist[t] = 0;
  __syncthreads();
  const int area = th * tw;
  for (int k = t; k < area; k += blockDim.x) {
    const int y = reflect_index(ti * th + k / tw, H);
    const int x = reflect_index(tj * tw + k % tw, W);
    atomicAdd(&hist[pixel_bin(im[static_cast<int64_t>(y) * W + x])], 1);
  }
  __syncthreads();

  // Clip, then spread the excess: floor(excess / 256) to every bin plus one
  // to every step-th bin while the residual lasts (ops/clahe.py:114-123).
  const int count = hist[t];
  int over = max(count - clip, 0);
  for (int o = 16; o > 0; o >>= 1) over += __shfl_xor_sync(0xffffffffu, over, o);
  if ((t & 31) == 0) warp_sums[t >> 5] = over;
  __syncthreads();
  int excess = 0;
  for (int i = 0; i < kBins / 32; ++i) excess += warp_sums[i];
  const int redist = excess / kBins;
  const int residual = excess - redist * kBins;
  const int step = max(kBins / max(residual, 1), 1);
  const int bonus = (t % step == 0 && t / step < residual) ? 1 : 0;
  int v = min(count, clip) + redist + bonus;

  // Inclusive scan over the 256 bins: warp scans, then the warp totals.
  const int lane = t & 31;
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  __syncthreads();  // every thread has read warp_sums above
  if (lane == 31) warp_sums[t >> 5] = v;
  __syncthreads();
  for (int i = 0; i < (t >> 5); ++i) v += warp_sums[i];

  // Integer counts: the CDF is exact; the scale is the reference's f32
  // product cdf * f32(255 / area).
  const float scale = static_cast<float>(255.0 / static_cast<double>(area));
  const float out = fminf(fmaxf(rintf(static_cast<float>(v) * scale), 0.0f), 255.0f);
  lut[static_cast<int64_t>(blockIdx.x) * kBins + t] = out;
}

__device__ __forceinline__ void axis_weights(int i, int tsize, int n_tiles, int* lo, int* hi,
                                             float* w) {
  const float f = static_cast<float>(i) / static_cast<float>(tsize) - 0.5f;
  const float f0 = floorf(f);
  *w = f - f0;
  const int i0 = static_cast<int>(f0);
  *lo = min(max(i0, 0), n_tiles - 1);
  *hi = min(max(i0 + 1, 0), n_tiles - 1);
}

// One thread per output pixel over (B, H, W).
__global__ void clahe_apply_kernel(const float* __restrict__ img, const float* __restrict__ lut,
                                   float* __restrict__ out, int64_t total, int H, int W,
                                   int tiles_y, int tiles_x, int th, int tw) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int x = static_cast<int>(idx % W);
  const int y = static_cast<int>((idx / W) % H);
  const int64_t b = idx / (static_cast<int64_t>(H) * W);
  const int v = pixel_bin(img[idx]);
  int y0, y1, x0, x1;
  float wy, wx;
  axis_weights(y, th, tiles_y, &y0, &y1, &wy);
  axis_weights(x, tw, tiles_x, &x0, &x1, &wx);
  const float* l = lut + b * tiles_y * tiles_x * kBins + v;
  const float l00 = __ldg(l + (y0 * tiles_x + x0) * kBins);
  const float l01 = __ldg(l + (y0 * tiles_x + x1) * kBins);
  const float l10 = __ldg(l + (y1 * tiles_x + x0) * kBins);
  const float l11 = __ldg(l + (y1 * tiles_x + x1) * kBins);
  out[idx] = (1.0f - wy) * ((1.0f - wx) * l00 + wx * l01) + wy * ((1.0f - wx) * l10 + wx * l11);
}

}  // namespace

extern "C" {

// img (B, H, W) float32 -> lut (B, ty*tx, 256) float32.
int clahe_lut(const float* img, float* lut, int B, int H, int W, int tiles_y, int tiles_x,
              int th, int tw, int clip, void* stream) {
  const int blocks = B * tiles_y * tiles_x;
  clahe_lut_kernel<<<blocks, kBins, 0, static_cast<cudaStream_t>(stream)>>>(
      img, lut, H, W, tiles_y, tiles_x, th, tw, clip);
  return static_cast<int>(cudaGetLastError());
}

// img (B, H, W) + lut (B, ty*tx, 256) -> out (B, H, W), all float32.
int clahe_apply(const float* img, const float* lut, float* out, int B, int H, int W,
                int tiles_y, int tiles_x, int th, int tw, void* stream) {
  const int64_t total = static_cast<int64_t>(B) * H * W;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  clahe_apply_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(img, lut, out, total, H, W, tiles_y,
                                                            tiles_x, th, tw);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
