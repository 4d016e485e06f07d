// Native host keyframe-selection scan (pass 1) of the PyTorch port: its own
// copy of native/pass1.cpp (which stays the JAX package's), run on a pool of
// threads. The twin of the device scan in pipeline._make_keyframe_scan.
//
// WHY THIS EXISTS: pass 1 only produces a per-frame boolean (is this a
// keyframe?) plus the scan state; its input is the whole video. Running the
// selection on the host means only selected keyframes ever cross the
// host->device link (config.pass1_backend="host").
//
// Mirrored semantics (statistical parity with the device scan, not bitwise —
// the contract of SURVEY.md §7.3 for every kernel in this framework):
//   * CLAHE:      ops/clahe.py::_clahe_single  (reference processor.py:12-26)
//   * Shi-Tomasi: ops/features.py::good_features (processor.py:104-106)
//   * pyramidal LK: ops/klt.py::lucas_kanade    (processor.py:79-83)
//   * accumulation + threshold rule: pipeline._make_keyframe_scan
//     (reference keyframeTracking, processor.py:95-106: NaN->0 clamp, mean
//     over valid points, err > threshold * full_res_width, reseed on fire)
//
// Threads: the caller passes the number of cores it may use. One persistent
// pool of std::thread workers (created on first use, blocked on a condition
// variable between jobs) runs, for each call,
//   1. every frame's CLAHE, then every frame's pyramid (they depend on that
//      frame alone);
//   2. the keyframe chain, frame by frame: each step's live points tracked
//      by LK on the threads, each point taken by whichever thread is free and
//      written to its own slot, then, on the calling thread, the error and
//      displacement sums in point order, the fire rule and the carry;
//   3. Shi-Tomasi on bootstrap and fired frames: Sobel, box sums and response
//      by rows, the maximum response (exact in any order), then NMS and the
//      best per cell over bands of whole cell rows, each cell with one owner.
// Every float operation is the serial scan's, on the same operands in the same
// order, so the results are bit for bit native/pass1.cpp's at any thread
// count. With one thread every phase runs inline on the caller and no thread
// starts.

#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

namespace {

// ------------------------------- CLAHE ------------------------------------

// Matches ops/clahe.py::_clahe_single: reflect-pad to the tile grid,
// OpenCV-style integer clip/redistribute, per-pixel bilinear LUT blend
// between the 4 surrounding tile centers (clamped at borders).
void clahe_u8(const uint8_t* in, float* out, long h, long w, float clip_limit,
              int ty, int tx) {
  const long th = (h + ty - 1) / ty;  // ceil tile height
  const long tw = (w + tx - 1) / tx;
  const double area = (double)th * (double)tw;
  const double clip = std::max(1.0, std::floor(clip_limit * area / 256.0));

  // Per-tile LUTs. Reflect padding is equivalent to reflecting the
  // out-of-range sample index back into the image when histogramming.
  std::vector<float> lut((size_t)ty * tx * 256);
  std::vector<double> hist(256);
  for (int iy = 0; iy < ty; ++iy) {
    for (int ix = 0; ix < tx; ++ix) {
      std::fill(hist.begin(), hist.end(), 0.0);
      for (long r = iy * th; r < (iy + 1) * th; ++r) {
        long rr = r < h ? r : 2 * h - 2 - r;  // reflect (no edge repeat)
        if (rr < 0) rr = 0;
        const uint8_t* row = in + rr * w;
        for (long c = ix * tw; c < (ix + 1) * tw; ++c) {
          long cc = c < w ? c : 2 * w - 2 - c;
          if (cc < 0) cc = 0;
          hist[row[cc]] += 1.0;
        }
      }
      double excess = 0.0;
      for (int b = 0; b < 256; ++b)
        if (hist[b] > clip) {
          excess += hist[b] - clip;
          hist[b] = clip;
        }
      const double redist = std::floor(excess / 256.0);
      const double residual = excess - redist * 256.0;
      const double step =
          std::max(std::floor(256.0 / std::max(residual, 1.0)), 1.0);
      for (int b = 0; b < 256; ++b) {
        double bonus =
            (std::fmod((double)b, step) == 0.0 && (double)b / step < residual)
                ? 1.0
                : 0.0;
        hist[b] += redist + bonus;
      }
      double cdf = 0.0;
      float* lp = &lut[((size_t)iy * tx + ix) * 256];
      for (int b = 0; b < 256; ++b) {
        cdf += hist[b];
        double v = std::round(cdf * 255.0 / area);
        lp[b] = (float)std::min(std::max(v, 0.0), 255.0);
      }
    }
  }

  // Bilinear blend of the 4 surrounding tile LUTs (clamped at borders) —
  // per-pixel form of the banded matmul in clahe.py (same weights). The
  // column tile index/weight depends only on x (and row only on y), so both
  // are precomputed once per image: the per-pixel body is then 4 LUT
  // gathers + 3 lerps, with no divides or floors (those dominated the
  // original per-pixel form on the scalar pass-1 host path).
  std::vector<long> j0s(w), j1s(w);
  std::vector<float> wxs(w);
  for (long x = 0; x < w; ++x) {
    const double fx = (double)x / tw - 0.5;
    long j0 = (long)std::floor(fx);
    double wx = fx - j0;
    if (j0 < 0) { j0 = 0; wx = 0.0; }
    if (j0 > tx - 1) { j0 = tx - 1; wx = 0.0; }
    j0s[x] = j0;
    j1s[x] = std::min(j0 + 1, (long)tx - 1);
    wxs[x] = (float)wx;
  }
  for (long y = 0; y < h; ++y) {
    const double fy = (double)y / th - 0.5;
    long i0 = (long)std::floor(fy);
    double wy = fy - i0;
    if (i0 < 0) { i0 = 0; wy = 0.0; }
    if (i0 > ty - 1) { i0 = ty - 1; wy = 0.0; }
    const long i1 = std::min(i0 + 1, (long)ty - 1);
    const float fwy = (float)(i1 == i0 ? 0.0 : wy);
    const float* lrow0 = &lut[(size_t)i0 * tx * 256];
    const float* lrow1 = &lut[(size_t)i1 * tx * 256];
    const uint8_t* row = in + y * w;
    float* orow = out + y * w;
    for (long x = 0; x < w; ++x) {
      const int v = row[x];
      const float wx = wxs[x];
      const long j0 = j0s[x] * 256, j1 = j1s[x] * 256;
      const float top = lrow0[j0 + v] + wx * (lrow0[j1 + v] - lrow0[j0 + v]);
      const float bot = lrow1[j0 + v] + wx * (lrow1[j1 + v] - lrow1[j0 + v]);
      orow[x] = top + fwy * (bot - top);
    }
  }
}

// ----------------------------- image pyramid -------------------------------

struct Pyramid {
  std::vector<std::vector<float>> levels;  // level 0 = full res
  std::vector<long> hs, ws;
  void init(long h, long w, int n) {
    levels.resize(n);
    hs.resize(n);
    ws.resize(n);
    for (int l = 0; l < n; ++l) {
      hs[l] = h;
      ws[l] = w;
      levels[l].resize((size_t)h * w);
      h = (h + 1) / 2;  // ceil halving matches [::2] on odd sizes
      w = (w + 1) / 2;
    }
  }
};

// 5-tap [1,4,6,4,1]/16 separable blur with edge padding, then [::2, ::2]
// decimation — matches ops/klt.py::build_pyramid.
void pyr_down(const float* in, long h, long w, float* out, long oh, long ow,
              std::vector<float>& tmp) {
  tmp.resize((size_t)h * w);
  static const float g[5] = {1.f / 16, 4.f / 16, 6.f / 16, 4.f / 16, 1.f / 16};
  // Vertical pass (edge clamp).
  for (long y = 0; y < h; ++y) {
    float* trow = &tmp[(size_t)y * w];
    const float* r0 = in + (size_t)std::max(y - 2, 0L) * w;
    const float* r1 = in + (size_t)std::max(y - 1, 0L) * w;
    const float* r2 = in + (size_t)y * w;
    const float* r3 = in + (size_t)std::min(y + 1, h - 1) * w;
    const float* r4 = in + (size_t)std::min(y + 2, h - 1) * w;
    for (long x = 0; x < w; ++x)
      trow[x] = g[0] * r0[x] + g[1] * r1[x] + g[2] * r2[x] + g[3] * r3[x] +
                g[4] * r4[x];
  }
  // Horizontal pass + decimation.
  for (long y = 0; y < oh; ++y) {
    const float* trow = &tmp[(size_t)(2 * y) * w];
    float* orow = out + (size_t)y * ow;
    for (long x = 0; x < ow; ++x) {
      const long c = 2 * x;
      float acc = 0.f;
      for (int k = -2; k <= 2; ++k) {
        long cc = std::min(std::max(c + k, 0L), w - 1);
        acc += g[k + 2] * trow[cc];
      }
      orow[x] = acc;
    }
  }
}

void build_pyramid(const float* img, long h, long w, int levels, Pyramid& pyr,
                   std::vector<float>& tmp) {
  std::memcpy(pyr.levels[0].data(), img, sizeof(float) * h * w);
  for (int l = 1; l < levels; ++l)
    pyr_down(pyr.levels[l - 1].data(), pyr.hs[l - 1], pyr.ws[l - 1],
             pyr.levels[l].data(), pyr.hs[l], pyr.ws[l], tmp);
}

// --------------------------- bilinear sampling ------------------------------

inline float sample(const float* img, long h, long w, double x, double y) {
  // Clamp-to-edge bilinear (the device kernel replicate-pads; same contract).
  x = std::min(std::max(x, 0.0), (double)(w - 1));
  y = std::min(std::max(y, 0.0), (double)(h - 1));
  const long x0 = (long)x, y0 = (long)y;
  const long x1 = std::min(x0 + 1, w - 1), y1 = std::min(y0 + 1, h - 1);
  const double fx = x - x0, fy = y - y0;
  const float* r0 = img + (size_t)y0 * w;
  const float* r1 = img + (size_t)y1 * w;
  return (float)((1 - fy) * ((1 - fx) * r0[x0] + fx * r0[x1]) +
                 fy * ((1 - fx) * r1[x0] + fx * r1[x1]));
}

// Fill a win x win patch centered at (cx, cy), rows written at `stride`
// floats apart (stride >= win; padding columns are left untouched).
// Interior windows (the common case by far) take a branch-free path: one
// set of bilinear weights, four fused row reads — ~4x the throughput of
// per-sample clamping.
void window(const float* img, long h, long w, double cx, double cy, int win,
            float* out, int stride) {
  const double half = (win - 1) / 2.0;
  const double x0f = cx - half, y0f = cy - half;
  const long x0 = (long)std::floor(x0f), y0 = (long)std::floor(y0f);
  if (x0 >= 0 && y0 >= 0 && x0 + win < w && y0 + win < h) {
    const float fx = (float)(x0f - x0), fy = (float)(y0f - y0);
    const float w00 = (1 - fy) * (1 - fx), w01 = (1 - fy) * fx;
    const float w10 = fy * (1 - fx), w11 = fy * fx;
    for (int r = 0; r < win; ++r) {
      const float* r0 = img + (size_t)(y0 + r) * w + x0;
      const float* r1 = r0 + w;
      float* orow = out + (size_t)r * stride;
      for (int c = 0; c < win; ++c)
        orow[c] = w00 * r0[c] + w01 * r0[c + 1] + w10 * r1[c] + w11 * r1[c + 1];
    }
    return;
  }
  for (int r = 0; r < win; ++r)
    for (int c = 0; c < win; ++c)
      out[r * stride + c] = sample(img, h, w, cx - half + c, cy - half + r);
}

// ------------------------------ pyramidal LK -------------------------------

// Track one point; mirrors ops/klt.py::track_one. Returns status; writes the
// tracked point and the level-0 window error.
bool lk_track(const Pyramid& prev, const Pyramid& curr, int levels, int win,
              int iters, double eps, const float pt[2], float out_pt[2],
              float* out_err, std::vector<float>& buf) {
  const int wp = win + 2;
  // Window rows live at a multiple-of-8 stride with ZERO padding columns:
  // every per-iteration reduction then runs over win*ws floats with no
  // scalar tail (the padding contributes exactly 0 — ix/iy/tmpl are zero
  // there), which the compiler turns into clean 8-wide FMA loops.
  const int ws = (win + 7) & ~7;
  const size_t area = (size_t)win * ws;
  buf.assign((size_t)wp * wp + 4 * area, 0.0f);
  float* patch = buf.data();
  float* ix = patch + wp * wp;
  float* iy = ix + area;
  float* tmpl = iy + area;
  float* cur = tmpl + area;

  double d[2] = {0.0, 0.0};
  bool ok_all = true;
  for (int lvl = levels - 1; lvl >= 0; --lvl) {
    const double s = (double)(1 << lvl);
    const double px = pt[0] / s, py = pt[1] / s;
    const float* pimg = prev.levels[lvl].data();
    const float* cimg = curr.levels[lvl].data();
    const long lh = prev.hs[lvl], lw = prev.ws[lvl];

    window(pimg, lh, lw, px, py, wp, patch, wp);
    double gxx = 0, gxy = 0, gyy = 0;
    for (int r = 0; r < win; ++r)
      for (int c = 0; c < win; ++c) {
        const float dx = 0.5f * (patch[(r + 1) * wp + c + 2] -
                                 patch[(r + 1) * wp + c]);
        const float dy = 0.5f * (patch[(r + 2) * wp + c + 1] -
                                 patch[r * wp + c + 1]);
        ix[r * ws + c] = dx;
        iy[r * ws + c] = dy;
        tmpl[r * ws + c] = patch[(r + 1) * wp + c + 1];
        gxx += (double)dx * dx;
        gxy += (double)dx * dy;
        gyy += (double)dy * dy;
      }
    const double det = gxx * gyy - gxy * gxy;
    const bool ok = det > 1e-7;
    ok_all &= ok;
    const double i00 = gyy / (ok ? det : 1.0), i01 = -gxy / (ok ? det : 1.0);
    const double i11 = gxx / (ok ? det : 1.0);

    bool frozen = false;
    for (int it = 0; it < iters && !frozen; ++it) {
      float bxf = 0, byf = 0;
      window(cimg, lh, lw, px + d[0], py + d[1], win, cur, ws);
      // Full padded range, no tail: padding has ix = iy = 0. Float
      // accumulation here is safe — |diff| <= 255 and win*win <= ~1k, well
      // inside float range; the solve stays in double.
      for (int i = 0; i < win * ws; ++i) {
        const float diff = tmpl[i] - cur[i];
        bxf += diff * ix[i];
        byf += diff * iy[i];
      }
      const double bx = bxf, by = byf;
      const double dx = i00 * bx + i01 * by;
      const double dy = i01 * bx + i11 * by;
      if (dx * dx + dy * dy < eps * eps || !ok)
        frozen = true;  // cv2 TERM_CRITERIA_EPS freeze (klt.py::body)
      else {
        d[0] += dx;
        d[1] += dy;
      }
    }
    if (lvl > 0) {
      d[0] *= 2.0;
      d[1] *= 2.0;
    }
  }

  out_pt[0] = (float)(pt[0] + d[0]);
  out_pt[1] = (float)(pt[1] + d[1]);
  const long h0 = prev.hs[0], w0 = prev.ws[0];
  const bool in_bounds = out_pt[0] >= 0 && out_pt[0] < w0 && out_pt[1] >= 0 &&
                         out_pt[1] < h0;
  // Final window error at full resolution (klt.py: mean |tmpl - curr|).
  // Padded columns contribute |0 - 0| = 0; the mean divides by the true
  // window area.
  window(prev.levels[0].data(), h0, w0, pt[0], pt[1], win, tmpl, ws);
  window(curr.levels[0].data(), h0, w0, out_pt[0], out_pt[1], win, cur, ws);
  float err = 0.0f;
  for (int i = 0; i < win * ws; ++i)
    err += std::fabs(tmpl[i] - cur[i]);
  *out_err = err / (win * win);
  return ok_all && in_bounds;
}

// --------------------------------- pool ----------------------------------

inline void cpu_relax() {
#if defined(__x86_64__) || defined(__i386__)
  __builtin_ia32_pause();
#elif defined(__aarch64__)
  asm volatile("yield");
#endif
}

// Spins up to ~kSpinSeconds for done() to hold, then returns done(). Waking a
// blocked thread costs tens to hundreds of microseconds on a virtual machine,
// as much as a frame's LK: between the jobs of one scan, which follow each
// other within microseconds, the pool's threads wait spinning.
constexpr double kSpinSeconds = 2e-4;

template <class Done>
bool spin_until(Done done) {
  const auto t0 = std::chrono::steady_clock::now();
  for (;;) {
    for (int i = 0; i < 64; ++i) {
      if (done()) return true;
      cpu_relax();
    }
    if (std::chrono::duration<double>(std::chrono::steady_clock::now() - t0)
            .count() > kSpinSeconds)
      return done();
  }
}

// Persistent workers: run(n, fn) calls fn(i) for every i in [0, n), fn(0) on
// the caller and the rest on workers 1..n-1, and returns when all are done.
// Workers spin a little after each job, then block on a condition variable.
class Pool {
 public:
  void run(int n, const std::function<void(int)>& fn) {
    if (n <= 1) {
      fn(0);
      return;
    }
    {
      std::lock_guard<std::mutex> g(m_);
      while ((int)threads_.size() < n - 1) {
        const int id = (int)threads_.size() + 1;
        threads_.emplace_back([this, id, s0 = state_.load()] { loop(id, s0); });
      }
      job_ = &fn;
      pending_.store(n - 1);
      // A job is (generation << 16 | threads): a worker reads both at once.
      state_.store(((state_.load() >> 16) + 1) << 16 | (uint64_t)n);
    }
    wake_.notify_all();
    fn(0);
    if (!spin_until([this] { return pending_.load() == 0; })) {
      std::unique_lock<std::mutex> lk(m_);
      done_.wait(lk, [this] { return pending_.load() == 0; });
    }
  }

 private:
  // Runs each job after `seen` that needs worker `id`.
  void loop(int id, uint64_t seen) {
    for (;;) {
      if (!spin_until([&] { return state_.load() != seen; })) {
        std::unique_lock<std::mutex> lk(m_);
        wake_.wait(lk, [&] { return state_.load() != seen; });
      }
      seen = state_.load();
      // A job that needs this worker cannot end, and no later job start,
      // before the worker has run it: job_ stays valid meanwhile.
      if (id >= (int)(seen & 0xffff)) continue;
      (*job_)(id);
      if (pending_.fetch_sub(1) == 1) {
        std::lock_guard<std::mutex> g(m_);
        done_.notify_one();
      }
    }
  }

  std::mutex m_;
  std::condition_variable wake_, done_;
  std::vector<std::thread> threads_;
  const std::function<void(int)>* job_ = nullptr;
  std::atomic<int> pending_{0};
  std::atomic<uint64_t> state_{0};
};

// Where part i of n equal parts of `rows` rows starts.
inline long part(long rows, int i, int n) { return rows * i / n; }

// ------------------------------- Shi-Tomasi --------------------------------

// Shi-Tomasi's planes, kept between calls: the gradients, the structure
// tensor's three products and their horizontal box sums, the response.
struct Features {
  std::vector<float> gx, gy, prod, hsum, resp, band_max;
  std::vector<long> best, cand;
};

// Mirrors ops/features.py::good_features: Sobel -> box-summed structure
// tensor -> min-eig -> 3x3 NMS -> relative quality gate -> border margin ->
// best-per-cell min-distance -> top-K by response. Rows and cell rows are
// split over n threads; each pixel's arithmetic is native/pass1.cpp's.
void good_features(Pool& pool, int n, Features& s, const float* img, long h,
                   long w, long K, float quality, int min_dist, int block,
                   float* out_xy, uint8_t* out_mask) {
  const size_t np = (size_t)h * w;
  for (auto* v : {&s.gx, &s.gy, &s.resp}) v->resize(np);
  s.prod.resize(3 * np);
  s.hsum.resize(3 * np);
  s.band_max.assign(n, -1e30f);
  float *gx = s.gx.data(), *gy = s.gy.data(), *resp = s.resp.data();
  float* plane[3] = {s.prod.data(), s.prod.data() + np, s.prod.data() + 2 * np};
  float* hsum[3] = {s.hsum.data(), s.hsum.data() + np, s.hsum.data() + 2 * np};
  const int hb = block / 2;
  // 3x3 Sobel (replicate borders), the structure tensor's products and their
  // horizontal box sums (replicate padding), by rows.
  pool.run(n, [&](int i) {
    for (long y = part(h, i, n); y < part(h, i + 1, n); ++y) {
      const float* rm = img + (size_t)std::max(y - 1, 0L) * w;
      const float* r0 = img + (size_t)y * w;
      const float* rp = img + (size_t)std::min(y + 1, h - 1) * w;
      for (long x = 0; x < w; ++x) {
        const long xm = std::max(x - 1, 0L), xp = std::min(x + 1, w - 1);
        gx[y * w + x] = (rm[xp] - rm[xm]) + 2.f * (r0[xp] - r0[xm]) +
                        (rp[xp] - rp[xm]);
        gy[y * w + x] = (rp[xm] - rm[xm]) + 2.f * (rp[x] - rm[x]) +
                        (rp[xp] - rm[xp]);
      }
      for (long x = y * w; x < (y + 1) * w; ++x) {
        plane[0][x] = gx[x] * gx[x];
        plane[1][x] = gx[x] * gy[x];
        plane[2][x] = gy[x] * gy[x];
      }
      for (int p = 0; p < 3; ++p) {
        const float* src = plane[p] + (size_t)y * w;
        float* d = hsum[p] + (size_t)y * w;
        for (long x = 0; x < w; ++x) {
          float acc = 0.f;
          for (int k = -hb; k <= hb; ++k)
            acc += src[std::min(std::max(x + k, 0L), w - 1)];
          d[x] = acc;
        }
      }
    }
  });
  // Vertical box sums (replicate padding) and the min-eigenvalue response,
  // by rows; each band's largest response.
  const double scale = 1.0 / ((4.0 * 255.0 * block) * (4.0 * 255.0 * block));
  pool.run(n, [&](int i) {
    const long y0 = part(h, i, n), y1 = part(h, i + 1, n);
    for (int p = 0; p < 3; ++p)
      for (long y = y0; y < y1; ++y)
        for (long x = 0; x < w; ++x) {
          float acc = 0.f;
          for (int k = -hb; k <= hb; ++k)
            acc += hsum[p][(size_t)std::min(std::max(y + k, 0L), h - 1) * w + x];
          plane[p][(size_t)y * w + x] = acc;
        }
    const float *a = plane[0], *b = plane[1], *c = plane[2];
    float rmax = -1e30f;
    for (size_t j = (size_t)y0 * w; j < (size_t)y1 * w; ++j) {
      const double half_tr = 0.5 * ((double)a[j] + c[j]);
      const double rad =
          std::sqrt(std::max(0.25 * ((double)a[j] - c[j]) * ((double)a[j] - c[j]) +
                                 (double)b[j] * b[j],
                             0.0));
      resp[j] = (float)((half_tr - rad) * scale);
      rmax = std::max(rmax, resp[j]);
    }
    s.band_max[i] = rmax;
  });
  float rmax = -1e30f;
  for (int i = 0; i < n; ++i) rmax = std::max(rmax, s.band_max[i]);
  const float thresh = quality * rmax;
  const int margin = std::max(block / 2, 3);
  const int cell = min_dist > 0 ? min_dist : 1;
  const long ncx = (w + cell - 1) / cell;
  const long ncy = (h + cell - 1) / cell;
  // Best candidate per min-distance cell, over bands of whole cell rows.
  s.best.assign(ncx * ncy, -1);
  long* best = s.best.data();
  pool.run(n, [&](int i) {
    const long y0 = std::max(part(ncy, i, n) * cell, (long)margin);
    const long y1 = std::min(part(ncy, i + 1, n) * cell, h - margin);
    for (long y = y0; y < y1; ++y)
      for (long x = margin; x < w - margin; ++x) {
        const float v = resp[y * w + x];
        if (v <= thresh) continue;
        // 3x3 non-max suppression (>= neighborhood max).
        bool peak = true;
        for (int dy = -1; dy <= 1 && peak; ++dy)
          for (int dx = -1; dx <= 1; ++dx) {
            const long yy = std::min(std::max(y + dy, 0L), h - 1);
            const long xx = std::min(std::max(x + dx, 0L), w - 1);
            if (resp[yy * w + xx] > v) {
              peak = false;
              break;
            }
          }
        if (!peak) continue;
        long& slot = best[(y / cell) * ncx + (x / cell)];
        if (slot < 0 || resp[slot] < v) slot = y * w + x;
      }
  });
  // Top-K by response, from the candidates in cell order.
  std::vector<long>& cand = s.cand;
  cand.clear();
  for (long i = 0; i < ncx * ncy; ++i)
    if (best[i] >= 0) cand.push_back(best[i]);
  std::sort(cand.begin(), cand.end(),
            [&](long p, long q) { return resp[p] > resp[q]; });
  for (long k = 0; k < K; ++k) {
    if (k < (long)cand.size()) {
      out_xy[2 * k] = (float)(cand[k] % w);
      out_xy[2 * k + 1] = (float)(cand[k] / w);
      out_mask[k] = 1;
    } else {
      out_xy[2 * k] = out_xy[2 * k + 1] = 0.f;
      out_mask[k] = 0;
    }
  }
}

// ------------------------------- the scan ----------------------------------

// A scan's buffers, kept between calls by the pool's owner: a pyramid a
// frame, the threads' own temporaries, Shi-Tomasi's planes, and the seconds
// spent in each phase (CLAHE, pyramids, LK, Shi-Tomasi) since they were read.
struct Scratch {
  std::vector<Pyramid> pyrs;
  std::vector<std::vector<float>> tmp, buf;
  Features features;
  std::vector<long> live;
  std::vector<float> new_pts, errs;
  std::vector<uint8_t> status;
  double phase_s[4] = {0, 0, 0, 0};
};

// The process's pool and the scratch of the scan that holds it (`busy`); a
// scan that finds it held runs on its own thread alone.
struct Host {
  Pool pool;
  std::mutex busy;
  Scratch scratch;
};

// A forked child gets a new Host: its parent's workers do not exist in it.
Host& the_host() {
  static std::mutex m;
  static Host* host = nullptr;
  static pid_t owner = 0;
  std::lock_guard<std::mutex> g(m);
  if (host == nullptr || owner != getpid()) {
    host = new Host();  // never freed: its workers live as long as the process
    owner = getpid();
  }
  return *host;
}

using Clock = std::chrono::steady_clock;

inline double since(Clock::time_point t0) {
  return std::chrono::duration<double>(Clock::now() - t0).count();
}

}  // namespace

extern "C" {

// Scan one chunk of decimated grey frames through the keyframe state machine.
//
// greys:        (t, h, w) uint8 raw downscaled frames.
// bootstrap_at: >= 0 -> (re)initialize the carry from that frame (frames
//               before it are skipped, as the reference discards pre-board
//               frames, processor.py:315-319); -1 -> carry continues.
// state_prev:   (h, w) float CLAHE'd previous frame (in/out; valid when
//               bootstrap_at < 0).
// state_pts / state_mask: (K, 2) float / (K,) uint8 tracked points (in/out).
// state_acc:    accumulated error scalar (in/out).
// state_acc_flow: accumulated mean tracked displacement scalar (in/out) —
//               the frame-count-invariant secondary trigger (see
//               KeyframeConfig.flow_threshold; the reference's intensity
//               rule alone starves fast clips of keyframes).
// threshold_px: keyframe threshold * FULL-resolution width (pipeline rule),
//               or the absolute intensity budget (threshold_abs).
// flow_threshold_px: displacement budget in working px (flow_threshold *
//               working width); <= 0 disables the secondary trigger.
// kf_flags:     (t,) uint8 out — 1 where the frame fires a keyframe.
// enhanced_out: (t, h, w) float out — CLAHE'd frames (only entries at
//               flagged or bootstrap frames are meaningful to the caller).
// threads:      the cores the caller may use.
// Returns the threads the call used: `threads`, or 1 where another scan
// holds the pool.
int pass1_scan(const uint8_t* greys, long t, long h, long w, long bootstrap_at,
               float clip_limit, int tiles_y, int tiles_x, float* state_prev,
               float* state_pts, uint8_t* state_mask, float* state_acc,
               float* state_acc_flow, long K, float quality, int min_dist,
               int block, int win, int levels, int iters, float eps,
               float threshold_px, float flow_threshold_px, uint8_t* kf_flags,
               float* enhanced_out, int threads) {
  Host& host = the_host();
  Pool& pool = host.pool;
  std::unique_lock<std::mutex> own(host.busy, std::try_to_lock);
  Scratch local;
  Scratch& s = own.owns_lock() ? host.scratch : local;
  const int n = own.owns_lock() ? std::max(threads, 1) : 1;
  const size_t hw = (size_t)h * w;

  std::memset(kf_flags, 0, (size_t)t);
  const long first = bootstrap_at >= 0 ? bootstrap_at : 0;
  const long start = bootstrap_at >= 0 ? bootstrap_at + 1 : 0;
  s.tmp.resize(n);
  s.buf.resize(n);

  // Phase 1: every frame's CLAHE, then the pyramids of the carried frame
  // (slot 0) and of each frame from `start` (slot f - start + 1).
  Clock::time_point t0 = Clock::now();
  std::atomic<long> next(first);
  pool.run(n, [&](int) {
    for (long f; (f = next++) < t;)
      clahe_u8(greys + f * hw, enhanced_out + f * hw, h, w, clip_limit,
               tiles_y, tiles_x);
  });
  s.phase_s[0] += since(t0);
  if (bootstrap_at >= 0) {
    t0 = Clock::now();
    const float* enh = enhanced_out + (size_t)bootstrap_at * hw;
    good_features(pool, n, s.features, enh, h, w, K, quality, min_dist, block,
                  state_pts, state_mask);
    std::memcpy(state_prev, enh, sizeof(float) * hw);
    *state_acc = 0.f;
    *state_acc_flow = 0.f;
    s.phase_s[3] += since(t0);
  }
  if (start >= t) return n;

  t0 = Clock::now();
  const long slots = t - start + 1;
  if ((long)s.pyrs.size() < slots) s.pyrs.resize(slots);
  next = 0;
  pool.run(n, [&](int i) {
    for (long j; (j = next++) < slots;) {
      s.pyrs[j].init(h, w, levels);
      const float* img = j == 0 ? state_prev : enhanced_out + (start + j - 1) * hw;
      build_pyramid(img, h, w, levels, s.pyrs[j], s.tmp[i]);
    }
  });
  s.phase_s[1] += since(t0);

  // Phase 2: the chain.
  s.new_pts.resize(2 * (size_t)K);
  s.status.resize((size_t)K);
  s.errs.resize((size_t)K);
  float* new_pts = s.new_pts.data();
  uint8_t* status = s.status.data();
  float* errs = s.errs.data();
  for (long f = start; f < t; ++f) {
    const Pyramid& prev_pyr = s.pyrs[f - start];
    const Pyramid& curr_pyr = s.pyrs[f - start + 1];
    s.live.clear();
    for (long k = 0; k < K; ++k)
      if (state_mask[k]) s.live.push_back(k);
    const long n_live = (long)s.live.size();
    const int m = (int)std::min<long>(n, n_live);
    t0 = Clock::now();
    std::atomic<long> nj(0);
    pool.run(m, [&](int i) {
      for (long j; (j = nj++) < n_live;) {
        const long k = s.live[j];
        status[k] = lk_track(prev_pyr, curr_pyr, levels, win, iters, eps,
                             &state_pts[2 * k], &new_pts[2 * k], &errs[k],
                             s.buf[i])
                        ? 1
                        : 0;
      }
    });
    s.phase_s[2] += since(t0);

    double err_sum = 0.0;
    double disp_sum = 0.0;
    long n_valid = 0;
    long n_flow = 0;
    for (long k = 0; k < K; ++k) {
      if (!state_mask[k]) continue;
      ++n_valid;
      // Reference accumulation (processor.py:95-97): NaN (untracked) -> 0,
      // negatives -> 0 (|.| is already non-negative here).
      if (status[k] && std::isfinite(errs[k]))
        err_sum += std::max(errs[k], 0.f);
      if (status[k]) {
        float dx = new_pts[2 * k] - state_pts[2 * k];
        float dy = new_pts[2 * k + 1] - state_pts[2 * k + 1];
        float d = std::sqrt(dx * dx + dy * dy);
        if (std::isfinite(d)) disp_sum += d;
        ++n_flow;
      }
    }
    *state_acc += (float)(err_sum / std::max(n_valid, 1L));
    *state_acc_flow += (float)(disp_sum / std::max(n_flow, 1L));

    bool fire = *state_acc > threshold_px;
    if (flow_threshold_px > 0.f && *state_acc_flow > flow_threshold_px)
      fire = true;
    if (fire) {
      kf_flags[f] = 1;
      *state_acc = 0.f;
      *state_acc_flow = 0.f;
      t0 = Clock::now();
      good_features(pool, n, s.features, enhanced_out + f * hw, h, w, K,
                    quality, min_dist, block, state_pts, state_mask);
      s.phase_s[3] += since(t0);
    } else {
      for (long k = 0; k < K; ++k) {
        if (state_mask[k] && status[k]) {
          state_pts[2 * k] = new_pts[2 * k];
          state_pts[2 * k + 1] = new_pts[2 * k + 1];
        } else {
          state_mask[k] = 0;
        }
      }
    }
  }
  std::memcpy(state_prev, enhanced_out + (t - 1) * hw, sizeof(float) * hw);
  return n;
}

// Copies the seconds the scans that held the pool spent in each phase
// (CLAHE, pyramids, LK, Shi-Tomasi) since the last call into out[4], and
// starts them again from zero.
void pass1_phase_seconds(double* out) {
  Host& host = the_host();
  std::lock_guard<std::mutex> g(host.busy);
  for (int i = 0; i < 4; ++i) {
    out[i] = host.scratch.phase_s[i];
    host.scratch.phase_s[i] = 0;
  }
}

}  // extern "C"
