// Native data-loading path: threaded JPEG decode + antialiased bicubic
// resize to a fixed crop size, writing directly into a caller-provided
// batch buffer.
//
// The port's copy of tpu_reid/native/loader.cc, byte for byte below this
// header, so that both packages decode every image to the same pixels. The
// resize reimplements PIL's convolution resampling (separable cubic filter,
// a = -0.5, support widened by the scale factor when downscaling) so the
// native path is numerically interchangeable with the PIL path (within 2
// levels; PIL rounds some pixels differently).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 loader.cc -o <lib> -ljpeg -lpthread
// (driven by tpu_reid_torch/native/__init__.py, into build/native/)

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <csetjmp>
#include <cstddef>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

// jpeglib.h needs size_t/FILE declared first
#include <jpeglib.h>

namespace {

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode a JPEG file to an RGB8 buffer. Returns false on any error.
bool DecodeJpeg(const char* path, std::vector<unsigned char>* rgb, int* w,
                int* h) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  rgb->resize(size_t(*w) * *h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row = rgb->data() + size_t(cinfo.output_scanline) * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return true;
}

// PIL bicubic kernel (a = -0.5, support 2).
inline double CubicFilter(double x) {
  constexpr double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

struct ResampleWeights {
  std::vector<int> xmin;    // first source index per output pixel
  std::vector<int> xsize;   // taps per output pixel
  std::vector<double> coef; // ksize coefficients per output pixel
  int ksize = 0;
};

// PIL's precompute_coeffs: antialiased support scaling on downscale.
ResampleWeights ComputeWeights(int in_size, int out_size) {
  ResampleWeights rw;
  const double scale = double(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = 2.0 * filterscale;
  rw.ksize = int(std::ceil(support)) * 2 + 1;
  rw.xmin.resize(out_size);
  rw.xsize.resize(out_size);
  rw.coef.resize(size_t(out_size) * rw.ksize);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = std::max(0, int(center - support + 0.5));
    int xmax = std::min(in_size, int(center + support + 0.5));
    double* k = &rw.coef[size_t(xx) * rw.ksize];
    double total = 0.0;
    for (int x = xmin; x < xmax; ++x) {
      double w = CubicFilter((x - center + 0.5) / filterscale);
      k[x - xmin] = w;
      total += w;
    }
    if (total != 0.0) {
      for (int x = 0; x < xmax - xmin; ++x) k[x] /= total;
    }
    rw.xmin[xx] = xmin;
    rw.xsize[xx] = xmax - xmin;
  }
  return rw;
}

inline unsigned char ClampRound(double v) {
  v = std::round(v);
  if (v < 0.0) return 0;
  if (v > 255.0) return 255;
  return (unsigned char)v;
}

// Separable resize RGB8 (in_h, in_w) -> (out_h, out_w): horizontal pass to
// a float intermediate, then vertical pass.
void ResizeBicubic(const unsigned char* in, int in_h, int in_w,
                   unsigned char* out, int out_h, int out_w) {
  ResampleWeights wx = ComputeWeights(in_w, out_w);
  ResampleWeights wy = ComputeWeights(in_h, out_h);
  std::vector<float> tmp(size_t(in_h) * out_w * 3);
  for (int y = 0; y < in_h; ++y) {
    const unsigned char* row = in + size_t(y) * in_w * 3;
    float* trow = tmp.data() + size_t(y) * out_w * 3;
    for (int xx = 0; xx < out_w; ++xx) {
      const double* k = &wx.coef[size_t(xx) * wx.ksize];
      const int x0 = wx.xmin[xx];
      double acc[3] = {0, 0, 0};
      for (int t = 0; t < wx.xsize[xx]; ++t) {
        const unsigned char* px = row + size_t(x0 + t) * 3;
        acc[0] += k[t] * px[0];
        acc[1] += k[t] * px[1];
        acc[2] += k[t] * px[2];
      }
      trow[xx * 3 + 0] = float(acc[0]);
      trow[xx * 3 + 1] = float(acc[1]);
      trow[xx * 3 + 2] = float(acc[2]);
    }
  }
  for (int yy = 0; yy < out_h; ++yy) {
    const double* k = &wy.coef[size_t(yy) * wy.ksize];
    const int y0 = wy.xmin[yy];
    unsigned char* orow = out + size_t(yy) * out_w * 3;
    for (int xx = 0; xx < out_w * 3; ++xx) {
      double acc = 0;
      for (int t = 0; t < wy.xsize[yy]; ++t) {
        acc += k[t] * tmp[size_t(y0 + t) * out_w * 3 + xx];
      }
      orow[xx] = ClampRound(acc);
    }
  }
}

}  // namespace

extern "C" {

// Decode n JPEG files and resize each to (out_h, out_w) RGB8, writing into
// out[n][out_h][out_w][3]. Work is split over n_threads. Returns the number
// of images that FAILED (their slots are zero-filled).
int reid_decode_resize_batch(const char** paths, int n, int out_h, int out_w,
                             unsigned char* out, int n_threads) {
  if (n <= 0) return 0;
  n_threads = std::max(1, std::min(n_threads, n));
  std::atomic<int> next(0), failures(0);
  const size_t img_bytes = size_t(out_h) * out_w * 3;
  auto worker = [&]() {
    std::vector<unsigned char> rgb;
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      int w = 0, h = 0;
      if (!DecodeJpeg(paths[i], &rgb, &w, &h)) {
        std::memset(out + i * img_bytes, 0, img_bytes);
        failures.fetch_add(1);
        continue;
      }
      ResizeBicubic(rgb.data(), h, w, out + i * img_bytes, out_h, out_w);
    }
  };
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return failures.load();
}

// Plain decode of one file into a caller buffer sized max_bytes; returns
// needed byte count, 0 on failure, or -needed if the buffer is too small.
long reid_decode_jpeg(const char* path, unsigned char* out, long max_bytes,
                      int* w, int* h) {
  std::vector<unsigned char> rgb;
  if (!DecodeJpeg(path, &rgb, w, h)) return 0;
  const long need = long(rgb.size());
  if (need > max_bytes) return -need;
  std::memcpy(out, rgb.data(), rgb.size());
  return need;
}
}

// ---------------------------------------------------------------------------
// Persistent worker pool: reid_decode_resize_batch spins threads up and down
// on every call; at production batch rates the pool lives for the whole
// sweep and batches are dispatched to already-parked workers. The Python
// BatchLoader's producer/queue provides the double buffering; this removes
// the per-batch thread churn underneath it.
// ---------------------------------------------------------------------------

namespace {

struct ReidPool {
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_work;   // workers wait for a new job
  std::condition_variable cv_done;   // caller waits for job completion
  // job description (valid while job_active)
  const char** paths = nullptr;
  int n = 0, out_h = 0, out_w = 0;
  unsigned char* out = nullptr;
  std::atomic<int> next{0};
  std::atomic<int> failures{0};
  int working = 0;        // workers still inside the current job
  long job_seq = 0;       // bumped per job; workers track the last seen seq
  bool stopping = false;

  void WorkerLoop() {
    long seen = 0;
    for (;;) {
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [&] { return stopping || job_seq != seen; });
        if (stopping) return;
        seen = job_seq;
      }
      const size_t img_bytes = size_t(out_h) * out_w * 3;
      std::vector<unsigned char> rgb;
      for (;;) {
        const int i = next.fetch_add(1);
        if (i >= n) break;
        int w = 0, h = 0;
        if (!DecodeJpeg(paths[i], &rgb, &w, &h)) {
          std::memset(out + i * img_bytes, 0, img_bytes);
          failures.fetch_add(1);
          continue;
        }
        ResizeBicubic(rgb.data(), h, w, out + i * img_bytes, out_h, out_w);
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        if (--working == 0) cv_done.notify_all();
      }
    }
  }
};

}  // namespace

extern "C" {

void* reid_pool_create(int n_threads) {
  auto* p = new ReidPool();
  n_threads = std::max(1, n_threads);
  p->workers.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) {
    p->workers.emplace_back([p] { p->WorkerLoop(); });
  }
  return p;
}

// Synchronous batch on the persistent pool; returns the failure count.
int reid_pool_run(void* pool, const char** paths, int n, int out_h,
                  int out_w, unsigned char* out) {
  auto* p = static_cast<ReidPool*>(pool);
  if (n <= 0) return 0;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->paths = paths;
    p->n = n;
    p->out_h = out_h;
    p->out_w = out_w;
    p->out = out;
    p->next.store(0);
    p->failures.store(0);
    p->working = int(p->workers.size());
    ++p->job_seq;
  }
  p->cv_work.notify_all();
  {
    std::unique_lock<std::mutex> lk(p->mu);
    p->cv_done.wait(lk, [&] { return p->working == 0; });
  }
  return p->failures.load();
}

void reid_pool_destroy(void* pool) {
  auto* p = static_cast<ReidPool*>(pool);
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stopping = true;
  }
  p->cv_work.notify_all();
  for (auto& t : p->workers) t.join();
  delete p;
}
}
