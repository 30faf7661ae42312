// Native host-side data pipeline for the SLAM runtime.
//
// The reference drivers do all frame IO inline on the tracking thread with
// OpenCV (imread + remap per frame, reference src/VIOSlam.cpp:292-306, IMU
// CSV parse at 23-73). Here the same work is a small C++ library driven
// from Python via ctypes: grayscale PNG/PGM decode (libpng), bilinear
// rectification remap, EuRoC-format IMU CSV parsing, and a multi-threaded
// readahead prefetcher that keeps decoded+rectified frames ready in a ring
// buffer so the Python frame loop never blocks on disk or decode.
//
// Build: g++ -std=c++17 -O3 -shared -fPIC io_native.cc -o _io_native.so
//        -lpng -lpthread   (see vslam_tpu/native/__init__.py)

#include <png.h>

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// PNG decode (grayscale 8-bit out)
// ---------------------------------------------------------------------------

// Probe a PNG's dimensions. Returns 0 on success.
int vt_png_probe(const char* path, int* h, int* w) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return 1;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (!png || !info || setjmp(png_jmpbuf(png))) {
    if (png) png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return 2;
  }
  png_init_io(png, fp);
  png_read_info(png, info);
  *w = static_cast<int>(png_get_image_width(png, info));
  *h = static_cast<int>(png_get_image_height(png, info));
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  return 0;
}

// Decode a PNG to 8-bit grayscale into caller-provided (max_h x max_w)
// buffer `out` (row-major, tightly packed at the actual width). Writes the
// actual dims to h/w. Any color type is converted to gray (the reference
// converts BGR->gray per frame, src/FeatureTracker.cpp:1131-1145).
// Returns 0 on success.
int vt_png_read_gray(const char* path, uint8_t* out, int* h, int* w,
                     int max_h, int max_w) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return 1;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png_create_info_struct(png);
  if (!png || !info || setjmp(png_jmpbuf(png))) {
    if (png) png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return 2;
  }
  png_init_io(png, fp);
  png_read_info(png, info);

  png_uint_32 W = png_get_image_width(png, info);
  png_uint_32 H = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);
  if (static_cast<int>(H) > max_h || static_cast<int>(W) > max_w) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return 3;
  }

  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  if (color == PNG_COLOR_TYPE_RGB || color == PNG_COLOR_TYPE_RGB_ALPHA ||
      color == PNG_COLOR_TYPE_PALETTE) {
    // ITU-R BT.601 luma, matching cv::cvtColor COLOR_BGR2GRAY coefficients
    png_set_rgb_to_gray(png, PNG_ERROR_ACTION_NONE, 0.299, 0.587);
  }
  png_read_update_info(png, info);

  std::vector<png_bytep> rows(H);
  for (png_uint_32 y = 0; y < H; ++y) rows[y] = out + static_cast<size_t>(y) * W;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  *h = static_cast<int>(H);
  *w = static_cast<int>(W);
  return 0;
}

// ---------------------------------------------------------------------------
// Bilinear remap (rectification), uint8 -> uint8
// ---------------------------------------------------------------------------

// dst[y,x] = bilinear(src, my[y,x], mx[y,x]); out-of-range samples are 0
// (cv::remap BORDER_CONSTANT semantics used by the reference drivers).
void vt_remap_bilinear_u8(const uint8_t* src, int h, int w, const float* mx,
                          const float* my, uint8_t* dst, int oh, int ow) {
  for (int y = 0; y < oh; ++y) {
    const float* mxr = mx + static_cast<size_t>(y) * ow;
    const float* myr = my + static_cast<size_t>(y) * ow;
    uint8_t* drow = dst + static_cast<size_t>(y) * ow;
    for (int x = 0; x < ow; ++x) {
      float fx = mxr[x], fy = myr[x];
      int x0 = static_cast<int>(std::floor(fx));
      int y0 = static_cast<int>(std::floor(fy));
      if (x0 < -1 || y0 < -1 || x0 >= w || y0 >= h) {
        drow[x] = 0;
        continue;
      }
      float ax = fx - x0, ay = fy - y0;
      int x1 = x0 + 1, y1 = y0 + 1;
      auto at = [&](int yy, int xx) -> float {
        if (yy < 0 || yy >= h || xx < 0 || xx >= w) return 0.0f;
        return static_cast<float>(src[static_cast<size_t>(yy) * w + xx]);
      };
      float v = at(y0, x0) * (1 - ax) * (1 - ay) + at(y0, x1) * ax * (1 - ay) +
                at(y1, x0) * (1 - ax) * ay + at(y1, x1) * ax * ay;
      drow[x] = static_cast<uint8_t>(v + 0.5f);
    }
  }
}

// ---------------------------------------------------------------------------
// IMU CSV parse (EuRoC imu0/data.csv: t_ns, gx, gy, gz, ax, ay, az)
// ---------------------------------------------------------------------------

// Parses up to max_rows rows of 7 doubles into `out` (row-major), skipping
// '#' comments and blank lines; both ',' and whitespace separators accepted.
// Timestamps (col 0) are converted ns -> seconds, replicating reference
// getAllIMUData (src/VIOSlam.cpp:23-73). Returns the row count, or -1.
long vt_parse_imu_csv(const char* path, double* out, long max_rows) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return -1;
  char line[1024];
  long n = 0;
  while (n < max_rows && std::fgets(line, sizeof(line), fp)) {
    char* p = line;
    while (*p == ' ' || *p == '\t') ++p;
    if (*p == '#' || *p == '\n' || *p == '\r' || *p == 0) continue;
    double v[7];
    int got = 0;
    char* tok = std::strtok(p, ", \t\r\n");
    while (tok && got < 7) {
      v[got++] = std::strtod(tok, nullptr);
      tok = std::strtok(nullptr, ", \t\r\n");
    }
    if (got < 7) continue;
    v[0] *= 1e-9;  // ns -> s
    std::memcpy(out + n * 7, v, sizeof(v));
    ++n;
  }
  std::fclose(fp);
  return n;
}

// ---------------------------------------------------------------------------
// Threaded readahead prefetcher: decode (+ optional rectify) frames ahead
// ---------------------------------------------------------------------------

struct Prefetcher {
  std::vector<std::string> left, right;
  int h = 0, w = 0;
  bool stereo = false;
  std::vector<float> mxl, myl, mxr, myr;  // empty => no rectification
  int queue_cap = 4;

  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  // frames decoded out of order by workers, delivered in order
  struct Slot {
    std::vector<uint8_t> l, r;
    bool done = false;
  };
  std::vector<Slot> slots;           // one per frame index
  std::atomic<long> next_claim{0};   // next index a worker grabs
  long next_emit = 0;                // next index vt_prefetch_next returns
  long inflight_base = 0;            // emit cursor for backpressure
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  void worker() {
    std::vector<uint8_t> raw(static_cast<size_t>(h) * w);
    while (!stop.load()) {
      long i = next_claim.fetch_add(1);
      if (i >= static_cast<long>(left.size())) return;
      // backpressure: stay within queue_cap of the consumer
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_space.wait(lk, [&] { return stop.load() || i < next_emit + queue_cap; });
        if (stop.load()) return;
      }
      Slot s;
      s.l.resize(static_cast<size_t>(h) * w);
      int ah = 0, aw = 0;
      if (vt_png_read_gray(left[i].c_str(), raw.data(), &ah, &aw, h, w) == 0) {
        if (!mxl.empty()) {
          vt_remap_bilinear_u8(raw.data(), ah, aw, mxl.data(), myl.data(), s.l.data(), h, w);
        } else {
          std::memcpy(s.l.data(), raw.data(), s.l.size());
        }
      }
      if (stereo) {
        s.r.resize(static_cast<size_t>(h) * w);
        if (vt_png_read_gray(right[i].c_str(), raw.data(), &ah, &aw, h, w) == 0) {
          if (!mxr.empty()) {
            vt_remap_bilinear_u8(raw.data(), ah, aw, mxr.data(), myr.data(), s.r.data(), h, w);
          } else {
            std::memcpy(s.r.data(), raw.data(), s.r.size());
          }
        }
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        slots[i] = std::move(s);
        slots[i].done = true;
      }
      cv_ready.notify_all();
    }
  }
};

// paths are '\n'-joined blobs (simplest stable ABI for ctypes).
// maps (mxl/myl/mxr/myr) may be null for already-rectified datasets.
void* vt_prefetch_create(const char* left_blob, const char* right_blob,
                         int h, int w, const float* mxl, const float* myl,
                         const float* mxr, const float* myr, int n_threads,
                         int queue_cap) {
  auto* p = new Prefetcher();
  p->h = h;
  p->w = w;
  p->queue_cap = queue_cap > 0 ? queue_cap : 4;
  auto split = [](const char* blob, std::vector<std::string>& out) {
    if (!blob) return;
    const char* s = blob;
    while (*s) {
      const char* e = std::strchr(s, '\n');
      if (!e) {
        out.emplace_back(s);
        break;
      }
      if (e > s) out.emplace_back(s, e - s);
      s = e + 1;
    }
  };
  split(left_blob, p->left);
  split(right_blob, p->right);
  p->stereo = !p->right.empty();
  size_t hw = static_cast<size_t>(h) * w;
  if (mxl && myl) {
    p->mxl.assign(mxl, mxl + hw);
    p->myl.assign(myl, myl + hw);
  }
  if (mxr && myr) {
    p->mxr.assign(mxr, mxr + hw);
    p->myr.assign(myr, myr + hw);
  }
  p->slots.resize(p->left.size());
  int nt = n_threads > 0 ? n_threads : 2;
  for (int t = 0; t < nt; ++t) p->workers.emplace_back(&Prefetcher::worker, p);
  return p;
}

// Copies the next frame (in order) into caller buffers; returns its index,
// or -1 past the end. Blocks until the frame is decoded.
long vt_prefetch_next(void* hd, uint8_t* left, uint8_t* right) {
  auto* p = static_cast<Prefetcher*>(hd);
  std::unique_lock<std::mutex> lk(p->mu);
  if (p->next_emit >= static_cast<long>(p->left.size())) return -1;
  long i = p->next_emit;
  p->cv_ready.wait(lk, [&] { return p->slots[i].done; });
  std::memcpy(left, p->slots[i].l.data(), p->slots[i].l.size());
  if (right && p->stereo) std::memcpy(right, p->slots[i].r.data(), p->slots[i].r.size());
  p->slots[i].l.clear();
  p->slots[i].l.shrink_to_fit();
  p->slots[i].r.clear();
  p->slots[i].r.shrink_to_fit();
  p->next_emit = i + 1;
  lk.unlock();
  p->cv_space.notify_all();
  return i;
}

void vt_prefetch_destroy(void* hd) {
  auto* p = static_cast<Prefetcher*>(hd);
  p->stop.store(true);
  p->cv_space.notify_all();
  p->cv_ready.notify_all();
  for (auto& t : p->workers) t.join();
  delete p;
}

}  // extern "C"
