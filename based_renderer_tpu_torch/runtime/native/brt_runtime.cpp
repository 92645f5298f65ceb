// brt_runtime — native host runtime for based_renderer_tpu_torch, the
// PyTorch + CUDA package's own copy of based_renderer_tpu's runtime (the
// same C ABI).
//
// The reference implements its entire host runtime in C++ (window, frame
// pacing, batched GPU memory allocation, present machinery — see
// reference src/main.cpp).  The package keeps the device compute path in
// PyTorch and CUDA, and re-creates the *host-side* runtime natively here:
//
//  * brt_arena   — batched, alignment-grouped host buffer allocator, the
//                  capability analog of vulkan_allocate (main.cpp:153-584):
//                  callers describe N buffers up front; the arena lays them
//                  out at align_forward'ed offsets and makes ONE backing
//                  allocation per alignment class, then "binds" (returns)
//                  per-buffer offsets.  Used for readback staging rings.
//  * brt_pacer   — monotonic fixed-dt frame pacing + FPS stats, the analog
//                  of the display-frequency timestep + FPS overlay
//                  (main.cpp:1314-1319, 826-829).
//  * convert     — float32 RGBA -> uint8 framebuffer conversion.
//  * image IO    — PNG (via zlib) and PPM encoders for present/readback.
//  * brt_present — background present thread consuming a ring of frames
//                  (the swapchain/present-queue analog, main.cpp:2173-2184):
//                  submit never blocks while a slot is free; frames are
//                  converted and written (or dropped for display-less runs)
//                  off the Python thread.
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// Arena allocator (vulkan_allocate analog)
// ---------------------------------------------------------------------------

struct BrtArena {
  // one backing block per alignment class ("memory type")
  struct Group {
    size_t alignment;
    std::vector<size_t> sizes;      // requested buffer sizes
    std::vector<size_t> offsets;    // assigned offsets
    std::vector<uint32_t> indices;  // original request indices
    uint8_t* base = nullptr;
    size_t total = 0;
  };
  // dedicated allocations: own backing block per request (the analog of
  // the reference's vk::MemoryDedicatedAllocateInfo promotion of large /
  // flagged resources, main.cpp:379-398, 448-467)
  struct Dedicated {
    size_t size;
    size_t alignment;
    uint32_t index;
    uint8_t* base = nullptr;
  };
  std::vector<Group> groups;
  std::vector<Dedicated> dedicated;
  std::vector<uint8_t*> bound;  // per original request: final pointer
  bool finalized = false;
  // Requests at/above this size are promoted to dedicated blocks even
  // without the explicit flag (the reference promotes by size/flags).
  size_t dedicated_threshold = (size_t)32 << 20;  // 32 MiB
};

static size_t align_forward(size_t v, size_t a) {
  // power-of-two alignment, as in the reference's align_forward
  // (main.cpp:289-312).
  return (v + (a - 1)) & ~(a - 1);
}

BrtArena* brt_arena_create() { return new BrtArena(); }

// Request a buffer; returns its request index. Two-pass like the
// reference: requests first, one backing allocation per group afterwards.
// ``dedicated`` forces the request onto its own backing block; large
// requests (>= the arena's threshold) are promoted automatically, like
// the reference's size/flag-based dedicated-allocation path.
int32_t brt_arena_request_ex(BrtArena* a, uint64_t size, uint64_t alignment,
                             int32_t dedicated) {
  if (a == nullptr || a->finalized || size == 0) return -1;
  if (alignment == 0 || (alignment & (alignment - 1)) != 0) return -1;
  uint32_t index = (uint32_t)a->bound.size();
  a->bound.push_back(nullptr);
  if (dedicated != 0 || (size_t)size >= a->dedicated_threshold) {
    BrtArena::Dedicated d;
    d.size = size;
    d.alignment = alignment;
    d.index = index;
    a->dedicated.push_back(d);
    return (int32_t)index;
  }
  for (auto& g : a->groups) {
    if (g.alignment == alignment) {
      g.sizes.push_back(size);
      g.indices.push_back(index);
      return (int32_t)index;
    }
  }
  BrtArena::Group g;
  g.alignment = alignment;
  g.sizes.push_back(size);
  g.indices.push_back(index);
  a->groups.push_back(std::move(g));
  return (int32_t)index;
}

int32_t brt_arena_request(BrtArena* a, uint64_t size, uint64_t alignment) {
  return brt_arena_request_ex(a, size, alignment, 0);
}

void brt_arena_set_dedicated_threshold(BrtArena* a, uint64_t bytes) {
  // 0 disables automatic promotion (explicit requests still honored).
  if (a != nullptr && !a->finalized)
    a->dedicated_threshold = bytes ? (size_t)bytes : (size_t)-1;
}

// Lay out and allocate: one aligned backing block per group.
int32_t brt_arena_finalize(BrtArena* a) {
  if (a == nullptr || a->finalized) return -1;
  for (auto& g : a->groups) {
    size_t off = 0;
    g.offsets.resize(g.sizes.size());
    for (size_t i = 0; i < g.sizes.size(); ++i) {
      off = align_forward(off, g.alignment);
      g.offsets[i] = off;
      off += g.sizes[i];
    }
    g.total = off;
    g.base = (uint8_t*)aligned_alloc(g.alignment, align_forward(off, g.alignment));
    if (g.base == nullptr) return -2;
    for (size_t i = 0; i < g.sizes.size(); ++i) {
      a->bound[g.indices[i]] = g.base + g.offsets[i];
    }
  }
  for (auto& d : a->dedicated) {
    d.base = (uint8_t*)aligned_alloc(d.alignment, align_forward(d.size, d.alignment));
    if (d.base == nullptr) return -2;
    a->bound[d.index] = d.base;
  }
  a->finalized = true;
  return 0;
}

void* brt_arena_ptr(BrtArena* a, int32_t index) {
  if (a == nullptr || !a->finalized) return nullptr;
  if (index < 0 || (size_t)index >= a->bound.size()) return nullptr;
  return a->bound[index];
}

uint64_t brt_arena_total_bytes(BrtArena* a) {
  if (a == nullptr) return 0;
  uint64_t t = 0;
  for (auto& g : a->groups) t += g.total;
  for (auto& d : a->dedicated) t += d.size;
  return t;
}

int32_t brt_arena_num_groups(BrtArena* a) {
  return a ? (int32_t)a->groups.size() : -1;
}

int32_t brt_arena_num_dedicated(BrtArena* a) {
  return a ? (int32_t)a->dedicated.size() : -1;
}

void brt_arena_destroy(BrtArena* a) {
  if (a == nullptr) return;
  for (auto& g : a->groups) free(g.base);
  for (auto& d : a->dedicated) free(d.base);
  delete a;
}

// ---------------------------------------------------------------------------
// Frame pacer
// ---------------------------------------------------------------------------

struct BrtPacer {
  double fixed_dt;
  bool vsync;
  std::chrono::steady_clock::time_point last;
  std::chrono::steady_clock::time_point window_start;
  uint64_t window_frames = 0;
  double fps = 0.0;
  double t = 0.0;
};

BrtPacer* brt_pacer_create(double fixed_dt, int32_t vsync) {
  auto* p = new BrtPacer();
  p->fixed_dt = fixed_dt;
  p->vsync = vsync != 0;
  p->last = p->window_start = std::chrono::steady_clock::now();
  return p;
}

// Advance one frame; sleeps to the next slot when vsync; returns new t.
double brt_pacer_tick(BrtPacer* p) {
  using namespace std::chrono;
  auto now = steady_clock::now();
  if (p->vsync) {
    auto next = p->last + duration_cast<steady_clock::duration>(
                              duration<double>(p->fixed_dt));
    if (now < next) {
      std::this_thread::sleep_until(next);
      now = steady_clock::now();
    }
  }
  p->last = now;
  p->window_frames++;
  double window = duration<double>(now - p->window_start).count();
  if (window >= 0.5) {
    p->fps = (double)p->window_frames / window;
    p->window_frames = 0;
    p->window_start = now;
  }
  p->t += p->fixed_dt;
  return p->t;
}

double brt_pacer_fps(BrtPacer* p) { return p->fps; }
void brt_pacer_destroy(BrtPacer* p) { delete p; }

// ---------------------------------------------------------------------------
// Framebuffer conversion + image IO
// ---------------------------------------------------------------------------

// float32 [0,1] RGBA -> uint8, round-half-up with clipping (matches the
// Python FrameResult.color_u8 path).
void brt_f32_to_u8(const float* src, uint8_t* dst, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    float v = src[i] * 255.0f + 0.5f;
    v = v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v);
    dst[i] = (uint8_t)v;
  }
}

// Linear -> sRGB transfer function (IEC 61966-2-1).  Computed in double so
// the result is bit-identical to the Python utils/image.py path (both call
// this host's correctly-rounded libm pow on the same doubles).
static inline double srgb_encode1(double v) {
  if (v <= 0.0031308) return v * 12.92;
  return 1.055 * pow(v < 0.0 ? 0.0 : v, 1.0 / 2.4) - 0.055;
}

// RGBA quads: R, G, B get the sRGB transfer function, alpha stays linear —
// the semantics of a VK_FORMAT_*_SRGB swapchain image (the reference takes
// the first reported surface format, in practice *_SRGB:
// reference src/main.cpp:1338-1339).  n counts floats (4 per pixel).
void brt_f32_to_u8_srgb(const float* src, uint8_t* dst, int64_t n) {
  for (int64_t i = 0; i < n; ++i) {
    double v = (double)src[i];
    if ((i & 3) != 3) v = srgb_encode1(v);
    v = v * 255.0 + 0.5;
    v = v < 0.0 ? 0.0 : (v > 255.0 ? 255.0 : v);
    dst[i] = (uint8_t)v;
  }
}

static void put_be32(std::vector<uint8_t>& out, uint32_t v) {
  out.push_back((v >> 24) & 0xFF);
  out.push_back((v >> 16) & 0xFF);
  out.push_back((v >> 8) & 0xFF);
  out.push_back(v & 0xFF);
}

static void png_chunk(std::vector<uint8_t>& out, const char tag[4],
                      const uint8_t* data, size_t len) {
  put_be32(out, (uint32_t)len);
  size_t tag_pos = out.size();
  out.insert(out.end(), tag, tag + 4);
  out.insert(out.end(), data, data + len);
  uint32_t crc = crc32(0, out.data() + tag_pos, (uInt)(4 + len));
  put_be32(out, crc);
}

// Encode (h, w, c) uint8 image (c = 1/3/4) as PNG. Returns 0 on success.
int32_t brt_write_png(const char* path, const uint8_t* img, int32_t w,
                      int32_t h, int32_t c) {
  static const int color_types[] = {-1, 0, -1, 2, 6};
  if (c < 1 || c > 4 || color_types[c] < 0) return -1;
  // filter-0 scanlines
  std::vector<uint8_t> raw((size_t)h * (1 + (size_t)w * c));
  for (int y = 0; y < h; ++y) {
    uint8_t* row = raw.data() + (size_t)y * (1 + (size_t)w * c);
    row[0] = 0;
    memcpy(row + 1, img + (size_t)y * w * c, (size_t)w * c);
  }
  uLongf comp_cap = compressBound((uLong)raw.size());
  std::vector<uint8_t> comp(comp_cap);
  if (compress2(comp.data(), &comp_cap, raw.data(), (uLong)raw.size(), 6) != Z_OK)
    return -2;

  std::vector<uint8_t> out;
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  out.insert(out.end(), sig, sig + 8);
  uint8_t ihdr[13];
  ihdr[0] = (w >> 24) & 0xFF; ihdr[1] = (w >> 16) & 0xFF;
  ihdr[2] = (w >> 8) & 0xFF;  ihdr[3] = w & 0xFF;
  ihdr[4] = (h >> 24) & 0xFF; ihdr[5] = (h >> 16) & 0xFF;
  ihdr[6] = (h >> 8) & 0xFF;  ihdr[7] = h & 0xFF;
  ihdr[8] = 8;  // bit depth
  ihdr[9] = (uint8_t)color_types[c];
  ihdr[10] = ihdr[11] = ihdr[12] = 0;
  png_chunk(out, "IHDR", ihdr, 13);
  png_chunk(out, "IDAT", comp.data(), comp_cap);
  png_chunk(out, "IEND", nullptr, 0);

  FILE* f = fopen(path, "wb");
  if (!f) return -3;
  size_t n = fwrite(out.data(), 1, out.size(), f);
  fclose(f);
  return n == out.size() ? 0 : -4;
}

int32_t brt_write_ppm(const char* path, const uint8_t* rgb, int32_t w,
                      int32_t h) {
  FILE* f = fopen(path, "wb");
  if (!f) return -3;
  fprintf(f, "P6\n%d %d\n255\n", w, h);
  size_t n = fwrite(rgb, 1, (size_t)w * h * 3, f);
  fclose(f);
  return n == (size_t)w * h * 3 ? 0 : -4;
}

// ---------------------------------------------------------------------------
// Present ring (swapchain/present-queue analog)
// ---------------------------------------------------------------------------

struct BrtPresent {
  struct Frame {
    std::vector<float> rgba;  // owned copy (h*w*4)
    uint64_t index;
  };
  int32_t w = 0, h = 0, depth = 2;
  bool srgb = false;        // encode with the sRGB transfer function
  std::string out_dir;      // empty => display-less (convert + drop)
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv_submit, cv_done;
  std::deque<Frame> ring;
  std::atomic<bool> stop{false};
  std::atomic<uint64_t> presented{0};
  // Atomic: flush() reads it without the mutex (submit() increments under
  // the lock, but nothing ties the flushing thread to the submitting one).
  std::atomic<uint64_t> submitted{0};
};

static void present_worker(BrtPresent* p) {
  std::vector<uint8_t> u8((size_t)p->w * p->h * 4);
  for (;;) {
    BrtPresent::Frame frame;
    {
      std::unique_lock<std::mutex> lk(p->mu);
      p->cv_submit.wait(lk, [&] { return p->stop.load() || !p->ring.empty(); });
      if (p->ring.empty()) return;  // stop && drained
      frame = std::move(p->ring.front());
      p->ring.pop_front();
      p->cv_done.notify_all();
    }
    (p->srgb ? brt_f32_to_u8_srgb : brt_f32_to_u8)(
        frame.rgba.data(), u8.data(), (int64_t)p->w * p->h * 4);
    if (!p->out_dir.empty()) {
      char path[4096];
      snprintf(path, sizeof(path), "%s/frame_%06llu.png", p->out_dir.c_str(),
               (unsigned long long)frame.index);
      brt_write_png(path, u8.data(), p->w, p->h, 4);
    }
    p->presented.fetch_add(1);
  }
}

// srgb != 0 presents through the sRGB transfer function (the *_SRGB
// swapchain-format analog); 0 presents linear (UNORM).
BrtPresent* brt_present_create(int32_t w, int32_t h, int32_t depth,
                               const char* out_dir, int32_t srgb) {
  auto* p = new BrtPresent();
  p->w = w;
  p->h = h;
  p->depth = depth < 1 ? 1 : depth;
  p->srgb = srgb != 0;
  p->out_dir = out_dir ? out_dir : "";
  p->worker = std::thread(present_worker, p);
  return p;
}

// Submit a frame (copies rgba f32 data). Blocks only when the ring is full
// (the fence-wait analog). Returns the frame index.
uint64_t brt_present_submit(BrtPresent* p, const float* rgba) {
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv_done.wait(lk, [&] { return (int32_t)p->ring.size() < p->depth; });
  BrtPresent::Frame f;
  f.rgba.assign(rgba, rgba + (size_t)p->w * p->h * 4);
  f.index = p->submitted++;
  p->ring.push_back(std::move(f));
  p->cv_submit.notify_one();
  return f.index;
}

// Wait until all submitted frames are presented (vkDeviceWaitIdle analog).
void brt_present_flush(BrtPresent* p) {
  while (p->presented.load() < p->submitted) {
    std::this_thread::sleep_for(std::chrono::microseconds(100));
  }
}

uint64_t brt_present_count(BrtPresent* p) { return p->presented.load(); }

void brt_present_destroy(BrtPresent* p) {
  if (!p) return;
  brt_present_flush(p);
  p->stop.store(true);
  p->cv_submit.notify_all();
  p->worker.join();
  delete p;
}

}  // extern "C"
