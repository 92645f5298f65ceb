// brt_runtime — native host runtime for based_renderer_tpu_torch, the
// PyTorch + CUDA package's own copy of the present path of
// based_renderer_tpu's runtime (its C ABI, plus the present ring's records).
//
// The reference implements its entire host runtime in C++ (window, frame
// pacing, batched GPU memory allocation, present machinery — see
// reference src/main.cpp).  The package keeps the device compute path in
// PyTorch and CUDA, and the present path's host side natively here:
//
//  * convert     — float32 RGBA -> uint8 framebuffer conversion (one SSE2
//                  pass, bit-identical to its scalar tail).
//  * image IO    — PNG (via zlib) and PPM encoders for present/readback.
//  * brt_present — background present thread consuming a ring of frames
//                  (the swapchain/present-queue analog, main.cpp:2173-2184)
//                  in u8 slots pooled at creation.  submit blocks only
//                  while depth frames wait, then converts the caller's f32
//                  frame straight into a slot as it reads it.  The thread
//                  writes PNGs (or drops frames, display-less) off the
//                  Python thread and returns the slots; each frame's phases
//                  are stamped on both threads (brt_present_records).
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

#if defined(__SSE2__)
#include <emmintrin.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// Framebuffer conversion + image IO
// ---------------------------------------------------------------------------

// float32 [0,1] RGBA -> uint8, round-half-up with clipping (matches the
// Python FrameResult.color_u8 path): v * 255 and + 0.5 rounded apart (no
// FMA: -ffp-contract=off), clamped to [0, 255], truncated.  NaN gives 0.
static inline uint8_t f32_to_u8_1(float s) {
  float v = s * 255.0f + 0.5f;
  return (uint8_t)(v > 0.0f ? (v < 255.0f ? v : 255.0f) : 0.0f);
}

// Sixteen floats a step in SSE2 (x86-64's baseline), the rest scalar; both
// give the same bytes.  maxps returns its second operand when one is NaN,
// so NaN clamps to 0 as the scalar compare does.  Unaligned loads and
// stores: any source and destination address.  A frame arrives cold (the
// card's copy wrote it), and one thread's read of it is bound by the
// misses in flight, so each step prefetches the line a page ahead.
void brt_f32_to_u8(const float* src, uint8_t* dst, int64_t n) {
  int64_t i = 0;
#if defined(__SSE2__)
  const int64_t ahead = 1024;  // floats: 4 KiB
  const __m128 scale = _mm_set1_ps(255.0f), half = _mm_set1_ps(0.5f);
  const __m128 lo = _mm_setzero_ps(), hi = _mm_set1_ps(255.0f);
  for (; i + 16 <= n; i += 16) {
    _mm_prefetch((const char*)(src + std::min(i + ahead, n - 1)), _MM_HINT_T0);
    __m128i q[4];
    for (int k = 0; k < 4; ++k) {
      __m128 v = _mm_add_ps(_mm_mul_ps(_mm_loadu_ps(src + i + 4 * k), scale), half);
      q[k] = _mm_cvttps_epi32(_mm_min_ps(_mm_max_ps(v, lo), hi));
    }
    __m128i b = _mm_packus_epi16(_mm_packs_epi32(q[0], q[1]), _mm_packs_epi32(q[2], q[3]));
    _mm_storeu_si128((__m128i*)(dst + i), b);
  }
#endif
  for (; i < n; ++i) dst[i] = f32_to_u8_1(src[i]);
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

// Per-frame stamps of the ring, in ns on std::chrono::system_clock (the
// clock torch.profiler stamps its host events on), kept in a fixed ring of
// kPresentRecords records and read out by brt_present_records.  A stamp a
// frame did not reach (written, without an out_dir) is 0.
struct BrtPresentRecord {
  uint64_t index;
  uint64_t enter;      // submit entered
  uint64_t room;       // a place in the ring and a slot were free
  uint64_t copied;     // the frame converted into its slot
  uint64_t popped;     // the worker took the frame
  uint64_t converted;  // at once: nothing is left to convert
  uint64_t written;    // the PNG written
  uint64_t freed;      // the slot returned
};
static const uint64_t kPresentRecords = 4096;

static size_t align_forward(size_t v, size_t a) {
  // power-of-two alignment, as in the reference's align_forward
  // (main.cpp:289-312).
  return (v + (a - 1)) & ~(a - 1);
}

static uint64_t now_ns() {
  return (uint64_t)std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::system_clock::now().time_since_epoch())
      .count();
}

struct BrtPresent {
  struct Frame {
    uint8_t* slot;  // h*w*4 u8
    uint64_t index;
  };
  int32_t w = 0, h = 0, depth = 2;
  bool srgb = false;        // encode with the sRGB transfer function
  std::string out_dir;      // empty => display-less (drop)
  std::thread worker;
  std::mutex mu;
  std::mutex submit_mu;     // one submit at a time: frames queue in index order
  std::condition_variable cv_submit, cv_done;
  std::deque<Frame> ring;
  // depth + 1 slots, allocated and touched once.  A frame holds one from
  // room to freed; when a submit takes one, at most depth - 1 wait and one
  // is with the worker, so a slot is free.
  std::vector<uint8_t> pool;
  std::vector<uint8_t*> free_slots;  // (mu)
  std::atomic<bool> stop{false};
  std::atomic<uint64_t> presented{0};
  // Atomic: flush() reads it without the mutex (submit() increments under
  // the lock, but nothing ties the flushing thread to the submitting one).
  std::atomic<uint64_t> submitted{0};
  // records[i % kPresentRecords] is frame i's.  submit writes its stamps
  // under mu as the frame is queued; the worker writes the rest before
  // presented passes the frame.  A frame below presented is complete.
  std::vector<BrtPresentRecord> records =
      std::vector<BrtPresentRecord>(kPresentRecords);
  uint64_t read = 0;  // the next record brt_present_records hands out (mu)
};

static void present_worker(BrtPresent* p) {
  for (;;) {
    BrtPresent::Frame frame;
    uint64_t popped;
    {
      std::unique_lock<std::mutex> lk(p->mu);
      p->cv_submit.wait(lk, [&] { return p->stop.load() || !p->ring.empty(); });
      if (p->ring.empty()) return;  // stop && drained
      frame = p->ring.front();
      p->ring.pop_front();
      popped = now_ns();
      p->cv_done.notify_all();
    }
    BrtPresentRecord& rec = p->records[frame.index % kPresentRecords];
    rec.popped = popped;
    rec.converted = now_ns();
    if (!p->out_dir.empty()) {
      char path[4096];
      snprintf(path, sizeof(path), "%s/frame_%06llu.png", p->out_dir.c_str(),
               (unsigned long long)frame.index);
      brt_write_png(path, frame.slot, p->w, p->h, 4);
      rec.written = now_ns();
    }
    {
      std::lock_guard<std::mutex> lk(p->mu);
      p->free_slots.push_back(frame.slot);
      p->cv_done.notify_all();
    }
    rec.freed = now_ns();
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
  size_t slot = align_forward((size_t)w * h * 4, 64);
  size_t slots = (size_t)p->depth + 1;
  p->pool.resize(slots * slot + 64);  // zeroed: every page touched here
  uint8_t* base = p->pool.data() + (-(uintptr_t)p->pool.data() & 63);
  for (size_t i = 0; i < slots; ++i) p->free_slots.push_back(base + i * slot);
  p->worker = std::thread(present_worker, p);
  return p;
}

// Submit a frame: converts rgba f32 into a u8 slot, so the caller's buffer
// is free on return.  Blocks only while depth frames wait (the fence-wait
// analog).  Returns the frame index.
uint64_t brt_present_submit(BrtPresent* p, const float* rgba) {
  uint64_t enter = now_ns();
  std::lock_guard<std::mutex> order(p->submit_mu);
  BrtPresent::Frame f;
  uint64_t room;
  {
    std::unique_lock<std::mutex> lk(p->mu);
    p->cv_done.wait(lk, [&] {
      return (int32_t)p->ring.size() < p->depth && !p->free_slots.empty();
    });
    room = now_ns();
    f.slot = p->free_slots.back();
    p->free_slots.pop_back();
    f.index = p->submitted++;
  }
  // outside mu: the worker pops, writes and returns slots meanwhile
  (p->srgb ? brt_f32_to_u8_srgb : brt_f32_to_u8)(rgba, f.slot,
                                                 (int64_t)p->w * p->h * 4);
  uint64_t copied = now_ns();
  std::lock_guard<std::mutex> lk(p->mu);
  p->records[f.index % kPresentRecords] =
      BrtPresentRecord{f.index, enter, room, copied, 0, 0, 0, 0};
  p->ring.push_back(f);
  p->cv_submit.notify_one();
  return f.index;
}

// Copy the records of presented frames not yet read, oldest first, into
// out (max records of 8 uint64: index, enter, room, copied, popped,
// converted, written, freed); returns how many.  Frames older than the
// record ring holds are skipped.
int32_t brt_present_records(BrtPresent* p, uint64_t* out, int32_t max) {
  std::lock_guard<std::mutex> lk(p->mu);
  uint64_t end = p->presented.load();
  // the slots of frames still in flight (at most depth + 1) are not read
  uint64_t keep = kPresentRecords - (uint64_t)p->depth - 1;
  uint64_t start = std::max(p->read, end > keep ? end - keep : 0);
  int32_t n = 0;
  for (uint64_t i = start; i < end && n < max; ++i, ++n) {
    memcpy(out + (size_t)n * 8, &p->records[i % kPresentRecords],
           sizeof(BrtPresentRecord));
  }
  p->read = start + (uint64_t)n;
  return n;
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
