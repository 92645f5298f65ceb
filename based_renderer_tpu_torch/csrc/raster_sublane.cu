// Order-independent per-tile visibility rasterizer for Hopper (sm_90a).
//
// Replaces based_renderer_tpu/ops/raster_pallas.py:_raster_kernel_sublane,
// the TPU's sublane-parallel raster for dense meshes (and, as a route,
// _raster_kernel_batched).  It computes the same function, valid for depth
// test + write with an ordered compare (less, less_equal, greater,
// greater_equal), where the final buffer is a pure per-pixel reduction
// over the tile's records: among the records that cover a pixel (three
// edge values, stepped from the tile anchor, all >= 0; inside the scissor)
// and survive the depth clip or clamp, the winner is the nearest depth
// under the compare, and on an exact depth tie the earliest record for the
// strict compares and the latest for the *_equal ones
// (raster_pallas.py:795-808, 1050-1068).  The winner is then held against
// the init or clear depth with the compare itself; if it passes, the pixel
// takes its depth, its tri_id (int record row 13) and its float planes
// evaluated once as (p0 + pdx*x) + pdy*y; b2 is (1 - b0) - b1 wherever
// tri_id >= 0 and 0 elsewhere, invw 1 and the channels 0 where nothing
// won.  With band binning (raster_bin_rows) each band of tile rows has its
// own record list, anchored at the tile origin.
//
// Design.  One block per bin.  Each candidate (record, pixel) is one
// 64-bit key in shared memory, folded with atomicMin: an order-preserving
// uint32 of the depth (negated for the greater compares) above the
// record's index in the bin (complemented for the *_equal compares), so the
// minimum is exactly the winner above.
//   * Keys: one thread per record, which reads its 13 int fields straight
//     from the field-major stream (neighbouring threads, neighbouring
//     slots: coalesced; no staging, no barrier between records).  A bin
//     with fewer records than threads spreads each record's rows over up to
//     band_rows threads.  A record visits only the rows between its
//     triangle's least and greatest corner y (the pairwise crossings of its
//     edge lines, from exact 64-bit products), and per row it estimates
//     the covered x span from each edge's reciprocal, taken once per
//     record, and corrects each end by one exact integer step: no integer
//     division, no per-pixel edge test.
//   * Output: each thread takes 4 adjacent pixels of a tile row (one pixel
//     where the tile or frame width is not a multiple of 4), resolves each
//     against the init depth, gathers each winner's tri_id and plane rows
//     (the 4 pixels' loads in flight together), and writes every plane
//     with one 16-byte store.  A bin without records only writes.
// What bounds it on this card: the bytes of the 12 output planes at K = 6,
// which alone run at 89% of HBM on big_mesh at 1080p; beside them the key
// phase is instruction-bound in the fullest bins, whose serial per-thread
// work sets its length, and the winner gather is latency-bound (PERF.md).
// Hence the row range and the division-free spans, and no barrier or
// staging in the record loop.  A shared 64-bit atomicMin is a CAS loop on this card
// (ATOMS.CAST.SPIN.64); it costs little, a record covering ~1 pixel there.
// raster_group (the TPU's records per sublane group) has no counterpart
// here and changes nothing.
//
// Exactness: the binner clamps edge anchors to +/-(2^30 - 1) and steps
// are below 2^22 per pixel, so every edge value from one pixel left of a
// 128-px tile to one pixel right of it fits in int32 without wrapping; an
// edge is monotone along a row, so one integer test at each end of the
// float estimate (which is off by less than one pixel) gives the exact
// span.  The row range only skips rows no pixel of can be covered (see
// row_range).  Depth is stepped in 32-bit wrap-around arithmetic and rescaled in
// uint32, as in csrc/raster_tile.cu; the planes use __fmul_rn/__fadd_rn,
// so the output equals the plain PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kFields = 13;  // eb0..2, ax0..2, ay0..2, zo, dzx, dzy, zshift
constexpr int kQuad = 4;     // adjacent pixels one thread writes
constexpr int kDepthOneQ = 1 << 30;
constexpr int kAnchorClamp = (1 << 30) - 1;  // the binner's clamp of edge anchors
constexpr unsigned long long kEmpty = ~0ull;

enum { kLess = 1, kLessEqual = 3, kGreater = 4, kGreaterEqual = 6 };

struct Params {
  const int32_t* records;
  const float* frecords;
  int64_t stride;
  const int32_t* tile_start;
  const int32_t* tile_count;
  const int32_t* init_id;
  const int32_t* init_z;
  const float* init_b0;
  const float* init_b1;
  int32_t* out_i;
  float* out_f;
  int width, height, tile_w, tile_h, num_tx;
  int band_rows, bands, num_by, banded;
  int depth_op, depth_clip, clear_q;
  int num_channels;
  int has_scissor, sx0, sy0, sx1, sy1;
};

__device__ __forceinline__ bool depth_compare(int op, int z, int zbuf) {
  switch (op) {
    case kLess: return z < zbuf;
    case kLessEqual: return z <= zbuf;
    case kGreater: return z > zbuf;
    default: return z >= zbuf;  // kGreaterEqual
  }
}

// c + a*x in 32-bit wrap-around arithmetic (exact where it fits, see above).
__device__ __forceinline__ int edge_at(int c, int a, int x) {
  return (int)((uint32_t)c + (uint32_t)a * (uint32_t)x);
}

// Narrow [lo, hi] to the x in [0, n - 1] where c + a*x >= 0 (inv is
// __frcp_rn(a), 0 for a == 0).  The float root -c/a is off by less than
// one pixel wherever it matters (|root| <= n), so after clamping one exact
// integer step at the bound makes it exact, without a division.
__device__ __forceinline__ void clip_span(int c, int a, float inv, int n, int& lo, int& hi) {
  const float root = __fmul_rn(-__int2float_rn(c), inv);
  if (a > 0) {  // x >= root
    int x = (int)fminf(fmaxf(ceilf(root), 0.0f), (float)n);
    x -= x > 0 && edge_at(c, a, x - 1) >= 0;
    x += x < n && edge_at(c, a, x) < 0;
    lo = max(lo, x);
  } else if (a < 0) {  // x <= root
    int x = (int)fminf(fmaxf(floorf(root), -1.0f), (float)(n - 1));
    x -= x >= 0 && edge_at(c, a, x) < 0;
    x += x < n - 1 && edge_at(c, a, x + 1) >= 0;
    hi = min(hi, x);
  } else if (c < 0) {
    hi = -1;
  }
}

struct Record {
  int f[kFields];
};

__device__ __forceinline__ void load_record(const Params& p, int64_t slot, Record& r) {
#pragma unroll
  for (int k = 0; k < kFields; ++k) r.f[k] = __ldg(p.records + k * p.stride + slot);
}

// Band rows [lo, hi] that can hold a covered pixel: the rows between the
// least and the greatest y of the triangle's corners, each the crossing of
// two edges' zero lines, solved from exact 64-bit products in float (off by
// far less than the 1/64 px it is widened by).  An edge clamped at the
// tile anchor is not the triangle's own line, and parallel edges do not
// cross: such records keep the whole band, and the span test decides.
__device__ __forceinline__ void row_range(const Params& p, const Record& rec, int row0, int& lo, int& hi) {
  lo = 0;
  hi = p.band_rows - 1;
  float y_min = 256.0f, y_max = -256.0f;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const int f = e == 2 ? 0 : e + 1;
    if (abs(rec.f[e]) >= kAnchorClamp) return;
    const long long num = (long long)rec.f[3 + f] * rec.f[e] - (long long)rec.f[3 + e] * rec.f[f];
    const long long den = (long long)rec.f[3 + e] * rec.f[6 + f] - (long long)rec.f[3 + f] * rec.f[6 + e];
    if (den == 0) return;
    const float y = __fdividef(__ll2float_rn(num), __ll2float_rn(den));
    y_min = fminf(y_min, y);
    y_max = fmaxf(y_max, y);
  }
  lo = max(lo, (int)ceilf(fmaxf(y_min - 1.0f / 64, -1.0f)) - row0);
  hi = min(hi, (int)floorf(fminf(y_max + 1.0f / 64, 256.0f)) - row0);
}

// Fold one record's covered pixels in rows y0, y0 + step, ... of this
// band into the keys.
__device__ __forceinline__ void fold_record(const Params& p, const Record& rec, uint32_t idx_word,
                                            unsigned long long* keys, int row0, int py0, int x_lo,
                                            int x_hi, bool greater, int y0, int step) {
  int y_lo, y_hi;
  row_range(p, rec, row0, y_lo, y_hi);
  y_lo += (y0 - y_lo) & (step - 1);  // the first row of this item's set (step is a power of 2)
  if (y_lo > y_hi) return;
  float inv[3];
#pragma unroll
  for (int e = 0; e < 3; ++e) inv[e] = rec.f[3 + e] == 0 ? 0.0f : __frcp_rn(__int2float_rn(rec.f[3 + e]));
  const int dzx = rec.f[10];
  const int zshift = rec.f[12];
  const int hi_clamp = ((1 << 29) >> zshift) + 1;
  for (int y = y_lo; y <= y_hi; y += step) {
    const int iy = row0 + y;  // row within the tile: records are anchored at its origin
    if (p.has_scissor && (py0 + iy < p.sy0 || py0 + iy >= p.sy1)) continue;
    int lo = x_lo, hi = x_hi;
#pragma unroll
    for (int e = 0; e < 3; ++e)  // each edge from its value at x = 0 of this row
      clip_span(edge_at(rec.f[e], rec.f[6 + e], iy), rec.f[3 + e], inv[e], p.tile_w, lo, hi);
    if (lo > hi) continue;
    const uint32_t zrow = (uint32_t)rec.f[9] + (uint32_t)rec.f[11] * (uint32_t)iy;
    unsigned long long* key_row = keys + y * p.tile_w;
    for (int x = lo; x <= hi; ++x) {
      const int z_u = (int)(zrow + (uint32_t)dzx * (uint32_t)x);
      const int zc = min(max(z_u, -hi_clamp), hi_clamp);
      int z = (int)(((uint32_t)zc << zshift) + (1u << 29));
      if (p.depth_clip == 2) {
        z = min(max(z, 0), kDepthOneQ);
      } else if (p.depth_clip == 1 && (z < 0 || z > kDepthOneQ)) {
        continue;
      }
      const uint32_t zkey = (uint32_t)(greater ? -z : z) ^ 0x80000000u;
      const unsigned long long key = ((unsigned long long)zkey << 32) | idx_word;
      if (key < key_row[x]) atomicMin(key_row + x, key);
    }
  }
}

__device__ __forceinline__ float plane_at(const float* __restrict__ frec, int64_t stride,
                                          int64_t slot, int row, float ixf, float iyf) {
  const float p0 = __ldg(frec + row * stride + slot);
  const float pdx = __ldg(frec + (row + 1) * stride + slot);
  const float pdy = __ldg(frec + (row + 2) * stride + slot);
  return __fadd_rn(__fadd_rn(p0, __fmul_rn(pdx, ixf)), __fmul_rn(pdy, iyf));
}

// N (1 or kQuad) adjacent values of a plane, in one store.
template <int N, typename T>
__device__ __forceinline__ void store(T* dst, const T (&v)[N]) {
  if constexpr (N == kQuad) {
    using V = typename std::conditional<std::is_same<T, float>::value, float4, int4>::type;
    *reinterpret_cast<V*>(dst) = V{v[0], v[1], v[2], v[3]};
  } else {
    dst[0] = v[0];
  }
}

// Resolve, gather and write N adjacent pixels of a tile row, starting at
// tile column x0.  keys is null for a bin without records.
template <int N>
__device__ __forceinline__ void write_pixels(const Params& p, const unsigned long long* keys, int64_t start,
                                             int y, int x0, int row0, int px0, int py0, bool greater,
                                             bool strict) {
  const int iy = row0 + y;
  const int py = py0 + iy;
  const int px = px0 + x0;
  if (px >= p.width || py >= p.height) return;  // N = kQuad only where the width is a multiple of it
  const int64_t plane = (int64_t)p.width * p.height;
  const int64_t pix = (int64_t)py * p.width + px;
  const bool has_init = p.init_id != nullptr;
  int id[N], zbuf[N];
  int64_t win[N];
  float b0[N], b1[N], v[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    zbuf[j] = has_init ? p.init_z[pix + j] : p.clear_q;
    id[j] = has_init ? p.init_id[pix + j] : -1;
    b0[j] = has_init ? p.init_b0[pix + j] : 0.0f;
    b1[j] = has_init ? p.init_b1[pix + j] : 0.0f;
    win[j] = -1;
    const unsigned long long key = keys == nullptr ? kEmpty : keys[y * p.tile_w + x0 + j];
    if (key != kEmpty) {
      const int zm = (int)((uint32_t)(key >> 32) ^ 0x80000000u);
      const int z = greater ? -zm : zm;
      const uint32_t word = (uint32_t)key;
      if (depth_compare(p.depth_op, z, zbuf[j])) {
        zbuf[j] = z;
        win[j] = start + (strict ? word : ~word);
      }
    }
  }
  // Each plane's loads for the N pixels are in flight together.
  const float iyf = (float)iy;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (win[j] >= 0) {
      const float ixf = (float)(x0 + j);
      id[j] = __ldg(p.records + 13 * p.stride + win[j]);
      b0[j] = plane_at(p.frecords, p.stride, win[j], 0, ixf, iyf);
      b1[j] = plane_at(p.frecords, p.stride, win[j], 3, ixf, iyf);
    }
  }
  store<N>(p.out_i + pix, id);
  store<N>(p.out_i + plane + pix, zbuf);
  float* out = p.out_f + pix;
  store<N>(out, b0);
  store<N>(out + plane, b1);
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = id[j] >= 0 ? __fsub_rn(__fsub_rn(1.0f, b0[j]), b1[j]) : 0.0f;
  store<N>(out + 2 * plane, v);
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = win[j] >= 0 ? plane_at(p.frecords, p.stride, win[j], 6, (float)(x0 + j), iyf) : 1.0f;
  store<N>(out + 3 * plane, v);
  for (int c = 0; c < p.num_channels; ++c) {
#pragma unroll
    for (int j = 0; j < N; ++j)
      v[j] = win[j] >= 0 ? plane_at(p.frecords, p.stride, win[j], 9 + 3 * c, (float)(x0 + j), iyf) : 0.0f;
    store<N>(out + (4 + c) * plane, v);
  }
}

__global__ void __launch_bounds__(kThreads) raster_sublane_kernel(const Params p, const bool quads) {
  extern __shared__ unsigned long long keys[];  // (band_rows, tile_w)

  const int t = threadIdx.x;
  const int tile = blockIdx.x;
  const int band = blockIdx.y;
  const int tx = tile % p.num_tx;
  const int ty = tile / p.num_tx;
  const int bin = p.banded ? tx * p.num_by + ty * p.bands + band : tile;
  const int row0 = band * p.band_rows;  // first tile row of this band
  const int px0 = tx * p.tile_w;
  const int py0 = ty * p.tile_h;
  const int npix = p.band_rows * p.tile_w;
  const bool greater = p.depth_op == kGreater || p.depth_op == kGreaterEqual;
  const bool strict = p.depth_op == kLess || p.depth_op == kGreater;
  const int64_t start = p.tile_start[bin];
  const int count = p.tile_count[bin];

  if (count > 0) {  // block-uniform
    for (int i = t; i < npix; i += blockDim.x) keys[i] = kEmpty;
    // The scissor as a window of tile columns and a test on rows.
    int x_lo = 0, x_hi = p.tile_w - 1;
    if (p.has_scissor) {
      x_lo = max(x_lo, p.sx0 - px0);
      x_hi = min(x_hi, p.sx1 - 1 - px0);
    }
    __syncthreads();  // keys are set
    // A bin with few records spreads each record's rows over `groups`
    // threads (interleaved rows), so the block stays busy.
    int shift = 0;
    while ((1 << shift) < p.band_rows && count << (shift + 1) <= (int)blockDim.x) ++shift;
    const int groups = 1 << shift;
    const int items = count << shift;
    for (int w = t; w < items; w += blockDim.x) {
      Record rec;
      load_record(p, start + (w >> shift), rec);
      const uint32_t idx = (uint32_t)(w >> shift);
      fold_record(p, rec, strict ? idx : ~idx, keys, row0, py0, x_lo, x_hi, greater, w & (groups - 1), groups);
    }
    __syncthreads();
  }

  const unsigned long long* k = count > 0 ? keys : nullptr;
  if (quads) {
    for (int q = t; q < npix / kQuad; q += blockDim.x) {
      const int i = q * kQuad;
      const int y = i / p.tile_w;
      write_pixels<kQuad>(p, k, start, y, i - y * p.tile_w, row0, px0, py0, greater, strict);
    }
  } else {
    for (int i = t; i < npix; i += blockDim.x) {
      const int y = i / p.tile_w;
      write_pixels<1>(p, k, start, y, i - y * p.tile_w, row0, px0, py0, greater, strict);
    }
  }
}

bool aligned(const void* ptr) { return ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % (4 * kQuad) == 0; }

}  // namespace

extern "C" cudaError_t brt_raster_sublane(
    const void* records, const void* frecords, int64_t stride,
    const void* tile_start, const void* tile_count,
    const void* init_id, const void* init_z, const void* init_b0, const void* init_b1,
    void* out_i, void* out_f,
    int width, int height, int tile_w, int tile_h, int num_tx, int num_ty,
    int banded, int band_rows,
    int depth_op, int depth_clip, int clear_q,
    int num_channels,
    int has_scissor, int sx0, int sy0, int sx1, int sy1,
    void* stream) {
  if (tile_w <= 0 || tile_h <= 0 || 128 % tile_w || 128 % tile_h) return cudaErrorInvalidValue;
  if (band_rows <= 0 || tile_h % band_rows) return cudaErrorInvalidValue;
  if (depth_op != kLess && depth_op != kLessEqual && depth_op != kGreater && depth_op != kGreaterEqual)
    return cudaErrorInvalidValue;
  if (num_tx <= 0 || num_ty <= 0 || width <= 0 || height <= 0) return cudaSuccess;
  Params p;
  p.records = static_cast<const int32_t*>(records);
  p.frecords = static_cast<const float*>(frecords);
  p.stride = stride;
  p.tile_start = static_cast<const int32_t*>(tile_start);
  p.tile_count = static_cast<const int32_t*>(tile_count);
  p.init_id = static_cast<const int32_t*>(init_id);
  p.init_z = static_cast<const int32_t*>(init_z);
  p.init_b0 = static_cast<const float*>(init_b0);
  p.init_b1 = static_cast<const float*>(init_b1);
  p.out_i = static_cast<int32_t*>(out_i);
  p.out_f = static_cast<float*>(out_f);
  p.width = width;
  p.height = height;
  p.tile_w = tile_w;
  p.tile_h = tile_h;
  p.num_tx = num_tx;
  p.bands = tile_h / band_rows;
  p.band_rows = band_rows;
  p.num_by = num_ty * p.bands;
  p.banded = banded;
  p.depth_op = depth_op;
  p.depth_clip = depth_clip;
  p.clear_q = clear_q;
  p.num_channels = num_channels;
  p.has_scissor = has_scissor;
  p.sx0 = sx0;
  p.sy0 = sy0;
  p.sx1 = sx1;
  p.sy1 = sy1;
  // Vector stores of kQuad adjacent pixels need every group to start on
  // a (4 * kQuad)-byte boundary of every plane.
  const bool quads = tile_w % kQuad == 0 && width % kQuad == 0 && aligned(out_i) && aligned(out_f) &&
                     aligned(init_id) && aligned(init_z) && aligned(init_b0) && aligned(init_b1);
  const size_t smem = (size_t)band_rows * tile_w * sizeof(unsigned long long);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        raster_sublane_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(num_tx * num_ty, p.bands);
  raster_sublane_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p, quads);
  return cudaGetLastError();
}
