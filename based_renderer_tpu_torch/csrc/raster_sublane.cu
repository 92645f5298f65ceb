// Order-independent per-tile visibility rasterizer for Hopper (sm_90a).
//
// Replaces based_renderer_tpu/ops/raster_pallas.py:_raster_kernel_sublane,
// the TPU's sublane-parallel raster for dense meshes.  It computes the same
// function, valid for depth test + write with an ordered compare (less,
// less_equal, greater, greater_equal), where the final buffer is a pure
// per-pixel reduction over the tile's records: among the records that
// cover a pixel (three edge values, stepped from the tile anchor, all
// >= 0; inside the scissor) and survive the depth clip or clamp, the
// winner is the nearest depth under the compare, and on an exact depth tie
// the earliest record for the strict compares and the latest for the
// *_equal ones (raster_pallas.py:795-808, 1050-1068).  The winner is then
// held against the init or clear depth with the compare itself; if it
// passes, the pixel takes its depth, its tri_id (int record row 13) and
// its float planes evaluated once as (p0 + pdx*x) + pdy*y; b2 is
// (1 - b0) - b1 wherever tri_id >= 0 and 0 elsewhere, invw 1 and the
// channels 0 where nothing won.  With band binning (raster_bin_rows) each
// band of tile rows has its own record list, anchored at the tile origin.
//
// What bounds it on this card: the TPU (and csrc/raster_tile.cu) evaluate
// every record over every pixel of its tile, 1024 pixel tests per record
// on the dense mesh's 128x8 tiles, where a tiny triangle covers a handful.
// Order independence lets one tile's records spread over all threads of a
// block, so the design cuts that work instead: a thread takes one (record,
// tile row) pair, solves the three edge inequalities of that row exactly
// in integers for its covered x span (a few integer divisions in place of
// 128 pixel tests), and folds only the covered pixels into a per-pixel
// 64-bit key in shared memory with atomicMin.  The key orders by depth
// (high word, an order-preserving uint32 of the depth, negated for the
// greater compares) and then by record index (low word, complemented for
// the *_equal compares), so the minimum is exactly the winner above.  What
// remains is integer ALU per (record, row) and one streamed, coalesced read
// of the int records, staged through shared memory in chunks.  The TPU's
// one-hot MXU matmul that fetched the winner's planes becomes an indexed
// load.  Its CHUNK-aligned DMA window, leading-record skip, late +2^29
// bias and pre-shift clip window are not needed: each block reads exactly
// [tile_start, tile_start + tile_count) of its bin and computes depth as
// csrc/raster_tile.cu does.  raster_group (the TPU's records per sublane
// group) has no counterpart here and changes nothing.
//
// Exactness: the binner clamps edge anchors to +/-(2^30 - 1) and steps
// are below 2^22 per pixel, so every edge value within a 128-px tile fits
// in int32 without wrapping; an edge is then monotone along a row, and the
// integer span is exactly the set of x where the per-pixel test passes.
// Depth is stepped in 32-bit wrap-around arithmetic and rescaled in uint32,
// as in csrc/raster_tile.cu; the planes use __fmul_rn/__fadd_rn, so the
// output equals the plain PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 256;   // records staged in shared memory at a time
constexpr int kFields = 13;   // eb0..2, ax0..2, ay0..2, zo, dzx, dzy, zshift
constexpr int kDepthOneQ = 1 << 30;
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

__device__ __forceinline__ float plane_at(const float* __restrict__ frec, int64_t stride,
                                          int64_t slot, int row, float ixf, float iyf) {
  const float p0 = frec[row * stride + slot];
  const float pdx = frec[(row + 1) * stride + slot];
  const float pdy = frec[(row + 2) * stride + slot];
  return __fadd_rn(__fadd_rn(p0, __fmul_rn(pdx, ixf)), __fmul_rn(pdy, iyf));
}

__global__ void __launch_bounds__(kThreads) raster_sublane_kernel(const Params p) {
  extern __shared__ unsigned long long keys[];  // (band_rows, tile_w)
  __shared__ int32_t srec[kFields][kChunk];

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

  for (int i = t; i < npix; i += blockDim.x) keys[i] = kEmpty;

  // The scissor as a window of tile columns and a test on rows.
  int x_lo = 0, x_hi = p.tile_w - 1;
  if (p.has_scissor) {
    x_lo = max(x_lo, p.sx0 - px0);
    x_hi = min(x_hi, p.sx1 - 1 - px0);
  }

  const int start = p.tile_start[bin];
  const int count = p.tile_count[bin];
  for (int c0 = 0; c0 < count; c0 += kChunk) {
    const int n = min(kChunk, count - c0);
    __syncthreads();  // the previous chunk is done with srec (and keys are set)
    for (int r = t; r < n; r += blockDim.x) {
      const int64_t slot = (int64_t)start + c0 + r;
#pragma unroll
      for (int f = 0; f < kFields; ++f) srec[f][r] = p.records[f * p.stride + slot];
    }
    __syncthreads();
    const int items = n * p.band_rows;
    for (int w = t; w < items; w += blockDim.x) {
      const int r = w / p.band_rows;
      const int y = w - r * p.band_rows;
      const int iy = row0 + y;  // row within the tile: records are anchored at its origin
      if (p.has_scissor && (py0 + iy < p.sy0 || py0 + iy >= p.sy1)) continue;
      int lo = x_lo, hi = x_hi;
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        // The edge at x = 0 of this row.
        const int c = (int)((uint32_t)srec[e][r] + (uint32_t)srec[6 + e][r] * (uint32_t)iy);
        const int a = srec[3 + e][r];
        if (a > 0) {
          if (c < 0) lo = max(lo, (-c - 1) / a + 1);  // x >= ceil(-c / a)
        } else if (a < 0) {
          hi = c < 0 ? -1 : min(hi, c / -a);  // x <= floor(c / -a)
        } else if (c < 0) {
          hi = -1;
        }
      }
      if (lo > hi) continue;
      const int dzx = srec[10][r];
      const int zshift = srec[12][r];
      const uint32_t zrow = (uint32_t)srec[9][r] + (uint32_t)srec[11][r] * (uint32_t)iy;
      const int hi_clamp = ((1 << 29) >> zshift) + 1;
      const uint32_t idx = (uint32_t)(c0 + r);
      const uint32_t idx_word = strict ? idx : ~idx;
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
  __syncthreads();

  const int64_t plane = (int64_t)p.width * p.height;
  for (int i = t; i < npix; i += blockDim.x) {
    const int y = i / p.tile_w;
    const int x = i - y * p.tile_w;
    const int iy = row0 + y;
    const int px = px0 + x;
    const int py = py0 + iy;
    if (px >= p.width || py >= p.height) continue;
    const int64_t pix = (int64_t)py * p.width + px;
    const bool has_init = p.init_id != nullptr;
    int zbuf = has_init ? p.init_z[pix] : p.clear_q;
    int id = has_init ? p.init_id[pix] : -1;
    int64_t win = -1;
    const unsigned long long key = keys[i];
    if (key != kEmpty) {
      const int zm = (int)((uint32_t)(key >> 32) ^ 0x80000000u);
      const int z = greater ? -zm : zm;
      const uint32_t word = (uint32_t)key;
      const int64_t slot = (int64_t)start + (strict ? word : ~word);
      if (depth_compare(p.depth_op, z, zbuf)) {
        zbuf = z;
        win = slot;
        id = p.records[13 * p.stride + slot];
      }
    }
    p.out_i[pix] = id;
    p.out_i[plane + pix] = zbuf;
    float* out = p.out_f + pix;
    if (win >= 0) {
      const float ixf = (float)x;
      const float iyf = (float)iy;
      const float b0 = plane_at(p.frecords, p.stride, win, 0, ixf, iyf);
      const float b1 = plane_at(p.frecords, p.stride, win, 3, ixf, iyf);
      out[0] = b0;
      out[plane] = b1;
      out[2 * plane] = __fsub_rn(__fsub_rn(1.0f, b0), b1);
      out[3 * plane] = plane_at(p.frecords, p.stride, win, 6, ixf, iyf);
      for (int c = 0; c < p.num_channels; ++c)
        out[(4 + c) * plane] = plane_at(p.frecords, p.stride, win, 9 + 3 * c, ixf, iyf);
    } else {
      const float b0 = has_init ? p.init_b0[pix] : 0.0f;
      const float b1 = has_init ? p.init_b1[pix] : 0.0f;
      out[0] = b0;
      out[plane] = b1;
      out[2 * plane] = id >= 0 ? __fsub_rn(__fsub_rn(1.0f, b0), b1) : 0.0f;
      out[3 * plane] = 1.0f;
      for (int c = 0; c < p.num_channels; ++c) out[(4 + c) * plane] = 0.0f;
    }
  }
}

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
  const size_t smem = (size_t)band_rows * tile_w * sizeof(unsigned long long);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        raster_sublane_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(num_tx * num_ty, p.bands);
  raster_sublane_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}
