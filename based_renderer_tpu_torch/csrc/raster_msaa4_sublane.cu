// Order-independent coverage MSAA-4x per-tile rasterizer for Hopper (sm_90a).
//
// Replaces based_renderer_tpu/ops/raster_pallas.py:_raster_kernel_msaa4_sublane,
// the TPU's sublane-parallel MSAA raster for dense meshes.  It computes
// csrc/raster_sublane.cu's function once per sample layer, valid for depth
// test + write with an ordered compare (less, less_equal, greater,
// greater_equal): for each of a pixel's four samples (ops/fixedpoint.py
// MSAA4_OFFSETS), among the records of its tile that cover the sample (the
// pixel-center edge values, stepped from the tile anchor, plus the
// per-record sample offsets o_i = A_i*ddx + B_i*ddy from the raw
// coefficients in rows 16-21, all >= 0; inside the scissor) and survive the
// depth clip or clamp, the winner is the nearest depth under the compare,
// and on an exact depth tie the earliest record for the strict compares and
// the latest for the *_equal ones.  A sample's depth is the pixel-center
// plane value plus dz = (dzdx*ddx + dzdy*ddy) >> 4 (arithmetic shift),
// taken before the +/-hi clamp and the rescale.  The winner is then held
// against the sample's init or clear depth with the compare itself
// (raster_pallas.py:1359-1378); if it passes, the sample takes its depth,
// its tri_id (int record row 13) and its float planes evaluated once at the
// pixel CENTER as (p0 + pdx*x) + pdy*y; b2 is (1 - b0) - b1 wherever
// tri_id >= 0 and 0 elsewhere, invw 1 and the channels 0 where nothing won.
//
// What bounds it on this card: as for csrc/raster_sublane.cu, the integer
// work of solving each (record, tile row)'s covered x span and folding the
// covered pixels into shared-memory keys, here four times (one span solve
// and one key plane per sample), plus one streamed read of the int records
// and one coalesced write of 4 x (6 + K) output planes.  The design: a
// thread takes one (record, tile row) item, steps the row's three edge
// constants and its depth once, and for each sample solves the edge
// inequalities of the row exactly in integers with the constants shifted
// by that sample's offsets (the sample's edge along a row is the same line
// moved by a per-record constant), then folds the covered pixels into that
// sample's 64-bit (depth, record index) key plane with atomicMin.  The
// per-sample offsets depend only on the record, so they are computed once
// when the record is staged.  The TPU's lane-widened one-hot MXU fetch of
// the winners' planes becomes an indexed load, once per distinct winner of
// a pixel's samples.  raster_group has no counterpart and changes nothing.
//
// Shared memory: the four key planes of an 8-row band of a 128-wide tile
// take 4 x 8 x 128 x 8 B = 32 KB, and 128 staged records of 29 fields take
// 14,848 B: 47,616 B of static shared memory, under the 48 KB a launch may
// use without opting in.  A taller tile is split into 8-row bands, one
// block each, every band reading its tile's whole record list.
//
// Exactness: the binner clamps edge anchors to +/-(2^30 - 1); with the
// sample offsets every per-sample edge value within a 128-px tile stays in
// int32 (ops/fixedpoint.py's proof), so each sample edge is monotone along
// a row and the integer span is exactly the set of x where the per-pixel
// test passes.  Depth is stepped in 32-bit wrap-around arithmetic and
// rescaled in uint32; the planes use __fmul_rn/__fadd_rn, so the output
// equals the plain PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSamples = 4;
constexpr int kThreads = 256;
constexpr int kTileW = 128;   // the sublane route requires tile_w == 128
constexpr int kBandRows = 8;  // tile rows per block
constexpr int kChunk = 128;   // records staged in shared memory at a time
// Staged per record: eb0..2, ax0..2, ay0..2, zo, dzx, dzy, zshift (rows
// 0-12), then per sample s the edge offsets o0..o2 and the depth offset dz.
constexpr int kRecFields = 13;
constexpr int kFields = kRecFields + 4 * kSamples;
constexpr int kDepthOneQ = 1 << 30;
constexpr unsigned long long kEmpty = ~0ull;

enum { kLess = 1, kLessEqual = 3, kGreater = 4, kGreaterEqual = 6 };

struct Params {
  const int32_t* records;  // (>= 22, stride)
  const float* frecords;   // (>= 9 + 3K, stride)
  int64_t stride;
  const int32_t* tile_start;
  const int32_t* tile_count;
  const int32_t* init_id;  // (4, H, W) or null
  const int32_t* init_z;
  const float* init_b0;
  const float* init_b1;
  int32_t* out_i;          // (2, 4, H, W)
  float* out_f;            // (4 + K, 4, H, W)
  int width, height, tile_h, num_tx, band_rows;
  int depth_op, depth_clip, clear_q;
  int num_channels;
  int has_scissor, sx0, sy0, sx1, sy1;
  int ddx[kSamples], ddy[kSamples];  // MSAA4_OFFSETS, 1/16 px from the pixel center
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

__global__ void __launch_bounds__(kThreads) raster_msaa4_sublane_kernel(const Params p) {
  __shared__ unsigned long long keys[kSamples][kBandRows][kTileW];
  __shared__ int32_t srec[kFields][kChunk];

  const int t = threadIdx.x;
  const int tile = blockIdx.x;
  const int tx = tile % p.num_tx;
  const int ty = tile / p.num_tx;
  const int row0 = blockIdx.y * p.band_rows;  // first tile row of this block
  const int px0 = tx * kTileW;
  const int py0 = ty * p.tile_h;
  const int npix = p.band_rows * kTileW;
  const bool greater = p.depth_op == kGreater || p.depth_op == kGreaterEqual;
  const bool strict = p.depth_op == kLess || p.depth_op == kGreater;

  for (int i = t; i < kSamples * npix; i += blockDim.x) {
    const int s = i / npix;
    const int j = i - s * npix;
    keys[s][j / kTileW][j % kTileW] = kEmpty;
  }

  // The scissor as a window of tile columns and a test on rows.
  int x_lo = 0, x_hi = kTileW - 1;
  if (p.has_scissor) {
    x_lo = max(x_lo, p.sx0 - px0);
    x_hi = min(x_hi, p.sx1 - 1 - px0);
  }

  const int start = p.tile_start[tile];
  const int count = p.tile_count[tile];
  for (int c0 = 0; c0 < count; c0 += kChunk) {
    const int n = min(kChunk, count - c0);
    __syncthreads();  // the previous chunk is done with srec (and keys are set)
    for (int r = t; r < n; r += blockDim.x) {
      const int64_t slot = (int64_t)start + c0 + r;
#pragma unroll
      for (int f = 0; f < kRecFields; ++f) srec[f][r] = p.records[f * p.stride + slot];
      int a[3], b[3];
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        a[e] = p.records[(16 + e) * p.stride + slot];
        b[e] = p.records[(19 + e) * p.stride + slot];
      }
      const int dzx = srec[10][r];
      const int dzy = srec[11][r];
#pragma unroll
      for (int s = 0; s < kSamples; ++s) {
        const int ddx = p.ddx[s], ddy = p.ddy[s];
#pragma unroll
        for (int e = 0; e < 3; ++e) srec[kRecFields + 4 * s + e][r] = a[e] * ddx + b[e] * ddy;
        srec[kRecFields + 4 * s + 3][r] = (dzx * ddx + dzy * ddy) >> 4;  // arithmetic: floor
      }
    }
    __syncthreads();
    const int items = n * p.band_rows;
    for (int w = t; w < items; w += blockDim.x) {
      const int r = w / p.band_rows;
      const int y = w - r * p.band_rows;
      const int iy = row0 + y;  // row within the tile: records are anchored at its origin
      if (p.has_scissor && (py0 + iy < p.sy0 || py0 + iy >= p.sy1)) continue;
      int c[3], a[3];
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        c[e] = (int)((uint32_t)srec[e][r] + (uint32_t)srec[6 + e][r] * (uint32_t)iy);  // edge at x = 0
        a[e] = srec[3 + e][r];
      }
      const int dzx = srec[10][r];
      const int zshift = srec[12][r];
      const uint32_t zrow = (uint32_t)srec[9][r] + (uint32_t)srec[11][r] * (uint32_t)iy;
      const int hi_clamp = ((1 << 29) >> zshift) + 1;
      const uint32_t idx = (uint32_t)(c0 + r);
      const uint32_t idx_word = strict ? idx : ~idx;
#pragma unroll
      for (int s = 0; s < kSamples; ++s) {
        const int f = kRecFields + 4 * s;
        int lo = x_lo, hi = x_hi;
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          const int cs = (int)((uint32_t)c[e] + (uint32_t)srec[f + e][r]);  // the sample's edge at x = 0
          if (a[e] > 0) {
            if (cs < 0) lo = max(lo, (-cs - 1) / a[e] + 1);  // x >= ceil(-cs / a)
          } else if (a[e] < 0) {
            hi = cs < 0 ? -1 : min(hi, cs / -a[e]);  // x <= floor(cs / -a)
          } else if (cs < 0) {
            hi = -1;
          }
        }
        if (lo > hi) continue;
        const uint32_t zs = zrow + (uint32_t)srec[f + 3][r];
        unsigned long long* key_row = keys[s][y];
        for (int x = lo; x <= hi; ++x) {
          const int z_u = (int)(zs + (uint32_t)dzx * (uint32_t)x);
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
  }
  __syncthreads();

  const int64_t hw = (int64_t)p.width * p.height;
  const int64_t plane = kSamples * hw;  // one output plane holds 4 sample layers
  const bool has_init = p.init_id != nullptr;
  for (int i = t; i < npix; i += blockDim.x) {
    const int y = i / kTileW;
    const int x = i - y * kTileW;
    const int iy = row0 + y;
    const int px = px0 + x;
    const int py = py0 + iy;
    if (px >= p.width || py >= p.height) continue;
    const int64_t pix = (int64_t)py * p.width + px;
    const float ixf = (float)x;
    const float iyf = (float)iy;
    int64_t win[kSamples];
    float b0 = 0.0f, b1 = 0.0f;
    int64_t last = -1;
#pragma unroll
    for (int s = 0; s < kSamples; ++s) {
      const int64_t o = s * hw + pix;
      int zbuf = has_init ? p.init_z[o] : p.clear_q;
      int id = has_init ? p.init_id[o] : -1;
      win[s] = -1;
      const unsigned long long key = keys[s][y][x];
      if (key != kEmpty) {
        const int zm = (int)((uint32_t)(key >> 32) ^ 0x80000000u);
        const int z = greater ? -zm : zm;
        const uint32_t word = (uint32_t)key;
        const int64_t slot = (int64_t)start + (strict ? word : ~word);
        if (depth_compare(p.depth_op, z, zbuf)) {
          zbuf = z;
          win[s] = slot;
          id = p.records[13 * p.stride + slot];
        }
      }
      p.out_i[o] = id;
      p.out_i[plane + o] = zbuf;
      if (win[s] >= 0) {
        if (win[s] != last) {  // samples usually share a winner: evaluate once
          b0 = plane_at(p.frecords, p.stride, win[s], 0, ixf, iyf);
          b1 = plane_at(p.frecords, p.stride, win[s], 3, ixf, iyf);
          last = win[s];
        }
        p.out_f[o] = b0;
        p.out_f[plane + o] = b1;
        p.out_f[2 * plane + o] = __fsub_rn(__fsub_rn(1.0f, b0), b1);
      } else {
        const float ib0 = has_init ? p.init_b0[o] : 0.0f;
        const float ib1 = has_init ? p.init_b1[o] : 0.0f;
        p.out_f[o] = ib0;
        p.out_f[plane + o] = ib1;
        p.out_f[2 * plane + o] = id >= 0 ? __fsub_rn(__fsub_rn(1.0f, ib0), ib1) : 0.0f;
      }
    }
    // invw and the channels, each distinct winner's value evaluated once.
    for (int c = -1; c < p.num_channels; ++c) {
      const int row = 9 + 3 * c;  // c = -1: the invw plane (row 6)
      const float none = c < 0 ? 1.0f : 0.0f;
      float* out = p.out_f + (int64_t)(4 + c) * plane + pix;
      int64_t prev = -1;
      float v = none;
#pragma unroll
      for (int s = 0; s < kSamples; ++s) {
        if (win[s] < 0) {
          out[s * hw] = none;
          continue;
        }
        if (win[s] != prev) {
          v = plane_at(p.frecords, p.stride, win[s], row, ixf, iyf);
          prev = win[s];
        }
        out[s * hw] = v;
      }
    }
  }
}

}  // namespace

extern "C" cudaError_t brt_raster_msaa4_sublane(
    const void* records, const void* frecords, int64_t stride,
    const void* tile_start, const void* tile_count,
    const void* init_id, const void* init_z, const void* init_b0, const void* init_b1,
    void* out_i, void* out_f,
    int width, int height, int tile_w, int tile_h, int num_tx, int num_ty,
    int depth_op, int depth_clip, int clear_q,
    int num_channels,
    int has_scissor, int sx0, int sy0, int sx1, int sy1,
    const int32_t* sample_offsets,  // host (ddx, ddy) x 4: ops/fixedpoint.py MSAA4_OFFSETS
    void* stream) {
  if (tile_w != kTileW || tile_h <= 0 || 128 % tile_h) return cudaErrorInvalidValue;
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
  p.tile_h = tile_h;
  p.num_tx = num_tx;
  p.band_rows = tile_h < kBandRows ? tile_h : kBandRows;  // powers of two: divides tile_h
  p.depth_op = depth_op;
  p.depth_clip = depth_clip;
  p.clear_q = clear_q;
  p.num_channels = num_channels;
  p.has_scissor = has_scissor;
  p.sx0 = sx0;
  p.sy0 = sy0;
  p.sx1 = sx1;
  p.sy1 = sy1;
  for (int i = 0; i < kSamples; ++i) {
    p.ddx[i] = sample_offsets[2 * i];
    p.ddy[i] = sample_offsets[2 * i + 1];
  }
  const dim3 grid(num_tx * num_ty, tile_h / p.band_rows);
  raster_msaa4_sublane_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}
