// Per-tile visibility rasterizer for Hopper (sm_90a).
//
// Replaces based_renderer_tpu/ops/raster_pallas.py:_raster_kernel, the
// sequential per-tile Pallas raster of the TPU package.  It computes the
// same function: for every pixel of a screen tile, walk the tile's binned
// records (ops/binning.py layout) in draw order; a record covers the pixel
// when its three int32 edge values, stepped from the tile anchor, are all
// >= 0 (inside the scissor); its quantized depth plane gives z; after the
// depth clip or clamp and the depth test, a passing record becomes the
// pixel's winner (tri_id, depth_q if written).  The float outputs are the
// planes of the LAST passing record evaluated at the pixel (b0, b1,
// b2 = (1 - b0) - b1, invw, K channels), which is what the TPU kernel's
// per-record overwrite leaves behind: so the winner's slot is kept in a
// register and its planes are evaluated once, at the end.  Pixels no
// record passes keep init (or clear) tri_id/depth_q/b0/b1/b2, and invw = 1,
// channels = 0, as the TPU kernel restarts them even under init.
//
// What bounds it on this card: every pixel of a tile is touched once per
// record of that tile, so the work is int32 ALU on the CUDA cores
// (~20 integer ops per pixel-record) plus one streamed read of the int
// records, which every block of the tile reads through L2.  The design:
// one thread per pixel, one block per (tile, row band) of at most 256
// threads, the tile's records staged through shared memory in chunks of
// one record per thread and read back as warp-wide broadcasts, the
// visibility state in registers, no float work in the record loop, and
// one coalesced row of stores per output plane.  The TPU's chunk-aligned
// DMA window and leading-record skip are not needed: blocks read exactly
// [tile_start, tile_start + tile_count).
//
// Exactness: edge and depth stepping use 32-bit wrap-around arithmetic
// (done in uint32, as the TPU's int32 lanes wrap) and the depth rescale
// shifts in uint32 (a signed left shift of a negative value is not
// defined in C++).  The anchored-exactness proof needs tile dims that
// divide 128; the Python wrapper rejects any other tile.  Plane
// evaluation is (p0 + pdx*ix) + pdy*iy with __fmul_rn/__fadd_rn so nvcc
// cannot contract it into FMAs, matching the plain PyTorch version bit
// for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kIntFields = 14;  // eb0..2, ax0..2, ay0..2, zo, dzx, dzy, zshift, tri_id
constexpr int kMaxThreads = 256;
constexpr int kDepthOneQ = 1 << 30;

__device__ __forceinline__ bool depth_compare(int op, int z, int zbuf) {
  switch (op) {
    case 0: return false;         // never
    case 1: return z < zbuf;      // less
    case 2: return z == zbuf;     // equal
    case 3: return z <= zbuf;     // less_equal
    case 4: return z > zbuf;      // greater
    case 5: return z != zbuf;     // not_equal
    case 6: return z >= zbuf;     // greater_equal
    default: return true;         // always
  }
}

__device__ __forceinline__ int step32(int base, int dx, int x, int dy, int y) {
  return (int)((uint32_t)base + (uint32_t)dx * (uint32_t)x + (uint32_t)dy * (uint32_t)y);
}

__device__ __forceinline__ float plane_at(const float* __restrict__ frec, int64_t stride,
                                          int64_t slot, int row, float ixf, float iyf) {
  const float p0 = frec[row * stride + slot];
  const float pdx = frec[(row + 1) * stride + slot];
  const float pdy = frec[(row + 2) * stride + slot];
  return __fadd_rn(__fadd_rn(p0, __fmul_rn(pdx, ixf)), __fmul_rn(pdy, iyf));
}

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
  const float* init_b2;
  int32_t* out_i;
  float* out_f;
  int width, height, tile_w, tile_h, num_tx, band_h;
  int depth_test, depth_op, depth_write, depth_clip, clear_q;
  int num_channels;
  int has_scissor, sx0, sy0, sx1, sy1;
};

__global__ void __launch_bounds__(kMaxThreads) raster_tile_kernel(const Params p) {
  __shared__ int32_t srec[kIntFields][kMaxThreads];

  const int nthreads = blockDim.x;
  const int t = threadIdx.x;
  const int tile = blockIdx.x;
  const int ix = t % p.tile_w;
  const int iy = blockIdx.y * p.band_h + t / p.tile_w;
  const int px = (tile % p.num_tx) * p.tile_w + ix;
  const int py = (tile / p.num_tx) * p.tile_h + iy;
  const bool inside = px < p.width && py < p.height;
  const int64_t pix = (int64_t)py * p.width + px;
  const bool in_scissor = !p.has_scissor ||
      (px >= p.sx0 && px < p.sx1 && py >= p.sy0 && py < p.sy1);
  const bool live = inside && in_scissor;

  int zbuf = p.clear_q;
  int id = -1;
  if (inside && p.init_id != nullptr) {
    zbuf = p.init_z[pix];
    id = p.init_id[pix];
  }
  int64_t win = -1;  // sorted slot of the last passing record

  const int start = p.tile_start[tile];
  const int count = p.tile_count[tile];
  for (int c0 = 0; c0 < count; c0 += nthreads) {
    const int n = min(nthreads, count - c0);
    if (t < n) {
      const int64_t slot = (int64_t)start + c0 + t;
#pragma unroll
      for (int f = 0; f < kIntFields; ++f) srec[f][t] = p.records[f * p.stride + slot];
    }
    __syncthreads();
    if (live) {
      for (int r = 0; r < n; ++r) {
        const int e0 = step32(srec[0][r], srec[3][r], ix, srec[6][r], iy);
        const int e1 = step32(srec[1][r], srec[4][r], ix, srec[7][r], iy);
        const int e2 = step32(srec[2][r], srec[5][r], ix, srec[8][r], iy);
        if ((e0 | e1 | e2) < 0) continue;  // some edge negative: not covered
        const int zshift = srec[12][r];
        const int z_u = step32(srec[9][r], srec[10][r], ix, srec[11][r], iy);
        const int hi = ((1 << 29) >> zshift) + 1;
        const int zc = min(max(z_u, -hi), hi);
        int z = (int)(((uint32_t)zc << zshift) + (1u << 29));
        if (p.depth_clip == 2) {
          z = min(max(z, 0), kDepthOneQ);
        } else if (p.depth_clip == 1 && (z < 0 || z > kDepthOneQ)) {
          continue;
        }
        if (p.depth_test && !depth_compare(p.depth_op, z, zbuf)) continue;
        if (p.depth_write) zbuf = z;
        id = srec[13][r];
        win = (int64_t)start + c0 + r;
      }
    }
    __syncthreads();
  }
  if (!inside) return;

  const int64_t plane = (int64_t)p.width * p.height;
  p.out_i[pix] = id;
  p.out_i[plane + pix] = zbuf;
  float* out = p.out_f + pix;
  if (win >= 0) {
    const float ixf = (float)ix;
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
    const bool has_init = p.init_id != nullptr;
    out[0] = has_init ? p.init_b0[pix] : 0.0f;
    out[plane] = has_init ? p.init_b1[pix] : 0.0f;
    out[2 * plane] = has_init ? p.init_b2[pix] : 0.0f;
    out[3 * plane] = 1.0f;
    for (int c = 0; c < p.num_channels; ++c) out[(4 + c) * plane] = 0.0f;
  }
}

}  // namespace

extern "C" cudaError_t brt_raster_tile(
    const void* records, const void* frecords, int64_t stride,
    const void* tile_start, const void* tile_count, int num_tiles,
    const void* init_id, const void* init_z, const void* init_b0,
    const void* init_b1, const void* init_b2,
    void* out_i, void* out_f,
    int width, int height, int tile_w, int tile_h, int num_tx,
    int depth_test, int depth_op, int depth_write, int depth_clip, int clear_q,
    int num_channels,
    int has_scissor, int sx0, int sy0, int sx1, int sy1,
    void* stream) {
  if (tile_w <= 0 || tile_h <= 0 || 128 % tile_w || 128 % tile_h) return cudaErrorInvalidValue;
  if (num_tiles <= 0 || width <= 0 || height <= 0) return cudaSuccess;
  // Tile dims are powers of two <= 128: a band of whole rows fills at
  // most kMaxThreads threads and divides the tile height.
  int band_h = kMaxThreads / tile_w;
  if (band_h > tile_h) band_h = tile_h;
  if (band_h < 1) band_h = 1;
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
  p.init_b2 = static_cast<const float*>(init_b2);
  p.out_i = static_cast<int32_t*>(out_i);
  p.out_f = static_cast<float*>(out_f);
  p.width = width;
  p.height = height;
  p.tile_w = tile_w;
  p.tile_h = tile_h;
  p.num_tx = num_tx;
  p.band_h = band_h;
  p.depth_test = depth_test;
  p.depth_op = depth_op;
  p.depth_write = depth_write;
  p.depth_clip = depth_clip;
  p.clear_q = clear_q;
  p.num_channels = num_channels;
  p.has_scissor = has_scissor;
  p.sx0 = sx0;
  p.sy0 = sy0;
  p.sx1 = sx1;
  p.sy1 = sy1;
  const dim3 grid(num_tiles, tile_h / band_h);
  const dim3 block(tile_w * band_h);
  raster_tile_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}
