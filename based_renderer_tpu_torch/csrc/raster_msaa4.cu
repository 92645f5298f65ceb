// Coverage-sample MSAA-4x per-tile visibility rasterizer for Hopper (sm_90a).
//
// Replaces based_renderer_tpu/ops/raster_pallas.py:_raster_kernel_msaa4,
// the TPU's two-pass MSAA raster.  It computes the same function: every
// pixel of a tile has four sample layers at the standard positions (ops/fixedpoint.py MSAA4_OFFSETS, in
// 1/16 px from the pixel center).  For each sample, walk the tile's binned
// 24-row records (ops/binning.py layout) in draw order; a record covers the
// sample when its three pixel-center edge values, stepped from the tile
// anchor, plus the per-record sample offsets o_i = A_i*ddx + B_i*ddy (raw
// coefficients in rows 16-21) are all >= 0 (inside the scissor).  The
// sample's depth is the pixel-center plane value z_u plus
// dz = (dzdx*ddx + dzdy*ddy) >> 4 (an arithmetic shift, i.e. floor), taken
// before the +/-hi clamp and the rescale.  After the depth clip or clamp
// the covered sample runs the depth test against that sample's buffer and,
// with stencil on, the stencil test against that sample's 8-bit stencil
// value, which every covered sample updates (fail_op, depth_fail_op or
// pass_op under write_mask, as csrc/raster_tile.cu); a sample passing both
// becomes the sample's winner (tri_id, depth_q if written), and the four
// stencil layers are a third int output plane.  The float
// outputs of each sample are the planes of its winner evaluated at the
// pixel CENTER (b0, b1, b2 = (1 - b0) - b1, invw, K channels): true
// multisampling.  Samples no record passes keep init (or clear)
// tri_id/depth_q/b0/b1/b2, with invw 1 and channels 0.
//
// What bounds it on this card: per pixel and record, three edge values and
// a depth value at the pixel center (4 integer multiply-adds each) and then
// four sample tests of a few integer adds, compares and selects: integer
// ALU on the CUDA cores, plus one streamed read of the int records through
// L2 and one coalesced write of 4 x (6 + K) output planes.  The design is
// csrc/raster_tile.cu's, widened to four samples: one thread per pixel, one
// block per (tile, row band) of at most 256 threads, the tile's records
// staged through shared memory in chunks of one record per thread.  The
// per-sample offsets depend only on the record, so the thread that stages
// a record computes them once (12 edge offsets, 4 depth offsets) and
// every pixel reads them as warp-wide broadcasts.  Each sample's (depth,
// winning slot) stays in registers; the planes are evaluated at the end,
// once per distinct winner of a pixel's four samples (they usually share
// one), and so do its four stencil values.  The TPU's pass-2 replay of every surviving record's planes, and
// its chunk-aligned DMA window, are not needed.
//
// Exactness: the proof in ops/fixedpoint.py keeps every per-sample edge sum
// inside int32 and the per-sample depth delta below 2^21; the stepping is
// done in uint32 (wrap-around, as the TPU's int32 lanes) and the depth
// rescale shifts in uint32.  Tile dims must divide 128 (checked).  Planes
// are (p0 + pdx*ix) + pdy*iy with __fmul_rn/__fadd_rn, matching the plain
// PyTorch version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSamples = 4;
constexpr int kMaxThreads = 256;
constexpr int kDepthOneQ = 1 << 30;
// Staged per record: eb0..2, ax0..2, ay0..2, zo, dzx, dzy, zshift, tri_id
// (rows 0-13), then per sample s the edge offsets o0..o2 and the depth
// offset dz.
constexpr int kRecFields = 14;
constexpr int kFields = kRecFields + 4 * kSamples;

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

// VkStencilOp, in 32-bit wrap-around arithmetic as the TPU's int32 lanes.
__device__ __forceinline__ int stencil_op(int op, int s, int ref) {
  const int up = (int)((uint32_t)s + 1u);
  const int down = (int)((uint32_t)s - 1u);
  switch (op) {
    case 0: return s;               // keep
    case 1: return 0;               // zero
    case 2: return ref;             // replace
    case 3: return min(up, 255);    // increment_clamp
    case 4: return max(down, 0);    // decrement_clamp
    case 5: return ~s & 0xFF;       // invert
    case 6: return up & 0xFF;       // increment_wrap
    default: return down & 0xFF;    // decrement_wrap
  }
}

__device__ __forceinline__ int step32(int base, int dx, int x, int dy, int y) {
  return (int)((uint32_t)base + (uint32_t)dx * (uint32_t)x + (uint32_t)dy * (uint32_t)y);
}

__device__ __forceinline__ int add32(int a, int b) { return (int)((uint32_t)a + (uint32_t)b); }

__device__ __forceinline__ float plane_at(const float* __restrict__ frec, int64_t stride,
                                          int64_t slot, int row, float ixf, float iyf) {
  const float p0 = frec[row * stride + slot];
  const float pdx = frec[(row + 1) * stride + slot];
  const float pdy = frec[(row + 2) * stride + slot];
  return __fadd_rn(__fadd_rn(p0, __fmul_rn(pdx, ixf)), __fmul_rn(pdy, iyf));
}

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
  const float* init_b2;
  const int32_t* init_st;  // (4, H, W) or null: start from st_clear
  int32_t* out_i;          // (2, 4, H, W), or (3, 4, H, W) with the stencil
  float* out_f;            // (4 + K, 4, H, W)
  int width, height, tile_w, tile_h, num_tx, band_h;
  int depth_test, depth_op, depth_write, depth_clip, clear_q;
  int num_channels;
  int has_scissor, sx0, sy0, sx1, sy1;
  int use_stencil, st_compare, st_ref, st_cmask, st_wmask, st_fail, st_dfail, st_pass, st_clear;
  int ddx[kSamples], ddy[kSamples];  // MSAA4_OFFSETS, 1/16 px from the pixel center
};

__global__ void __launch_bounds__(kMaxThreads) raster_msaa4_kernel(const Params p) {
  __shared__ int32_t srec[kFields][kMaxThreads];

  const int nthreads = blockDim.x;
  const int t = threadIdx.x;
  const int tile = blockIdx.x;
  const int ix = t % p.tile_w;
  const int iy = blockIdx.y * p.band_h + t / p.tile_w;
  const int px = (tile % p.num_tx) * p.tile_w + ix;
  const int py = (tile / p.num_tx) * p.tile_h + iy;
  const bool inside = px < p.width && py < p.height;
  const int64_t hw = (int64_t)p.width * p.height;
  const int64_t pix = (int64_t)py * p.width + px;
  const bool in_scissor = !p.has_scissor ||
      (px >= p.sx0 && px < p.sx1 && py >= p.sy0 && py < p.sy1);
  const bool live = inside && in_scissor;
  const bool has_init = p.init_id != nullptr;

  int zbuf[kSamples], id[kSamples], win[kSamples];  // win: record index in the tile, -1 = none
  int st[kSamples];
#pragma unroll
  for (int s = 0; s < kSamples; ++s) {
    zbuf[s] = p.clear_q;
    id[s] = -1;
    win[s] = -1;
    st[s] = p.st_clear;
    if (inside && has_init) {
      zbuf[s] = p.init_z[s * hw + pix];
      id[s] = p.init_id[s * hw + pix];
    }
    if (inside && p.init_st != nullptr) st[s] = p.init_st[s * hw + pix];
  }
  const int st_ref_m = p.st_ref & p.st_cmask;

  const int start = p.tile_start[tile];
  const int count = p.tile_count[tile];
  for (int c0 = 0; c0 < count; c0 += nthreads) {
    const int n = min(nthreads, count - c0);
    if (t < n) {
      const int64_t slot = (int64_t)start + c0 + t;
#pragma unroll
      for (int f = 0; f < kRecFields; ++f) srec[f][t] = p.records[f * p.stride + slot];
      int a[3], b[3];
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        a[e] = p.records[(16 + e) * p.stride + slot];
        b[e] = p.records[(19 + e) * p.stride + slot];
      }
      const int dzx = srec[10][t];
      const int dzy = srec[11][t];
#pragma unroll
      for (int s = 0; s < kSamples; ++s) {
        const int ddx = p.ddx[s], ddy = p.ddy[s];
#pragma unroll
        for (int e = 0; e < 3; ++e) srec[kRecFields + 4 * s + e][t] = a[e] * ddx + b[e] * ddy;
        srec[kRecFields + 4 * s + 3][t] = (dzx * ddx + dzy * ddy) >> 4;  // arithmetic: floor
      }
    }
    __syncthreads();
    if (live) {
      for (int r = 0; r < n; ++r) {
        const int e0 = step32(srec[0][r], srec[3][r], ix, srec[6][r], iy);
        const int e1 = step32(srec[1][r], srec[4][r], ix, srec[7][r], iy);
        const int e2 = step32(srec[2][r], srec[5][r], ix, srec[8][r], iy);
        const int zshift = srec[12][r];
        const int z_u = step32(srec[9][r], srec[10][r], ix, srec[11][r], iy);
        const int hi = ((1 << 29) >> zshift) + 1;
#pragma unroll
        for (int s = 0; s < kSamples; ++s) {
          const int f = kRecFields + 4 * s;
          const int s0 = add32(e0, srec[f][r]);
          const int s1 = add32(e1, srec[f + 1][r]);
          const int s2 = add32(e2, srec[f + 2][r]);
          if ((s0 | s1 | s2) < 0) continue;  // some edge negative: sample not covered
          const int zc = min(max(add32(z_u, srec[f + 3][r]), -hi), hi);
          int z = (int)(((uint32_t)zc << zshift) + (1u << 29));
          if (p.depth_clip == 2) {
            z = min(max(z, 0), kDepthOneQ);
          } else if (p.depth_clip == 1 && (z < 0 || z > kDepthOneQ)) {
            continue;
          }
          const bool d_pass = !p.depth_test || depth_compare(p.depth_op, z, zbuf[s]);
          if (p.use_stencil) {
            // Every covered sample updates its stencil, passing or not.
            const bool s_pass = depth_compare(p.st_compare, st_ref_m, st[s] & p.st_cmask);
            const int op = s_pass ? (d_pass ? p.st_pass : p.st_dfail) : p.st_fail;
            st[s] = (st[s] & ~p.st_wmask) | (stencil_op(op, st[s], p.st_ref) & p.st_wmask);
            if (!s_pass) continue;
          }
          if (!d_pass) continue;
          if (p.depth_write) zbuf[s] = z;
          id[s] = srec[13][r];
          win[s] = c0 + r;
        }
      }
    }
    __syncthreads();
  }
  if (!inside) return;

  const int64_t plane = kSamples * hw;  // one output plane holds 4 sample layers
  float b0[kSamples], b1[kSamples];
  const float ixf = (float)ix;
  const float iyf = (float)iy;
#pragma unroll
  for (int s = 0; s < kSamples; ++s) {
    const int64_t o = s * hw + pix;
    p.out_i[o] = id[s];
    p.out_i[plane + o] = zbuf[s];
    if (p.use_stencil) p.out_i[2 * plane + o] = st[s];
    if (win[s] >= 0) {
      // Samples usually share a winner: evaluate its planes once.
      if (s > 0 && win[s] == win[s - 1]) {
        b0[s] = b0[s - 1];
        b1[s] = b1[s - 1];
      } else {
        const int64_t slot = (int64_t)start + win[s];
        b0[s] = plane_at(p.frecords, p.stride, slot, 0, ixf, iyf);
        b1[s] = plane_at(p.frecords, p.stride, slot, 3, ixf, iyf);
      }
      p.out_f[o] = b0[s];
      p.out_f[plane + o] = b1[s];
      p.out_f[2 * plane + o] = __fsub_rn(__fsub_rn(1.0f, b0[s]), b1[s]);
    } else {
      b0[s] = b1[s] = 0.0f;
      p.out_f[o] = has_init ? p.init_b0[o] : 0.0f;
      p.out_f[plane + o] = has_init ? p.init_b1[o] : 0.0f;
      p.out_f[2 * plane + o] = has_init ? p.init_b2[o] : 0.0f;
    }
  }
  // invw and the channels: one plane row at a time, each distinct winner's
  // value evaluated once.
  for (int c = -1; c < p.num_channels; ++c) {
    const int row = 9 + 3 * c;  // c = -1: the invw plane (row 6)
    const float none = c < 0 ? 1.0f : 0.0f;
    float* out = p.out_f + (int64_t)(4 + c) * plane + pix;
    int last = -1;
    float v = none;
#pragma unroll
    for (int s = 0; s < kSamples; ++s) {
      if (win[s] < 0) {
        out[s * hw] = none;
        continue;
      }
      if (win[s] != last) {
        v = plane_at(p.frecords, p.stride, (int64_t)start + win[s], row, ixf, iyf);
        last = win[s];
      }
      out[s * hw] = v;
    }
  }
}

}  // namespace

extern "C" cudaError_t brt_raster_msaa4(
    const void* records, const void* frecords, int64_t stride,
    const void* tile_start, const void* tile_count, int num_tiles,
    const void* init_id, const void* init_z, const void* init_b0,
    const void* init_b1, const void* init_b2, const void* init_st,
    void* out_i, void* out_f,
    int width, int height, int tile_w, int tile_h, int num_tx,
    int depth_test, int depth_op, int depth_write, int depth_clip, int clear_q,
    int num_channels,
    int has_scissor, int sx0, int sy0, int sx1, int sy1,
    int use_stencil, int st_compare, int st_ref, int st_compare_mask, int st_write_mask,
    int st_fail, int st_depth_fail, int st_pass, int st_clear,
    const int32_t* sample_offsets,  // host (ddx, ddy) x 4: ops/fixedpoint.py MSAA4_OFFSETS
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
  p.init_st = static_cast<const int32_t*>(init_st);
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
  p.use_stencil = use_stencil;
  p.st_compare = st_compare;
  p.st_ref = st_ref;
  p.st_cmask = st_compare_mask;
  p.st_wmask = st_write_mask;
  p.st_fail = st_fail;
  p.st_dfail = st_depth_fail;
  p.st_pass = st_pass;
  p.st_clear = st_clear;
  for (int i = 0; i < kSamples; ++i) {
    p.ddx[i] = sample_offsets[2 * i];
    p.ddy[i] = sample_offsets[2 * i + 1];
  }
  const dim3 grid(num_tiles, tile_h / band_h);
  const dim3 block(tile_w * band_h);
  raster_msaa4_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}
