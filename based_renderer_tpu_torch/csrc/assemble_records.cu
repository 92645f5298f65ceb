// Post-sort record assembly for Hopper (sm_90a).
//
// Replaces based_renderer_tpu/ops/binassem.py:_assemble_kernel (run by
// assemble_records), the binner's fused Pallas assembly on the TPU.  It
// computes the same function: for every slot s of the sorted (tile,
// triangle) pair stream, with triangle t = t_slot[s] and tile origin
// (ox, oy), write the field-major int record (edge values stepped in int64
// from the pixel-(0, 0) centre to the tile origin and clamped to
// +/-ANCHOR_CLAMP, edge steps A*16 and B*16, the quantized depth plane
// anchored on the canonical 128-px grid and stepped to the tile origin,
// its steps and exponent, the triangle id) and the float record (every
// plane re-anchored as (p00 + pdx*ox) + pdy*oy, the steps copied, the id
// as f32).  Slots at or past *total get impossible edges (-2^30, zero
// steps); every other field is still assembled from the slot's triangle.
// With rw == 24 (coverage MSAA-4x, binassem.py:160-163) rows 16-21 carry
// the raw per-subpixel edge coefficients A0..A2, B0..B2 (0 on invalid
// slots) and rows 22-23 are zero.
//
// What bounds it on this card: memory traffic.  A slot reads ~100 bytes of
// per-triangle fields at a data-dependent row (t_slot is sorted by tile, so
// neighbouring slots read scattered triangles) plus 24 bytes of slot
// inputs, and writes 64 (MSAA: 96) bytes of int record and 4 * FW bytes of float
// record (FW = 32 for the six varyings of the dense mesh): about 200 bytes
// per slot read and written, with the arithmetic well under the memory
// time.  The design: one thread per slot; each thread reads its triangle's
// fields straight from the per-triangle tensors (no 64-wide fused template
// row, which on the TPU only served its gather unit) and writes every
// record row field-major, so neighbouring threads store to neighbouring
// addresses and every store is coalesced.
//
// Exactness: the edge and depth arithmetic is int64 and exact; results are
// truncated to int32 as the TPU's wrapping int32 lanes leave them.  The f32
// steps are single roundings (__fmul_rn/__fadd_rn: nvcc may not contract
// them into FMAs), casts round half to even after the spec's clamp
// (__float2int_rn, never roundf), so the records equal the plain PyTorch
// version bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRecordWidth = 16;
constexpr int kRecordWidthMsaa = 24;
constexpr int64_t kAnchorClamp = (1LL << 30) - 1;
constexpr int32_t kInvalidEdge = -(1 << 30);
constexpr int kSubpixel = 16;
constexpr int kHalfPixel = 8;
constexpr int kDepthFracBits = 6;

struct Params {
  const int32_t* a;       // (T, 3)
  const int32_t* b;       // (T, 3)
  const int64_t* e;       // (T, 3)
  const int32_t* dzdx;    // (T,)
  const int32_t* dzdy;    // (T,)
  const int32_t* zshift;  // (T,)
  const int32_t* zq;      // (T, 3), vertex 0 read
  const int32_t* xf;      // (T, 3), vertex 0 read
  const int32_t* yf;      // (T, 3), vertex 0 read
  const float* gx;        // (T,)
  const float* gy;        // (T,)
  const float* planes;    // (T, num_planes)
  int num_planes;
  const int64_t* t_slot;  // (P,)
  const int64_t* ox;      // (P,)
  const int64_t* oy;      // (P,)
  const int64_t* total;   // ()
  int64_t id_offset;
  int32_t* records;       // (rw, P)
  float* frecords;        // (fw, P)
  int64_t num_slots;
  int rw;
  int fw;
};

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t lo, int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// rint_i32 of the spec: clamp to +/-2^30, then round half to even.
__device__ __forceinline__ int32_t rint_i32(float v) {
  return __float2int_rn(fminf(fmaxf(v, -1073741824.0f), 1073741824.0f));
}

// setup.depth_tile_anchor: the quantized plane value at a canonical anchor.
__device__ __forceinline__ int64_t depth_tile_anchor(int32_t zq0, int32_t x0f, int32_t y0f, float gx,
                                                     float gy, int32_t zshift, int64_t ax, int64_t ay) {
  const int64_t ax_fp = ax * kSubpixel + kHalfPixel;
  const int64_t ay_fp = ay * kSubpixel + kHalfPixel;
  const float unit_scale = __int_as_float((133 - zshift) << 23);  // 2^(6 - zshift), exact
  const float dxf = (float)(ax_fp - x0f);  // |.| < 2^20: exact
  const float dyf = (float)(ay_fp - y0f);
  const int64_t tx = rint_i32(__fmul_rn(__fmul_rn(gx, dxf), unit_scale));
  const int64_t ty = rint_i32(__fmul_rn(__fmul_rn(gy, dyf), unit_scale));
  const int64_t rsh = clamp64(zshift - kDepthFracBits, 0, 24);
  const int64_t pow_l = 1LL << clamp64(kDepthFracBits - zshift, 0, 6);
  const int64_t mid_u = (1LL << 29) >> zshift;
  const int64_t base = ((int64_t)zq0 >> rsh) * pow_l - mid_u;
  int64_t s = clamp64((base + tx) + ty, -(1LL << 30), 1LL << 30);
  const int64_t clamp_hi = mid_u + (1LL << 29);
  return clamp64(s, -clamp_hi, clamp_hi);
}

__global__ void __launch_bounds__(kThreads) assemble_records_kernel(const Params p) {
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= p.num_slots) return;
  const int64_t P = p.num_slots;
  const int64_t t = p.t_slot[s];
  const int64_t ox = p.ox[s];
  const int64_t oy = p.oy[s];
  const bool invalid = s >= *p.total;

  int32_t* rec = p.records + s;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int64_t a = p.a[3 * t + i];
    const int64_t b = p.b[3 * t + i];
    const int64_t eb = clamp64(p.e[3 * t + i] + a * (ox * kSubpixel) + b * (oy * kSubpixel),
                               -kAnchorClamp, kAnchorClamp);
    rec[i * P] = invalid ? kInvalidEdge : (int32_t)eb;
    rec[(3 + i) * P] = invalid ? 0 : (int32_t)(a * kSubpixel);
    rec[(6 + i) * P] = invalid ? 0 : (int32_t)(b * kSubpixel);
    if (p.rw == kRecordWidthMsaa) {
      rec[(16 + i) * P] = invalid ? 0 : (int32_t)a;
      rec[(19 + i) * P] = invalid ? 0 : (int32_t)b;
    }
  }

  const int32_t zshift = p.zshift[t];
  const int64_t dzx = p.dzdx[t];
  const int64_t dzy = p.dzdy[t];
  const int64_t can_x = (ox >> 7) << 7;  // floor to the 128-px depth grid
  const int64_t can_y = (oy >> 7) << 7;
  const int64_t z_can = depth_tile_anchor(p.zq[3 * t], p.xf[3 * t], p.yf[3 * t], p.gx[t], p.gy[t],
                                          zshift, can_x, can_y);
  const int64_t zo = z_can + dzx * (ox - can_x) + dzy * (oy - can_y);
  const int64_t tid = t + p.id_offset;
  rec[9 * P] = (int32_t)(uint32_t)(uint64_t)zo;  // int32 wrap, as the TPU lanes
  rec[10 * P] = (int32_t)dzx;
  rec[11 * P] = (int32_t)dzy;
  rec[12 * P] = zshift;
  rec[13 * P] = (int32_t)(uint32_t)(uint64_t)tid;
  rec[14 * P] = 0;
  rec[15 * P] = 0;
  if (p.rw == kRecordWidthMsaa) {
    rec[22 * P] = 0;
    rec[23 * P] = 0;
  }

  const float oxf = (float)ox;
  const float oyf = (float)oy;
  const float* pl = p.planes + t * p.num_planes;
  float* frec = p.frecords + s;
  for (int r = 0; r < p.num_planes; r += 3) {
    const float p00 = pl[r];
    const float pdx = pl[r + 1];
    const float pdy = pl[r + 2];
    frec[r * P] = __fadd_rn(__fadd_rn(p00, __fmul_rn(pdx, oxf)), __fmul_rn(pdy, oyf));
    frec[(r + 1) * P] = pdx;
    frec[(r + 2) * P] = pdy;
  }
  frec[p.num_planes * P] = __ll2float_rn(tid);
  for (int r = p.num_planes + 1; r < p.fw; ++r) frec[r * P] = 0.0f;
}

}  // namespace

extern "C" cudaError_t brt_assemble_records(
    const void* a, const void* b, const void* e,
    const void* dzdx, const void* dzdy, const void* zshift,
    const void* zq, const void* xf, const void* yf,
    const void* gx, const void* gy,
    const void* planes, int num_planes,
    const void* t_slot, const void* ox, const void* oy, const void* total, int64_t id_offset,
    void* records, void* frecords, int64_t num_slots, int rw, int fw,
    void* stream) {
  if (num_planes % 3 || fw < num_planes + 1) return cudaErrorInvalidValue;
  if (rw != kRecordWidth && rw != kRecordWidthMsaa) return cudaErrorInvalidValue;
  if (num_slots <= 0) return cudaSuccess;
  Params p;
  p.a = static_cast<const int32_t*>(a);
  p.b = static_cast<const int32_t*>(b);
  p.e = static_cast<const int64_t*>(e);
  p.dzdx = static_cast<const int32_t*>(dzdx);
  p.dzdy = static_cast<const int32_t*>(dzdy);
  p.zshift = static_cast<const int32_t*>(zshift);
  p.zq = static_cast<const int32_t*>(zq);
  p.xf = static_cast<const int32_t*>(xf);
  p.yf = static_cast<const int32_t*>(yf);
  p.gx = static_cast<const float*>(gx);
  p.gy = static_cast<const float*>(gy);
  p.planes = static_cast<const float*>(planes);
  p.num_planes = num_planes;
  p.t_slot = static_cast<const int64_t*>(t_slot);
  p.ox = static_cast<const int64_t*>(ox);
  p.oy = static_cast<const int64_t*>(oy);
  p.total = static_cast<const int64_t*>(total);
  p.id_offset = id_offset;
  p.records = static_cast<int32_t*>(records);
  p.frecords = static_cast<float*>(frecords);
  p.num_slots = num_slots;
  p.rw = rw;
  p.fw = fw;
  const int64_t blocks = (num_slots + kThreads - 1) / kThreads;
  assemble_records_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return cudaGetLastError();
}
