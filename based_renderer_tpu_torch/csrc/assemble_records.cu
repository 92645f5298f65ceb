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
// as f32).  The id is t + id_offset, or tri_ids[t] when the caller gives
// per-triangle ids (a culled instanced draw keeps each surviving
// triangle's original id; binning.py:_templates).  Slots at or past *total
// get impossible edges (-2^30, zero steps); every other field is still
// assembled from the slot's triangle.
// With rw == 24 (coverage MSAA-4x, binassem.py:160-163) rows 16-21 carry
// the raw per-subpixel edge coefficients A0..A2, B0..B2 (0 on invalid
// slots) and rows 22-23 are zero.
//
// What bounds it on this card: memory traffic.  A slot reads ~100 bytes of
// per-triangle fields at a data-dependent row (t_slot is sorted by tile, so
// neighbouring slots read scattered triangles; 4 more with per-triangle
// ids) plus 24 bytes of slot
// inputs, and writes 64 (MSAA: 96) bytes of int record and 4 * FW bytes of float
// record (FW = 32 for the six varyings of the dense mesh): about 200 bytes
// per slot read and written, with the arithmetic well under the memory
// time.  The design: one thread per slot, which writes every record row
// field-major, so neighbouring threads store to neighbouring addresses
// and every store is coalesced.  Two entries read the slot's triangle:
//   brt_assemble_records       straight from the per-triangle tensors;
//   brt_assemble_records_rows  from row t_slot[s] of the (T, row_width)
//                              template matrix that transpose_templates.cu
//                              builds under raster_tmpl="pallas": one
//                              contiguous row of 256 B (row_width 64) per
//                              slot, the gather the TPU kernel's caller
//                              makes before its Pallas assembly
//                              (binning.py:489-500), here done in-kernel.
// Both fill one SlotFields and run the same write_slot, so they produce
// bit-identical records.
//
// The rows entry stages rows through shared memory.  Read straight from
// global memory, each thread's 21 + num_planes scalar loads of its own row
// put 32 rows 256 B apart under every load instruction: 32 L1 lines a
// load, about 1,250 L1 wavefronts for a warp's 39 columns (K = 3), against
// the SoA fields' few lines of the per-field entry.  So each warp owns 32
// consecutive slots and copies the used part of their rows (ceil4(21 +
// num_planes) columns) with 16-byte loads: lane (lane / 8, lane % 8) takes
// chunk 8p + lane % 8 of rows 4i + lane / 8, so one load instruction reads
// 128 contiguous bytes of each of 4 rows (4 lines).  The chunks land
// transposed in the warp's shared tile: column c of the warp's slot j at
// c * 33 + j, so the stores (bank 4 * chunk + row, mod 32) and each
// thread's reads of its own row's columns (bank c + j) are free of bank
// conflicts.  write_slot then reads the planes at that column pitch.
// Warps share nothing, so a __syncwarp orders the copy and the reads.
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
constexpr int kRowsWarps = 4;  // warps a block of the rows entry
constexpr int kStagePitch = 33;  // int32 words between two staged columns of one warp
constexpr int kRecordWidth = 16;
constexpr int kRecordWidthMsaa = 24;
constexpr int64_t kAnchorClamp = (1LL << 30) - 1;
constexpr int32_t kInvalidEdge = -(1 << 30);
constexpr int kSubpixel = 16;
constexpr int kHalfPixel = 8;
constexpr int kDepthFracBits = 6;
constexpr int kTemplateColumns = 21;  // 19 int + gx, gy: the planes start here

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
  const int64_t* t_slot;  // (P,)
  const int64_t* ox;      // (P,)
  const int64_t* oy;      // (P,)
  const int64_t* total;   // ()
  const int32_t* tri_ids; // (T,) per-triangle ids, or null: the id is t + id_offset
  int64_t id_offset;
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

// One slot's template fields, read from either layout.
struct SlotFields {
  int64_t a[3];
  int64_t b[3];
  int64_t e[3];
  int64_t dzdx, dzdy, tid;
  int32_t zshift, zq0, x0f, y0f;
  float gx, gy;
  const float* planes;  // num_planes floats, (p00, pdx, pdy) triples, kPlanePitch apart
};

// 16-byte chunks of a template row that the rows entry stages: every column
// up to the last plane.
__host__ __device__ constexpr int row_chunks(int num_planes) { return (kTemplateColumns + num_planes + 3) / 4; }

// Dynamic shared memory of one block of the rows entry.
__host__ __device__ constexpr int64_t rows_smem_bytes(int num_planes) {
  return (int64_t)kRowsWarps * 4 * row_chunks(num_planes) * kStagePitch * (int64_t)sizeof(int32_t);
}

struct Out {
  int32_t* records;  // (rw, P)
  float* frecords;   // (fw, P)
  int64_t num_slots;
  int rw;
  int fw;
  int num_planes;
};

// The record arithmetic of both entries: slot s, tile origin (ox, oy).
template <int kPlanePitch>
__device__ __forceinline__ void write_slot(const SlotFields& f, int64_t s, int64_t ox, int64_t oy,
                                           bool invalid, const Out& o) {
  const int64_t P = o.num_slots;
  int32_t* rec = o.records + s;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int64_t eb = clamp64(f.e[i] + f.a[i] * (ox * kSubpixel) + f.b[i] * (oy * kSubpixel),
                               -kAnchorClamp, kAnchorClamp);
    rec[i * P] = invalid ? kInvalidEdge : (int32_t)eb;
    rec[(3 + i) * P] = invalid ? 0 : (int32_t)(f.a[i] * kSubpixel);
    rec[(6 + i) * P] = invalid ? 0 : (int32_t)(f.b[i] * kSubpixel);
    if (o.rw == kRecordWidthMsaa) {
      rec[(16 + i) * P] = invalid ? 0 : (int32_t)f.a[i];
      rec[(19 + i) * P] = invalid ? 0 : (int32_t)f.b[i];
    }
  }

  const int64_t can_x = (ox >> 7) << 7;  // floor to the 128-px depth grid
  const int64_t can_y = (oy >> 7) << 7;
  const int64_t z_can = depth_tile_anchor(f.zq0, f.x0f, f.y0f, f.gx, f.gy, f.zshift, can_x, can_y);
  const int64_t zo = z_can + f.dzdx * (ox - can_x) + f.dzdy * (oy - can_y);
  rec[9 * P] = (int32_t)(uint32_t)(uint64_t)zo;  // int32 wrap, as the TPU lanes
  rec[10 * P] = (int32_t)f.dzdx;
  rec[11 * P] = (int32_t)f.dzdy;
  rec[12 * P] = f.zshift;
  rec[13 * P] = (int32_t)(uint32_t)(uint64_t)f.tid;
  rec[14 * P] = 0;
  rec[15 * P] = 0;
  if (o.rw == kRecordWidthMsaa) {
    rec[22 * P] = 0;
    rec[23 * P] = 0;
  }

  const float oxf = (float)ox;
  const float oyf = (float)oy;
  float* frec = o.frecords + s;
  for (int r = 0; r < o.num_planes; r += 3) {
    const float p00 = f.planes[r * kPlanePitch];
    const float pdx = f.planes[(r + 1) * kPlanePitch];
    const float pdy = f.planes[(r + 2) * kPlanePitch];
    frec[r * P] = __fadd_rn(__fadd_rn(p00, __fmul_rn(pdx, oxf)), __fmul_rn(pdy, oyf));
    frec[(r + 1) * P] = pdx;
    frec[(r + 2) * P] = pdy;
  }
  frec[o.num_planes * P] = __ll2float_rn(f.tid);
  for (int r = o.num_planes + 1; r < o.fw; ++r) frec[r * P] = 0.0f;
}

// Per-field entry: the slot's fields from the per-triangle tensors.
__global__ void __launch_bounds__(kThreads) assemble_records_kernel(const Params p, const Out o) {
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= o.num_slots) return;
  const int64_t t = p.t_slot[s];
  SlotFields f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    f.a[i] = p.a[3 * t + i];
    f.b[i] = p.b[3 * t + i];
    f.e[i] = p.e[3 * t + i];
  }
  f.dzdx = p.dzdx[t];
  f.dzdy = p.dzdy[t];
  f.tid = p.tri_ids != nullptr ? (int64_t)p.tri_ids[t] : t + p.id_offset;
  f.zshift = p.zshift[t];
  f.zq0 = p.zq[3 * t];
  f.x0f = p.xf[3 * t];
  f.y0f = p.yf[3 * t];
  f.gx = p.gx[t];
  f.gy = p.gy[t];
  f.planes = p.planes + t * o.num_planes;
  write_slot<1>(f, s, p.ox[s], p.oy[s], s >= *p.total, o);
}

// Row entry: the slot's fields from row t_slot[s] of the (T, row_width)
// template matrix (transpose_templates.cu's output; column layout in
// binassem.py), staged through the warp's shared tile (see the top of the
// file).  Rows start 16-byte aligned: the caller checks fused's address
// and that row_width is a multiple of 4.
__global__ void __launch_bounds__(kRowsWarps * 32) assemble_records_rows_kernel(
    const int32_t* __restrict__ fused, int row_width, const int64_t* __restrict__ t_slot,
    const int64_t* __restrict__ ox, const int64_t* __restrict__ oy, const int64_t* __restrict__ total,
    const Out o) {
  extern __shared__ int32_t stage_all[];
  const int lane = threadIdx.x & 31;
  const int chunks = row_chunks(o.num_planes);
  int32_t* stage = stage_all + (threadIdx.x >> 5) * (4 * chunks * kStagePitch);
  const int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = s < o.num_slots;
  const int64_t t = live ? t_slot[s] : -1;

  // The copy: this lane takes chunks lane % 8 (+ 8, ...) of the rows of
  // slots 4i + lane / 8.  Lanes past num_slots stage nothing.
  const int sub = lane >> 3;
  int64_t rows[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) rows[i] = __shfl_sync(0xffffffffu, t, 4 * i + sub);
  for (int q = lane & 7; q < chunks; q += 8) {
    int4 v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (rows[i] >= 0) v[i] = __ldg(reinterpret_cast<const int4*>(fused + rows[i] * row_width) + q);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (rows[i] < 0) continue;
      int32_t* d = stage + 4 * q * kStagePitch + 4 * i + sub;
      d[0] = v[i].x;
      d[kStagePitch] = v[i].y;
      d[2 * kStagePitch] = v[i].z;
      d[3 * kStagePitch] = v[i].w;
    }
  }
  __syncwarp();
  if (!live) return;

  const int32_t* col = stage + lane;  // column c of this slot's row: col[c * kStagePitch]
  SlotFields f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    f.a[i] = col[i * kStagePitch];
    f.b[i] = col[(3 + i) * kStagePitch];
    // (hi, lo) pair: hi * 2^32 + lo as uint32.
    f.e[i] = (int64_t)(((uint64_t)(uint32_t)col[(6 + 2 * i) * kStagePitch] << 32) |
                       (uint32_t)col[(7 + 2 * i) * kStagePitch]);
  }
  f.dzdx = col[12 * kStagePitch];
  f.dzdy = col[13 * kStagePitch];
  f.zshift = col[14 * kStagePitch];
  f.tid = col[15 * kStagePitch];
  f.zq0 = col[16 * kStagePitch];
  f.x0f = col[17 * kStagePitch];
  f.y0f = col[18 * kStagePitch];
  f.gx = __int_as_float(col[19 * kStagePitch]);
  f.gy = __int_as_float(col[20 * kStagePitch]);
  f.planes = reinterpret_cast<const float*>(col + kTemplateColumns * kStagePitch);
  write_slot<kStagePitch>(f, s, ox[s], oy[s], s >= *total, o);
}

}  // namespace

extern "C" cudaError_t brt_assemble_records(
    const void* a, const void* b, const void* e,
    const void* dzdx, const void* dzdy, const void* zshift,
    const void* zq, const void* xf, const void* yf,
    const void* gx, const void* gy,
    const void* planes, int num_planes,
    const void* t_slot, const void* ox, const void* oy, const void* total,
    const void* tri_ids, int64_t id_offset,
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
  p.t_slot = static_cast<const int64_t*>(t_slot);
  p.ox = static_cast<const int64_t*>(ox);
  p.oy = static_cast<const int64_t*>(oy);
  p.total = static_cast<const int64_t*>(total);
  p.tri_ids = static_cast<const int32_t*>(tri_ids);
  p.id_offset = id_offset;
  const Out o{static_cast<int32_t*>(records), static_cast<float*>(frecords), num_slots, rw, fw, num_planes};
  const int64_t blocks = (num_slots + kThreads - 1) / kThreads;
  assemble_records_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p, o);
  return cudaGetLastError();
}

// Bytes of dynamic shared memory a launch of the rows entry asks for.
extern "C" int64_t brt_assemble_records_rows_smem(int num_planes) { return rows_smem_bytes(num_planes); }

extern "C" cudaError_t brt_assemble_records_rows(
    const void* fused, int row_width, int num_planes,
    const void* t_slot, const void* ox, const void* oy, const void* total,
    void* records, void* frecords, int64_t num_slots, int rw, int fw,
    void* stream) {
  if (num_planes % 3 || fw < num_planes + 1 || kTemplateColumns + num_planes > row_width || row_width % 4 ||
      reinterpret_cast<uintptr_t>(fused) % 16) {
    return cudaErrorInvalidValue;
  }
  if (rw != kRecordWidth && rw != kRecordWidthMsaa) return cudaErrorInvalidValue;
  if (num_slots <= 0) return cudaSuccess;
  const int64_t smem = rows_smem_bytes(num_planes);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(assemble_records_rows_kernel,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const Out o{static_cast<int32_t*>(records), static_cast<float*>(frecords), num_slots, rw, fw, num_planes};
  constexpr int threads = kRowsWarps * 32;
  const int64_t blocks = (num_slots + threads - 1) / threads;
  assemble_records_rows_kernel<<<(unsigned)blocks, threads, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(fused), row_width, static_cast<const int64_t*>(t_slot),
      static_cast<const int64_t*>(ox), static_cast<const int64_t*>(oy), static_cast<const int64_t*>(total), o);
  return cudaGetLastError();
}
