// The binner's float template planes, one row per triangle, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel.  The JAX package builds the planes with plain
// array code (binning.py:_triangle_templates), which XLA fuses into a
// loop or two over the triangles; the port's plain PyTorch
// (ops/templates.py:template_planes_reference) runs the same chain as
// about 120 separate passes over the draw: the int64 -> f32 edge values,
// the barycentric planes, the perspective product, three strided products
// and two additions for each of the 3 + K planes, and the stack of the
// 3 * (3 + K) columns.  This kernel is that chain in one pass.  Per
// triangle t it writes row t of planes (T, 3 * (3 + K)) f32: the planes
// (p00, pdx, pdy) of b0, b1, 1/w and each of the K channels, anchored at
// the pixel-(0, 0) centre.  From e (T, 3) int64, the exact biased edge
// values there, a and b (T, 3) int32 and inv_area (T,) f32:
//   b0 = (f32(e1) * ia, (f32(a1) * 16) * ia, (f32(b1) * 16) * ia)
//   b1 = the same from edge 2
//   b2 = (1 - (b0.p00 + b1.p00), -(b0.pdx + b1.pdx), -(b0.pdy + b1.pdy))
// and for per-vertex values q (1/w, or channel k times 1/w when
// `perspective`, else channel k) component c of its plane is
//   ((q0 * b0[c] + q1 * b1[c]) + q2 * b2[c]).
//
// What bounds it on this card: memory traffic.  A triangle reads 24 B of
// edge values, 24 B of coefficients, 4 B of 1/area, 12 B of 1/w and 12K B
// of channels and writes 12 (3 + K) B of planes: 244 B at K = 6, 244 MB
// for the 1M-triangle mesh, about 0.07 ms at 3.35 TB/s; the arithmetic
// (about 6 (3 + K) flops a triangle) is far under the FP32 rate.  The
// design: a block of kTris threads takes kTris consecutive triangles, so
// its rows are one contiguous run of the output and its inputs contiguous
// runs of theirs.  Each thread first computes its triangle's nine
// barycentric plane values and stages them in shared memory (field-major,
// so the stores hit distinct banks).  Then the block walks the run's
// (triangle, plane) items in order, a thread an item: it reads the
// plane's three per-vertex values once (1/w and a channel, which L1 holds
// after the block's first touch), and writes the plane's three floats,
// so that a warp's stores cover 384 contiguous bytes.  On the 1M-triangle
// mesh (K = 6) this ran in 0.138-0.146 ms against 0.165 for a thread an
// output element and 0.536 for a thread a whole row (H100, kernel-only).
//
// Numerics: float32, the plain version's order, every product and sum by
// __fmul_rn/__fadd_rn/__fsub_rn so that nvcc's default -fmad=true cannot
// contract them, no flush to zero.  The int64 edge value converts by the
// JAX package's two-step rule (fixedpoint.i64_to_f32):
// f32(hi + (lo < 0)) * 2^32 + f32(int32(lo)), a double rounding above 2^31
// in magnitude that a direct conversion would not reproduce.  The planes
// equal the plain version's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTris = 128;  // triangles a block, one thread each in the first phase
constexpr float kSubpixelScale = 16.f;

__device__ __forceinline__ float i64_to_f32(int64_t v) {
  const int64_t lo = ((v + (1LL << 31)) & 0xFFFFFFFFLL) - (1LL << 31);  // the low word as int32
  const int64_t hi = (v - lo) >> 32;
  return __fadd_rn(__fmul_rn(__ll2float_rn(hi), 4294967296.f), __int2float_rn((int32_t)lo));
}

__global__ void __launch_bounds__(kTris) triangle_templates_kernel(
    const int64_t* __restrict__ e, const int32_t* __restrict__ a, const int32_t* __restrict__ b,
    const float* __restrict__ inv_area, const float* __restrict__ inv_w, const float* __restrict__ channels,
    int k, int perspective, float* __restrict__ planes, int64_t t) {
  // bary[3 * j + c]: component c (p00, pdx, pdy) of barycentric j's plane.
  __shared__ float bary[9][kTris];
  const int64_t t0 = (int64_t)blockIdx.x * kTris;
  const int n = (int)min((int64_t)kTris, t - t0);
  const int r = threadIdx.x;
  if (r < n) {
    const int64_t tri = t0 + r;
    const float ia = __ldg(inv_area + tri);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int64_t i = tri * 3 + j + 1;  // b0 from edge 1, b1 from edge 2
      bary[3 * j][r] = __fmul_rn(i64_to_f32(__ldg(e + i)), ia);
      bary[3 * j + 1][r] = __fmul_rn(__fmul_rn(__int2float_rn(__ldg(a + i)), kSubpixelScale), ia);
      bary[3 * j + 2][r] = __fmul_rn(__fmul_rn(__int2float_rn(__ldg(b + i)), kSubpixelScale), ia);
    }
    bary[6][r] = __fsub_rn(1.f, __fadd_rn(bary[0][r], bary[3][r]));
    bary[7][r] = -__fadd_rn(bary[1][r], bary[4][r]);
    bary[8][r] = -__fadd_rn(bary[2][r], bary[5][r]);
  }
  __syncthreads();
  const int w = 3 * (3 + k);
  const int groups = 3 + k;  // planes a row: b0, b1, 1/w, then the channels
  const float* iw = inv_w + t0 * 3;
  const float* ch = channels + t0 * 3 * k;  // unread when k == 0
  float* out = planes + t0 * w;
  for (int item = threadIdx.x; item < n * groups; item += kTris) {
    const int row = item / groups;
    const int g = item - row * groups;
    float* o = out + row * w + 3 * g;
    if (g < 2) {
#pragma unroll
      for (int c = 0; c < 3; ++c) o[c] = bary[3 * g + c][row];
      continue;
    }
    float q[3];
#pragma unroll
    for (int vtx = 0; vtx < 3; ++vtx) {
      const float wv = __ldg(iw + row * 3 + vtx);
      if (g == 2) {
        q[vtx] = wv;
      } else {
        const float cv = __ldg(ch + (row * 3 + vtx) * k + g - 3);
        q[vtx] = perspective ? __fmul_rn(cv, wv) : cv;
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c)
      o[c] = __fadd_rn(__fadd_rn(__fmul_rn(q[0], bary[c][row]), __fmul_rn(q[1], bary[3 + c][row])),
                       __fmul_rn(q[2], bary[6 + c][row]));
  }
}

}  // namespace

// e (T, 3) int64; a, b (T, 3) int32; inv_area (T,) f32; inv_w (T, 3) f32;
// channels (T, 3, K) f32, null when K = 0; planes (T, 3 * (3 + K)) f32.
extern "C" cudaError_t brt_triangle_templates(const void* e, const void* a, const void* b, const void* inv_area,
                                              const void* inv_w, const void* channels, int num_channels,
                                              int perspective, void* planes, int64_t t, void* stream) {
  if (t < 0 || num_channels < 0) return cudaErrorInvalidValue;
  if (t == 0) return cudaSuccess;  // an empty draw: its operands may have no storage
  if (channels == nullptr && num_channels > 0) return cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((t + kTris - 1) / kTris);
  triangle_templates_kernel<<<blocks, kTris, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(e), static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
      static_cast<const float*>(inv_area), static_cast<const float*>(inv_w), static_cast<const float*>(channels),
      num_channels, perspective, static_cast<float*>(planes), t);
  return cudaGetLastError();
}
