// The vertex stage's point transform, M @ [p, 1] per point in a fixed
// order, for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package transforms the vertex stage's
// points with plain array code (math3d.py:transform_points), which XLA
// fuses into one loop over the points; the port's plain PyTorch
// (ops/transform.py:transform_points_reference) runs it as separate
// passes: a fill and a concatenation that append the ones column, then one
// strided product per matrix column and an addition per column but the
// first, each over the whole (N, R) output.  This kernel is that chain in
// one pass.  Per point i it writes row i of out (N, R) f32:
//   out[i][r] = ((v0 * m_r0 + v1 * m_r1) + v2 * m_r2) + v3 * m_r3
// summed over the C columns of the matrix in column order, where v is
// point i's P floats followed, when P = C - 1, by an implicit w = 1 (the
// product with it is m_r(C-1) exactly).  The matrix is one (R, C) matrix
// for every point (m_stride 0) or one per point, (N, R, C) (m_stride
// R * C), as instanced draws give it; R, C <= 4.
//
// What bounds it on this card: memory traffic.  A point reads 4P bytes
// (and 4RC of matrix when each point has its own) and writes 4R; for the
// 1M-triangle mesh's 3M corners at P = 3, R = 4 that is 36 MB read and 48
// MB written, about 0.025 ms at 3.35 TB/s, and 2RC flops a point, far
// under the FP32 rate.  The design: a thread per point, so a warp's loads
// cover one contiguous run of the points and a 4-wide row leaves as one
// 16-byte store; the ones column is never stored or read; a shared matrix
// is read once per block into shared memory and broadcast from there.
//
// Numerics: float32, the plain version's order, every product and sum by
// __fmul_rn/__fadd_rn so that nvcc's default -fmad=true cannot contract
// them, no flush to zero.  The output equals the plain version's bit for
// bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDim = 4;  // rows, columns and point width at most

__global__ void __launch_bounds__(kThreads) transform_points_kernel(const float* __restrict__ m, int64_t m_stride,
                                                                    const float* __restrict__ v,
                                                                    float* __restrict__ out, int64_t n, int r,
                                                                    int c, int p) {
  __shared__ float shared_m[kMaxDim * kMaxDim];
  if (m_stride == 0) {
    if (threadIdx.x < r * c) shared_m[threadIdx.x] = __ldg(m + threadIdx.x);
    __syncthreads();
  }
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float* mi = m_stride == 0 ? shared_m : m + i * m_stride;
  float x[kMaxDim];
#pragma unroll
  for (int j = 0; j < kMaxDim; ++j) {
    x[j] = 1.f;  // the implicit w where j == p < c
    if (j < p) x[j] = __ldg(v + i * p + j);
  }
  float o[kMaxDim];
#pragma unroll
  for (int row = 0; row < kMaxDim; ++row) {
    float acc = 0.f;
    if (row < r) {
      acc = __fmul_rn(mi[row * c], x[0]);
#pragma unroll
      for (int j = 1; j < kMaxDim; ++j)
        if (j < c) acc = __fadd_rn(acc, __fmul_rn(mi[row * c + j], x[j]));
    }
    o[row] = acc;
  }
  if (r == kMaxDim) {
    reinterpret_cast<float4*>(out)[i] = make_float4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int row = 0; row < kMaxDim; ++row)
      if (row < r) out[i * r + row] = o[row];
  }
}

}  // namespace

// m (R, C) f32 with m_stride 0, or (N, R, C) with m_stride R * C; v (N, P)
// f32 with P = C or C - 1; out (N, R) f32, 16-byte aligned when R = 4.
extern "C" cudaError_t brt_transform_points(const void* m, int64_t m_stride, const void* v, void* out, int64_t n,
                                            int r, int c, int p, void* stream) {
  if (r < 1 || r > kMaxDim || c < 1 || c > kMaxDim || p < 1 || (p != c && p != c - 1) || n < 0 ||
      (m_stride != 0 && m_stride != (int64_t)r * c))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;  // an empty draw: its operands may have no storage
  if (r == kMaxDim && (reinterpret_cast<uintptr_t>(out) & 15) != 0) return cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  transform_points_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(m), m_stride, static_cast<const float*>(v), static_cast<float*>(out), n, r, c, p);
  return cudaGetLastError();
}
