// Template transpose for Hopper (sm_90a).
//
// Replaces based_renderer_tpu/ops/binassem.py:_transpose_kernel (run by
// transpose_templates), the relayout behind raster_tmpl="pallas" on the
// TPU.  It computes the same function: the field-major template matrix
// fused_t (W8, T) int32, one row per template field, becomes the row-major
// gather layout out (T, out_width) int32, one row per triangle, with lanes
// W8..out_width zero.  W8 is a multiple of 8 and at most out_width, a
// multiple of 64; any such W8 works (W8 = 136 for K = 33 channels, past
// the 128 the TPU version was tried at).  Unlike the TPU version, which
// pads T to its fixed 1024-column chunk, T is not padded: the grid covers
// ceil(T / 32) column tiles and masks the ragged edge, and only rows below
// T are ever gathered (every t_slot is below T).
//
// What bounds it on this card: memory traffic, and nothing else.  It
// moves no value through arithmetic: each input int is read once and each
// output int written once, W8 * T * 4 + T * out_width * 4 bytes (448 MB
// for the 1M-triangle mesh at K = 6: W8 = 48, out_width = 64).  The
// design is the classic shared-memory tiled transpose: a block of 32 x 8
// threads stages a 32 x 32 int32 tile (+1 column of padding, so the
// column-wise reads of the transposed write hit 32 distinct banks), reading
// rows of fused_t coalesced along T and writing rows of out coalesced
// along out_width.  Tiles past W8 read nothing and write the zero lanes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kRowsPerPass = 8;  // threads in y; each moves kTile / kRowsPerPass ints

__global__ void __launch_bounds__(kTile * kRowsPerPass) transpose_templates_kernel(
    const int32_t* __restrict__ fused_t, int32_t* __restrict__ out, int w8, int64_t t, int out_width) {
  __shared__ int32_t tile[kTile][kTile + 1];
  const int64_t t0 = (int64_t)blockIdx.x * kTile;  // first triangle of the tile
  const int r0 = blockIdx.y * kTile;                // first field (output lane)
  const int64_t col = t0 + threadIdx.x;
  for (int j = threadIdx.y; j < kTile; j += kRowsPerPass) {
    const int r = r0 + j;
    tile[j][threadIdx.x] = (r < w8 && col < t) ? fused_t[(int64_t)r * t + col] : 0;
  }
  __syncthreads();
  for (int j = threadIdx.y; j < kTile; j += kRowsPerPass) {
    const int64_t row = t0 + j;
    if (row < t) out[row * out_width + r0 + threadIdx.x] = tile[threadIdx.x][j];
  }
}

}  // namespace

extern "C" cudaError_t brt_transpose_templates(const void* fused_t, void* out, int w8, int64_t t,
                                               int out_width, void* stream) {
  if (w8 <= 0 || w8 % 8 || out_width % 64 || w8 > out_width) return cudaErrorInvalidValue;
  if (t <= 0) return cudaSuccess;
  const dim3 grid((unsigned)((t + kTile - 1) / kTile), (unsigned)(out_width / kTile));
  const dim3 block(kTile, kRowsPerPass);
  transpose_templates_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(fused_t), static_cast<int32_t*>(out), w8, t, out_width);
  return cudaGetLastError();
}
