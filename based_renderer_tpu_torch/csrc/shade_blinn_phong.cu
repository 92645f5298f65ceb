// Deferred Blinn-Phong shading, opaque composite and MSAA-4x box resolve
// in one pass, for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package shades a draw with plain array
// code (renderer.py's shading pass), which XLA fuses into a few loops over
// the samples; the port's plain PyTorch runs the same chain as some forty
// separate passes over every sample: the perspective divide, the strided
// fragment shader, the composite and the resolve, each reading and
// writing (S, H, W) planes.  This kernel is that chain for a draw whose
// shader is blinn_phong, with blending off and every channel written
// (ops/shade.py; its plain version is shade_blinn_phong_reference).  Per
// pixel and for each of its S samples (S = 4 under coverage MSAA, else
// 1): where the draw won the sample (lo <= tri_id < hi), the raw varyings
// are divided by 1/w (by 1 where 1/w is 0), the normal, light, view and
// half vectors normalised, and ambient + diffuse + specular clamped to
// [0, 1] with alpha 1; elsewhere the sample keeps its colour so far (the
// (4,) clear colour, or the (S, 4, H, W) colour of earlier draws).  With
// `resolve` the four samples are averaged in registers and only the
// (4, H, W) result is written; otherwise the per-sample colour is.
//
// What bounds it on this card: memory traffic.  A sample reads its tri_id
// (4 B) and, where the draw won it, 1/w and 6 varyings (28 B; 9 with the
// per-vertex colour); about 100 flops follow, far under the FP32 rate.
// At 3840x2160 MSAA-4x that is at most 1.06 GB read and 0.13 GB written.
// The design: one thread per pixel with all its samples, so each plane is
// read coalesced along W, the resolve needs no other thread, and nothing
// per sample goes back to device memory; a sample the draw lost reads no
// varyings.  The uniforms are loaded once per block into shared memory.
//
// Numerics: float32 throughout, the plain version's order of operations,
// IEEE division and square root (__fdiv_rn, __fsqrt_rn) and products and
// sums with __fmul_rn/__fadd_rn, so that nvcc's default -fmad=true cannot
// contract them; the clamps pass NaN through, as torch.clamp does.  The
// norms sum ((x*x + y*y) + z*z) and the resolve ((s0 + s1) + s2) + s3,
// then * 0.25; powf takes the specular power.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Uniforms {
  float light[3], eye[3], base[3], shininess, ambient;
};

__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

__device__ __forceinline__ float clamp01(float x) {
  x = x < 0.f ? 0.f : x;
  return x > 1.f ? 1.f : x;
}

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx, float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)), __fmul_rn(az, bz));
}

__device__ __forceinline__ void normalize(float& x, float& y, float& z) {
  const float len = clamp_min(__fsqrt_rn(dot3(x, y, z, x, y, z)), 1e-8f);
  x = __fdiv_rn(x, len);
  y = __fdiv_rn(y, len);
  z = __fdiv_rn(z, len);
}

// One sample's rgb from its raw varyings (plane stride `ps` apart).
template <bool kColor>
__device__ __forceinline__ void shade_sample(const float* __restrict__ v, const float* __restrict__ invw,
                                             int64_t idx, int64_t ps, const Uniforms& u, float rgb[3]) {
  constexpr int kN = kColor ? 3 : 0;  // first normal channel
  float w = __ldg(invw + idx);
  w = w == 0.f ? 1.f : w;
  float ch[kN + 6];
#pragma unroll
  for (int c = 0; c < kN + 6; ++c) ch[c] = __fdiv_rn(__ldg(v + c * ps + idx), w);
  float nx = ch[kN], ny = ch[kN + 1], nz = ch[kN + 2];
  const float px = ch[kN + 3], py = ch[kN + 4], pz = ch[kN + 5];
  normalize(nx, ny, nz);
  float lx = __fsub_rn(u.light[0], px), ly = __fsub_rn(u.light[1], py), lz = __fsub_rn(u.light[2], pz);
  normalize(lx, ly, lz);
  float vx = __fsub_rn(u.eye[0], px), vy = __fsub_rn(u.eye[1], py), vz = __fsub_rn(u.eye[2], pz);
  normalize(vx, vy, vz);
  float hx = __fadd_rn(lx, vx), hy = __fadd_rn(ly, vy), hz = __fadd_rn(lz, vz);
  normalize(hx, hy, hz);
  const float ndotl = clamp_min(dot3(nx, ny, nz, lx, ly, lz), 0.f);
  const float ndoth = clamp_min(dot3(nx, ny, nz, hx, hy, hz), 0.f);
  const float spec = __fmul_rn(0.3f, powf(ndoth, u.shininess));
  const float diffuse = __fadd_rn(u.ambient, ndotl);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float base = kColor ? ch[c] : u.base[c];
    rgb[c] = clamp01(__fadd_rn(__fmul_rn(base, diffuse), spec));
  }
}

template <int S, bool kColor>
__global__ void __launch_bounds__(kThreads) shade_blinn_phong_kernel(
    const float* __restrict__ interp, const float* __restrict__ invw, const int32_t* __restrict__ tri_id,
    int64_t lo, int64_t hi, const float* __restrict__ color, int clear, const float* __restrict__ light,
    int light_stride, const float* __restrict__ eye, int eye_stride, const float* __restrict__ base,
    int base_stride, const float* __restrict__ shininess, const float* __restrict__ ambient,
    float* __restrict__ out, int64_t hw, int resolve) {
  __shared__ Uniforms u;
  if (threadIdx.x < 3) {
    u.light[threadIdx.x] = light[threadIdx.x * light_stride];
    u.eye[threadIdx.x] = eye[threadIdx.x * eye_stride];
    u.base[threadIdx.x] = base[threadIdx.x * base_stride];
  } else if (threadIdx.x == 3) {
    u.shininess = *shininess;
    u.ambient = *ambient;
  }
  __syncthreads();
  const int64_t p = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (p >= hw) return;
  const int64_t ps = S * hw;  // one varying plane: S sample layers of H x W
  int32_t ids[S];
#pragma unroll
  for (int s = 0; s < S; ++s) ids[s] = __ldg(tri_id + s * hw + p);
  float sum[4];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int64_t idx = s * hw + p;
    float rgba[4];
    if (ids[s] >= lo && ids[s] < hi) {
      shade_sample<kColor>(interp, invw, idx, ps, u, rgba);
      rgba[3] = 1.f;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) rgba[c] = clear ? __ldg(color + c) : __ldg(color + (s * 4 + c) * hw + p);
    }
    if (S > 1 && resolve) {
#pragma unroll
      for (int c = 0; c < 4; ++c) sum[c] = s == 0 ? rgba[c] : __fadd_rn(sum[c], rgba[c]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) out[(s * 4 + c) * hw + p] = rgba[c];
    }
  }
  if (S > 1 && resolve) {
#pragma unroll
    for (int c = 0; c < 4; ++c) out[c * hw + p] = __fmul_rn(sum[c], 0.25f);
  }
}

template <int S, bool kColor>
cudaError_t launch(const float* interp, const float* invw, const int32_t* tri_id, int64_t lo, int64_t hi,
                   const float* color, int clear, const float* light, int light_stride, const float* eye,
                   int eye_stride, const float* base, int base_stride, const float* shininess,
                   const float* ambient, float* out, int64_t hw, int resolve, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((hw + kThreads - 1) / kThreads);
  shade_blinn_phong_kernel<S, kColor><<<blocks, kThreads, 0, stream>>>(
      interp, invw, tri_id, lo, hi, color, clear, light, light_stride, eye, eye_stride, base, base_stride,
      shininess, ambient, out, hw, resolve);
  return cudaGetLastError();
}

template <int S>
cudaError_t dispatch(bool has_color, const float* interp, const float* invw, const int32_t* tri_id, int64_t lo,
                     int64_t hi, const float* color, int clear, const float* light, int light_stride,
                     const float* eye, int eye_stride, const float* base, int base_stride, const float* shininess,
                     const float* ambient, float* out, int64_t hw, int resolve, cudaStream_t stream) {
  auto f = has_color ? launch<S, true> : launch<S, false>;
  return f(interp, invw, tri_id, lo, hi, color, clear, light, light_stride, eye, eye_stride, base, base_stride,
           shininess, ambient, out, hw, resolve, stream);
}

}  // namespace

// interp (K, S, H, W) with K = 6 (normal, pos_ws) or 9 (color, normal,
// pos_ws); invw (S, H, W); tri_id (S, H, W); color the (4,) clear colour
// (clear = 1) or (S, 4, H, W); out (4, H, W) with resolve under S = 4,
// else (S, 4, H, W).  A uniform stride of 0 broadcasts its one value.
extern "C" cudaError_t brt_shade_blinn_phong(const void* interp, const void* invw, const void* tri_id, int64_t lo,
                                             int64_t hi, const void* color, int clear, const void* light,
                                             int light_stride, const void* eye, int eye_stride, const void* base,
                                             int base_stride, const void* shininess, const void* ambient, void* out,
                                             int samples, int64_t hw, int num_channels, int resolve,
                                             void* stream) {
  if ((samples != 1 && samples != 4) || (num_channels != 6 && num_channels != 9) || invw == nullptr)
    return cudaErrorInvalidValue;
  if (hw <= 0) return cudaSuccess;
  auto args = [&](auto f) {
    return f(num_channels == 9, static_cast<const float*>(interp), static_cast<const float*>(invw),
             static_cast<const int32_t*>(tri_id), lo, hi, static_cast<const float*>(color), clear,
             static_cast<const float*>(light), light_stride, static_cast<const float*>(eye), eye_stride,
             static_cast<const float*>(base), base_stride, static_cast<const float*>(shininess),
             static_cast<const float*>(ambient), static_cast<float*>(out), hw, resolve,
             static_cast<cudaStream_t>(stream));
  };
  return samples == 4 ? args(dispatch<4>) : args(dispatch<1>);
}
