// Fused adaLN modulation: parameter-free LayerNorm then per-sample
// scale and shift (the DiT blocks' pre-attention, pre-MLP and final
// modulation).
//
// Replaces: src/repro/kernels/adaln/kernel.py::adaln_modulate_kernel
//   (body _adaln_kernel, wrapper ops.py::adaln_modulate).
//
// Computes, per token row x of x (B, N, d) with the (B, d) vectors shift
// and scale of its sample:
//   mu = mean(x), var = mean((x - mu)^2)    (f32, two passes, as the TPU
//                                            kernel does)
//   out = (x - mu) * rsqrt(var + eps) * (1 + scale) + shift
// in f32, rounded once to x's dtype.
//
// Bound on the H100: device memory.  Each element of x is read once and
// each output written once (plus the small (B, d) vectors): 4 bytes per
// bf16 element against about ten float ops, far below the card's ridge.
//
// Design: one warp per row.  The row stays in registers between the two
// reductions (d <= 32 * 4 * kMaxChunks; 36 values per lane at d = 1152),
// so x is read from device memory once.  Lanes load 4 consecutive
// elements at a time (8 bytes of bf16, 16 of f32), neighbouring lanes on
// neighbouring addresses; the sums are per-lane partials combined by
// butterfly shuffles.  Rows are independent, so a ragged N needs no
// padding (the TPU wrapper pads N to its row tile).  The square root is
// correctly rounded (__frsqrt_rn); built with --fmad=false, the
// modulation's multiply and add round separately, as in the plain
// version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows per block
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a.y));
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = hi.x;
  v[3] = hi.y;
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 a;
  a.x = *reinterpret_cast<uint32_t*>(&lo);
  a.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = a;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// CH: chunks of 4 elements per lane (the row's register footprint).
template <typename T, int CH>
__global__ void __launch_bounds__(kThreads)
    adaln_kernel(const T* __restrict__ x, const T* __restrict__ shift,
                 const T* __restrict__ scale, T* __restrict__ out, long rows,
                 int N, int d, long sh_stride, long sc_stride, float eps) {
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;
  const int nch = d / 4;
  const long b = row / N;
  const T* xr = x + row * d;

  float v[CH][4];
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int i = lane + 32 * c;
    if (i < nch) {
      load4(xr + 4 * i, v[c]);
      sum += (v[c][0] + v[c][1]) + (v[c][2] + v[c][3]);
    } else {
      v[c][0] = v[c][1] = v[c][2] = v[c][3] = 0.f;
    }
  }
  const float inv_d = 1.f / (float)d;
  const float mu = warp_sum(sum) * inv_d;
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    if (lane + 32 * c < nch) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[c][e] -= mu;
        sq += v[c][e] * v[c][e];
      }
    }
  }
  const float r = __frsqrt_rn(warp_sum(sq) * inv_d + eps);

  const T* sh = shift + b * sh_stride;
  const T* sc = scale + b * sc_stride;
  T* outr = out + row * d;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int i = lane + 32 * c;
    if (i < nch) {
      float s4[4], h4[4], o[4];
      load4(sc + 4 * i, s4);
      load4(sh + 4 * i, h4);
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = v[c][e] * r * (1.f + s4[e]) + h4[e];
      store4(outr + 4 * i, o);
    }
  }
}

constexpr int kMaxChunks = 32;  // d <= 4096

template <typename T, int CH>
cudaError_t launch(const void* x, const void* shift, const void* scale,
                   void* out, long rows, int N, int d, long sh_stride,
                   long sc_stride, float eps, cudaStream_t s) {
  const long blocks = (rows + kWarps - 1) / kWarps;
  adaln_kernel<T, CH><<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(shift),
      static_cast<const T*>(scale), static_cast<T*>(out), rows, N, d,
      sh_stride, sc_stride, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* shift, const void* scale,
                     void* out, long rows, int N, int d, long sh_stride,
                     long sc_stride, float eps, cudaStream_t s) {
#define ADALN_LAUNCH(CH)                                              \
  return launch<T, CH>(x, shift, scale, out, rows, N, d, sh_stride,   \
                       sc_stride, eps, s)
  const int need = (d / 4 + 31) / 32;
  if (need <= 1) ADALN_LAUNCH(1);
  if (need <= 2) ADALN_LAUNCH(2);
  if (need <= 4) ADALN_LAUNCH(4);
  if (need <= 9) ADALN_LAUNCH(9);
  if (need <= 16) ADALN_LAUNCH(16);
  ADALN_LAUNCH(kMaxChunks);
#undef ADALN_LAUNCH
}

}  // namespace

extern "C" int adaln_max_dim() { return 32 * 4 * kMaxChunks; }

// x, out: (B, N, d) contiguous; shift, scale: (B, d) with unit stride
// along d and sh_stride / sc_stride elements between samples (multiples
// of 4, at least d); all float32 (is_bf16 = 0) or all bfloat16; d % 4 == 0
// and every row 8-byte (bf16) or 16-byte (f32) aligned.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int adaln_launch(const void* x, const void* shift,
                            const void* scale, void* out, int is_bf16, int B,
                            int N, int d, long sh_stride, long sc_stride,
                            float eps, void* stream) {
  const long rows = (long)B * N;
  if (B < 1 || N < 1 || d < 4 || d % 4 || d > adaln_max_dim() ||
      sh_stride < d || sc_stride < d || sh_stride % 4 || sc_stride % 4 ||
      (rows + kWarps - 1) / kWarps > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)dispatch<__nv_bfloat16>(x, shift, scale, out, rows, N, d,
                                        sh_stride, sc_stride, eps, s);
  return (int)dispatch<float>(x, shift, scale, out, rows, N, d, sh_stride,
                              sc_stride, eps, s);
}
