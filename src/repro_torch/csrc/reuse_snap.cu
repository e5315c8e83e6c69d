// Single-axis pair snap: the window-2 Δ-check and snap along adjacent
// token pairs (paper Eq. 3 for K = 2).
//
// Replaces: src/repro/kernels/reuse_mask/kernel.py::reuse_snap_kernel
//   (body _reuse_kernel, wrapper ops.py::reuse_snap).
//
// x: (R, N, d) with N even; pair p holds tokens 2p (the representative)
// and 2p + 1 (the follower).  Per channel
//     Δ = |x[2p+1] - x[2p]| * 0.5,   snap = Δ < θ,
// the follower takes the representative's value where it snaps.  One
// launch writes both full outputs: the snapped operand (the even tokens
// copied unchanged) and an int8 mask (0 on every even token), so no
// interleave pass follows.  Rounding is the JAX package's: the
// difference is taken in f32 and rounded to the working type, then abs
// (exact), then * 0.5 rounded again; θ arrives already rounded to the
// working type (by the wrapper), and the compare is exact.  Built with
// --fmad=false, so the bar is bit-equality with the plain version.
//
// Bound on the H100: bytes.  A few flops per element against reading x
// once and writing x-sized output plus a one-byte mask.
//
// Design: one thread owns 16 bytes of channels (8 bf16 or 4 f32) of one
// pair, loaded with one 16-byte load from each token and stored the same
// way; the mask bytes go out as one 8- or 4-byte store per token.  A head
// dim that is not a multiple of 16 bytes takes an element-wise variant.
// There is no padding: a grid-stride loop stops at the last pair.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Round an f32 value to the working type T (and back, for the compare).
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename T>
__device__ __forceinline__ bool snaps(T even, T odd, float theta) {
  const float diff = round_to<T>(__fsub_rn(to_f(odd), to_f(even)));
  const float delta = round_to<T>(__fmul_rn(fabsf(diff), 0.5f));
  return delta < theta;
}

// 16 bytes of T, and the mask bytes that go with them.
template <typename T>
struct Chunk;
template <>
struct Chunk<float> {
  static constexpr int n = 4;
  using mask_t = uint32_t;
};
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int n = 8;
  using mask_t = uint2;
};

constexpr int kThreads = 256;
constexpr long kMaxBlocks = 132 * 64;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    snap_vec_kernel(const T* __restrict__ x, T* __restrict__ out,
                    int8_t* __restrict__ mask, long pairs, int d,
                    float theta) {
  constexpr int V = Chunk<T>::n;
  using mask_t = typename Chunk<T>::mask_t;
  const int chunks = d / V;
  const long total = pairs * chunks;
  for (long i = blockIdx.x * (long)kThreads + threadIdx.x; i < total;
       i += (long)gridDim.x * kThreads) {
    const long p = i / chunks;
    const long e_off = 2 * p * d + (i % chunks) * V;  // even token's chunk
    const long o_off = e_off + d;                      // odd token's chunk
    const uint4 ev = *reinterpret_cast<const uint4*>(x + e_off);
    const uint4 ov = *reinterpret_cast<const uint4*>(x + o_off);
    const T* e = reinterpret_cast<const T*>(&ev);
    const T* o = reinterpret_cast<const T*>(&ov);
    __align__(16) T res[V];
    __align__(8) int8_t m[V];
#pragma unroll
    for (int c = 0; c < V; ++c) {
      const bool s = snaps(e[c], o[c], theta);
      res[c] = s ? e[c] : o[c];
      m[c] = s ? 1 : 0;
    }
    *reinterpret_cast<uint4*>(out + e_off) = ev;
    *reinterpret_cast<uint4*>(out + o_off) =
        *reinterpret_cast<const uint4*>(res);
    const mask_t zero{};
    *reinterpret_cast<mask_t*>(mask + e_off) = zero;
    *reinterpret_cast<mask_t*>(mask + o_off) =
        *reinterpret_cast<const mask_t*>(m);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    snap_elem_kernel(const T* __restrict__ x, T* __restrict__ out,
                     int8_t* __restrict__ mask, long pairs, int d,
                     float theta) {
  const long total = pairs * d;
  for (long i = blockIdx.x * (long)kThreads + threadIdx.x; i < total;
       i += (long)gridDim.x * kThreads) {
    const long e_off = 2 * (i / d) * d + i % d;
    const long o_off = e_off + d;
    const T e = x[e_off], o = x[o_off];
    const bool s = snaps(e, o, theta);
    out[e_off] = e;
    out[o_off] = s ? e : o;
    mask[e_off] = 0;
    mask[o_off] = s ? 1 : 0;
  }
}

template <typename T>
cudaError_t launch(const void* x, void* out, void* mask, long pairs, int d,
                   float theta, cudaStream_t s) {
  const bool vec = d % Chunk<T>::n == 0;
  const long items = pairs * (vec ? d / Chunk<T>::n : d);
  // Enough blocks to fill the card many times over; the loop strides.
  const long want = (items + kThreads - 1) / kThreads;
  const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
  if (vec)
    snap_vec_kernel<T><<<blocks, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(out),
        static_cast<int8_t*>(mask), pairs, d, theta);
  else
    snap_elem_kernel<T><<<blocks, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<T*>(out),
        static_cast<int8_t*>(mask), pairs, d, theta);
  return cudaGetLastError();
}

}  // namespace

// x, out: (pairs, 2, d) contiguous, float32 (is_bf16 = 0) or bfloat16,
// 16-byte aligned; mask: (pairs, 2, d) int8.  theta is already rounded to
// the working type.  Returns the CUDA error of the launch (0 on success).
extern "C" int reuse_snap_launch(const void* x, void* out, void* mask,
                                 int is_bf16, int pairs, int d, float theta,
                                 void* stream) {
  if (pairs < 1 || d < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(x, out, mask, pairs, d, theta, s);
  return (int)launch<float>(x, out, mask, pairs, d, theta, s);
}
