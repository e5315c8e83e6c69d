// Fused three-axis Δ-check + snap (TimeRipple paper Fig. 6 steps 1-2).
//
// Replaces: src/repro/kernels/reuse_mask/kernel.py::fused_reuse_kernel
//   (body _fused_kernel, wrapper ops.py::fused_reuse_snap).
//
// Computes, for the grid tokens of one operand laid out (G, TT, S, d) with
// TT in {1, 2} frames of one frame pair and S = H*W tokens per frame in
// (y, x) row-major order: the window-2 Δ (Eq. 3) along t (the two frames),
// x (adjacent tokens of a row) and y (adjacent rows), gated per channel or
// by the mean over the channels of a token against θ = (θt, θx, θy); the
// three masks are OR-aggregated with first-wins copy source in the order
// of `axes`, always from the original operand.  Writes the snapped operand
// and a one-byte mask.
//
// Bound on the H100: device memory.  Each element is read once (2 or 4 B)
// and written twice (value + 1 B mask): 5 B per bf16 element against some
// twenty float ops, far below the ~20 ops/B the card needs to be limited
// by arithmetic.
//
// Design: one thread block per (frame pair, pair of rows, run of x-pairs);
// threadIdx.x is the channel, so a warp reads consecutive addresses, and
// each thread holds the 2x2x2 cube (tt, yy, xx) of one channel in
// registers, which contains every t-, x- and y-partner it needs.  Every
// element is read from device memory once and written once; nothing is
// staged except the channel sums of the `token` gate (shared memory).
//
// Bit-equality with the plain version (core/reuse.py::compute_reuse):
// every op is an explicitly rounded intrinsic (__fadd_rn, __fmul_rn,
// __fsqrt_rn) so nothing contracts into an FMA, and bf16 values are
// rounded back to bf16 after each op where the host path rounds.  A mean
// is a float32 sum times the float32 reciprocal of its count, rounded once;
// the token gate sums channels in ascending order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
struct Ops;

template <>
struct Ops<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float rnd(float v) { return v; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
};

template <>
struct Ops<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ float rnd(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);  // v is already a bf16 value: exact
  }
};

// Window-2 Eq. 3 Δ in the host's op order: mean, difference, square,
// mean, sqrt, each rounded to the working type.
template <typename T>
__device__ __forceinline__ float delta2(float a0, float a1) {
  using O = Ops<T>;
  const float m = O::rnd(__fmul_rn(__fadd_rn(a0, a1), 0.5f));
  const float d0 = O::rnd(__fsub_rn(a0, m));
  const float d1 = O::rnd(__fsub_rn(a1, m));
  const float s0 = O::rnd(__fmul_rn(d0, d0));
  const float s1 = O::rnd(__fmul_rn(d1, d1));
  const float s = O::rnd(__fmul_rn(__fadd_rn(s0, s1), 0.5f));
  return O::rnd(__fsqrt_rn(s));
}

constexpr int kSlots = 12;  // 4 Δ per axis (t, x, y) in one 2x2x2 cube

// TT (frames per program: 2 with the t check, else 1) is a template
// parameter so every loop unrolls and the cube stays in registers.
template <typename T, int TT>
__global__ void fused_reuse_kernel(const T* __restrict__ x,
                                   T* __restrict__ out,
                                   uint8_t* __restrict__ mask, int H, int W,
                                   int d, float th_t, float th_x, float th_y,
                                   int axes_code, int n_axes, int token,
                                   float inv_d) {
  using O = Ops<T>;
  extern __shared__ float sm[];
  const int c = threadIdx.x;
  const int j = threadIdx.y;
  const int JB = blockDim.y;
  const long g = blockIdx.x;
  const int r = blockIdx.y;
  const int xp = blockIdx.z * JB + j;
  const bool live = xp < W / 2;
  constexpr bool with_t = TT == 2;
  const long S = (long)H * W;

  float v[2][2][2] = {};  // [tt][yy][xx]
  long off[2][2][2] = {};
#pragma unroll
  for (int tt = 0; tt < TT; ++tt)
#pragma unroll
    for (int yy = 0; yy < 2; ++yy)
#pragma unroll
      for (int xx = 0; xx < 2; ++xx) {
        off[tt][yy][xx] =
            ((g * TT + tt) * S + (long)(2 * r + yy) * W + 2 * xp + xx) * d + c;
        if (live) v[tt][yy][xx] = O::load(x + off[tt][yy][xx]);
      }

  // Δ slots: t k = yy*2+xx; x k = tt*2+yy; y k = tt*2+xx.
  float dl[3][4] = {};
  if (with_t)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      dl[0][k] = delta2<T>(v[0][k >> 1][k & 1], v[1][k >> 1][k & 1]);
#pragma unroll
  for (int tt = 0; tt < TT; ++tt)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      dl[1][tt * 2 + q] = delta2<T>(v[tt][q][0], v[tt][q][1]);
      dl[2][tt * 2 + q] = delta2<T>(v[tt][0][q], v[tt][1][q]);
    }
  const float th[3] = {th_t, th_x, th_y};

  bool ok[3][4];
  if (!token) {
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int k = 0; k < 4; ++k) ok[a][k] = dl[a][k] < th[a];
  } else {
    // Channel mean per slot: stage every Δ, then one thread per slot sums
    // the channels in ascending order.
    float* red = sm;                          // [JB][kSlots][d]
    float* flag = sm + (long)JB * kSlots * d;  // [JB][kSlots]
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        red[((long)j * kSlots + a * 4 + k) * d + c] = dl[a][k];
    __syncthreads();
    const int nthreads = d * JB;
    for (int s = j * d + c; s < JB * kSlots; s += nthreads) {
      const float* row = red + (long)s * d;
      float acc = row[0];
      for (int cc = 1; cc < d; ++cc) acc = __fadd_rn(acc, row[cc]);
      const float mean = O::rnd(__fmul_rn(acc, inv_d));
      const int ax = (s % kSlots) / 4;
      flag[s] = mean < (ax == 0 ? th_t : ax == 1 ? th_x : th_y) ? 1.f : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int k = 0; k < 4; ++k) ok[a][k] = flag[j * kSlots + a * 4 + k] != 0.f;
  }
  if (!with_t)
#pragma unroll
    for (int k = 0; k < 4; ++k) ok[0][k] = false;
  if (!live) return;

#pragma unroll
  for (int tt = 0; tt < TT; ++tt)
#pragma unroll
    for (int yy = 0; yy < 2; ++yy)
#pragma unroll
      for (int xx = 0; xx < 2; ++xx) {
        float val = v[tt][yy][xx];
        bool claimed = false;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          if (i >= n_axes) break;
          const int a = (axes_code >> (2 * i)) & 3;
          bool m;
          float rep;
          if (a == 0) {
            m = tt == 1 && ok[0][yy * 2 + xx];
            rep = v[0][yy][xx];
          } else if (a == 1) {
            m = xx == 1 && ok[1][tt * 2 + yy];
            rep = v[tt][yy][0];
          } else {
            m = yy == 1 && ok[2][tt * 2 + xx];
            rep = v[tt][0][xx];
          }
          if (m && !claimed) val = rep;
          claimed = claimed || m;
        }
        O::store(out + off[tt][yy][xx], val);
        mask[off[tt][yy][xx]] = claimed ? 1 : 0;
      }
}

}  // namespace

// x, out: (G, TT, H*W, d) contiguous, float32 (is_bf16 = 0) or bfloat16;
// mask: same shape, one byte per element.  axes_code packs up to three
// axis ids (0 = t, 1 = x, 2 = y) two bits each in priority order.  The
// thresholds are already rounded to the working type.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int fused_reuse_launch(const void* x, void* out, void* mask,
                                  int is_bf16, int G, int TT, int H, int W,
                                  int d, float th_t, float th_x, float th_y,
                                  int axes_code, int n_axes, int token,
                                  void* stream) {
  if (G < 1 || d < 1 || d > 256 || H < 2 || W < 2 || H % 2 || W % 2 ||
      (TT != 1 && TT != 2) || n_axes < 0 || n_axes > 3 || H / 2 > 65535)
    return (int)cudaErrorInvalidValue;
  const int JB = 256 / d > 0 ? 256 / d : 1;
  const dim3 block(d, JB);
  const dim3 grid(G, H / 2, (W / 2 + JB - 1) / JB);
  const size_t smem =
      token ? (size_t)JB * kSlots * (d + 1) * sizeof(float) : 0;
  const float inv_d = 1.0f / (float)d;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* m = static_cast<uint8_t*>(mask);
  if (is_bf16) {
    auto* xi = static_cast<const __nv_bfloat16*>(x);
    auto* xo = static_cast<__nv_bfloat16*>(out);
    if (TT == 2)
      fused_reuse_kernel<__nv_bfloat16, 2><<<grid, block, smem, s>>>(
          xi, xo, m, H, W, d, th_t, th_x, th_y, axes_code, n_axes, token,
          inv_d);
    else
      fused_reuse_kernel<__nv_bfloat16, 1><<<grid, block, smem, s>>>(
          xi, xo, m, H, W, d, th_t, th_x, th_y, axes_code, n_axes, token,
          inv_d);
  } else {
    auto* xi = static_cast<const float*>(x);
    auto* xo = static_cast<float*>(out);
    if (TT == 2)
      fused_reuse_kernel<float, 2><<<grid, block, smem, s>>>(
          xi, xo, m, H, W, d, th_t, th_x, th_y, axes_code, n_axes, token,
          inv_d);
    else
      fused_reuse_kernel<float, 1><<<grid, block, smem, s>>>(
          xi, xo, m, H, W, d, th_t, th_x, th_y, axes_code, n_axes, token,
          inv_d);
  }
  return (int)cudaGetLastError();
}
