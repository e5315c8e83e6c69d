// Dense flash attention: tiled online-softmax attention, no mask.
//
// Replaces: src/repro/kernels/flash/kernel.py::flash_attention
//   (body _flash_kernel, wrapper ops.py::flash_attention).
//
// q: (BH, Nq, d), k: (BH, Nk, d), v: (BH, Nk, dv) -> out (BH, Nq, dv) in
// q's dtype; Nq != Nk and d != dv are allowed.  Per query row an f32
// running max m (from -inf), row sum l and accumulator: the f32 logits
// are multiplied by the scale, p = exp(s - m), p is cast to v's dtype
// before the PV product (bf16) and accumulated in f32, and the row is
// divided by l at the end.  Keys past Nk score -inf and query rows past
// Nq are computed on zeros and never stored: the ragged edges are masked
// by index, with no flag channel.  The first key tile always holds a real
// key, and the running max is still guarded: a row whose max is -inf
// subtracts 0, so exp(-inf - (-inf)) never occurs.
//
// Bound on the H100: arithmetic.  4 * Nq * Nk * d flops per head (d ==
// dv) against 2 * (Nq + Nk) * d * 2 bytes of bf16 operands and output:
// at serving lengths thousands of flops per byte, far above the card's
// ~295 flops/B bf16 ridge.
//
// Design (a simple first version, the pair-collapse kernel's former
// mma.sync design without the pair structure):
//   * bf16, any head dims up to 128: tensor cores through
//     mma.sync.m16n8k16 (bf16 in, f32 accumulate).  A block owns 128
//     query rows (eight warps of 16) and loops over key tiles of 64; the
//     scores stay in the accumulator registers and are re-packed as the A
//     operand of the PV product (the flash-attention-2 layout); K and V
//     are row-major in shared memory with rows padded by 16 B and read
//     with ldmatrix (.trans for V).  Shared-memory tiles are zero-padded:
//     Q and K to the next multiple of 32 channels (ldmatrix loads the
//     score product's k-steps in pairs), V to the next multiple of 16
//     (output n-tiles come in pairs).  Only the real channels are read
//     from device memory (16-byte loads when a row is a whole number of
//     16-byte chunks, element loads otherwise) and only the real output
//     columns are stored; zero channels add exact zeros.
//   * float32: CUDA-core FMAs in f32, 64 query rows by 64 keys a tile,
//     4x4 scores and 8x4 outputs per thread from shared memory.
// Neither uses TMA, wgmma, cp.async pipelining or warp specialisation yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_frag.cuh"

namespace {

constexpr int kMaxDim = 128;

// ---------------------------------------------------------------------------
// Tensor-core path (bf16)
// ---------------------------------------------------------------------------

constexpr int kBQ = 128;  // query rows a block (eight warps of 16)
constexpr int kBK = 64;   // keys a tile
constexpr int kMmaThreads = 256;

__host__ __device__ constexpr int pad_qk(int d) { return (d + 31) / 32 * 32; }
__host__ __device__ constexpr int pad_v(int dv) { return (dv + 15) / 16 * 16; }

template <int DP, int DVP>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) *
         ((size_t)(kBQ + kBK) * (DP + 8) + (size_t)kBK * (DVP + 8));
}

// Rows row0 .. row0 + nrows - 1 of a (rows, width) bf16 matrix into a
// shared tile of ``padw`` channels at row stride ``stride``; channels at
// or past ``width`` and rows at or past ``rows`` are zero.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int stride,
                                          int padw,
                                          const __nv_bfloat16* src, int row0,
                                          int nrows, int rows, int width,
                                          int tid) {
  const int chunks = padw / 8;
  const bool whole = width % 8 == 0;  // rows are whole 16-byte chunks
  for (int i = tid; i < nrows * chunks; i += kMmaThreads) {
    const int r = i / chunks, ch = i % chunks;
    const int row = row0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row < rows && ch * 8 < width) {
      const __nv_bfloat16* p = src + (long)row * width + ch * 8;
      if (whole) {
        val = *reinterpret_cast<const uint4*>(p);
      } else {
        __align__(16) __nv_bfloat16 e[8];
#pragma unroll
        for (int c = 0; c < 8; ++c)
          e[c] = ch * 8 + c < width ? p[c] : __float2bfloat16_rn(0.f);
        val = *reinterpret_cast<const uint4*>(e);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * stride + ch * 8) = val;
  }
}

template <int DP, int DVP>
__global__ void __launch_bounds__(kMmaThreads)
    flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out, int Nq, int Nk, int d,
                     int dv, float scale_log2) {
  constexpr int QS = DP + 8;       // row stride of the Q and K tiles (bf16)
  constexpr int VS = DVP + 8;      // row stride of the V tile
  constexpr int KSTEPS = DP / 16;  // k-steps of the score product
  constexpr int NT_O = DVP / 8;    // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kBQ][QS]
  __nv_bfloat16* Ks = Qs + kBQ * QS;                                // [kBK][QS]
  __nv_bfloat16* Vs = Ks + kBK * QS;                                // [kBK][VS]

  const long bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;  // mma group / thread in group
  const __nv_bfloat16* qh = q + bh * Nq * d;
  const __nv_bfloat16* kh = k + bh * Nk * d;
  const __nv_bfloat16* vh = v + bh * Nk * dv;

  load_tile(Qs, QS, DP, qh, q0, kBQ, Nq, d, tid);
  __syncthreads();
  const int r0 = warp * 16;
  const bool active = q0 + r0 < Nq;  // a warp past the last row idles
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const int col = ks * 16 + 2 * tq;
    qa[ks][0] = ld32(Qs + (r0 + gq) * QS + col);
    qa[ks][1] = ld32(Qs + (r0 + gq + 8) * QS + col);
    qa[ks][2] = ld32(Qs + (r0 + gq) * QS + col + 8);
    qa[ks][3] = ld32(Qs + (r0 + gq + 8) * QS + col + 8);
  }

  float o[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};  // rows gq and gq + 8
  float l_r[2] = {0.f, 0.f};
  const int lrow = lane & 7, lhalf = (lane >> 3) & 1, lpair = lane >> 4;
  const int nkb = (Nk + kBK - 1) / kBK;

  for (int kb = 0; kb < nkb; ++kb) {
    __syncthreads();  // the previous tile's K and V are consumed
    load_tile(Ks, QS, DP, kh, kb * kBK, kBK, Nk, d, tid);
    load_tile(Vs, VS, DVP, vh, kb * kBK, kBK, Nk, dv, tid);
    __syncthreads();
    if (!active) continue;

    // S = Q K^T for this warp's 16 rows: 8 n-tiles of 8 keys.  One
    // ldmatrix.x4 brings the B fragments of two k-steps: lane l addresses
    // key row l % 8, channel block (l / 16) * 16 + ((l / 8) % 2) * 8.
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kr =
          Ks + (nt * 8 + lrow) * QS + lpair * 16 + lhalf * 8;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ks += 2) {
        uint32_t b[4];
        ldsm_x4(b, kr + ks * 16);
        mma_bf16(s[nt], qa[ks], b[0], b[1]);
        mma_bf16(s[nt], qa[ks + 1], b[2], b[3]);
      }
    }
    // Scale the f32 logits (into log2 units), mask keys past Nk, online
    // softmax.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kb * kBK + nt * 8 + 2 * tq + (e & 1);
        s[nt][e] = key < Nk ? s[nt][e] * scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
    float alpha[2], base[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_r[h], mx[h]);
      base[h] = m_new == -INFINITY ? 0.f : m_new;  // no -inf - -inf
      alpha[h] = exp2f(m_r[h] - base[h]);
      m_r[h] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(s[nt][e] - base[e >> 1]);
        sum[e >> 1] += s[nt][e];
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l_r[h] = alpha[h] * l_r[h] + sum[h];
    }
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    // O += P V: the score accumulators of n-tiles 2kk, 2kk+1 are the A
    // fragment of k-step kk (p rounded to bf16, v's dtype).
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      // ldmatrix.x4.trans of row-major V: lane l addresses key row
      // kk*16 + ((l / 8) % 2) * 8 + l % 8 of column block n + l / 16, giving
      // the B fragments of output n-tiles n and n + 1.
      const __nv_bfloat16* vr =
          Vs + (kk * 16 + lhalf * 8 + lrow) * VS + lpair * 8;
#pragma unroll
      for (int n = 0; n < NT_O; n += 2) {
        uint32_t b[4];
        ldsm_x4_trans(b, vr + n * 8);
        mma_bf16(o[n], pa, b[0], b[1]);
        mma_bf16(o[n + 1], pa, b[2], b[3]);
      }
    }
  }

  if (!active) return;
  __nv_bfloat16* oh = out + bh * Nq * dv;
  const bool pairs = dv % 2 == 0;  // two columns per 4-byte store
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + gq + 8 * h;
    if (row >= Nq) continue;
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      const int col = n * 8 + 2 * tq;
      if (col >= dv) continue;  // padding columns
      const float a = o[n][2 * h] / l_r[h], b = o[n][2 * h + 1] / l_r[h];
      __nv_bfloat16* dst = oh + (long)row * dv + col;
      if (pairs) {
        *reinterpret_cast<uint32_t*>(dst) = pack_bf16(a, b);
      } else {
        dst[0] = __float2bfloat16_rn(a);
        if (col + 1 < dv) dst[1] = __float2bfloat16_rn(b);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// CUDA-core path (f32)
// ---------------------------------------------------------------------------

constexpr int kFT = 64;  // query rows a block and keys a tile
constexpr int kFmaThreads = 256;

__global__ void __launch_bounds__(kFmaThreads)
    flash_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int Nq, int Nk, int d, int dv, float scale) {
  extern __shared__ float sm[];
  const int q0 = blockIdx.x * kFT;
  const long bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int dp = d + 1;
  const int sp = kFT + 1;

  float* Qs = sm;                  // [kFT][d + 1]
  float* Ks = Qs + kFT * dp;       // [kFT][d + 1]
  float* Vs = Ks + kFT * dp;       // [kFT][kMaxDim]
  float* Ss = Vs + kFT * kMaxDim;  // [kFT][kFT + 1]
  float* m_s = Ss + kFT * sp;      // [kFT]
  float* l_s = m_s + kFT;          // [kFT]
  float* a_s = l_s + kFT;          // [kFT]

  const float* qh = q + bh * Nq * d;
  const float* kh = k + bh * Nk * d;
  const float* vh = v + bh * Nk * dv;

  for (int i = tid; i < kFT * d; i += kFmaThreads) {
    const int r = i / d, c = i % d;
    Qs[r * dp + c] = q0 + r < Nq ? qh[(long)(q0 + r) * d + c] : 0.f;
  }
  for (int r = tid; r < kFT; r += kFmaThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }

  // Score micro-tile: rows ty + 16*i, keys tx + 16*j.
  const int ty = tid / 16, tx = tid % 16;
  // PV micro-tile: rows warp + 8*i, output columns lane + 32*j.
  const int warp = tid / 32, lane = tid % 32;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int nkb = (Nk + kFT - 1) / kFT;
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * kFT;
    __syncthreads();  // the previous tile's K, V and S are consumed
    for (int i = tid; i < kFT * d; i += kFmaThreads) {
      const int j = i / d, c = i % d;
      Ks[j * dp + c] = k0 + j < Nk ? kh[(long)(k0 + j) * d + c] : 0.f;
    }
    for (int i = tid; i < kFT * kMaxDim; i += kFmaThreads) {
      const int j = i / kMaxDim, c = i % kMaxDim;
      Vs[i] = (k0 + j < Nk && c < dv) ? vh[(long)(k0 + j) * dv + c] : 0.f;
    }
    __syncthreads();

    // S = scale * Q K^T; keys past Nk -> -inf.
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * dp + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * dp + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = tx + 16 * j;
        Ss[(ty + 16 * i) * sp + key] =
            k0 + key < Nk ? sc[i][j] * scale : -INFINITY;
      }
    __syncthreads();

    // Online softmax: four threads per row.
    {
      const int r = tid / 4, part = tid % 4;
      float mx = -INFINITY;
      for (int kk = part; kk < kFT; kk += 4) mx = fmaxf(mx, Ss[r * sp + kk]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float base = m_new == -INFINITY ? 0.f : m_new;  // no -inf - -inf
      float sum = 0.f;
      for (int kk = part; kk < kFT; kk += 4) {
        const float p = expf(Ss[r * sp + kk] - base);
        Ss[r * sp + kk] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_prev - base);
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = alpha * acc + P V.
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float alpha = a_s[warp + 8 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
    }
    for (int kk = 0; kk < kFT; ++kk) {
      float vv[4], pv[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = Vs[kk * kMaxDim + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i) pv[i] = Ss[(warp + 8 * i) * sp + kk];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  float* oh = out + bh * Nq * dv;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = warp + 8 * i;
    if (q0 + r >= Nq) continue;
    const float l = l_s[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = lane + 32 * j;
      if (col < dv) oh[(long)(q0 + r) * dv + col] = acc[i][j] / l;
    }
  }
}

template <int DP, int DVP>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out,
                       int BH, int Nq, int Nk, int d, int dv, float scale,
                       cudaStream_t s) {
  const dim3 grid((Nq + kBQ - 1) / kBQ, BH);
  constexpr size_t smem = mma_smem_bytes<DP, DVP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<DP, DVP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  flash_mma_kernel<DP, DVP><<<grid, kMmaThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      Nq, Nk, d, dv, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_mma_dv(const void* q, const void* k, const void* v,
                          void* out, int BH, int Nq, int Nk, int d, int dv,
                          float scale, cudaStream_t s) {
  switch (pad_v(dv)) {
#define FLASH_DV(DVP) \
  case DVP:           \
    return launch_mma<DP, DVP>(q, k, v, out, BH, Nq, Nk, d, dv, scale, s);
    FLASH_DV(16) FLASH_DV(32) FLASH_DV(48) FLASH_DV(64)
    FLASH_DV(80) FLASH_DV(96) FLASH_DV(112) FLASH_DV(128)
#undef FLASH_DV
    default:
      return cudaErrorInvalidValue;
  }
}

cudaError_t launch_fma(const void* q, const void* k, const void* v, void* out,
                       int BH, int Nq, int Nk, int d, int dv, float scale,
                       cudaStream_t s) {
  const dim3 grid((Nq + kFT - 1) / kFT, BH);
  const size_t smem =
      sizeof(float) * ((size_t)kFT * (d + 1) * 2 + (size_t)kFT * kMaxDim +
                       (size_t)kFT * (kFT + 1) + 3 * kFT);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  flash_fma_kernel<<<grid, kFmaThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Nq, Nk, d, dv,
      scale);
  return cudaGetLastError();
}

}  // namespace

// q: (BH, Nq, d), k: (BH, Nk, d), v: (BH, Nk, dv), out: (BH, Nq, dv),
// contiguous, float32 (is_bf16 = 0) or bfloat16, 16-byte aligned; d and
// dv up to 128.  bf16 takes the tensor cores, float32 the CUDA cores.
// Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int is_bf16,
                                      int BH, int Nq, int Nk, int d, int dv,
                                      float scale, void* stream) {
  if (BH < 1 || BH > 65535 || Nq < 1 || Nk < 1 || d < 1 || d > kMaxDim ||
      dv < 1 || dv > kMaxDim)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) return (int)launch_fma(q, k, v, out, BH, Nq, Nk, d, dv, scale, s);
  switch (pad_qk(d)) {
    case 32: return (int)launch_mma_dv<32>(q, k, v, out, BH, Nq, Nk, d, dv, scale, s);
    case 64: return (int)launch_mma_dv<64>(q, k, v, out, BH, Nq, Nk, d, dv, scale, s);
    case 96: return (int)launch_mma_dv<96>(q, k, v, out, BH, Nq, Nk, d, dv, scale, s);
    case 128: return (int)launch_mma_dv<128>(q, k, v, out, BH, Nq, Nk, d, dv, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Which path a call takes: 1 for the tensor-core kernel, 0 for CUDA cores.
extern "C" int flash_uses_tensor_cores(int is_bf16) { return is_bf16 != 0; }
