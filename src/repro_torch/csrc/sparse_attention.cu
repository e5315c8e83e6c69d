// Block-sparse masked flash attention (the SVG block mask's executor,
// DESIGN.md §12).
//
// Replaces: src/repro/kernels/sparse/kernel.py::sparse_attention_kernel
//   (body _sparse_kernel, wrapper ops.py::sparse_attention_pallas).
//
// A (BH, nq, nk) int32 block map over the (Nq, Nk) score matrix, tiled by
// (bq, bk) as ref.py::sparse_grid tiles it, gives each tile a state:
//   SKIP (0)    no loads, no math;
//   FULL (1)    a mask-free tile - the bias is never read;
//   PARTIAL (2) the tile's f32 logit bias (bias[b, h, row, key], -inf
//               where the mask drops a key) is added to the scores.
// With f32 running (m, l, acc) states per query row, m starting at the
// finite -1e30 of the JAX kernel (so a row whose keys are all -inf stays
// finite) and rows that end with l == 0 emitting 0.  Scores accumulate in
// f32 and are then multiplied by the scale; probabilities are rounded to
// v's dtype before the PV product, as the JAX kernel rounds them.  A
// block walks its map row in ascending key-tile order, the JAX kernel's
// summation order.  Keys past Nk and query rows past Nq are masked by
// index (the JAX wrapper pads with a flag channel instead).
//
// Bound on the H100: per non-SKIP tile 4*bq*bk*d flops, per PARTIAL tile
// bq*bk*4 bytes of bias (64 KB at 128x128) on top of q, k, v and the
// output read or written once.  At the served grid a temporal head's map
// is a third PARTIAL, so the dense bias makes such a call bound by bytes;
// a spatial head's map has no PARTIAL tile and is bound by its flops.
//
// Design (simple first version; no TMA, wgmma, cp.async pipelining or
// warp specialisation yet):
//   * one block per (bh, query rows of one map tile); the kernel's own
//     row block (128 rows on tensor cores, 64 on CUDA cores) may be
//     smaller than the map tile, and a map tile of fewer rows leaves the
//     block's tail rows idle;
//   * the block reads each state of its map row from global memory (one
//     broadcast load); a SKIP tile costs that load only;
//   * keys of a live tile are consumed in chunks of 64 through shared
//     memory;
//   * bf16 with d == dv in {32, 64, 128}: tensor cores through
//     mma.sync.m16n8k16 with ldmatrix fragments (mma_frag.cuh, shared
//     with ripple_attention.cu); eight warps of 16 query rows;
//   * float32 (and other head dims): CUDA-core FMAs in f32, the tile code
//     of ripple_attention.cu's CUDA-core path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_frag.cuh"

namespace {

constexpr int kSkip = 0;
constexpr int kPartial = 2;
constexpr float kMInit = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxDim = 128;
constexpr int kChunk = 64;  // keys per shared-memory chunk

struct Args {
  const void* q;      // (BH, Nq, d)
  const void* k;      // (BH, Nk, d)
  const void* v;      // (BH, Nk, dv)
  void* out;          // (BH, Nq, dv)
  const float* bias;  // rows of Nk floats at bias + b*bias_sb + h*bias_sh; may be null
  const int* bmap;    // (BH, nq, nk)
  int H, Nq, Nk, d, dv, bq, bk, nq, nk, sub;
  long long bias_sb, bias_sh;
  float scale;
};

// A probability as the PV product sees it: rounded to v's dtype.
__device__ __forceinline__ float round_as(float p, float) { return p; }
__device__ __forceinline__ float round_as(float p, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

// ---------------------------------------------------------------------------
// Tensor-core path (bf16)
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 8;
constexpr int kMmaRows = 16 * kMmaWarps;  // query rows per block
constexpr int kMmaThreads = 32 * kMmaWarps;

template <int D>
__global__ void __launch_bounds__(kMmaThreads) sparse_mma_kernel(Args a) {
  static_assert(D % 32 == 0, "ldmatrix pairs k-steps");
  constexpr int S = D + 8;        // row stride of the Q, K and V tiles (bf16)
  constexpr int KSTEPS = D / 16;  // k-steps of the score product
  constexpr int NT_O = D / 8;     // n-tiles of the output
  constexpr int CH = D / 8;       // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [128][S]
  __nv_bfloat16* Ks = Qs + kMmaRows * S;                            // [64][S]
  __nv_bfloat16* Vs = Ks + kChunk * S;                              // [64][S]

  const int qi = blockIdx.x / a.sub;
  const long bh = blockIdx.y;
  const int row_lo = qi * a.bq + (blockIdx.x % a.sub) * kMmaRows;
  const int row_hi = min(qi * a.bq + a.bq, a.Nq);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;  // mma group / thread in group

  const __nv_bfloat16* qh =
      static_cast<const __nv_bfloat16*>(a.q) + bh * a.Nq * D;
  const __nv_bfloat16* kh =
      static_cast<const __nv_bfloat16*>(a.k) + bh * a.Nk * D;
  const __nv_bfloat16* vh =
      static_cast<const __nv_bfloat16*>(a.v) + bh * a.Nk * D;
  const int* mrow = a.bmap + (bh * a.nq + qi) * a.nk;
  const float* bh_bias =
      a.bias == nullptr
          ? nullptr
          : a.bias + (bh / a.H) * a.bias_sb + (bh % a.H) * a.bias_sh;

  for (int i = tid; i < kMmaRows * CH; i += kMmaThreads) {
    const int r = i / CH, ch = i % CH;
    const int row = row_lo + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row < row_hi)
      val = *reinterpret_cast<const uint4*>(qh + (long)row * D + ch * 8);
    *reinterpret_cast<uint4*>(Qs + r * S + ch * 8) = val;
  }
  __syncthreads();

  const int r0 = warp * 16;
  const bool active = row_lo + r0 < row_hi;
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int ks = 0; ks < KSTEPS; ++ks) {
    const int col = ks * 16 + 2 * tq;
    qa[ks][0] = ld32(Qs + (r0 + gq) * S + col);
    qa[ks][1] = ld32(Qs + (r0 + gq + 8) * S + col);
    qa[ks][2] = ld32(Qs + (r0 + gq) * S + col + 8);
    qa[ks][3] = ld32(Qs + (r0 + gq + 8) * S + col + 8);
  }
  // This thread's two query rows (gq and gq + 8 of the warp's 16).
  int rows[2];
  rows[0] = row_lo + r0 + gq;
  rows[1] = rows[0] + 8;

  float o[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_r[2] = {kMInit, kMInit};
  float l_r[2] = {0.f, 0.f};
  const int lrow = lane & 7, lhalf = (lane >> 3) & 1, lpair = lane >> 4;

  for (int kj = 0; kj < a.nk; ++kj) {
    const int state = mrow[kj];  // uniform over the block
    if (state == kSkip) continue;
    const bool add_bias = state == kPartial && bh_bias != nullptr;
    const int key_hi = min((kj + 1) * a.bk, a.Nk);
    for (int c0 = kj * a.bk; c0 < key_hi; c0 += kChunk) {
      const int nkeys = min(kChunk, key_hi - c0);
      __syncthreads();  // the previous chunk's K and V are consumed
      for (int i = tid; i < kChunk * CH; i += kMmaThreads) {
        const int j = i / CH, ch = i % CH;
        uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
        if (j < nkeys) {
          kv = *reinterpret_cast<const uint4*>(kh + (long)(c0 + j) * D + ch * 8);
          vv = *reinterpret_cast<const uint4*>(vh + (long)(c0 + j) * D + ch * 8);
        }
        *reinterpret_cast<uint4*>(Ks + j * S + ch * 8) = kv;
        *reinterpret_cast<uint4*>(Vs + j * S + ch * 8) = vv;
      }
      __syncthreads();
      if (!active) continue;

      // S = Q K^T for this warp's 16 rows, n-tiles of 8 keys.  One
      // ldmatrix.x4 brings the B fragments of two k-steps: lane l addresses
      // key row l % 8, channel block (l / 16) * 16 + ((l / 8) % 2) * 8.
      const int ntiles = (nkeys + 7) / 8;
      float s[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        if (nt >= ntiles) continue;
        const __nv_bfloat16* kr = Ks + (nt * 8 + lrow) * S + lpair * 16 + lhalf * 8;
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ks += 2) {
          uint32_t b[4];
          ldsm_x4(b, kr + ks * 16);
          mma_bf16(s[nt], qa[ks], b[0], b[1]);
          mma_bf16(s[nt], qa[ks + 1], b[2], b[3]);
        }
      }
      // Scale, bias (PARTIAL tiles), mask keys past the tile, online softmax.
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = nt * 8 + 2 * tq + (e & 1);
          const int row = rows[e >> 1];
          float x = -INFINITY;
          if (j < nkeys) {
            x = s[nt][e] * a.scale;
            if (add_bias && row < row_hi)
              x = x + bh_bias[(long long)row * a.Nk + c0 + j];
          }
          s[nt][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m_r[h], mx[h]);
        alpha[h] = exp2f((m_r[h] - m_new) * kLog2e);
        m_r[h] = m_new;
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[nt][e] = exp2f((s[nt][e] - m_r[e >> 1]) * kLog2e);
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
      // fragment of k-step kk (probabilities rounded to bf16 here).
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (2 * kk >= ntiles) continue;
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        // ldmatrix.x4.trans of row-major V: lane l addresses key row
        // kk*16 + ((l / 8) % 2) * 8 + l % 8 of column block n + l / 16,
        // giving the B fragments of output n-tiles n and n + 1.
        const __nv_bfloat16* vr = Vs + (kk * 16 + lhalf * 8 + lrow) * S + lpair * 8;
#pragma unroll
        for (int n = 0; n < NT_O; n += 2) {
          uint32_t b[4];
          ldsm_x4_trans(b, vr + n * 8);
          mma_bf16(o[n], pa, b[0], b[1]);
          mma_bf16(o[n + 1], pa, b[2], b[3]);
        }
      }
    }
  }

  if (!active) return;
  __nv_bfloat16* oh = static_cast<__nv_bfloat16*>(a.out) + bh * a.Nq * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = rows[h];
    if (row >= row_hi) continue;
    // l == 0: every tile of the row was skipped or fully masked.
    const float inv_l = l_r[h] > 0.f ? 1.f / l_r[h] : 0.f;
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      const uint32_t val = pack_bf16(o[n][2 * h] * inv_l, o[n][2 * h + 1] * inv_l);
      *reinterpret_cast<uint32_t*>(oh + (long)row * D + n * 8 + 2 * tq) = val;
    }
  }
}

// ---------------------------------------------------------------------------
// CUDA-core path (f32, and bf16 with other head dims <= 128)
// ---------------------------------------------------------------------------

constexpr int kFmaRows = 64;  // query rows per block
constexpr int kFmaThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kFmaThreads) sparse_fma_kernel(Args a) {
  extern __shared__ float sm[];
  const int d = a.d, dv = a.dv;
  const int dp = d + 1;
  const int sp = kChunk + 1;
  float* Qs = sm;                      // [64][d + 1]
  float* Ks = Qs + kFmaRows * dp;      // [64][d + 1]
  float* Vs = Ks + kChunk * dp;        // [64][kMaxDim]
  float* Ss = Vs + kChunk * kMaxDim;   // [64][65]
  float* m_s = Ss + kFmaRows * sp;     // [64]
  float* l_s = m_s + kFmaRows;         // [64]
  float* a_s = l_s + kFmaRows;         // [64]

  const int qi = blockIdx.x / a.sub;
  const long bh = blockIdx.y;
  const int row_lo = qi * a.bq + (blockIdx.x % a.sub) * kFmaRows;
  const int row_hi = min(qi * a.bq + a.bq, a.Nq);
  const int tid = threadIdx.x;

  const T* qh = static_cast<const T*>(a.q) + bh * a.Nq * d;
  const T* kh = static_cast<const T*>(a.k) + bh * a.Nk * d;
  const T* vh = static_cast<const T*>(a.v) + bh * a.Nk * dv;
  const int* mrow = a.bmap + (bh * a.nq + qi) * a.nk;
  const float* bh_bias =
      a.bias == nullptr
          ? nullptr
          : a.bias + (bh / a.H) * a.bias_sb + (bh % a.H) * a.bias_sh;

  for (int i = tid; i < kFmaRows * d; i += kFmaThreads) {
    const int r = i / d, c = i % d;
    const int row = row_lo + r;
    Qs[r * dp + c] = row < row_hi ? to_f(qh[(long)row * d + c]) : 0.f;
  }
  for (int i = tid; i < kChunk * kMaxDim; i += kFmaThreads) Vs[i] = 0.f;
  for (int r = tid; r < kFmaRows; r += kFmaThreads) {
    m_s[r] = kMInit;
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

  for (int kj = 0; kj < a.nk; ++kj) {
    const int state = mrow[kj];  // uniform over the block
    if (state == kSkip) continue;
    const bool add_bias = state == kPartial && bh_bias != nullptr;
    const int key_hi = min((kj + 1) * a.bk, a.Nk);
    for (int c0 = kj * a.bk; c0 < key_hi; c0 += kChunk) {
      const int nkeys = min(kChunk, key_hi - c0);
      __syncthreads();  // the previous chunk's K, V and S are consumed
      for (int i = tid; i < kChunk * d; i += kFmaThreads) {
        const int j = i / d, c = i % d;
        Ks[j * dp + c] = j < nkeys ? to_f(kh[(long)(c0 + j) * d + c]) : 0.f;
      }
      for (int i = tid; i < kChunk * dv; i += kFmaThreads) {
        const int j = i / dv, c = i % dv;
        Vs[j * kMaxDim + c] = j < nkeys ? to_f(vh[(long)(c0 + j) * dv + c]) : 0.f;
      }
      __syncthreads();

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
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const int row = row_lo + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kk = tx + 16 * j;
          float x = -INFINITY;
          if (kk < nkeys) {
            x = sc[i][j] * a.scale;
            if (add_bias && row < row_hi)
              x = x + bh_bias[(long long)row * a.Nk + c0 + kk];
          }
          Ss[r * sp + kk] = x;
        }
      }
      __syncthreads();

      // Online softmax: four threads per row.
      {
        const int r = tid / 4, part = tid % 4;
        float mx = -INFINITY;
        for (int kk = part; kk < kChunk; kk += 4) mx = fmaxf(mx, Ss[r * sp + kk]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, mx);
        float sum = 0.f;
        for (int kk = part; kk < kChunk; kk += 4) {
          const float p = exp2f((Ss[r * sp + kk] - m_new) * kLog2e);
          Ss[r * sp + kk] = round_as(p, T());
          sum += p;
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if (part == 0) {
          const float alpha = exp2f((m_prev - m_new) * kLog2e);
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
      for (int kk = 0; kk < nkeys; ++kk) {
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
  }

  T* oh = static_cast<T*>(a.out) + bh * a.Nq * dv;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = warp + 8 * i;
    const int row = row_lo + r;
    if (row >= row_hi) continue;
    // l == 0: every tile of the row was skipped or fully masked.
    const float inv_l = l_s[r] > 0.f ? 1.f / l_s[r] : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = lane + 32 * j;
      if (col < dv) from_f(oh + (long)row * dv + col, acc[i][j] * inv_l);
    }
  }
}

template <int D>
cudaError_t launch_mma(Args a, int BH, cudaStream_t s) {
  a.sub = (a.bq + kMmaRows - 1) / kMmaRows;
  const dim3 grid(a.nq * a.sub, BH);
  const size_t smem = sizeof(__nv_bfloat16) * (size_t)(kMmaRows + 2 * kChunk) * (D + 8);
  cudaError_t err = cudaFuncSetAttribute(
      sparse_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  sparse_mma_kernel<D><<<grid, kMmaThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fma(Args a, int BH, cudaStream_t s) {
  a.sub = (a.bq + kFmaRows - 1) / kFmaRows;
  const dim3 grid(a.nq * a.sub, BH);
  const size_t smem =
      sizeof(float) * ((size_t)(kFmaRows + kChunk) * (a.d + 1) + (size_t)kChunk * kMaxDim +
                       (size_t)kFmaRows * (kChunk + 1) + 3 * kFmaRows);
  cudaError_t err = cudaFuncSetAttribute(
      sparse_fma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  sparse_fma_kernel<T><<<grid, kFmaThreads, smem, s>>>(a);
  return cudaGetLastError();
}

bool tensor_cores(int is_bf16, int d, int dv) {
  return is_bf16 && d == dv && (d == 32 || d == 64 || d == 128);
}

}  // namespace

// q: (BH, Nq, d); k: (BH, Nk, d); v: (BH, Nk, dv); out: (BH, Nq, dv); all
// contiguous, float32 (is_bf16 = 0) or bfloat16, 16-byte aligned.
// bmap: (BH, ceil(Nq/bq), ceil(Nk/bk)) int32 states.  bias: null, or f32
// rows of Nk floats, row `row` of head (b, h) = bh / H, bh % H at
// bias + b*bias_sb + h*bias_sh + row*Nk.  Returns the CUDA error of the
// launch (0 on success).
extern "C" int sparse_attention_launch(const void* q, const void* k, const void* v,
                                       void* out, const void* bias, const void* bmap,
                                       int is_bf16, int BH, int H, int Nq, int Nk,
                                       int d, int dv, int bq, int bk,
                                       long long bias_sb, long long bias_sh,
                                       float scale, void* stream) {
  if (BH < 1 || BH > 65535 || H < 1 || BH % H || Nq < 1 || Nk < 1 || d < 1 ||
      d > kMaxDim || dv < 1 || dv > kMaxDim || bq < 1 || bk < 1)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.bias = static_cast<const float*>(bias);
  a.bmap = static_cast<const int*>(bmap);
  a.H = H;
  a.Nq = Nq;
  a.Nk = Nk;
  a.d = d;
  a.dv = dv;
  a.bq = bq;
  a.bk = bk;
  a.nq = (Nq + bq - 1) / bq;
  a.nk = (Nk + bk - 1) / bk;
  a.sub = 1;
  a.bias_sb = bias_sb;
  a.bias_sh = bias_sh;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tensor_cores(is_bf16, d, dv)) {
    switch (d) {
      case 32: return (int)launch_mma<32>(a, BH, s);
      case 64: return (int)launch_mma<64>(a, BH, s);
      default: return (int)launch_mma<128>(a, BH, s);
    }
  }
  if (is_bf16) return (int)launch_fma<__nv_bfloat16>(a, BH, s);
  return (int)launch_fma<float>(a, BH, s);
}

// Which path a call takes: 1 for the tensor-core kernel, 0 for CUDA cores.
extern "C" int sparse_uses_tensor_cores(int is_bf16, int d, int dv) {
  return tensor_cores(is_bf16, d, dv);
}
