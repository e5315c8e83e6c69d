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
// ~295 flops/B bf16 ridge; in f32 on CUDA cores (67 TFLOP/s) further
// still.
//
// Design:
//   * bf16, any head dims up to 128 (on no serving path; a simple first
//     version, the pair-collapse kernel's former mma.sync design without
//     the pair structure): tensor cores through mma.sync.m16n8k16 (bf16
//     in, f32 accumulate).  A block owns 128 query rows (eight warps of
//     16) and loops over key tiles of 64; the scores stay in the
//     accumulator registers and are re-packed as the A operand of the PV
//     product (the flash-attention-2 layout); K and V are row-major in
//     shared memory with rows padded by 16 B and read with ldmatrix
//     (.trans for V).  Shared-memory tiles are zero-padded: Q and K to the
//     next multiple of 32 channels (ldmatrix loads the score product's
//     k-steps in pairs), V to the next multiple of 16 (output n-tiles come
//     in pairs).  Only the real channels are read from device memory
//     (16-byte loads when a row is a whole number of 16-byte chunks,
//     element loads otherwise) and only the real output columns are
//     stored; zero channels add exact zeros.  No TMA, wgmma, cp.async
//     pipelining or warp specialisation yet.
//   * float32 (the kernel_bench sweep's dense anchor): CUDA-core FMAs,
//     no TF32.  The FMA pipes are the bound, so every other instruction
//     and every shared-memory wavefront is kept off them:
//       - a block owns 128 query rows, eight warps of 16, and loops over
//         key tiles of 64; a lane holds 8 rows x 4 keys of scores and the
//         same 8 rows x 8 columns of output, so per channel three float4
//         reads of shared memory feed 32 FMAs (per 4 keys of P V, 16
//         reads feed 256);
//       - Q is stored transposed in shared memory (channel-major, rows
//         contiguous): a lane's 8 rows are two float4s.  K stays row-major
//         with rows padded to 132 floats, and a lane's keys are kg + 16j,
//         so the float4s of four channels that the lanes of a wavefront
//         read lie in eight different rows and distinct banks.  Every
//         read is at a base plus a constant in the unrolled channel loop,
//         with no index arithmetic;
//       - softmax in registers: a row's max and sum are reduced over the
//         16 lanes that hold it with shuffles, in log2 units (log2 e
//         folded into the scale, each exponent one FFMA into
//         ex2.approx.ftz); P goes once through shared memory, row-major
//         for the P V product and read only by the warp that wrote it, so
//         a tile needs one block barrier, not three;
//       - K and V tiles are double-buffered with cp.async (16-byte copies,
//         4-byte ones when a row is not whole 16-byte chunks), so the next
//         tile's 64 KB at d 128 loads while the current one computes;
//         226 KB of shared memory, one block of 8 warps an SM, up to 255
//         registers a thread; dv > 64 and dv <= 64 are two
//         instantiations, so the P V loop has no branch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"  // cp.async, smem_u32; mma.sync fragments (mma_frag.cuh)

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

constexpr int kFWarps = 8;
constexpr int kFThreads = 32 * kFWarps;
constexpr int kFRows = 8;                  // query rows a lane holds
constexpr int kFQ = 2 * kFRows * kFWarps;  // query rows a block: 16 a warp
constexpr int kFK = 64;                    // keys a tile
constexpr int kKRow = kMaxDim + 4;  // floats a K row takes in shared memory
// Q^T, two K and two V tiles, and the block's probabilities: 226 KB.
constexpr size_t kFSmem =
    sizeof(float) * ((size_t)kMaxDim * kFQ + 2 * (size_t)kFK * kKRow +
                     2 * (size_t)kFK * kMaxDim + (size_t)kFQ * kFK);

// Rows row0 .. row0 + kFK - 1 of a (rows, width) f32 matrix into a shared
// tile of `stride`-float rows by cp.async, a warp a row and a lane a
// chunk: 16-byte copies when the rows are whole 16-byte chunks, 4-byte
// copies otherwise.  Rows past `rows` and columns from width up to the
// next multiple of 4 are written as zeros.
__device__ __forceinline__ void fetch_rows(float* tile, int stride,
                                           const float* src, int row0,
                                           int rows, int width) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chunks = (width + 3) >> 2;
  for (int r = warp; r < kFK; r += kFWarps) {
    const bool ok = row0 + r < rows;
    const float* row = src + (long)(ok ? row0 + r : 0) * width;
    float* dst = tile + r * stride;
    if ((width & 3) == 0) {
      if (lane < chunks) cp_async16(smem_u32(dst + 4 * lane), row + 4 * lane, ok ? 16 : 0);
    } else {
      for (int c = lane; c < 4 * chunks; c += 32)
        cp_async4(smem_u32(dst + c), c < width ? row + c : row,
                  ok && c < width ? 4 : 0);
    }
  }
}

// A warp owns 16 query rows.  Lane (rg, kg) = (lane / 16, lane % 16) holds
// the scores of rows 8rg..8rg+7 against keys kg + 16j (j < 4), 32 of
// them, and the outputs of the same rows at columns 4kg..4kg+3 and
// 64+4kg..64+4kg+3, 64 of them.
template <bool HI>
__global__ void __launch_bounds__(kFThreads, 1)
    flash_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int Nq, int Nk, int d, int dv, float scale_log2) {
  extern __shared__ __align__(16) float fsm[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* Qt = fsm;                      // [kMaxDim][kFQ]: Q transposed
  float* Ks = Qt + kMaxDim * kFQ;       // [2][kFK][kKRow]
  float* Vs = Ks + 2 * kFK * kKRow;     // [2][kFK][kMaxDim]
  float* Ps = Vs + 2 * kFK * kMaxDim;   // [kFQ][kFK]
  const int q0 = blockIdx.x * kFQ;
  const long bh = blockIdx.y;
  const float* qh = q + bh * Nq * d;
  const float* kh = k + bh * Nk * d;
  const float* vh = v + bh * Nk * dv;
  const int rg = lane >> 4, kg = lane & 15;
  const int qr = warp * 2 * kFRows + rg * kFRows;  // this lane's first row
  const int nkb = (Nk + kFK - 1) / kFK;
  const int groups = (d + 3) >> 2;  // 4-channel steps of the score product

  fetch_rows(Ks, kKRow, kh, 0, Nk, d);
  fetch_rows(Vs, kMaxDim, vh, 0, Nk, dv);
  cp_async_commit();
  // Q^T once, through registers (lanes on consecutive rows); channels from
  // d up to the next multiple of 4 are zeros.
  for (int i = threadIdx.x; i < kFQ * groups; i += kFThreads) {
    const int r = i % kFQ, ch = i / kFQ;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Nq) {
      const float* p = qh + (long)(q0 + r) * d + 4 * ch;
      if ((d & 3) == 0) {
        x = *reinterpret_cast<const float4*>(p);
      } else {
        if (4 * ch + 0 < d) x.x = p[0];
        if (4 * ch + 1 < d) x.y = p[1];
        if (4 * ch + 2 < d) x.z = p[2];
        if (4 * ch + 3 < d) x.w = p[3];
      }
    }
    Qt[(4 * ch + 0) * kFQ + r] = x.x;
    Qt[(4 * ch + 1) * kFQ + r] = x.y;
    Qt[(4 * ch + 2) * kFQ + r] = x.z;
    Qt[(4 * ch + 3) * kFQ + r] = x.w;
  }

  float o[kFRows][8], m[kFRows], l[kFRows];
#pragma unroll
  for (int i = 0; i < kFRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) o[i][c] = 0.f;
  }

  for (int kb = 0; kb < nkb; ++kb) {
    const int buf = kb & 1;
    // Tile kb has landed for every thread, and every warp is done with
    // tile kb - 1, whose buffers the next copies overwrite.
    cp_async_wait_all();
    __syncthreads();
    if (kb + 1 < nkb) {
      fetch_rows(Ks + (buf ^ 1) * kFK * kKRow, kKRow, kh, (kb + 1) * kFK, Nk, d);
      fetch_rows(Vs + (buf ^ 1) * kFK * kMaxDim, kMaxDim, vh, (kb + 1) * kFK, Nk, dv);
      cp_async_commit();
    }
    const float* Kt = Ks + buf * kFK * kKRow;
    const float* Vt = Vs + buf * kFK * kMaxDim;

    // S = Q K^T: per 4 channels, 12 float4 reads feed 128 FMAs.
    float s[kFRows][4];
#pragma unroll
    for (int i = 0; i < kFRows; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    const float* qc = Qt + qr;
    const float* kc = Kt + kg * kKRow;
#pragma unroll 4
    for (int g = 0; g < groups; ++g) {
      float4 kf[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kf[j] = *reinterpret_cast<const float4*>(kc + 16 * j * kKRow + 4 * g);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* qu = qc + (4 * g + u) * kFQ;
        const float4 qa = *reinterpret_cast<const float4*>(qu);
        const float4 qb = *reinterpret_cast<const float4*>(qu + 4);
        const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float kv = u == 0 ? kf[j].x : u == 1 ? kf[j].y : u == 2 ? kf[j].z : kf[j].w;
#pragma unroll
          for (int i = 0; i < kFRows; ++i) s[i][j] = fmaf(qv[i], kv, s[i][j]);
        }
      }
    }

    // Online softmax in log2 units (log2 e folded into the scale), each
    // row reduced over the 16 lanes that hold it; keys past Nk -> -inf.
    const int key0 = kb * kFK;
    if (key0 + kFK > Nk) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (key0 + kg + 16 * j >= Nk) {
#pragma unroll
          for (int i = 0; i < kFRows; ++i) s[i][j] = -INFINITY;
        }
    }
#pragma unroll
    for (int i = 0; i < kFRows; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int x = 1; x < 16; x <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
      // The scale is positive: the max of the raw scores scales to it.
      const float m_new = fmaxf(m[i], mx * scale_log2);
      const float base = m_new == -INFINITY ? 0.f : m_new;  // no -inf - -inf
      const float alpha = exp2_ftz(m[i] - base);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2_ftz(fmaf(s[i][j], scale_log2, -base));
        sum += s[i][j];
      }
#pragma unroll
      for (int x = 1; x < 16; x <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, x);
      l[i] = alpha * l[i] + sum;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(qr + i) * kFK + kg + 16 * j] = s[i][j];
#pragma unroll
      for (int c = 0; c < 8; ++c) o[i][c] *= alpha;
    }
    __syncwarp();  // the warp's probabilities are written

    // O += P V, four keys a step: per step 8 float4 reads of P (one a row)
    // and 8 of V feed 256 FMAs.
    const float* pr = Ps + qr * kFK;
#pragma unroll 4
    for (int kk = 0; kk < kFK; kk += 4) {
      float4 pf[kFRows];
#pragma unroll
      for (int i = 0; i < kFRows; ++i)
        pf[i] = *reinterpret_cast<const float4*>(pr + i * kFK + kk);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float* vr = Vt + (kk + t) * kMaxDim;
        const float4 va = *reinterpret_cast<const float4*>(vr + 4 * kg);
        float4 vb = make_float4(0.f, 0.f, 0.f, 0.f);
        if (HI) vb = *reinterpret_cast<const float4*>(vr + 64 + 4 * kg);
#pragma unroll
        for (int i = 0; i < kFRows; ++i) {
          const float p = t == 0 ? pf[i].x : t == 1 ? pf[i].y : t == 2 ? pf[i].z : pf[i].w;
          o[i][0] = fmaf(p, va.x, o[i][0]);
          o[i][1] = fmaf(p, va.y, o[i][1]);
          o[i][2] = fmaf(p, va.z, o[i][2]);
          o[i][3] = fmaf(p, va.w, o[i][3]);
          if (HI) {
            o[i][4] = fmaf(p, vb.x, o[i][4]);
            o[i][5] = fmaf(p, vb.y, o[i][5]);
            o[i][6] = fmaf(p, vb.z, o[i][6]);
            o[i][7] = fmaf(p, vb.w, o[i][7]);
          }
        }
      }
    }
  }

  float* oh = out + bh * Nq * dv;
#pragma unroll
  for (int i = 0; i < kFRows; ++i) {
    const int row = q0 + qr + i;
    if (row >= Nq) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = (c < 4 ? 0 : 64) + 4 * kg + (c & 3);
      if (col < dv) oh[(long)row * dv + col] = o[i][c] / l[i];
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
  const dim3 grid((Nq + kFQ - 1) / kFQ, BH);
  auto kernel = dv > 64 ? flash_fma_kernel<true> : flash_fma_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kFSmem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kFThreads, kFSmem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Nq, Nk, d, dv,
      scale * 1.4426950408889634f);
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
