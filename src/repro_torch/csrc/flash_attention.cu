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
//   * bf16, any head dims up to 256 (on no serving path; a simple first
//     version, the pair-collapse kernel's former mma.sync design without
//     the pair structure): tensor cores through mma.sync.m16n8k16 (bf16
//     in, f32 accumulate).  A block owns 128 query rows (eight warps of
//     16) and loops over key tiles of BK keys; the scores stay in the
//     accumulator registers and are re-packed as the A operand of the PV
//     product (the flash-attention-2 layout); K and V are row-major in
//     shared memory with rows padded by 16 B and read with ldmatrix
//     (.trans for V).  Shared-memory tiles are zero-padded: Q and K to the
//     next multiple of 32 channels (ldmatrix loads the score product's
//     k-steps in pairs), V to the next multiple of 16 (output n-tiles come
//     in pairs); when d or dv is above 128, both to the next multiple of
//     64 (fewer instantiations).  Only the real channels are read from
//     device memory (16-byte loads when a row is a whole number of 16-byte
//     chunks, element loads otherwise) and only the real output columns
//     are stored; zero channels add exact zeros.  The registers bound the
//     wide dims: a warp's 16 x dv f32 output is dv / 2 registers a lane
//     (128 at dv 256), so above 128 channels Q's fragments are read from
//     shared memory at each k-step instead of held (64 registers at d
//     256), and above dv 128 a key tile is 32 keys instead of 64 (16
//     score registers instead of 32).  No TMA, wgmma, cp.async pipelining
//     or warp specialisation yet.
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
//         instantiations, so the P V loop has no branch;
//       - d or dv above 128 (up to 256) take the wide instantiations, the
//         same design at half the rows and keys so that the tiles fit
//         shared memory (201 KB): four warps (64 query rows a block), key
//         tiles of 32 (2 keys a lane), rows of 256 + 4 floats, 4 x NC
//         output columns a lane for dv <= 64 NC, and P read a value at a
//         time in the P V loop instead of a float4 a row, to keep the
//         128 output registers of dv 256 from spilling.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"  // cp.async, smem_u32; mma.sync fragments (mma_frag.cuh)

namespace {

constexpr int kMaxDim = 256;
constexpr int kNarrow = 128;  // head dims of the narrow instantiations

// ---------------------------------------------------------------------------
// Tensor-core path (bf16)
// ---------------------------------------------------------------------------

constexpr int kBQ = 128;  // query rows a block (eight warps of 16)
constexpr int kMmaThreads = 256;

__host__ __device__ constexpr int pad_qk(int d) { return (d + 31) / 32 * 32; }
__host__ __device__ constexpr int pad_v(int dv) { return (dv + 15) / 16 * 16; }
__host__ __device__ constexpr int pad_wide(int d) { return (d + 63) / 64 * 64; }
// Keys a tile: 32 when a lane holds more than 64 output registers.
__host__ __device__ constexpr int mma_bk(int dvp) { return dvp > kNarrow ? 32 : 64; }

template <int DP, int DVP>
constexpr size_t mma_smem_bytes() {
  constexpr int BK = mma_bk(DVP);
  return sizeof(__nv_bfloat16) *
         ((size_t)(kBQ + BK) * (DP + 8) + (size_t)BK * (DVP + 8));
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

// The A fragment (mma.m16n8k16) of k-step ks of the 16 rows from r0 of a
// shared Q tile of row stride QS.
template <int QS>
__device__ __forceinline__ void q_frag(uint32_t* a, const __nv_bfloat16* Qs,
                                       int r0, int gq, int tq, int ks) {
  const int col = ks * 16 + 2 * tq;
  a[0] = ld32(Qs + (r0 + gq) * QS + col);
  a[1] = ld32(Qs + (r0 + gq + 8) * QS + col);
  a[2] = ld32(Qs + (r0 + gq) * QS + col + 8);
  a[3] = ld32(Qs + (r0 + gq + 8) * QS + col + 8);
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
  constexpr int BK = mma_bk(DVP);  // keys a tile
  constexpr int NT_S = BK / 8;     // n-tiles of the scores
  constexpr bool QREG = DP <= kNarrow;  // Q's fragments held in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kBQ][QS]
  __nv_bfloat16* Ks = Qs + kBQ * QS;                                // [BK][QS]
  __nv_bfloat16* Vs = Ks + BK * QS;                                 // [BK][VS]

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
  uint32_t qa[QREG ? KSTEPS : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) q_frag<QS>(qa[ks], Qs, r0, gq, tq, ks);
  }

  float o[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};  // rows gq and gq + 8
  float l_r[2] = {0.f, 0.f};
  const int lrow = lane & 7, lhalf = (lane >> 3) & 1, lpair = lane >> 4;
  const int nkb = (Nk + BK - 1) / BK;

  for (int kb = 0; kb < nkb; ++kb) {
    __syncthreads();  // the previous tile's K and V are consumed
    load_tile(Ks, QS, DP, kh, kb * BK, BK, Nk, d, tid);
    load_tile(Vs, VS, DVP, vh, kb * BK, BK, Nk, dv, tid);
    __syncthreads();
    if (!active) continue;

    // S = Q K^T for this warp's 16 rows: NT_S n-tiles of 8 keys.  One
    // ldmatrix.x4 brings the B fragments of two k-steps: lane l addresses
    // key row l % 8, channel block (l / 16) * 16 + ((l / 8) % 2) * 8.
    // Each accumulator takes its k-steps in ascending order either way.
    float s[NT_S][4];
    if constexpr (QREG) {
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt) {
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
    } else {
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ks += 2) {
        uint32_t a0[4], a1[4];
        q_frag<QS>(a0, Qs, r0, gq, tq, ks);
        q_frag<QS>(a1, Qs, r0, gq, tq, ks + 1);
#pragma unroll
        for (int nt = 0; nt < NT_S; ++nt) {
          uint32_t b[4];
          ldsm_x4(b, Ks + (nt * 8 + lrow) * QS + lpair * 16 + lhalf * 8 + ks * 16);
          mma_bf16(s[nt], a0, b[0], b[1]);
          mma_bf16(s[nt], a1, b[2], b[3]);
        }
      }
    }
    // Scale the f32 logits (into log2 units), mask keys past Nk, online
    // softmax.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kb * BK + nt * 8 + 2 * tq + (e & 1);
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
    for (int nt = 0; nt < NT_S; ++nt) {
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
    for (int kk = 0; kk < BK / 16; ++kk) {
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

constexpr int kFRows = 8;  // query rows a lane holds

// The CUDA-core path's two geometries: narrow (d, dv <= 128) and wide (up
// to 256, half the rows and keys a block so the tiles fit).
template <bool WIDE>
struct FmaGeom {
  static constexpr int kWarps = WIDE ? 4 : 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kQ = 2 * kFRows * kWarps;  // query rows a block: 16 a warp
  static constexpr int kK = WIDE ? 32 : 64;        // keys a tile
  static constexpr int kJ = kK / 16;               // keys a lane holds
  static constexpr int kDim = WIDE ? kMaxDim : kNarrow;
  static constexpr int kKRow = kDim + 4;  // floats a K row takes in shared memory
  // Q^T, two K and two V tiles, and the block's probabilities: 226 KB
  // narrow, 201 KB wide.
  static constexpr size_t kSmem =
      sizeof(float) * ((size_t)kDim * kQ + 2 * (size_t)kK * kKRow +
                       2 * (size_t)kK * kDim + (size_t)kQ * kK);
};

// Rows row0 .. row0 + G::kK - 1 of a (rows, width) f32 matrix into a
// shared tile of `stride`-float rows by cp.async, a warp a row and a lane
// a chunk: 16-byte copies when the rows are whole 16-byte chunks, 4-byte
// copies otherwise.  Rows past `rows` and columns from width up to the
// next multiple of 4 are written as zeros.
template <class G>
__device__ __forceinline__ void fetch_rows(float* tile, int stride,
                                           const float* src, int row0,
                                           int rows, int width) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int chunks = (width + 3) >> 2;
  for (int r = warp; r < G::kK; r += G::kWarps) {
    const bool ok = row0 + r < rows;
    const float* row = src + (long)(ok ? row0 + r : 0) * width;
    float* dst = tile + r * stride;
    if ((width & 3) == 0) {
      if constexpr (G::kDim <= 128) {  // at most one chunk a lane: no loop
        if (lane < chunks) cp_async16(smem_u32(dst + 4 * lane), row + 4 * lane, ok ? 16 : 0);
      } else {
        for (int c = lane; c < chunks; c += 32)
          cp_async16(smem_u32(dst + 4 * c), row + 4 * c, ok ? 16 : 0);
      }
    } else {
      for (int c = lane; c < 4 * chunks; c += 32)
        cp_async4(smem_u32(dst + c), c < width ? row + c : row,
                  ok && c < width ? 4 : 0);
    }
  }
}

// A warp owns 16 query rows.  Lane (rg, kg) = (lane / 16, lane % 16) holds
// the scores of rows 8rg..8rg+7 against keys kg + 16j (j < G::kJ), and the
// outputs of the same rows at columns 64c + 4kg .. 64c + 4kg + 3 (c < NC):
// 4 NC of them a row.
template <int NC, bool WIDE>
__global__ void __launch_bounds__(FmaGeom<WIDE>::kThreads, 1)
    flash_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int Nq, int Nk, int d, int dv, float scale_log2) {
  using G = FmaGeom<WIDE>;
  constexpr int FQ = G::kQ, FK = G::kK, KJ = G::kJ, DM = G::kDim, KROW = G::kKRow;
  extern __shared__ __align__(16) float fsm[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* Qt = fsm;                 // [DM][FQ]: Q transposed
  float* Ks = Qt + DM * FQ;        // [2][FK][KROW]
  float* Vs = Ks + 2 * FK * KROW;  // [2][FK][DM]
  float* Ps = Vs + 2 * FK * DM;    // [FQ][FK]
  const int q0 = blockIdx.x * FQ;
  const long bh = blockIdx.y;
  const float* qh = q + bh * Nq * d;
  const float* kh = k + bh * Nk * d;
  const float* vh = v + bh * Nk * dv;
  const int rg = lane >> 4, kg = lane & 15;
  const int qr = warp * 2 * kFRows + rg * kFRows;  // this lane's first row
  const int nkb = (Nk + FK - 1) / FK;
  const int groups = (d + 3) >> 2;  // 4-channel steps of the score product

  fetch_rows<G>(Ks, KROW, kh, 0, Nk, d);
  fetch_rows<G>(Vs, DM, vh, 0, Nk, dv);
  cp_async_commit();
  // Q^T once, through registers (lanes on consecutive rows); channels from
  // d up to the next multiple of 4 are zeros.
  for (int i = threadIdx.x; i < FQ * groups; i += G::kThreads) {
    const int r = i % FQ, ch = i / FQ;
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
    Qt[(4 * ch + 0) * FQ + r] = x.x;
    Qt[(4 * ch + 1) * FQ + r] = x.y;
    Qt[(4 * ch + 2) * FQ + r] = x.z;
    Qt[(4 * ch + 3) * FQ + r] = x.w;
  }

  float o[kFRows][4 * NC], m[kFRows], l[kFRows];
#pragma unroll
  for (int i = 0; i < kFRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) o[i][c] = 0.f;
  }

  for (int kb = 0; kb < nkb; ++kb) {
    const int buf = kb & 1;
    // Tile kb has landed for every thread, and every warp is done with
    // tile kb - 1, whose buffers the next copies overwrite.
    cp_async_wait_all();
    __syncthreads();
    if (kb + 1 < nkb) {
      fetch_rows<G>(Ks + (buf ^ 1) * FK * KROW, KROW, kh, (kb + 1) * FK, Nk, d);
      fetch_rows<G>(Vs + (buf ^ 1) * FK * DM, DM, vh, (kb + 1) * FK, Nk, dv);
      cp_async_commit();
    }
    const float* Kt = Ks + buf * FK * KROW;
    const float* Vt = Vs + buf * FK * DM;

    // S = Q K^T: per 4 channels, KJ + 8 float4 reads feed 32 KJ FMAs.
    float s[kFRows][KJ];
#pragma unroll
    for (int i = 0; i < kFRows; ++i)
#pragma unroll
      for (int j = 0; j < KJ; ++j) s[i][j] = 0.f;
    const float* qc = Qt + qr;
    const float* kc = Kt + kg * KROW;
#pragma unroll 4
    for (int g = 0; g < groups; ++g) {
      float4 kf[KJ];
#pragma unroll
      for (int j = 0; j < KJ; ++j)
        kf[j] = *reinterpret_cast<const float4*>(kc + 16 * j * KROW + 4 * g);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* qu = qc + (4 * g + u) * FQ;
        const float4 qa = *reinterpret_cast<const float4*>(qu);
        const float4 qb = *reinterpret_cast<const float4*>(qu + 4);
        const float qv[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          const float kv = u == 0 ? kf[j].x : u == 1 ? kf[j].y : u == 2 ? kf[j].z : kf[j].w;
#pragma unroll
          for (int i = 0; i < kFRows; ++i) s[i][j] = fmaf(qv[i], kv, s[i][j]);
        }
      }
    }

    // Online softmax in log2 units (log2 e folded into the scale), each
    // row reduced over the 16 lanes that hold it; keys past Nk -> -inf.
    const int key0 = kb * FK;
    if (key0 + FK > Nk) {
#pragma unroll
      for (int j = 0; j < KJ; ++j)
        if (key0 + kg + 16 * j >= Nk) {
#pragma unroll
          for (int i = 0; i < kFRows; ++i) s[i][j] = -INFINITY;
        }
    }
#pragma unroll
    for (int i = 0; i < kFRows; ++i) {
      float mx = fmaxf(s[i][0], s[i][1]);  // KJ is 2 or 4
      if constexpr (KJ == 4) mx = fmaxf(mx, fmaxf(s[i][2], s[i][3]));
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
      for (int j = 0; j < KJ; ++j) {
        s[i][j] = exp2_ftz(fmaf(s[i][j], scale_log2, -base));
        sum += s[i][j];
      }
#pragma unroll
      for (int x = 1; x < 16; x <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, x);
      l[i] = alpha * l[i] + sum;
#pragma unroll
      for (int j = 0; j < KJ; ++j) Ps[(qr + i) * FK + kg + 16 * j] = s[i][j];
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) o[i][c] *= alpha;
    }
    __syncwarp();  // the warp's probabilities are written

    // O += P V, four keys a step: narrow, 8 float4 reads of P (one a row)
    // and 4 NC of V feed 128 NC FMAs; wide, P is read a value at a time.
    const float* pr = Ps + qr * FK;
#pragma unroll 4
    for (int kk = 0; kk < FK; kk += 4) {
      float4 pf[WIDE ? 1 : kFRows];
      if constexpr (!WIDE) {
#pragma unroll
        for (int i = 0; i < kFRows; ++i)
          pf[i] = *reinterpret_cast<const float4*>(pr + i * FK + kk);
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float* vr = Vt + (kk + t) * DM;
        float4 vc[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c)
          vc[c] = *reinterpret_cast<const float4*>(vr + 64 * c + 4 * kg);
#pragma unroll
        for (int i = 0; i < kFRows; ++i) {
          float p;
          if constexpr (WIDE) {
            p = pr[i * FK + kk + t];
          } else {
            p = t == 0 ? pf[i].x : t == 1 ? pf[i].y : t == 2 ? pf[i].z : pf[i].w;
          }
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            o[i][4 * c + 0] = fmaf(p, vc[c].x, o[i][4 * c + 0]);
            o[i][4 * c + 1] = fmaf(p, vc[c].y, o[i][4 * c + 1]);
            o[i][4 * c + 2] = fmaf(p, vc[c].z, o[i][4 * c + 2]);
            o[i][4 * c + 3] = fmaf(p, vc[c].w, o[i][4 * c + 3]);
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
    for (int c = 0; c < 4 * NC; ++c) {
      const int col = 64 * (c >> 2) + 4 * kg + (c & 3);
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

// d or dv above 128: both padded to a multiple of 64.
template <int DP>
cudaError_t launch_mma_wide(const void* q, const void* k, const void* v,
                            void* out, int BH, int Nq, int Nk, int d, int dv,
                            float scale, cudaStream_t s) {
  switch (pad_wide(dv)) {
#define FLASH_WIDE(DVP)                                                     \
  case DVP:                                                                 \
    if constexpr (DP > kNarrow || DVP > kNarrow)                            \
      return launch_mma<DP, DVP>(q, k, v, out, BH, Nq, Nk, d, dv, scale, s); \
    else                                                                    \
      return cudaErrorInvalidValue;
    FLASH_WIDE(64) FLASH_WIDE(128) FLASH_WIDE(192) FLASH_WIDE(256)
#undef FLASH_WIDE
    default:
      return cudaErrorInvalidValue;
  }
}

template <int NC, bool WIDE>
cudaError_t launch_fma_nc(const void* q, const void* k, const void* v, void* out,
                          int BH, int Nq, int Nk, int d, int dv, float scale,
                          cudaStream_t s) {
  using G = FmaGeom<WIDE>;
  const dim3 grid((Nq + G::kQ - 1) / G::kQ, BH);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fma_kernel<NC, WIDE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)G::kSmem);
  if (err != cudaSuccess) return err;
  flash_fma_kernel<NC, WIDE><<<grid, G::kThreads, G::kSmem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Nq, Nk, d, dv,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

cudaError_t launch_fma(const void* q, const void* k, const void* v, void* out,
                       int BH, int Nq, int Nk, int d, int dv, float scale,
                       cudaStream_t s) {
  if (d <= kNarrow && dv <= kNarrow)
    return dv > 64 ? launch_fma_nc<2, false>(q, k, v, out, BH, Nq, Nk, d, dv, scale, s)
                   : launch_fma_nc<1, false>(q, k, v, out, BH, Nq, Nk, d, dv, scale, s);
  switch ((dv + 63) / 64) {
    case 1: return launch_fma_nc<1, true>(q, k, v, out, BH, Nq, Nk, d, dv, scale, s);
    case 2: return launch_fma_nc<2, true>(q, k, v, out, BH, Nq, Nk, d, dv, scale, s);
    case 3: return launch_fma_nc<3, true>(q, k, v, out, BH, Nq, Nk, d, dv, scale, s);
    case 4: return launch_fma_nc<4, true>(q, k, v, out, BH, Nq, Nk, d, dv, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (BH, Nq, d), k: (BH, Nk, d), v: (BH, Nk, dv), out: (BH, Nq, dv),
// contiguous, float32 (is_bf16 = 0) or bfloat16, 16-byte aligned; d and
// dv up to 256.  bf16 takes the tensor cores, float32 the CUDA cores.
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
  if (d > kNarrow || dv > kNarrow) {
    switch (pad_wide(d)) {
      case 64: return (int)launch_mma_wide<64>(q, k, v, out, BH, Nq, Nk, d, dv, scale, s);
      case 128: return (int)launch_mma_wide<128>(q, k, v, out, BH, Nq, Nk, d, dv, scale, s);
      case 192: return (int)launch_mma_wide<192>(q, k, v, out, BH, Nq, Nk, d, dv, scale, s);
      case 256: return (int)launch_mma_wide<256>(q, k, v, out, BH, Nq, Nk, d, dv, scale, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
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
