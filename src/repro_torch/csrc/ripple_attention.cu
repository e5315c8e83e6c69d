// Pair-collapse flash attention (TimeRipple's structured execution,
// DESIGN.md §4).
//
// Replaces: src/repro/kernels/ripple/kernel.py::ripple_attention_kernel
//   (body _ripple_kernel, wrapper ops.py::ripple_attention_pallas).
//
// Operands are the snapped (BH, N, d) Q, K and V with N even; token 2p is
// the representative of pair p and token 2p+1 its follower.  Per tile of
// kTile pairs the wrapper passes an int32 flag, 1 when every pair of the
// tile is value-identical (the follower fully snapped).  With f32
// running (m, l, acc) states per query row:
//   * a collapsed K tile does one score product against the representative
//     keys, counts each probability twice in the row sum, and one PV product
//     against v_even + v_odd - the exact collapse identity;
//   * a collapsed Q tile computes only the representative rows and copies
//     their output to the followers;
//   * a mixed tile runs dense on the snapped values.
// Pairs past N/2 in the last tile are masked by index (score -inf), so
// no padding channel is needed.
//
// Bound on the H100: arithmetic.  4*N^2*d flops per head for dense
// attention against 4*N*d*2 bytes of bf16 operands: hundreds of flops per
// byte at serving length, above the card's ~295 flops/B bf16 ridge.
//
// Design (simple first versions: blocks own query tiles of kTile pairs
// and loop over tiles of kTile key pairs; both halves of a query tile -
// representative and follower rows - share each K/V tile):
//   * bf16 with head dims 32/64/72/128: tensor cores through
//     mma.sync.m16n8k16 (bf16 in, f32 accumulate), two query tiles per
//     block, four warps of 16 query rows per tile, the flash-attention-2
//     register layout (scores stay in
//     the accumulator registers and are re-packed as the A operand of the
//     PV product), K and V row-major in shared memory with rows padded by
//     16 B, B fragments loaded with ldmatrix (.trans for V) free of bank
//     conflicts.  A head dim that is not a multiple of 32 (DiT-XL/2's 72)
//     is zero-padded in shared memory only: Q and K tiles to the next
//     multiple of 32 channels (ldmatrix loads the score product's k-steps
//     in pairs), the V tile to the next multiple of 16 (output n-tiles
//     come in pairs); only the real channels are read from device memory
//     and only the real output columns are stored.  Zero channels add
//     exact zeros to the scores, so the result is that of the unpadded
//     product.  The
//     collapsed V tile is v_even + v_odd summed in f32 and rounded once to
//     bf16, as the JAX kernel rounds it to the operand dtype.
//   * float32 (and other head dims): CUDA-core FMAs in f32, 4x4 scores and
//     8x4 outputs per thread from f32 tiles in shared memory.
// Neither uses TMA, wgmma, cp.async pipelining or warp specialisation yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_frag.cuh"

namespace {

constexpr int kTile = 32;         // pairs per query tile and per key tile
constexpr int kRows = 2 * kTile;  // rows (even + odd) of a full tile
constexpr int kMaxDim = 128;

// ---------------------------------------------------------------------------
// Tensor-core path (bf16)
// ---------------------------------------------------------------------------

// A block holds kQTiles query tiles (4 warps of 16 rows each), which share
// every K/V tile it loads.
constexpr int kQTiles = 2;
constexpr int kMmaThreads = 128 * kQTiles;

// Channels of the shared-memory tiles: the score product's k-steps are
// loaded in pairs (32 channels), the output's n-tiles in pairs (16).
__host__ __device__ constexpr int pad_qk(int d) { return (d + 31) / 32 * 32; }
__host__ __device__ constexpr int pad_v(int dv) { return (dv + 15) / 16 * 16; }

template <int D, int DV>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * kRows *
         ((size_t)(kQTiles + 1) * (pad_qk(D) + 8) + (pad_v(DV) + 8));
}

template <int D, int DV>
__global__ void __launch_bounds__(kMmaThreads)
    ripple_mma_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ out,
                      const int* __restrict__ qflags,
                      const int* __restrict__ kflags, int N, int nqb,
                      float scale_log2) {
  static_assert(D % 8 == 0 && DV % 8 == 0, "rows load in 16-byte chunks");
  constexpr int DP = pad_qk(D);    // channels of the Q and K tiles
  constexpr int DVP = pad_v(DV);   // channels of the V tile
  constexpr int QS = DP + 8;       // row stride of Q and K tiles (bf16)
  constexpr int VS = DVP + 8;      // row stride of the V tile
  constexpr int KSTEPS = DP / 16;  // k-steps of the score product
  constexpr int NT_O = DVP / 8;    // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [QT*64][QS]
  __nv_bfloat16* Ks = Qs + kQTiles * kRows * QS;                    // [64][QS]
  __nv_bfloat16* Vs = Ks + kRows * QS;                              // [64][VS]

  const int P = N / 2;
  const int nkb = (P + kTile - 1) / kTile;
  const long bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;  // mma group / thread in group
  const int wl = warp % 4;                   // warp within its query tile
  const int qb = blockIdx.x * kQTiles + warp / 4;  // this warp's query tile

  const __nv_bfloat16* qh = q + bh * N * D;
  const __nv_bfloat16* kh = k + bh * N * D;
  const __nv_bfloat16* vh = v + bh * N * DV;
  const int qf = qb < nqb ? qflags[bh * nqb + qb] : 1;

  // Q tiles: local row r of tile t is pair (first + t)*kTile + r % kTile,
  // the follower if r >= kTile.  Chunks past the real channels are zero.
  constexpr int QCH = DP / 8;  // 16-byte chunks per tile row
  for (int i = tid; i < kQTiles * kRows * QCH; i += kMmaThreads) {
    const int row = i / QCH, ch = i % QCH;
    const int r = row % kRows;
    const int tb = blockIdx.x * kQTiles + row / kRows;
    const int p = tb * kTile + (r % kTile);
    uint4 val = make_uint4(0, 0, 0, 0);
    if (tb < nqb && p < P && ch < D / 8)
      val = *reinterpret_cast<const uint4*>(
          qh + (long)(2 * p + (r >= kTile)) * D + ch * 8);
    *reinterpret_cast<uint4*>(Qs + row * QS + ch * 8) = val;
  }
  __syncthreads();

  // In each query tile warps 0-1 own the representative rows, 2-3 the
  // followers; a collapsed query tile leaves its follower warps idle.
  const bool active = qb < nqb && !(qf && wl >= 2);
  const int r0 = warp * 16;
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

  for (int kb = 0; kb < nkb; ++kb) {
    const int kf = kflags[bh * nkb + kb];
    const int nkeys = kf ? kTile : kRows;  // key j: pair j % kTile, odd if j >= kTile
    __syncthreads();  // the previous tile's K and V are consumed
    for (int i = tid; i < nkeys * QCH; i += kMmaThreads) {
      const int j = i / QCH, ch = i % QCH;
      const int p = kb * kTile + (j % kTile);
      uint4 val = make_uint4(0, 0, 0, 0);
      if (p < P && ch < D / 8)
        val = *reinterpret_cast<const uint4*>(
            kh + (long)(2 * p + (j >= kTile)) * D + ch * 8);
      *reinterpret_cast<uint4*>(Ks + j * QS + ch * 8) = val;
    }
    constexpr int VCH = DVP / 8;
    for (int i = tid; i < nkeys * VCH; i += kMmaThreads) {
      const int j = i / VCH, ch = i % VCH;
      const int p = kb * kTile + (j % kTile);
      __align__(16) __nv_bfloat16 vals[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) vals[e] = __float2bfloat16_rn(0.f);
      if (p < P && ch < DV / 8) {
        const uint4 a = *reinterpret_cast<const uint4*>(
            vh + (long)(2 * p + (kf ? 0 : (j >= kTile))) * DV + ch * 8);
        const __nv_bfloat16* av = reinterpret_cast<const __nv_bfloat16*>(&a);
        if (kf) {
          const uint4 b = *reinterpret_cast<const uint4*>(
              vh + (long)(2 * p + 1) * DV + ch * 8);
          const __nv_bfloat16* bv = reinterpret_cast<const __nv_bfloat16*>(&b);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            vals[e] = __float2bfloat16_rn(
                __fadd_rn(__bfloat162float(av[e]), __bfloat162float(bv[e])));
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) vals[e] = av[e];
        }
      }
      *reinterpret_cast<uint4*>(Vs + j * VS + ch * 8) =
          *reinterpret_cast<const uint4*>(vals);
    }
    __syncthreads();
    if (!active) continue;

    // S = Q K^T for this warp's 16 rows: up to 8 n-tiles of 8 keys.  One
    // ldmatrix.x4 brings the B fragments of two k-steps: lane l addresses
    // key row l % 8, channel block (l / 16) * 16 + ((l / 8) % 2) * 8.
    const int ntiles = nkeys / 8;
    const int lrow = lane & 7, lhalf = (lane >> 3) & 1, lpair = lane >> 4;
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      if (nt >= ntiles) continue;
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
    // Scale into log2 units, mask pairs past N/2, online softmax.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt >= ntiles) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = nt * 8 + 2 * tq + (e & 1);
        const int p = kb * kTile + (j % kTile);
        s[nt][e] = p < P ? s[nt][e] * scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_r[h], mx[h]);
      alpha[h] = exp2f(m_r[h] - m_new);
      m_r[h] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (nt >= ntiles) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(s[nt][e] - m_r[e >> 1]);
        sum[e >> 1] += s[nt][e];
      }
    }
    const float w = kf ? 2.f : 1.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l_r[h] = alpha[h] * l_r[h] + w * sum[h];
    }
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    // O += P V: the score accumulators of n-tiles 2kk, 2kk+1 are the A
    // fragment of k-step kk.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (2 * kk >= ntiles) continue;
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
  __nv_bfloat16* oh = out + bh * N * DV;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wl * 16 + gq + 8 * h;  // row within the query tile
    const int p = qb * kTile + (r % kTile);
    if (p >= P) continue;
    const int tok = 2 * p + (r >= kTile);
    const float inv_l = 1.f / l_r[h];
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      if (n * 8 >= DV) continue;  // padding columns
      const uint32_t val =
          pack_bf16(o[n][2 * h] * inv_l, o[n][2 * h + 1] * inv_l);
      const int col = n * 8 + 2 * tq;
      *reinterpret_cast<uint32_t*>(oh + (long)tok * DV + col) = val;
      if (qf)  // follower copy
        *reinterpret_cast<uint32_t*>(oh + (long)(tok + 1) * DV + col) = val;
    }
  }
}

// ---------------------------------------------------------------------------
// CUDA-core path (f32, any head dim <= 128)
// ---------------------------------------------------------------------------

constexpr int kFmaThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kFmaThreads)
    ripple_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out,
                      const int* __restrict__ qflags,
                      const int* __restrict__ kflags, int N, int d, int dv,
                      float scale) {
  extern __shared__ float sm[];
  const int P = N / 2;
  const int nqb = gridDim.x;
  const int nkb = (P + kTile - 1) / kTile;
  const int qb = blockIdx.x;
  const long bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int dp = d + 1;
  const int sp = kRows + 1;

  float* Qs = sm;                // [kRows][d + 1]
  float* Ks = Qs + kRows * dp;   // [kRows][d + 1]
  float* Vs = Ks + kRows * dp;   // [kRows][kMaxDim]
  float* Ss = Vs + kRows * kMaxDim;  // [kRows][kRows + 1]
  float* m_s = Ss + kRows * sp;  // [kRows]
  float* l_s = m_s + kRows;      // [kRows]
  float* a_s = l_s + kRows;      // [kRows]

  const T* qh = q + bh * N * d;
  const T* kh = k + bh * N * d;
  const T* vh = v + bh * N * dv;

  const int qf = qflags[bh * nqb + qb];
  const int nrows = qf ? kTile : kRows;  // row r: pair r % kTile, odd if r >= kTile

  for (int i = tid; i < kRows * d; i += kFmaThreads) {
    const int r = i / d, c = i % d;
    const int p = qb * kTile + (r % kTile);
    const int tok = 2 * p + (r >= kTile);
    Qs[r * dp + c] = p < P ? to_f(qh[(long)tok * d + c]) : 0.f;
  }
  for (int i = tid; i < kRows * kMaxDim; i += kFmaThreads) Vs[i] = 0.f;
  for (int r = tid; r < kRows; r += kFmaThreads) {
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

  for (int kb = 0; kb < nkb; ++kb) {
    const int kf = kflags[bh * nkb + kb];
    const int nkeys = kf ? kTile : kRows;  // key j: pair j % kTile, odd if j >= kTile
    __syncthreads();  // the previous tile's K, V and S are consumed
    for (int i = tid; i < kRows * d; i += kFmaThreads) {
      const int j = i / d, c = i % d;
      const int p = kb * kTile + (j % kTile);
      const int tok = 2 * p + (j >= kTile);
      Ks[j * dp + c] = (p < P && j < nkeys) ? to_f(kh[(long)tok * d + c]) : 0.f;
    }
    for (int i = tid; i < nkeys * dv; i += kFmaThreads) {
      const int j = i / dv, c = i % dv;
      const int p = kb * kTile + (j % kTile);
      float val = 0.f;
      if (p < P) {
        if (kf)
          val = __fadd_rn(to_f(vh[(long)(2 * p) * dv + c]),
                          to_f(vh[(long)(2 * p + 1) * dv + c]));
        else
          val = to_f(vh[(long)(2 * p + (j >= kTile)) * dv + c]);
      }
      Vs[j * kMaxDim + c] = val;
    }
    __syncthreads();

    // S = scale * Q K^T over the live rows and keys; padded pairs -> -inf.
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
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kk = tx + 16 * j;
        if (r >= nrows || kk >= nkeys) continue;
        const int p = kb * kTile + (kk % kTile);
        Ss[r * sp + kk] = p < P ? sc[i][j] * scale : -INFINITY;
      }
    }
    __syncthreads();

    // Online softmax: four threads per row.
    {
      const int r = tid / 4, part = tid % 4;
      float mx = -INFINITY;
      if (r < nrows)
        for (int kk = part; kk < nkeys; kk += 4) mx = fmaxf(mx, Ss[r * sp + kk]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = r < nrows ? m_s[r] : 0.f;
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      if (r < nrows)
        for (int kk = part; kk < nkeys; kk += 4) {
          const float p = expf(Ss[r * sp + kk] - m_new);
          Ss[r * sp + kk] = p;
          sum += p;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (r < nrows && part == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = alpha * l_s[r] + (kf ? 2.f : 1.f) * sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = alpha * acc + P V (rows past nrows hold stale values and are
    // never written out).
    float pv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = warp + 8 * i;
      const float alpha = r < nrows ? a_s[r] : 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
    }
    for (int kk = 0; kk < nkeys; ++kk) {
      float vv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = Vs[kk * kMaxDim + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = warp + 8 * i;
        pv[i] = r < nrows ? Ss[r * sp + kk] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  T* oh = out + bh * N * dv;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = warp + 8 * i;
    if (r >= nrows) continue;
    const int p = qb * kTile + (r % kTile);
    if (p >= P) continue;
    const float inv_l = 1.f / l_s[r];
    const int tok = 2 * p + (r >= kTile);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = lane + 32 * j;
      if (col >= dv) continue;
      const float o = acc[i][j] * inv_l;
      from_f(oh + (long)tok * dv + col, o);
      if (qf) from_f(oh + (long)(tok + 1) * dv + col, o);  // follower copy
    }
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out,
                       const int* qf, const int* kf, int BH, int N,
                       float scale, cudaStream_t s) {
  const int P = N / 2;
  const int nqb = (P + kTile - 1) / kTile;
  const dim3 grid((nqb + kQTiles - 1) / kQTiles, BH);
  constexpr size_t smem = mma_smem_bytes<D, D>();
  cudaError_t err = cudaFuncSetAttribute(
      ripple_mma_kernel<D, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  ripple_mma_kernel<D, D><<<grid, kMmaThreads, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      qf, kf, N, nqb, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* out,
                       const int* qf, const int* kf, int BH, int N, int d,
                       int dv, float scale, cudaStream_t s) {
  const int P = N / 2;
  const dim3 grid((P + kTile - 1) / kTile, BH);
  const size_t smem =
      sizeof(float) * ((size_t)kRows * (d + 1) * 2 + (size_t)kRows * kMaxDim +
                       (size_t)kRows * (kRows + 1) + 3 * kRows);
  cudaError_t err = cudaFuncSetAttribute(
      ripple_fma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  ripple_fma_kernel<T><<<grid, kFmaThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), qf, kf, N, d, dv, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ripple_tile_pairs() { return kTile; }

// q, k: (BH, N, d); v, out: (BH, N, dv), contiguous, float32 (is_bf16 = 0)
// or bfloat16; qflags, kflags: (BH, ceil(N/2 / kTile)) int32.  bf16 with
// d == dv in {32, 64, 72, 128} takes the tensor-core path.  Returns the
// CUDA error of the launch (0 on success).
extern "C" int ripple_attention_launch(const void* q, const void* k,
                                       const void* v, void* out,
                                       const void* qflags, const void* kflags,
                                       int is_bf16, int BH, int N, int d,
                                       int dv, float scale, void* stream) {
  if (BH < 1 || BH > 65535 || N < 2 || N % 2 || d < 1 || d > kMaxDim ||
      dv < 1 || dv > kMaxDim)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* qf = static_cast<const int*>(qflags);
  const int* kf = static_cast<const int*>(kflags);
  if (is_bf16 && d == dv) {
    switch (d) {
      case 32: return (int)launch_mma<32>(q, k, v, out, qf, kf, BH, N, scale, s);
      case 64: return (int)launch_mma<64>(q, k, v, out, qf, kf, BH, N, scale, s);
      case 72: return (int)launch_mma<72>(q, k, v, out, qf, kf, BH, N, scale, s);
      case 128: return (int)launch_mma<128>(q, k, v, out, qf, kf, BH, N, scale, s);
      default: break;
    }
  }
  if (is_bf16)
    return (int)launch_fma<__nv_bfloat16>(q, k, v, out, qf, kf, BH, N, d, dv,
                                          scale, s);
  return (int)launch_fma<float>(q, k, v, out, qf, kf, BH, N, d, dv, scale, s);
}

// Which path a call takes: 1 for the tensor-core kernel, 0 for CUDA cores.
extern "C" int ripple_uses_tensor_cores(int is_bf16, int d, int dv) {
  return is_bf16 && d == dv && (d == 32 || d == 64 || d == 72 || d == 128);
}
