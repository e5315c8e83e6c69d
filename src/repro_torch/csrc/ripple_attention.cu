// Pair-collapse flash attention (TimeRipple's structured execution,
// DESIGN.md §4).
//
// Replaces: src/repro/kernels/ripple/kernel.py::ripple_attention_kernel
//   (body _ripple_kernel, wrapper ops.py::ripple_attention_pallas).
//
// Operands are the snapped (BH, N, d) Q, K and V with N even; token 2p is
// the representative of pair p and token 2p+1 its follower.  Per tile of
// kFlagTile key pairs the wrapper passes an int32 flag, 1 when every pair
// of the tile is value-identical (the follower fully snapped).  Dense
// attention on the snapped operands is the exact answer; the collapse
// identities only skip work:
//   * a collapsed key tile needs one score product against the
//     representative keys, each probability counted twice;
//   * a collapsed query tile needs only the representative rows;
//   * a mixed tile runs dense on the snapped values.
// Pairs past N/2 in the last tile are masked by index (score -inf).
//
// Bound on the H100: arithmetic.  4*N^2*d flops per head for dense
// attention against 4*N*d*2 bytes of bf16 operands: hundreds of flops per
// byte at serving length, above the card's ~295 flops/B bf16 ridge.  So
// the design feeds the tensor cores at their Hopper rate and keeps the
// loads off the critical path:
//   * bf16 with d == dv in {32, 40, 64, 72, 80, 128, 160}: wgmma.mma_async
//     (sm_90a),
//     with the TMA, mbarrier and wgmma helpers of hopper.cuh (shared with
//     sparse_attention.cu).
//     A block owns a query tile of 64 pairs: consumer warpgroup 0 the 64
//     representative rows, warpgroup 1 the 64 follower rows (a collapsed
//     query tile computes its followers anyway: snapped followers equal
//     their representatives bit for bit, so the result is the same, and no
//     query flags are needed).  A third, producer warpgroup (one thread
//     issues; setmaxnreg hands its registers to the consumers, though
//     ptxas compiles every path within the launch bound, below) streams key stages of 64 pairs through a ring of as many stages as
//     227 KB of shared memory holds (2 at d 160, 3 at d 128, 5 at d 72 and
//     80) with TMA;
//     mbarriers say when a stage's K and V are full (transaction bytes)
//     and when both consumers have released it.  The ring's depth matters:
//     the stages come from L2 with a latency of several stages' compute.
//   * Each operand is seen by TMA as a 4-D tensor (d, 2, P, BH), head dim
//     innermost: a box at parity 0 brings the representatives of 64 pairs
//     as contiguous shared rows, a box at parity 1 the followers, with no
//     gather pass.  P and BH stay separate dimensions, so the ragged last
//     tile of a head is zero-filled by TMA instead of reading the next
//     head.  A key stage holds 128 rows, representatives first.
//   * Shared tiles are stored in swizzled channel boxes, written by TMA
//     with a swizzle and read by wgmma through descriptors of the same
//     mode: 128 B rows of 64 channels (d 64, 128; d 32: 64 B rows of 32).
//     Other head dims add one tail box (hopper.cuh, Boxes): d 72 pads to
//     80 channels, one 64-channel box plus a 16-channel tail box in 32 B
//     rows, whose map's innermost extent is 72, so TMA zero-fills channels
//     72-79; the score product adds exact zeros and the PV product's tail
//     (N = 16) columns 72-79 are never stored.  (Five 16-channel boxes load
//     the same tile at half the rate.)  d 80 is 64 + 16 with no padding;
//     d 40 a 32-channel box in 64 B rows plus a 16-channel tail padded the
//     same way (channels 40-47, K = 48 for the score product, the PV
//     product at N = 32 + 16); d 160 is 64 + 64 + a 32-channel tail in 64 B
//     rows.
//   * S = Q K^T is wgmma SS (Q and K both K-major); O += P V is wgmma RS:
//     P is re-packed from the f32 score accumulators into bf16 A
//     registers, V is the MN-major B operand (row-major keys x dv,
//     transposed by the instruction).  Softmax runs online in f32 in log2
//     units: the running max of the raw scores, each exponent one FFMA
//     into ex2.approx.ftz (built without --fmad=false), O rescaled by
//     alpha.  Each consumer runs its stages in order (S, softmax, PV):
//     ptxas keeps the kernel at the 168 registers a thread of the launch
//     bound, and holding the next stage's scores while the PV product
//     runs does not fit there (it spills and serialises the wgmmas).
//     Above 128 channels (d 160) the O accumulator alone takes DP / 2
//     registers a thread, so a dense stage runs as two halves of 64 keys
//     (representatives, then followers), each S -> softmax -> PV over its
//     own 64 V rows: 64 x 64 scores live at a time instead of 64 x 128.
//   * A collapsed key tile loads its 64 representative keys only and runs
//     the score product at N = 64; the PV product runs over both halves of
//     V with the probabilities duplicated (p * v_even + p * v_odd, exact
//     up to rounding, no V sum in shared memory), and the row sum counts
//     each probability twice.
//   * float32 (and other head dims up to 256): CUDA-core FMAs in f32, 4x4
//     scores and 8x4 outputs per thread (8x8 for dv above 128) from f32
//     tiles in shared memory, 32-pair tiles reading the 64-pair flags (a
//     collapsed flag covers both of its halves).

#include <math.h>
#include <stdint.h>

#include "hopper.cuh"  // TMA, mbarrier, wgmma helpers; pack_bf16, to_f, from_f

namespace {

constexpr int kFlagTile = 64;     // pairs per flag = the wgmma path's tile
constexpr int kTile = 32;         // pairs per tile of the CUDA-core path
constexpr int kSubTiles = kFlagTile / kTile;
constexpr int kRows = 2 * kTile;  // rows (even + odd) of a CUDA-core tile
constexpr int kMaxDim = 256;  // both paths, as the fused Δ-check kernel

// ---------------------------------------------------------------------------
// Tensor-core path (bf16): TMA ring, producer warpgroup, wgmma
// ---------------------------------------------------------------------------

constexpr int kPairs = kFlagTile;        // pairs per query tile and key stage
constexpr int kStageKeys = 2 * kPairs;   // rows of a dense key stage
constexpr int kConsumers = 2;            // representative and follower rows
constexpr int kWgmmaThreads = 128 * (kConsumers + 1);  // + the producer
constexpr int kMaxStages = 6;

// A head dim's channel boxes (hopper.cuh) and the ring of key stages.
template <int D>
struct Tiles : Boxes<D> {
  using B = Boxes<D>;
  // As many K/V stages as a block's 227 KB of shared memory holds (up to
  // 6): the loads come from L2 with a latency of several stages' compute.
  // At d 64, 5 or 6 stages make ptxas serialise the wgmmas for want of
  // registers (its C7511 "Potential Performance Loss" note), 4 do not.
  static constexpr int STAGES =
      cmin(D == 64 ? 4 : kMaxStages,
           (kSmemLimit - 1024 - 8 * (1 + 3 * kMaxStages) -
            kConsumers * kPairs * B::DP * 2) /
               (2 * kStageKeys * B::DP * 2));
  static constexpr int Q_BYTES = kPairs * B::DP * 2;  // one warpgroup's rows
  static constexpr int KV_BYTES = kStageKeys * B::DP * 2;
  static constexpr int TILE_BYTES = kConsumers * Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int BARRIERS = 1 + 3 * STAGES;
  static constexpr int SMEM = 1024 + TILE_BYTES + 8 * BARRIERS;  // + alignment
  // Dense stages in two 64-key halves: O's DP / 2 registers a thread
  // leave no room for 64 x 128 scores beside them above 128 channels.
  static constexpr bool SPLIT = B::DP > 128;
  static_assert(STAGES >= 2 && SMEM <= kSmemLimit, "a ring of 2+ stages fits");
};

// How a consumer runs one key stage: the whole stage (128 scores a row);
// a collapsed stage (64 representative keys, each probability fed to both
// halves of V); or, when SPLIT, a dense stage as its representative half
// then its follower half, each against its own 64 V rows.
enum StageMode { kDense, kCollapsed, kRepHalf, kFolHalf };

template <int MODE>
struct Stage {
  static constexpr int KEYS = MODE == kDense ? kStageKeys : kPairs;  // score N
  static constexpr int KROW0 = MODE == kFolHalf ? kPairs : 0;  // first K row
  static constexpr int V0 = MODE == kFolHalf ? 4 : 0;          // PV k-steps
  static constexpr int V1 = MODE == kRepHalf ? 4 : kStageKeys / 16;
  static constexpr float W = MODE == kCollapsed ? 2.f : 1.f;   // keys a prob.
};

// The online-softmax state of one consumer thread: rows r and r + 8 of its
// warp's 16 (wgmma accumulator layout).  s holds a stage's scores, then
// their exponentials; pk the probabilities in bf16 for the PV product; o
// the output over DP columns.
template <int D>
struct RowState {
  static constexpr int NS = Tiles<D>::SPLIT ? kPairs : kStageKeys;
  float s[NS / 2];
  uint32_t pk[NS / 16][4];
  float o[Tiles<D>::DP / 2];
  float m[2], l[2];
};

// Issue S = Q K^T for one stage (N = 64 keys from row KROW0 of the stage
// for a collapsed stage or a half, else 128) and commit it as one wgmma
// group.
template <int D, int MODE>
__device__ __forceinline__ void issue_scores(RowState<D>& st, uint32_t q_tile,
                                             uint32_t k_tile) {
  using S = Stage<MODE>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < Tiles<D>::KSTEPS; ++kk)
    wgmma_ss<S::KEYS>(st.s, kmajor_desc<D, kPairs>(q_tile, kk),
                      kmajor_desc<D, kStageKeys>(k_tile, kk, S::KROW0),
                      kk > 0);
  wgmma_commit();
}

// Issue O += P V over the stage's V rows 16 V0 .. 16 V1 (representatives,
// then followers; V is the MN-major operand) from the probabilities in pk;
// a collapsed stage feeds each probability to both halves.  The tail box's
// columns are a second product of N = 16 or 32.  Commits one wgmma group.
template <int D, int MODE>
__device__ __forceinline__ void issue_pv(RowState<D>& st, uint32_t v_tile) {
  using T = Tiles<D>;
  using S = Stage<MODE>;
  constexpr int KP = S::KEYS / 16;  // k-steps of P
  wgmma_fence();
#pragma unroll
  for (int kk = S::V0; kk < S::V1; ++kk) {
    wgmma_rs<T::MAIN_C>(
        st.o, st.pk[(kk - S::V0) % KP],
        make_desc(v_tile + kk * 16 * T::MAIN_SW, kStageKeys * T::MAIN_SW,
                  8 * T::MAIN_SW, T::MAIN_MODE));
    if constexpr (T::TAIL_C > 0)
      wgmma_rs<T::TAIL_C>(
          st.o + T::MAIN_C / 2, st.pk[(kk - S::V0) % KP],
          make_desc(v_tile + T::NMAIN * kStageKeys * T::MAIN_SW +
                        kk * 16 * T::TAIL_SW,
                    kStageKeys * T::TAIL_SW, 8 * T::TAIL_SW, T::TAIL_MODE));
  }
  wgmma_commit();
}

// Online softmax of the raw scores in s: mask pairs past P in the last
// tile, update the running max (log2 units: the scale is positive, so the
// max of the raw scores scales to it and each exponent is one FFMA) and
// the row sum, leave the f32 exponentials in s and return O's rescale
// factors.
template <int D, int MODE>
__device__ __forceinline__ float2 softmax_scores(RowState<D>& st, int pair0,
                                                 int P, float scale_log2) {
  constexpr int NS = Stage<MODE>::KEYS;
  if (pair0 + kPairs > P) {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int i = 0; i < NS / 2; ++i) {
      const int col = (i / 4) * 8 + (lane % 4) * 2 + (i & 1);
      if (pair0 + col % kPairs >= P) st.s[i] = -INFINITY;
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < NS / 2; ++i)
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], st.s[i]);
  float alpha[2], neg_m[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(st.m[h], mx[h] * scale_log2);
    alpha[h] = exp2_ftz(st.m[h] - m_new);
    st.m[h] = m_new;
    neg_m[h] = -m_new;
  }
#pragma unroll
  for (int i = 0; i < NS / 2; ++i) {
    st.s[i] = exp2_ftz(fmaf(st.s[i], scale_log2, neg_m[(i >> 1) & 1]));
    sum[(i >> 1) & 1] += st.s[i];
  }
  const float w = Stage<MODE>::W;  // a collapsed probability stands for two keys
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    st.l[h] = alpha[h] * st.l[h] + w * sum[h];
  }
  return make_float2(alpha[0], alpha[1]);
}

// O *= alpha, then the exponentials in s become the bf16 A operand of the
// next PV product: k-step kk is score columns 16kk..16kk+15 (accumulator
// chunks 2kk and 2kk + 1, the row-major A fragment of m64k16).
template <int D, int MODE>
__device__ __forceinline__ void rescale_and_pack(RowState<D>& st,
                                                 float2 alpha) {
#pragma unroll
  for (int c = 0; c < Tiles<D>::DP / 8; ++c) {
    st.o[c * 4 + 0] *= alpha.x;
    st.o[c * 4 + 1] *= alpha.x;
    st.o[c * 4 + 2] *= alpha.y;
    st.o[c * 4 + 3] *= alpha.y;
  }
#pragma unroll
  for (int kk = 0; kk < Stage<MODE>::KEYS / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      st.pk[kk][j] = pack_bf16(st.s[kk * 8 + 2 * j], st.s[kk * 8 + 2 * j + 1]);
}

// One key stage (or half of one) for one consumer warpgroup: S = Q K^T,
// online softmax, O += P V once the stage's V has arrived on v_bar (phase
// `parity`).
template <int D, int MODE>
__device__ __forceinline__ void consume_stage(RowState<D>& st, uint32_t q_tile,
                                              uint32_t k_tile, uint32_t v_tile,
                                              uint32_t v_bar, uint32_t parity,
                                              int pair0, int P,
                                              float scale_log2) {
  issue_scores<D, MODE>(st, q_tile, k_tile);
  wgmma_wait_all();
  pin<RowState<D>::NS / 2>(st.s);
  rescale_and_pack<D, MODE>(
      st, softmax_scores<D, MODE>(st, pair0, P, scale_log2));
  mbar_wait(v_bar, parity);
  issue_pv<D, MODE>(st, v_tile);
  wgmma_wait_all();
  pin<Tiles<D>::DP / 2>(st.o);
}

// The three operands' tensor maps: main boxes, then the tail boxes.
struct Maps {
  CUtensorMap main[3];  // q, k, v
  CUtensorMap tail[3];
};

// The 64 pairs from pair0 at one parity of operand op (0 q, 1 k, 2 v)
// into rows row0.. of a tile of `rows` rows, completing on bar.
template <int D>
__device__ __forceinline__ void load_rows(uint32_t tile, int rows, int row0,
                                          const Maps& maps, int op,
                                          uint32_t bar, int parity, int pair0,
                                          int bh) {
  using T = Tiles<D>;
  for (int b = 0; b < T::NMAIN; ++b)
    tma_load(tile + (b * rows + row0) * T::MAIN_SW, &maps.main[op], bar,
             b * T::MAIN_BOXC, parity, pair0, bh);
  if constexpr (T::TAIL_C > 0)
    tma_load(tile + T::NMAIN * rows * T::MAIN_SW + row0 * T::TAIL_SW,
             &maps.tail[op], bar, T::MAIN_C, parity, pair0, bh);
}

template <int D>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
    ripple_wgmma_kernel(const __grid_constant__ Maps maps,
                        __nv_bfloat16* __restrict__ out,
                        const int* __restrict__ kflags, int N,
                        float scale_log2) {
  using T = Tiles<D>;
  extern __shared__ unsigned char smem_raw[];
  // Swizzled tiles need 1024-byte alignment (the 128 B pattern's period).
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_tiles = base;  // [kConsumers][kPairs rows]
  const uint32_t k_tiles = q_tiles + kConsumers * T::Q_BYTES;  // [STAGES][128 rows]
  const uint32_t v_tiles = k_tiles + T::STAGES * T::KV_BYTES;
  const uint32_t bars = base + T::TILE_BYTES;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + T::STAGES + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * T::STAGES + s); };
  // Ring position of the current key stage: its slot and the parity of
  // the slot's current round, advanced in step by producer and consumers.
  struct Ring {
    int slot = 0;
    uint32_t phase = 0;
    __device__ void advance() {
      if (++slot == T::STAGES) slot = 0, phase ^= 1;
    }
  };

  const int P = N / 2;
  const int nkb = (P + kPairs - 1) / kPairs;
  const int qb = blockIdx.x;
  const int bh = blockIdx.y;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // Producer: one thread issues every load; the warpgroup gives its
    // registers to the consumers.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x != kConsumers * 128) return;
    mbar_expect_tx(q_full, kConsumers * T::Q_BYTES);
    for (int h = 0; h < kConsumers; ++h)
      load_rows<D>(q_tiles + h * T::Q_BYTES, kPairs, 0, maps, 0, q_full, h,
                   qb * kPairs, bh);
    Ring ring;
    for (int kb = 0; kb < nkb; ++kb, ring.advance()) {
      const int s = ring.slot;
      const int kf = kflags[(long)bh * nkb + kb];
      mbar_wait(empty(s), ring.phase ^ 1);
      // A collapsed stage loads the representative keys only.
      mbar_expect_tx(k_full(s), (kf ? 1 : 2) * kPairs * T::DP * 2);
      for (int par = 0; par < (kf ? 1 : 2); ++par)
        load_rows<D>(k_tiles + s * T::KV_BYTES, kStageKeys, par * kPairs, maps,
                     1, k_full(s), par, kb * kPairs, bh);
      mbar_expect_tx(v_full(s), T::KV_BYTES);
      for (int par = 0; par < 2; ++par)
        load_rows<D>(v_tiles + s * T::KV_BYTES, kStageKeys, par * kPairs, maps,
                     2, v_full(s), par, kb * kPairs, bh);
    }
  } else {
    // Consumers: warpgroup wg owns the rows of parity wg.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    RowState<D> st;
#pragma unroll
    for (int i = 0; i < T::DP / 2; ++i) st.o[i] = 0.f;
    st.m[0] = st.m[1] = -INFINITY;
    st.l[0] = st.l[1] = 0.f;
    const uint32_t q_tile = q_tiles + wg * T::Q_BYTES;
    mbar_wait(q_full, 0);
    Ring ring;
#pragma unroll 1
    for (int kb = 0; kb < nkb; ++kb, ring.advance()) {
      const int s = ring.slot;
      const uint32_t kt = k_tiles + s * T::KV_BYTES;
      const uint32_t vt = v_tiles + s * T::KV_BYTES;
      const int kf = kflags[(long)bh * nkb + kb];
      mbar_wait(k_full(s), ring.phase);
      if (kf) {
        consume_stage<D, kCollapsed>(st, q_tile, kt, vt, v_full(s), ring.phase,
                                     kb * kPairs, P, scale_log2);
      } else if constexpr (T::SPLIT) {
        consume_stage<D, kRepHalf>(st, q_tile, kt, vt, v_full(s), ring.phase,
                                   kb * kPairs, P, scale_log2);
        consume_stage<D, kFolHalf>(st, q_tile, kt, vt, v_full(s), ring.phase,
                                   kb * kPairs, P, scale_log2);
      } else {
        consume_stage<D, kDense>(st, q_tile, kt, vt, v_full(s), ring.phase,
                                 kb * kPairs, P, scale_log2);
      }
      mbar_arrive(empty(s));
    }

    // Rows r and r + 8 of this warp: pairs qb*64 + r, tokens 2p + wg.
    const int t = threadIdx.x % 128;
    const int r0 = (t / 32) * 16 + (t % 32) / 4;
    const int col0 = (t % 4) * 2;
    __nv_bfloat16* oh = out + (long)bh * N * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = qb * kPairs + r0 + 8 * h;
      if (p >= P) continue;
      const float inv_l = 1.f / st.l[h];
      __nv_bfloat16* row = oh + (long)(2 * p + wg) * D;
#pragma unroll
      for (int c = 0; c < T::DP / 8; ++c) {
        if (c * 8 >= D) continue;  // padding columns
        *reinterpret_cast<uint32_t*>(row + c * 8 + col0) = pack_bf16(
            st.o[c * 4 + 2 * h] * inv_l, st.o[c * 4 + 2 * h + 1] * inv_l);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// CUDA-core path (f32, and bf16 at other head dims; d, dv <= 256)
// ---------------------------------------------------------------------------

constexpr int kFmaThreads = 256;

// NJ: output columns a lane holds (lane + 32 j), 4 up to dv 128, else 8.
template <typename T, int NJ>
__global__ void __launch_bounds__(kFmaThreads)
    ripple_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out,
                      const int* __restrict__ qflags,
                      const int* __restrict__ kflags, int N, int d, int dv,
                      float scale) {
  extern __shared__ float sm[];
  const int P = N / 2;
  const int nkb = (P + kTile - 1) / kTile;
  const int nf = (P + kFlagTile - 1) / kFlagTile;  // flags per head
  const int qb = blockIdx.x;
  const long bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int dp = d + 1;
  const int sp = kRows + 1;
  constexpr int VS = 32 * NJ;    // V row stride

  float* Qs = sm;                // [kRows][d + 1]
  float* Ks = Qs + kRows * dp;   // [kRows][d + 1]
  float* Vs = Ks + kRows * dp;   // [kRows][VS]
  float* Ss = Vs + kRows * VS;   // [kRows][kRows + 1]
  float* m_s = Ss + kRows * sp;  // [kRows]
  float* l_s = m_s + kRows;      // [kRows]
  float* a_s = l_s + kRows;      // [kRows]

  const T* qh = q + bh * N * d;
  const T* kh = k + bh * N * d;
  const T* vh = v + bh * N * dv;

  const int qf = qflags[bh * nf + qb / kSubTiles];
  const int nrows = qf ? kTile : kRows;  // row r: pair r % kTile, odd if r >= kTile

  for (int i = tid; i < kRows * d; i += kFmaThreads) {
    const int r = i / d, c = i % d;
    const int p = qb * kTile + (r % kTile);
    const int tok = 2 * p + (r >= kTile);
    Qs[r * dp + c] = p < P ? to_f(qh[(long)tok * d + c]) : 0.f;
  }
  for (int i = tid; i < kRows * VS; i += kFmaThreads) Vs[i] = 0.f;
  for (int r = tid; r < kRows; r += kFmaThreads) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }

  // Score micro-tile: rows ty + 16*i, keys tx + 16*j.
  const int ty = tid / 16, tx = tid % 16;
  // PV micro-tile: rows warp + 8*i, output columns lane + 32*j.
  const int warp = tid / 32, lane = tid % 32;
  float acc[8][NJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int kb = 0; kb < nkb; ++kb) {
    const int kf = kflags[bh * nf + kb / kSubTiles];
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
      Vs[j * VS + c] = val;
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
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    for (int kk = 0; kk < nkeys; ++kk) {
      float vv[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = Vs[kk * VS + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = warp + 8 * i;
        pv[i] = r < nrows ? Ss[r * sp + kk] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
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
    for (int j = 0; j < NJ; ++j) {
      const int col = lane + 32 * j;
      if (col >= dv) continue;
      const float o = acc[i][j] * inv_l;
      from_f(oh + (long)tok * dv + col, o);
      if (qf) from_f(oh + (long)(tok + 1) * dv + col, o);  // follower copy
    }
  }
}


template <typename T, int NJ>
cudaError_t launch_fma_cols(const void* q, const void* k, const void* v, void* out,
                       const int* qf, const int* kf, int BH, int N, int d,
                       int dv, float scale, cudaStream_t s) {
  const int P = N / 2;
  const dim3 grid((P + kTile - 1) / kTile, BH);
  // At d = dv = 256: 2 x 64 x 257 + 64 x 256 + 64 x 65 + 192 floats, 210 KB.
  const size_t smem =
      sizeof(float) * ((size_t)kRows * (d + 1) * 2 + (size_t)kRows * 32 * NJ +
                       (size_t)kRows * (kRows + 1) + 3 * kRows);
  cudaError_t err = cudaFuncSetAttribute(
      ripple_fma_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  ripple_fma_kernel<T, NJ><<<grid, kFmaThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), qf, kf, N, d, dv, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* out,
                       const int* qf, const int* kf, int BH, int N, int d,
                       int dv, float scale, cudaStream_t s) {
  if (dv > 128)
    return launch_fma_cols<T, 8>(q, k, v, out, qf, kf, BH, N, d, dv, scale, s);
  return launch_fma_cols<T, 4>(q, k, v, out, qf, kf, BH, N, d, dv, scale, s);
}



// The (BH, N, d) bf16 operand as a 4-D map (d, 2, P, BH) whose box is
// `channels` channels of 64 pairs at one parity, swizzled over `sw` bytes
// as the wgmma descriptors read it; out-of-range pairs and channels fill
// with zeros.
int encode_operand(CUtensorMap* map, const void* ptr, int d, int BH, int N,
                   int channels, int sw) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return kEncodeError + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)d, 2, (cuuint64_t)(N / 2),
                              (cuuint64_t)BH};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)d * 4,
                                 (cuuint64_t)N * d * 2};
  const cuuint32_t box[4] = {(cuuint32_t)channels, 1, (cuuint32_t)kPairs, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                          const_cast<void*>(ptr), dims, strides, box, elem,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, tma_swizzle(sw),
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeError + (int)res;
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 const int* kf, int BH, int N, float scale, cudaStream_t s) {
  using T = Tiles<D>;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) % 16)
    return (int)cudaErrorMisalignedAddress;  // TMA needs 16-byte bases
  Maps maps = {};
  const void* ops[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    int rc = encode_operand(&maps.main[i], ops[i], D, BH, N, T::MAIN_BOXC,
                            T::MAIN_SW);
    if (rc == 0 && T::TAIL_C > 0)
      rc = encode_operand(&maps.tail[i], ops[i], D, BH, N, T::TAIL_C,
                          T::TAIL_SW);
    if (rc != 0) return rc;
  }
  cudaError_t err = cudaFuncSetAttribute(
      ripple_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N / 2 + kPairs - 1) / kPairs, BH);
  ripple_wgmma_kernel<D><<<grid, kWgmmaThreads, T::SMEM, s>>>(
      maps, static_cast<__nv_bfloat16*>(out), kf, N,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ripple_tile_pairs() { return kFlagTile; }

// q, k: (BH, N, d); v, out: (BH, N, dv), contiguous, float32 (is_bf16 = 0)
// or bfloat16; kflags: (BH, ceil(N/2 / kFlagTile)) int32; qflags, the same
// shape, is read by the CUDA-core path only (the tensor-core path computes
// follower rows in any case) and may be null there.  bf16 with d == dv in
// {32, 40, 64, 72, 80, 128, 160} takes the tensor-core path; d and dv are
// at most 256.  Returns the CUDA error of
// the launch (0 on success), or kEncodeError + the CUresult of a failed
// tensor-map encode.
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
      case 32: return launch_wgmma<32>(q, k, v, out, kf, BH, N, scale, s);
      case 40: return launch_wgmma<40>(q, k, v, out, kf, BH, N, scale, s);
      case 64: return launch_wgmma<64>(q, k, v, out, kf, BH, N, scale, s);
      case 72: return launch_wgmma<72>(q, k, v, out, kf, BH, N, scale, s);
      case 80: return launch_wgmma<80>(q, k, v, out, kf, BH, N, scale, s);
      case 128: return launch_wgmma<128>(q, k, v, out, kf, BH, N, scale, s);
      case 160: return launch_wgmma<160>(q, k, v, out, kf, BH, N, scale, s);
      default: break;
    }
  }
  if (qf == nullptr) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return (int)launch_fma<__nv_bfloat16>(q, k, v, out, qf, kf, BH, N, d, dv,
                                          scale, s);
  return (int)launch_fma<float>(q, k, v, out, qf, kf, BH, N, d, dv, scale, s);
}

// Which path a call takes: 1 for the tensor-core kernel, 0 for CUDA cores.
extern "C" int ripple_uses_tensor_cores(int is_bf16, int d, int dv) {
  return is_bf16 && d == dv &&
         (d == 32 || d == 40 || d == 64 || d == 72 || d == 80 || d == 128 ||
          d == 160);
}
